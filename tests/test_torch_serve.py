"""The whole serving slice, port against the JAX package, on the CPU.

gpt-1.3b smoke config on the (1, 1) mesh with the default QSDPConfig (W8,
shift rounding, bucket 1024, coalesced, bf16 compute).  The JAX params go
through ``params_from_jax`` into the port; both sides serve the same prompt
with the same key.  Values are captured with test-side hooks: in the JAX
package through ``jax.debug.callback`` (no JAX file changes), in the port by
wrapping the same functions.

  (a) every gathered weight, in the compute dtype the model reads it in,
      byte-equal (the port's K2 writes that dtype itself; the f32-compute
      run holds the f32 decode);
  (b) f32 compute: prefill and decode logits within LOGIT_ATOL_F32;
  (c) bf16 compute, port teacher-forced with the JAX tokens: greedy tokens
      equal wherever the JAX top-1/top-2 margin exceeds LOGIT_ATOL_BF16;
  (d) rowquant decode MLP (bucket 256, so the smoke MLP rows tile) within
      ROWQUANT_RTOL of the port's dense path.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.layers as jlayers
from repro.configs import gpt_1_3b as jcfg_mod
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.models.transformer import Model as JModel
from repro.serve import ServeEngine as JServeEngine
import repro_torch.models.layers as tlayers
from repro_torch.configs import gpt_1_3b as tcfg_mod
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.decode import ROWQUANT_MLP, DecodeSpec
from repro_torch.models.transformer import Model
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_jax

B, S, GEN, SEED, KEY = 2, 8, 4, 0, 3
# f32 compute: the two sides differ only in summation order and in the
# libm of rope/rsqrt, ~1e-6 relative on logits of magnitude ~0.1-1
LOGIT_ATOL_F32 = 1e-4
# bf16 compute: the frameworks round bf16 intermediates at different
# places (XLA fuses elementwise chains in f32), a few bf16 ulps per layer
LOGIT_ATOL_BF16 = 2e-2
# rowquant vs dense: the dense path rounds the dequantized weight to bf16
# before the matmul, the rowquant path keeps it exact in f32
ROWQUANT_RTOL = 3e-2


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":  # JAX's bf16 and the port's (as int16) alike
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode() + str(a.shape).encode()).hexdigest()


def _prompt():
    from repro_torch.data import SyntheticLM
    tokens, _ = SyntheticLM(vocab_size=1024, seq_len=S, global_batch=B, seed=SEED).sample(0)
    return tokens.numpy()


def _jax_run(qcfg: JQSDPConfig, monkeypatch):
    """JAX generate with hooks: (tokens (B, GEN), logits per step,
    {name: sorted digests of gathered flats}, params as numpy)."""
    cfg = jcfg_mod.smoke()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), qcfg)
    params = model.init_params(jax.random.PRNGKey(SEED))
    spec = JDecodeSpec(cache_len=S + GEN, batch_global=B, batch_sharded=True)
    logits, fulls = [], {}
    orig_logits = jlayers.vocab_parallel_logits

    def hook_logits(h, w):
        out = orig_logits(h, w)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out)
        return out

    orig_full = model.engine._reshape_full

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: fulls.setdefault(name, []).append(
            _digest(v)), full[:n].astype(model.engine.compute_dtype))
        return orig_full(name, full)

    monkeypatch.setattr(jlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    engine = JServeEngine(model, mesh, spec)
    with mesh:
        out = engine.generate(params, {"tokens": jnp.asarray(_prompt(), jnp.int32)},
                              {"tokens": P(("data",))}, n_tokens=GEN,
                              key=jax.random.PRNGKey(KEY))
        out = np.asarray(jax.device_get(out))
    monkeypatch.undo()
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return out, logits, {k: sorted(v) for k, v in fulls.items()}, np_params


def _port_teacher_forced(qcfg: QSDPConfig, np_params, tokens, monkeypatch,
                         rowquant=False):
    """Port prefill, then decode steps fed `tokens` (the reference's):
    (logits per step, {name: sorted digests}, rowquant kernel calls)."""
    cfg = tcfg_mod.smoke()
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), qcfg)
    params = params_from_jax(np_params, "cpu", model)
    spec = DecodeSpec(cache_len=S + GEN, batch_global=B, batch_sharded=True,
                      rowquant_mlp=rowquant)
    engine = ServeEngine(model, spec, "cpu")
    logits, fulls, rq_calls = [], {}, []
    orig_logits = tlayers.vocab_parallel_logits
    orig_full = model.engine._reshape_full
    orig_rq = tlayers.rowquant_matmul

    def hook_logits(h, w):
        out = orig_logits(h, w)
        logits.append(out.numpy())
        return out

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        w = full[:n].to(model.engine.compute_dtype)
        fulls.setdefault(name, []).append(_digest(
            w.view(torch.int16).numpy().view(np.uint16) if w.dtype == torch.bfloat16
            else w.numpy()))
        return orig_full(name, full)

    def hook_rq(*a):
        rq_calls.append(1)
        return orig_rq(*a)

    monkeypatch.setattr(tlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(tlayers, "rowquant_matmul", hook_rq)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    key = prng.PRNGKey(KEY)
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(_prompt())}
        _, cache = engine.prefill_step()(params, batch, key)
        dec = engine.decode_step()
        for i in range(GEN - 1):
            pos = torch.full((B,), S + i, dtype=torch.int64)
            _, cache = dec(params, cache, torch.from_numpy(tokens[:, i].astype(np.int64)),
                           pos, prng.fold_in(key, i))
    monkeypatch.undo()
    return logits, {k: sorted(v) for k, v in fulls.items()}, len(rq_calls), model


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    out = {}
    for name, kw in (("bf16", {}), ("f32", {"compute_dtype": "float32"})):
        toks, jl, jf, np_params = _jax_run(JQSDPConfig(**kw), mp)
        tl, tf, _, _ = _port_teacher_forced(QSDPConfig(**kw), np_params, toks, mp)
        out[name] = dict(tokens=toks, jax_logits=jl, jax_fulls=jf, port_logits=tl,
                         port_fulls=tf, params=np_params)
    return out


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_gathered_weights_byte_equal(runs, compute):
    """(a) the same multiset of gathered weight bytes per parameter name:
    embed and final_norm once per step, each layer tensor once per layer
    per step (prefill + GEN-1 decode steps)."""
    r = runs[compute]
    assert set(r["jax_fulls"]) == set(r["port_fulls"])
    n_steps = GEN  # prefill + GEN-1 decode steps
    for name, digests in r["jax_fulls"].items():
        per_step = 2 if name.startswith("layers/") else 1
        assert len(digests) == n_steps * per_step, name
        assert r["port_fulls"][name] == digests, name


def test_f32_logits_agree(runs):
    """(b) f32 compute: prefill and every decode step's logits."""
    r = runs["f32"]
    assert len(r["jax_logits"]) == len(r["port_logits"]) == GEN
    for j, (a, b) in enumerate(zip(r["jax_logits"], r["port_logits"])):
        assert a.shape == b.shape == (B, 1024)
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL_F32, err_msg=f"step {j}")


def test_bf16_greedy_tokens_teacher_forced(runs):
    """(c) default bf16 config: the port's greedy token equals the JAX token
    wherever the JAX top-1/top-2 logit margin exceeds the logit tolerance."""
    r = runs["bf16"]
    checked = 0
    for j, (a, b) in enumerate(zip(r["jax_logits"], r["port_logits"])):
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL_BF16, err_msg=f"step {j}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL_BF16
        assert (np.argmax(a, -1) == r["tokens"][:, j]).all()
        assert (np.argmax(b, -1)[clear] == r["tokens"][clear, j]).all(), f"step {j}"
        checked += int(clear.sum())
    assert checked >= B * GEN // 2, "too few tokens with a clear margin to check"


def test_rowquant_decode_matches_dense(runs, monkeypatch):
    """(d) rowquant MLP weights really take the K3 path and agree with the
    dense gather."""
    r = runs["bf16"]
    qcfg = QSDPConfig(bucket_size=256)
    dense, _, n_rq_dense, _ = _port_teacher_forced(qcfg, r["params"], r["tokens"], monkeypatch)
    rq, _, n_rq, model = _port_teacher_forced(qcfg, r["params"], r["tokens"], monkeypatch,
                                              rowquant=True)
    for n in ROWQUANT_MLP:
        assert model.engine.rowquant_eligible(f"layers/{n}")
    assert n_rq_dense == 0
    assert n_rq == len(ROWQUANT_MLP) * model.cfg.n_layers * (GEN - 1)
    np.testing.assert_array_equal(rq[0], dense[0])  # prefill never takes rowquant
    for j in range(1, GEN):
        scale = np.abs(dense[j]).max()
        assert np.abs(rq[j] - dense[j]).max() <= ROWQUANT_RTOL * scale, j


def test_generate_matches_teacher_forced_run(runs):
    """The port's own generate() reproduces its teacher-forced tokens where
    it agrees with the reference (same keys, same per-step folds)."""
    r = runs["f32"]
    cfg = tcfg_mod.smoke()
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(compute_dtype="float32"))
    spec = DecodeSpec(cache_len=S + GEN, batch_global=B, batch_sharded=True)
    out = ServeEngine(model, spec, "cpu").generate(
        params_from_jax(r["params"], "cpu"), {"tokens": torch.from_numpy(_prompt())}, GEN,
        key=prng.PRNGKey(KEY))
    assert out.shape == (B, GEN)
    np.testing.assert_array_equal(out.numpy(), r["tokens"])


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_per_tensor_gather_equals_coalesced(compute_dtype):
    """One layer gathered per tensor (coalesce=False: three collectives per
    quantized tensor) gives the bytes of the one-buffer coalesced gather,
    in either compute dtype K2 decodes into."""
    cfg, ms = tcfg_mod.smoke(), MeshSpec(("data", "model"), (1, 1))
    out = []
    for coalesce in (True, False):
        model = Model(cfg, ms, QSDPConfig(coalesce=coalesce, compute_dtype=compute_dtype))
        params = model.engine.init_params(SEED, "cpu")
        names = tuple(sorted(n for n in params if n.startswith("layers/")))
        key = prng.fold_in(prng.PRNGKey(KEY), 1)
        assert model.engine.layer_coalesced(names) == coalesce
        # the layer has quantized tensors
        assert any(model.engine._is_quantized(model.specs[n]) for n in names)
        out.append(model.engine.gather_layer(
            "layers/", {n.split("/", 1)[1]: params[n][1] for n in names}, key))
    assert out[0].keys() == out[1].keys()
    for n in out[0]:
        assert out[0][n].dtype == out[1][n].dtype == model.engine.compute_dtype
        assert torch.equal(out[0][n].view(torch.uint8), out[1][n].view(torch.uint8)), n


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2), (3, 1)])
def test_rest_layout_equals_reference(mesh):
    """to_rest/from_rest keep the reference's (stack?, MODEL, FSDP, n_local)
    layout on any mesh shape (host-side; gathers run on (1, 1) only)."""
    from repro.core.qsdp import from_rest as jfrom, to_rest as jto
    from repro_torch.core.qsdp import from_rest, to_rest
    cfg = jcfg_mod.smoke()
    jms = JMeshSpec(("data", "model"), mesh)
    tms = MeshSpec(("data", "model"), mesh)
    specs = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig()).specs
    tspecs = Model(tcfg_mod.smoke(), MeshSpec(("data", "model"), (1, 1)), QSDPConfig()).specs
    rng = np.random.default_rng(0)
    for name, js in specs.items():
        if js.tp_axis is not None and js.shape[js.tp_axis] % mesh[1]:
            continue
        full = rng.standard_normal(((js.stack,) if js.stack else ()) + js.shape).astype(np.float32)
        ts = tspecs[name]
        rj = np.asarray(jto(jnp.asarray(full), js, jms))
        rt = to_rest(torch.from_numpy(full), ts, tms).numpy()
        assert rj.shape == rt.shape == ts.rest_shape(tms)
        assert rj.tobytes() == rt.tobytes(), name
        assert np.array_equal(from_rest(torch.from_numpy(rt), ts, tms).numpy(), full), name
        assert np.array_equal(np.asarray(jfrom(jnp.asarray(rj), js, jms)), full), name


def test_serve_specs_equal_reference():
    from repro.models.config import SHAPES as JSHAPES
    from repro.models.decode import make_decode_spec as jmake
    from repro.serve.common import make_serve_spec as jserve
    from repro_torch.models.config import SHAPES
    from repro_torch.models.decode import make_decode_spec
    from repro_torch.serve.common import make_serve_spec
    cfg = jcfg_mod.CONFIG
    jm = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
    tm = Model(tcfg_mod.CONFIG, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    for shape in ("decode_32k", "long_500k", "prefill_32k"):
        j, t = jmake(jm, JSHAPES[shape], rowquant_mlp=True), make_decode_spec(tm, SHAPES[shape], True)
        assert (j.cache_len, j.batch_global, j.batch_sharded, j.rowquant_mlp) == \
            (t.cache_len, t.batch_global, t.batch_sharded, t.rowquant_mlp)
    j = jserve(cfg, JMeshSpec(("data", "model"), (1, 1)), 4, 128, 16)
    t = make_serve_spec(tcfg_mod.CONFIG, MeshSpec(("data", "model"), (1, 1)), 4, 128, 16)
    assert (j.cache_len, j.batch_global, j.batch_sharded) == \
        (t.cache_len, t.batch_global, t.batch_sharded)
    assert [s.rest_shape(MeshSpec(("data", "model"), (1, 1))) for _, s in sorted(tm.specs.items())] \
        == [s.rest_shape(JMeshSpec(("data", "model"), (1, 1))) for _, s in sorted(jm.specs.items())]
