"""SSM and hybrid serving, the port against the JAX package on the CPU: the
mamba2-370m and zamba2-7b smoke configs (2 / 3 Mamba2 layers, d_model 256;
zamba2 with a shared attention+MLP block after every 2 layers, so one
invocation and a tail layer) through ``build_serve_setup(...,
device="cpu")`` -> ``ServeEngine.generate`` on the reference's weights
(``weights.params_from_jax``), batch 2, prompt 16, 4 tokens, the same key,
an unsharded batch on both sides.

  (a) default QSDPConfig (bf16 compute) and f32 compute: every gathered
      weight of every step, the shared block's at each invocation
      included, byte-equal per tensor;
  (b) f32 compute: the same greedy tokens, the prefill's and every decode
      step's logits within LOGIT_ATOL_F32, and the prefill caches (conv
      ring, SSM state, the shared block's KV) within CACHE_ATOL_F32;
  (c) zamba2 smoke under the reference's rowquant test config (min_quant
      256, bucket 128, ``test_kernel_dispatch.py:206``): the shared MLP's
      w_gate/w_up/w_down go through K3's plain version at decode, and the
      greedy tokens equal the dense path's, on both sides.

Values are captured with test-side hooks: in the JAX package through
``jax.debug.callback`` (no JAX file changes), in the port by wrapping the
same functions."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.layers as jlayers
from repro import configs as jconfigs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.models.transformer import Model as JModel
from repro.serve import ServeEngine as JServeEngine
import repro_torch.models.layers as tlayers
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.kernels import ops
from repro_torch.serve import build_serve_setup
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)
B, S, GEN, SEED, KEY = 2, 16, 4, 0, 3
# f32 compute: summation order and the libm of exp/softplus/rsqrt, ~1e-6
# relative on logits of magnitude ~0.1-1 (as tests/test_torch_serve.py)
LOGIT_ATOL_F32 = 1e-4
# the conv ring holds bf16-rounded projections (exact on both sides up to
# one f32 rounding of the products); the SSM state sums 16 tokens' f32
# contributions in other orders; the shared KV is bf16 (one ulp of values
# ~1 is 7.8e-3, and a 1-ulp input difference can flip a rounding)
CACHE_ATOL_F32 = {"conv": 1e-5, "ssm": 1e-5, "shared_k": 1e-2, "shared_v": 1e-2}
ARCHS = ["mamba2_370m", "zamba2_7b"]
RQ_QSDP = dict(min_quant_size=256, bucket_size=128)


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode() + str(a.shape).encode()).hexdigest()


def _prompt():
    return np.random.default_rng(SEED).integers(0, 1024, size=(B, S)).astype(np.int64)


def _jax_run(arch, qcfg, monkeypatch, rowquant=False, np_params=None, tokens_only=False):
    """JAX generate with hooks, then a prefill: (tokens, logits per step,
    {name: sorted digests of gathered weights}, prefill cache, params).
    With `tokens_only` the generate alone, unhooked: (tokens, params)."""
    cfg = jconfigs.get_smoke(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), qcfg)
    if np_params is None:
        params = model.init_params(jax.random.PRNGKey(SEED))
    else:
        params = {k: jnp.asarray(v) for k, v in np_params.items()}
    spec = JDecodeSpec(cache_len=0 if cfg.arch_type == "ssm" else S + GEN, batch_global=B,
                       batch_sharded=False, rowquant_mlp=rowquant)
    batch, pspecs = {"tokens": jnp.asarray(_prompt(), jnp.int32)}, {"tokens": P()}
    if tokens_only:
        with mesh:
            out = JServeEngine(model, mesh, spec).generate(params, batch, pspecs, n_tokens=GEN,
                                                           key=jax.random.PRNGKey(KEY))
            return np.asarray(jax.device_get(out)), {k: np.asarray(v) for k, v in params.items()}
    logits, fulls = [], {}
    orig_logits, orig_full = jlayers.vocab_parallel_logits, model.engine._reshape_full

    def hook_logits(h, w):
        out = orig_logits(h, w)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out)
        return out

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: fulls.setdefault(name, []).append(
            _digest(v)), full[:n].astype(model.engine.compute_dtype))
        return orig_full(name, full)

    monkeypatch.setattr(jlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    engine = JServeEngine(model, mesh, spec)
    with mesh:
        out = engine.generate(params, batch, pspecs, n_tokens=GEN,
                              key=jax.random.PRNGKey(KEY))
        out = np.asarray(jax.device_get(out))
        _, cache = engine.prefill_step(pspecs)(params, batch, jax.random.PRNGKey(KEY))
        cache = {k: np.asarray(jax.device_get(v).astype(jnp.float32)) for k, v in cache.items()}
    monkeypatch.undo()
    return out, logits[:GEN], {k: sorted(v) for k, v in fulls.items()}, cache, \
        {k: np.asarray(v) for k, v in params.items()}


def _port_run(arch, qcfg, np_params, monkeypatch, rowquant=False, tokens_only=False):
    """The port's build_serve_setup + generate with the same hooks, then a
    prefill: (tokens, logits per step, gathered weight digests, prefill
    cache).  With `tokens_only` the generate alone, unhooked: the tokens."""
    setup = build_serve_setup(arch, smoke=True, qsdp=qcfg, batch=B, prompt_len=S, gen=GEN,
                              rowquant_mlp=rowquant, device="cpu")
    setup.params = params_from_jax(np_params, "cpu", setup.model)
    if tokens_only:
        return setup.engine.generate(setup.params, {"tokens": torch.from_numpy(_prompt())},
                                     n_tokens=GEN, key=prng.PRNGKey(KEY)).numpy()
    model = setup.model
    logits, fulls = [], {}
    orig_logits, orig_full = tlayers.vocab_parallel_logits, model.engine._reshape_full

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

    monkeypatch.setattr(tlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    batch = {"tokens": torch.from_numpy(_prompt())}
    out = setup.engine.generate(setup.params, batch, n_tokens=GEN, key=prng.PRNGKey(KEY))
    _, cache = setup.engine.prefill_step()(setup.params, batch, prng.PRNGKey(KEY))
    monkeypatch.undo()
    return out.numpy(), logits[:GEN], {k: sorted(v) for k, v in fulls.items()}, \
        {k: v.float().numpy() for k, v in cache.items()}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    mp = pytest.MonkeyPatch()
    out = {}
    for name, kw in (("bf16", {}), ("f32", {"compute_dtype": "float32"})):
        jt, jl, jf, jc, np_params = _jax_run(request.param, JQSDPConfig(**kw), mp)
        tt, tl, tf, tc = _port_run(request.param, QSDPConfig(**kw), np_params, mp)
        out[name] = dict(jax=(jt, jl, jf, jc), port=(tt, tl, tf, tc))
    return request.param, out


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_ssm_gathered_weights_byte_equal(runs, compute):
    arch, r = runs
    jf, tf = r[compute]["jax"][2], r[compute]["port"][2]
    cfg = jconfigs.get_smoke(arch)
    assert set(jf) == set(tf)
    assert {"layers/w_z", "layers/w_x", "layers/w_bc", "layers/w_dt", "layers/w_out",
            "layers/conv_x", "layers/a_log"} <= set(tf)
    n_shared = cfg.n_layers // cfg.hybrid_attn_every if cfg.arch_type == "hybrid" else 0
    for name, digests in jf.items():
        per_step = (cfg.n_layers if name.startswith("layers/")
                    else n_shared if name.startswith("shared/") else 1)
        # generate(GEN) plus the test's extra prefill: GEN + 1 gathers
        assert len(digests) == (GEN + 1) * per_step, name
        assert tf[name] == digests, name


def test_ssm_greedy_tokens_and_logits(runs):
    _, r = runs
    (jt, jl, _, _), (tt, tl, _, _) = r["f32"]["jax"], r["f32"]["port"]
    np.testing.assert_array_equal(tt, jt)
    assert len(jl) == len(tl) == GEN
    for j, (a, b) in enumerate(zip(jl, tl)):
        assert a.shape == b.shape == (B, 1024)
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL_F32, err_msg=f"step {j}")


def test_ssm_prefill_caches(runs):
    arch, r = runs
    jc, tc = r["f32"]["jax"][3], r["f32"]["port"][3]
    cfg = jconfigs.get_smoke(arch)
    want = {"conv", "ssm"} | ({"shared_k", "shared_v"} if cfg.arch_type == "hybrid" else set())
    assert set(jc) == set(tc) == want
    for k in want:
        assert jc[k].shape == tc[k].shape, k
        assert np.abs(jc[k]).max() > 0, k
        np.testing.assert_allclose(tc[k], jc[k], rtol=0, atol=CACHE_ATOL_F32[k], err_msg=k)


def test_zamba2_rowquant_tokens_equal_dense(monkeypatch):
    """The reference's ``test_serve_rowquant_decode_audio_hybrid`` for the
    port, held to the JAX engine's tokens too: at min_quant 256 / bucket 128
    the shared MLP is rowquant-eligible, and its decode goes through K3."""
    jt, np_params = _jax_run("zamba2_7b", JQSDPConfig(**RQ_QSDP), monkeypatch, tokens_only=True)
    jrq = _jax_run("zamba2_7b", JQSDPConfig(**RQ_QSDP), monkeypatch, rowquant=True,
                   np_params=np_params, tokens_only=True)[0]
    np.testing.assert_array_equal(jrq, jt)
    tt = _port_run("zamba2_7b", QSDPConfig(**RQ_QSDP), np_params, monkeypatch,
                   tokens_only=True)
    calls = []
    orig = ops.rowquant_matmul

    def count(*a, **k):
        calls.append(a[1].shape)
        return orig(*a, **k)

    monkeypatch.setattr(tlayers, "rowquant_matmul", count)
    trq = _port_run("zamba2_7b", QSDPConfig(**RQ_QSDP), np_params, monkeypatch,
                    rowquant=True, tokens_only=True)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(trq, tt)
    # one shared invocation per decode step, three MLP weights each
    assert len(calls) == 3 * (GEN - 1)
    assert sorted(set(calls)) == [(256, 512), (512, 256)]
