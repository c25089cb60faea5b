"""MoE serving, the port against the JAX package on the CPU: the olmoe-1b-7b
and qwen3-moe-235b-a22b smoke configs (2 layers, d_model 256, 4 experts
top-2; qwen3-moe with 2 KV heads) through ``build_serve_setup(...,
device="cpu")`` -> ``ServeEngine.generate`` on the reference's weights
(``weights.params_from_jax``), batch 2, prompt 16, 4 tokens, the same key.

  (a) default QSDPConfig (bf16 compute): every gathered weight of every
      step, expert stacks and router included, byte-equal per layer;
  (b) f32 compute: the same greedy tokens, and the prefill's and every
      decode step's logits within LOGIT_ATOL_F32;
  (c) the whole-prompt prefill routes with the capacity drops and the decode
      steps drop-free, as the reference does.

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
import repro.models.moe as jmoe
from repro import configs as jconfigs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.models.transformer import Model as JModel
from repro.serve import ServeEngine as JServeEngine
import repro_torch.models.layers as tlayers
import repro_torch.models.moe as tmoe
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.serve import build_serve_setup
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)
B, S, GEN, SEED, KEY = 2, 16, 4, 0, 3
# f32 compute: summation order and the libm of rope/rsqrt/exp, ~1e-6
# relative on logits of magnitude ~0.1-1 (as tests/test_torch_serve.py)
LOGIT_ATOL_F32 = 1e-4
ARCHS = ["olmoe_1b_7b", "qwen3_moe_235b_a22b"]


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode() + str(a.shape).encode()).hexdigest()


def _prompt():
    return np.random.default_rng(SEED).integers(0, 1024, size=(B, S)).astype(np.int64)


def _jax_run(arch, qcfg, monkeypatch):
    """JAX generate with hooks: (tokens, logits per step, {name: sorted
    digests of gathered weights}, moe_layer calls' no_drop flags, params)."""
    cfg = jconfigs.get_smoke(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), qcfg)
    params = model.init_params(jax.random.PRNGKey(SEED))
    spec = JDecodeSpec(cache_len=S + GEN, batch_global=B, batch_sharded=True)
    logits, fulls, modes = [], {}, []
    orig_logits, orig_full, orig_moe = (jlayers.vocab_parallel_logits,
                                        model.engine._reshape_full, jmoe.moe_layer)

    def hook_logits(h, w):
        out = orig_logits(h, w)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out)
        return out

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: fulls.setdefault(name, []).append(
            _digest(v)), full[:n].astype(model.engine.compute_dtype))
        return orig_full(name, full)

    def hook_moe(x, w, cfg, no_drop=False):
        modes.append((x.shape[0], no_drop))
        return orig_moe(x, w, cfg, no_drop=no_drop)

    monkeypatch.setattr(jlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    monkeypatch.setattr(jmoe, "moe_layer", hook_moe)
    engine = JServeEngine(model, mesh, spec)
    with mesh:
        out = engine.generate(params, {"tokens": jnp.asarray(_prompt(), jnp.int32)},
                              {"tokens": P(("data",))}, n_tokens=GEN,
                              key=jax.random.PRNGKey(KEY))
        out = np.asarray(jax.device_get(out))
    monkeypatch.undo()
    return out, logits, {k: sorted(v) for k, v in fulls.items()}, modes, \
        {k: np.asarray(v) for k, v in params.items()}


def _port_run(arch, qcfg, np_params, monkeypatch):
    """The port's build_serve_setup + generate with the same hooks."""
    setup = build_serve_setup(arch, smoke=True, qsdp=qcfg, batch=B, prompt_len=S, gen=GEN,
                              device="cpu")
    setup.params = params_from_jax(np_params, "cpu", setup.model)
    model = setup.model
    logits, fulls, modes = [], {}, []
    orig_logits, orig_full, orig_moe = (tlayers.vocab_parallel_logits,
                                        model.engine._reshape_full, tmoe.moe_layer)

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

    def hook_moe(x, w, cfg, no_drop=False):
        modes.append((x.shape[0], no_drop))
        return orig_moe(x, w, cfg, no_drop=no_drop)

    monkeypatch.setattr(tlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    monkeypatch.setattr(tmoe, "moe_layer", hook_moe)
    out = setup.engine.generate(setup.params, {"tokens": torch.from_numpy(_prompt())},
                                n_tokens=GEN, key=prng.PRNGKey(KEY))
    monkeypatch.undo()
    return out.numpy(), logits, {k: sorted(v) for k, v in fulls.items()}, modes


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    mp = pytest.MonkeyPatch()
    out = {}
    for name, kw in (("bf16", {}), ("f32", {"compute_dtype": "float32"})):
        jt, jl, jf, jm, np_params = _jax_run(request.param, JQSDPConfig(**kw), mp)
        tt, tl, tf, tm = _port_run(request.param, QSDPConfig(**kw), np_params, mp)
        out[name] = dict(jax=(jt, jl, jf, jm), port=(tt, tl, tf, tm))
    return request.param, out


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_moe_gathered_weights_byte_equal(runs, compute):
    arch, r = runs
    jf, tf = r[compute]["jax"][2], r[compute]["port"][2]
    assert set(jf) == set(tf)
    assert {"layers/router", "layers/w_gate", "layers/w_up", "layers/w_down"} <= set(tf)
    for name, digests in jf.items():
        per_step = jconfigs.get_smoke(arch).n_layers if name.startswith("layers/") else 1
        assert len(digests) == GEN * per_step, name
        assert tf[name] == digests, name


def test_moe_greedy_tokens_and_logits(runs):
    _, r = runs
    (jt, jl, _, _), (tt, tl, _, _) = r["f32"]["jax"], r["f32"]["port"]
    np.testing.assert_array_equal(tt, jt)
    assert len(jl) == len(tl) == GEN
    for j, (a, b) in enumerate(zip(jl, tl)):
        assert a.shape == b.shape == (B, 1024)
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL_F32, err_msg=f"step {j}")


def test_moe_dispatch_modes_follow_the_reference(runs):
    """Prefill dispatches its B x S tokens with capacity drops, each decode
    step its B tokens drop-free, layer by layer, on both sides."""
    arch, r = runs
    nl = jconfigs.get_smoke(arch).n_layers
    jm, tm = r["bf16"]["jax"][3], r["bf16"]["port"][3]
    assert tm == [(B * S, False)] * nl + [(B, True)] * nl * (GEN - 1)
    # the JAX scan traces each layer body once per compiled step
    assert set(jm) == set(tm)
