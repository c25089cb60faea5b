"""The MoE layer, the registry and the MoE entry points of the port against
the JAX package on the CPU.

``models.moe.moe_layer`` against the JAX ``moe_layer`` (run through
``shard_map`` on the (1, 1) mesh, as ``tests/test_chunked_prefill.py``
does), on the same inputs made from a numpy seed: the top-k expert ids
equal (the JAX ids captured from its ``lax.top_k``), hence the kept
assignments equal, at a size where the capacity drops assignments; the
outputs and the aux loss within the tolerances below.  Then the reference's
isolation property (drop-free is isolated, capacity leaks), the registry
(every config the port registers field-equal to the JAX package's, the
VLM and audio families training), the MoE parameter specs, the
4-bit draft of a MoE model byte-equal to the reference's, and the serve
launcher in batch and continuous mode (MoE training is held in
``test_torch_moe_train*.py``)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.moe as jmoe
from repro import configs as jconfigs
from repro.compat import shard_map
from repro.core import quant as jquant
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.core.quant import QuantizedParam
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serve import engine
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)
MESH = jax.make_mesh((1, 1), ("data", "model"))
# 48 tokens, 8 experts, top-2 over a router whose logits favour low ids:
# the capacity (16 slots) drops assignments, drop-free (96) none
T, E, K, D, FF = 48, 8, 2, 32, 64
# f32: the matmuls and exp sum in other orders (1.5e-7 measured on values
# ~0.5); the combine adds in the same order on both sides. bf16: one ulp of
# 0.5 (3.9e-3) measured, where XLA keeps a fused chain in f32
OUT_ATOL = {"float32": 1e-6, "bfloat16": 1e-2}
AUX_RTOL = 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    bias = np.linspace(1.5, -1.5, E, dtype=np.float32)  # uneven load
    router = (rng.standard_normal((D, E)) * 0.3).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[:, 0] = 1.0
    router[0] = bias
    w = {"router": router,
         "w_gate": (0.1 * rng.standard_normal((E, D, FF))).astype(np.float32),
         "w_up": (0.1 * rng.standard_normal((E, D, FF))).astype(np.float32),
         "w_down": (0.1 * rng.standard_normal((E, FF, D))).astype(np.float32)}
    return x, w


def _kept(tope: np.ndarray, c: int) -> np.ndarray:
    """Per flat (token, k) assignment, whether the reference keeps it: its
    place among its expert's assignments in the stable sort is below c."""
    flat = tope.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    se = flat[perm]
    pos = np.arange(flat.size) - np.searchsorted(se, se, side="left")
    kept = np.empty(flat.size, bool)
    kept[perm] = pos < c
    return kept.reshape(tope.shape)


def _jax_moe(x, w, cfg, no_drop, dtype, monkeypatch):
    """JAX moe_layer under shard_map: (out, aux, top-k ids from its lax.top_k)."""
    ids = []

    def top_k(a, k):
        v, i = jax.lax.top_k(a, k)
        jax.debug.callback(lambda t: ids.append(np.asarray(t)), i)
        return v, i

    monkeypatch.setattr(jmoe, "lax", types.SimpleNamespace(
        top_k=top_k, all_to_all=jax.lax.all_to_all))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    fn = shard_map(lambda xx: jmoe.moe_layer(xx, jw, cfg, no_drop=no_drop), mesh=MESH,
                   in_specs=(P(),), out_specs=(P(), P()), check_vma=False)
    out, aux = jax.jit(fn)(jnp.asarray(x).astype(dtype))
    out, aux = jax.device_get((out, aux))
    monkeypatch.undo()
    return np.asarray(out.astype(np.float32)), float(aux), ids[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_layer_matches_jax(no_drop, dtype, monkeypatch):
    x, w = _inputs()
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=FF, tp=1)
    tcfg = moe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=FF, tp=1)
    jout, jaux, jids = _jax_moe(x, w, jcfg, no_drop, getattr(jnp, dtype), monkeypatch)
    tdt = getattr(torch, dtype)
    tw = {k: torch.from_numpy(v).to(tdt if k != "router" else torch.float32)
          for k, v in w.items()}
    xt = torch.from_numpy(x).to(tdt)
    _, _, tids = moe.route(xt, tw["router"], tcfg)
    tout, taux = moe.moe_layer(xt, tw, tcfg, no_drop=no_drop)
    np.testing.assert_array_equal(tids.numpy(), jids)
    c = moe.dispatch_capacity(tcfg, T, no_drop)
    kept = _kept(jids, c)
    assert c == (max(8, -(-T * K // 8) * 8) if no_drop else jcfg.capacity(T))
    assert kept.all() if no_drop else 0 < (~kept).sum() < kept.size // 4
    np.testing.assert_array_equal(_kept(tids.numpy(), c), kept)
    assert tout.dtype == tdt and tout.shape == (T, D)
    np.testing.assert_allclose(tout.float().numpy(), jout, rtol=0, atol=OUT_ATOL[dtype])
    assert abs(float(taux) - jaux) <= AUX_RTOL * abs(jaux)
    if not no_drop:  # a token whose every assignment dropped gets zeros
        dropped = ~kept.any(axis=1)
        np.testing.assert_array_equal(tout.float().numpy()[dropped], 0.0)


def test_top_k_ties_take_the_lower_id():
    """Equal router probabilities (zero tokens): lax.top_k's lower-id-first."""
    cfg = moe.MoEConfig(n_experts=6, top_k=3, d_model=4, d_ff=8, tp=1)
    _, topw, tope = moe.route(torch.zeros(2, 4), torch.randn(4, 6), cfg)
    assert tope.tolist() == [[0, 1, 2], [0, 1, 2]]
    assert torch.allclose(topw, torch.full((2, 3), 1 / 3))


def test_moe_no_drop_isolates_tokens():
    """The reference's ``test_moe_no_drop_isolates_tokens`` through the port:
    drop-free, a token's output is independent of every other token of the
    call; the capacity path leaks (earlier tokens' routing decides which
    later assignments are dropped)."""
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=32, tp=1,
                        capacity_factor=0.25)  # overflows at t=32 (c floors at 8)
    rng = np.random.default_rng(7)
    w = {"router": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)),
         "w_gate": torch.from_numpy((0.1 * rng.normal(size=(4, 16, 32))).astype(np.float32)),
         "w_up": torch.from_numpy((0.1 * rng.normal(size=(4, 16, 32))).astype(np.float32)),
         "w_down": torch.from_numpy((0.1 * rng.normal(size=(4, 32, 16))).astype(np.float32))}
    x1 = rng.normal(size=(32, 16)).astype(np.float32)
    x2 = x1.copy()
    x2[:16] = rng.normal(size=(16, 16))  # perturb the OTHER (earlier) tokens

    def run(no_drop, x):
        return moe.moe_layer(torch.from_numpy(x), w, cfg, no_drop=no_drop)[0].numpy()

    np.testing.assert_array_equal(run(True, x1)[16:], run(True, x2)[16:])
    assert not np.array_equal(run(False, x1)[16:], run(False, x2)[16:])


def test_moe_layer_refuses_expert_parallelism():
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=8, tp=2)
    w = {"router": torch.zeros(8, 4), "w_gate": torch.zeros(2, 8, 8),
         "w_up": torch.zeros(2, 8, 8), "w_down": torch.zeros(2, 8, 8)}
    with pytest.raises(NotImplementedError, match="ROADMAP A11h"):
        moe.moe_layer(torch.zeros(4, 8), w, cfg)


# -- registry --------------------------------------------------------------------

_JAX_FAMILIES = {n: jconfigs.get_config(n).arch_type for n in jconfigs.ARCHS}


@pytest.mark.parametrize("name", configs.ARCHS)
def test_registered_config_equals_reference(name):
    """Every config the port registers, full and smoke, field-equal to the
    JAX package's, parameter counts included."""
    for tget, jget in ((configs.get_config, jconfigs.get_config),
                       (configs.get_smoke, jconfigs.get_smoke)):
        t, j = tget(name.replace("_", "-")), jget(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_params(), t.n_active_params()) == (j.n_params(), j.n_active_params())


def test_registry_covers_the_reference():
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    assert {_JAX_FAMILIES[n] for n in configs.ARCHS} == {"dense", "moe", "ssm", "hybrid",
                                                         "vlm", "audio"}
    olmoe = configs.get_config("olmoe-1b-7b")
    assert (olmoe.n_layers, olmoe.d_model, olmoe.n_experts, olmoe.moe_top_k) == (16, 2048, 64, 8)
    assert olmoe.n_params() == 6_813_908_992 and olmoe.n_active_params() == 1_176_764_416


@pytest.mark.parametrize("name", ["qwen2_vl_72b", "seamless_m4t_large_v2"])
def test_unported_families_name_their_item(name):
    """The VLM and audio families, once refused for training, build, serve
    and train: ``loss_fn`` on the reference's train inputs (the VLM's
    vision stubs and positions, the audio frames of S // enc_frames_ratio)
    gives a finite loss and a gradient for every leaf, the encoder's
    ``enc/*``, ``enc_final_norm`` and the cross-attention's ``dec/x*``
    included."""
    for get in (configs.get_config, configs.get_smoke):
        assert get(name).arch_type == _JAX_FAMILIES[name]
    cfg = ModelConfig(**dataclasses.asdict(jconfigs.get_smoke(name)))
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    params = {k: v.requires_grad_() for k, v in model.init_params(0, "cpu").items()}
    b, s = 2, 8
    batch = {"tokens": torch.ones((b, s), dtype=torch.int64),
             "labels": torch.ones((b, s), dtype=torch.int64)}
    if cfg.arch_type == "vlm":
        batch.update(vision_embeds=torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16),
                     vision_mask=torch.zeros((b, s), dtype=torch.bool),
                     positions=torch.arange(s).expand(3, b, s))
    else:
        batch["audio_embeds"] = 0.1 * torch.randn(b, s // cfg.enc_frames_ratio, cfg.d_model,
                                                  generator=torch.Generator().manual_seed(0))
        assert {"enc/wq", "enc_final_norm", "dec/xwq", "dec/xattn_norm"} <= set(params)
    loss = model.loss_fn(params, batch, (0, 0))
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    assert torch.isfinite(loss)
    for n, g in zip(names, grads):
        assert g.shape == params[n].shape and torch.isfinite(g).all(), n
        assert g.abs().max() > 0, n


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "qwen3_moe_235b_a22b"])
def test_moe_specs_equal_reference(name):
    """The MoE parameter specs (the router an unquantized fp leaf, the expert
    stacks sharded on the expert axis) and rest shapes, full and smoke."""
    ms, jms = MeshSpec(("data", "model"), (1, 1)), JMeshSpec(("data", "model"), (1, 1))
    for smoke in (True, False):
        jc = jconfigs.get_smoke(name) if smoke else jconfigs.get_config(name)
        tm = Model(ModelConfig(**dataclasses.asdict(jc)), ms, QSDPConfig())
        jm = JModel(jc, jms, JQSDPConfig())
        assert set(tm.specs) == set(jm.specs)
        for n, ts in tm.specs.items():
            js = jm.specs[n]
            assert (ts.shape, ts.tp_axis, ts.stack, ts.init, ts.init_scale, ts.quantize) == \
                (js.shape, js.tp_axis, js.stack, js.init, js.init_scale, js.quantize), n
            assert ts.rest_shape(ms) == js.rest_shape(jms), n
            assert tm.engine._is_quantized(ts) == jm.engine._is_quantized(js), n
        assert tm.ecfg == moe.MoEConfig(**dataclasses.asdict(jm.ecfg))
        assert not tm.specs["layers/router"].quantize


# -- the draft -------------------------------------------------------------------

_DRAFT_CFG = dict(name="moe-draft", arch_type="moe", n_layers=2, d_model=64, vocab_size=256,
                  n_heads=4, n_kv_heads=2, head_dim=16, n_experts=4, moe_top_k=2, moe_d_ff=32)


@pytest.mark.parametrize("bits", [4, 2])
def test_make_draft_params_moe(bits):
    """A MoE model's draft: every layer matmul (attention and the 3-D expert
    stacks) as `bits`-bit wire codes byte-equal to the reference's, split per
    layer; the router, norms and embedding are the serving tensors; the
    experts are not rowquant-eligible (3-D), so the draft decodes them
    through K2."""
    jm = JModel(JModelConfig(**_DRAFT_CFG), JMeshSpec(("data", "model"), (1, 1)),
                JQSDPConfig(min_quant_size=256))
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = Model(ModelConfig(**_DRAFT_CFG), MeshSpec(("data", "model"), (1, 1)),
               QSDPConfig(min_quant_size=256))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu", tm)
    jd, td = jengine.make_draft_params(jm, jp, bits), engine.make_draft_params(tm, tp, bits)
    wire = sorted(n for n, v in td.items() if isinstance(v, QuantizedParam))
    assert wire == sorted(n for n, v in jd.items() if isinstance(v, jquant.QuantizedParam))
    assert {n.split("/")[-1] for n in wire} == {"wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                "w_down"}
    for n in wire:
        np.testing.assert_array_equal(td[n].wire.numpy(), np.asarray(jd[n].wire))
        assert tuple(td[n].cell_shape) == tuple(jd[n].cell_shape)
        assert td[n].wire.shape[0] == 2
        expert = n.split("/")[-1] in ("w_gate", "w_up", "w_down")
        if expert:
            one = QuantizedParam(td[n].wire[0], td[n].cell_shape, td[n].cfg)
            assert not tm.engine.rowquant_wire_eligible(n, one)
            assert not jm.engine.rowquant_wire_eligible(n, jax.tree.map(
                lambda a: a[0], jd[n]))
    for n in set(td) - set(wire):
        assert td[n] is tp[n], n


# -- entry points ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--continuous", "--requests", "3", "--prefill-chunk",
                                        "8", "--prefill-buckets", "2", "--kv-block-size", "8",
                                        "--kv-quant-bits", "4", "--kv-quant-horizon", "2"]])
def test_serve_launcher_moe(flags, capsys):
    from repro_torch.launch import serve as launch_serve
    rc = launch_serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--batch",
                            "2", "--prompt-len", "12", "--gen", "4", *flags])
    out = capsys.readouterr().out
    assert rc == 0 and "olmoe-smoke" in out and "sample:" in out
    if flags:
        assert "paged KV pool" in out and "chunk launches" in out
