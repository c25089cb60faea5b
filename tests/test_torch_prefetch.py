"""The double-buffered layer prefetch (``QSDPConfig(prefetch=True)``) on the
(1, 1) mesh, on the CPU: the port against the JAX package's pipelined
scan, and against its own unpipelined step.

Four models, each with every stack pipelined: the reference's 3-layer
dense ``MCFG`` and its 2-layer MoE model of ``tests/test_wire_coalesced.py``
(the (x, aux) carry), zamba2-7b's smoke config at 5 layers with a shared
block every 3 (a group of 3 Mamba2 layers and a tail of 2), and
seamless-m4t-large-v2's smoke config (the encoder's and the decoder's
stacks, the decoder's bodies taking the encoder's output).

  * Against the JAX package's prefetch run: loss within ``LOSS_RTOL`` and
    every gradient within ``GRAD_RTOL`` of its largest value, every
    gathered weight byte-equal (f32 compute, gradients unquantized in f32:
    the two frameworks' matmuls and reductions run in other orders, so
    the loss and gradients compare as functions, as in
    ``test_torch_mm_train_grads.py``; the weights are carried across from
    the JAX package's init).
  * Against the port's unpipelined step under the reference's policy of
    ``test_engine_coalesce_prefetch_bitexact`` (W8G8, bf16 compute,
    ``min_quant_size=128``): loss and every gradient bit-equal, per tensor
    == coalesced == prefetch for the dense model.
  * K1/K2 launches of one microbatch equal ``chip_smoke``'s
    ``expected_train_launches`` (the pipelined layers' replays decode, no
    encode) and the hand count.
  * The fallbacks take the unpipelined path, as the reference's: a stack of
    one layer, and a ``coalesce_max_bytes`` veto.
  * Two train steps (AdamW, 8-bit moments, quantized_state) bit-equal to
    the unpipelined ones.
  * On meta, the counted marginal per added layer at depths 2 and 4: one
    gather (not two) and the K1/K2 of ``train_layer_launches``.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.compat import shard_map
from repro.core.qsdp import QSDPConfig as JQSDPConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.core import collectives as coll
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from _torch_train_common import JMS, LOSS_RTOL, MS
from test_torch_continuous import _chip_smoke

torch.set_num_threads(1)

# f32 gradients of the two frameworks (test_torch_mm_train_grads.py's bound)
GRAD_RTOL = 2e-5
F32 = dict(compute_dtype="float32", quantize_grads=False, grad_wire_dtype="float32",
           min_quant_size=128)
# the reference's policy of test_engine_coalesce_prefetch_bitexact
REF = dict(min_quant_size=128)

MCFG = dict(name="t", arch_type="dense", n_layers=3, d_model=64, vocab_size=256, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128)
MOE = dict(name="tm", arch_type="moe", n_layers=2, d_model=64, vocab_size=256, n_heads=4,
           n_kv_heads=4, head_dim=16, n_experts=4, moe_top_k=2, moe_d_ff=64)
CASES = ("dense", "moe", "hybrid", "audio")


def _configs(case, **over):
    """(JAX config, port config) of `case`."""
    if case in ("dense", "moe"):
        kw = {**(MCFG if case == "dense" else MOE), **over}
        return JModelConfig(**kw), ModelConfig(**kw)
    arch = {"hybrid": "zamba2-7b", "audio": "seamless-m4t-large-v2"}[case]
    if case == "hybrid":
        over = dict(n_layers=5, hybrid_attn_every=3, **over)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **over),
            dataclasses.replace(tconfigs.get_smoke(arch), **over))


def _batch(cfg, b=2, s=16, seed=2):
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.arch_type == "audio":
        out["audio_embeds"] = (0.1 * rng.standard_normal(
            (b, s // cfg.enc_frames_ratio, cfg.d_model))).astype(ml_dtypes.bfloat16).astype(
            np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode()).hexdigest()


def _jax_run(jcfg, qkw, batch, store):
    """Loss and gradients of the JAX package's model under `qkw`, gathered
    weights' digests into `store`; the initial params (numpy)."""
    jm = JModel(jcfg, JMS, JQSDPConfig(**qkw))
    orig = jm.engine._reshape_full

    def hook(name, full):
        n = jm.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: store.setdefault(name, set()).add(_digest(v)),
                           full[:n])
        return orig(name, full)
    jm.engine._reshape_full = hook
    params = jm.init_params(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
          for k, v in batch.items()}
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def f(p, b):
        return jax.value_and_grad(lambda pp: jm.loss_fn(pp, b, key))(p)

    loss, grads = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                                    check_vma=False))(params, jb)
    jax.effects_barrier()
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, \
        {k: np.array(v) for k, v in params.items()}


def _count(monkeypatch):
    """Count K1/K2 calls of the plain versions (the wrappers count launches
    on a device only) and the engine's prefetch starts."""
    counts = {"quantize_pack": 0, "unpack_dequantize": 0, "starts": 0}
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            counts[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    from repro_torch.core import qsdp

    def start(self, *a, _orig=qsdp.QSDPEngine.gather_layer_start, **k):
        counts["starts"] += 1
        return _orig(self, *a, **k)
    monkeypatch.setattr(qsdp.QSDPEngine, "gather_layer_start", start)
    return counts


def _port_run(tcfg, qkw, params, batch, store=None, counts=None):
    """Loss, gradients and (with `counts`) K1/K2 calls of one microbatch of
    the port's model under `qkw` from the rest params `params`."""
    tm = Model(tcfg, MS, QSDPConfig(**qkw))
    if store is not None:
        orig = tm.engine._reshape_full

        def hook(name, full):
            n = tm.specs[name].n_logical_local(1)
            store.setdefault(name, set()).add(_digest(full[:n].detach().numpy()))
            return orig(name, full)
        tm.engine._reshape_full = hook
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    names = sorted(tp)
    before = dict(counts) if counts is not None else None
    loss = tm.loss_fn(tp, _torch_batch(batch), prng.PRNGKey(3))
    grads = torch.autograd.grad(loss, [tp[n] for n in names])
    used = None if counts is None else {k: counts[k] - before[k] for k in counts}
    return tm, loss.item(), {n: g.numpy() for n, g in zip(names, grads)}, used


@pytest.fixture(scope="module")
def jax_runs():
    """Per case the JAX package's prefetch run under F32: (loss, grads,
    digests, params)."""
    out = {}
    for case in CASES:
        jcfg, _ = _configs(case)
        store = {}
        loss, grads, params = _jax_run(jcfg, dict(F32, prefetch=True), _batch(jcfg), store)
        out[case] = (loss, grads, store, params)
    return out


@pytest.mark.parametrize("case", CASES)
def test_prefetch_matches_jax_prefetch(case, jax_runs):
    jloss, jgrads, jstore, params = jax_runs[case]
    _, tcfg = _configs(case)
    tstore = {}
    tm, loss, grads, _ = _port_run(tcfg, dict(F32, prefetch=True), params, _batch(tcfg),
                                   tstore)
    assert all(tm.pipelined(p, n) for p in {k.split("/")[0] for k in tm.specs if "/" in k
                                            and tm.specs[k].stack}
               for n in tm.stack_traversals(p))
    assert tstore == jstore and len(tstore) > 1
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        want = jgrads[n]
        assert g.shape == want.shape and np.isfinite(g).all(), n
        assert np.abs(want).max() > 0, n
        assert np.abs(g - want).max() <= GRAD_RTOL * np.abs(want).max(), n


@pytest.mark.parametrize("case", CASES)
def test_prefetch_bit_equal_to_unpipelined_and_launches(case, jax_runs, monkeypatch):
    """Under the reference's W8G8 policy: loss and every gradient bit-equal
    to the unpipelined (coalesced) step, K1/K2 of one microbatch equal to
    the formula; dense: per tensor too."""
    params = jax_runs[case][3]
    _, tcfg = _configs(case)
    batch = _batch(tcfg)
    counts = _count(monkeypatch)
    tm0, l0, g0, c0 = _port_run(tcfg, dict(REF), params, batch, counts=counts)
    tm1, l1, g1, c1 = _port_run(tcfg, dict(REF, prefetch=True), params, batch, counts=counts)
    runs = [(l1, g1)]
    if case == "dense":
        _, lp, gp, _ = _port_run(tcfg, dict(REF, coalesce=False), params, batch)
        runs.append((lp, gp))
    for loss, grads in runs:
        assert loss == l0
        assert all(np.array_equal(grads[k], g0[k]) for k in g0)
    cs = _chip_smoke()
    for tm, c, starts in ((tm0, c0, 0), (tm1, c1, tcfg.n_layers + tcfg.n_enc_layers)):
        want = cs.expected_train_launches(tm, 1)
        assert c == {"quantize_pack": want["quantize_pack"],
                     "unpack_dequantize": want["unpack_dequantize"], "starts": starts}
    # prefetch removes the replay's encodes of every pipelined layer and
    # keeps its decodes
    w0, w1 = cs.expected_train_launches(tm0, 1), cs.expected_train_launches(tm1, 1)
    eng = tm1.engine
    stacked_q = sum(eng._is_quantized(sp) * sp.stack for sp in eng.specs.values() if sp.stack)
    assert w0["per_micro"][1] - w1["per_micro"][1] == stacked_q > 0
    assert (w1["per_micro"][0], w1["per_micro"][2]) == (w0["per_micro"][0], w0["per_micro"][2])
    assert w1["k2_per_micro"] == w0["k2_per_micro"]
    if case == "dense":
        # embed + 3 layers x 7 weights: forward 22, replay 21, gradients 22
        assert w0["per_micro"] == (22, 21, 22) and w1["per_micro"] == (22, 0, 22)


@pytest.mark.parametrize("why", ["one layer", "coalesce_max_bytes"])
def test_fallbacks_take_the_unpipelined_path(why, monkeypatch):
    over = dict(n_layers=1) if why == "one layer" else {}
    qkw = dict(REF) if why == "one layer" else dict(REF, coalesce_max_bytes=0)
    _, tcfg = _configs("dense", **over)
    tm = Model(tcfg, MS, QSDPConfig(**qkw))
    params = {k: v.numpy() for k, v in tm.init_params(0, "cpu").items()}
    batch = _batch(tcfg)
    counts = _count(monkeypatch)
    _, l0, g0, c0 = _port_run(tcfg, qkw, params, batch, counts=counts)
    tm1, l1, g1, c1 = _port_run(tcfg, dict(qkw, prefetch=True), params, batch, counts=counts)
    assert not tm1.pipelined("layers", tcfg.n_layers)
    assert c1 == c0 and c1["starts"] == 0
    assert l1 == l0 and all(np.array_equal(g1[k], g0[k]) for k in g0)


def test_two_train_steps_bit_equal_to_unpipelined():
    """AdamW with 8-bit moments on a quantized_state, two steps of two
    microbatches each: losses, grad norms and every state byte equal."""
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.checkpoint import state_to_flat
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        quantize_train_state)
    _, tcfg = _configs("dense")
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(rng.integers(0, 256, (4, 16))).long()
                for k in ("tokens", "labels")} for _ in range(2)]
    out = []
    for pf in (False, True):
        model = Model(tcfg, MS, QSDPConfig(min_quant_size=128, prefetch=pf))
        opt = make_adamw(AdamWConfig(lr=1e-3, schedule=cosine_schedule(1e-3, 1, 4),
                                     moment_bits=8))
        st = quantize_train_state(init_train_state(model, opt, 0, "cpu"), model,
                                  prng.PRNGKey(2))
        step = build_train_step(model, opt, n_micro=2, quantized_state=True, device="cpu")
        mets = []
        for i, b in enumerate(batches):
            st, m = step(st, b, prng.fold_in(prng.PRNGKey(1), i))
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        out.append((mets, state_to_flat(st)[0]))
    (m0, f0), (m1, f1) = out
    assert m0 == m1
    assert sorted(f0) == sorted(f1) and all(f0[k].tobytes() == f1[k].tobytes() for k in f0)


def test_meta_marginal_per_layer_under_prefetch(monkeypatch):
    """The train step counted on meta at depths 2 and 4 (gpt-125m's smoke
    config, the collective audit's harness): each added layer adds one
    layer gather (the forward's; two unpipelined) and the K1/K2 of
    ``collective_audit.train_layer_launches``."""
    from repro_torch.analysis import collective_audit
    from repro_torch.roofline.counter import marginal
    cfg = tconfigs.get_smoke("gpt-125m")
    gathers = {"n": 0}

    def gather_wire(buf, group=None, _orig=coll.gather_wire):
        gathers["n"] += 1
        return _orig(buf, group)
    monkeypatch.setattr(coll, "gather_wire", gather_wire)
    for pf, per_layer in ((False, 2), (True, 1)):
        qcfg = QSDPConfig(min_quant_size=256, prefetch=pf)
        counted = {}
        for depth in collective_audit.DEPTHS:
            gathers["n"] = 0
            counted[depth] = collective_audit._step_counts(cfg, qcfg, depth)
            counted[depth]["gathers"] = gathers["n"]
        lo, hi = collective_audit.DEPTHS
        marg = marginal(counted[hi], counted[lo], hi - lo)
        eng = Model(cfg, MS, qcfg).engine
        names = sorted(n for n in eng.specs if n.startswith("layers/"))
        want = collective_audit.train_layer_launches(eng, names)
        assert marg["gathers"] == per_layer
        assert {k: marg["launches"][k] for k in want} == want


@pytest.mark.parametrize("arch", ["gpt-1.3b", "seamless-m4t-large-v2"])
def test_serving_under_prefetch_equals_unpipelined(arch, monkeypatch):
    """No serving path runs the pipeline (the audio prefill's encoder passes
    its own gather of wire-form slices; decode steps run no layer loop of
    ``_scan_layers``): under a prefetch config the tokens, and the engine
    calls, are the unpipelined config's."""
    from repro_torch.serve import build_serve_setup, make_prompt_batch
    counts = _count(monkeypatch)
    toks = []
    for pf in (False, True):
        ts = build_serve_setup(arch, qsdp=QSDPConfig(prefetch=pf), batch=2, prompt_len=8, gen=3,
                               device="cpu")
        tokens = np.random.default_rng(0).integers(0, ts.cfg.vocab_size, (2, 8))
        batch = make_prompt_batch(ts.cfg, ts.spec, ts.ms, tokens, "cpu")
        toks.append(ts.engine.generate(ts.params, batch, n_tokens=3,
                                       key=prng.PRNGKey(3)).numpy())
    assert np.array_equal(toks[0], toks[1]) and counts["starts"] == 0
