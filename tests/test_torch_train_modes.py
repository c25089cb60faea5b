"""The training slice's other modes on the CPU (set-up and tolerances in
``_torch_train_common.py``):

  (e) the port's quantized_state step bit-exact with its quantize_master
      step (losses, grad norms, params and 8-bit moments), as
      ``tests/test_quantized_state.py`` holds the JAX package;
  (f) the fp baseline (``QSDPConfig.baseline()``: fp32 weights, bf16
      gradients, per-tensor collectives) step against the JAX package.
"""
import pytest
import torch

from repro_torch.configs import gpt_1_3b as tcfg_mod
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.step import (build_train_step, dequantize_train_state,
                                    init_train_state, quantize_train_state)
from _torch_train_common import LR, MS, N_MICRO, assert_step_close, batches, models, run_both


def test_baseline_fp_step_matches_jax():
    jm, tm = models(baseline=True, compute_dtype="float32")
    assert not tm.qcfg.quantize_weights and not tm.qcfg.quantize_grads
    assert_step_close(*run_both(jm, tm, 1))


def test_quantized_state_bitexact_with_quantize_master():
    tm = Model(tcfg_mod.smoke(), MS, QSDPConfig())
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    qs = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(9))
    fs = dequantize_train_state(qs)
    step_q = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    step_f = build_train_step(tm, opt, n_micro=N_MICRO, quantize_master=True, device="cpu")
    for i, batch in enumerate(batches(3)):
        b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        qs, mq = step_q(qs, b, prng.fold_in(prng.PRNGKey(7), i))
        fs, mf = step_f(fs, b, prng.fold_in(prng.PRNGKey(7), i))
        assert float(mq["loss"]) == float(mf["loss"])
        assert float(mq["grad_norm"]) == float(mf["grad_norm"])
    dq, df = dequantize_train_state(qs), dequantize_train_state(fs)
    for tree_q, tree_f in ((dq.params, df.params), (dq.opt.mu, df.opt.mu), (dq.opt.nu, df.opt.nu)):
        for k in tree_f:
            assert torch.equal(tree_q[k], tree_f[k]), k


def test_chip_smoke_train_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s train phase, run on the CPU at the smoke config:
    its control flow, its checks, and the K1/K2 launch counts it derives
    from the code's structure (``expected_train_launches``) against the
    wrappers' calls (which count only kernel launches, so the rehearsal
    counts calls)."""
    import importlib.util
    from pathlib import Path

    from repro_torch import configs
    from repro_torch.kernels import ops

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(cs.TRAIN, "seq", 32)
    # the profiled step reads kernel events, which only the card records
    profiled = []
    monkeypatch.setattr(cs, "profile_train_step",
                        lambda torch_, run, state, log: profiled.append(run(state)) or dict(
                            k1_ms=0.0, k1_n=0, k2_ms=0.0, k2_n=0, int64_ms=0.0, int64_n=0,
                            threefry_int64=0))
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    lines = []
    counts = cs.train_phase(torch, lines.append, dev="cpu")
    want = cs.expected_train_launches(Model(configs.get_smoke("gpt-1.3b"), MS, QSDPConfig()), 2)
    # smoke: 1 embed + 2 layers x 7 weights; every one of them grad-quantized
    assert want["per_micro"] == (15, 14, 15)
    assert counts["quantize_pack"] == cs.TRAIN_TIMED * want["quantize_pack"] == 3 * 2 * 44
    # K2: one launch per buffer -- embed + 2 layers, 2 replayed layers,
    # embed + 2 layer gradients (the final norm's buffers are fp only)
    assert want["k2_per_micro"] == (3, 2, 3)
    assert counts["unpack_dequantize"] == cs.TRAIN_TIMED * want["unpack_dequantize"] == 3 * 2 * 8
    assert any("quantized_state == quantize_master" in x for x in lines)
    # the prefetch run: bit-equal to "full", launches by the prefetch formula
    assert any("train prefetch: losses and grad norms bit-equal" in x for x in lines)
    assert len(profiled) == 1


@pytest.mark.parametrize("kind", ["adamw", "adamw_wd", "adamw_m8", "sgd", "sgd_momentum"])
def test_optimizer_updates_match_jax(kind):
    """Three updates of the port's optimizers against the JAX package's on
    the same rest-layout params and grads (cosine schedule, clip scale):
    f32 elementwise math, within 1e-6 relative (the frameworks may round
    the schedule's cos/pow and a contracted multiply-add differently).
    Leaf "c" is a stacked leaf of two buckets a slice whose gradient the
    port takes as its layer slices, as the train step hands it over: the
    update walks it slice by slice."""
    import jax.numpy as jnp
    import numpy as np
    from repro.core.quant import QuantizedParam as JQP, qparam_decode as jdecode
    from repro.optim import (AdamWConfig as JAdamW, SGDConfig as JSGD, cosine_schedule as jcos,
                             make_adamw as jadamw, make_sgd as jsgd)
    from repro_torch.core.quant import QuantizedParam, qparam_decode
    from repro_torch.optim import SGDConfig, cosine_schedule, make_sgd

    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((1, 1, 3000)).astype(np.float32),
              "b": rng.standard_normal((2, 1, 1, 1024)).astype(np.float32),
              "c": rng.standard_normal((3, 1, 1, 2048)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    kw = dict(adamw=dict(), adamw_wd=dict(weight_decay=0.1), adamw_m8=dict(moment_bits=8))
    if kind.startswith("adamw"):
        jopt = jadamw(JAdamW(lr=1e-2, schedule=jcos(1e-2, 1, 5), **kw[kind]))
        topt = make_adamw(AdamWConfig(lr=1e-2, schedule=cosine_schedule(1e-2, 1, 5), **kw[kind]))
    else:
        mom = 0.9 if kind == "sgd_momentum" else 0.0
        jopt = jsgd(JSGD(lr=1e-2, momentum=mom, weight_decay=0.01, schedule=jcos(1e-2, 1, 5)))
        topt = make_sgd(SGDConfig(lr=1e-2, momentum=mom, weight_decay=0.01,
                                  schedule=cosine_schedule(1e-2, 1, 5)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, grad_scale=0.5)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tg["c"] = list(tg["c"].unbind(0))
        tp, ts = topt.update(tp, tg, ts, grad_scale=torch.tensor(0.5))
    assert ts.step == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    if kind == "adamw_m8":
        for jt, tt in ((js.mu, ts.mu), (js.nu, ts.nu)):
            for k in params:
                assert isinstance(jt[k], JQP) and isinstance(tt[k], QuantizedParam)
                np.testing.assert_allclose(qparam_decode(tt[k]).numpy(),
                                           np.asarray(jdecode(jt[k])), rtol=1e-6, atol=1e-7)
