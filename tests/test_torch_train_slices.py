"""The train step's memory schedule on the CPU: gradients per layer slice,
the global norm and the optimizer update per chunk (``optim.chunk_ranges``).

  (a) the chunked update is torch.equal to the whole-leaf arithmetic
      (``chip_smoke.whole_leaf_adamw``, and SGD's below) for every
      optimizer: a stacked leaf of 4 buckets a slice whose gradient comes
      as its layer slices, a stacked leaf whose slices share buckets
      (updated whole), an unstacked leaf in ranges of CHUNK values whose
      last one ends inside a bucket; 8-bit moment wires byte-equal to
      ``qparam_encode`` of the whole updated moment;
  (b) allocations, seen by a ``TorchDispatchMode`` during one olmoe smoke
      step at n_micro 2 with 8-bit moments: none in the backward of a
      stacked leaf's full size, none in the norm or the update larger than
      one chunk;
  (c) the olmoe and zamba2 smoke steps with 8-bit moments: two steps with
      the chunked update equal to two with the whole-leaf one, and against
      the JAX package two steps each from its state, within the
      one-step tolerances of ``_torch_train_common.py`` (the f32-moment
      trajectories are ``test_torch_moe_train_step.py``'s and
      ``test_torch_ssm_train_step_hybrid.py``'s).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.optim.optimizers as optim_mod
import repro_torch.train.step as step_mod
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.core.quant import QuantizedParam, qparam_encode
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.optim import (AdamWConfig, OptState, SGDConfig, cosine_schedule, make_adamw,
                               make_sgd)
from repro_torch.models.transformer import Model
from _torch_train_common import (GNORM_RTOL, LOSS_RTOL, MS, assert_step_close, models,
                                 run_both)

torch.set_num_threads(1)
CHUNK = 2048  # optim_mod.CHUNK_VALUES in these tests: the unstacked leaf in 4 ranges
SHAPES = {"a": (1, 1, 3 * CHUNK + 904), "b": (3, 1, 1, 4 * 1024), "c": (3, 1, 1, 100)}


@pytest.fixture(scope="module")
def cs():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def whole_leaf_sgd(cfg, params, grads, st, grad_scale):
    """SGD on whole leaves, the arithmetic the chunked update is held to."""
    lr = cfg.schedule(st.step + 1)
    for k, p in params.items():
        d = grads[k].float() * grad_scale
        if cfg.weight_decay:
            d = d + cfg.weight_decay * p
        if cfg.momentum:
            d = st.mu[k].mul_(cfg.momentum).add_(d)
        p.sub_(lr * d)


@pytest.mark.parametrize("kind", ["adamw", "adamw_wd", "adamw_m8", "sgd", "sgd_momentum"])
def test_chunked_update_equals_whole_leaf(cs, kind, monkeypatch):
    monkeypatch.setattr(optim_mod, "CHUNK_VALUES", CHUNK)
    assert [len(optim_mod.chunk_ranges(s)) for s in SHAPES.values()] == [4, 3, 1]
    gen = torch.Generator().manual_seed(0)
    sched = cosine_schedule(1e-2, 1, 5)
    if kind.startswith("adamw"):
        kw = dict(adamw={}, adamw_wd=dict(weight_decay=0.1), adamw_m8=dict(moment_bits=8))[kind]
        cfg = AdamWConfig(lr=1e-2, schedule=sched, **kw)
        opt = make_adamw(cfg)
    else:
        cfg = SGDConfig(lr=1e-2, momentum=0.9 if kind == "sgd_momentum" else 0.0,
                        weight_decay=0.01, schedule=sched)
        opt = make_sgd(cfg)
    pc = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
    pw = {k: v.clone() for k, v in pc.items()}
    sc, sw = opt.init(pc), opt.init(pw)
    scale = torch.tensor(0.5)
    for _ in range(3):
        g = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
        # the stacked leaves' gradients as the train step hands them over
        gc = {k: list(v.clone().unbind(0)) if v.dim() == 4 else v.clone() for k, v in g.items()}
        pc, sc = opt.update(pc, gc, sc, grad_scale=scale)
        assert gc == {}  # every chunk's gradient was taken
        if kind.startswith("adamw"):
            mu, nu = cs.whole_leaf_adamw(torch, cfg, pw, g, sw, scale)
            sw = OptState(step=sw.step + 1, mu=mu, nu=nu)
        else:
            whole_leaf_sgd(cfg, pw, g, sw, scale)
            sw = OptState(step=sw.step + 1, mu=sw.mu, nu=())
        for k in SHAPES:
            assert torch.equal(pc[k], pw[k]), k
        for tc, tw in ((sc.mu, sw.mu), (sc.nu, sw.nu)):
            for k in (tc or {}):
                if kind == "adamw_m8":
                    assert isinstance(tc[k], QuantizedParam)
                    assert torch.equal(tc[k].wire, tw[k].wire), k
                else:
                    assert torch.equal(tc[k], tw[k]), k


def test_range_encode_matches_whole_stack_encode():
    """A stacked moment re-encoded slice by slice in place is the whole
    stack's ``qparam_encode``, byte for byte, and each slice's K2 entry
    decodes its own rows."""
    from repro_torch.core.quant import qparam_decode, qparam_encode_range, qparam_range
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    x, y = (torch.randn((3, 1, 1, 2048), generator=gen) for _ in range(2))
    cfg = optim_mod.make_adamw(AdamWConfig(moment_bits=8)).init({"x": x}).mu["x"].cfg
    qp = qparam_encode(x, cfg)
    for i in range(3):
        qparam_encode_range(qp, i * 2048, y[i].reshape(2, 1024))
        got, = ops.unpack_dequantize_wire(qp.wire.view(-1), [qparam_range(qp, i * 2048,
                                                                          (i + 1) * 2048)],
                                          [torch.float32])
        assert torch.equal(got.reshape(-1), qparam_decode(qp)[i].reshape(-1))
    assert torch.equal(qp.wire, qparam_encode(y, cfg).wire)


class _Allocations(TorchDispatchMode):
    """Records (stage, numel, shape) of every tensor an op makes anew (views
    and in-place or out= ops make none)."""

    def __init__(self, stage):
        super().__init__()
        self.stage, self.seen = stage, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func._schema.is_mutable:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.seen.append((self.stage[0], t.numel(), tuple(t.shape)))
        return out


def test_step_allocates_no_second_copy(monkeypatch):
    """One step of olmoe's smoke config at 6 layers (n_micro 2, 8-bit
    moments), where an expert stack (786,432 values) outsizes every other
    tensor of the step (a layer's coalesced gradient buffer holds 666,624):
    the backward makes no tensor of a stacked leaf's full size (the
    per-slice gradients sum in place), the norm and the update none larger
    than one chunk."""
    monkeypatch.setattr(optim_mod, "CHUNK_VALUES", 4096)
    model = Model(dataclasses.replace(tconfigs.get_smoke("olmoe-1b-7b"), n_layers=6), MS,
                  QSDPConfig())
    opt = make_adamw(AdamWConfig(lr=1e-3, moment_bits=8))
    state = step_mod.init_train_state(model, opt, 0, "cpu")
    stage = ["set-up"]

    def staged(name, fn):
        def f(*a, **k):
            stage[0] = name
            out = fn(*a, **k)
            stage[0] = "backward" if name == "forward" else "after"
            return out
        return f

    monkeypatch.setattr(model, "loss_fn", staged("forward", model.loss_fn))
    monkeypatch.setattr(step_mod, "global_norm", staged("norm", step_mod.global_norm))
    opt = optim_mod.Optimizer(init=opt.init, update=staged("update", opt.update),
                              quantized_moments=True)
    step = step_mod.build_train_step(model, opt, n_micro=2, device="cpu")
    data = SyntheticLM(model.cfg.vocab_size, 8, 2, seed=0)
    stacked = {tuple(v.shape): k for k, v in state.params.items() if v.dim() == 4}
    full = max(v.numel() for v in state.params.values() if v.dim() == 4)
    # the largest chunk: a layer slice of an expert stack (the embedding's
    # ranges of 4,096 values and the norm stacks, updated whole, are smaller)
    chunk = max(v[0].numel() for v in state.params.values() if v.dim() == 4)
    assert chunk == 131072 < state.params["embed"].numel() < full
    with _Allocations(stage) as mode:
        step(state, make_batch(data, 0, "cpu"), prng.PRNGKey(1))
    by = {}
    for st, n, shape in mode.seen:
        by.setdefault(st, []).append((n, shape))
    assert set(by) >= {"forward", "backward", "norm", "update"}
    bwd = by["backward"]
    assert not [s for _, s in bwd if s in stacked], "a stacked leaf's full-size tensor"
    assert max(n for n, _ in bwd) < full
    assert max(n for n, _ in by["norm"] + by["update"]) <= chunk


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b"])
def test_slice_steps_equal_whole_leaf_steps(cs, arch):
    """Two steps of the smoke config (n_micro 2, 8-bit moments; the second
    decodes trained moment codes) with the chunked update and with
    ``chip_smoke.whole_leaf_adamw`` in its place, from the same state:
    losses, grad norms, every parameter and moment wire equal."""
    _, model = models(arch=arch)
    cfg = AdamWConfig(lr=1e-3, schedule=cosine_schedule(1e-3, 2, 10), moment_bits=8)
    opt = make_adamw(cfg)

    def whole(params, grads, st, grad_scale):
        grads = {k: torch.stack(g) if isinstance(g, list) else g for k, g in grads.items()}
        mu, nu = cs.whole_leaf_adamw(torch, cfg, params, grads, st, grad_scale)
        return params, OptState(step=st.step + 1, mu=mu, nu=nu)

    data = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=0)
    runs = []
    for o in (opt, optim_mod.Optimizer(init=opt.init, update=whole, quantized_moments=True)):
        state = step_mod.init_train_state(model, o, 0, "cpu")
        step = step_mod.build_train_step(model, o, n_micro=2, device="cpu")
        metrics = []
        for i in range(2):
            state, m = step(state, make_batch(data, i, "cpu"), prng.fold_in(prng.PRNGKey(1), i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, state))
    (mc, sc), (mw, sw) = runs
    assert mc == mw and np.isfinite(mc).all()
    for k in sc.params:
        assert torch.equal(sc.params[k], sw.params[k]), k
        for tc, tw in ((sc.opt.mu, sw.opt.mu), (sc.opt.nu, sw.opt.nu)):
            assert torch.equal(tc[k].wire, tw[k].wire), k


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b"])
def test_slice_steps_with_8bit_moments_match_jax(arch):
    """Two steps with 8-bit moments at n_micro 2, each from the JAX
    package's state (at step 2 the moments are trained codes, which
    the chunked update decodes and re-encodes by range): every step's loss
    and grad norm within LOSS_RTOL / GNORM_RTOL, step 1's parameters within
    the one-step tolerances.  At step 2 the parameters are not held
    to them: where a stochastic gradient code flips between the frameworks
    (PARAM_EXACT_SHARE), an element whose second moment decodes near zero
    moves by up to ~300 lr on either side (this tree and its parent alike),
    which is what the 8-bit moments of the reference do, not a property of
    the chunked update; ``test_slice_steps_equal_whole_leaf_steps`` holds
    the update itself."""
    rows, after = run_both(*models(arch=arch, compute_dtype="float32"), 2, moment_bits=8,
                           synced=True)
    for jl, tl, jg, tg in rows:
        assert np.isfinite(tl) and abs(tl - jl) <= LOSS_RTOL * abs(jl)
        assert abs(tg - jg) <= GNORM_RTOL * abs(jg)
    assert_step_close(rows[:1], after[0])
