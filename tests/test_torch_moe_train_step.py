"""MoE training steps, the port against the JAX package on the CPU (set-up
and tolerances in ``_torch_train_common.py``), olmoe-1b-7b's smoke config
(2 layers, d 256, 4 experts top-2, vocab 1024), f32 compute, batches of 4
x 32 in 2 microbatches (64 tokens, capacity 40 slots per expert):

  (c) one step: loss (load-balance term included), grad norm and updated
      params within LOSS_RTOL / GNORM_RTOL / PARAM_*;
  (d) a 10-step loss trajectory within TRAJ_RTOL, under the router-margin
      rule: a step is compared while both packages route every token to
      the same experts and the port's top-k margin (k-th minus (k+1)-th
      probability) stays at or above ROUTE_MARGIN.  Step 1 starts both from
      the same state, where the margin rule is what makes the routes agree;
      once a gradient code has flipped (``PARAM_EXACT_SHARE``), parameters
      differ by up to 2 lr and a token near a tie may go to another expert,
      after which the two runs are different MoE trajectories.  The steps
      left out are counted and every step's loss must be finite.
"""
import types

import jax
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro_torch.models import moe
from _torch_train_common import STEPS, TRAJ_RTOL, assert_step_close, digest, models, run_both

ROUTE_MARGIN = 1e-5  # chip_smoke.ROUTE_MARGIN


@pytest.fixture(scope="module")
def moe_runs():
    """(rows, first) of run_both over STEPS steps, and per step the JAX and
    the port top-k ids of every routing (forward and replay) and the port's
    smallest top-k margin."""
    jids, tids, margins = [], [], []

    def jtop_k(a, k):
        v, i = jax.lax.top_k(a, k)
        jax.debug.callback(lambda t: jids.append(np.asarray(t).astype(np.int64)), i)
        return v, i

    troute = moe.route

    def route(x, router, cfg):
        p, w, e = troute(x, router, cfg)
        s = torch.sort(p.detach(), dim=-1, descending=True).values
        margins.append(float((s[:, cfg.top_k - 1] - s[:, cfg.top_k]).min()))
        tids.append(e.numpy().copy())
        return p, w, e

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "lax", types.SimpleNamespace(top_k=jtop_k,
                                                      all_to_all=jax.lax.all_to_all))
        mp.setattr(moe, "route", route)
        rows, first = run_both(*models(arch="olmoe-1b-7b", compute_dtype="float32"), STEPS)
    assert len(jids) == len(tids) == len(margins) and len(tids) % STEPS == 0
    per = len(tids) // STEPS  # 2 microbatches x 2 layers x (forward, replay)
    assert per == 8
    steps = [(sorted(map(digest, jids[i * per:(i + 1) * per])),
              sorted(map(digest, tids[i * per:(i + 1) * per])),
              min(margins[i * per:(i + 1) * per])) for i in range(STEPS)]
    return rows, first, steps


def _compared(steps):
    n = 0
    while n < len(steps) and steps[n][0] == steps[n][1] and steps[n][2] >= ROUTE_MARGIN:
        n += 1
    return n


def test_one_moe_f32_step_matches_jax(moe_runs):
    rows, first, steps = moe_runs
    assert _compared(steps) >= 1
    assert_step_close(rows, first)


def test_moe_loss_trajectory(moe_runs):
    rows, _, steps = moe_runs
    n = _compared(steps)
    assert n >= 2, f"only {n} steps route alike in both packages"
    print(f"router-margin rule: {n} of {STEPS} steps compared, {STEPS - n} left out")
    for i, (jl, tl, _, _) in enumerate(rows):
        assert np.isfinite(jl) and np.isfinite(tl), i
        if i < n:
            assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), i
