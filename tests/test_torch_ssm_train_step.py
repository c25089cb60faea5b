"""SSM training steps, the port against the JAX package on the CPU (set-up
and tolerances in ``_torch_train_common.py``), mamba2-370m's smoke config
(2 Mamba2 layers, d 256, 16 heads of 32, state 16, chunk 32, vocab 1024),
f32 compute, default QSDP policy otherwise (W8 shift gathers, G8 stochastic
gradients), batches of 4 x 32 in 2 microbatches:

  (c) one ``build_train_step`` step: loss, grad norm and updated params
      within LOSS_RTOL / GNORM_RTOL / PARAM_*;
  (d) a 10-step loss trajectory within TRAJ_RTOL.
"""
import pytest

from _torch_train_common import STEPS, TRAJ_RTOL, assert_step_close, models, run_both

ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def runs():
    return run_both(*models(arch=ARCH, compute_dtype="float32"), STEPS)


def check_one_step(runs):
    assert_step_close(*runs)


def check_trajectory(runs):
    rows, _ = runs
    assert len(rows) == STEPS
    for i, (jl, tl, _, _) in enumerate(rows):
        assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), i


def test_one_ssm_f32_step_matches_jax(runs):
    check_one_step(runs)


def test_ssm_loss_trajectory(runs):
    check_trajectory(runs)
