"""Hybrid training steps, the port against the JAX package on the CPU, as
``test_torch_ssm_train_step.py`` does for the SSM family, at zamba2-7b's
smoke config (3 Mamba2 layers, the shared attention+MLP block after every
2: one group and a one-layer tail; d 256, 8 heads of 32, d_ff 512)."""
import pytest

from _torch_train_common import STEPS, models, run_both
from test_torch_ssm_train_step import check_one_step, check_trajectory


@pytest.fixture(scope="module")
def runs():
    return run_both(*models(arch="zamba2-7b", compute_dtype="float32"), STEPS)


def test_one_hybrid_f32_step_matches_jax(runs):
    check_one_step(runs)


def test_hybrid_loss_trajectory(runs):
    check_trajectory(runs)
