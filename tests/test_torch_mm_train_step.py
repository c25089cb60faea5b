"""VLM and audio training steps, the port against the JAX package on the
CPU (set-up and tolerances in ``_torch_train_common.py``): qwen2-vl-72b's
smoke config (batches with a 2 x 4 image block, Qwen2-VL's positions and
masked labels under it) and seamless-m4t-large-v2's (batches with the frame
stub), f32 compute, default QSDP policy otherwise (W8 shift gathers, G8
stochastic gradients), batches of 4 x 32 in 2 microbatches, so the VLM's
(3, 4, 32) positions split on their batch axis:

  (c) one ``build_train_step`` step against ``make_jitted_train_step``:
      loss, grad norm and updated params within LOSS_RTOL / GNORM_RTOL /
      PARAM_*;
  (d) a loss trajectory within TRAJ_RTOL: 10 steps of the VLM, 3 of the
      audio model (its CPU step is the slower one, ~2.3 s on one thread:
      the encoder and decoder's plain threefry draws).
"""
import pytest
import torch

from repro_torch.train.step import _split
from _torch_train_common import STEPS, TRAJ_RTOL, assert_step_close, models, run_both

# steps of each arch's trajectory
ARCHS = {"qwen2-vl-72b": STEPS, "seamless-m4t-large-v2": 3}


@pytest.fixture(scope="module", params=list(ARCHS))
def runs(request):
    return ARCHS[request.param], run_both(*models(arch=request.param, compute_dtype="float32"),
                                          ARCHS[request.param])


def test_one_mm_f32_step_matches_jax(runs):
    assert_step_close(*runs[1])


def test_mm_loss_trajectory(runs):
    n, (rows, _) = runs
    assert len(rows) == n
    for i, (jl, tl, _, _) in enumerate(rows):
        assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), i


def test_positions_split_on_their_batch_axis():
    """Microbatch i holds rows i * B / n of every leaf, the three position
    streams of each; a batch axis that does not split raises."""
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    tok = torch.arange(4 * 5).reshape(4, 5)
    for n in (1, 2, 4):
        p, t = _split("positions", pos, n), _split("tokens", tok, n)
        assert tuple(p.shape) == (n, 3, 4 // n, 5) and tuple(t.shape) == (n, 4 // n, 5)
        for i in range(n):
            rows = slice(i * 4 // n, (i + 1) * 4 // n)
            assert torch.equal(p[i], pos[:, rows]) and torch.equal(t[i], tok[rows])
    with pytest.raises(ValueError, match="positions of 4 rows does not split into 3"):
        _split("positions", pos, 3)
