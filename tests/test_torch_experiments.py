"""The experiments' trainer, port against the JAX package, on the CPU:

  (a) the reference-like initial weights (``init_params_like_reference``)
      within a few ulps of the JAX package's ``Model.init_params``;
  (b) ``train_run`` for 5 steps of the bench GPT from the JAX package's
      initial state against the JAX ``benchmarks/_trainer.train_run``'s
      losses (``_torch_exp_common.check_train_run``), for the fp baseline
      and W8G8, f32 compute (W4G8 at bucket 256 and Table 1's unbucketed
      round-to-nearest: ``test_torch_experiments_lowbit.py``);
  (c) the experiments' entry points refuse to run without a card unless
      asked for the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import _trainer as jtrainer
from repro.models.transformer import Model as JModel
from repro_torch.experiments import _trainer as ttrainer
from repro_torch.models.transformer import Model
from _torch_exp_common import JMS, check_train_run

torch.set_num_threads(1)
# the JAX init's normals go through XLA's erf_inv (its own logf, fused
# multiply-adds); the twin's polynomial rounds apart in ~4 % of values, by at
# most 4 ulp
INIT_ULP = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def test_init_like_reference_within_ulps():
    jp = JModel(jtrainer.BENCH_MODEL, JMS, jtrainer.qsdp_wg(8, 8)).init_params(
        jax.random.PRNGKey(0))
    tp = ttrainer.init_params_like_reference(
        Model(ttrainer.BENCH_MODEL, ttrainer.MESH11, ttrainer.qsdp_wg(8, 8)), 0, "cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert a.shape == b.shape, k
        assert _ulps(a, b) <= INIT_ULP, k


@pytest.mark.parametrize("policy", ["baseline", "w8g8"])
def test_train_run_matches_reference(policy):
    check_train_run(policy)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core import prng
    from repro_torch.core.theory import Quadratic, make_quadratic, run_qsgd, theorem2_params
    from repro_torch.experiments import run as exp_run

    obj = Quadratic(h=torch.ones(4), c=torch.zeros(4))
    params = theorem2_params(1.0, 1.0, 0.5, 1e-3, 0.0, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_qsgd(obj, torch.zeros(4), params, prng.PRNGKey(0)),
                 lambda: make_quadratic(prng.PRNGKey(0)),
                 lambda: ttrainer.train_run(ttrainer.qsdp_wg(8, 8), steps=1),
                 lambda: exp_run.main(["--only", "table1_recovery"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
