"""``train_run`` of the port against the JAX package's for 5 steps of the
bench GPT from the same state (``_torch_exp_common.check_train_run``), at
the experiments' other wire policies: W4G8 at bucket 256 (Table 3) and
Table 1's unbucketed round-to-nearest (W8G8 nearest, bucket 65536)."""
import pytest
import torch

from _torch_exp_common import check_train_run

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", ["w4g8-b256", "rtn-nobucket"])
def test_train_run_matches_reference(policy):
    check_train_run(policy)
