"""The hybrid's loss and gradients against the JAX package's (set-up and
tolerances in ``test_torch_ssm_train_grads.py``) at zamba2-7b's smoke
config cut to 5 layers: two groups of 2 Mamba2 layers, each followed by
the shared block, and a one-layer tail, so the shared block's gradient is
the sum of two invocations' reduce-scatters."""
from repro_torch import configs
from test_torch_ssm_train_grads import check_loss_and_grads


def test_hybrid_two_groups_loss_and_grads_match_jax(mesh11):
    cfg = configs.get_smoke("zamba2-7b")
    assert divmod(5, cfg.hybrid_attn_every) == (2, 1)
    check_loss_and_grads("zamba2-7b", mesh11, n_layers=5)
