"""SSM/hybrid training, the loss and its gradients: ``Model.loss_fn`` of the
port against ``jax.value_and_grad`` of the JAX package's ``Model.loss_fn``
(under ``shard_map`` on the (1, 1) mesh) on the CPU, from the same rest
parameters and batch, for mamba2-370m's smoke config (2 Mamba2 layers),
and zamba2-7b's (3 layers, a shared block every 2: one group and a
one-layer tail); ``test_torch_ssm_train_grads_hybrid.py`` adds zamba2-7b's
at 5 layers (two groups, so the shared block's gradient sums two
invocations, and a tail).

Weights are gathered as the step gathers them (W8 shift, byte-equal
between the packages); the gradients leave the reduce-scatter unquantized
in f32 (``quantize_grads=False``, ``grad_wire_dtype="float32"``), so that
every parameter's gradient compares as the function it is.  The quantized
reduce-scatter's bytes for the same cotangent are held in
``test_torch_ssm_train.py`` and the quantized step in
``test_torch_ssm_train_step*.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.compat import shard_map
from repro.core.qsdp import QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.models.transformer import Model
from _torch_train_common import JMS, LOSS_RTOL, MS, batches

torch.set_num_threads(1)

# f32: the products, the scan and the reductions run in other orders (<=
# 4.5e-6 of each tensor's largest gradient measured)
GRAD_RTOL = 2e-5
POLICY = dict(compute_dtype="float32", quantize_grads=False, grad_wire_dtype="float32")


def check_loss_and_grads(arch, mesh11, **over):
    """`arch`'s smoke config with the fields `over` replaced."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **over)
    jm, tm = JModel(jcfg, JMS, JQSDPConfig(**POLICY)), Model(tcfg, MS, QSDPConfig(**POLICY))
    params = jm.init_params(jax.random.PRNGKey(0))
    batch = {k: v[:2] for k, v in batches(1)[0].items()}
    key = jax.random.PRNGKey(3)

    def f(p, b):
        return jax.value_and_grad(lambda pp: jm.loss_fn(pp, b, key))(p)

    jloss, jgrads = jax.jit(shard_map(f, mesh=mesh11, in_specs=(P(), P()),
                                      out_specs=(P(), P()), check_vma=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    names = sorted(tp)
    loss = tm.loss_fn(tp, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                      prng.PRNGKey(3))
    grads = torch.autograd.grad(loss, [tp[n] for n in names])
    jl = float(jloss)
    assert abs(loss.item() - jl) <= LOSS_RTOL * abs(jl)
    assert sorted(jgrads) == names
    if arch == "zamba2-7b":
        assert any(n.startswith("shared/") for n in names)
    for n, g in zip(names, grads):
        want = np.asarray(jgrads[n])
        got = g.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), n
        assert np.abs(want).max() > 0, n
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (n, err, np.abs(want).max())


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_loss_and_grads_match_jax(arch, mesh11):
    check_loss_and_grads(arch, mesh11)
