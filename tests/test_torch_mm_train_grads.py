"""VLM and audio training, the loss and its gradients: ``Model.loss_fn`` of
the port against ``jax.value_and_grad`` of the JAX package's
``Model.loss_fn`` (under ``shard_map`` on the (1, 1) mesh) on the CPU, from
the same rest parameters and batch, for qwen2-vl-72b's smoke config (2
layers, M-RoPE sections (8, 4, 4), qkv bias, tied head; the batch carries a
2 x 4 image block with Qwen2-VL's positions and masked labels under it) and
seamless-m4t-large-v2's (2 encoder and 2 decoder layers, untied head; the
batch carries the frame stub of S // 2 frames).

Weights are gathered as the step gathers them (W8 shift): every gathered
weight's bytes are equal between the packages, the encoder's under
``fold_in(key, 3000)`` included.  The gradients leave the reduce-scatter
unquantized in f32 (``quantize_grads=False``, ``grad_wire_dtype=
"float32"``), so that every parameter's gradient compares as the function
it is: the encoder's receive the sum of the decoder layers' cross-attention
contributions.  The quantized step is held in ``test_torch_mm_train_step.py``.
"""
import jax
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
from _torch_mm_common import digest
from _torch_train_common import JMS, LOSS_RTOL, MS, batches, to_jax, to_torch

torch.set_num_threads(1)

# f32: the products and reductions run in other orders (<= 3.4e-6 of each
# tensor's largest gradient measured on these configs, dec/xwk the worst);
# the SSM/hybrid gradient tests hold the same bound
GRAD_RTOL = 2e-5
POLICY = dict(compute_dtype="float32", quantize_grads=False, grad_wire_dtype="float32")


def _hook_jax(monkeypatch, model, store):
    orig = model.engine._reshape_full

    def hook(name, full):
        n = model.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: store.setdefault(name, set()).add(digest(v)),
                           full[:n])
        return orig(name, full)
    monkeypatch.setattr(model.engine, "_reshape_full", hook)


def _hook_port(monkeypatch, model, store):
    orig = model.engine._reshape_full

    def hook(name, full):
        n = model.specs[name].n_logical_local(1)
        store.setdefault(name, set()).add(digest(full[:n].detach().numpy()))
        return orig(name, full)
    monkeypatch.setattr(model.engine, "_reshape_full", hook)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_loss_grads_and_gathers_match_jax(arch, mesh11, monkeypatch):
    jm = JModel(jconfigs.get_smoke(arch), JMS, JQSDPConfig(**POLICY))
    tm = Model(tconfigs.get_smoke(arch), MS, QSDPConfig(**POLICY))
    params = jm.init_params(jax.random.PRNGKey(0))
    batch = batches(1, jm.cfg)[0]
    if arch == "qwen2-vl-72b":
        assert batch["vision_mask"].any() and (batch["labels"] < 0).any()
        assert (batch["positions"][1] != batch["positions"][2]).any()
    key = jax.random.PRNGKey(3)
    jg, tg = {}, {}
    _hook_jax(monkeypatch, jm, jg)

    def f(p, b):
        return jax.value_and_grad(lambda pp: jm.loss_fn(pp, b, key))(p)

    jloss, jgrads = jax.jit(shard_map(f, mesh=mesh11, in_specs=(P(), P()),
                                      out_specs=(P(), P()), check_vma=False))(
        params, to_jax(batch))
    jax.effects_barrier()

    _hook_port(monkeypatch, tm, tg)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    names = sorted(tp)
    loss = tm.loss_fn(tp, to_torch(batch), prng.PRNGKey(3))
    grads = torch.autograd.grad(loss, [tp[n] for n in names])

    assert sorted(jg) == sorted(tg) and jg == tg
    if arch == "seamless-m4t-large-v2":
        assert {"enc/wq", "dec/xwq", "lm_head"} <= set(tg)
    jl = float(jloss)
    assert abs(loss.item() - jl) <= LOSS_RTOL * abs(jl)
    assert sorted(jgrads) == names
    for n, g in zip(names, grads):
        want = np.asarray(jgrads[n])
        got = g.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), n
        assert np.abs(want).max() > 0, n
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (n, err, np.abs(want).max())
