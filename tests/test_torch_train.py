"""The training slice, port against the JAX package, on the CPU (set-up and
tolerances in ``_torch_train_common.py``):

  (a) the same cotangent through one layer's gather backward: gradient
      wire bytes (codes, scale, zero, bf16 norm segments) and the
      reduce-scattered gradients byte-equal, coalesced and per-tensor;
  (b) the backward's re-gathered weights byte-equal to the forward's, and
      one gradient reduce-scatter per gather;
  (c) one f32-compute step: loss, grad norm and updated params within the
      stated tolerances;
  (d) a 10-step f32 loss trajectory within TRAJ_RTOL.

The quantized-state and fp-baseline steps are in
``test_torch_train_modes.py`` (each file stays well inside a minute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core.collectives as jcoll
from repro.compat import shard_map
import repro_torch.core.collectives as tcoll
from repro_torch.configs import gpt_1_3b as tcfg_mod
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.models.transformer import Model
from _torch_train_common import (MS, STEPS, TRAJ_RTOL, assert_step_close, batches, digest,
                                 models, run_both)


# ---------------------------------------------------------------------------
# (a) + (b): the gather backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False])
def test_layer_grad_wire_bytes_equal(coalesce, mesh11, monkeypatch):
    jm, tm = models(coalesce=coalesce)
    params = jm.init_params(jax.random.PRNGKey(0))
    names = sorted(n[len("layers/"):] for n in jm.specs if n.startswith("layers/"))
    leaves = {n: np.asarray(params[f"layers/{n}"][0]) for n in names}
    rng = np.random.default_rng(1)
    cts = {n: (rng.standard_normal(tm.specs[f"layers/{n}"].tp_local_shape(1)) * 1e-2)
           .astype(np.float32) for n in names}

    jbufs, orig = [], jax.lax.all_to_all

    def hooked(x, *a, **kw):
        jax.debug.callback(lambda b: jbufs.append(np.asarray(b)), x)
        return orig(x, *a, **kw)

    monkeypatch.setattr(jcoll.lax, "all_to_all", hooked)
    key = jax.random.PRNGKey(3)

    def f(lv, ct):  # the cotangent reaches the gather in the compute dtype
        _, vjp = jax.vjp(lambda l: jm.engine.gather_layer("layers/", l, key), lv)
        return vjp({n: c.astype(jm.compute_dtype) for n, c in ct.items()})[0]

    jgrads = jax.jit(shard_map(f, mesh=mesh11, in_specs=(P(), P()), out_specs=P(),
                               check_vma=False))(
        {n: jnp.asarray(v) for n, v in leaves.items()},
        {n: jnp.asarray(c) for n, c in cts.items()})
    jgrads = {n: np.asarray(g) for n, g in jgrads.items()}

    tbufs, torig = [], tcoll._all_to_all_rows
    monkeypatch.setattr(tcoll, "_all_to_all_rows",
                        lambda rows, group=None: torig(tbufs.append(rows.numpy().copy())
                                                       or rows, group))
    tleaves = {n: torch.from_numpy(v.copy()).requires_grad_() for n, v in leaves.items()}
    tkey = prng.PRNGKey(3)
    outs = tm.engine.gather_layer("layers/", tleaves, tkey)
    torch.autograd.backward([outs[n] for n in names],
                            [torch.from_numpy(cts[n]).to(outs[n].dtype) for n in names])

    assert len(jbufs) == len(tbufs) == (1 if coalesce else 3 * 7)
    assert sorted(map(digest, jbufs)) == sorted(map(digest, tbufs))
    for n in names:
        assert digest(tleaves[n].grad.numpy()) == digest(jgrads[n]), n


def test_backward_regathers_forward_weights(monkeypatch):
    tm = Model(tcfg_mod.smoke(), MS, QSDPConfig())
    params = {k: v.requires_grad_() for k, v in tm.init_params(0, "cpu").items()}
    batch = {k: torch.from_numpy(v).long() for k, v in batches(1)[0].items()}
    seen, phase = {"fwd": [], "bwd": []}, ["fwd"]
    orig = tm.engine._reshape_full

    def record(name, full):
        seen[phase[0]].append((name, digest(full.detach().view(torch.uint8).numpy())))
        return orig(name, full)

    n_rs, orig_rs = [0], tcoll.reduce_scatter_coalesced

    def count_rs(*a, **kw):
        n_rs[0] += 1
        return orig_rs(*a, **kw)

    monkeypatch.setattr(tm.engine, "_reshape_full", record)
    monkeypatch.setattr(tcoll, "reduce_scatter_coalesced", count_rs)
    loss = tm.loss_fn(params, {k: v[:2] for k, v in batch.items()}, prng.PRNGKey(5))
    phase[0] = "bwd"
    loss.backward()
    layer_fwd = [x for x in seen["fwd"] if x[0].startswith("layers/")]
    n_layers = tm.cfg.n_layers
    assert len(layer_fwd) == 9 * n_layers  # 7 matmul weights + 2 norms per layer
    assert sorted(seen["bwd"]) == sorted(layer_fwd)
    assert n_rs[0] == n_layers + 2  # each layer once, embed once, final norm once
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params.values())


# ---------------------------------------------------------------------------
# (c) + (d): f32 steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_runs():
    return run_both(*models(compute_dtype="float32"), STEPS)


def test_one_f32_step_matches_jax(f32_runs):
    assert_step_close(*f32_runs)


def test_ten_step_loss_trajectory(f32_runs):
    rows, _ = f32_runs
    assert len(rows) == STEPS
    for jl, tl, _, _ in rows:
        assert np.isfinite(tl) and abs(tl - jl) <= TRAJ_RTOL * abs(jl)
