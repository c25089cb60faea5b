"""MoE training, the layer's backward: the port against the JAX package on
the CPU.

  (a) ``models.moe.moe_layer``'s VJP against ``jax.vjp`` of the JAX
      ``moe_layer`` (under ``shard_map`` on the (1, 1) mesh) for the same
      cotangents of the output and the aux loss, capacity path (with drops)
      and drop-free: gradients to x, the router and the three expert
      stacks within GRAD_RTOL of the largest; a token whose every
      assignment was dropped gets exactly zero gradient from the experts
      in both packages;
  (b) one olmoe smoke layer's gather backward for the same cotangent: the
      gradient wire bytes (codes, scale, zero of every quantized tensor,
      the router's and the norms' bf16 fp segments) and the
      reduce-scattered gradients byte-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core.collectives as jcoll
import repro.models.moe as jmoe
from repro.compat import shard_map
import repro_torch.core.collectives as tcoll
from repro_torch.core import prng
from repro_torch.models import moe
from _torch_train_common import digest, models
from test_torch_moe import D, E, FF, K, MESH, T, _inputs, _kept

# f32: the products and the softmax's sums run in other orders (<= 4e-7 of
# the largest gradient measured); the combine and its transpose add in the
# same order on both sides
GRAD_RTOL = 2e-6


def _jax_vjp(x, w, gout, gaux, no_drop):
    cfg = jmoe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=FF, tp=1)

    def grads(xx, ww, go, ga):
        _, vjp = jax.vjp(lambda a, b: jmoe.moe_layer(a, b, cfg, no_drop=no_drop), xx, ww)
        return vjp((go, ga))

    fn = jax.jit(shard_map(grads, mesh=MESH, in_specs=(P(), P(), P(), P()),
                           out_specs=(P(), P()), check_vma=False))
    dx, dw = fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()},
                jnp.asarray(gout), jnp.float32(gaux))
    return np.asarray(dx), {k: np.asarray(v) for k, v in dw.items()}


@pytest.mark.parametrize("gaux", [0.0, 1.7])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_layer_vjp_matches_jax(no_drop, gaux):
    x, w = _inputs()
    gout = np.random.default_rng(5).standard_normal((T, D)).astype(np.float32)
    jdx, jdw = _jax_vjp(x, w, gout, gaux, no_drop)
    cfg = moe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=FF, tp=1)
    xt = torch.from_numpy(x).requires_grad_()
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out, aux = moe.moe_layer(xt, tw, cfg, no_drop=no_drop)
    torch.autograd.backward([out, aux], [torch.from_numpy(gout), torch.tensor(gaux)])
    for name, got, want in [("x", xt.grad, jdx), *((k, tw[k].grad, jdw[k]) for k in w)]:
        got = got.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)

    _, _, ids = moe.route(torch.from_numpy(x), torch.from_numpy(w["router"]), cfg)
    kept = _kept(ids.numpy(), moe.dispatch_capacity(cfg, T, no_drop))
    gone = ~kept.any(axis=1)  # tokens whose every assignment was dropped
    if no_drop:
        assert kept.all()
    else:
        assert gone.sum() >= 2
        if gaux == 0.0:  # the router then gets nothing from these tokens either
            assert not xt.grad.numpy()[gone].any() and not jdx[gone].any()


def test_moe_layer_grad_wire_bytes_equal(mesh11, monkeypatch):
    jm, tm = models(arch="olmoe-1b-7b")
    params = jm.init_params(jax.random.PRNGKey(0))
    names = sorted(n[len("layers/"):] for n in jm.specs if n.startswith("layers/"))
    assert {"router", "w_gate", "w_up", "w_down"} <= set(names)
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
    outs = tm.engine.gather_layer("layers/", tleaves, prng.PRNGKey(3))
    torch.autograd.backward([outs[n] for n in names],
                            [torch.from_numpy(cts[n]).to(outs[n].dtype) for n in names])

    layout = tm.engine.layout(tuple(f"layers/{n}" for n in names))
    fp = {n for n, seg in zip(names, layout.segments) if seg.cfg is None}
    assert fp == {"router", "attn_norm", "mlp_norm"}
    assert len(jbufs) == len(tbufs) == 1
    assert digest(jbufs[0]) == digest(tbufs[0])
    for n in names:
        assert digest(tleaves[n].grad.numpy()) == digest(jgrads[n]), n
