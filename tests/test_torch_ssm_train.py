"""SSM/hybrid training, the mixer's backward: the port against the JAX
package on the CPU.

  (a) softplus's gradient: the reference's (logaddexp's JVP, exp(x -
      softplus(x)) = sigmoid(x)), 0.5 at x = 0, where the composite
      max(x, 0) + log1p(exp(-|x|)) differentiates to 1 under autograd.  At
      step 0 every ``dt_bias`` is -4.0 and ``dt_raw`` comes out of a bf16
      projection, so dt_raw + dt_bias == 0 occurs; the forward stays the
      composite's, bit for bit;
  (b) the causal conv's backward (K shifted products summed in f32), the
      decay mask's (finite where the reference's overflows to NaN), and the
      Mamba2 mixer's input and weight gradients against ``jax.vjp`` of the
      JAX functions (the mixer under ``shard_map`` on the (1, 1) mesh), f32,
      at a length that pads to whole chunks (dt = 0 steps) and at one that
      does not;
  (c) the hybrid's shared block gathered once per invocation: the gradient
      reduce-scatter's wire bytes of every invocation byte-equal to the JAX
      package's for the same cotangents, and the summed gradient within f32
      tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core.collectives as jcoll
import repro.models.mamba as jmamba
from repro.compat import shard_map
import repro_torch.core.collectives as tcoll
from repro_torch.core import prng
from repro_torch.models import mamba
from _torch_train_common import digest, models
from test_torch_mamba import B, D, K, MESH, _as, _cfgs, _weights

torch.set_num_threads(1)

# f32: the products and the scan's sums run in other orders (<= 3e-6 of
# the largest gradient measured)
GRAD_RTOL = 1e-5
_jgrad_softplus = jax.jit(jax.vmap(jax.grad(jax.nn.softplus)))


def _port_softplus_grad(x: torch.Tensor) -> np.ndarray:
    x = x.clone().requires_grad_()
    mamba.softplus(x).sum().backward()
    return x.grad.numpy()


def test_softplus_grad_at_zero_matches_jax():
    """x = 0 itself, and dt_raw + dt_bias at step 0: bf16-rounded
    projections (4.0 among them) plus the initial dt_bias of -4.0."""
    raw = torch.tensor([4.0, 3.984375, 4.03125, -4.0, 0.0], dtype=torch.bfloat16)
    dt_bias = torch.full((5,), -4.0)
    x = raw.float() + dt_bias
    assert (x == 0).sum() == 1
    want = np.asarray(_jgrad_softplus(jnp.asarray(x.numpy())))
    got = _port_softplus_grad(x)
    assert want[0] == got[0] == 0.5
    # elsewhere exp's last bit may differ between the two libms
    assert np.abs(got - want).max() <= 1e-6
    # the gradient reaches dt_bias through the sum
    b = dt_bias.clone().requires_grad_()
    mamba.softplus(raw.float() + b).sum().backward()
    assert b.grad[0] == 0.5
    assert _port_softplus_grad(torch.zeros(3)).tolist() == [0.5] * 3


def test_softplus_grad_matches_jax_on_random_values():
    x = (np.random.default_rng(0).standard_normal(10 ** 6) * 6).astype(np.float32)
    x[:4] = [0.0, -0.0, 30.0, -30.0]
    want = np.asarray(_jgrad_softplus(jnp.asarray(x)))
    got = _port_softplus_grad(torch.from_numpy(x))
    assert np.abs(got - want).max() <= 1e-6
    # the forward is the composite's, bit for bit
    t = torch.from_numpy(x)
    assert torch.equal(mamba.softplus(t),
                       torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs())))


def _rel_close(name, got, want, rtol=GRAD_RTOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv_vjp_matches_jax(dt):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 20, 24)).astype(np.float32)
    w = rng.standard_normal((24, K)).astype(np.float32)
    g = rng.standard_normal((B, 20, 24)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    _, vjp = jax.vjp(jmamba._causal_conv, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    mamba._causal_conv(tx, tw).backward(torch.from_numpy(g).to(tdt))
    assert tx.grad.dtype == tw.grad.dtype == tdt
    # bf16: both round the f32 sums of K (dx) and B*S (dw) products once
    rtol = GRAD_RTOL if dt == "float32" else 1e-2
    _rel_close("x", tx.grad, jdx.astype(jnp.float32), rtol)
    _rel_close("w", tw.grad, jdw.astype(jnp.float32), rtol)


@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_segsum_decay_vjp(scale):
    """The decay mask's gradient.  At scale 1.0 a chunk's sum |dt a| passes
    88.7: the JAX package's mask (exp, then where) overflows above the
    diagonal and its gradient is NaN; the port's (where inside exp) keeps
    the values of the exp-then-where form bit for bit and gives the finite
    gradient, that of JAX's on a form of the same function that cannot
    overflow.  At 0.05 both packages' gradients agree."""
    rng = np.random.default_rng(12)
    da_cs = np.cumsum(-rng.random((B, 2, 256, 3)) * scale, axis=2).astype(np.float32)
    g = rng.standard_normal((B, 2, 256, 256, 3)).astype(np.float32)
    overflow = bool((da_cs[:, :, 0] - da_cs[:, :, -1]).max() > 88.8)
    assert overflow == (scale == 1.0)
    jout, vjp = jax.vjp(jmamba.segsum_decay, jnp.asarray(da_cs))
    jgrad = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.isnan(jgrad).any() == overflow

    def safe(d):  # the masked entries' exponent zeroed before the exp
        q = d.shape[2]
        diff = d[:, :, :, None, :] - d[:, :, None, :, :]
        mask = jnp.tril(jnp.ones((q, q), bool))[None, None, :, :, None]
        return jnp.where(mask, jnp.exp(jnp.where(mask, diff, 0.0)), 0.0)

    _, svjp = jax.vjp(safe, jnp.asarray(da_cs))
    want = np.asarray(svjp(jnp.asarray(g))[0])
    t = torch.from_numpy(da_cs).requires_grad_()
    out = mamba.segsum_decay(t)
    out.backward(torch.from_numpy(g))
    q = torch.arange(256)
    diff = t.detach()[:, :, :, None, :] - t.detach()[:, :, None, :, :]
    assert torch.equal(out.detach(), torch.where((q[:, None] >= q[None, :])[None, None, :, :, None],
                                                 torch.exp(diff), 0.0))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    _rel_close("da_cs", t.grad, want)
    if not overflow:
        _rel_close("da_cs vs the reference", t.grad, jgrad)


def _jax_block_vjp(x, w, gout):
    jcfg, _ = _cfgs()

    def grads(xx, ww, go):
        _, vjp = jax.vjp(lambda a, b: jmamba.mamba2_block(a, b, jcfg), xx, ww)
        return vjp(go)

    fn = jax.jit(shard_map(grads, mesh=MESH, in_specs=(P(), P(), P()), out_specs=(P(), P()),
                           check_vma=False))
    dx, dw = fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(gout))
    return np.asarray(dx), {k: np.asarray(v) for k, v in dw.items()}


@pytest.mark.parametrize("s", [20, 16])  # 20 pads to 3 chunks of 8; 16 is 2 whole chunks
def test_mamba2_block_vjp_matches_jax(s):
    _, tcfg = _cfgs()
    w = _weights(8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, s, D)).astype(np.float32)
    gout = rng.standard_normal((B, s, D)).astype(np.float32)
    jdx, jdw = _jax_block_vjp(x, w, gout)
    _, tw = _as(w, "float32")
    tw = {k: v.requires_grad_() for k, v in tw.items()}
    tx = torch.from_numpy(x).requires_grad_()
    mamba.mamba2_block(tx, tw, tcfg).backward(torch.from_numpy(gout))
    _rel_close("x", tx.grad, jdx)
    for k in w:
        _rel_close(k, tw[k].grad, jdw[k])


def test_shared_block_grad_wire_bytes_equal(mesh11, monkeypatch):
    """The zamba2 smoke shared block gathered under three invocations' keys
    (``fold_in(key, 1000 + g)``), each with its own cotangent: per
    invocation one coalesced reduce-scatter buffer, byte-equal between the
    packages (compared as sets: JAX's callbacks need not run in program
    order); the gradient summed over the invocations within f32
    tolerance."""
    jm, tm = models(arch="zamba2-7b")
    params = jm.init_params(jax.random.PRNGKey(0))
    names = sorted(n[len("shared/"):] for n in jm.specs if n.startswith("shared/"))
    assert {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm",
            "mlp_norm"} == set(names)
    leaves = {n: np.asarray(params[f"shared/{n}"]) for n in names}
    rng = np.random.default_rng(2)
    n_inv = 3
    cts = [{n: (rng.standard_normal(tm.specs[f"shared/{n}"].tp_local_shape(1)) * 1e-2)
            .astype(np.float32) for n in names} for _ in range(n_inv)]
    key = jax.random.PRNGKey(4)

    jbufs, orig = [], jax.lax.all_to_all

    def hooked(x, *a, **kw):
        jax.debug.callback(lambda b: jbufs.append(np.asarray(b)), x)
        return orig(x, *a, **kw)

    monkeypatch.setattr(jcoll.lax, "all_to_all", hooked)

    def f(lv, cs):
        total = None
        for g, ct in enumerate(cs):
            gkey = jax.random.fold_in(key, 1000 + g)
            _, vjp = jax.vjp(lambda l, gk=gkey: jm.engine.gather_layer("shared/", l, gk), lv)
            gr = vjp({n: c.astype(jm.compute_dtype) for n, c in ct.items()})[0]
            total = gr if total is None else jax.tree.map(jnp.add, total, gr)
        return total

    jgrads = jax.jit(shard_map(f, mesh=mesh11, in_specs=(P(), P()), out_specs=P(),
                               check_vma=False))(
        {n: jnp.asarray(v) for n, v in leaves.items()},
        [{n: jnp.asarray(c) for n, c in ct.items()} for ct in cts])

    tbufs, torig = [], tcoll._all_to_all_rows
    monkeypatch.setattr(tcoll, "_all_to_all_rows",
                        lambda rows, group=None: torig(tbufs.append(rows.numpy().copy())
                                                       or rows, group))
    tleaves = {n: torch.from_numpy(v.copy()).requires_grad_() for n, v in leaves.items()}
    outs, grads = [], []
    for g in range(n_inv):
        o = tm.engine.gather_layer("shared/", tleaves, prng.fold_in(prng.PRNGKey(4), 1000 + g))
        outs += [o[n] for n in names]
        grads += [torch.from_numpy(cts[g][n]).to(o[n].dtype) for n in names]
    torch.autograd.backward(outs, grads)

    layout = tm.engine.layout(tuple(f"shared/{n}" for n in names))
    fp = {n for n, seg in zip(names, layout.segments) if seg.cfg is None}
    assert fp == {"attn_norm", "mlp_norm"}
    assert len(jbufs) == len(tbufs) == n_inv
    assert sorted(map(digest, jbufs)) == sorted(map(digest, tbufs))
    assert len(set(map(digest, tbufs))) == n_inv
    for n in names:
        want = np.asarray(jgrads[n])
        got = tleaves[n].grad.numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), n
