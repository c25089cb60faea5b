"""The theory slice, port against the JAX package, on the CPU:

  (a) ``core/prng.py``'s 64-bit draws and f64 uniforms byte-equal to
      ``jax.random`` under ``jax.enable_x64(True)``; normals within the
      stated ulps (f32, f64); a row of keys draws as each key alone;
  (b) the lattice quantizers ``q_nearest``/``q_shift``/``q_coinflip``
      against ``repro.core.quant`` in f32 and f64;
  (c) ``make_quadratic``, ``theorem2_params``, ``lattice_opt_value``;
  (d) ``run_qsgd``'s f-trajectory against the reference's
      ``_run_qsgd_impl`` under ``jax.enable_x64(True)`` at every step.

The paper's claims run through the port alone in
``test_torch_theory_claims.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import theory as jtheory
from repro_torch.core import prng, quant, theory

torch.set_num_threads(1)

# XLA's erf_inv runs its own logf and fuses multiply-adds on the CPU; the
# twin rounds apart in ~4 % (f32) / ~7 % (f64) of draws, by at most 3 ulp
NORMAL_ULP = {np.float32: 3, np.float64: 4}
RUN_RTOL = 1e-9


def _ulps(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    i = np.int32 if a.dtype == np.float32 else np.int64
    return int(np.abs(a.view(i).astype(np.int64) - b.view(i)).max())


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (7,), (33, 5)])
def test_bits64_and_f64_uniform_byte_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    with jax.enable_x64(True):
        b = np.asarray(jax.random.bits(jk, shape, jnp.uint64))
        assert np.array_equal(b, prng.bits(tk, shape, width=64).numpy().view(np.uint64))
        for lo, hi in ((0.0, 1.0), (-0.5, 0.5)):
            u = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
            assert u.dtype == np.float64
            t = prng.uniform(tk, shape, "cpu", lo, hi, torch.float64).numpy()
            assert np.array_equal(u.view(np.uint64), t.view(np.uint64))


def test_bits64_layout_is_hi_shift_or_lo():
    """The issue's probe: PRNGKey(3), three uint64 draws."""
    assert prng.bits(prng.PRNGKey(3), (3,), width=64).numpy().view(np.uint64).tolist() == [
        15963681350020464357, 8360145782228061838, 4400243552688456428]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_within_ulps(dtype):
    n = 100_000
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (n,), dtype))
    got = prng.normal(prng.PRNGKey(11), (n,), "cpu", torch.from_numpy(np.zeros(1, dtype)).dtype)
    assert _ulps(want, got.numpy()) <= NORMAL_ULP[dtype]


def test_key_rows_draw_as_each_key():
    keys = [prng.PRNGKey(s) for s in (0, 5, 9)]
    rows = prng.key_rows(keys)
    for dt in (torch.float32, torch.float64):
        r = prng.uniform(rows, (6,), dtype=dt)
        n = prng.normal(rows, (6,), dtype=dt)
        s = prng.uniform(rows, (), dtype=dt)
        assert r.shape == n.shape == (3, 6) and s.shape == (3,)
        for i, k in enumerate(keys):
            assert torch.equal(r[i], prng.uniform(k, (6,), dtype=dt))
            assert torch.equal(n[i], prng.normal(k, (6,), dtype=dt))
            assert torch.equal(s[i], prng.uniform(k, (), dtype=dt))
    for i, k in enumerate(keys):
        assert [(int(a[i]), int(b[i])) for a, b in prng.split(rows, 4)] == prng.split(k, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("delta", [0.5, 0.37, 0.05, 1e-3])
def test_lattice_quantizers_match_reference(dtype, delta):
    """Compiled as the reference's scan compiles them (so XLA fuses), with
    delta traced (a constant divisor XLA would turn into a reciprocal
    multiply: a different rounding of the same formula)."""
    x = (np.random.default_rng(int(delta * 1000)).standard_normal(4096) * 10).astype(dtype)
    tx = torch.from_numpy(x)
    d = dtype(delta)
    with jax.enable_x64(dtype == np.float64):
        for s in range(4):
            jk, tk = jax.random.PRNGKey(s), prng.PRNGKey(s)
            shift = np.asarray(jax.jit(jquant.q_shift)(x, d, jk))
            flip = np.asarray(jax.jit(jquant.q_coinflip)(x, d, jk))
            near = np.asarray(jax.jit(jquant.q_nearest)(x, d))
            assert _ulps(shift, quant.q_shift(tx, delta, tk).numpy()) == 0
            assert _ulps(flip, quant.q_coinflip(tx, delta, tk).numpy()) == 0
            assert _ulps(near, quant.q_nearest(tx, delta).numpy()) == 0


def test_quadratic_params_and_lattice_opt():
    jobj = jtheory.make_quadratic(jax.random.PRNGKey(0), n=64, kappa=4.0)
    tobj = theory.make_quadratic(prng.PRNGKey(0), n=64, kappa=4.0, device="cpu")
    assert _ulps(jobj.h, tobj.h.numpy()) <= 1 and _ulps(jobj.c, tobj.c.numpy()) <= 1
    obj = theory.Quadratic(h=torch.from_numpy(np.array(jobj.h)), c=torch.from_numpy(np.array(jobj.c)))
    f0 = float(jobj.f(jnp.zeros(64)))
    assert float(obj.f(torch.zeros(64))) == pytest.approx(f0, rel=1e-6)
    for sigma, eps, sigma_q in ((0.0, 1e-3, 0.0), (0.5, 0.05, 0.0), (0.0, 0.05, 6.7)):
        assert dataclasses.asdict(theory.theorem2_params(obj.alpha, obj.beta, 0.5, eps, sigma,
                                                         f0, sigma_q)) == \
            dataclasses.asdict(jtheory.theorem2_params(jobj.alpha, jobj.beta, 0.5, eps, sigma,
                                                       f0, sigma_q))
    want = jobj.lattice_opt_value(0.5, jax.random.PRNGKey(7))
    assert obj.lattice_opt_value(0.5, prng.PRNGKey(7)) == pytest.approx(want, rel=1e-6)


CASES = {  # name: (run_qsgd kwargs, eps); the stochastic case runs 600 of its steps
    "shift": (dict(weight_q="shift"), 1e-3),
    "nearest": (dict(weight_q="nearest"), 1e-3),
    "coinflip": (dict(weight_q="coinflip"), 1e-3),
    "none": (dict(weight_q="none"), 1e-3),
    "shift+gradq": (dict(weight_q="shift", grad_q_delta=0.05), 1e-3),
    "shift+sigma": (dict(weight_q="shift", sigma=0.5), 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_qsgd_matches_reference(case):
    """kappa 4, n 64, seed 1: f(x_t) within RUN_RTOL at every step of the
    reference's iteration run in f64 (its wrapper's x64 scope is gone from
    JAX, so the test scopes it)."""
    kw, eps = CASES[case]
    sigma = kw.get("sigma", 0.0)
    jobj = jtheory.make_quadratic(jax.random.PRNGKey(0), n=64, kappa=4.0)
    f0 = float(jobj.f(jnp.zeros(64)))
    p = jtheory.theorem2_params(jobj.alpha, jobj.beta, 0.5, eps, sigma, f0)
    if sigma:
        p = dataclasses.replace(p, T=600)
    with jax.enable_x64(True):
        _, jf = jtheory._run_qsgd_impl(jobj, jnp.zeros(64, jnp.float64), p,
                                       jax.random.PRNGKey(1), sigma, kw["weight_q"],
                                       kw.get("grad_q_delta"), 1)
        jf = np.asarray(jf)
    obj = theory.Quadratic(h=torch.from_numpy(np.array(jobj.h)), c=torch.from_numpy(np.array(jobj.c)))
    tp = theory.Theorem2Params(**dataclasses.asdict(p))
    _, tf = theory.run_qsgd(obj, torch.zeros(64), tp, prng.PRNGKey(1), device="cpu", **kw)
    assert jf.dtype == np.float64 and tf.dtype == torch.float64 and tf.shape == jf.shape
    np.testing.assert_allclose(tf.numpy(), jf, rtol=RUN_RTOL, atol=0)
