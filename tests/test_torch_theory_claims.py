"""The paper's analytical claims (``tests/test_theory.py``'s checks) through
the port alone, on the CPU: Theorem 2 (deterministic and stochastic), the
contraction rate, naive round-to-nearest breaking convergence, Lemma 4,
Lemma 6 and the parameter formulas.  Seeds run as one row of keys.

Corollary 3 at its own parameters (eps 0.05, gradient lattice 0.05, so
sigma_q^2 ~ 50 and T = 1,732,218 steps) is too long for an eager loop here; the
theory experiment holds Corollary 3's quantizer at Theorem 2's parameters
(its ``gq_holds`` rows).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.quant import q_shift
from repro_torch.core.theory import make_quadratic, run_qsgd, theorem2_params

torch.set_num_threads(1)

KEY = prng.PRNGKey(0)


def _setup(kappa=4.0, n=64, delta_star=0.5, eps=1e-3, sigma=0.0):
    obj = make_quadratic(KEY, n=n, kappa=kappa, device="cpu")
    params = theorem2_params(obj.alpha, obj.beta, delta_star, eps, sigma,
                             f0_gap=float(obj.f(torch.zeros(n))))
    return obj, params, obj.lattice_opt_value(delta_star, prng.PRNGKey(7))


def _seeds(n):
    return prng.key_rows([prng.PRNGKey(s) for s in range(n)])


def test_theorem2_deterministic_convergence():
    """Exact gradients: E f(x_T) <= E f(x*_{r,d*}) + eps (Theorem 2)."""
    obj, params, bench = _setup()
    xs, _ = run_qsgd(obj, torch.zeros(64), params, _seeds(8), device="cpu")
    assert float(obj.f(xs).mean()) <= bench + 1e-3 + 1e-6


def test_theorem2_stochastic_convergence():
    obj, params, bench = _setup(sigma=0.5, eps=0.05)
    xs, _ = run_qsgd(obj, torch.zeros(64), params, _seeds(8), sigma=0.5, device="cpu")
    assert float(obj.f(xs).mean()) <= bench + 0.05 + 1e-6


def test_theorem2_linear_contraction_rate():
    """The error contracts at least as fast as 1 - eta*alpha/(2 beta) per
    step in the deterministic case (Lemmas 9/10), over the transient."""
    obj, params, bench = _setup()
    _, fs = run_qsgd(obj, torch.zeros(64), params, prng.PRNGKey(1), device="cpu")
    gaps = np.maximum(fs.numpy() - bench, 1e-12)
    floor = max(gaps[-1], 1e-9)
    live = np.nonzero(gaps > 100 * floor)[0]
    assert len(live) >= 3, (gaps[:5], floor)
    idx = live[: max(3, len(live) // 2)]
    ratios = gaps[idx[1:]] / gaps[idx[:-1]]
    rate = 1.0 - 0.5 * params.eta * obj.alpha / obj.beta
    assert np.median(ratios) <= rate + 0.05


def test_naive_rtn_breaks_convergence():
    """Round-to-nearest on the coarse grid freezes once steps < delta/2; the
    random shift keeps moving (Section 6)."""
    obj, params, _ = _setup()
    coarse = dataclasses.replace(params, delta=0.5)
    x_rtn, _ = run_qsgd(obj, torch.zeros(64), coarse, KEY, weight_q="nearest", device="cpu")
    xs, _ = run_qsgd(obj, torch.zeros(64), coarse, _seeds(6), weight_q="shift", device="cpu")
    assert float(obj.f(xs).mean()) < float(obj.f(x_rtn))


def test_lemma4_variance_contraction():
    """E||Q_d(x) - x||^2 <= (d/d*) E_r ||x*_{r,d*} - x||^2 (Lemma 4), by
    Monte Carlo over 4,000 shift keys at once."""
    delta_star = 1.0
    delta = delta_star / 8
    x = prng.normal(KEY, (128,)) * 2.3
    keys = prng.key_rows(prng.split(KEY, 4000))
    lhs = torch.mean(torch.sum((q_shift(x.expand(4000, 128), delta, keys) - x) ** 2, dim=-1))
    rs = prng.uniform(prng.PRNGKey(5), (4000,), "cpu", -0.5, 0.5)[:, None]
    y = delta_star * torch.round((x - rs * delta_star) / delta_star) + rs * delta_star
    rhs = torch.mean(torch.sum((y - x) ** 2, dim=-1))
    assert float(lhs) <= (delta / delta_star) * float(rhs) * 1.05


def test_lemma6_scalar_inequality():
    """(1-{y}){y} <= k (1-{y/k}) {y/k} for integer k."""
    ys = np.linspace(0, 7, 1401)
    for k in (2, 3, 8):
        f = lambda v: (v - np.floor(v))  # noqa: E731
        assert np.all((1 - f(ys)) * f(ys) <= k * (1 - f(ys / k)) * f(ys / k) + 1e-9)


def test_theorem2_params_formulas():
    p = theorem2_params(alpha=1.0, beta=2.0, delta_star=1.0, eps=0.1, sigma=1.0, f0_gap=10.0)
    assert p.eta == pytest.approx(min(0.3 * 0.1 * 1.0 / 1.0, 1.0))
    assert p.delta == pytest.approx(p.eta / np.ceil(16 * 4))
    assert p.lr == pytest.approx(p.eta / 2.0)
