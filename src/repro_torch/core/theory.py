"""Theorem 2 / Corollary 3 of the QSDP paper, executable (the JAX package's
``core/theory.py``).

The paper's analytical core is the iteration

    x_{t+1} = Q^w_delta( x_t - (eta / beta) * Q^g( g(x_t) ) )

for a beta-smooth, alpha-PL objective f, with Q^w the random-shift lattice
quantizer (Definition 1) and Q^g any unbiased gradient quantizer.  Theorem 2
fixes  delta = eta * delta_star / ceil(16 (beta/alpha)^2)  and proves linear
convergence (rate 1 - (3/4) eta alpha/beta per step, Lemma 10) to within
epsilon of the best point on the coarser lattice delta_star Z^n + r 1.

``make_quadratic`` draws its objective in f32, as the reference does (it
is called outside x64); ``run_qsgd`` iterates in f64 by default, the dtype
the reference intends (its draws are then ``jax.random``'s 64-bit ones).
The iteration is a Python loop over T steps that splits the key 4 ways per
step exactly as ``_run_qsgd_impl``; given a row of keys
(``prng.key_rows``) it runs one independent iteration per key at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import resolve_device
from . import prng
from .quant import q_coinflip, q_nearest, q_shift


@dataclasses.dataclass(frozen=True)
class Quadratic:
    """f(x) = 0.5 * sum_i h_i (x_i - c_i)^2 -- beta = max h, alpha = min h.

    Strongly convex, hence alpha-PL; the minimizer over a shifted lattice is
    the coordinate-wise rounding of c, which makes the benchmark
    E f(x*_{r,delta_star}) computable in closed form.  f and grad act on the
    last axis, so a (S, n) batch of points gives S values."""

    h: torch.Tensor  # (n,) positive curvatures
    c: torch.Tensor  # (n,) optimum

    @property
    def alpha(self) -> float:
        return float(torch.min(self.h))

    @property
    def beta(self) -> float:
        return float(torch.max(self.h))

    def to(self, device) -> "Quadratic":
        return Quadratic(h=self.h.to(device), c=self.c.to(device))

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(self.h * torch.square(x - self.c), dim=-1)

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.h * (x - self.c)

    def noisy_grad(self, x: torch.Tensor, key: prng.Key, sigma: float) -> torch.Tensor:
        """Unbiased gradient oracle with E||g - grad||^2 = sigma^2."""
        n = x.shape[-1]
        noise = prng.normal(key, (n,), x.device, x.dtype) * (sigma / math.sqrt(n))
        return self.grad(x) + noise

    def lattice_opt_value(self, delta_star: float, key: prng.Key, n_shifts: int = 256) -> float:
        """Monte-Carlo estimate of E_r f(x*_{r,delta_star}) in f32: for a
        separable quadratic the best lattice point is round-to-nearest of c
        on each shifted grid."""
        rs = prng.uniform(key, (n_shifts,), self.c.device, -0.5, 0.5) * delta_star
        xs = delta_star * torch.round((self.c - rs[:, None]) / delta_star) + rs[:, None]
        return float(torch.mean(self.f(xs)))


def make_quadratic(key: prng.Key, n: int = 64, kappa: float = 4.0, c_scale: float = 8.0,
                   device=None) -> Quadratic:
    """Random separable quadratic with condition number `kappa`, drawn in
    f32 on `device` (the card unless given).

    `c_scale` sets ||x0 - c|| relative to the coarse-lattice benchmark
    E f(x*_{r,delta_star}) (which depends only on h and delta_star, not c):
    starting from x0 = 0, the initial gap is ~c_scale^2 larger than the
    benchmark floor, so the linear transient of Theorem 2 spans enough
    iterations to measure the contraction rate before f(x_t) crosses the
    floor."""
    device = resolve_device(device)
    k1, k2 = prng.split(key)
    h = torch.exp(prng.uniform(k1, (n,), device) * math.log(kappa))  # in [1, kappa]
    c = prng.normal(k2, (n,), device) * c_scale
    return Quadratic(h=h, c=c)


@dataclasses.dataclass(frozen=True)
class Theorem2Params:
    eta: float
    delta: float
    T: int
    lr: float  # eta / beta -- the actual step size


def theorem2_params(alpha: float, beta: float, delta_star: float, eps: float, sigma: float,
                    f0_gap: float, sigma_q: float = 0.0) -> Theorem2Params:
    """Exactly the parameter choices of Theorem 2 / Corollary 3."""
    var = sigma**2 + sigma_q**2
    eta = 1.0 if var == 0 else min(0.3 * eps * alpha / var, 1.0)
    delta = eta * delta_star / math.ceil(16.0 * (beta / alpha) ** 2)
    T = math.ceil(10.0 / eta * (beta / alpha) * math.log(max(f0_gap / eps, math.e)))
    return Theorem2Params(eta=eta, delta=delta, T=T, lr=eta / beta)


WEIGHT_QS = ("shift", "nearest", "coinflip", "none")


def run_qsgd(obj: Quadratic, x0: torch.Tensor, params: Theorem2Params, key: prng.Key,
             sigma: float = 0.0, weight_q: str = "shift", grad_q_delta: Optional[float] = None,
             record_every: int = 1, x64: bool = True,
             device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the Theorem-2 iteration on `device` (the card unless given);
    returns (x_T, f-trajectory): (n,) and (T',) for one key, (S, n) and
    (T', S) for a row of S keys (each row its key's own run).  f64 unless
    ``x64=False``: the f(x_t) - f* gaps span many orders of magnitude and
    bottom out at the f32 resolution of f after a handful of steps."""
    if weight_q not in WEIGHT_QS:
        raise ValueError(f"weight_q must be one of {WEIGHT_QS}, got {weight_q!r}")
    device = resolve_device(device)
    obj = obj.to(device)
    x = x0.to(device, torch.float64 if x64 else x0.dtype)
    if isinstance(key[0], torch.Tensor):
        key = (key[0].to(device), key[1].to(device))
        x = x.expand(key[0].shape[0], x.shape[-1])

    def qw(x, k):
        if weight_q == "shift":
            return q_shift(x, params.delta, k)
        if weight_q == "nearest":
            return q_nearest(x, params.delta)
        if weight_q == "coinflip":
            return q_coinflip(x, params.delta, k)
        return x

    fs = []
    for _ in range(params.T):
        key, kg, kq, kgq = prng.split(key, 4)
        g = obj.noisy_grad(x, kg, sigma) if sigma > 0 else obj.grad(x)
        if grad_q_delta is not None:  # Corollary 3: unbiased gradient quantizer
            g = q_coinflip(g, grad_q_delta, kgq)
        x = qw(x - params.lr * g, kq)
        fs.append(obj.f(x))
    return x, torch.stack(fs)[::record_every]
