"""Learned quantization levels (paper Section 5.2, Algorithm 2), the JAX
package's ``core/levels.py`` in PyTorch.

Instead of the uniform grid, the locations of the ``2^b`` quantization
levels are fitted to the (bucket-normalized) values by an SGD-style pass:

    for each value v_i:
        q_j = find_closest(v_i, Q)
        q_j = q_j - lr * (q_j - v_i)

``learn_levels_sequential`` is that literal loop (for tests);
``learn_levels_minibatch`` the vectorized estimator the paper's
implementation uses (batch 1024, lr 0.01), which applies the accumulated
per-level update once per batch.  Non-uniform encode/decode uses the
bucketed min-max normalization of the wire quantizer, so learned levels
drop into the same wire format: codes are indices into the level table.

Everything here is plain tensor work on x's device (the reference's is
plain ``jnp``, outside any Pallas kernel).  Ties resolve as in the
reference: ``torch.argmin`` and ``jnp.argmin`` take the first index,
``torch.searchsorted(right=True)`` is ``jnp.searchsorted(side="right")``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import prng
from .quant import QuantConfig, Quantized, _to_buckets, pack_codes, unpack_codes


def uniform_levels(bits: int, device="cpu") -> torch.Tensor:
    """Initial (uniform) level locations on the normalized [0, 1] range,
    rounded as ``jnp.linspace`` rounds them: i times the f32 reciprocal of
    2^bits - 1 (XLA's form of the division by a constant), the last level
    exactly 1."""
    n = 1 << bits
    step = torch.tensor(1.0, device=device) / (n - 1)
    out = torch.arange(n, dtype=torch.float32, device=device) * step
    out[-1] = 1.0
    return out


def _nearest_level(v: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Index of the closest level for each value (levels need not be sorted
    during learning, so argmin rather than searchsorted)."""
    return torch.argmin(torch.abs(v[..., None] - levels), dim=-1)


def learn_levels_minibatch(values: torch.Tensor, levels: torch.Tensor, lr: float = 0.01,
                           batch_size: int = 1024) -> torch.Tensor:
    """One epoch of Algorithm 2 over `values` (already normalized to [0,1]).

    For each minibatch every value pulls its closest level toward itself,
    and a level's pulls within a batch are averaged: applying the sequential
    rule to `cnt` values near `mean_v` moves the level (1 - (1-lr)^cnt) of
    the way toward their mean, and that closed-form rate is used."""
    n = values.shape[0]
    pad = (-n) % batch_size
    v = torch.nn.functional.pad(values, (0, pad)).reshape(-1, batch_size)
    valid = torch.nn.functional.pad(torch.ones(n, device=values.device), (0, pad))
    valid = valid.reshape(-1, batch_size)
    k = levels.shape[0]
    for vb, mb in zip(v, valid):
        idx = _nearest_level(vb, levels)
        one_hot = torch.nn.functional.one_hot(idx, k).to(torch.float32) * mb[:, None]
        cnt = torch.sum(one_hot, dim=0)
        mean_v = torch.sum(one_hot * vb[:, None], dim=0) / torch.clamp(cnt, min=1.0)
        rate = 1.0 - (1.0 - lr) ** cnt
        levels = torch.where(cnt > 0, levels - rate * (levels - mean_v), levels)
    return levels


def learn_levels_sequential(values: torch.Tensor, levels: torch.Tensor,
                            lr: float = 0.01) -> torch.Tensor:
    """The literal per-value loop of Algorithm 2 (reference / tests)."""
    levels = levels.clone()
    for vi in values:
        j = _nearest_level(vi, levels)
        levels[j] = levels[j] + (-lr * (levels[j] - vi))
    return levels


@dataclasses.dataclass(frozen=True)
class LevelsConfig:
    bits: int = 4
    bucket_size: int = 1024
    lr: float = 0.01
    batch_size: int = 1024
    epochs: int = 1
    min_params: int = 100_000  # layers smaller than this stay uniform (App. C)


def _normalized(x: torch.Tensor, bucket_size: int):
    """(buckets normalized to [0, 1], bucket min, bucket range, size)."""
    buckets, size = _to_buckets(x, bucket_size)
    lo = torch.amin(buckets, dim=1, keepdim=True)
    hi = torch.amax(buckets, dim=1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-12)
    return (buckets - lo) / scale, lo, scale, size


def learn_levels_for_tensor(x: torch.Tensor, cfg: LevelsConfig) -> torch.Tensor:
    """Learn a level table for one tensor, after bucket-wise normalization
    (paper: 'Normalize values V bucket-wise')."""
    v, _, _, size = _normalized(x, cfg.bucket_size)
    v = v.reshape(-1)[:size]
    levels = uniform_levels(cfg.bits, x.device)
    for _ in range(cfg.epochs):
        levels = learn_levels_minibatch(v, levels, cfg.lr, cfg.batch_size)
    return torch.sort(levels).values


# ---------------------------------------------------------------------------
# Non-uniform wire quantization with a level table
# ---------------------------------------------------------------------------


def quantize_levels(x: torch.Tensor, levels: torch.Tensor, bucket_size: int = 1024,
                    key: Optional[prng.Key] = None) -> Quantized:
    """Bucket-normalize, then encode each value as the index of its nearest
    level, or (with `key`) stochastically between its two neighbours, which
    keeps the estimator unbiased within the table's convex hull."""
    bits = int(math.log2(levels.shape[0]))
    if (1 << bits) != levels.shape[0]:
        raise ValueError(f"level count must be a power of 2, got {levels.shape[0]}")
    cfg = QuantConfig(bits=bits, bucket_size=bucket_size, mode="nearest")
    v, lo, scale, size = _normalized(x, bucket_size)
    srt = torch.sort(levels).values
    # index of the right neighbour in the sorted table
    hi_idx = torch.clamp(torch.searchsorted(srt, v, right=True), 1, srt.shape[0] - 1)
    lo_idx = hi_idx - 1
    l_lo, l_hi = srt[lo_idx], srt[hi_idx]
    frac = torch.clamp((v - l_lo) / torch.clamp(l_hi - l_lo, min=1e-12), 0.0, 1.0)
    if key is None:
        take_hi = frac > 0.5
    else:
        take_hi = prng.uniform(key, tuple(v.shape), v.device) < frac
    codes = torch.where(take_hi, hi_idx, lo_idx).to(torch.uint8)
    return Quantized(codes=pack_codes(codes, bits), scale=scale[:, 0], zero=lo[:, 0],
                     shape=tuple(x.shape), size=size, cfg=cfg)


def dequantize_levels(q: Quantized, levels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    srt = torch.sort(levels).values
    v = srt[unpack_codes(q.codes, q.cfg.bits).long()]
    x = v * q.scale[:, None] + q.zero[:, None]
    return x.reshape(-1)[: q.size].reshape(q.shape).to(dtype)


def compression_error(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Relative L2 compression error (the paper's Figures 7/8 metric)."""
    return torch.linalg.norm((x - xq).reshape(-1)) / torch.clamp(
        torch.linalg.norm(x.reshape(-1)), min=1e-12)
