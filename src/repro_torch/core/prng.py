"""Threefry-2x32 counter PRNG, bit-compatible with ``jax.random`` in its
partitionable mode (``jax_threefry_partitionable=True``, the default since
JAX 0.5).

The JAX package draws every quantization randomness from ``jax.random``
keys; drawing the same bits here makes the port's shift- and
stochastic-mode wire bytes equal to the reference's byte for byte.

A key is a pair of Python ints ``(k1, k2)``, each a uint32 value.  Key
derivation (``PRNGKey``, ``fold_in``, ``split``) is scalar integer work and
runs on the host, as does ``fold_in_rows`` over a (B, 2) tensor of keys;
bulk draws (``bits``, ``uniform``, ``randint``, ``gumbel``) run as int64
tensor arithmetic, masked to 32 bits, and are used on the CPU only (on the
card the kernels draw: K1 its rounding bits, ``kernels.ops.random_bits``
the sampler's).  ``to_uniform`` and ``gumbel_from_bits`` turn drawn bits
into floats with int32 and f32 operations only.

Sources in JAX 0.9.0: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``, ``_gumbel`` in its
default "low" mode).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

Key = tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def stable_hash(s: str) -> int:
    """FNV-1a over the UTF-8 bytes — the per-name key salt of the JAX
    package (``core/qsdp.py::_stable_hash``, ``train/step.py::_h``)."""
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 & _M32
    return h


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 block function.  Works elementwise on
    Python ints and on int64 tensors holding uint32 values alike (keys may
    be scalars or tensors broadcasting against the counts)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed bitcast to (hi, lo) words."""
    if not -(1 << 63) <= seed < (1 << 64):
        raise ValueError(f"seed {seed} does not fit in 64 bits")
    seed &= (1 << 64) - 1
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)`` (fold-like in partitionable mode)."""
    return [_threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)(keys, data)``: (B, 2) keys (int64 or
    int32 tensors of u32 values or bit patterns) and (B,) 32-bit data ->
    (B, 2) int64 keys."""
    k = keys.to(torch.int64) & _M32
    x0, x1 = _threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(k[:, 0]),
                           data.to(torch.int64) & _M32)
    return torch.stack([x0, x1], dim=1)


def as_i32(b: torch.Tensor) -> torch.Tensor:
    """u32 values in an int64 tensor -> the same bit patterns as int32."""
    b = b & _M32
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)


def bits_at(key: Key, counts: torch.Tensor) -> torch.Tensor:
    """The 32 bits that ``jax.random.bits(key, shape, uint32)`` puts at the
    flat indices `counts` (int64, < 2**32): XOR of the two hash words at
    (hi, lo) = (0, count), the partitionable ``random_bits``."""
    b0, b1 = _threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return b0 ^ b1


def bits(key: Key, shape: Sequence[int], device="cpu",
         width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint{width})`` as an int64 tensor
    holding the unsigned values (width 32 or 16: the low word is kept)."""
    if width not in (16, 32):
        raise ValueError(f"width must be 16 or 32, got {width}")
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("more than 2**32 values per key are not supported")
    out = bits_at(key, torch.arange(n, dtype=torch.int64, device=device))
    if width == 16:
        out = out & 0xFFFF
    return out.reshape(tuple(shape))


def to_uniform(b: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """uint32 bits (u32 values in int64, or their bit patterns in int32) ->
    f32 in [minval, maxval) as ``jax.random.uniform`` makes them: mantissa
    fill of 1.0, minus 1, then the affine map."""
    u = (((b >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def uniform(key: Key, shape: Sequence[int], device="cpu",
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return to_uniform(bits(key, shape, device), minval, maxval)


_F32_TINY = torch.finfo(torch.float32).tiny


def gumbel_from_bits(b: torch.Tensor) -> torch.Tensor:
    """Drawn bits -> ``jax.random.gumbel``'s f32 noise: a uniform in
    [tiny, 1), then ``-log(-log(u))``."""
    return -torch.log(-torch.log(to_uniform(b, _F32_TINY, 1.0)))


def gumbel(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (default "low" mode)."""
    return gumbel_from_bits(bits(key, shape, device))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 output
    (two 32-bit draws reduced modulo the span, as JAX does)."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape, device), bits(k2, shape, device)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    # uint32 arithmetic: every product and sum wraps, as lax.mul/add do
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    off = off % span
    return (minval + off).to(torch.int64)
