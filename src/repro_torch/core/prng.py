"""Threefry-2x32 counter PRNG, bit-compatible with ``jax.random`` in its
partitionable mode (``jax_threefry_partitionable=True``, the default since
JAX 0.5).

The JAX package draws every quantization randomness from ``jax.random``
keys; drawing the same bits here makes the port's shift- and
stochastic-mode wire bytes equal to the reference's byte for byte.

A key is a pair of Python ints ``(k1, k2)``, each a uint32 value.  Key
derivation (``PRNGKey``, ``fold_in``, ``split``) is scalar integer work and
runs on the host, as does ``fold_in_rows`` over a (B, 2) tensor of keys;
bulk draws (``bits``, ``uniform``, ``normal``, ``randint``, ``gumbel``) run
as int64 tensor arithmetic, masked to 32 bits, on any device (the wire
quantizers and the sampler draw on the card in kernels: K1 its rounding
bits, ``kernels.ops.random_bits`` the sampler's).  ``to_uniform`` and
``gumbel_from_bits`` turn drawn bits into floats with int32 and f32
operations only.

A key's two words may also be (S,) int64 tensors, a row of S keys
(:func:`key_rows`): a draw of `shape` from it draws `shape` once per key,
each as that key alone would, into (S, *shape); ``fold_in`` and ``split``
work on rows as on one key.  64-bit draws (``bits(..., width=64)``, f64
``uniform`` and ``normal``) are those of ``jax.random`` under
``jax.enable_x64(True)``: the hash's first word shifted left 32, OR the
second (the 32-bit draw XORs them).

Sources in JAX 0.9.0: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real``, ``_randint``,
``_gumbel`` in its default "low" mode); XLA's expansion of ``erf_inv``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
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
    be scalars or tensors broadcasting against the counts).  CPU tensors
    hash in numpy's wrapping uint32 arithmetic (:func:`_threefry2x32_u32`,
    the same words several times faster than int64 tensor ops)."""
    ts = [v for v in (k1, k2, x0, x1) if isinstance(v, torch.Tensor)]
    if ts and all(t.device.type == "cpu" for t in ts):
        return _threefry2x32_u32(k1, k2, x0, x1, max(t.dim() for t in ts))
    return _threefry2x32_i64(k1, k2, x0, x1)


def _threefry2x32_i64(k1, k2, x0, x1):
    """:func:`_threefry2x32` in masked int64 (or Python int) arithmetic,
    on any device."""
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


def _threefry2x32_u32(k1, k2, x0, x1, ndim: int):
    """:func:`_threefry2x32` of CPU tensors (and ints) in numpy uint32,
    where every sum wraps mod 2**32 as the masked int64 sums do; returns
    int64 tensors of the u32 words."""
    def u32(v):
        if isinstance(v, torch.Tensor):
            return v.numpy().astype(np.uint32)
        return np.full((1,) * ndim, v & _M32, dtype=np.uint32)

    k1, k2, x0, x1 = (u32(v) for v in (k1, k2, x0, x1))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return (torch.from_numpy(np.asarray(x0, dtype=np.int64)),
            torch.from_numpy(np.asarray(x1, dtype=np.int64)))


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
    """``jax.random.split(key, num)`` (fold-like in partitionable mode); a
    row of keys splits in one hash of (S, num) counters."""
    if isinstance(key[0], torch.Tensor):
        w0, w1 = _hash(key, (num,), None)
        return [(w0[:, i], w1[:, i]) for i in range(num)]
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


def key_rows(keys: Sequence[Key], device="cpu") -> Key:
    """S keys -> one key whose words are (S,) int64 tensors on `device`."""
    k = torch.tensor([list(k) for k in keys], dtype=torch.int64, device=device)
    return k[:, 0], k[:, 1]


def _hash(key: Key, shape: Sequence[int], device) -> tuple:
    """The two threefry words at the flat indices of `shape` (counter (0,
    index)); a row of keys hashes `shape` once per key."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("more than 2**32 values per key are not supported")
    k1, k2 = key
    if isinstance(k1, torch.Tensor):
        device = k1.device
        lead = (-1,) + (1,) * len(shape)
        k1, k2 = k1.reshape(lead), k2.reshape(lead)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return _threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def bits_at(key: Key, counts: torch.Tensor) -> torch.Tensor:
    """The 32 bits that ``jax.random.bits(key, shape, uint32)`` puts at the
    flat indices `counts` (int64, < 2**32): XOR of the two hash words at
    (hi, lo) = (0, count), the partitionable ``random_bits``."""
    b0, b1 = _threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return b0 ^ b1


def bits(key: Key, shape: Sequence[int], device="cpu",
         width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint{width})`` as an int64 tensor:
    widths 16 and 32 hold the unsigned values (16: the low half of the
    32-bit draw); width 64 holds the uint64 bit patterns (negative where
    the top bit is set)."""
    if width not in (16, 32, 64):
        raise ValueError(f"width must be 16, 32 or 64, got {width}")
    hi, lo = _hash(key, shape, device)
    if width == 64:
        return (hi << 32) | lo
    out = hi ^ lo
    return out & 0xFFFF if width == 16 else out


def to_uniform(b: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """uint32 bits (u32 values in int64, or their bit patterns in int32) ->
    f32 in [minval, maxval) as ``jax.random.uniform`` makes them: mantissa
    fill of 1.0, minus 1, then the affine map."""
    u = (((b >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def to_uniform64(b: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """uint64 bit patterns (int64) -> f64 in [minval, maxval) as
    ``jax.random.uniform`` makes them under x64: the top 52 bits as the
    mantissa of a number in [1, 2), minus 1, then the affine map."""
    mant = (b >> 12) & ((1 << 52) - 1)  # the logical shift of the uint64
    u = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = torch.tensor(minval, dtype=torch.float64, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float64, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def uniform(key: Key, shape: Sequence[int], device="cpu", minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` in f32, or
    in f64 as under ``jax.enable_x64(True)``."""
    if dtype == torch.float64:
        return to_uniform64(bits(key, shape, device, 64), minval, maxval)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws f32 or f64, not {dtype}")
    return to_uniform(bits(key, shape, device), minval, maxval)


def _horner(coefs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coefs[0])
    for c in coefs[1:]:
        p = c + p * w
    return p


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011), the
# expansion XLA lowers erf_inv to.  Single precision: w < 5 and w >= 5.
_ERFINV32 = ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
             (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
# Double precision: w < 6.25 (23 terms), w < 16 (19), w >= 16 (17).
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221))


# XLA's log1p on the CPU: Cephes' rational approximation for |x| < sqrt(2) - 1,
# log(1 + x) beyond (it takes x down to -0.414, past the -0.293 Cephes
# fits, so it is off by ~1e-14 relative there, and erf_inv with it)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = x + (-0.5 * x2 + x * x2 * (_horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)))
    return torch.where(x.abs() < 0.41421356237309504880, small, torch.log(1 + x))


def erfinv(u: torch.Tensor) -> torch.Tensor:
    """The inverse error function as XLA computes ``lax.erf_inv`` in f32 or
    f64: w = -log1p(-u*u), a polynomial in w or sqrt(w) per range of w,
    times u; +-inf at +-1.  Within 2 ulp of XLA's on the CPU, where its own
    logf and the multiply-adds it fuses round differently."""
    w = -_xla_log1p(-u * u)
    if u.dtype == torch.float32:
        p = torch.where(w < 5, _horner(_ERFINV32[0], w - 2.5),
                        _horner(_ERFINV32[1], torch.sqrt(w) - 3.0))
    elif u.dtype == torch.float64:
        p = torch.where(w < 6.25, _horner(_ERFINV64[0], w - 3.125),
                        torch.where(w < 16, _horner(_ERFINV64[1], torch.sqrt(w) - 3.25),
                                    _horner(_ERFINV64[2], torch.sqrt(w) - 5.0)))
    else:
        raise TypeError(f"erfinv takes f32 or f64, not {u.dtype}")
    return torch.where(u.abs() == 1, u * math.inf, p * u)


def _normal_bf16(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)``.  Its uniform draws 8 bits
    per value (bf16 has 7 mantissa bits, fewer than 8): the low byte of the
    32-bit draw, shifted right once into the mantissa of a number in [1,
    2); every step after that is a bf16 operation, rounded as the CPU
    rounds it (computed in f32, rounded to bf16): minus 1, times (1 - lo),
    plus lo, clamped at lo = nextafter(-1, 0) = -1 + 2**-8; erf_inv in f32
    rounded to bf16; times sqrt(2) in bf16."""
    bf = torch.bfloat16
    b8 = bits(key, shape, device) & 0xFF
    one = torch.tensor(1.0, dtype=bf, device=device)
    lo = torch.tensor(-1.0 + 2.0 ** -8, dtype=bf, device=device)
    f = ((b8 >> 1) | 0x3F80).to(torch.int16).view(bf) - one
    u = torch.maximum(lo, f * (one - lo) + lo)
    return torch.tensor(math.sqrt(2), dtype=bf, device=device) * erfinv(u.float()).to(bf)


def normal(key: Key, shape: Sequence[int], device="cpu", dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` (f32, bf16, or f64 as under
    x64): a uniform on (nextafter(-1, 0), 1), times sqrt(2) after erf_inv."""
    if dtype == torch.bfloat16:
        return _normal_bf16(key, shape, device)
    one = torch.tensor(1.0, dtype=dtype)
    lo = float(torch.nextafter(-one, torch.zeros_like(one)))
    u = uniform(key, shape, device, lo, 1.0, dtype)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=u.device) * erfinv(u)


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
