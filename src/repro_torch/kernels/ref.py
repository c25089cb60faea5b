"""Plain PyTorch versions of the CUDA kernels (K1-K5, and the sampler's
draw ``random_bits``).

Each function computes exactly what its kernel computes; ``kernels.ops``
runs it for tensors on the CPU, the tests hold it against the JAX package,
and ``chip_smoke.py`` holds each kernel against it on the card.

Two expressions of the reference are fused multiply-adds under XLA (the
shift-mode ``zero = lo + r*scale`` and the decode ``c*scale + zero``); the
kernels use ``__fmaf_rn`` there and :func:`fma_f32` reproduces a correctly
rounded f32 fma here (:func:`fma_f64` the f64 one, for the lattice
quantizers of the theory runs).

K1 takes a PRNG key and draws its rounding randomness itself; its plain
version :func:`quantize_pack_key_ref` draws the same bits with the threefry
twin (:func:`draw_rand`, at the counters :func:`k1_counters` names) and
quantizes with :func:`quantize_pack_ref`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core import prng

_MODES = ("nearest", "stochastic", "shift")


def codes_per_byte(bits: int) -> int:
    return 8 // bits if 8 % bits == 0 else 1


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a*b + c) with ONE rounding, as ``fmaf`` computes it.

    a*b of two f32 values is exact in f64; the f64 sum is made exact by
    TwoSum and rounded to odd, after which the rounding to f32 is correct
    (53 >= 2*24 + 2 bits, so round-to-odd is innocuous)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    # inexact with an even last bit: step one ulp toward the exact value
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0)
    s = torch.where(fix, bits + step, bits).view(torch.float64)
    return s.float()


def fma_f64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c in f64 rounded once, as a fused multiply-add rounds it,
    from error-free transformations: the exact product as p + e (Dekker's
    split), p + c as s + err (TwoSum), then s + (err + e).  Correctly
    rounded except where the final sum rounds twice (rare)."""
    split = 134217729.0  # 2^27 + 1
    p = a * b
    t = split * a
    ah = t - (t - a)
    al = a - ah
    t = split * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return s + (err + e)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (..., n) u8 codes of width `bits` into (..., n*bits/8) bytes
    when 8 % bits == 0; otherwise pass through (one code per byte)."""
    k = codes_per_byte(bits)
    if k == 1:
        return codes
    *lead, n = codes.shape
    if n % k:
        raise ValueError(f"{n} codes do not pack {k} per byte")
    c = codes.reshape(*lead, n // k, k).to(torch.int32)
    shifts = torch.arange(k, dtype=torch.int32, device=codes.device) * bits
    return torch.sum(c << shifts, dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`."""
    k = codes_per_byte(bits)
    if k == 1:
        return packed
    shifts = torch.arange(k, dtype=torch.int32, device=packed.device) * bits
    c = (packed.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    *lead, n, _ = c.shape
    return c.reshape(*lead, n * k).to(torch.uint8)


def quantize_pack_ref(x: torch.Tensor, rand: torch.Tensor, levels: int,
                      bits: int, mode: str = "nearest",
                      rand_scale: float = 1.0):
    """K1: bucketed min-max quantize of (nb, bucket) f32 rows + bit-pack.

    rand: (nb, bucket) thresholds for "stochastic" (``up = rand < frac *
    rand_scale``), (nb, 1) shifts in [-0.5, 0.5) for "shift", ignored for
    "nearest".  Returns (packed u8 (nb, bucket*bits/8), scale (nb, 1),
    zero (nb, 1))."""
    if mode not in _MODES:
        raise ValueError(mode)
    f32 = dict(dtype=torch.float32, device=x.device)
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    scale = torch.maximum((hi - lo) * torch.tensor(1.0 / levels, **f32),
                          torch.tensor(1e-12, **f32))
    v = (x - lo) / scale
    if mode == "stochastic":
        f = torch.floor(v)
        up = rand < (v - f) * torch.tensor(rand_scale, **f32)
        codes = f + up.to(torch.float32)
        zero = lo
    elif mode == "shift":
        codes = torch.round(v - rand)
        zero = fma_f32(rand, scale, lo)
    else:
        codes = torch.round(v)
        zero = lo
    codes = torch.clamp(codes, 0, levels).to(torch.uint8)
    return pack_codes(codes, bits), scale, zero


def k1_counters(nb: int, bucket: int, mode: str, device="cpu") -> torch.Tensor:
    """The threefry counter K1 hashes for value j of bucket b, as an int64
    grid: ``b * bucket + j`` in stochastic mode ((nb, bucket): the flat
    index ``jax.random.uniform(key, (nb, bucket))`` draws at), ``b`` in
    shift mode ((nb, 1): one draw per bucket)."""
    b = torch.arange(nb, dtype=torch.int64, device=device)[:, None]
    if mode == "stochastic":
        return b * bucket + torch.arange(bucket, dtype=torch.int64, device=device)
    return b


def draw_rand(key, nb: int, bucket: int, mode: str, rand_bits: int = 32,
              device="cpu") -> tuple[torch.Tensor, float]:
    """K1's rounding randomness for (nb, bucket) values under `key`, as
    (rand, rand_scale) for :func:`quantize_pack_ref`: the bits the kernel
    computes in its threads, and those the JAX package draws
    (``core/quant.py:241-254``).  Stochastic: ``uniform(key, (nb, bucket))``,
    or with ``rand_bits=16`` the low 16 bits of ``bits(key, (nb, bucket))``
    compared against frac * 65536; shift: ``uniform(key, (nb, 1), -0.5,
    0.5)``; nearest: no draw (zeros)."""
    if mode not in _MODES:
        raise ValueError(mode)
    if mode == "nearest":
        return torch.zeros((nb, 1), dtype=torch.float32, device=device), 1.0
    if key is None:
        raise ValueError(f"mode={mode!r} requires a PRNG key")
    if rand_bits not in (16, 32):
        raise ValueError(f"rand_bits must be 16 or 32, got {rand_bits}")
    if nb * (bucket if mode == "stochastic" else 1) > 1 << 32:
        raise ValueError("more than 2**32 draws per key are not supported")
    b = prng.bits_at(key, k1_counters(nb, bucket, mode, device))
    if mode == "shift":
        return prng.to_uniform(b, -0.5, 0.5), 1.0
    if rand_bits == 16:
        return (b & 0xFFFF).to(torch.float32), 65536.0
    return prng.to_uniform(b), 1.0


def quantize_pack_key_ref(x: torch.Tensor, key, levels: int, bits: int,
                          mode: str = "nearest", rand_bits: int = 32):
    """K1 as the wrapper calls it: the rounding randomness drawn from `key`
    (:func:`draw_rand`), then :func:`quantize_pack_ref`."""
    rand, rand_scale = draw_rand(key, x.shape[0], x.shape[1], mode, rand_bits, x.device)
    return quantize_pack_ref(x, rand, levels, bits, mode, rand_scale)


def unpack_dequantize_ref(codes: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, bits: int,
                          dtype=torch.float32) -> torch.Tensor:
    """K2: (nb, bucket*bits/8) packed u8 + (nb, 1) affine -> (nb, bucket)."""
    c = unpack_codes(codes, bits).to(torch.float32)
    return fma_f32(c, scale, zero).to(dtype)


def bucket_bytes(bucket: int, bits: int) -> int:
    """Bytes of one bucket's packed codes."""
    return bucket // codes_per_byte(bits)


def view_bytes(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1-D u8 bytes read as `dtype` (a copy: a slice of a wire buffer need
    not be aligned for a view)."""
    return b.clone().view(dtype)


class WireCodes(NamedTuple):
    """One quantized tensor inside a u8 wire buffer, as K2's table takes it:
    the byte offsets of its codes (nb buckets of ``bucket_bytes(bucket,
    bits)``), of its scale (nb,) and of its zero (nb,) in `meta_dtype` (f32
    or bf16).  ``core.quant.wire_codes`` places them as the wire format
    lays them out."""

    codes: int
    scale: int
    zero: int
    nb: int
    bucket: int
    bits: int
    meta_dtype: torch.dtype = torch.float32


def unpack_dequantize_wire_ref(buf, segments: Sequence[WireCodes],
                               out_dtypes: Sequence) -> list[torch.Tensor]:
    """K2 over a wire buffer: each segment of (1-D u8) `buf` decoded into an
    (nb, bucket) tensor in its out dtype (f32 or bf16), one
    :func:`unpack_dequantize_ref` per segment.  `buf` may be a sequence of
    buffers, one per segment."""
    bufs = [buf] * len(segments) if isinstance(buf, torch.Tensor) else buf
    outs = []
    for buf, w, dt in zip(bufs, segments, out_dtypes, strict=True):
        cb, mb = bucket_bytes(w.bucket, w.bits), w.nb * w.meta_dtype.itemsize
        codes = buf[w.codes:w.codes + w.nb * cb].reshape(w.nb, cb)
        scale = view_bytes(buf[w.scale:w.scale + mb], w.meta_dtype).to(torch.float32)
        zero = view_bytes(buf[w.zero:w.zero + mb], w.meta_dtype).to(torch.float32)
        outs.append(unpack_dequantize_ref(codes, scale[:, None], zero[:, None], w.bits, dt))
    return outs


def quantize_buckets_ref(x: torch.Tensor, rand: torch.Tensor, levels: int = 255,
                         stochastic: bool = True):
    """K4: unpacked bucketed quantize of (nb, bucket) f32 rows, one u8 code
    per value in [0, levels]: K1 at 8 bits, nearest or stochastic (``up =
    rand < frac``, rand (nb, bucket)).  Returns (codes, scale (nb, 1),
    zero (nb, 1))."""
    return quantize_pack_ref(x, rand, levels, 8, "stochastic" if stochastic else "nearest")


def dequantize_buckets_ref(codes: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """K5: (nb, bucket) u8 codes + (nb, 1) affine -> codes*scale + zero."""
    return unpack_dequantize_ref(codes, scale, zero, 8, dtype)


def rowquant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """K3: y = x @ dequant(W) with per-(K-row, N-segment) affine.

    x (M, K) f32/bf16; codes (K, N) u8; scale/zero (K, n_seg) f32 with
    N % n_seg == 0.  f32 math, output in x.dtype."""
    n = codes.shape[1]
    n_seg = scale.shape[1]
    if n % n_seg:
        raise ValueError(f"N={n} is not a multiple of n_seg={n_seg}")
    s = torch.repeat_interleave(scale, n // n_seg, dim=1)
    z = torch.repeat_interleave(zero, n // n_seg, dim=1)
    w = fma_f32(codes.to(torch.float32), s, z)
    return (x.to(torch.float32) @ w).to(x.dtype)


def random_bits_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The sampler's draw: row r of ``jax.random.bits(key_r, (n,), uint32)``
    for each of the (R, 2) keys, with the threefry twin.  Keys and bits are
    u32 bit patterns held in int32 tensors (PyTorch's unsigned 32-bit type
    has few kernels); returns (R, n) int32."""
    rows = [prng.bits(tuple(int(w) & 0xFFFFFFFF for w in k), (n,), keys.device)
            for k in keys.tolist()]
    return prng.as_i32(torch.stack(rows)) if rows else keys.new_empty((0, n))
