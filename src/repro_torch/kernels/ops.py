"""Checked wrappers around the CUDA kernels, with one launch counter each.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a tensor
on the card launches the kernel (built from ``csrc/`` at first use) on
``torch.cuda.current_stream()``, or raises.  There is no fallback: a CUDA
tensor never takes the plain path.

``LAUNCHES[name]`` counts kernel launches and nothing else, so a run can
show which kernels its main path went through (``reset_launches()`` zeroes
the counts).  K2 has two entry points, one tensor (``unpack_dequantize``)
and a wire buffer's table of segments (``unpack_dequantize_wire``); both
count under ``"unpack_dequantize"``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from collections import Counter
from typing import NamedTuple, Sequence

import torch

from . import build, ref
from .ref import WireCodes

KERNELS = ("quantize_pack", "unpack_dequantize", "rowquant_matmul", "quantize_buckets",
           "dequantize_buckets")
LAUNCHES: Counter = Counter({k: 0 for k in KERNELS})

_MODE_IDS = {"nearest": 0, "stochastic": 1, "shift": 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)  # what K2 and K5 write


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, "
                     f"got {[str(t.device) for t in ts]}")


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def quantize_pack(x: torch.Tensor, key, levels: int, bits: int,
                  mode: str = "nearest", rand_bits: int = 32):
    """K1: fused bucketed quantize + bit-pack of (nb, bucket) f32 rows,
    drawing its rounding randomness from the PRNG `key` (a pair of u32
    words; None for "nearest") as ``ref.draw_rand`` does.  Returns (codes u8
    (nb, bucket*bits/8 or bucket), scale (nb, 1), zero (nb, 1))."""
    if _on_cpu(x):
        return ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)
    nb, bucket = x.shape
    k = ref.codes_per_byte(bits)
    if mode not in _MODE_IDS or bucket % k or not 1 <= bits <= 8 or rand_bits not in (16, 32):
        raise ValueError(f"unsupported mode={mode!r} bits={bits} bucket={bucket} "
                         f"rand_bits={rand_bits}")
    if mode != "nearest" and key is None:
        raise ValueError(f"mode={mode!r} requires a PRNG key")
    if mode == "stochastic" and nb * bucket > 1 << 32:
        raise ValueError("more than 2**32 draws per key are not supported")
    _check("x", x, torch.float32, (nb, bucket))
    k0, k1 = key if key is not None else (0, 0)
    codes = torch.empty((nb, bucket // k), dtype=torch.uint8, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    rc = build.load("quantize").qsdp_quantize_pack(
        x.data_ptr(), k0, k1, rand_bits, codes.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), nb, bucket, bits, levels, 1.0 / levels, _MODE_IDS[mode], _stream())
    _raise_on(rc, "quantize_pack")
    LAUNCHES["quantize_pack"] += 1
    return codes, scale, zero


def unpack_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, bits: int,
                      dtype=torch.float32) -> torch.Tensor:
    """K2: fused bit-unpack + affine decode: (nb, bucket*bits/8) packed u8 +
    (nb, 1) scale/zero -> (nb, bucket) in `dtype` (f32 or bf16)."""
    if _on_cpu(codes, scale, zero):
        return ref.unpack_dequantize_ref(codes, scale, zero, bits, dtype)
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"unpack_dequantize writes f32 or bf16, not {dtype}")
    nb, nbytes = codes.shape
    bucket = nbytes * ref.codes_per_byte(bits)
    _check("codes", codes, torch.uint8, (nb, nbytes))
    _check("scale", scale, torch.float32, (nb, 1))
    _check("zero", zero, torch.float32, (nb, 1))
    out = torch.empty((nb, bucket), dtype=dtype, device=codes.device)
    rc = build.load("quantize").qsdp_unpack_dequantize(
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), nb, bucket, bits, _stream())
    _raise_on(rc, "unpack_dequantize")
    LAUNCHES["unpack_dequantize"] += 1
    return out


WIRE_MAX_SEGS = 64  # quantize.cu: kMaxSegs, the segments one launch's table holds


def unpack_dequantize_wire(buf: torch.Tensor, segments: Sequence[WireCodes],
                           out_dtypes: Sequence) -> list[torch.Tensor]:
    """K2 over a wire buffer: every quantized segment of the 1-D u8 `buf`
    (``ref.WireCodes``: codes, scale and zero read in place) decoded into a
    new (nb, bucket) tensor in its out dtype (f32 or bf16).  One launch per
    WIRE_MAX_SEGS segments with nb > 0: one launch for a buffer of up to 64."""
    if len(segments) != len(out_dtypes):
        raise ValueError(f"{len(segments)} segments, {len(out_dtypes)} out dtypes")
    if _on_cpu(buf):
        return ref.unpack_dequantize_wire_ref(buf, segments, out_dtypes)
    _check("buf", buf, torch.uint8, (buf.numel(),))
    outs, rows = [], []
    base = buf.data_ptr()
    for seg, dt in zip(segments, out_dtypes):
        if dt not in _OUT_DTYPES:
            raise TypeError(f"unpack_dequantize_wire writes f32 or bf16, not {dt}")
        if seg.meta_dtype not in _OUT_DTYPES:
            raise TypeError(f"scale/zero must be f32 or bf16, not {seg.meta_dtype}")
        if (not 1 <= seg.bits <= 8 or seg.bucket < 1 or seg.nb < 0
                or seg.bucket % ref.codes_per_byte(seg.bits)):
            raise ValueError(f"unsupported segment {seg}")
        mb = seg.nb * seg.meta_dtype.itemsize
        for start, n in ((seg.codes, seg.nb * ref.bucket_bytes(seg.bucket, seg.bits)),
                         (seg.scale, mb), (seg.zero, mb)):
            if start < 0 or start + n > buf.numel():
                raise ValueError(f"segment {seg} runs past the {buf.numel()}-byte buffer")
        out = torch.empty((seg.nb, seg.bucket), dtype=dt, device=buf.device)
        outs.append(out)
        if seg.nb:
            flags = int(seg.meta_dtype == torch.bfloat16) | 2 * int(dt == torch.bfloat16)
            rows.append((base + seg.codes, base + seg.scale, base + seg.zero, out.data_ptr(),
                         seg.nb, seg.bucket, seg.bits, flags))
    lib = build.load("quantize") if rows else None
    for i in range(0, len(rows), WIRE_MAX_SEGS):
        part = rows[i:i + WIRE_MAX_SEGS]
        desc = (ctypes.c_longlong * (8 * len(part)))(*itertools.chain.from_iterable(part))
        _raise_on(lib.qsdp_unpack_dequantize_wire(desc, len(part), _stream()),
                  "unpack_dequantize_wire")
        LAUNCHES["unpack_dequantize"] += 1
    return outs


def quantize_buckets(x: torch.Tensor, rand: torch.Tensor, levels: int = 255,
                     stochastic: bool = True):
    """K4: unpacked bucketed quantize of (nb, bucket) f32 rows, one u8 code
    per value, `levels` in 1..255; rand (nb, bucket) f32 thresholds (read
    only when `stochastic`).  Returns (codes u8 (nb, bucket), scale (nb, 1),
    zero (nb, 1))."""
    if _on_cpu(x, rand):
        return ref.quantize_buckets_ref(x, rand, levels, stochastic)
    nb, bucket = x.shape
    if not 1 <= levels <= 255:
        raise ValueError(f"levels must be in 1..255, got {levels}")
    _check("x", x, torch.float32, (nb, bucket))
    _check("rand", rand, torch.float32, (nb, bucket))
    codes = torch.empty((nb, bucket), dtype=torch.uint8, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    rc = build.load("quantize").qsdp_quantize_buckets(
        x.data_ptr(), rand.data_ptr(), codes.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), nb, bucket, levels, 1.0 / levels, int(stochastic), _stream())
    _raise_on(rc, "quantize_buckets")
    LAUNCHES["quantize_buckets"] += 1
    return codes, scale, zero


def dequantize_buckets(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """K5: unpacked decode, (nb, bucket) u8 codes + (nb, 1) scale/zero ->
    codes*scale + zero in `dtype` (f32 or bf16)."""
    if _on_cpu(codes, scale, zero):
        return ref.dequantize_buckets_ref(codes, scale, zero, dtype)
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"dequantize_buckets writes f32 or bf16, not {dtype}")
    nb, bucket = codes.shape
    _check("codes", codes, torch.uint8, (nb, bucket))
    _check("scale", scale, torch.float32, (nb, 1))
    _check("zero", zero, torch.float32, (nb, 1))
    out = torch.empty((nb, bucket), dtype=dtype, device=codes.device)
    rc = build.load("quantize").qsdp_dequantize_buckets(
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), nb, bucket, _stream())
    _raise_on(rc, "dequantize_buckets")
    LAUNCHES["dequantize_buckets"] += 1
    return out


_TICKETS: dict = {}


@functools.lru_cache(maxsize=None)
def _rowquant_workspace(lib, m: int, k: int, n: int, n_seg: int,
                        aligned: bool) -> tuple[int, int]:
    """(tickets, partial floats) K3 needs for these shapes; its tiling sees
    the codes pointer only through its 16-byte alignment."""
    n_tickets, n_partial = ctypes.c_int(), ctypes.c_longlong()
    lib.qsdp_rowquant_workspace(m, k, n, n_seg, 0 if aligned else 1, ctypes.byref(n_tickets),
                                ctypes.byref(n_partial))
    return n_tickets.value, n_partial.value


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """K3's per-tile tickets on `device`: zeroed once, and every launch
    leaves them zero (launches on one stream, as the wrappers make them)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


class RowQuantWeight(NamedTuple):
    """A (K, N) matmul weight kept in quantized code form: codes (K, N) u8,
    scale/zero (K, n_seg) f32, the affine constant over N-segments of
    N / n_seg columns (n_seg == N / bucket is the QSDP wire layout)."""

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor


def rowquant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor) -> torch.Tensor:
    """K3: y = x @ dequant(W) consuming u8 codes directly.  x (M, K) f32 or
    bf16; codes (K, N) u8; scale/zero (K, n_seg) f32, N % n_seg == 0.
    f32 accumulation, y in x.dtype."""
    if _on_cpu(x, codes, scale, zero):
        return ref.rowquant_matmul_ref(x, codes, scale, zero)
    m, k = x.shape
    n = codes.shape[1]
    n_seg = scale.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if min(m, k, n, n_seg) < 1 or n % n_seg:
        raise ValueError(f"bad rowquant shapes M={m} K={k} N={n} n_seg={n_seg}")
    _check("x", x, x.dtype, (m, k))
    _check("codes", codes, torch.uint8, (k, n))
    _check("scale", scale, torch.float32, (k, n_seg))
    _check("zero", zero, torch.float32, (k, n_seg))
    lib = build.load("dequant_matmul")
    n_tickets, n_partial = _rowquant_workspace(lib, m, k, n, n_seg, codes.data_ptr() % 16 == 0)
    partial = torch.empty(n_partial, dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.qsdp_rowquant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), n_seg, partial.data_ptr(), _tickets(x.device, n_tickets).data_ptr(),
        y.data_ptr(), m, k, n, _stream())
    _raise_on(rc, "rowquant_matmul")
    LAUNCHES["rowquant_matmul"] += 1
    return y
