"""Checked wrappers around the CUDA kernels, with one launch counter each.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a tensor
on the card launches the kernel (built from ``csrc/`` at first use) on
``torch.cuda.current_stream()``, or raises.  There is no fallback: a CUDA
tensor never takes the plain path.

A tensor on the meta device (the dry run's, ``launch/dryrun.py``) takes a
third path: the wrapper checks its arguments as on the card, returns empty
meta outputs of the kernel's shapes and dtypes, counts the launch and
reports the kernel's work (``kernels.cost``: bytes read and written,
operations) to every active dispatch mode that takes it (the roofline's
counter, ``roofline.counter.Counter.kernel``).  Nothing computes there.

``LAUNCHES[name]`` counts kernel launches and nothing else, so a run can
show which kernels its main path went through (``reset_launches()`` zeroes
the counts).  Beside K1-K5, ``random_bits`` draws the serving sampler's
``jax.random`` bits on the card (not a TPU kernel).  K2 has two entry
points, one tensor (``unpack_dequantize``) and a wire buffer's table of
segments (``unpack_dequantize_wire``); both count under
``"unpack_dequantize"``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from collections import Counter
from typing import NamedTuple, Sequence

import torch
from torch._C import _len_torch_dispatch_stack
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from . import build, cost, ref
from .ref import WireCodes

KERNELS = ("quantize_pack", "unpack_dequantize", "rowquant_matmul", "quantize_buckets",
           "dequantize_buckets", "random_bits")
LAUNCHES: Counter = Counter({k: 0 for k in KERNELS})

_MODE_IDS = {"nearest": 0, "stochastic": 1, "shift": 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)  # what K2 and K5 write


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True for CPU tensors (the plain versions), False for tensors on one
    CUDA device or all on the meta device; any mix raises."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs in ({"cuda"}, {"meta"}) and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device (or all on the "
                     f"meta device), got {[str(t.device) for t in ts]}")


def active_modes():
    """The active dispatch modes, innermost last; an empty tuple, without
    building the stack's list, when none is active (every launch asks)."""
    return _get_current_dispatch_mode_stack() if _len_torch_dispatch_stack() else ()


def _launch(name: str, dev: torch.device, work: cost.KernelCost, run, ins=(),
            outs=()) -> None:
    """Launch kernel `name` (``run()`` returns its CUDA error code) on a
    CUDA device; on the meta device report its work to the active modes
    that take it instead (``kernel``).  On either, hand its operand and
    result tensors (`ins`, `outs`) to the active modes that take them
    (``launched``: the trace audit's graph).  Counts the launch."""
    modes = active_modes()
    if dev.type == "meta":
        for mode in modes:
            if hasattr(mode, "kernel"):
                mode.kernel(name, work)
    else:
        _raise_on(run(), name)
    for mode in modes:
        if hasattr(mode, "launched"):
            mode.launched(name, ins, outs)
    LAUNCHES[name] += 1


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
                  mode: str = "nearest", rand_bits: int = 32, out=None):
    """K1: fused bucketed quantize + bit-pack of (nb, bucket) f32 rows,
    drawing its rounding randomness from the PRNG `key` (a pair of u32
    words; None for "nearest") as ``ref.draw_rand`` does.  Returns (codes u8
    (nb, bucket*bits/8 or bucket), scale (nb, 1), zero (nb, 1)): new
    tensors, or `out`, three such tensors it writes into (views into a wire
    buffer; codes, scale and zero 4-byte aligned)."""
    if _on_cpu(x, *(out or ())):
        res = ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)
        if out is None:
            return res
        for o, r in zip(out, res, strict=True):
            _check("out", o, r.dtype, r.shape)
            o.copy_(r)
        return out
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
    if out is None:
        codes = torch.empty((nb, bucket // k), dtype=torch.uint8, device=x.device)
        scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
        zero = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    else:
        codes, scale, zero = out
        _check("codes", codes, torch.uint8, (nb, bucket // k))
        _check("scale", scale, torch.float32, (nb, 1))
        _check("zero", zero, torch.float32, (nb, 1))
        if any(t.data_ptr() % 4 for t in out):
            raise ValueError("quantize_pack: out codes, scale and zero must be 4-byte aligned")
    _launch("quantize_pack", x.device, cost.quantize_pack(nb, bucket, bits, mode),
            lambda: build.load("quantize").qsdp_quantize_pack(
                x.data_ptr(), k0, k1, rand_bits, codes.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), nb, bucket, bits, levels, 1.0 / levels, _MODE_IDS[mode],
                _stream()), (x,), (codes, scale, zero))
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
    _launch("unpack_dequantize", codes.device,
            cost.unpack_dequantize(nb, bucket, bits, dtype.itemsize),
            lambda: build.load("quantize").qsdp_unpack_dequantize(
                codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
                int(dtype == torch.bfloat16), nb, bucket, bits, _stream()),
            (codes, scale, zero), (out,))
    return out


WIRE_MAX_SEGS = 64  # quantize.cu: kMaxSegs, the segments one launch's table holds


def unpack_dequantize_wire(buf, segments: Sequence[WireCodes],
                           out_dtypes: Sequence) -> list[torch.Tensor]:
    """K2 over a wire buffer: every quantized segment of the 1-D u8 `buf`
    (``ref.WireCodes``: codes, scale and zero read in place) decoded into a
    new (nb, bucket) tensor in its out dtype (f32 or bf16).  `buf` may also
    be a sequence of 1-D u8 buffers, one per segment, each segment's offsets
    into its own.  One launch per WIRE_MAX_SEGS segments with nb > 0: one
    launch for up to 64."""
    if len(segments) != len(out_dtypes):
        raise ValueError(f"{len(segments)} segments, {len(out_dtypes)} out dtypes")
    bufs = [buf] * len(segments) if isinstance(buf, torch.Tensor) else list(buf)
    if len(bufs) != len(segments):
        raise ValueError(f"{len(segments)} segments, {len(bufs)} buffers")
    if _on_cpu(*bufs):
        return ref.unpack_dequantize_wire_ref(buf, segments, out_dtypes)
    for b in bufs:
        _check("buf", b, torch.uint8, (b.numel(),))
    outs, rows = [], []
    for buf, seg, dt in zip(bufs, segments, out_dtypes):
        base = buf.data_ptr()
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
            rows.append(((base + seg.codes, base + seg.scale, base + seg.zero, out.data_ptr(),
                          seg.nb, seg.bucket, seg.bits, flags), seg, dt.itemsize, buf, out))
    lib = build.load("quantize") if rows and bufs[0].device.type == "cuda" else None
    for i in range(0, len(rows), WIRE_MAX_SEGS):
        part = rows[i:i + WIRE_MAX_SEGS]
        desc = (ctypes.c_longlong * (8 * len(part)))(*itertools.chain.from_iterable(
            r[0] for r in part))
        _launch("unpack_dequantize", bufs[0].device,
                cost.unpack_dequantize_wire([r[1] for r in part], [r[2] for r in part]),
                lambda: lib.qsdp_unpack_dequantize_wire(desc, len(part), _stream()),
                [r[3] for r in part], [r[4] for r in part])
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
    _launch("quantize_buckets", x.device, cost.quantize_buckets(nb, bucket, stochastic),
            lambda: build.load("quantize").qsdp_quantize_buckets(
                x.data_ptr(), rand.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), nb, bucket, levels, 1.0 / levels, int(stochastic), _stream()),
            (x, rand), (codes, scale, zero))
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
    _launch("dequantize_buckets", codes.device,
            cost.dequantize_buckets(nb, bucket, dtype.itemsize),
            lambda: build.load("quantize").qsdp_dequantize_buckets(
                codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
                int(dtype == torch.bfloat16), nb, bucket, _stream()),
            (codes, scale, zero), (out,))
    return out


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The sampler's draw: (R, 2) PRNG keys -> (R, n) bits, row r equal to
    ``jax.random.bits(key_r, (n,), uint32)`` (threefry-2x32 at counters 0..n-1,
    partitionable mode).  Keys and bits are u32 bit patterns in int32
    tensors.  One launch for all R rows."""
    if _on_cpu(keys):
        return ref.random_bits_ref(keys, n)
    r = keys.shape[0] if keys.dim() == 2 else -1
    if not 1 <= r <= 65535 or not 1 <= n < 1 << 32:
        raise ValueError(f"random_bits: {tuple(keys.shape)} keys, n={n}")
    _check("keys", keys, torch.int32, (r, 2))
    out = torch.empty((r, n), dtype=torch.int32, device=keys.device)
    _launch("random_bits", keys.device, cost.random_bits(r, n),
            lambda: build.load("quantize").qsdp_random_bits(keys.data_ptr(), r, n,
                                                            out.data_ptr(), _stream()),
            (keys,), (out,))
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
    work = cost.rowquant_matmul(m, k, n, n_seg, x.dtype.itemsize)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        _launch("rowquant_matmul", x.device, work, None, (x, codes, scale, zero), (y,))
        return y
    lib = build.load("dequant_matmul")
    n_tickets, n_partial = _rowquant_workspace(lib, m, k, n, n_seg, codes.data_ptr() % 16 == 0)
    partial = torch.empty(n_partial, dtype=torch.float32, device=x.device)
    _launch("rowquant_matmul", x.device, work, lambda: lib.qsdp_rowquant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), n_seg, partial.data_ptr(), _tickets(x.device, n_tickets).data_ptr(),
        y.data_ptr(), m, k, n, _stream()), (x, codes, scale, zero), (y,))
    return y
