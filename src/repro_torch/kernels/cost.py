"""The work of each kernel of ``kernels.ops``: the bytes it must move (each
input byte read once, each output byte written once) and the operations it
does, from its shapes alone.

``ops`` reports these on the meta device, where nothing runs (the dry run's
counter, ``roofline.counter``, charges a kernel by them), and
``chip_smoke.py`` takes its bounds from them: the least time the card could
take is the larger of ``nbytes`` over the memory rate and the operations
over their peak rates.  ``flops`` are f32 operations on the CUDA cores;
``int_ops`` are 32-bit integer operations, on their own lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

# 32-bit integer operations of one threefry-2x32 draw: 20 rounds of add,
# rotate and xor, 5 key injections of 2 adds, plus the counter, the final xor
# and the mantissa fill
DRAW_INT_OPS = 75


class KernelCost(NamedTuple):
    read: int
    written: int
    flops: int = 0
    int_ops: int = 0

    @property
    def nbytes(self) -> int:
        return self.read + self.written

    def __add__(self, other: "KernelCost") -> "KernelCost":
        return KernelCost(*(a + b for a, b in zip(self, other)))


def _codes_bytes(nb: int, bucket: int, bits: int) -> int:
    return nb * (bucket // (8 // bits) if 8 % bits == 0 else bucket)


def quantize_pack(nb: int, bucket: int, bits: int, mode: str) -> KernelCost:
    """K1: (nb, bucket) f32 values in; packed codes and per-bucket f32 scale
    and zero out; a min, max and affine round per value (5 flops), and in
    stochastic mode one threefry draw per value."""
    n = nb * bucket
    return KernelCost(4 * n, _codes_bytes(nb, bucket, bits) + 8 * nb, 5 * n,
                      DRAW_INT_OPS * n if mode == "stochastic" else 0)


def unpack_dequantize(nb: int, bucket: int, bits: int, out_itemsize: int,
                      meta_bytes: int = 4) -> KernelCost:
    """K2 over one segment: packed codes and scale/zero (`meta_bytes` each)
    in, (nb, bucket) values of `out_itemsize` out; one fused multiply-add
    per value."""
    n = nb * bucket
    return KernelCost(_codes_bytes(nb, bucket, bits) + 2 * meta_bytes * nb,
                      out_itemsize * n, 2 * n)


def unpack_dequantize_wire(segments: Sequence, out_itemsizes: Sequence[int]) -> KernelCost:
    """K2 over a table of ``ref.WireCodes`` segments: the sum of theirs."""
    total = KernelCost(0, 0)
    for seg, size in zip(segments, out_itemsizes):
        total += unpack_dequantize(seg.nb, seg.bucket, seg.bits, size,
                                   seg.meta_dtype.itemsize)
    return total


def rowquant_matmul(m: int, k: int, n: int, n_seg: int, x_itemsize: int) -> KernelCost:
    """K3: x (M, K), u8 codes (K, N) and f32 scale/zero (K, n_seg) in, y (M,
    N) out; 2·M·K·N for the product over the codes and 4·M·K·n_seg for the
    affine terms (x·scale, x·zero summed per segment), f32 on the CUDA
    cores."""
    return KernelCost(x_itemsize * m * k + k * n + 8 * k * n_seg, x_itemsize * m * n,
                      2 * m * k * n + 4 * m * k * n_seg)


def quantize_buckets(nb: int, bucket: int, stochastic: bool) -> KernelCost:
    """K4: f32 values (and f32 thresholds when stochastic) in; one u8 code
    per value and f32 scale/zero out; 6 flops a value."""
    n = nb * bucket
    return KernelCost(4 * n * (2 if stochastic else 1), n + 8 * nb, 6 * n)


def dequantize_buckets(nb: int, bucket: int, out_itemsize: int) -> KernelCost:
    """K5: one u8 code per value and f32 scale/zero in, values out."""
    n = nb * bucket
    return KernelCost(n + 8 * nb, out_itemsize * n, 2 * n)


def random_bits(rows: int, n: int) -> KernelCost:
    """The sampler's draw: (rows, 2) int32 keys in, (rows, n) int32 bits
    out, one threefry draw per value."""
    return KernelCost(8 * rows, 4 * rows * n, 0, DRAW_INT_OPS * rows * n)
