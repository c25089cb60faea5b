"""Quantized collectives of QSDP (paper Section 5).

* **Quantized all-gather** ships packed u8 codes + per-bucket (scale, zero)
  metadata; the receiver dequantizes after the gather.
* **Quantized reduce-scatter** (sum): each of the P destination chunks is
  quantized with its own key (``split(key, P)``, stochastic rounding for
  gradients), the chunks ride one all-to-all, and each rank dequantizes and
  sums what it received.
* **Coalesced wire format**: every tensor of a layer — packed codes and
  metadata for quantized tensors, bitcast fp payloads for filtered ones —
  is serialized into ONE contiguous u8 buffer (``quant.wire_pack``) and
  gathered (or all-to-all'd) with one collective; :class:`WireLayout`
  describes the buffer.

The port runs on one rank: the gather and the all-to-all of a buffer are
the buffer itself, as on the JAX package's (1, 1) mesh, while encode and
decode still run the quantize and dequantize kernels.  A process group of
more than one rank raises ``NotImplementedError`` (ROADMAP A3b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..kernels import ops
from . import prng
from .quant import (QuantConfig, Quantized, dequantize, fp_pack, fp_segment_bytes,
                    fp_unpack, kernel_dtype, quantize, wire_codes, wire_pack,
                    wire_segment_bytes)


def group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def require_one_rank(group) -> None:
    if group_size(group) > 1:
        raise NotImplementedError(
            "multi-rank QSDP collectives are not ported yet (ROADMAP A3b): "
            "the port runs on one rank")


# ---------------------------------------------------------------------------
# Per-tensor gathers
# ---------------------------------------------------------------------------


def all_gather_fp(x: torch.Tensor, group=None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain all-gather, optionally through a narrower wire dtype."""
    require_one_rank(group)
    if dtype is not None and x.dtype != dtype:
        return x.to(dtype).to(x.dtype)
    return x


def all_gather_quantized(x: torch.Tensor, cfg: QuantConfig, key: prng.Key,
                         group=None, out_dtype=None) -> torch.Tensor:
    """Gather a flat (n_local,) shard into the full flat tensor, shipping
    quantized codes (3 collectives: codes, scale, zero) rounded under
    `key`."""
    q = quantize(x, cfg, key)
    require_one_rank(group)
    md = cfg.meta_torch_dtype
    wire = Quantized(q.codes, q.scale.to(md).to(torch.float32),
                     q.zero.to(md).to(torch.float32), (x.shape[0],), x.shape[0], cfg)
    return dequantize(wire, out_dtype or x.dtype)


def reduce_scatter_fp(x: torch.Tensor, group=None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain reduce-scatter (sum), optionally through a narrower wire dtype."""
    require_one_rank(group)
    if dtype is not None and x.dtype != dtype:
        return x.to(dtype).to(x.dtype)
    return x


def _all_to_all_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Row i of (P, ...) goes to rank i; returns the P rows received."""
    require_one_rank(group)
    return rows


def reduce_scatter_quantized(g: torch.Tensor, cfg: QuantConfig, key: prng.Key,
                             group=None) -> torch.Tensor:
    """Sum the flat (n,) `g` over the group, leaving this rank its (n/P,)
    chunk in f32: chunk i is quantized with ``split(key, P)[i]`` (so even at
    P = 1 the randomness comes from the split key), shipped, decoded and
    summed."""
    p = group_size(group)
    chunks = g.reshape(p, -1)
    n = chunks.shape[1]
    qs = [quantize(c, cfg, k) for c, k in zip(chunks, prng.split(key, p))]
    md = cfg.meta_torch_dtype
    codes = _all_to_all_rows(torch.stack([q.codes for q in qs]), group)
    scale = _all_to_all_rows(torch.stack([q.scale.to(md) for q in qs]), group)
    zero = _all_to_all_rows(torch.stack([q.zero.to(md) for q in qs]), group)
    deq = [dequantize(Quantized(c, s.float(), z.float(), (n,), n, cfg))
           for c, s, z in zip(codes, scale, zero)]
    return deq[0] if p == 1 else torch.stack(deq).sum(0)


# ---------------------------------------------------------------------------
# Coalesced wire collectives: one launch per layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireSegment:
    """One tensor inside a coalesced buffer: `n` elements per rank, quantized
    with `cfg`, or a raw fp payload in `fp_dtype` when cfg is None."""

    n: int
    cfg: Optional[QuantConfig]
    fp_dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        if self.cfg is None:
            return fp_segment_bytes(self.n, self.fp_dtype)
        return wire_segment_bytes(self.n, self.cfg)


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Ordered segments of a coalesced buffer."""

    segments: tuple[WireSegment, ...]

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.segments)

    def offsets(self) -> list[int]:
        out, off = [], 0
        for s in self.segments:
            out.append(off)
            off += s.nbytes
        return out


def encode_wire(xs: Sequence[torch.Tensor], layout: WireLayout,
                keys: Sequence[Optional[prng.Key]]) -> torch.Tensor:
    """Quantize + serialize every tensor into one (layout.nbytes,) u8
    buffer.  `keys`: one per segment, each quantized tensor's own key (None
    for an fp segment), so the bytes equal what per-tensor collectives
    would ship."""
    parts = []
    for x, seg, key in zip(xs, layout.segments, keys):
        flat = x.reshape(-1)
        if seg.cfg is None:
            parts.append(fp_pack(flat, seg.fp_dtype))
        else:
            parts.append(wire_pack(quantize(flat, seg.cfg, key)))
    return torch.cat(parts)


def gather_wire(buf: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather a coalesced buffer: (B,) u8 -> (P*B,) u8 in shard order."""
    require_one_rank(group)
    return buf


def wire_table(layout: WireLayout, p: int,
               out_dtypes: Sequence) -> tuple[list, list[torch.dtype]]:
    """K2's segment table for P rows of `layout` laid end to end: one
    ``ops.WireCodes`` per quantized (segment, row), segment-major, and the
    dtype K2 writes for each (the segment's out dtype where K2 writes it,
    else f32)."""
    table, dts = [], []
    for seg, off, dt in zip(layout.segments, layout.offsets(), out_dtypes):
        if seg.cfg is not None:
            table += [wire_codes(r * layout.nbytes + off, seg.n, seg.cfg) for r in range(p)]
            dts += [kernel_dtype(dt)] * p
    return table, dts


def _decode_segments(rows: torch.Tensor, layout: WireLayout,
                     out_dtypes: Sequence) -> list[list[torch.Tensor]]:
    """(P, layout.nbytes) u8 rows -> per segment, the P (seg.n,) decodes: a
    quantized segment's from ONE K2 launch over the whole buffer (scale and
    zero read in place) in the dtype :func:`wire_table` gives it, an fp
    segment's in f32 (shared by the gather decode and the reduce-scatter
    dequant-sum)."""
    p = rows.shape[0]
    table, dts = wire_table(layout, p, out_dtypes)
    decoded = iter(ops.unpack_dequantize_wire(rows.reshape(-1), table, dts) if table else ())
    return [[fp_unpack(row[off:off + seg.nbytes], seg.n, seg.fp_dtype) for row in rows]
            if seg.cfg is None else [next(decoded).reshape(-1)[:seg.n] for _ in range(p)]
            for seg, off in zip(layout.segments, layout.offsets())]


def decode_gathered_wire(gbuf: torch.Tensor, layout: WireLayout, p: int,
                         out_dtypes: Sequence) -> list[torch.Tensor]:
    """Decode a gathered (P * layout.nbytes,) buffer into full flat tensors
    [(P * seg.n,) in out_dtype], each shard decoded with its own padding; the
    quantized segments in one K2 launch that writes their out dtypes."""
    rows = gbuf.reshape(p, layout.nbytes)
    return [(vals[0] if p == 1 else torch.cat(vals)).to(dt)
            for vals, dt in zip(_decode_segments(rows, layout, out_dtypes), out_dtypes)]


def all_gather_coalesced(xs: Sequence[torch.Tensor], layout: WireLayout,
                         keys: Sequence[Optional[prng.Key]], out_dtypes: Sequence,
                         group=None) -> list[torch.Tensor]:
    """One-launch layer gather: encode -> 1 all-gather -> decode."""
    gbuf = gather_wire(encode_wire(xs, layout, keys), group)
    return decode_gathered_wire(gbuf, layout, group_size(group), out_dtypes)


def reduce_scatter_coalesced(gs: Sequence[torch.Tensor], layout: WireLayout,
                             keys: Sequence[Optional[prng.Key]],
                             group=None) -> list[torch.Tensor]:
    """One-launch layer reduce-scatter (sum): each tensor's P destination
    chunks are quantized (chunk i with ``split(key, P)[i]``) or bitcast to
    the fp segment's wire dtype, all tensors' rows ride ONE (P,
    layout.nbytes) u8 all-to-all, and each rank dequant-sums its P rows in
    f32.  layout.segments[i].n == gs[i].numel() // P; keys[i] is None for
    an fp segment."""
    p = group_size(group)
    rows = []
    for g, seg, key in zip(gs, layout.segments, keys):
        chunks = g.reshape(p, seg.n)
        if seg.cfg is None:
            rows.append(torch.stack([fp_pack(c, seg.fp_dtype) for c in chunks]))
        else:
            rows.append(torch.stack([wire_pack(quantize(c, seg.cfg, k))
                                     for c, k in zip(chunks, prng.split(key, p))]))
    rbuf = _all_to_all_rows(torch.cat(rows, dim=1), group)
    return [vals[0] if p == 1 else torch.stack(vals).sum(0)
            for vals in _decode_segments(rbuf, layout, [torch.float32] * len(gs))]
