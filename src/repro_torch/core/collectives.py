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

Every exchange takes a ``torch.distributed`` process group: the FSDP
exchanges the rank's data group, the sums and maxima of ``core/tp.py`` its
model group.  ``group=None`` is the one-rank path: the gather and the
all-to-all of a buffer are the buffer itself, as on the JAX package's
(1, 1) mesh, while encode and decode still run the quantize and dequantize
kernels.  A group of any size, one rank included, exchanges through
``torch.distributed`` (NCCL on the card, gloo on the CPU); a failed
exchange raises, with no fallback.  The receiving rank dequant-sums its P
rows in rank order, ``((r0 + r1) + r2) + ...``, the order of XLA's CPU
``jnp.sum(axis=0)``.

On a ("pod", "data", "model") mesh the FSDP axes are ("data", "pod"),
data-major: the rank at pod rank q and data rank d is FSDP index ``d·Q +
q``.  ``torch.distributed.new_group`` sorts its ranks and the global ranks
are pod-major (``launch/mesh.py``), so the flat FSDP group's own ranks run
``q·D + d``; :class:`OrderedGroup` is such a group with the group rank
that holds each FSDP index, and every exchange over it puts the rows in
FSDP order: the rows a gather delivers, the rows an all-to-all sends and
receives, the chunks a reduce-scatter hands out.  The hierarchical
(two-level) forms take the rank's pod group (its Q ranks of one (d, m))
and its inner group (the D ranks of one (q, m)) and exchange over the pod
first and the data axis second for a gather, the other way round for a
reduce-scatter, so only ``1/D`` of a gradient's bytes crosses the pod
boundary; their rows arrive in FSDP order as they are.

``COMM[op]`` counts the calls into ``torch.distributed`` by op and
``COMM_BYTES[op]`` the bytes each call brought in from the other ranks (the
analytic model's per-device bytes, :func:`gather_wire_bytes`);
``reset_comm()`` zeroes both.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Optional, Sequence

import torch

from ..kernels import ops
from . import prng
from .quant import (QuantConfig, Quantized, dequantize, fp_pack, fp_segment_bytes,
                    fp_unpack, kernel_dtype, quantize, quantized_shapes, wire_codes,
                    wire_pack, wire_segment_bytes)


COMM_OPS = ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")
COMM: Counter = Counter({k: 0 for k in COMM_OPS})
COMM_BYTES: Counter = Counter({k: 0 for k in COMM_OPS})


def reset_comm() -> None:
    for k in COMM_OPS:
        COMM[k] = COMM_BYTES[k] = 0


def _dist():
    import torch.distributed as dist
    return dist


def _op(new: str, old: str):
    """`new` where this torch has it, else `old`: the same collective under
    the name newer releases give it (``all_gather_single`` for
    ``all_gather_into_tensor``, ``reduce_scatter_single`` for
    ``reduce_scatter_tensor``)."""
    dist = _dist()
    return getattr(dist, new, None) or getattr(dist, old)


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(process_group(group))


@dataclasses.dataclass(frozen=True, eq=False)
class OrderedGroup:
    """A process group whose FSDP order is not its group ranks' order: FSDP
    index i is group rank ``order[i]`` (the flat (data, pod) group of a pod
    mesh, formed by ``launch/mesh.py``).  Every function here that takes a
    group takes one, and exchanges over it in FSDP order."""
    pg: object
    order: tuple

    def __post_init__(self):
        n = _dist().get_world_size(self.pg)
        if sorted(self.order) != list(range(n)):
            raise ValueError(f"{self.order} is not an order of the group's {n} ranks")


def ordered_group(pg, order: Sequence[int]):
    """`pg` with FSDP order `order` (group rank ``order[i]`` holds FSDP index
    i): the group itself where the order is its own."""
    order = tuple(int(r) for r in order)
    return pg if order == tuple(range(len(order))) else OrderedGroup(pg, order)


def process_group(group):
    """The ``torch.distributed`` process group of `group`."""
    return group.pg if isinstance(group, OrderedGroup) else group


def _order(group) -> Optional[tuple]:
    return group.order if isinstance(group, OrderedGroup) else None


def fsdp_index(group) -> int:
    """This rank's FSDP index in `group` (its group rank, unless `group` is
    an :class:`OrderedGroup`)."""
    order, r = _order(group), group_rank(group)
    return r if order is None else order.index(r)


def _rows_to_fsdp(rows: torch.Tensor, group) -> torch.Tensor:
    """Rows (or chunks on axis 0) by group rank -> by FSDP index."""
    order = _order(group)
    if order is None:
        return rows
    return rows.reshape(len(order), -1)[list(order)].reshape(rows.shape)


def _rows_to_group(rows: torch.Tensor, group) -> torch.Tensor:
    """Rows by FSDP index -> by group rank (the inverse of
    :func:`_rows_to_fsdp`)."""
    order = _order(group)
    if order is None:
        return rows
    inv = [order.index(r) for r in range(len(order))]
    return rows.reshape(len(order), -1)[inv].reshape(rows.shape)


def group_rank(group) -> int:
    return 0 if group is None else _dist().get_rank(process_group(group))


def _collective(fn):
    """Report each call of a collective entry point, with its arguments, to
    the active dispatch modes that take collectives (``collective``: the
    trace audit's graph, ``analysis/trace_audit.py``)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        for mode in ops.active_modes():
            if hasattr(mode, "collective"):
                mode.collective(fn.__name__, args)
        return fn(*args, **kwargs)
    return call


def _count(op: str, nbytes: int) -> None:
    COMM[op] += 1
    COMM_BYTES[op] += nbytes


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather_into_tensor: (n, ...) on each rank -> (P * n, ...), FSDP
    index i's block at rows i * n onwards (the group rank's, unless the
    group has an FSDP order)."""
    p = group_size(group)
    x = x.contiguous()
    out = x.new_empty((p * x.shape[0], *x.shape[1:]))
    _op("all_gather_single", "all_gather_into_tensor")(out, x, group=process_group(group))
    _count("all_gather", (p - 1) * x.numel() * x.element_size())
    return _rows_to_fsdp(out, group)


@_collective
def gather_axis(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's `x` laid end to end along `axis` (the checkpoint's
    gather of rest-layout blocks, axis -2)."""
    return _gather(x.movedim(axis, 0), group).movedim(0, axis)


@_collective
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, on every rank (a new tensor)."""
    return _all_reduce(x, group, "SUM")


@_collective
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the group, on every rank (a new
    tensor): the reference's ``pmax``."""
    return _all_reduce(x, group, "MAX")


@_collective
def ordered_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, on every rank (a new tensor), added in
    rank order ``((r0 + r1) + r2) + ...``, the order of the reference's psum
    on XLA's CPU, so every rank holds the same bits as the reference: one
    all-gather and P - 1 adds (a ring all-reduce adds in another order)."""
    return _sum_rows(list(_gather(x.detach()[None], group)))


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    dist = _dist()
    y = x.detach().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=process_group(group))
    _count("all_reduce", (group_size(group) - 1) * y.numel() * y.element_size())
    return y


def _sum_rows(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """The P received rows summed in rank order, one rounding per add."""
    return functools.reduce(torch.add, vals)


def require_one_rank(group, item: str = "A10e") -> None:
    """Refuse a group of more than one rank on a path that runs at one rank
    only; `item` names the ROADMAP item that brings it."""
    if group_size(group) > 1:
        raise NotImplementedError(
            f"this path runs on one rank: more than one is not ported yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# Per-tensor gathers
# ---------------------------------------------------------------------------


@_collective
def all_gather_fp(x: torch.Tensor, group=None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain all-gather, optionally through a narrower wire dtype."""
    wire = x if dtype is None or x.dtype == dtype else x.to(dtype)
    if group is not None:
        wire = _gather(wire, group)
    return wire.to(x.dtype)


@_collective
def all_gather_quantized(x: torch.Tensor, cfg: QuantConfig, key: prng.Key,
                         group=None, out_dtype=None) -> torch.Tensor:
    """Gather a flat (n_local,) shard into the full flat tensor, shipping
    quantized codes (3 collectives: codes, scale, zero) rounded under
    `key`; each rank's shard is decoded with its own bucket padding."""
    return _gather_levels(x, cfg, key, (group,), out_dtype)


@_collective
def all_gather_hierarchical(x: torch.Tensor, cfg: QuantConfig, key: prng.Key,
                            pod_group=None, inner_group=None,
                            out_dtype=None) -> torch.Tensor:
    """The two-level quantized gather (reference ``all_gather_hierarchical``):
    one quantize; codes, scale and zero gathered over the pod group, then
    over the inner group (6 collectives), which lays the Q·D shards out in
    FSDP order ``d·Q + q``; each shard decoded with its own padding."""
    return _gather_levels(x, cfg, key, (pod_group, inner_group), out_dtype)


def _gather_levels(x, cfg, key, groups, out_dtype):
    """Quantize `x`, gather codes, scale and zero over each of `groups` in
    turn (None: one rank) and decode every shard."""
    q = quantize(x, cfg, key)
    md = cfg.meta_torch_dtype
    n = x.shape[0]
    codes, scale, zero = q.codes, q.scale.to(md), q.zero.to(md)
    for group in groups:
        if group is not None:
            codes, scale, zero = _gather(codes, group), _gather(scale, group), _gather(zero, group)
    nb = q.codes.shape[0]
    vals = [dequantize(Quantized(codes[r * nb:(r + 1) * nb], scale[r * nb:(r + 1) * nb].float(),
                                 zero[r * nb:(r + 1) * nb].float(), (n,), n, cfg),
                       out_dtype or x.dtype)
            for r in range(codes.shape[0] // nb)]
    return vals[0] if len(vals) == 1 else torch.cat(vals)


@_collective
def reduce_scatter_fp(x: torch.Tensor, group=None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain reduce-scatter (sum), optionally through a narrower wire dtype:
    the sum runs in the wire dtype, in the order the backend chooses (the
    reference's ``psum_scatter``)."""
    wire = x if dtype is None or x.dtype == dtype else x.to(dtype)
    if group is not None:
        p = group_size(group)
        out = wire.new_empty((wire.shape[0] // p, *wire.shape[1:]))
        _op("reduce_scatter_single", "reduce_scatter_tensor")(
            out, _rows_to_group(wire, group).contiguous(), group=process_group(group))
        _count("reduce_scatter", (p - 1) * out.numel() * out.element_size())
        wire = out
    return wire.to(x.dtype)


@_collective
def _all_to_all_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Row i of (P, ...) goes to FSDP index i; returns the P rows received,
    row j from FSDP index j."""
    if group is None:
        return rows
    rows = _rows_to_group(rows, group).contiguous()
    out = torch.empty_like(rows)
    _dist().all_to_all_single(out, rows, group=process_group(group))
    _count("all_to_all", (rows.shape[0] - 1) * rows[0].numel() * rows.element_size())
    return _rows_to_fsdp(out, group)


@_collective
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
    return _sum_rows(deq)


@_collective
def reduce_scatter_hierarchical(g: torch.Tensor, cfg: QuantConfig, key: prng.Key,
                                pod_group=None, inner_group=None) -> torch.Tensor:
    """The two-level quantized reduce-scatter (reference
    ``reduce_scatter_hierarchical``): with ``k1, k2 = split(key)``, the full
    (n,) tensor reduce-scattered over the inner group under k1, then its
    (n/D,) partial sum over the pod group under k2; this rank keeps chunk
    ``d·Q + q`` of n/(Q·D) values.  Only the partial crosses the pods."""
    k1, k2 = prng.split(key)
    return reduce_scatter_quantized(reduce_scatter_quantized(g, cfg, k1, inner_group),
                                    cfg, k2, pod_group)


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


@_collective
def gather_wire(buf: torch.Tensor, group=None, pod_group=None) -> torch.Tensor:
    """All-gather a coalesced buffer: (B,) u8 -> (P*B,) u8 in FSDP order.
    With `pod_group`, `group` is the rank's inner group and the buffer is
    gathered over the pod group first, then over the inner group (the
    two-level form: the same rows as the flat gather)."""
    for grp in (pod_group, group):
        if grp is not None:
            buf = _gather(buf, grp)
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


def start_gather_coalesced(xs: Sequence[torch.Tensor], layout: WireLayout,
                           keys: Sequence[Optional[prng.Key]], group=None,
                           pod_group=None) -> torch.Tensor:
    """The start half of :func:`all_gather_coalesced`: encode -> 1
    all-gather (one a level with `pod_group`), the gathered (P *
    layout.nbytes,) u8 buffer; its finish is :func:`decode_gathered_wire`
    (the prefetch pipeline runs the two a layer apart)."""
    return gather_wire(encode_wire(xs, layout, keys), group, pod_group)


@_collective
def all_gather_coalesced(xs: Sequence[torch.Tensor], layout: WireLayout,
                         keys: Sequence[Optional[prng.Key]], out_dtypes: Sequence,
                         group=None, pod_group=None) -> list[torch.Tensor]:
    """One-launch layer gather: encode -> 1 all-gather (one a level with
    `pod_group`, `group` then the inner group) -> decode."""
    gbuf = start_gather_coalesced(xs, layout, keys, group, pod_group)
    return decode_gathered_wire(gbuf, layout, group_size(group) * group_size(pod_group),
                                out_dtypes)


def encode_rs_rows(gs: Sequence[torch.Tensor], layout: WireLayout,
                   keys: Sequence[Optional[prng.Key]], p: int) -> torch.Tensor:
    """The (P, layout.nbytes) u8 rows a rank sends in a coalesced
    reduce-scatter: row i holds every tensor's destination chunk i,
    quantized with ``split(key, P)[i]`` or bitcast to the fp segment's wire
    dtype."""
    rows = []
    for g, seg, key in zip(gs, layout.segments, keys):
        chunks = g.reshape(p, seg.n)
        if seg.cfg is None:
            rows.append(torch.stack([fp_pack(c, seg.fp_dtype) for c in chunks]))
        else:
            rows.append(torch.stack([wire_pack(quantize(c, seg.cfg, k))
                                     for c, k in zip(chunks, prng.split(key, p))]))
    return torch.cat(rows, dim=1)


def decode_rs_rows(rbuf: torch.Tensor, layout: WireLayout) -> list[torch.Tensor]:
    """The P rows a rank received (row j from rank j) -> each tensor's
    chunk, the rows decoded in f32 (one K2 launch for the quantized
    segments) and summed in rank order."""
    return [_sum_rows(vals)
            for vals in _decode_segments(rbuf, layout, [torch.float32] * len(layout.segments))]


@_collective
def reduce_scatter_coalesced(gs: Sequence[torch.Tensor], layout: WireLayout,
                             keys: Sequence[Optional[prng.Key]],
                             group=None) -> list[torch.Tensor]:
    """One-launch layer reduce-scatter (sum): every tensor's P destination
    chunks ride ONE (P, layout.nbytes) u8 all-to-all
    (:func:`encode_rs_rows`), and each rank dequant-sums its P rows in f32
    (:func:`decode_rs_rows`).  layout.segments[i].n == gs[i].numel() // P;
    keys[i] is None for an fp segment."""
    rows = encode_rs_rows(gs, layout, keys, group_size(group))
    return decode_rs_rows(_all_to_all_rows(rows, group), layout)


@_collective
def reduce_scatter_coalesced_hierarchical(
        gs: Sequence[torch.Tensor], inner_layout: WireLayout, pod_layout: WireLayout,
        keys: Sequence[Optional[prng.Key]], pod_group=None,
        inner_group=None) -> list[torch.Tensor]:
    """The two-level coalesced reduce-scatter (reference
    ``reduce_scatter_coalesced_hierarchical``): every tensor over the inner
    group in one all-to-all (`inner_layout`: D chunks of n/D), then the
    partial sums over the pod group in one more (`pod_layout`: Q chunks of
    n/(Q·D)); each tensor's key split as :func:`reduce_scatter_hierarchical`
    splits it.  An fp segment is packed to its wire dtype at both levels."""
    halves = [None if k is None else prng.split(k) for k in keys]
    part = reduce_scatter_coalesced(gs, inner_layout, [h and h[0] for h in halves],
                                    inner_group)
    return reduce_scatter_coalesced(part, pod_layout, [h and h[1] for h in halves], pod_group)


# ---------------------------------------------------------------------------
# Wire-byte accounting (the analytic communication model)
# ---------------------------------------------------------------------------


def gather_wire_bytes(n_local: int, p: int, cfg: Optional[QuantConfig],
                      fp_bytes: int = 4) -> int:
    """Per-device bytes moved by one all-gather of an n_local-element shard
    (ring: receive P - 1 shards).  The same for the per-tensor and the
    coalesced wire format: coalescing changes launches, not bytes."""
    if cfg is None:
        return (p - 1) * n_local * fp_bytes
    s = quantized_shapes(n_local, cfg)
    per_shard = s["codes"][0] * s["codes"][1] + 2 * cfg.meta_bytes * s["scale"][0]
    return (p - 1) * per_shard


def reduce_scatter_wire_bytes(n: int, p: int, cfg: Optional[QuantConfig],
                              fp_bytes: int = 4) -> int:
    """Per-device bytes moved by one reduce-scatter of an n-element tensor."""
    if cfg is None:
        return (p - 1) * (n // p) * fp_bytes
    s = quantized_shapes(n // p, cfg)
    per_chunk = s["codes"][0] * s["codes"][1] + 2 * cfg.meta_bytes * s["scale"][0]
    return (p - 1) * per_chunk
