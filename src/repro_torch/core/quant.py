"""Quantizers of QSDP (Markov et al., ICML 2023) in PyTorch.

Lattice quantizers (``q_nearest``, ``q_shift``, ``q_coinflip``): the exact
operators of the paper's analysis (Definitions 1 and 12) on a fixed grid
``delta * Z^n (+ r 1)``, no scaling or clipping, as the JAX package's
``core/quant.py:46-75``; ``core.theory`` iterates them.  Their draws come
from ``core.prng`` in x's dtype (f64 under the theory runs, as the
reference draws under x64), so they run on any device; a row of keys
(``prng.key_rows``) quantizes each row of x under its own key.

Wire quantizers (Section 5), the bucketed min-max scheme: a tensor is
flattened, zero-padded and split into equal buckets (default 1024); each
bucket is scaled to ``[0, levels]`` with its own (scale, zero) pair and
rounded with one of three modes — "shift" (Def. 1, weights), "stochastic"
(Def. 12, gradients) or "nearest".
A :class:`Quantized` holds packed u8 codes: exactly what QSDP puts on the
wire, byte for byte the same as the JAX package's ``core.quant``.  A
:class:`QuantizedParam` is a train-state leaf kept in that wire form.

Randomness comes from a PRNG key and is the threefry stream the JAX
package draws from it, so shift- and stochastic-mode bytes are comparable
bit for bit.  The quantize and dequantize work runs in ``kernels.ops``: the
CUDA kernels for tensors on the card (K1 computes the threefry bits in its
own threads), the plain versions on the CPU (which draw them with
``core.prng``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels import ops, ref
from ..kernels.ref import codes_per_byte, pack_codes, unpack_codes, view_bytes  # noqa: F401
from . import prng

_MODES = ("shift", "stochastic", "nearest")
_META_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}


# ---------------------------------------------------------------------------
# Lattice quantizers (paper Definitions 1 and 12)
# ---------------------------------------------------------------------------


def _draw_shape(key: prng.Key, x: torch.Tensor) -> tuple:
    """The shape one key draws for x: all of x, or one row of it when
    `key` is a row of keys (one per row of x)."""
    return tuple(x.shape[1:]) if isinstance(key[0], torch.Tensor) else tuple(x.shape)


def q_nearest(x: torch.Tensor, delta) -> torch.Tensor:
    """Deterministic round-to-nearest (half to even) on ``delta * Z``: the
    naive scheme the paper shows to break convergence."""
    return delta * torch.round(x / delta)


def q_shift(x: torch.Tensor, delta, key: prng.Key) -> torch.Tensor:
    """Quantization by random shift (Definition 1): one shift ``r ~
    Unif[-delta/2, delta/2)`` shared by every coordinate (of a row), each
    rounded to the nearest point of ``delta * Z + r``.  XLA fuses the last
    multiply-add; so does this (``ref.fma_f32`` / ``ref.fma_f64``)."""
    r = prng.uniform(key, (), x.device, -0.5, 0.5, x.dtype) * delta
    r = r.reshape(r.shape + (1,) * (x.dim() - r.dim()))
    k = torch.round((x - r) / delta)
    fma = ref.fma_f32 if x.dtype == torch.float32 else ref.fma_f64
    return fma(torch.full_like(k, delta), k, r.expand_as(k))


def q_coinflip(x: torch.Tensor, delta, key: prng.Key) -> torch.Tensor:
    """Quantization by coin flip (Definition 12): per-coordinate
    stochastic rounding onto ``delta * Z``, unbiased."""
    lo = torch.floor(x / delta)
    frac = x / delta - lo
    up = prng.uniform(key, _draw_shape(key, x), x.device, dtype=x.dtype) < frac
    return delta * (lo + up.to(x.dtype))


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the wire quantizer.

    bits:        code width (1..8); 8 % bits == 0 widths are bit-packed, the
                 others take one byte per code.
    bucket_size: independent scaling granularity (paper default 1024).
    mode:        "shift" | "stochastic" | "nearest".
    rand_bits:   stochastic thresholds as f32 uniforms (32) or u16 raw bits
                 compared against frac * 65536 (16).
    meta_dtype:  on-wire dtype of scale/zero: "float32" or "bfloat16".
    """

    bits: int = 8
    bucket_size: int = 1024
    mode: str = "shift"
    rand_bits: int = 32
    meta_dtype: str = "float32"

    def __post_init__(self):
        if not 1 <= self.bits <= 8:
            raise ValueError(f"bits must be in 1..8, got {self.bits}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.rand_bits not in (16, 32):
            raise ValueError(f"rand_bits must be 16 or 32, got {self.rand_bits}")
        if self.meta_dtype not in _META_DTYPES:
            raise ValueError(f"meta_dtype must be float32 or bfloat16, got "
                             f"{self.meta_dtype!r}")

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    @property
    def codes_per_byte(self) -> int:
        return codes_per_byte(self.bits)

    @property
    def meta_bytes(self) -> int:
        return 2 if self.meta_dtype == "bfloat16" else 4

    @property
    def meta_torch_dtype(self) -> torch.dtype:
        return _META_DTYPES[self.meta_dtype]


@dataclasses.dataclass
class Quantized:
    """A quantized tensor as transmitted by QSDP.

    codes: u8 (n_buckets, bucket_size // codes_per_byte)
    scale: f32 (n_buckets,);  zero: f32 (n_buckets,)
    shape / size: original shape and element count (before padding)
    """

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    shape: tuple
    size: int
    cfg: QuantConfig

    @property
    def wire_bytes(self) -> int:
        mb = self.cfg.meta_bytes
        return self.codes.numel() + mb * (self.scale.numel() + self.zero.numel())


def _to_buckets(x: torch.Tensor, bucket_size: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1).to(torch.float32)
    size = flat.numel()
    pad = (-size) % bucket_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, bucket_size).contiguous(), size


def quantize(x: torch.Tensor, cfg: QuantConfig, key: Optional[prng.Key] = None) -> Quantized:
    """Bucketed min-max quantization with packed codes (K1), its rounding
    randomness drawn from `key` as the JAX package draws it
    (``core/quant.py:241-254``): on the card inside the kernel, on the CPU
    by the threefry twin."""
    if cfg.mode in ("shift", "stochastic") and key is None:
        raise ValueError(f"mode={cfg.mode!r} requires a PRNG key")
    buckets, size = _to_buckets(x, cfg.bucket_size)
    codes, scale, zero = ops.quantize_pack(buckets, key, cfg.levels, cfg.bits, cfg.mode,
                                           cfg.rand_bits)
    return Quantized(codes=codes, scale=scale[:, 0], zero=zero[:, 0],
                     shape=tuple(x.shape), size=size, cfg=cfg)


def kernel_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype K2 decodes into for a consumer that reads `dtype`: that
    dtype where K2 writes it (f32, bf16), else f32 (then cast)."""
    return dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32


def dequantize(q: Quantized, dtype=torch.float32) -> torch.Tensor:
    """Affine decode back to the original shape in `dtype` (K2)."""
    x = ops.unpack_dequantize(q.codes, q.scale[:, None], q.zero[:, None],
                              q.cfg.bits, kernel_dtype(dtype))
    return x.reshape(-1)[: q.size].reshape(q.shape).to(dtype)


def quantize_dequantize(x: torch.Tensor, cfg: QuantConfig,
                        key: Optional[prng.Key] = None) -> torch.Tensor:
    """Fake-quant: quantize then decode to x's dtype."""
    return dequantize(quantize(x, cfg, key), x.dtype)


# ---------------------------------------------------------------------------
# Byte formulas and the serialized wire segment
#
#     [ codes : nb * bucket/cpb bytes | scale : nb * mb | zero : nb * mb ]
#
# with mb = cfg.meta_bytes; a raw fp segment is the bitcast of the tensor in
# its wire dtype.  Same layout as the JAX package (``core/quant.py:365``).
# ---------------------------------------------------------------------------


def quantized_shapes(n: int, cfg: QuantConfig) -> dict:
    nb = -(-n // cfg.bucket_size)
    return dict(codes=(nb, cfg.bucket_size // cfg.codes_per_byte),
                scale=(nb,), zero=(nb,))


def wire_codes(offset: int, n: int, cfg: QuantConfig) -> ops.WireCodes:
    """Where the parts of an n-element tensor's wire segment that starts at
    byte `offset` of a buffer lie: K2's table entry for it."""
    s = quantized_shapes(n, cfg)
    nb = s["scale"][0]
    scale = offset + math.prod(s["codes"])
    return ops.WireCodes(offset, scale, scale + nb * cfg.meta_bytes, nb, cfg.bucket_size,
                         cfg.bits, cfg.meta_torch_dtype)


def wire_segment_bytes(n: int, cfg: QuantConfig) -> int:
    """Byte length of the wire segment of an n-element tensor."""
    w = wire_codes(0, n, cfg)
    return w.zero + w.nb * cfg.meta_bytes


def fp_segment_bytes(n: int, dtype_str: str) -> int:
    return n * _FP_DTYPES[dtype_str].itemsize


def _f2b(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8).reshape(-1)


def wire_pack(q: Quantized) -> torch.Tensor:
    md = q.cfg.meta_torch_dtype
    return torch.cat([q.codes.reshape(-1), _f2b(q.scale.to(md)), _f2b(q.zero.to(md))])


def wire_unpack(buf: torch.Tensor, n: int, cfg: QuantConfig,
                shape: Optional[tuple] = None) -> Quantized:
    w = wire_codes(0, n, cfg)
    md = cfg.meta_torch_dtype
    codes = buf[:w.scale].reshape(quantized_shapes(n, cfg)["codes"])
    scale = view_bytes(buf[w.scale:w.zero], md).to(torch.float32)
    zero = view_bytes(buf[w.zero:w.zero + w.nb * cfg.meta_bytes], md).to(torch.float32)
    return Quantized(codes, scale, zero, shape or (n,), n, cfg)


def fp_pack(x: torch.Tensor, dtype_str: str) -> torch.Tensor:
    return _f2b(x.reshape(-1).to(_FP_DTYPES[dtype_str]))


def fp_unpack(buf: torch.Tensor, n: int, dtype_str: str) -> torch.Tensor:
    return view_bytes(buf[: n * _FP_DTYPES[dtype_str].itemsize],
                _FP_DTYPES[dtype_str]).to(torch.float32)


# ---------------------------------------------------------------------------
# QuantizedParam: a rest-layout train-state leaf kept as packed wire codes
# (the paper's "maintain only quantized weights", Theorem 2).  A leaf of
# shape (stack?, MODEL, FSDP, n_local) holds, per (model, fsdp) cell, the
# wire_pack serialization of that cell flattened in (stack, n_local) order
# -- the array the in-step master quantization feeds to quantize -- so its
# decode is bit-identical to the QDQ master value.  Same layout as the JAX
# package (``core/quant.py:465-582``).
#
#     wire : u8 (MODEL, FSDP, nbytes),  nbytes = wire_segment_bytes(n, cfg)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedParam:
    """A parameter (or optimizer-moment) leaf stored as packed wire codes.

    wire:       u8 (*lead, nbytes), one wire_pack segment per lead cell
    cell_shape: decoded shape per cell, (n_local,) or (stack, n_local)
    cfg:        the QuantConfig the codes were produced with
    """

    wire: torch.Tensor
    cell_shape: tuple
    cfg: QuantConfig

    @property
    def n(self) -> int:
        """Decoded f32 elements per cell."""
        return math.prod(self.cell_shape)

    @property
    def stacked(self) -> bool:
        return len(self.cell_shape) == 2


def qparam_encode(x: torch.Tensor, cfg: QuantConfig,
                  key: Optional[prng.Key] = None) -> QuantizedParam:
    """Rest-layout f32 leaf (stack?, A, B, n_local) -> QuantizedParam; every
    (A, B) cell is flattened in (stack, n_local) order and quantized with the
    same `key`, as each device of the reference does with its own view."""
    if x.dim() == 4:
        cell_shape = (x.shape[0], x.shape[-1])
        xc = torch.movedim(x, 0, 2)  # (A, B, stack, n_local)
    elif x.dim() == 3:
        cell_shape = (x.shape[-1],)
        xc = x
    else:
        raise ValueError(f"rest-layout leaf must be rank 3 or 4, got {tuple(x.shape)}")
    lead = tuple(xc.shape[:2])
    cells = xc.reshape(lead[0] * lead[1], math.prod(cell_shape))
    wire = torch.stack([wire_pack(quantize(c, cfg, key)) for c in cells])
    return QuantizedParam(wire.reshape(*lead, -1), cell_shape, cfg)


def qparam_decode(qp: QuantizedParam, dtype=torch.float32) -> torch.Tensor:
    """QuantizedParam -> rest-layout dense leaf (stack?, A, B, n_local), the
    exact inverse of :func:`qparam_encode`'s layout (deterministic); every
    cell's segment decoded by one K2 call over the whole wire."""
    lead = tuple(qp.wire.shape[:-1])
    cells, nbytes = math.prod(lead), qp.wire.shape[-1]
    table = [wire_codes(i * nbytes, qp.n, qp.cfg) for i in range(cells)]
    outs = ops.unpack_dequantize_wire(qp.wire.reshape(-1), table, [kernel_dtype(dtype)] * cells)
    out = torch.stack([o.reshape(-1)[:qp.n] for o in outs]).to(dtype)
    out = out.reshape(*lead, *qp.cell_shape)
    return torch.movedim(out, -2, 0).contiguous() if qp.stacked else out


def qparam_wire_nbytes(cell_shape: tuple, cfg: QuantConfig) -> int:
    """Per-cell wire length of a QuantizedParam."""
    return wire_segment_bytes(math.prod(cell_shape), cfg)


def qparam_split_stack(qp: QuantizedParam) -> QuantizedParam:
    """Re-slice a stacked QuantizedParam into one wire segment per stack
    slice: wire (*lead, nbytes) -> (stack, *lead, nbytes_slice), cell
    (n_local,) (``core/quant.py:558`` of the JAX package).  Each slice owns
    whole buckets (n_local % bucket_size == 0), so it is a valid segment
    (codes | scale | zero) whose decode equals those rows of the full
    decode bit for bit: serving can walk the layers of a stack while the
    codes stay in wire form."""
    if not qp.stacked:
        raise ValueError(f"not a stacked QuantizedParam: cell {qp.cell_shape}")
    stack, n_local = qp.cell_shape
    cfg = qp.cfg
    if n_local % cfg.bucket_size:
        raise ValueError(f"stack slices of {n_local} values do not hold whole buckets of "
                         f"{cfg.bucket_size}")
    nb_s = n_local // cfg.bucket_size
    cb_s = nb_s * (cfg.bucket_size // cfg.codes_per_byte)
    mb_s = nb_s * cfg.meta_bytes
    lead = tuple(qp.wire.shape[:-1])
    cb, sb = cb_s * stack, mb_s * stack
    codes = qp.wire[..., :cb].reshape(*lead, stack, cb_s)
    scale = qp.wire[..., cb:cb + sb].reshape(*lead, stack, mb_s)
    zero = qp.wire[..., cb + sb:cb + 2 * sb].reshape(*lead, stack, mb_s)
    wire = torch.cat([codes, scale, zero], dim=-1)
    return QuantizedParam(torch.movedim(wire, -2, 0).contiguous(), (n_local,), cfg)
