"""The QSDP engine: FSDP parameters with quantized communication.

Every logical parameter is stored at rest in the JAX package's distributed
layout

    (stack?, MODEL, FSDP, n_local)

with ``n_local = ceil(prod(tp_local_shape) / FSDP)``, flat and zero-padded,
so the port's wire bytes compare with the reference's byte for byte.
:meth:`QSDPEngine.gather_layer` rebuilds the TP-local tensors of one layer
as a ``torch.autograd.Function`` (the reference's ``custom_vjp``):

    forward :  quantize every shard (shift rounding, Def. 1) -> serialize
               into one coalesced u8 buffer -> all-gather -> decode
    backward:  quantize the cotangent's chunks (stochastic rounding,
               Def. 12) -> all-to-all -> dequant-sum (the quantized
               reduce-scatter), divided by the FSDP size

Per-tensor keys are ``fold_in(key, stable_hash(name))`` and the backward's
``fold_in(that, 0x5D)``, exactly as in the JAX package, so the quantization
randomness is the reference's.  Under ``torch.utils.checkpoint`` the
backward re-gathers each layer from the same key (byte-identical weights),
and each gather's backward runs once: the paper's 2x AllGather + 1x
ReduceScatter per layer per step.  This port runs on the (1, 1) mesh
(ROADMAP A3b/A4b bring more ranks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.ops import RowQuantWeight
from . import collectives as coll
from . import prng
from .quant import QuantConfig, quantize, unpack_codes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Static view of the mesh: axes ("data", "model") or ("pod", "data",
    "model") and their sizes."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def fsdp_size(self) -> int:
        s = dict(zip(self.axes, self.shape))
        return s["data"] * s.get("pod", 1)

    @property
    def model_size(self) -> int:
        return dict(zip(self.axes, self.shape))["model"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One logical parameter of the model."""

    shape: tuple[int, ...]            # logical (TP-global) shape, no stack dim
    tp_axis: Optional[int] = None     # axis sharded over "model"
    stack: Optional[int] = None       # layers stacked on a leading axis
    init: str = "normal"              # normal | scaled_normal | zeros | ones | constant
    init_scale: float = 0.02
    quantize: bool = True             # False: always full-precision comm

    def tp_local_shape(self, model_size: int) -> tuple[int, ...]:
        if self.tp_axis is None:
            return self.shape
        if self.shape[self.tp_axis] % model_size:
            raise ValueError(f"{self.shape} axis {self.tp_axis} does not split "
                             f"over {model_size} ranks")
        s = list(self.shape)
        s[self.tp_axis] //= model_size
        return tuple(s)

    def n_logical_local(self, model_size: int) -> int:
        return math.prod(self.tp_local_shape(model_size))

    def n_local(self, ms: MeshSpec) -> int:
        return -(-self.n_logical_local(ms.model_size) // ms.fsdp_size)

    def rest_shape(self, ms: MeshSpec) -> tuple[int, ...]:
        base = (ms.model_size, ms.fsdp_size, self.n_local(ms))
        return (self.stack, *base) if self.stack is not None else base


def to_rest(full: torch.Tensor, spec: ParamSpec, ms: MeshSpec) -> torch.Tensor:
    """Logical layout -> rest layout (stack?, MODEL, FSDP, n_local)."""
    lead = 1 if spec.stack is not None else 0
    x = full
    if spec.tp_axis is not None:
        ax = spec.tp_axis + lead
        s = list(x.shape)
        x = x.reshape(*s[:ax], ms.model_size, s[ax] // ms.model_size, *s[ax + 1:])
        x = torch.movedim(x, ax, lead)
    else:
        x = x.unsqueeze(lead)
        x = x.expand(*x.shape[:lead], ms.model_size, *x.shape[lead + 1:])
    batch_dims = x.shape[: lead + 1]
    flat = x.reshape(*batch_dims, -1)
    n = flat.shape[-1]
    n_local = -(-n // ms.fsdp_size)
    pad = n_local * ms.fsdp_size - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(*batch_dims, ms.fsdp_size, n_local).contiguous()


def from_rest(rest: torch.Tensor, spec: ParamSpec, ms: MeshSpec) -> torch.Tensor:
    """Rest layout -> logical layout."""
    lead = 1 if spec.stack is not None else 0
    batch_dims = rest.shape[: lead + 1]
    local = spec.tp_local_shape(ms.model_size)
    x = rest.reshape(*batch_dims, -1)[..., : math.prod(local)]
    x = x.reshape(*batch_dims, *local)
    if spec.tp_axis is None:
        return x[:, 0] if lead else x[0]
    ax = spec.tp_axis + lead
    x = torch.movedim(x, lead, ax)
    s = list(x.shape)
    return x.reshape(*s[:ax], s[ax] * s[ax + 1], *s[ax + 2:])


def init_param(gen: torch.Generator, spec: ParamSpec, ms: MeshSpec,
               device) -> torch.Tensor:
    """Random init from an explicit generator (not bit-equal to the JAX
    package's ``jax.random.normal`` init: load its weights with
    ``weights.params_from_jax`` to compare the two)."""
    shape = ((spec.stack,) if spec.stack is not None else ()) + spec.shape
    f32 = dict(dtype=torch.float32, device=device)
    if spec.init == "zeros":
        full = torch.zeros(shape, **f32)
    elif spec.init == "ones":
        full = torch.ones(shape, **f32)
    elif spec.init == "constant":
        full = torch.full(shape, spec.init_scale, **f32)
    elif spec.init == "normal":
        full = torch.randn(shape, generator=gen, **f32) * spec.init_scale
    elif spec.init == "scaled_normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        full = torch.randn(shape, generator=gen, **f32) * (spec.init_scale / math.sqrt(fan_in))
    else:
        raise ValueError(spec.init)
    return to_rest(full, spec, ms)


@dataclasses.dataclass(frozen=True)
class QSDPConfig:
    """Communication policy; the paper's QSDP default is W8G8, bucket 1024.
    ``baseline()`` is the paper's FSDP baseline (fp32 weights, bf16
    gradients, per-tensor collectives).  Gathered weights are always
    decoded straight into ``compute_dtype``, which gives the bytes of the
    f32 decode's cast, so the JAX package's ``dequant_to_compute`` has no
    counterpart here."""

    quantize_weights: bool = True
    quantize_grads: bool = True
    weight_bits: int = 8
    grad_bits: int = 8
    bucket_size: int = 1024
    weight_mode: str = "shift"        # Definition 1
    grad_mode: str = "stochastic"     # Definition 12
    min_quant_size: int = 2048
    weight_wire_dtype: str = "float32"
    grad_wire_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "full"        # recompute each layer in the backward
    attn_bf16: bool = False
    rand_bits: int = 32
    coalesce: bool = True
    coalesce_max_bytes: Optional[int] = None
    meta_wire_dtype: str = "float32"

    def __post_init__(self):
        if self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} is not ported yet (ROADMAP A5c); "
                "the port recomputes each whole layer ('full')")

    @classmethod
    def baseline(cls) -> "QSDPConfig":
        """The paper's FSDP baseline: fp32 weights / bf16 grads, per-tensor
        collectives."""
        return cls(quantize_weights=False, quantize_grads=False, coalesce=False)

    def wcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.weight_bits, bucket_size=self.bucket_size,
                           mode=self.weight_mode, rand_bits=self.rand_bits,
                           meta_dtype=self.meta_wire_dtype)

    def gcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.grad_bits, bucket_size=self.bucket_size,
                           mode=self.grad_mode, rand_bits=self.rand_bits,
                           meta_dtype=self.meta_wire_dtype)


_GRAD_SALT = 0x5D  # fold_in(gather key, _GRAD_SALT) keys the gradient RS


def _tensor_key(key: prng.Key, name: str) -> prng.Key:
    """The key a gather under `key` rounds tensor `name` with."""
    return prng.fold_in(key, prng.stable_hash(name))


class _GatherLayer(torch.autograd.Function):
    """Coalesced layer gather (forward) / coalesced quantized reduce-scatter
    of the cotangents (backward): the reference's ``qsdp_gather_layer``."""

    @staticmethod
    def forward(ctx, eng, names, key, *shards):
        ctx.eng, ctx.names, ctx.key = eng, names, key
        layout = eng.layout(names)
        # K2 decodes each quantized weight straight into the compute dtype
        # that _reshape_full casts to: the bytes of the f32 decode's cast
        # (the JAX package's dequant_to_compute gives them too), without the
        # cast kernel.
        # The cotangent then arrives in that dtype; the backward sums in f32.
        return tuple(coll.all_gather_coalesced(
            shards, layout,
            [_tensor_key(key, n) if s.cfg is not None else None
             for n, s in zip(names, layout.segments)],
            [eng.compute_dtype if s.cfg is not None else torch.float32
             for s in layout.segments],
            eng.group))

    @staticmethod
    def backward(ctx, *cts):
        eng, p = ctx.eng, ctx.eng.ms.fsdp_size
        layout = eng.rs_layout(ctx.names)
        keys = [prng.fold_in(_tensor_key(ctx.key, n), _GRAD_SALT)
                if s.cfg is not None else None for n, s in zip(ctx.names, layout.segments)]
        gs = coll.reduce_scatter_coalesced([c.float() for c in cts], layout, keys, eng.group)
        return (None, None, None, *(g / p for g in gs))


class _GatherOne(torch.autograd.Function):
    """Per-tensor gather (3 collectives for a quantized tensor, 1 for an fp
    payload) / per-tensor reduce-scatter: the reference's ``qsdp_gather``."""

    @staticmethod
    def forward(ctx, eng, name, key, flat):
        ctx.eng, ctx.name, ctx.key = eng, name, key
        if eng._is_quantized(eng.specs[name]):
            return coll.all_gather_quantized(flat, eng.cfg.wcfg(), _tensor_key(key, name),
                                             eng.group, out_dtype=eng.compute_dtype)
        return coll.all_gather_fp(flat, eng.group, _DTYPES[eng.cfg.weight_wire_dtype])

    @staticmethod
    def backward(ctx, ct):
        eng, name = ctx.eng, ctx.name
        ct = ct.float()
        if eng._is_grad_quantized(eng.specs[name]):
            bkey = prng.fold_in(_tensor_key(ctx.key, name), _GRAD_SALT)
            g = coll.reduce_scatter_quantized(ct, eng.cfg.gcfg(), bkey, eng.group)
        else:
            g = coll.reduce_scatter_fp(ct, eng.group, _DTYPES[eng.cfg.grad_wire_dtype])
        return None, None, None, g / eng.ms.fsdp_size


class QSDPEngine:
    """Binds a MeshSpec + QSDPConfig + parameter specs into gather calls."""

    def __init__(self, ms: MeshSpec, cfg: QSDPConfig, specs: dict[str, ParamSpec],
                 group=None):
        if ms.fsdp_size * ms.model_size > 1:
            raise NotImplementedError(
                f"mesh {dict(zip(ms.axes, ms.shape))}: multi-rank QSDP is not "
                "ported yet (ROADMAP A3b/A4b); the port runs on the (1, 1) mesh")
        self.ms = ms
        self.cfg = cfg
        self.specs = specs
        self.group = group
        self.compute_dtype = _DTYPES[cfg.compute_dtype]

    # -- static policy --------------------------------------------------------

    def _is_quantized(self, spec: ParamSpec) -> bool:
        return (spec.quantize and self.cfg.quantize_weights
                and spec.n_logical_local(self.ms.model_size) >= self.cfg.min_quant_size)

    def _is_grad_quantized(self, spec: ParamSpec) -> bool:
        return (spec.quantize and self.cfg.quantize_grads
                and spec.n_logical_local(self.ms.model_size) >= self.cfg.min_quant_size)

    def rs_layout(self, names: tuple[str, ...]) -> coll.WireLayout:
        """Wire layout of the gradient reduce-scatter rows of `names`."""
        gcfg = self.cfg.gcfg()
        return coll.WireLayout(tuple(
            coll.WireSegment(self.specs[n].n_local(self.ms),
                             gcfg if self._is_grad_quantized(self.specs[n]) else None,
                             self.cfg.grad_wire_dtype)
            for n in names))

    def layout(self, names: tuple[str, ...]) -> coll.WireLayout:
        """Coalesced wire layout of one gather of `names` (in that order)."""
        wcfg = self.cfg.wcfg()
        return coll.WireLayout(tuple(
            coll.WireSegment(self.specs[n].n_local(self.ms),
                             wcfg if self._is_quantized(self.specs[n]) else None,
                             self.cfg.weight_wire_dtype)
            for n in names))

    def layer_wire_bytes(self, names: tuple[str, ...]) -> int:
        return self.ms.fsdp_size * self.layout(tuple(names)).nbytes

    def layer_coalesced(self, names: tuple[str, ...]) -> bool:
        """Ship these params as ONE wire buffer iff ``cfg.coalesce`` and the
        gathered buffer stays under ``cfg.coalesce_max_bytes``."""
        if not self.cfg.coalesce:
            return False
        if self.cfg.coalesce_max_bytes is None:
            return True
        return self.layer_wire_bytes(names) <= self.cfg.coalesce_max_bytes

    # -- gathers ----------------------------------------------------------------

    def _reshape_full(self, name: str, full: torch.Tensor) -> torch.Tensor:
        spec = self.specs[name]
        n = spec.n_logical_local(self.ms.model_size)
        w = full[:n].reshape(spec.tp_local_shape(self.ms.model_size))
        return w.to(self.compute_dtype)

    def gather(self, name: str, local: torch.Tensor, key: prng.Key) -> torch.Tensor:
        """The TP-local tensor of parameter `name` from its flat shard."""
        return self.gather_layer("", {name: local}, key)[name]

    def gather_layer(self, prefix: str, leaves: dict[str, torch.Tensor],
                     key: prng.Key) -> dict[str, torch.Tensor]:
        """Gather every parameter of one layer dict — ONE collective for the
        whole layer under ``cfg.coalesce``, per-tensor otherwise — with the
        quantized reduce-scatter as its backward.  Tensor `name` is rounded
        under ``fold_in(key, stable_hash(name))``."""
        if not leaves:
            return {}
        names = tuple(sorted(leaves))
        full_names = tuple(f"{prefix}{k}" for k in names)
        if not self.layer_coalesced(full_names):
            return {k: self._reshape_full(
                        n, _GatherOne.apply(self, n, key, leaves[k].reshape(-1)))
                    for k, n in zip(names, full_names)}
        fulls = _GatherLayer.apply(self, full_names, key,
                                   *[leaves[k].reshape(-1) for k in names])
        return {k: self._reshape_full(n, f) for k, n, f in zip(names, full_names, fulls)}

    # -- code-form gather (serve/decode) -----------------------------------------

    def _rowquant_tiling_ok(self, spec: ParamSpec, cfg: QuantConfig) -> bool:
        """Do `cfg`'s buckets tile this weight's rows exactly?  2-D shape, N
        a multiple of the bucket and FSDP shards of whole buckets."""
        shape = spec.tp_local_shape(self.ms.model_size)
        n = spec.n_logical_local(self.ms.model_size)
        p = self.ms.fsdp_size
        return (cfg.bucket_size % cfg.codes_per_byte == 0
                and len(shape) == 2
                and shape[1] % cfg.bucket_size == 0
                and n % p == 0
                and (n // p) % cfg.bucket_size == 0)

    def _assemble_rowquant(self, spec: ParamSpec, cfg: QuantConfig, q) -> RowQuantWeight:
        """Gather a shard's (codes, scale, zero) and reshape into the
        (K, N) / (K, N / bucket) RowQuantWeight layout."""
        coll.require_one_rank(self.group)
        codes = q.codes
        if cfg.codes_per_byte > 1:
            codes = unpack_codes(codes, cfg.bits)
        k_dim, n_dim = spec.tp_local_shape(self.ms.model_size)
        n_seg = n_dim // cfg.bucket_size
        return RowQuantWeight(codes=codes.reshape(k_dim, n_dim),
                              scale=q.scale.reshape(k_dim, n_seg),
                              zero=q.zero.reshape(k_dim, n_seg))

    def rowquant_eligible(self, name: str) -> bool:
        spec = self.specs[name]
        return self._is_quantized(spec) and self._rowquant_tiling_ok(spec, self.cfg.wcfg())

    def gather_rowquant(self, name: str, local: torch.Tensor, key: prng.Key):
        """Gather `name` as a :class:`RowQuantWeight` (wire codes + per-bucket
        affine) for ``ops.rowquant_matmul``; the dense :meth:`gather` when
        the buckets do not tile its rows."""
        if not self.rowquant_eligible(name):
            return self.gather(name, local, key)
        wcfg = self.cfg.wcfg()
        return self._assemble_rowquant(self.specs[name], wcfg,
                                       quantize(local.reshape(-1), wcfg, _tensor_key(key, name)))

    # -- host-side helpers ----------------------------------------------------------

    def init_params(self, seed: int, device) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=device).manual_seed(seed)
        return {name: init_param(gen, spec, self.ms, device)
                for name, spec in sorted(self.specs.items())}
