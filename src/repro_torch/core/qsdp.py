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
ReduceScatter per layer per step.

Under ``QSDPConfig(prefetch=True)`` a coalesced layer gather is split in
two (the reference's ``qsdp_gather_layer_start``/``_finish``):
:meth:`QSDPEngine.gather_layer_start` encodes and all-gathers (no autograd
node; on the card on a side CUDA stream) and
:meth:`QSDPEngine.gather_layer_finish` decodes the carried wire buffer and
owns the whole backward, the same reduce-scatter under the same keys.  The
layer loop runs the start a layer ahead, outside the layer's checkpoint,
and hands the wire to the checkpointed body: the backward's replay decodes
the layer again (K2) but encodes nothing.

The engine runs on a (P, M) ("data", "model") mesh of P·M ranks: each
rank, at (data rank d, model rank m), holds its block ``(stack?, 1, 1,
n_local)`` of every rest-layout leaf, row m and column d of the leaf, the
block ``shard_map`` gives device ``d·M + m`` of the reference.  The gathers
and reduce-scatters exchange over the rank's data group (the P ranks of
its m) at the TP-local sizes; a model-replicated parameter consumed
rank-specifically (``ParamSpec.grad_sync_model``: replicated KV) has its
reduce-scattered gradient summed over the model group (the M ranks of its
d).  ``group=None`` and ``model_group=None`` are the one-rank axes.  The
two-level gathers of a "pod" axis (ROADMAP A3b) and serving over ranks
(A10e) are refused.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.ops import RowQuantWeight
from . import collectives as coll
from . import prng
from ..kernels import ops
from .quant import (QuantConfig, QuantizedParam, kernel_dtype, quantize, unpack_codes,
                    wire_codes, wire_unpack)
from .tp import model_sum

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
    # model-replicated but consumed rank-specifically: its gradient is summed
    # over the model group after the reduce-scatter (the reference's psum)
    grad_sync_model: bool = False

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

    def local_shape(self, ms: MeshSpec) -> tuple[int, ...]:
        """One rank's block of :meth:`rest_shape`: model and FSDP axes 1."""
        return (*self.rest_shape(ms)[:-3], 1, 1, self.n_local(ms))


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


def rank_block(rest, rank: int, p: int, model_rank: int = 0, model_size: int = 1):
    """The block of a rest-layout leaf (a tensor or an array) that the rank
    at (data rank `rank`, model rank `model_rank`) of a (P, M) mesh holds:
    axis -3, the model axis, sliced to ``[model_rank:model_rank + 1]`` and
    axis -2, the FSDP axis, to ``[rank:rank + 1]``; the leaf itself at one
    rank."""
    if p == 1 and model_size == 1:
        return rest
    block = rest[..., model_rank:model_rank + 1, rank:rank + 1, :]
    return block.clone() if isinstance(block, torch.Tensor) else block.copy()


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
        # scaled in place: the same values as `randn * scale`, without a
        # second copy of the largest stack
        full = torch.randn(shape, generator=gen, **f32).mul_(spec.init_scale)
    elif spec.init == "scaled_normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        full = torch.randn(shape, generator=gen, **f32).mul_(spec.init_scale / math.sqrt(fan_in))
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
    # activation checkpointing of the layer loop: "full" recomputes each
    # layer in the backward, "dots" keeps its 2-D matmuls' outputs
    remat_policy: str = "full"
    attn_bf16: bool = False
    rand_bits: int = 32
    coalesce: bool = True
    coalesce_max_bytes: Optional[int] = None
    # double-buffered layer prefetch: a stack's layer loop starts layer
    # i+1's coalesced gather (K1 and the all-gather, on a side CUDA stream
    # on the card) before it computes layer i, and decodes layer i's wire
    # buffer inside the layer's checkpoint (``models/transformer.py``).
    # Only where the stack's layers are coalesced; changes no value.
    prefetch: bool = False
    meta_wire_dtype: str = "float32"

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}")

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


def _layer_grad_rs(eng, names, key, cts) -> tuple:
    """The coalesced quantized reduce-scatter of one layer gather's
    cotangents, divided by the FSDP size and summed over the model group
    where ``grad_sync_model``: the backward of both :class:`_GatherLayer`
    and :class:`_GatherLayerFinish` (reference ``_layer_grad_rs``)."""
    layout = eng.rs_layout(names)
    keys = [prng.fold_in(_tensor_key(key, n), _GRAD_SALT)
            if s.cfg is not None else None for n, s in zip(names, layout.segments)]
    gs = coll.reduce_scatter_coalesced([c.float() for c in cts], layout, keys, eng.group)
    return tuple(eng._sync_model(n, g / eng.ms.fsdp_size) for n, g in zip(names, gs))


def _gather_keys(layout: coll.WireLayout, names, key) -> list:
    return [_tensor_key(key, n) if s.cfg is not None else None
            for n, s in zip(names, layout.segments)]


def _out_dtypes(eng, layout: coll.WireLayout) -> list:
    # K2 decodes each quantized weight straight into the compute dtype that
    # _reshape_full casts to: the bytes of the f32 decode's cast (the JAX
    # package's dequant_to_compute gives them too), without the cast kernel.
    # The cotangent then arrives in that dtype; the backward sums in f32.
    return [eng.compute_dtype if s.cfg is not None else torch.float32
            for s in layout.segments]


class _GatherLayer(torch.autograd.Function):
    """Coalesced layer gather (forward) / coalesced quantized reduce-scatter
    of the cotangents (backward): the reference's ``qsdp_gather_layer``."""

    @staticmethod
    def forward(ctx, eng, names, key, *shards):
        ctx.eng, ctx.names, ctx.key = eng, names, key
        layout = eng.layout(names)
        return tuple(coll.all_gather_coalesced(shards, layout, _gather_keys(layout, names, key),
                                               _out_dtypes(eng, layout), eng.group))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, None, *_layer_grad_rs(ctx.eng, ctx.names, ctx.key, cts))


class _GatherLayerFinish(torch.autograd.Function):
    """Decode a wire buffer that :meth:`QSDPEngine.gather_layer_start`
    gathered (forward; the shards are not read, their bytes are in the
    wire) / the same reduce-scatter as :class:`_GatherLayer` (backward):
    the reference's ``qsdp_gather_layer_finish``."""

    @staticmethod
    def forward(ctx, eng, names, key, wire, *shards):
        ctx.eng, ctx.names, ctx.key = eng, names, key
        layout = eng.layout(names)
        return tuple(coll.decode_gathered_wire(wire, layout, eng.ms.fsdp_size,
                                               _out_dtypes(eng, layout)))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, None, None, *_layer_grad_rs(ctx.eng, ctx.names, ctx.key, cts))


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
        return None, None, None, eng._sync_model(name, g / eng.ms.fsdp_size)


def check_mesh(ms: MeshSpec) -> None:
    """Refuse a mesh the port does not run: a "pod" axis, whose FSDP
    exchanges are two-level (ROADMAP A3b)."""
    if "pod" in ms.axes:
        raise NotImplementedError(
            f"mesh {dict(zip(ms.axes, ms.shape))}: the two-level gathers of a 'pod' axis "
            "are not ported yet (ROADMAP A3b)")


class QSDPEngine:
    """Binds a MeshSpec + QSDPConfig + parameter specs into gather calls."""

    def __init__(self, ms: MeshSpec, cfg: QSDPConfig, specs: dict[str, ParamSpec],
                 group=None, model_group=None, model_rank: Optional[int] = None):
        """`group`: the rank's data group (its FSDP exchanges); `model_group`:
        its model group (None: one rank each).  Without a model group on a
        model axis above 1, `model_rank` names the one model rank whose
        share this process computes alone (every model-axis sum the
        identity): the rank-by-rank emulation of the tp-local work in one
        process."""
        check_mesh(ms)
        mesh = dict(zip(ms.axes, ms.shape))
        if ms.fsdp_size != coll.group_size(group):
            raise ValueError(f"mesh {mesh} has {ms.fsdp_size} FSDP ranks but the process "
                             f"group has {coll.group_size(group)} (group=None is one rank)")
        if model_group is not None or model_rank is None:
            if ms.model_size != coll.group_size(model_group):
                raise ValueError(
                    f"mesh {mesh} has {ms.model_size} model ranks but the model group has "
                    f"{coll.group_size(model_group)} (None is one rank, unless model_rank "
                    "names the rank computed alone)")
            model_rank = coll.group_rank(model_group)
        elif not 0 <= model_rank < ms.model_size:
            raise ValueError(f"model_rank {model_rank} is not on the mesh {mesh}")
        self.ms = ms
        self.cfg = cfg
        self.specs = specs
        self.group = group
        self.model_group = model_group
        self.rank = coll.group_rank(group)
        self.model_rank = model_rank
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self._streams: dict = {}

    def _sync_model(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A reduce-scattered gradient, summed over the model group where
        the parameter is ``grad_sync_model`` (reference ``qsdp.py:379-380,
        507-510``)."""
        return model_sum(g, self.model_group) if self.specs[name].grad_sync_model else g

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

    # -- the prefetch pipeline's two halves (reference ``qsdp.py:697-711``) -----

    def _side_stream(self, device: torch.device):
        """The engine's side CUDA stream on `device` (made at first use),
        None off the card: on the CPU and the meta device the start runs in
        order on the one stream."""
        if device.type != "cuda":
            return None
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]

    def gather_layer_start(self, prefix: str, leaves: dict[str, torch.Tensor],
                           key: prng.Key) -> torch.Tensor:
        """Prefetch, step 1: encode a coalesced layer (K1, each tensor under
        the key :meth:`gather_layer` gives it) and all-gather it; returns the
        gathered u8 wire buffer, which autograd does not track.  On the card
        it runs on the engine's side stream, after the work queued so far on
        the compute stream (the previous step's in-place update included),
        so that it can run beside the compute queued next; the wire is allocated
        on the side stream and marked as used on the compute stream, and
        carries the event :meth:`gather_layer_finish` waits for."""
        names = tuple(sorted(leaves))
        full_names = tuple(f"{prefix}{k}" for k in names)
        layout = self.layout(full_names)
        keys = _gather_keys(layout, full_names, key)
        with torch.no_grad():
            shards = [leaves[k].reshape(-1) for k in names]
            side = self._side_stream(shards[0].device)
            if side is None:
                return coll.start_gather_coalesced(shards, layout, keys, self.group)
            compute = torch.cuda.current_stream(side.device)
            side.wait_stream(compute)
            with torch.cuda.stream(side):
                wire = coll.start_gather_coalesced(shards, layout, keys, self.group)
                ready = torch.cuda.Event()
                ready.record(side)
            for x in shards:
                x.record_stream(side)
            wire.record_stream(compute)
        wire._qsdp_ready = ready
        return wire

    def gather_layer_finish(self, prefix: str, leaves: dict[str, torch.Tensor],
                            wire: torch.Tensor, key: prng.Key) -> dict[str, torch.Tensor]:
        """Prefetch, step 2: decode a wire buffer from
        :meth:`gather_layer_start` (K2, after its event on the card) into the
        layer's TP-local tensors; the backward reduce-scatters their
        gradients to `leaves` under `key`, as :meth:`gather_layer`'s does."""
        names = tuple(sorted(leaves))
        full_names = tuple(f"{prefix}{k}" for k in names)
        ready = getattr(wire, "_qsdp_ready", None)
        if ready is not None:
            torch.cuda.current_stream(wire.device).wait_event(ready)
        fulls = _GatherLayerFinish.apply(self, full_names, key, wire,
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
        (K, N) / (K, N / bucket) RowQuantWeight layout.  Serving runs on one
        rank (ROADMAP A10e)."""
        coll.require_one_rank(self.group)
        coll.require_one_rank(self.model_group)
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

    def rowquant_wire_eligible(self, name: str, qp: QuantizedParam) -> bool:
        """:meth:`rowquant_eligible` for a parameter whose rest state already
        is wire codes (a quantized checkpoint, the speculative draft): its
        own buckets must tile the weight's rows, with f32 scale/zero as K3
        reads them.  Independent of this engine's own quantization."""
        return (qp.cfg.meta_dtype == "float32"
                and self._rowquant_tiling_ok(self.specs[name], qp.cfg))

    def gather_rowquant_wire(self, name: str, qp: QuantizedParam) -> RowQuantWeight:
        """Gather a parameter stored as wire codes straight into a
        :class:`RowQuantWeight` for K3: no quantize on the way out, no
        dequantize on the way in.  Sub-8-bit codes are unpacked to one byte
        per value after the gather (reference ``qsdp.py:745-764, 801``).
        `qp` is one layer's view, cell (n_local,); the caller checks
        :meth:`rowquant_wire_eligible`."""
        q = wire_unpack(qp.wire.reshape(-1), qp.n, qp.cfg)
        return self._assemble_rowquant(self.specs[name], qp.cfg, q)

    def gather_wire_dequant(self, prefix: str,
                            qps: dict[str, QuantizedParam]) -> dict[str, torch.Tensor]:
        """Dense decode of parameters stored as wire codes that K3 does not
        take (the attention projections; odd buckets): each one's wire
        segments gathered over FSDP (one rank: as they are; every segment
        carries its own bucket padding, so any bucket size works) and all of
        them decoded into the compute dtype by ONE K2 launch, a table entry
        per segment read in its own buffer (reference ``qsdp.py:812`` decodes
        one parameter per call).  Returns {name: TP-local tensor}."""
        if not qps:
            return {}
        coll.require_one_rank(self.group)
        coll.require_one_rank(self.model_group)
        names = sorted(qps)
        bufs = [qps[n].wire.reshape(-1) for n in names]
        table = [wire_codes(0, qps[n].n, qps[n].cfg) for n in names]
        dt = kernel_dtype(self.compute_dtype)
        outs = ops.unpack_dequantize_wire(bufs, table, [dt] * len(names))
        return {n: self._reshape_full(f"{prefix}{n}", o.reshape(-1))
                for n, o in zip(names, outs)}

    # -- host-side helpers ----------------------------------------------------------

    def init_params(self, seed: int, device) -> dict[str, torch.Tensor]:
        """Every leaf drawn whole, as at one rank, and this rank's block kept:
        the P·M ranks hold exactly the whole state's values."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return {name: rank_block(init_param(gen, spec, self.ms, device), self.rank,
                                 self.ms.fsdp_size, self.model_rank, self.ms.model_size)
                for name, spec in sorted(self.specs.items())}


# ---------------------------------------------------------------------------
# Communication accounting (per step, analytic; the reference's Fig-4 model)
# ---------------------------------------------------------------------------


def step_comm_bytes(engine: QSDPEngine, gathers_per_param: int = 2,
                    reduces_per_param: int = 1) -> dict[str, int]:
    """Per-device wire bytes of one optimizer step under the engine's policy
    (2 weight all-gathers + 1 gradient reduce-scatter per param by default,
    the FSDP schedule).  On the (1, 1) mesh every term is 0, as in the
    reference: a gather of one shard receives nothing."""
    ms, cfg = engine.ms, engine.cfg
    p = ms.fsdp_size
    wbytes = rbytes = 0
    for spec in engine.specs.values():
        reps = spec.stack or 1
        n_local_shard = spec.n_local(ms)
        n_full = n_local_shard * p
        wq = cfg.wcfg() if engine._is_quantized(spec) else None
        gq = cfg.gcfg() if engine._is_grad_quantized(spec) else None
        wfp = 4 if cfg.weight_wire_dtype == "float32" else 2
        gfp = 4 if cfg.grad_wire_dtype == "float32" else 2
        wbytes += reps * gathers_per_param * coll.gather_wire_bytes(n_local_shard, p, wq, wfp)
        rbytes += reps * reduces_per_param * coll.reduce_scatter_wire_bytes(n_full, p, gq, gfp)
    return dict(weight_gather=wbytes, grad_reduce=rbytes, total=wbytes + rbytes)


def layer_gather_launches(engine: QSDPEngine, names) -> int:
    """Analytic collective-launch count of ONE gather of the given params:
    3 per quantized tensor (codes, scale, zero) + 1 per full-precision
    tensor when per-tensor, 1 in all when coalesced (the engine's
    ``coalesce_max_bytes`` policy decides).  The port has no two-level
    (hierarchical) gathers (ROADMAP A3b), so one level."""
    if engine.layer_coalesced(tuple(names)):
        return 1
    return sum(3 if engine._is_quantized(engine.specs[n]) else 1 for n in names)


def layer_kernel_launches(engine: QSDPEngine, names, skip=()) -> dict[str, tuple[int, int]]:
    """K1 and K2 launches at one rank of ONE gather of the params `names`
    (a layer of a stack, one invocation of a block, or a top-level tensor)
    and of ONE reduce-scatter of their gradients: ``{"gather": (K1, K2),
    "reduce": (K1, K2)}``.  K1 encodes each quantized tensor (each
    gradient-quantized one for the reduce-scatter); K2 decodes each wire
    buffer that holds one, ``ops.WIRE_MAX_SEGS`` tensors a launch: under
    coalescing (``layer_gather_launches`` == 1) the params' one buffer, per
    tensor a buffer each.  The gather's K2 leaves out the tensors whose last
    name is in `skip` (a rowquant decode reads their codes through K3)."""
    names = tuple(names)
    q = [n for n in names if engine._is_quantized(engine.specs[n])]
    g = sum(engine._is_grad_quantized(engine.specs[n]) for n in names)
    decoded = sum(n.split("/")[-1] not in skip for n in q)
    coalesced = engine.layer_coalesced(names)

    def k2(n_q: int) -> int:
        return -(-n_q // ops.WIRE_MAX_SEGS) if coalesced else n_q

    return {"gather": (len(q), k2(decoded)), "reduce": (g, k2(g))}
