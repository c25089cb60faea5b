"""Versioned deployment plan: the autotuner's output, the launchers' input
(the JAX package's ``tune/plan.py``; the same JSON, byte for byte).

A :class:`DeploymentPlan` pins one point of the quant-and-schedule design
space -- the QSDPConfig comm policy (bits, bucket, rounding, meta dtype,
coalesce + the per-layer ``coalesce_max_bytes`` threshold) and the serve
scheduler's knobs -- together with the mesh it was tuned for, the
per-layer-group decisions that justify it, and the cost-model and
measurement evidence.  ``launch/train.py --plan`` and ``launch/serve.py
--plan`` consume it instead of a dozen flags.

``hierarchical`` and ``prefetch`` are the port's fields as the
reference's (a plan tuned at one rank sets ``hierarchical`` to change no
exchange: it needs a "pod" axis).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ..core.qsdp import QSDPConfig

PLAN_VERSION = 1

# QSDPConfig fields a plan may set (everything that shapes the wire or the
# schedule; deliberately NOT compute_dtype / remat_policy, which belong to
# the launcher)
_QSDP_FIELDS = (
    "quantize_weights", "quantize_grads", "weight_bits", "grad_bits",
    "bucket_size", "weight_mode", "grad_mode", "min_quant_size",
    "meta_wire_dtype", "hierarchical", "coalesce", "prefetch",
    "coalesce_max_bytes",
)

_SERVE_FIELDS = (
    "slots", "prefill_chunk", "prefill_buckets", "prefill_interleave",
    "kv_block_size", "kv_pool_blocks", "kv_quant_bits", "kv_quant_horizon",
    "draft_bits", "draft_depth",
)


def _round_floats(obj, ndigits: int = 4):
    """Round every float in a JSON-able tree (stable artifact diffs)."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, ndigits) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """Per-layer-group decision record (diagnostic + what the threshold in
    the qsdp section encodes)."""

    group: str               # layer-group prefix ("layers") or single param
    coalesce: bool           # does the plan's policy coalesce this group?
    wire_buffer_bytes: int   # per-device gathered wire buffer (P * nbytes)
    launches_per_tensor: int  # one gather of the group, per-tensor
    launches_coalesced: int   # one gather of the group, coalesced

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DeploymentPlan:
    version: int
    arch: str
    mesh_axes: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    hw: str                       # cost-model hardware preset name
    qsdp: dict                    # QSDPConfig overrides (subset of _QSDP_FIELDS)
    serve: dict                   # serve knobs (subset of _SERVE_FIELDS)
    layers: tuple[LayerPolicy, ...] = ()
    predicted: dict = dataclasses.field(default_factory=dict)
    measured: dict = dataclasses.field(default_factory=dict)

    # -- QSDPConfig round-trip -------------------------------------------------

    def to_qsdp_config(self, base: Optional[QSDPConfig] = None) -> QSDPConfig:
        base = base if base is not None else QSDPConfig()
        bad = set(self.qsdp) - set(_QSDP_FIELDS)
        if bad:
            raise ValueError(f"plan qsdp section has unknown fields: {sorted(bad)}")
        return dataclasses.replace(base, **self.qsdp)

    def serve_knobs(self) -> dict:
        bad = set(self.serve) - set(_SERVE_FIELDS)
        if bad:
            raise ValueError(f"plan serve section has unknown fields: {sorted(bad)}")
        return dict(self.serve)

    def validate_mesh(self, axes: tuple[str, ...], shape: tuple[int, ...]) -> None:
        """A plan is tuned FOR a mesh; refuse to drive a different one (the
        cost crossover and the per-layer byte threshold both scale with the
        FSDP size)."""
        if tuple(axes) != self.mesh_axes or tuple(shape) != self.mesh_shape:
            raise ValueError(
                f"plan was tuned for mesh {self.mesh_axes}={self.mesh_shape}, "
                f"launcher requested {tuple(axes)}={tuple(shape)} — re-run "
                f"repro_torch.tune.autotune for this mesh")

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_axes"] = list(self.mesh_axes)
        d["mesh_shape"] = list(self.mesh_shape)
        d["layers"] = [lp.to_dict() for lp in self.layers]
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(_round_floats(self.to_dict()), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentPlan":
        if d.get("version") != PLAN_VERSION:
            raise ValueError(
                f"deployment plan version {d.get('version')!r} != supported "
                f"{PLAN_VERSION} — regenerate with repro_torch.tune.autotune")
        layers = tuple(LayerPolicy(**lp) for lp in d.get("layers", ()))
        return cls(
            version=PLAN_VERSION,
            arch=d["arch"],
            mesh_axes=tuple(d["mesh_axes"]),
            mesh_shape=tuple(int(x) for x in d["mesh_shape"]),
            hw=d.get("hw", ""),
            qsdp=dict(d.get("qsdp", {})),
            serve=dict(d.get("serve", {})),
            layers=layers,
            predicted=dict(d.get("predicted", {})),
            measured=dict(d.get("measured", {})),
        )

    @classmethod
    def load(cls, path: str) -> "DeploymentPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))
