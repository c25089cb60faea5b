"""Checkpoints in the JAX package's format ``qsdp-ckpt-v2``: one npz payload
plus a JSON manifest (``train/checkpoint.py`` of the JAX package).

Every leaf is written in its rest layout; a :class:`QuantizedParam` leaf
is written AS its wire bytes (u8 codes + per-bucket scale/zero) with a
manifest entry naming its quantizer, so a quantized state resumes byte for
byte.  The manifest's ``format`` and every leaf's shape and dtype are
validated on load (``qsdp-ckpt-v1``, dense leaves only, loads too).  Both
packages read each other's checkpoints.

This port saves and loads on the mesh layout it was saved on; resharding
to another (model, fsdp) layout waits for ROADMAP A3b.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core.quant import QuantConfig, QuantizedParam
from ..device import resolve_device
from ..optim import OptState
from .step import TrainState

FORMAT_V1 = "qsdp-ckpt-v1"
FORMAT_V2 = "qsdp-ckpt-v2"


def state_to_flat(state: TrainState) -> tuple[dict[str, np.ndarray], dict[str, dict]]:
    """{npz key: host array} and {npz key: manifest entry} of a state."""
    items = [(f"params/{k}", v) for k, v in state.params.items()]
    items.append(("opt/step", np.asarray(state.opt.step, dtype=np.int32)))
    for name, tree in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        if tree != ():
            items += [(f"opt/{name}/{k}", v) for k, v in tree.items()]
    flat, leaves = {}, {}
    for key, v in items:
        if isinstance(v, QuantizedParam):
            arr = v.wire.cpu().numpy()
            leaves[key] = {"kind": "quantized", "shape": list(arr.shape),
                           "dtype": str(arr.dtype), "cell_shape": list(v.cell_shape),
                           "bits": v.cfg.bits, "bucket_size": v.cfg.bucket_size,
                           "mode": v.cfg.mode, "meta_dtype": v.cfg.meta_dtype}
        else:
            arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            leaves[key] = {"kind": "dense", "shape": list(arr.shape), "dtype": str(arr.dtype)}
        flat[key] = arr
    return flat, leaves


def state_from_flat(flat: dict[str, np.ndarray], leaves: dict[str, dict],
                    device=None) -> TrainState:
    """Inverse of :func:`state_to_flat`: tensors on `device` (the card
    unless given), quantized leaves as QuantizedParam with their bytes
    unchanged."""
    device = resolve_device(device)

    def leaf(key):
        e, arr = leaves.get(key, {"kind": "dense"}), np.asarray(flat[key])
        t = torch.from_numpy(np.array(arr)).to(device)
        if e.get("kind") != "quantized":
            return t
        cfg = QuantConfig(bits=e["bits"], bucket_size=e["bucket_size"], mode=e["mode"],
                          meta_dtype=e.get("meta_dtype", "float32"))
        return QuantizedParam(t, tuple(e["cell_shape"]), cfg)

    def tree(prefix):
        keys = [k for k in flat if k.startswith(prefix)]
        return {k[len(prefix):]: leaf(k) for k in keys} if keys else ()

    return TrainState(params=tree("params/"),
                      opt=OptState(step=int(flat["opt/step"]), mu=tree("opt/mu/"),
                                   nu=tree("opt/nu/")))


def _mesh_sizes(flat: dict) -> tuple[int, int]:
    """(model_size, fsdp_size) read off the rest layout of the params (both
    dense (stack?, MODEL, FSDP, n) and wire (MODEL, FSDP, nbytes) leaves)."""
    for key, arr in flat.items():
        if key.startswith("params/"):
            return int(arr.shape[-3]), int(arr.shape[-2])
    raise ValueError("empty state")


def save_checkpoint(path: str, state: TrainState, meta: Optional[dict[str, Any]] = None) -> None:
    """Write `state` as a ``qsdp-ckpt-v2`` checkpoint under directory `path`."""
    os.makedirs(path, exist_ok=True)
    flat, leaves = state_to_flat(state)
    model_size, fsdp_size = _mesh_sizes(flat)
    manifest = {"format": FORMAT_V2,
                "mesh": {"model_size": model_size, "fsdp_size": fsdp_size},
                "leaves": leaves, "meta": meta or {}}
    np.savez(os.path.join(path, "state.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, device=None, mesh_sizes: tuple[int, int] = (1, 1)) -> TrainState:
    """Load a v1 or v2 checkpoint saved on the (model, fsdp) layout
    `mesh_sizes` onto `device` (the card unless given); raises on an unknown format, a manifest that
    does not match the payload, or another layout."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"checkpoint manifest missing: {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt not in (FORMAT_V1, FORMAT_V2):
        raise ValueError(f"unknown checkpoint format {fmt!r} in {mpath}; this build "
                         f"reads {[FORMAT_V1, FORMAT_V2]}")
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    leaves = manifest.get("leaves")
    if not isinstance(leaves, dict) or set(leaves) != set(flat):
        raise ValueError(f"corrupted checkpoint manifest in {path}: leaf set mismatch")
    for k, e in leaves.items():
        if list(flat[k].shape) != list(e["shape"]) or str(flat[k].dtype) != e["dtype"]:
            raise ValueError(f"corrupted checkpoint manifest in {path}: leaf {k!r} is "
                             f"{flat[k].shape}/{flat[k].dtype} on disk but "
                             f"{tuple(e['shape'])}/{e['dtype']} in the manifest")
    if fmt == FORMAT_V2:
        saved = (manifest["mesh"]["model_size"], manifest["mesh"]["fsdp_size"])
        if saved != tuple(mesh_sizes):
            raise NotImplementedError(
                f"checkpoint was saved on (model, fsdp) = {saved}, not {tuple(mesh_sizes)}: "
                "resharding is not ported yet (ROADMAP A3b)")
    return state_from_flat(flat, leaves, device)
