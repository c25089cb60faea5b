"""Checkpoints in the JAX package's format ``qsdp-ckpt-v2``: one npz payload
plus a JSON manifest (``train/checkpoint.py`` of the JAX package).

Every leaf is written in its rest layout; a :class:`QuantizedParam` leaf
is written AS its wire bytes (u8 codes + per-bucket scale/zero) with a
manifest entry naming its quantizer, so a quantized state resumes byte for
byte.  The manifest's ``format`` and every leaf's shape and dtype are
validated on load (``qsdp-ckpt-v1``, dense leaves only, loads too).  Both
packages read each other's checkpoints.

On a (P, M) mesh every rank holds its block of each leaf: the save
gathers the blocks over the data group (axis -2) and then the model group
(axis -3), and global rank 0 writes the whole state, the file the JAX
package writes from its (P, M) mesh (manifest ``mesh`` {model_size: M,
fsdp_size: P}); the load gives each rank its block.

A v2 checkpoint saved on another (model, fsdp) layout is resharded through
the logical parameter form, as the JAX package's ``load_checkpoint`` does:
each leaf goes through ``from_rest`` at the saved layout and ``to_rest`` at
the target one (the parameter's ``ParamSpec`` from the `model` argument),
and the rank takes its block.  Dense leaves come out bit-identical.  A
quantized leaf's buckets depend on the layout, so across layouts it is
refused unless the load is asked to decode (``dequantize=True``); it is
then decoded to its exact f32 values on the target device (by K2 on the
card) before the reshard.  A same-layout load keeps every byte.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core import collectives as coll
from ..core.qsdp import MeshSpec, from_rest, rank_block, to_rest
from ..core.quant import QuantConfig, QuantizedParam, qparam_decode
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


def _qparam(t: torch.Tensor, e: dict) -> QuantizedParam:
    cfg = QuantConfig(bits=e["bits"], bucket_size=e["bucket_size"], mode=e["mode"],
                      meta_dtype=e.get("meta_dtype", "float32"))
    return QuantizedParam(t, tuple(e["cell_shape"]), cfg)


def _build_state(keys, step: int, leaf) -> TrainState:
    """The TrainState of the npz keys `keys`, ``leaf(key)`` each leaf."""
    def tree(prefix):
        ks = [k for k in keys if k.startswith(prefix)]
        return {k[len(prefix):]: leaf(k) for k in ks} if ks else ()

    return TrainState(params=tree("params/"),
                      opt=OptState(step=step, mu=tree("opt/mu/"), nu=tree("opt/nu/")))


def state_from_flat(flat: dict[str, np.ndarray], leaves: dict[str, dict],
                    device=None) -> TrainState:
    """Inverse of :func:`state_to_flat`: tensors on `device` (the card
    unless given), quantized leaves as QuantizedParam with their bytes
    unchanged."""
    device = resolve_device(device)

    def leaf(key):
        e = leaves.get(key, {"kind": "dense"})
        t = torch.from_numpy(np.array(np.asarray(flat[key]))).to(device)
        return _qparam(t, e) if e.get("kind") == "quantized" else t

    return _build_state([k for k in flat if k != "opt/step"], int(flat["opt/step"]), leaf)


def _param_name(key: str) -> Optional[str]:
    for pre in ("params/", "opt/mu/", "opt/nu/"):
        if key.startswith(pre):
            return key[len(pre):]
    return None


def _mesh_sizes(flat: dict) -> tuple[int, int]:
    """(model_size, fsdp_size) read off the rest layout of the params (both
    dense (stack?, MODEL, FSDP, n) and wire (MODEL, FSDP, nbytes) leaves)."""
    for key, arr in flat.items():
        if key.startswith("params/"):
            return int(arr.shape[-3]), int(arr.shape[-2])
    raise ValueError("empty state")


def _gather_state(state: TrainState, group, axis: int) -> TrainState:
    """The group's blocks laid end to end on `axis` of each rest-layout leaf
    (dense or wire codes), the step as it is."""
    def whole(v):
        if isinstance(v, QuantizedParam):
            return QuantizedParam(coll.gather_axis(v.wire, group, axis), v.cell_shape, v.cfg)
        return coll.gather_axis(v.detach(), group, axis)

    def tree(t):
        return t if t == () else {k: whole(v) for k, v in t.items()}

    return TrainState(params=tree(state.params),
                      opt=OptState(step=state.opt.step, mu=tree(state.opt.mu),
                                   nu=tree(state.opt.nu)))


def save_checkpoint(path: str, state: TrainState, meta: Optional[dict[str, Any]] = None,
                    group=None, model_group=None) -> None:
    """Write `state` as a ``qsdp-ckpt-v2`` checkpoint under directory `path`.
    Over the groups (every rank calls it) the blocks are gathered over the
    data group and then the model group, and the rank at (0, 0) writes;
    every rank returns once the files are written."""
    if group is not None or model_group is not None:
        import torch.distributed as dist
        whole = state
        for grp, axis in ((group, -2), (model_group, -3)):
            if grp is not None:
                whole = _gather_state(whole, grp, axis)
        if coll.group_rank(group) == coll.group_rank(model_group) == 0:
            save_checkpoint(path, whole, meta)
        del whole
        # (0, 0) writes before its data group's barrier; every other rank
        # passes its model group's barrier only after its data rank's
        # model-rank-0 rank passed that one
        for grp in (group, model_group):
            if grp is not None:
                dist.barrier(group=grp)
        return
    os.makedirs(path, exist_ok=True)
    flat, leaves = state_to_flat(state)
    model_size, fsdp_size = _mesh_sizes(flat)
    manifest = {"format": FORMAT_V2,
                "mesh": {"model_size": model_size, "fsdp_size": fsdp_size},
                "leaves": leaves, "meta": meta or {}}
    np.savez(os.path.join(path, "state.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, device=None, mesh_sizes: tuple[int, int] = (1, 1),
                    rank: int = 0, model_rank: int = 0, model=None,
                    dequantize: bool = False) -> TrainState:
    """Load a v1 or v2 checkpoint onto `device` (the card unless given) for
    the (model, fsdp) layout `mesh_sizes`: the block of every leaf at data
    rank `rank` and model rank `model_rank`.  A v2 file saved on another
    layout is resharded, which needs `model` (its ``specs``); a quantized
    leaf then needs ``dequantize=True``, which decodes quantized leaves to
    f32 on any load.  Raises ValueError on an unknown format, a manifest
    that does not match the payload, a reshard without `model` or of a
    quantized leaf in wire form."""
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
    m, p = mesh_sizes
    saved = ((manifest["mesh"]["model_size"], manifest["mesh"]["fsdp_size"])
             if fmt == FORMAT_V2 else None)
    same = saved is None or saved == (m, p)
    if not same and model is None:
        raise ValueError(
            f"checkpoint was saved on (model={saved[0]}, fsdp={saved[1]}) but the target "
            f"mesh is (model={m}, fsdp={p}); resharding needs the `model` argument")
    if same and not dequantize:
        return state_from_flat({k: rank_block(a, rank, p, model_rank, m) if a.ndim >= 3
                                else a for k, a in flat.items()}, leaves, device)
    device = resolve_device(device)
    ms_src = None if same else MeshSpec(("data", "model"), (saved[1], saved[0]))
    ms_tgt = MeshSpec(("data", "model"), (p, m))

    def leaf(key):
        e = leaves.get(key, {"kind": "dense"})
        t = torch.from_numpy(np.array(flat[key]))
        if e.get("kind") == "quantized":
            if not dequantize:
                raise ValueError(
                    f"quantized leaf {key!r} cannot be resharded in wire form (bucket "
                    "boundaries are layout-dependent); load with dequantize=True — the "
                    "decoded values are bit-exact — and re-enter wire form with "
                    "quantize_train_state if desired")
            t = qparam_decode(_qparam(t.to(device), e))
        name = _param_name(key)
        if not same and name is not None:
            spec = model.specs[name]
            t = to_rest(from_rest(t, spec, ms_src), spec, ms_tgt)
        return (rank_block(t, rank, p, model_rank, m) if t.ndim >= 3 else t).to(device)

    return _build_state([k for k in flat if k != "opt/step"], int(flat["opt/step"]), leaf)
