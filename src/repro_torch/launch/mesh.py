"""Meshes of the port (the JAX package's ``launch/mesh.py``).

``make_mesh_spec`` and ``make_small_spec`` describe a mesh and nothing
more: the dry run counts steps on the production meshes' specs without
forming any group.  :func:`init_distributed` forms the process group a
(P, 1) mesh trains over: P ranks on the FSDP (data) axis, one process a
rank, as ``torchrun`` starts them:

    torchrun --nproc_per_node P -m repro_torch.launch.train --data-par P ...

On the card it forms an NCCL group, each rank on ``cuda:LOCAL_RANK``; gloo
only when the CPU is asked for.  There is no fallback from one to the
other.  A model axis above 1 (ROADMAP A4b) and a "pod" axis (two-level
exchanges, A3b) are refused.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..core.qsdp import MeshSpec, check_mesh
from ..device import resolve_device


def make_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """The production mesh's spec: (16, 16) ("data", "model"), or (2, 16, 16)
    with a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes=axes, shape=shape)


def make_small_spec(data: int = 2, model: int = 4) -> MeshSpec:
    return MeshSpec(axes=("data", "model"), shape=(data, model))


def init_distributed(device=None, mesh: Optional[MeshSpec] = None, store=None,
                     rank: Optional[int] = None, world_size: Optional[int] = None):
    """Form the default process group of this rank and return ``(group,
    rank, device)``.  `rank` and `world_size` default to torchrun's
    ``RANK`` and ``WORLD_SIZE``, the card to ``cuda:LOCAL_RANK``; without
    `store` the group meets at torchrun's ``MASTER_ADDR:MASTER_PORT``.
    NCCL on the card (the default device), gloo when `device` is the CPU.
    `mesh`, where given, must be a (world size, 1) ("data", "model") mesh."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if mesh is not None:
        check_mesh(mesh)
        if mesh.fsdp_size != world_size:
            raise ValueError(f"mesh {dict(zip(mesh.axes, mesh.shape))} has {mesh.fsdp_size} "
                             f"FSDP ranks, the world {world_size}")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
        backend, kw = "nccl", {"device_id": device}
    elif device.type == "cpu":
        backend, kw = "gloo", {}
    else:
        raise ValueError(f"no process group runs on {device}")
    if not dist.is_initialized():
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, **kw)
    elif dist.get_backend() != backend or dist.get_world_size() != world_size:
        raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks "
                           f"is already formed, not {backend} over {world_size}")
    return dist.group.WORLD, dist.get_rank(), device
