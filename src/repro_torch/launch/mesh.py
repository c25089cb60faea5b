"""Meshes of the port (the JAX package's ``launch/mesh.py``).

``make_mesh_spec`` and ``make_small_spec`` describe a mesh and nothing
more: the dry run counts steps on the production meshes' specs without
forming any group.  :func:`init_distributed` forms the groups a (P, M)
("data", "model") mesh trains over: P·M ranks, one process a rank, as
``torchrun`` starts them:

    torchrun --nproc_per_node P·M -m repro_torch.launch.train \\
        --data-par P --model-par M ...

Global rank ``r = d·M + m`` sits at data rank d and model rank m, the
device order of the reference's ``Mesh(devices.reshape(P, M), ("data",
"model"))``.  Each rank's data group holds the P ranks of its m (the FSDP
exchanges), its model group the M ranks of its d (tensor parallelism).
On the card it forms NCCL groups, each rank on ``cuda:LOCAL_RANK``; gloo
only when the CPU is asked for.  There is no fallback from one to the
other.  A "pod" axis (two-level exchanges, ROADMAP A3b) is refused.
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
    """Form the default process group and this rank's groups of the (P, M)
    grid and return ``(data_group, model_group, (d, m), device)``.  `rank`
    and `world_size` default to torchrun's ``RANK`` and ``WORLD_SIZE``, the
    card to ``cuda:LOCAL_RANK``; without `store` the group meets at
    torchrun's ``MASTER_ADDR:MASTER_PORT``.  NCCL on the card (the default
    device), gloo when `device` is the CPU.  `mesh` (default: (world size,
    1)) must be a ("data", "model") mesh of the world's size.  Every rank
    forms every data group (same m) and then every model group (same d), in
    the same order, as ``new_group`` requires."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    mesh = mesh or MeshSpec(axes=("data", "model"), shape=(world_size, 1))
    check_mesh(mesh)
    p, m_size = mesh.fsdp_size, mesh.model_size
    if p * m_size != world_size:
        raise ValueError(f"mesh {dict(zip(mesh.axes, mesh.shape))} has {p * m_size} ranks, "
                         f"the world {world_size}")
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
    rank = dist.get_rank()
    d, m = divmod(rank, m_size)
    data = [dist.new_group([dd * m_size + mm for dd in range(p)]) for mm in range(m_size)]
    model = [dist.new_group([d2 * m_size + mm for mm in range(m_size)]) for d2 in range(p)]
    return data[m], model[d], (d, m), device
