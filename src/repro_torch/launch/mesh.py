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
other.

A (Q, D, M) ("pod", "data", "model") mesh, as the reference's scripts
reach it (the train launcher builds ("data", "model") meshes only, as the
reference's does), puts global rank ``r = q·D·M + d·M + m`` at (q, d, m):
pod-major, the reference's ``Mesh(devices.reshape(Q, D, M), ...)`` order,
and torchrun's too, which numbers a node's processes contiguously, so a
pod is a node's ranks.  Its FSDP index is data-major, ``d·Q + q``; the
flat FSDP group (the Q·D ranks of its m) runs its exchanges in that order
(it is returned as a ``collectives.OrderedGroup``), and two more groups carry the two-level
exchanges: the pod group (the Q ranks of its (d, m)) and the inner group
(the D ranks of its (q, m)).  Under torchrun on gloo:

    torchrun --nproc_per_node Q·D·M my_script.py    # calls, on every rank,
    init_distributed("cpu", MeshSpec(("pod", "data", "model"), (Q, D, M)))
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..core import collectives as coll
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
    grid and return ``(data_group, model_group, (d, m), device)``; on a (Q,
    D, M) pod mesh ``(fsdp_group, model_group, (q, d, m), device,
    pod_group, inner_group)``.  `rank` and `world_size` default to
    torchrun's ``RANK`` and ``WORLD_SIZE``, the card to
    ``cuda:LOCAL_RANK``; without `store` the group meets at torchrun's
    ``MASTER_ADDR:MASTER_PORT``.  NCCL on the card (the default device),
    gloo when `device` is the CPU.  `mesh` (default: (world size, 1)) must
    be a mesh of the world's size.  Every rank forms every group of each
    kind in the same order, as ``new_group`` requires: the FSDP groups
    (same m), on a pod mesh then the inner groups (same (q, m)) and the pod
    groups (same (d, m)), then the model groups."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    mesh = mesh or MeshSpec(axes=("data", "model"), shape=(world_size, 1))
    check_mesh(mesh)
    q_size, d_size, m_size = mesh.pod_size, mesh.data_size, mesh.model_size
    p = q_size * d_size
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
    q, rest = divmod(rank, d_size * m_size)
    d, m = divmod(rest, m_size)

    def at(qq, dd, mm):
        return (qq * d_size + dd) * m_size + mm

    # each FSDP group in its data-major order (index d·Q + q); new_group
    # sorts its ranks into pod-major order (q·D + d), so the group returned
    # carries the order
    orders = [[at(qq, dd, mm) for dd in range(d_size) for qq in range(q_size)]
              for mm in range(m_size)]
    fsdp = coll.ordered_group([dist.new_group(order) for order in orders][m],
                              [sorted(orders[m]).index(r) for r in orders[m]])
    inner = pod = None
    if mesh.multi_pod:
        inner = [[dist.new_group([at(qq, dd, mm) for dd in range(d_size)])
                  for mm in range(m_size)] for qq in range(q_size)][q][m]
        pod = [[dist.new_group([at(qq, dd, mm) for qq in range(q_size)])
                for mm in range(m_size)] for dd in range(d_size)][d][m]
    model = [[dist.new_group([at(qq, dd, mm) for mm in range(m_size)])
              for dd in range(d_size)] for qq in range(q_size)][q][d]
    if mesh.multi_pod:
        return fsdp, model, (q, d, m), device, pod, inner
    return fsdp, model, (d, m), device
