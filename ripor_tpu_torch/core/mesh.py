"""The ('data', 'model') device mesh, on ``torch.distributed``.

Port of ripor_tpu/core/mesh.py. A JAX mesh is one process driving N
devices; here it is N ranks, one process each, over a
``torch.distributed.device_mesh.DeviceMesh`` of shape (data, model) with
``mesh_dim_names=("data", "model")``:

  * ``data``  — data parallelism: queries, corpus rows and batches split
                over it.
  * ``model`` — tensor parallelism: attention heads and d_ff split over
                it, the row-parallel output projections all-reduced over
                its group.

Rank r sits at data coordinate ``r // model`` and model coordinate
``r % model``, the layout of the JAX package's
``np.asarray(devices).reshape(data, model)``.

The functions that take a mesh are SPMD: every rank calls them with the
same global inputs and gets back the same global outputs, as a JAX
function over a mesh takes and returns global arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh geometry. ``data * model`` must equal the world size
    (the number of ranks, which plays the JAX package's device count)."""

    data: int = -1  # -1: infer (world_size // model)
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        model = self.model
        data = self.data
        if data == -1:
            if n_devices % model != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by model={model}")
            data = n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return MeshSpec(data=data, model=model)


def _device_type(device_type: Optional[str]) -> str:
    """"cuda" unless the caller asks for another; without CUDA a request
    for it raises."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ripor_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device_type='cpu' for a mesh of CPU ranks")
    return device_type


def create_mesh(spec: MeshSpec | None = None,
                device_type: Optional[str] = None):
    """A ('data', 'model') DeviceMesh over the ranks of the initialised
    process group (:func:`distributed_init`). With no group initialised
    this process is the whole world: a one-rank gloo group is started on
    an in-memory store (nothing listens on a port; a one-rank group runs
    no collective), and :func:`distributed_init` cannot follow it in this
    process."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    spec = (spec or MeshSpec()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, (spec.data, spec.model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def local_mesh(device_type: Optional[str] = None):
    """Data-parallel-only mesh over all ranks."""
    return create_mesh(MeshSpec(data=-1, model=1), device_type)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process to its world (maps to the reference's
    init_process_group, t5_pretrainer/evaluate.py:181-182). No-op for one
    process.

    ``num_processes`` and ``process_id`` default to torchrun's
    ``WORLD_SIZE`` and ``RANK``. ``coordinator_address``: "host:port"
    (rank 0 listens there), any ``torch.distributed`` init method
    ("tcp://...", "file://..."), or None for torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``. ``backend``: "nccl" (the default; one
    card a rank) or "gloo" (CPU ranks, or ranks that share one card)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised (create_mesh starts a "
            "one-rank group when none is): call distributed_init before "
            "the first create_mesh")
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        _device_type("cuda")
        backend = "nccl"
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(backend, init_method=init_method,
                            rank=process_id, world_size=num_processes)


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along ``axis`` (the JAX ``mesh.shape[axis]``)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def shard(mesh, *axes: Optional[str]) -> Tuple:
    """Placements for a tensor whose dimension i is split over mesh axis
    ``axes[i]`` (None: not split); the JAX ``NamedSharding(mesh,
    P(*axes))``. One placement per mesh dimension, as DTensor takes them."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    for dim, axis in enumerate(axes):
        if axis is not None:
            placements[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(placements)


def replicated(mesh) -> Tuple:
    return shard(mesh)


def data_sharded(mesh, ndim_tail: int = 0) -> Tuple:
    """Batch dim split over 'data', remaining dims replicated."""
    return shard(mesh, DATA_AXIS, *([None] * ndim_tail))


def _via_host(x: torch.Tensor, group) -> bool:
    """A gloo group (ranks that share one card, or CPU ranks) runs its
    collectives on host copies of CUDA tensors."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(y: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``y`` over ``group`` (None: ``y`` as it is), in
    y's dtype: the megatron all-reduce after a row-parallel projection
    (the JAX package's ``lax.psum`` over ``tp_axis``)."""
    if group is None or dist.get_world_size(group) == 1:
        return y
    if _via_host(y, group):
        h = y.cpu()
        dist.all_reduce(h, group=group)
        return y.copy_(h)
    dist.all_reduce(y, group=group)
    return y


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.cpu() if _via_host(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast_object(obj=None, group=None):
    """``obj`` as the world's first rank holds it, on every rank of
    ``group`` (None: the world; the group must hold rank 0): the SPMD
    stand-in for the JAX package's single controller, which alone sees a
    request. The object is pickled into a byte tensor on the host
    (``dist.broadcast_object_list``), so a gloo group carries it; other
    ranks pass anything (it is ignored). One process: ``obj``."""
    if process_count() == 1:
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (None: the world); one process:
    nothing."""
    if process_count() > 1:
        dist.barrier(group=group)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_first_process() -> bool:
    """Rank-0 gate (reference: utils/utils.py:6-7 ``is_first_worker``)."""
    return not dist.is_initialized() or dist.get_rank() == 0
