"""Device meshes and process groups (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and starts no group.  The production meshes are JAX's: one pod
of 16 x 16 = 256 devices ``(data, model)``, or two pods ``(pod, data,
model)``.  A mesh needs an initialised default process group with as
many ranks as the mesh has devices; :func:`init_group` starts one
without fixing a port: a ``HashStore`` for a world of one, a
``FileStore`` at a path the caller names otherwise (the processes of one
group name the same file).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
GROUP_TIMEOUT_S = 120


def init_group(backend: Optional[str] = None, *, rank: int = 0,
               world_size: int = 1,
               store_path: Optional[str] = None) -> None:
    """Start the default process group: ``backend`` ``"nccl"`` (the
    card; rank ``r`` takes ``cuda:r``) or ``"gloo"`` (the CPU), by
    default NCCL when a card is there.  A world of one may leave
    ``store_path`` out (an in-memory ``HashStore``); a larger world
    needs the path of a file all its ranks share."""
    import datetime
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if store_path is None:
        if world_size != 1:
            raise ValueError("a group of more than one process needs a "
                             "store_path all its ranks share")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def close_group() -> None:
    """Destroy the default process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type(device_type: Optional[str]) -> str:
    """``device_type``, or the one the default group's backend drives."""
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group's ranks in order (rank ``r`` at the row-major coordinate of
    ``r``), on ``device_type`` (default: what the group's backend
    drives)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group "
                           "(repro_torch.launch.mesh.init_group)")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The 256-device ``(data, model)`` mesh, or with ``multi_pod`` the
    512-device ``(pod, data, model)`` one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


__all__ = ["GROUP_TIMEOUT_S", "init_group", "close_group", "make_mesh",
           "make_production_mesh"]
