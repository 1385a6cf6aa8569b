"""Process mesh for the storage data plane.

Counterpart of ``tpu3fs/parallel/mesh.py``. Two axes:

- ``dp``    striping: independent chunk batches spread over chain groups;
- ``chain`` replication/EC: one ring position per chain member.

Rank r sits at grid position ``(r // chain_len, r % chain_len)``, the
row-major layout of ``np.array(devices).reshape(n // chain_len, chain_len)``
in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu3fs_torch.device import resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process-group backend for tensors on ``device``: NCCL for CUDA,
    gloo for the CPU."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    return _BACKENDS[kind]


def make_storage_mesh(chain_len: int, device=None,
                      axis_names=("dp", "chain")) -> DeviceMesh:
    """Mesh of shape (world // chain_len, chain_len) over the initialised
    world. ``device`` defaults to ``cuda``; the default process group's
    backend must be ``backend_for(device)``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed.init_process_group first")
    want = backend_for(dev)
    if dist.get_backend() != want:
        raise ValueError(f"process group backend {dist.get_backend()} for "
                         f"{dev.type} tensors: want {want}")
    n = dist.get_world_size()
    if chain_len < 1 or n % chain_len != 0:
        raise ValueError(f"{n} ranks not divisible into chains of {chain_len}")
    return init_device_mesh(dev.type, (n // chain_len, chain_len),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh: DeviceMesh, name: str) -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's position, size) of mesh axis ``name``."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh axes {names} have no {name!r}")
    dim = names.index(name)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)
