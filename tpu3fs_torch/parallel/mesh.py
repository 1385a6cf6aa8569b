"""Device meshes for the storage data plane.

Counterpart of ``tpu3fs/parallel/mesh.py``. Two axes:

- ``dp``    striping: independent chunk batches spread over chain groups;
- ``chain`` replication/EC: one ring position per chain member.

Two forms. Given ``devices``, ``make_storage_mesh`` returns a
``LocalMesh``: one process driving a grid of ``torch.device``s, as the
JAX package's ``Mesh`` is one process driving a grid of devices (the
in-process fabric's ICI transport and the EC mesh rebuild use it). A hop
is a device-to-device copy: a peer copy over NVLink between cards, a copy
within one card when positions share it. Without ``devices`` it returns
a process-group ``DeviceMesh`` over the initialised world, one rank a
position. Either way position ``(r // chain_len, r % chain_len)`` holds
device (or rank) r, the row-major layout of
``np.array(devices).reshape(n // chain_len, chain_len)`` in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


class LocalMesh:
    """A (rows, cols) grid of devices driven by this one process.

    ``shape`` maps each axis name to its size, in axis order, as a JAX
    ``Mesh``'s does; ``grid[row][col]`` is the device at a grid
    position. Devices may repeat: positions that share a card hold
    separate buffers on it."""

    def __init__(self, devices: Sequence, chain_len: int,
                 axis_names=("dp", "chain")):
        devs = [torch.device(d) for d in devices]
        n = len(devs)
        if chain_len < 1 or n % chain_len != 0:
            raise ValueError(
                f"{n} devices not divisible into chains of {chain_len}")
        if len(axis_names) != 2:
            raise ValueError(f"axis names {axis_names}: want two")
        self.axis_names = tuple(str(a) for a in axis_names)
        self.grid: List[List[torch.device]] = [
            devs[r:r + chain_len] for r in range(0, n, chain_len)]
        self.shape: Dict[str, int] = {self.axis_names[0]: n // chain_len,
                                      self.axis_names[1]: chain_len}

    def axes(self, row_axis: str, col_axis: str) -> Tuple[int, int]:
        """(rows, cols) with ``row_axis`` along the grid's first index and
        ``col_axis`` along its second: the grid's own order, or its
        transpose when the names are swapped."""
        if (row_axis, col_axis) not in (self.axis_names,
                                        self.axis_names[::-1]):
            raise ValueError(f"mesh axes {self.axis_names} are not "
                             f"({row_axis!r}, {col_axis!r})")
        return self.shape[row_axis], self.shape[col_axis]

    def at(self, row_axis: str, i: int, col_axis: str, j: int
           ) -> torch.device:
        """The device at index i of ``row_axis`` and j of ``col_axis``."""
        self.axes(row_axis, col_axis)
        if row_axis == self.axis_names[0]:
            return self.grid[i][j]
        return self.grid[j][i]


def require_local_mesh(mesh, what: str, item: str) -> None:
    """Raise unless ``mesh`` is None or a ``LocalMesh``: ``what`` runs in
    this one process, and a process-group mesh's collectives need one
    process a rank (ROADMAP ``item``, the four-card cell)."""
    if mesh is not None and not isinstance(mesh, LocalMesh):
        raise NotImplementedError(
            f"{what} over a {type(mesh).__name__}: it runs in one process "
            "on a LocalMesh (make_storage_mesh(..., devices=...)); the "
            f"form with one process a rank waits for ROADMAP {item}'s "
            "four-card cell")


def same_device(a: torch.device, b: torch.device) -> bool:
    """True when a and b name one device (``cuda`` is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def make_storage_mesh(chain_len: int, devices=None,
                      axis_names=("dp", "chain"), *, device=None):
    """Mesh of shape (n // chain_len, chain_len).

    With ``devices`` (a list of ``torch.device`` or device strings,
    repeats allowed), the ``LocalMesh`` over them in row-major order.
    Without, the process-group ``DeviceMesh`` over the initialised world:
    ``device`` defaults to ``cuda``, and the default process group's
    backend must be ``backend_for(device)``."""
    if devices is not None:
        if device is not None:
            raise ValueError("give devices or device, not both")
        return LocalMesh(list(devices), chain_len, axis_names)
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
