"""Bulk shuffle (GraySort-style partition exchange) as all-to-all.

Counterpart of ``tpu3fs/parallel/shuffle.py``: one ``all_to_all_single``
over the ``dp`` axis's process group in place of ``lax.all_to_all``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu3fs_torch.parallel.mesh import mesh_axis


def shuffle_partitions(mesh: DeviceMesh, local: torch.Tensor,
                       axis: str = "dp") -> torch.Tensor:
    """Exchange partitions so member j of the axis ends with everyone's
    j-th partition.

    ``local``: (n * r, block, S), n the axis size: rows [j*r, (j+1)*r) are
    destined for member j. Returns the same shape, rows [i*r, (i+1)*r)
    received from member i."""
    group, _, n = mesh_axis(mesh, axis)
    if local.shape[0] % n:
        raise ValueError(f"{local.shape[0]} rows do not split over {n} ranks")
    x = local.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out
