"""Failed-target rebuild: all-gather the surviving shards + RS decode.

Counterpart of ``tpu3fs/parallel/rebuild.py``. One EC-group member per
position of the shard axis; the survivors are gathered over that axis and
the lost rows are decoded by ``RSCode.reconstruct_fn``: kernel K3 (one pass
XOR) for a single loss covered by parity row 0, K1 otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.parallel.mesh import mesh_axis


def rebuild_lost_shard(
    mesh: DeviceMesh,
    local: torch.Tensor,
    rs: RSCode,
    lost_idx: Sequence[int],
    shard_axis: str = "chain",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Reconstruct the lost shard rows from the surviving ones.

    ``local``: (1, batch, S) uint8, this member's shard (rows at
    ``lost_idx`` hold garbage: the failed targets). With ``batch_axis``
    (the dp axis) the batch is sharded over it and ``local`` holds this dp
    row's slice: each dp row gathers and rebuilds only its own slice over
    its own shard-axis group. Returns (len(lost_idx), batch, S), the same
    on every member of the shard axis."""
    group, _, size = mesh_axis(mesh, shard_axis)
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no "
                         f"{batch_axis!r}")
    n = rs.k + rs.m
    if size != n:
        raise ValueError(f"mesh axis {shard_axis}={size} != k+m={n}")
    lost = tuple(int(i) for i in lost_idx)
    if len(lost) > rs.m:
        raise ValueError(f"cannot rebuild {len(lost)} shards with m={rs.m}")
    present = [i for i in range(n) if i not in lost][:rs.k]
    decode = rs.reconstruct_fn(present, lost)
    mine = local[0].contiguous()
    gathered = torch.empty((n * mine.shape[0], *mine.shape[1:]),
                           dtype=mine.dtype, device=mine.device)
    dist.all_gather_into_tensor(gathered, mine, group=group)
    # (n, batch, S) -> survivors as (batch, k, S), one copy
    surv = gathered.view(n, *mine.shape).movedim(0, -2)[..., present, :]
    return decode(surv).movedim(-2, 0).contiguous()  # (lost, batch, S)
