"""Failed-target rebuild: all-gather the surviving shards + RS decode.

Counterpart of ``tpu3fs/parallel/rebuild.py``. One EC-group member per
position of the shard axis; the survivors are gathered over that axis and
the lost rows are decoded by ``RSCode.reconstruct_fn``: kernel K3 (one pass
XOR) for a single loss covered by parity row 0, K1 otherwise. On a
process-group ``DeviceMesh`` the gather is an all-gather; on a
``LocalMesh`` the survivors are copied onto the decoding position's
device (the first lost shard's: the replacement target's).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.parallel.mesh import LocalMesh, mesh_axis, same_device


def _plan(rs: RSCode, size: int, shard_axis: str, lost_idx):
    """-> (lost, present): the lost rows and the k survivors decoded
    from, after the checks both mesh forms share."""
    n = rs.k + rs.m
    if size != n:
        raise ValueError(f"mesh axis {shard_axis}={size} != k+m={n}")
    lost = tuple(int(i) for i in lost_idx)
    if len(lost) > rs.m:
        raise ValueError(f"cannot rebuild {len(lost)} shards with m={rs.m}")
    present = [i for i in range(n) if i not in lost][:rs.k]
    return lost, present


def _local_rebuild(mesh: LocalMesh, shards: torch.Tensor, rs: RSCode,
                   lost_idx, shard_axis: str, batch_axis: Optional[str]):
    """``rebuild_lost_shard`` on a ``LocalMesh``. Without ``batch_axis``
    every row of the other axis holds the same shards and rebuilds the
    same rows, so row 0 decodes once; with it, row r decodes its slice of
    the batch. A row gathers its k survivors onto its decoding position's
    device (the first lost shard's), which must be the codec's."""
    other = next(a for a in mesh.axis_names if a != shard_axis)
    if batch_axis is not None and batch_axis != other:
        raise ValueError(f"mesh axes {mesh.axis_names}: batch axis "
                         f"{batch_axis!r} must be the one beside "
                         f"{shard_axis!r}")
    rows, size = mesh.axes(other, shard_axis)
    lost, present = _plan(rs, size, shard_axis, lost_idx)
    decode = rs.reconstruct_fn(present, lost)
    n, batch, S = shards.shape
    if n != size:
        raise ValueError(f"shards {tuple(shards.shape)}: want {size} rows")
    if batch_axis is None:
        rows = 1
    elif batch % rows:
        raise ValueError(f"batch {batch} does not split over {rows} rows")
    per = batch // rows
    at = lost[0] if lost else 0
    out = None
    for r in range(rows):
        dev = mesh.at(other, r, shard_axis, at)
        if not same_device(dev, rs.device):
            raise ValueError(f"decoding position on {dev}, codec on "
                             f"{rs.device}")
        lo, hi = r * per, (r + 1) * per
        surv = torch.empty((hi - lo, len(present), S), dtype=torch.uint8,
                           device=dev)
        for col, j in enumerate(present):  # the gather: one copy a survivor
            surv[:, col].copy_(shards[j, lo:hi])
        part = decode(surv).movedim(-2, 0)  # (lost, per, S)
        if out is None:
            out = torch.empty((len(lost), batch, S), dtype=torch.uint8,
                              device=dev)
        out[:, lo:hi].copy_(part)
    return out


def rebuild_lost_shard(
    mesh,
    local: torch.Tensor,
    rs: RSCode,
    lost_idx: Sequence[int],
    shard_axis: str = "chain",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Reconstruct the lost shard rows from the surviving ones.

    On a ``LocalMesh``: ``local`` is the global (k+m, batch, S) uint8, one
    shard row per position of the shard axis (rows at ``lost_idx`` hold
    garbage: the failed targets); with ``batch_axis`` (the dp axis) each
    row of that axis rebuilds its slice of the batch. Returns (lost,
    batch, S) on row 0's decoding device.

    On a process-group ``DeviceMesh``: ``local`` is (1, batch, S), this
    member's shard. With ``batch_axis`` the batch is sharded over it and
    ``local`` holds this dp row's slice: each dp row gathers and rebuilds
    only its own slice over its own shard-axis group. Returns
    (len(lost_idx), batch, S), the same on every member of the shard
    axis."""
    if isinstance(mesh, LocalMesh):
        return _local_rebuild(mesh, local, rs, lost_idx, shard_axis,
                              batch_axis)
    group, _, size = mesh_axis(mesh, shard_axis)
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no "
                         f"{batch_axis!r}")
    lost, present = _plan(rs, size, shard_axis, lost_idx)
    decode = rs.reconstruct_fn(present, lost)
    n = size
    mine = local[0].contiguous()
    gathered = torch.empty((n * mine.shape[0], *mine.shape[1:]),
                           dtype=mine.dtype, device=mine.device)
    dist.all_gather_into_tensor(gathered, mine, group=group)
    # (n, batch, S) -> survivors as (batch, k, S), one copy
    surv = gathered.view(n, *mine.shape).movedim(0, -2)[..., present, :]
    return decode(surv).movedim(-2, 0).contiguous()  # (lost, batch, S)
