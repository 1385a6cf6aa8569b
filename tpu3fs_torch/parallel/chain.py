"""CRAQ chain replication as a send/recv ring along the ``chain`` axis.

Counterpart of ``tpu3fs/parallel/chain.py``. A batch of chunk payloads
enters at the head (chain position 0) and flows one hop per step; every
member recomputes the checksum of what it received and compares it with
the head's, so a corrupted hop is detected as the reference's cross-check
does (src/storage/service/StorageOperator.cc:464-482). The JAX ring is a
``lax.ppermute`` per step. On a process-group ``DeviceMesh`` each step is
one ``batch_isend_irecv`` to the next position and from the previous one;
on a ``LocalMesh`` it is one copy onto the next position's device, into a
buffer of that position's own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu3fs_torch.ops.xor_fold import xor_fold_crc
from tpu3fs_torch.parallel.mesh import LocalMesh, mesh_axis, same_device


def _ring_propagate(payload: torch.Tensor, head_crc: torch.Tensor,
                    group: dist.ProcessGroup, idx: int, chain_len: int):
    """Push (payload, crc) from chain position 0 to every position, one hop
    per step, chain_len - 1 steps. Position 0 keeps its own copy; the
    others adopt what arrived."""
    nxt = dist.get_global_rank(group, (idx + 1) % chain_len)
    prv = dist.get_global_rank(group, (idx - 1) % chain_len)
    buf, crc = payload, head_crc
    for _ in range(chain_len - 1):
        got_buf, got_crc = torch.empty_like(buf), torch.empty_like(crc)
        ops = [dist.P2POp(dist.isend, buf, nxt, group),
               dist.P2POp(dist.isend, crc, nxt, group),
               dist.P2POp(dist.irecv, got_buf, prv, group),
               dist.P2POp(dist.irecv, got_crc, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if idx != 0:
            buf, crc = got_buf, got_crc
    return buf, crc


def _crc32(fold):
    def crc(x):  # carried and compared as int32: uint32 has few kernels
        return fold(x).view(torch.int32)
    return crc


def _hop(prev: torch.Tensor, buf: torch.Tensor, pos: int) -> None:
    """One hop of the local ring: position ``pos`` receives ``prev`` into
    its own ``buf`` (a test seam: a corrupted hop is a patched one)."""
    buf.copy_(prev)


def _local_write_step(mesh: LocalMesh, data: torch.Tensor, crc,
                      chain_axis: str, dp_axis: str):
    """``chain_write_step`` on a ``LocalMesh``: dp row r takes rows
    [r * b, (r + 1) * b) of the batch, b = batch // dp. Its head copies
    them in; each hop copies the previous position's buffer onto the next
    position's device, checksums it there and compares with the carried
    head checksum. The replicas are returned on the device of position
    (0, 0): a position on that device holds its copy in its own slot of
    the result, one on another device gives its copy back after its
    check."""
    dp, chain_len = mesh.axes(dp_axis, chain_axis)
    batch, size = data.shape
    if batch % dp:
        raise ValueError(f"batch {batch} does not split over {dp} dp rows")
    rows = batch // dp
    home = mesh.at(dp_axis, 0, chain_axis, 0)
    replicas = torch.empty((chain_len, batch, size), dtype=torch.uint8,
                           device=home)
    ok = torch.empty((chain_len, batch), dtype=torch.bool, device=home)
    for r in range(dp):
        lo, hi = r * rows, (r + 1) * rows
        prev, carried = data[lo:hi], None
        for pos in range(chain_len):
            dev = mesh.at(dp_axis, r, chain_axis, pos)
            at_home = same_device(dev, home)
            buf = (replicas[pos, lo:hi] if at_home
                   else torch.empty((rows, size), dtype=torch.uint8,
                                    device=dev))
            _hop(prev, buf, pos)
            if carried is None:  # the head: only it got the payload
                carried = crc(buf)
            else:
                carried = carried.to(dev)
            ok[pos, lo:hi] = (crc(buf) == carried).to(home)
            if not at_home:
                replicas[pos, lo:hi].copy_(buf)
            prev = buf
    return replicas, ok


def chain_write_step(
    mesh,
    local: torch.Tensor,
    crc_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    chain_axis: str = "chain",
    dp_axis: str = "dp",
):
    """Replicate a write batch down every chain of the mesh.

    On a ``LocalMesh``: ``local`` is the whole (batch, S) uint8 write
    batch, split over the ``dp`` rows as the JAX docstring says (each dp
    row an independent chain group); returns JAX's global shapes,
    (replicas (chain, batch, S), ok (chain, batch) bool), on the device
    of position (0, 0).

    On a process-group ``DeviceMesh``: ``local`` is this dp row's slice
    of the batch (the same on every chain position); returns this chain
    member's (replica (1, batch, S), ok (1, batch) bool): its stored copy
    and its checksum cross-check.

    ``crc_fn`` maps (batch, S) uint8 to (batch,) 32-bit checksums
    (``BatchCrc32c(S)`` runs K2 on the card); the default is
    ``xor_fold_crc`` (K4 on the card)."""
    crc = _crc32(crc_fn or xor_fold_crc)
    if isinstance(mesh, LocalMesh):
        return _local_write_step(mesh, local, crc, chain_axis, dp_axis)
    group, idx, chain_len = mesh_axis(mesh, chain_axis)

    # only the head actually received the client payload
    payload = local.contiguous() if idx == 0 else torch.zeros_like(local)
    head_crc = crc(payload)
    buf, carried = _ring_propagate(payload, head_crc, group, idx, chain_len)
    ok = crc(buf) == carried
    return buf[None], ok[None]


def chain_replicate(mesh: DeviceMesh, local: torch.Tensor, **kw):
    """chain_write_step returning the replica only."""
    replica, _ = chain_write_step(mesh, local, **kw)
    return replica
