"""CRAQ chain replication as a send/recv ring along the ``chain`` axis.

Counterpart of ``tpu3fs/parallel/chain.py``. A batch of chunk payloads
enters at the head (chain position 0) and flows one hop per step; every
member recomputes the checksum of what it received and compares it with
the head's, so a corrupted hop is detected as the reference's cross-check
does (src/storage/service/StorageOperator.cc:464-482). The JAX ring is a
``lax.ppermute`` per step; here each step is one ``batch_isend_irecv`` to
the next position and from the previous one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpu3fs_torch.parallel.mesh import mesh_axis


def _xor_fold_crc(chunks: torch.Tensor) -> torch.Tensor:
    """Cheap stand-in checksum, (B, S) uint8 -> (B,) uint32: the row's
    little-endian 32-bit words XOR-folded together (the row zero-padded to
    4 bytes). A halving tree of in-place int32 XORs: torch has no uint32
    arithmetic. Used when no ``crc_fn`` is given."""
    batch, size = chunks.shape
    pad = (-size) % 4
    if pad:
        chunks = F.pad(chunks, (0, pad))
    words = chunks.contiguous().view(torch.int32).clone()
    w = words.shape[1]
    if w == 0:
        return torch.zeros(batch, dtype=torch.int32,
                           device=chunks.device).view(torch.uint32)
    while w > 1:  # fold the top half onto the bottom; an odd middle stays
        h = w // 2
        words[:, :h].bitwise_xor_(words[:, w - h:w])
        w -= h
    return words[:, 0].contiguous().view(torch.uint32)


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


def chain_write_step(
    mesh: DeviceMesh,
    local: torch.Tensor,
    crc_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    chain_axis: str = "chain",
):
    """Replicate this rank's write batch down its chain.

    ``local``: (batch, S) uint8, this dp row's slice of the write batch (the
    same on every chain position). ``crc_fn`` maps (batch, S) uint8 to
    (batch,) 32-bit checksums (``BatchCrc32c(S)`` runs K2 on the card);
    the default is ``_xor_fold_crc``.

    Returns this chain member's (replica (1, batch, S), ok (1, batch)
    bool): its stored copy and its checksum cross-check."""
    group, idx, chain_len = mesh_axis(mesh, chain_axis)
    fold = crc_fn or _xor_fold_crc

    def crc(x):  # carried and compared as int32: uint32 has few kernels
        return fold(x).view(torch.int32)

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
