"""ICI chain replication as a SERVING mode.

The port's own copy of ``tpu3fs/storage/ici_chain.py``.
``tpu3fs_torch.parallel.chain.chain_write_step`` on a ``LocalMesh`` is
the collective form of CRAQ's head->tail fan-out (ref
src/storage/service/StorageOperator.cc:333-514): a staged batch enters at
ring position 0 and flows one device-to-device copy a hop, with a carried
checksum (kernel K4 on the card) cross-checked at every position. When a
chain's targets all live on this node and the chain's writer count
matches the mesh's ``chain`` axis, ``_handle_batch_update`` hands the
staged batch to ``IciChainReplicator.try_replicate`` INSTEAD of the
per-hop messenger forward. Every successor position installs the
collective's delivered payload through the normal engine stage+commit
(same versions, same COW offset semantics, same checksum cross-check
against the head's staged CRC; the engines take their CRCs with K2 on the
card), so the committed state is byte-identical to the messenger path.

Anything the collective cannot express — non-local successors, SYNCING
members (full-replace installs), a chain wider than the mesh axis — falls
back to the messenger, mirroring how the reference falls from RDMA to TCP.

The JAX package pads the batch to powers of two (XLA compiles once a
shape bucket); the port pads only to a row count the ``dp`` axis divides
and to the longest row. Zero padding is inert for the fold checksum and
sliced off at install.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu3fs_torch.parallel.mesh import LocalMesh
from tpu3fs_torch.utils.result import Code


class IciChainReplicator:
    def __init__(self, mesh: LocalMesh, chain_axis: str = "chain",
                 dp_axis: str = "dp"):
        if not isinstance(mesh, LocalMesh):
            raise TypeError(f"the ICI transport runs on a LocalMesh, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.chain_axis = chain_axis
        self.dp_axis = dp_axis
        self.hits = 0
        self.fallbacks = 0
        self._count_lock = threading.Lock()

    def _fallback(self) -> Tuple[bool, None]:
        with self._count_lock:
            self.fallbacks += 1
        return False, None

    def try_replicate(
        self, service, target, reqs, staged, chain
    ) -> Tuple[bool, Optional[List]]:
        """-> (handled, replies). `replies` follows _forward_batch's
        contract (one reply per staged op, or None when this target is
        the chain tail). handled=False => caller uses the messenger."""
        from tpu3fs_torch.mgmtd.types import PublicTargetState

        writers = chain.writer_chain()
        if len(writers) < 2:
            return True, None  # single-writer chain: head IS the tail
        if writers[0].target_id != target.target_id:
            return self._fallback()  # collective mode engages at the head
        if len(writers) != self.mesh.shape.get(self.chain_axis):
            return self._fallback()
        succs = []
        for t in writers[1:]:
            local = service.target(t.target_id)
            if local is None or not t.public_state.can_write:
                return self._fallback()
            if t.public_state != PublicTargetState.SERVING:
                return self._fallback()  # SYNCING => full-replace semantics
            succs.append(local)

        # SUCCESSOR LOCKS: the messenger path runs every successor install
        # under that target's own per-chunk locks (its
        # _handle_batch_update), excluding interleavings with concurrently
        # forwarded truncate/remove/full-replace on the same chunks. The
        # collective path installs into successor engines DIRECTLY, so it
        # must take the same locks itself: every (successor target, chunk)
        # key, acquired in the one global sorted key order all batch paths
        # use — no lock-order inversion against batch_write_shard /
        # _handle_batch_update on those targets.
        succ_keys = sorted({
            service._chunk_key(succ.target_id, reqs[ri].chunk_id)
            for succ in succs
            for ri, _ver, _cs, _fr in staged
        })
        for key in succ_keys:
            service._locks.acquire(key)
        try:
            # membership re-check UNDER the locks (the data-path race
            # rule, ref StorageOperator.cc:377-382): a member flipping
            # out of SERVING between the check above and here means
            # full-replace semantics we cannot express — fall back to the
            # messenger before touching any successor engine
            chain2 = service._chain(chain.chain_id)
            writers2 = chain2.writer_chain()
            if (chain2.chain_version != chain.chain_version
                    or [t.target_id for t in writers2]
                    != [t.target_id for t in writers]
                    or any(t.public_state != PublicTargetState.SERVING
                           for t in writers2[1:])):
                return self._fallback()
            return self._replicate_locked(service, reqs, staged, chain,
                                          succs)
        finally:
            for key in reversed(succ_keys):
                service._locks.release(key)

    def _payload(self, rows) -> torch.Tensor:
        """The staged rows as one zero-padded (nrows, width) batch on the
        head position's device, nrows the least multiple of the ``dp``
        axis that holds them."""
        width = max(len(r) for r in rows)
        dp = self.mesh.shape.get(self.dp_axis, 1)
        nrows = -(-len(rows) // dp) * dp
        buf = np.zeros((nrows, width), dtype=np.uint8)
        for r, data in enumerate(rows):
            buf[r, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        head = self.mesh.at(self.dp_axis, 0, self.chain_axis, 0)
        return torch.from_numpy(buf).to(head)

    def _replicate_locked(self, service, reqs, staged, chain, succs):
        from tpu3fs_torch.parallel.chain import chain_write_step
        from tpu3fs_torch.storage.craq import UpdateReply
        from tpu3fs_torch.storage.engine import EngineUpdateOp

        payload = self._payload([reqs[i].data for i, _v, _c, _f in staged])
        replicas, ok = chain_write_step(self.mesh, payload,
                                        chain_axis=self.chain_axis,
                                        dp_axis=self.dp_axis)
        # the successors' copies only: the head keeps its own staged data
        replicas = replicas[1:].cpu().numpy()
        ok = ok.cpu().numpy()

        n = len(staged)
        replies: List[Optional[UpdateReply]] = [None] * n
        # a hop that failed its cross-check anywhere down the ring fails
        # its op before ANY successor installs it (the JAX package installs
        # position by position and so commits the good copies upstream of
        # a corrupt hop: a version the head never commits)
        for i in range(n):
            bad = np.flatnonzero(~ok[1:len(succs) + 1, i])
            if bad.size:
                replies[i] = UpdateReply(
                    Code.CHUNK_CHECKSUM_MISMATCH,
                    message=f"ICI hop corrupt at position {bad[0] + 1}")
        for j, succ in enumerate(succs, start=1):
            ops = []
            op_idx = []
            for i, (ri, ver, cs, _fr) in enumerate(staged):
                if replies[i] is not None:
                    continue  # failed a hop, or at an earlier position
                req = reqs[ri]
                data = replicas[j - 1, i, : len(req.data)].tobytes()
                ops.append(EngineUpdateOp(
                    chunk_id=req.chunk_id, data=data, offset=req.offset,
                    update_ver=ver, full_replace=req.full_replace,
                    chunk_size=req.chunk_size or succ.chunk_size))
                op_idx.append(i)
            results = succ.engine.batch_update(ops, chain.chain_version) \
                if ops else []
            commit_items = []
            commit_slots = []
            for i, res in zip(op_idx, results):
                ri, ver, cs, is_fr = staged[i]
                if res.code == Code.CHUNK_STALE_UPDATE:
                    replies[i] = replies[i] or UpdateReply(
                        Code.OK, update_ver=ver, commit_ver=res.ver,
                        checksum=res.checksum)
                    continue
                if not res.ok:
                    replies[i] = UpdateReply(res.code,
                                             message="ICI stage failed")
                    continue
                succ_cs = res.checksum
                if not is_fr and succ_cs.value != cs.value:
                    replies[i] = UpdateReply(
                        Code.CHUNK_CHECKSUM_MISMATCH,
                        message=(f"ICI position {j} "
                                 f"{succ_cs.value:#x} != head {cs.value:#x}"))
                    continue
                if is_fr:
                    if j == len(succs):
                        replies[i] = UpdateReply(
                            Code.OK, update_ver=ver, commit_ver=ver,
                            checksum=succ_cs)
                    continue
                commit_items.append((reqs[ri].chunk_id, ver))
                commit_slots.append((i, ver, succ_cs))
            if commit_items:
                commit_res = succ.engine.batch_commit(
                    commit_items, chain.chain_version)
                for (i, ver, succ_cs), cr in zip(commit_slots, commit_res):
                    if not cr.ok:
                        replies[i] = UpdateReply(
                            cr.code, message="ICI commit failed")
                    elif j == len(succs):
                        # the TAIL's replies are what the head cross-checks
                        replies[i] = UpdateReply(
                            Code.OK, update_ver=ver, commit_ver=cr.ver,
                            checksum=succ_cs)
        with self._count_lock:
            self.hits += 1
        for i in range(n):
            if replies[i] is None:  # no tail reply materialized: refuse
                replies[i] = UpdateReply(
                    Code.ENGINE_ERROR, message="ICI replication incomplete")
        return True, replies
