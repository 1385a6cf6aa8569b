"""Recovery sender: chunkmeta diff + full-chunk-replace stream + sync-done.

The port's own copy of ``tpu3fs/storage/resync.py``,
unchanged but for its imports.

Re-expresses src/storage/sync/ResyncWorker.cc:101-460 and design_notes "Data
recovery": for every chain where this node's target is SERVING and the next
writer is SYNCING, the predecessor (a) asks the successor to dump its chunk
metadata, (b) diffs against its own committed chunks, (c) transfers stale or
missing chunks as full-chunk-replace writes under the chunk lock, (d) removes
successor chunks that no longer exist locally, then (e) sends sync-done so the
successor reports up-to-date in its next heartbeat.
"""

from __future__ import annotations

import time
from typing import List

from tpu3fs_torch.mgmtd.types import PublicTargetState, RoutingInfo
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.storage.craq import Messenger, StorageService, UpdateReply, WriteReq
from tpu3fs_torch.storage.types import ChunkMeta
from tpu3fs_torch.utils.result import Code


class ResyncWorker:
    #: bounded OVERLOADED retries per chunk before deferring it to the
    #: next resync round (recovery is idempotent; skipping is safe)
    MAX_SHED_RETRIES = 4

    def __init__(self, service: StorageService, messenger: Messenger):
        self._service = service
        self._messenger = messenger

    def run_once(self) -> int:
        """One resync round over all local chains. Returns chunks
        transferred. Traffic is tagged RESYNC (tpu3fs/qos) so the
        successor's update workers schedule it behind foreground writes;
        OVERLOADED sheds are honored by backing off for the server's
        retry-after hint — the worker throttles ITSELF under pressure
        instead of retrying blind."""
        with tagged(TrafficClass.RESYNC):
            return self._run_once_tagged()

    def _run_once_tagged(self) -> int:
        routing: RoutingInfo = self._service._routing()
        transferred = 0
        for chain in routing.chains.values():
            if chain.is_ec:
                # EC members hold DIFFERENT shards — copying a peer's shard
                # would corrupt the recovering target; EC recovery is the
                # decode rebuild in tpu3fs/storage/ec_resync.py
                continue
            writers = chain.writer_chain()
            for i, t in enumerate(writers[:-1]):
                if t.target_id not in {
                    tt.target_id for tt in self._service.targets()
                }:
                    continue
                if t.public_state != PublicTargetState.SERVING:
                    continue
                succ = writers[i + 1]
                if succ.public_state != PublicTargetState.SYNCING:
                    continue
                node = routing.node_of_target(succ.target_id)
                if node is None:
                    continue
                transferred += self._sync_one(
                    chain.chain_id, chain.chain_version, t.target_id,
                    succ.target_id, node.node_id,
                )
        return transferred

    def _sync_one(
        self,
        chain_id: int,
        chain_ver: int,
        local_target_id: int,
        succ_target_id: int,
        succ_node_id: int,
    ) -> int:
        target = self._service.target(local_target_id)
        engine = target.engine
        # (a) dump-chunkmeta from the successor (ref syncStart, cc:163-180)
        succ_metas: List[ChunkMeta] = self._messenger(
            succ_node_id, "dump_chunkmeta", succ_target_id
        )
        succ_by_id = {m.chunk_id: m for m in succ_metas}
        local = [m for m in engine.all_metadata() if m.committed_ver > 0]
        local_ids = {m.chunk_id for m in local}
        moved = 0
        # (b+c) transfer missing/stale chunks as full-chunk-replace
        for meta in local:
            have = succ_by_id.get(meta.chunk_id)
            if (
                have is not None
                and have.committed_ver == meta.committed_ver
                and have.checksum.value == meta.checksum.value
            ):
                continue
            with self._service._chunk_lock(local_target_id, meta.chunk_id):
                cur = engine.get_meta(meta.chunk_id)
                if cur is None or cur.committed_ver == 0:
                    continue
                content = engine.read(meta.chunk_id)
                req = WriteReq(
                    chain_id=chain_id,
                    chain_ver=chain_ver,
                    chunk_id=meta.chunk_id,
                    offset=0,
                    data=content,
                    chunk_size=target.chunk_size,
                    update_ver=cur.committed_ver,
                    full_replace=True,
                    from_target=local_target_id,
                )
            reply: UpdateReply = self._send_throttled(succ_node_id, req)
            if reply.code == Code.OK:
                moved += 1
        # (d) drop successor chunks that no longer exist on the predecessor
        for meta in succ_metas:
            if meta.chunk_id not in local_ids:
                self._messenger(
                    succ_node_id, "remove_chunk", (succ_target_id, meta.chunk_id)
                )
        # (e) sync-done
        self._messenger(succ_node_id, "sync_done", succ_target_id)
        return moved

    def _send_throttled(self, succ_node_id: int, req: WriteReq) -> UpdateReply:
        """Send one recovery update, honoring OVERLOADED sheds with the
        server's retry-after hint (bounded; a still-overloaded successor
        defers this chunk to the next round)."""
        reply: UpdateReply = self._messenger(succ_node_id, "update", req)
        for _ in range(self.MAX_SHED_RETRIES):
            if reply.code != Code.OVERLOADED:
                break
            from tpu3fs_torch.qos.core import retry_after_ms_of

            hint = reply.retry_after_ms or retry_after_ms_of(reply.message)
            time.sleep(max(hint, 10) / 1000.0)
            reply = self._messenger(succ_node_id, "update", req)
        return reply
