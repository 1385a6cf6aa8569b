"""EC rebuild worker: reconstruct a recovering target's shards on device.

The port's own copy of ``tpu3fs/storage/ec_resync.py``: the worker's
``device`` runs the decode (K1, or K3 for a single loss) and the rebuilt
shards' CRCs (K2). With a ``LocalMesh`` the decode runs inside
``parallel.rebuild.rebuild_lost_shard`` over it (the survivors gathered
onto the decoding position's device); a process-group ``DeviceMesh``
raises ``NotImplementedError``: the worker runs in one process (ROADMAP
M7/M8).

The CR chains recover by full-chunk-replace copying from a chain peer
(tpu3fs/storage/resync.py, ref src/storage/sync/ResyncWorker.cc). EC chains
have no replica to copy from — the recovering target's shard of every stripe
is REBUILT from any k surviving shards with one batched GF(2) bit-matmul
(the BASELINE.json "rebuild 14 TiB < 5 min" path):

  1. union the stripe lists of the serving peers (dump-chunkmeta),
  2. for each batch of stripes, read k surviving shards per stripe,
  3. one batched RSCode.reconstruct on device rebuilds the lost shard rows,
  4. install each rebuilt shard on the recovering target (write_shard,
     trimmed back to its stored extent), then sync-done.

Any SERVING node of the chain can run the rebuild for a SYNCING member;
the worker is driven off routing exactly like the CR resync worker.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.mgmtd.types import ChainInfo, PublicTargetState, RoutingInfo
from tpu3fs_torch.parallel.mesh import require_local_mesh
from tpu3fs_torch.storage.craq import Messenger, ReadReq, ShardWriteReq, StorageService
from tpu3fs_torch.storage.types import ChunkId, ChunkMeta
from tpu3fs_torch.utils.result import Code, FsError


class EcResyncWorker:
    def __init__(self, service: StorageService, messenger: Messenger, *,
                 batch_stripes: int = 64, mesh=None, device=None):
        from tpu3fs_torch.monitor.recorder import CounterRecorder, ValueRecorder

        require_local_mesh(mesh, "EcResyncWorker's mesh rebuild", "M7/M8")
        # optional device mesh: rebuild through parallel.rebuild's gather
        self._mesh = mesh
        self.device = resolve_device(device)
        if service.device != self.device:
            raise ValueError(f"worker on {self.device}, service on "
                             f"{service.device}")
        self._service = service
        self._messenger = messenger
        self._batch = batch_stripes
        # tagged with the node (the JAX package's copy is untagged): the
        # node that coordinated a rebuild is the one that decoded on its
        # device
        tags = {"node": str(service.node_id)}
        self._rebuilt_shards = CounterRecorder("ec.rebuild_shards", tags)
        self._rebuilt_bytes = CounterRecorder("ec.rebuild_bytes", tags)
        self._rebuild_mibps = ValueRecorder("ec.rebuild_mibps", tags)
        # last completed rebuild round, for admin_cli ec-status and the
        # bench's source-spread verification: recovery reads per SOURCE
        # target prove the source-disjoint rotation actually spreads load
        self.last_stats: Dict = {
            "stripes": 0, "installed": 0, "bytes": 0,
            "read_sources": {}, "mibps": 0.0}
        self._round_stats: Dict = dict(self.last_stats,
                                       read_sources={})
        # healthy-repair memo: per chain, the pending signature of the last
        # sweep that committed nothing. A pending set that can never reach
        # the roll-forward quorum (e.g. a phase-1 crash that staged < k
        # shards) would otherwise re-trigger the full version gather every
        # round forever; such orphans are reclaimed when their stripe is
        # next overwritten (staging displaces older pendings).
        self._repair_memo: Dict[int, frozenset] = {}

    def run_once(self) -> int:
        """One rebuild round over all local EC chains; returns shards
        moved. Traffic is tagged EC_REBUILD (tpu3fs/qos): rebuild reads
        go through the per-class read gate and shard installs schedule
        behind foreground writes; OVERLOADED sheds defer work to the next
        round (the rebuild is idempotent and resumable)."""
        from tpu3fs_torch.qos.core import TrafficClass, tagged

        with tagged(TrafficClass.EC_REBUILD):
            return self._run_once_tagged()

    def _run_once_tagged(self) -> int:
        routing: RoutingInfo = self._service._routing()
        local_ids = {t.target_id for t in self._service.targets()}
        moved = 0
        for chain in routing.chains.values():
            if not chain.is_ec:
                continue
            syncing = [t for t in chain.targets
                       if t.public_state == PublicTargetState.SYNCING]
            if not syncing:
                serving = chain.serving_targets()
                if (serving and serving[0].target_id in local_ids
                        and len(serving) == len(chain.targets)):
                    moved += self._repair_healthy(routing, chain)
                continue
            # the first serving member acts as rebuild coordinator (one
            # recovery driver per chain, mirroring the CR predecessor
            # rule); a chain with NO serving members — every target
            # degraded after cascading bounces — falls to the first chain
            # member, or recovery could never start anywhere
            serving = chain.serving_targets()
            coordinator = (serving[0] if serving else chain.targets[0])
            if coordinator.target_id not in local_ids:
                continue
            for t in syncing:
                moved += self._rebuild_target(routing, chain, t.target_id)
        return moved

    # -- one recovering target ------------------------------------------------
    def _rebuild_target(self, routing: RoutingInfo, chain: ChainInfo,
                        target_id: int) -> int:
        k, m = chain.ec_k, chain.ec_m
        lost_shard = chain.shard_index(target_id)
        node = routing.node_of_target(target_id)
        if node is None:
            return 0
        # stripe inventory: serving peers' stripes are REQUIRED (promotion
        # blocks until each rebuilds); reachable degraded peers contribute
        # best-effort entries — rebuilt when provable, never promotion-
        # blocking (a single-shard residue of a failed write must not
        # wedge sync_done)
        stripes: Dict[bytes, ChunkId] = {}
        required: set = set()
        # per-stripe, per-shard (committed_ver, pending_ver) — feeds the
        # roll-forward of partial two-phase commits
        vers: Dict[bytes, Dict[int, tuple]] = {}
        serving_dumps = 0
        total_dumps = 0
        serving_ids = {t.target_id for t in chain.serving_targets()}
        for t in chain.targets:
            if t.target_id == target_id:
                continue
            pn = routing.node_of_target(t.target_id)
            if pn is None:
                continue
            try:
                metas: List[ChunkMeta] = self._messenger(
                    pn.node_id, "dump_chunkmeta", t.target_id)
            except FsError:
                continue
            total_dumps += 1
            if t.target_id in serving_ids:
                serving_dumps += 1
            shard_j = chain.shard_index(t.target_id)
            for meta in metas:
                key = meta.chunk_id.to_bytes()
                if meta.committed_ver > 0 or meta.pending_ver > 0:
                    vers.setdefault(key, {})[shard_j] = (
                        meta.committed_ver, meta.pending_ver)
                if meta.committed_ver > 0:
                    stripes[key] = meta.chunk_id
                    if t.target_id in serving_ids:
                        required.add(key)
        if serving_dumps == 0:
            # no serving peer's inventory is visible. With enough degraded
            # peers REACHABLE (answering dumps), committed k-quorums still
            # PROVE stripes — treat those as required and recover; with
            # fewer than k reachable peers nothing can be proven and
            # promotion would be hollow: stay SYNCING. The bar counts
            # RESPONDING PEERS, not shards seen in stripes: an empty
            # all-degraded chain (zero stripes anywhere) must fall through
            # to the empty-promotion below, or it wedges forever.
            if total_dumps < k:
                return 0
            for key, shard_vers in vers.items():
                counts: Dict[int, int] = {}
                for cv, _pv in shard_vers.values():
                    if cv > 0:
                        counts[cv] = counts.get(cv, 0) + 1
                if counts and max(counts.values()) >= k:
                    required.add(key)
        if not stripes:
            try:
                self._messenger(node.node_id, "sync_done", target_id)
            except FsError:
                pass  # recovering node died again; next round retries
            return 0
        # roll FORWARD partial two-phase commits first: a stripe version v
        # with committed(v) + pending(v) >= k was fully staged before its
        # commit round died — committing the stragglers restores a
        # committed k-quorum that the rebuild below can then use
        self._roll_forward(routing, chain, stripes, vers)
        moved = 0
        failed = 0
        todo = list(stripes.values())
        import time as _time

        # fresh per-round stats dict; published to last_stats only when
        # the round actually rebuilt something, so a later no-op sweep
        # does not wipe the numbers ec-status / the bench report
        round_stats: Dict = {"stripes": len(todo), "installed": 0,
                             "bytes": 0, "read_sources": {}, "mibps": 0.0}
        self._round_stats = round_stats
        t0 = _time.monotonic()
        for base in range(0, len(todo), self._batch):
            batch = todo[base : base + self._batch]
            # each rebuild batch is a traceable op: head-sampled like any
            # client op, its recovery reads/installs carry the context
            # over the batchReadRebuild / batch_write_shard RPCs
            from tpu3fs_torch.analytics import spans as _spans

            with _spans.root_span("ec.rebuild_batch"):
                ok, bad = self._rebuild_batch(
                    routing, chain, batch, lost_shard, node.node_id,
                    target_id, required)
            moved += ok
            failed += bad
        dt = _time.monotonic() - t0
        round_stats["installed"] = moved
        if moved:
            if dt > 0:
                mibps = round_stats["bytes"] / dt / (1 << 20)
                round_stats["mibps"] = round(mibps, 3)
                self._rebuild_mibps.set(mibps)
            self.last_stats = round_stats
        # stale-chunk cleanup: shards on the recovering target for stripes
        # no peer knows anymore
        try:
            have: List[ChunkMeta] = self._messenger(
                node.node_id, "dump_chunkmeta", target_id)
            for meta in have:
                if meta.chunk_id.to_bytes() not in stripes:
                    self._messenger(
                        node.node_id, "remove_chunk", (target_id, meta.chunk_id))
        except FsError:
            failed += 1
        if failed == 0:
            # only promote when EVERY stripe was rebuilt this round —
            # skipped stripes (in-flight writes, failed installs) must get
            # another pass before the target may serve reads
            try:
                self._messenger(node.node_id, "sync_done", target_id)
            except FsError:
                pass  # recovering node died again; next round retries
        return moved

    def _repair_healthy(self, routing: RoutingInfo, chain: ChainInfo) -> int:
        """Roll forward partially-committed two-phase stripe writes on a
        HEALTHY chain. A client that crashes between its phase-2 commit
        RPCs can leave committed(v_new) on only c shards, c in (m, k): no
        version then holds a committed k-quorum, every byte is intact on
        disk, and - because _rebuild_target's roll-forward only runs for
        chains with a SYNCING member - the stripe stayed undecodable until
        an overwrite or a target bounce happened to trigger resync
        (round-4 advisor finding, medium). Two phases so healthy chains
        cost almost nothing at steady state: (A) a cheap pending-only
        probe per target (an interrupted write ALWAYS leaves pendings on
        its straggler shards - phase 2 is what clears them); only if some
        target reports pendings does (B) gather the per-shard committed
        versions of JUST those stripes (stat_chunks) and roll forward
        (idempotent phase-2 writes; safety argument in _roll_forward's
        docstring). An ACTIVE write looks identical in (A) - the quorum +
        serving-coverage guard makes committing alongside it idempotent.
        Returns shards committed."""
        pend: Dict[int, Dict[bytes, int]] = {}  # shard j -> key -> pv
        cids: Dict[bytes, ChunkId] = {}
        for t in chain.targets:
            pn = routing.node_of_target(t.target_id)
            if pn is None:
                return 0  # can't see the whole chain: don't judge quorums
            try:
                metas: List[ChunkMeta] = self._messenger(
                    pn.node_id, "dump_pending_chunkmeta", t.target_id)
            except FsError:
                return 0
            j = chain.shard_index(t.target_id)
            for meta in metas:
                key = meta.chunk_id.to_bytes()
                pend.setdefault(j, {})[key] = meta.pending_ver
                cids.setdefault(key, meta.chunk_id)
        if not cids:
            self._repair_memo.pop(chain.chain_id, None)
            return 0  # steady state: no pendings anywhere, no repair work
        sig = frozenset((j, key, pv)
                        for j, by_key in pend.items()
                        for key, pv in by_key.items())
        if self._repair_memo.get(chain.chain_id) == sig:
            return 0  # same unresolvable pendings as last round: skip
        order = sorted(cids)
        id_list = [cids[key] for key in order]
        vers: Dict[bytes, Dict[int, tuple]] = {}
        for t in chain.targets:
            pn = routing.node_of_target(t.target_id)
            if pn is None:
                return 0
            j = chain.shard_index(t.target_id)
            try:
                stats = self._messenger(
                    pn.node_id, "stat_chunks", (t.target_id, id_list))
            except FsError:
                return 0
            for key, (cv, _length, _aux) in zip(order, stats):
                pv = pend.get(j, {}).get(key, 0)
                if cv > 0 or pv > 0:
                    vers.setdefault(key, {})[j] = (cv, pv)
        if not vers:
            return 0
        committed, failed = self._roll_forward(
            routing, chain, {key: cids[key] for key in vers}, vers)
        committed += self._repair_decode(
            routing, chain, {key: cids[key] for key in vers}, vers)
        # memoize ONLY a truly fruitless sweep (nothing eligible AND no
        # failed attempts): a transiently-failed commit must retry next
        # round — its pending signature is unchanged, so memoizing it
        # would freeze the stripe unreadable forever
        if committed == 0 and failed == 0:
            self._repair_memo[chain.chain_id] = sig
        else:
            self._repair_memo.pop(chain.chain_id, None)
        return committed

    def _roll_forward(self, routing: RoutingInfo, chain: ChainInfo,
                      stripes: Dict[bytes, ChunkId],
                      vers: Dict[bytes, Dict[int, tuple]]) -> int:
        """Finish partially-committed two-phase stripe writes: for each
        stripe, the highest version v with committed(v) + pending(v) >= k
        gets its pending shards committed (idempotent phase-2 writes).
        Safe because a version fully staged across >= k shards was one
        commit round away from durable — completing it can only move the
        stripe FORWARD to content every staged shard already holds.

        -> (committed, failed): failed counts commit ATTEMPTS that did not
        land (unreachable node, refused write). Callers memoizing "nothing
        to do" must treat failed > 0 as progress-possible — a transient
        refusal this round may succeed the next, and memoizing it would
        freeze the stripe unreadable forever."""
        k = chain.ec_k
        committed = 0
        failed = 0
        serving_shards = {chain.shard_index(t.target_id)
                          for t in chain.serving_targets()}
        for key, shard_vers in vers.items():
            cid = stripes.get(key)
            if cid is None:
                continue
            best = 0
            for j, (cv, pv) in shard_vers.items():
                for v in (cv, pv):
                    if v <= best:
                        continue
                    holders = {j2 for j2, (cv2, pv2) in shard_vers.items()
                               if cv2 == v or pv2 == v}
                    # quorum AND coverage of every serving shard: rolling
                    # forward past a serving target that never staged v
                    # would leave it serving stale sub-stripe reads
                    if len(holders) >= k and serving_shards <= holders:
                        best = v
            if best == 0:
                continue
            # commit the stragglers still pending at `best`
            for j, (cv, pv) in shard_vers.items():
                if pv != best or cv >= best:
                    continue
                t = chain.target_of_shard(j)
                pn = (routing.node_of_target(t.target_id)
                      if t is not None else None)
                if pn is None:
                    failed += 1
                    continue
                try:
                    r = self._messenger(pn.node_id, "write_shard",
                                        ShardWriteReq(
                                            chain_id=chain.chain_id,
                                            chain_ver=chain.chain_version,
                                            target_id=t.target_id,
                                            chunk_id=cid,
                                            data=b"",
                                            crc=0,
                                            update_ver=best,
                                            chunk_size=0,
                                            phase=2,
                                        ))
                    if r.ok:
                        committed += 1
                    else:
                        failed += 1
                except FsError:
                    failed += 1
                    continue
        return committed, failed

    def _repair_decode(self, routing: RoutingInfo, chain: ChainInfo,
                       stripes: Dict[bytes, ChunkId],
                       vers: Dict[bytes, Dict[int, tuple]]) -> int:
        """The DECODE twin of the pending roll-forward: repair stripes
        whose straggler shard lost its pending to a displacing (failed)
        later write.

        A committed k-quorum at version v proves the stripe's content
        (whole-stripe versioning + writer nonces: equal encoded version
        means one writer's consistent encode), so a shard still
        committed BELOW v with no pending at v is reconstructed from the
        quorum and installed at v (validated one-step install). Without
        this, the state {k shards committed at v, straggler's pending
        displaced} is permanently version-forked — _roll_forward's
        serving-coverage guard rightly refuses it, no client retries it
        (the write was already abandoned), and sub-stripe reads of the
        stale shard would be torn. Found by the chaos search once the
        chain-encode relay made partial stage states common. -> shards
        repaired."""
        import numpy as np

        from tpu3fs_torch.ops.stripe import (
            aligned_shard_size,
            get_codec,
            trim_rebuilt_shard,
        )

        k, m = chain.ec_k, chain.ec_m
        fixed = 0
        for key, shard_vers in vers.items():
            cid = stripes.get(key)
            if cid is None:
                continue
            by_cv: Dict[int, set] = {}
            for j, (cv, _pv) in shard_vers.items():
                if cv > 0:
                    by_cv.setdefault(cv, set()).add(j)
            if not by_cv:
                continue
            v = max(by_cv)
            holders = by_cv[v]
            if len(holders) < k:
                continue
            stale = [j for j, (cv, pv) in shard_vers.items()
                     if cv < v and pv != v]
            if not stale:
                continue  # pendings present: _roll_forward's business
            datas: Dict[int, bytes] = {}
            aux = 0
            ok = True
            for j in sorted(holders):
                rs = self._read_shard(routing, chain, j, cid)
                if rs is None or rs[0].commit_ver != v:
                    ok = False  # raced/unreachable: next round retries
                    break
                datas[j] = bytes(rs[0].data)
                aux = max(aux, rs[0].logical_len)
            if not ok:
                continue
            S = aligned_shard_size(max(len(b) for b in datas.values())
                                   if datas else 0)
            if S == 0:
                continue
            present = sorted(datas)[:k]
            codec = get_codec(k, m, S, self.device)
            surv = np.stack([
                np.frombuffer(datas[j].ljust(S, b"\x00"), dtype=np.uint8)
                for j in present])[None]
            lens = {jj: len(b) for jj, b in datas.items() if jj < k}
            for j in stale:
                raw = codec.reconstruct_batch(present, (j,), surv)[0, 0] \
                    .tobytes()
                if aux and j < k:
                    extent = min(max(aux - j * S, 0), S)
                    payload = raw[:extent]
                elif j >= k:
                    payload = raw
                else:
                    payload = trim_rebuilt_shard(raw, j, lens, k, S)
                t = chain.target_of_shard(j)
                pn = (routing.node_of_target(t.target_id)
                      if t is not None else None)
                if pn is None:
                    continue
                try:
                    r = self._messenger(pn.node_id, "write_shard",
                                        ShardWriteReq(
                                            chain_id=chain.chain_id,
                                            chain_ver=chain.chain_version,
                                            target_id=t.target_id,
                                            chunk_id=cid,
                                            data=payload,
                                            crc=codec.crc_host(payload),
                                            update_ver=v,
                                            chunk_size=S,
                                            logical_len=aux,
                                            phase=0,
                                        ))
                    if r.ok:
                        fixed += 1
                except FsError:
                    continue
        return fixed

    def _swap_leftover(self, routing: RoutingInfo, chain: ChainInfo,
                       target_id: int):
        """The EC swap's OUTGOING member, when it can serve a DIRECT copy
        of the recovering target's shard: mgmtd keeps a swapped-out
        member's TargetInfo alive (chain_id intact, off the member list)
        until the migration worker releases it at cutover — exactly the
        drain direct-copy window. -> (leftover target id, node id) or
        None.

        Slot-safety guard: the leftover's shard position is not recorded
        anywhere, so it is only usable when the chain has EXACTLY ONE
        non-SERVING member — the swap refuses on a degraded chain, so
        the single recovering slot must be the one the leftover held.
        Any ambiguity (second degraded member, several leftovers,
        unroutable node) falls back to the decode rebuild."""
        non_serving = [t.target_id for t in chain.targets
                       if t.public_state != PublicTargetState.SERVING]
        if non_serving != [target_id]:
            return None
        members = {t.target_id for t in chain.targets}
        cands = [info for info in routing.targets.values()
                 if info.chain_id == chain.chain_id
                 and info.target_id not in members]
        if len(cands) != 1:
            return None
        node = routing.nodes.get(cands[0].node_id)
        if node is None:
            return None
        return cands[0].target_id, node.node_id

    def _read_shard(self, routing: RoutingInfo, chain: ChainInfo, j: int,
                    chunk_id: ChunkId):
        """-> (reply, safe) or None. `safe` = the source is publicly
        readable. UNSAFE sources (WAITING/SYNCING publics whose node still
        answers) are read OPPORTUNISTICALLY: after multiple bounces more
        than m targets can be publicly degraded at once while every byte
        still exists on disk — committed shard versions + CRCs let the
        rebuilder prove which of that data is usable (the version guard in
        _rebuild_batch), instead of wedging the chain forever."""
        t = chain.target_of_shard(j)
        if t is None:
            return None
        safe = t.public_state.can_read
        pn = routing.node_of_target(t.target_id)
        if pn is None:
            return None
        try:
            # read_rebuild bypasses the public-state gate (locally-offlined
            # targets still refuse); the caller's version guard decides
            # what is usable
            r = self._messenger(
                pn.node_id, "read_rebuild",
                ReadReq(chain.chain_id, chunk_id, 0, -1, t.target_id))
        except FsError:
            return None
        return (r, safe) if r.ok else None

    def _gather_serial(self, routing: RoutingInfo, chain: ChainInfo,
                       cid: ChunkId, lost_shard: int):
        """Per-stripe serial gather — the pre-batched path, kept as the
        fallback when peer stats are unavailable or a batched read raced
        a writer. -> (row | None, skip): row = (cid, ver, {shard: bytes},
        S, logical); skip marks a promotion-relevant failure (quorum
        unprovable this round), False with no row means nothing to do
        (already holding the proven version / all-empty stripe)."""
        from tpu3fs_torch.ops.stripe import aligned_shard_size

        k, m = chain.ec_k, chain.ec_m
        by_ver: Dict[int, Dict[int, bytes]] = {}
        aux_ver: Dict[int, int] = {}
        max_safe_ver = 0
        # the recovering target's OWN committed shard participates in the
        # version quorum: after several bounces it often already holds the
        # newest shard (disk intact), and without its vote a one-at-a-time
        # promotion queue can deadlock — every SYNCING rebuild waiting on
        # stale WAITING peers that are queued behind it
        own_ver = -1
        for j in range(k + m):
            rs = self._read_shard(routing, chain, j, cid)
            if rs is None:
                continue
            r, safe = rs
            by_ver.setdefault(r.commit_ver, {})[j] = r.data
            if j == lost_shard:
                own_ver = r.commit_ver
            if safe:
                max_safe_ver = max(max_safe_ver, r.commit_ver)
            if r.logical_len:
                aux_ver[r.commit_ver] = max(
                    aux_ver.get(r.commit_ver, 0), r.logical_len)
        usable = [v for v, g in by_ver.items() if len(g) >= k]
        if not usable:
            return None, True
        ver = max(usable)
        if ver < max_safe_ver:
            # a publicly-readable source has a NEWER committed stripe
            # than anything k shards can prove: rebuilding at the old
            # version would roll the stripe back — wait for the newer
            # version's shard set to become reachable
            return None, True
        if own_ver == ver:
            # already holding the proven version (engine-validated CRC)
            return None, False
        shards = {j: b for j, b in by_ver[ver].items() if j != lost_shard}
        if len(shards) < k:
            # fewer than k true survivors cannot decode — wait for peers
            return None, True
        logical = aux_ver.get(ver, 0)
        # shard size is per-file (S = ceil(chunk_size/k)); the max stored
        # survivor length is a safe working size: content beyond any
        # shard's stored extent is zeros, and GF-multiplying zeros
        # contributes zeros, so decoding at the shorter padded size is
        # byte-exact over the true extents
        S = max(len(b) for b in shards.values())
        if S == 0:
            return None, False  # all-empty stripe: nothing to rebuild
        return (cid, ver, shards, aligned_shard_size(S), logical), False

    def _gather_batched(self, routing: RoutingInfo, chain: ChainInfo,
                        chunk_ids: List[ChunkId], lost_shard: int,
                        leftover=None):
        """-> (rows, skip_cids, fallback_cids, direct_rows): the PARALLEL
        gather. Versions probe as ONE stat_chunks per peer (no payload),
        the k survivors of each stripe are chosen by ROTATING over that
        version's holders — source-disjoint scheduling, so recovery
        reads spread over ALL surviving peers instead of hammering the
        lowest-indexed shards — and the reads issue as ONE
        batch_read_rebuild per peer node. Safety guards mirror
        _gather_serial (safe-version ceiling, own-shard vote, k-quorum);
        stripes the stats cannot prove or whose reads raced a writer
        fall back to the serial gather.

        ``leftover`` = (target id, node id) of a swap's outgoing member
        (_swap_leftover): a stripe whose leftover copy sits at the
        PROVEN version reads that ONE shard direct (1/k the recovery
        bytes of a decode) — direct_rows carries
        (cid, ver, payload, crc, S, logical); any mismatch (a write
        landed after the swap froze the leftover) decodes as usual."""
        from tpu3fs_torch.ops.stripe import aligned_shard_size

        k, m = chain.ec_k, chain.ec_m
        lo_stats = None
        if leftover is not None:
            try:
                lo_stats = self._messenger(
                    leftover[1], "stat_chunks", (leftover[0],
                                                 list(chunk_ids)))
                if len(lo_stats) != len(chunk_ids):
                    lo_stats = None
            except FsError:
                lo_stats = None
        stats: Dict[int, list] = {}
        safe: Dict[int, bool] = {}
        route: Dict[int, tuple] = {}
        for j in range(k + m):
            t = chain.target_of_shard(j)
            if t is None:
                continue
            pn = routing.node_of_target(t.target_id)
            if pn is None:
                continue
            try:
                st = self._messenger(pn.node_id, "stat_chunks",
                                     (t.target_id, list(chunk_ids)))
            except FsError:
                continue
            if len(st) != len(chunk_ids):
                continue
            stats[j] = st
            safe[j] = t.public_state.can_read
            route[j] = (t.target_id, pn.node_id)
        if sum(1 for j in stats if j != lost_shard) < k:
            # stats too thin: serial decides
            return [], [], list(chunk_ids), []
        plans: List[dict] = []
        skip_cids: List[ChunkId] = []
        fallback: List[ChunkId] = []
        reads: Dict[int, list] = {}  # node -> [(plan idx, shard j, req)]
        for idx, cid in enumerate(chunk_ids):
            by_ver: Dict[int, set] = {}
            aux_by_ver: Dict[int, int] = {}
            lens: Dict[tuple, int] = {}
            own_ver = -1
            max_safe = 0
            for j, st in stats.items():
                cv, length, aux = st[idx]
                if cv <= 0:
                    continue
                by_ver.setdefault(cv, set()).add(j)
                lens[(cv, j)] = length
                if j == lost_shard:
                    own_ver = cv
                if safe.get(j):
                    max_safe = max(max_safe, cv)
                if aux:
                    aux_by_ver[cv] = max(aux_by_ver.get(cv, 0), aux)
            usable = [v for v, g in by_ver.items() if len(g) >= k]
            if not usable:
                fallback.append(cid)  # stats can't prove: serial decides
                continue
            ver = max(usable)
            if ver < max_safe:
                skip_cids.append(cid)  # newer committed stripe exists
                continue
            if own_ver == ver:
                continue  # already holding the proven version
            holders = sorted(j for j in by_ver[ver] if j != lost_shard)
            if len(holders) < k:
                skip_cids.append(cid)
                continue
            # working size over ALL holders of the version (parity shards
            # store full S): a rotation choosing only short data shards
            # must still decode at the stripe's true extent
            S_work = max(lens.get((ver, j), 0) for j in by_ver[ver])
            if S_work == 0:
                continue  # all-empty stripe: nothing to rebuild
            if lo_stats is not None and lo_stats[idx][0] == ver:
                # DIRECT COPY: the swap's outgoing member still holds
                # this stripe's shard at the PROVEN version (the swap
                # froze it; no write has landed since) — ONE
                # target-addressed read instead of k survivor reads + a
                # decode. Slot safety: _swap_leftover's one-non-serving
                # guard; byte safety: version match + validated install.
                pi = len(plans)
                plans.append({"cid": cid, "ver": ver,
                              "S": aligned_shard_size(S_work),
                              "logical": aux_by_ver.get(ver, 0),
                              "shards": {}, "want": 1, "bad": False,
                              "direct": True, "payload": None, "crc": 0})
                reads.setdefault(leftover[1], []).append((pi, -1, ReadReq(
                    chain.chain_id, cid, 0, -1, leftover[0])))
                continue
            rot = idx % len(holders)
            chosen = [holders[(rot + t) % len(holders)] for t in range(k)]
            pi = len(plans)
            plans.append({"cid": cid, "ver": ver,
                          "S": aligned_shard_size(S_work),
                          "logical": aux_by_ver.get(ver, 0),
                          "shards": {}, "want": len(chosen), "bad": False})
            for j in chosen:
                tid, nid = route[j]
                reads.setdefault(nid, []).append((pi, j, ReadReq(
                    chain.chain_id, cid, 0, -1, tid)))
        for nid, entries in reads.items():
            try:
                replies = self._messenger(
                    nid, "batch_read_rebuild", [rq for _, _, rq in entries])
            except FsError:
                replies = [None] * len(entries)
            for (pi, j, _rq), r in zip(entries, replies):
                plan = plans[pi]
                if r is None or not r.ok or r.commit_ver != plan["ver"]:
                    plan["bad"] = True  # raced/failed: serial decides
                    continue
                if plan.get("direct"):
                    plan["payload"] = bytes(r.data)  # copy-ok: install input
                    plan["crc"] = r.checksum.value
                    src = leftover[0]
                else:
                    plan["shards"][j] = bytes(r.data)  # copy-ok: decode input
                    src = route[j][0]
                sources = self._round_stats["read_sources"]
                sources[src] = sources.get(src, 0) + 1
        rows = []
        direct_rows = []
        for plan in plans:
            if plan.get("direct"):
                if plan["bad"] or plan["payload"] is None:
                    fallback.append(plan["cid"])  # dead/raced: decode
                else:
                    direct_rows.append(
                        (plan["cid"], plan["ver"], plan["payload"],
                         plan["crc"], plan["S"], plan["logical"]))
                continue
            if plan["bad"] or len(plan["shards"]) < plan["want"]:
                fallback.append(plan["cid"])
                continue
            rows.append((plan["cid"], plan["ver"], plan["shards"],
                         plan["S"], plan["logical"]))
        return rows, skip_cids, fallback, direct_rows

    def _install_batch(self, node_id: int,
                       reqs: List[ShardWriteReq]) -> List[object]:
        """Install rebuilt shards on the recovering node as ONE
        batch_write_shard (the pipelined decode -> install leg);
        OVERLOADED sheds honor the server's retry-after hint once as a
        single re-batch, then defer to the next round (rebuild is
        idempotent and resumable). -> per-req replies (None = transport
        failure)."""
        if not reqs:
            return []
        try:
            replies = list(self._messenger(node_id, "batch_write_shard",
                                           reqs))
        except FsError:
            return [None] * len(reqs)
        shed = [i for i, r in enumerate(replies)
                if r is not None and r.code == Code.OVERLOADED]
        if shed:
            import time as _time

            from tpu3fs_torch.qos.core import retry_after_ms_of

            hint = max((replies[i].retry_after_ms
                        or retry_after_ms_of(replies[i].message))
                       for i in shed)
            _time.sleep(max(hint, 10) / 1000.0)
            try:
                again = self._messenger(node_id, "batch_write_shard",
                                        [reqs[i] for i in shed])
                for i, r in zip(shed, again):
                    replies[i] = r
            except FsError:
                for i in shed:
                    replies[i] = None
        return replies

    def _reconstruct(self, codec, present, lost, surv: np.ndarray) -> np.ndarray:
        """(B, k, S) -> (B, len(lost), S): through the mesh rebuild when a
        mesh was given, else the codec's own decode on the worker's
        device — both via RSCode.reconstruct_fn."""
        if self._mesh is not None:
            import torch

            from tpu3fs_torch.parallel.rebuild import rebuild_lost_shard

            n = codec.k + codec.m
            B, _, S = surv.shape
            full = np.zeros((n, B, S), dtype=np.uint8)
            for row, j in enumerate(present):
                full[j] = surv[:, row, :]
            # rebuild_lost_shard derives its survivor set as "everything not
            # lost" — so every shard NOT in our present set must be declared
            # lost, or its zero-filled row would be decoded as real data
            mesh_lost = sorted(set(range(n)) - set(present))
            out = rebuild_lost_shard(
                self._mesh, torch.from_numpy(full), codec.rs, mesh_lost)
            out = np.moveaxis(out.cpu().numpy(), 0, 1)  # (B, mesh_lost, S)
            cols = [mesh_lost.index(j) for j in lost]
            return out[:, cols, :]
        return codec.reconstruct_batch(present, lost, surv)

    def _rebuild_batch(self, routing: RoutingInfo, chain: ChainInfo,
                       chunk_ids: List[ChunkId], lost_shard: int,
                       node_id: int, target_id: int,
                       required: Optional[set] = None) -> tuple:
        """-> (shards installed, REQUIRED stripes skipped/failed this
        round). Best-effort stripes (known only to degraded peers) never
        block promotion.

        Pipeline: batched version probe + source-disjoint batched
        recovery reads (_gather_batched; serial per-shard fallback),
        one batched GF(2) decode per survivor-set group, installs as
        batch_write_shard on the recovering node."""
        from tpu3fs_torch.ops.stripe import get_codec, trim_rebuilt_shard

        k, m = chain.ec_k, chain.ec_m

        def _skip(cid) -> int:
            return 1 if (required is None
                         or cid.to_bytes() in required) else 0

        leftover = self._swap_leftover(routing, chain, target_id)
        gathered, skip_cids, fb_cids, direct_rows = self._gather_batched(
            routing, chain, chunk_ids, lost_shard, leftover)
        skipped = sum(_skip(cid) for cid in skip_cids)
        for cid in fb_cids:
            row, skip = self._gather_serial(routing, chain, cid, lost_shard)
            if row is not None:
                gathered.append(row)
            elif skip:
                skipped += _skip(cid)
        if not gathered and not direct_rows:
            return 0, skipped
        # group stripes by (survivor index set, working size) so each group
        # is ONE batched device decode
        groups: Dict[tuple, List[int]] = {}
        for i, (_, _, shards, S, _logical) in enumerate(gathered):
            present = tuple(sorted(shards)[:k])
            groups.setdefault((present, S), []).append(i)
        installs: List[ShardWriteReq] = []
        install_cids: List[ChunkId] = []
        # direct-copied shards (the drain fast path): stored-trimmed
        # bytes straight off the outgoing member — no decode, no re-trim
        for cid, ver, payload, crc, S, logical in direct_rows:
            installs.append(ShardWriteReq(
                chain_id=chain.chain_id,
                chain_ver=chain.chain_version,
                target_id=target_id,
                chunk_id=cid,
                data=payload,
                crc=crc,
                update_ver=ver,
                chunk_size=S,
                logical_len=logical,
            ))
            install_cids.append(cid)
        for (present, S), idxs in groups.items():
            codec = get_codec(k, m, S, self.device)
            surv = np.stack([
                np.stack([
                    np.frombuffer(
                        gathered[i][2][j].ljust(S, b"\x00"), dtype=np.uint8)
                    for j in present
                ])
                for i in idxs
            ])  # (B, k, S)
            rebuilt = self._reconstruct(codec, present, (lost_shard,), surv)
            for row, i in enumerate(idxs):
                cid, ver, shards, _, logical = gathered[i]
                raw = rebuilt[row, 0].tobytes()
                if logical and lost_shard < k:
                    # EXACT trim from the survivors' persisted stripe
                    # logical length (engine aux tag) — no zero-stripping
                    # ambiguity even when true content ends in zeros
                    extent = min(max(logical - lost_shard * S, 0), S)
                    payload = raw[:extent]
                elif lost_shard >= k:
                    payload = raw  # parity shards are stored full
                else:
                    lens = {j: len(b) for j, b in shards.items() if j < k}
                    payload = trim_rebuilt_shard(
                        raw, lost_shard, lens, k, S)
                installs.append(ShardWriteReq(
                    chain_id=chain.chain_id,
                    chain_ver=chain.chain_version,
                    target_id=target_id,
                    chunk_id=cid,
                    data=payload,
                    crc=codec.crc_host(payload),
                    update_ver=ver,
                    chunk_size=S,
                    logical_len=logical,
                ))
                install_cids.append(cid)
        moved = 0
        for cid, req, reply in zip(
                install_cids, installs,
                self._install_batch(node_id, installs)):
            if reply is not None and reply.ok:
                moved += 1
                nbytes = len(req.data)
                self._round_stats["bytes"] += nbytes
                self._rebuilt_shards.add()
                self._rebuilt_bytes.add(nbytes)
            else:
                skipped += _skip(cid)
        return moved, skipped
