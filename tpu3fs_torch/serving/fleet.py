"""``FleetKVCache``: a TieredKVCache whose miss path asks the FLEET
before storage.

The fill ladder for a host-tier miss (docs/serving.md):

1. **single-flight** — concurrent in-process misses of one key collapse
   onto one leader fill (serving.fill_coalesced counts the waiters);
2. **peer fill** — the key's rendezvous-ranked, health-gated best peer
   (directory.pick) gets ONE deadline-bounded peerRead, the deadline
   being the adaptive hedge point (3x the peer's latency EWMA, 5ms
   floor, from the HedgeController's delay model). Past the deadline
   the attempt is abandoned at the transport (a degenerate hedge: the
   storage backup PREEMPTS rather than races) and the fill takes the
   storage path it would have taken anyway — so a straggling peer costs
   one hedge delay, never its full straggle, and the common fast path
   stays a single inline RPC with no helper-thread handoffs on it;
3. **claimed storage fill** — before touching storage the filler claims
   the key at its claim-home host (fillClaim). A denied claim means
   another process is already filling: poll ITS host tier briefly
   instead of issuing a duplicate storage fill (cluster-wide
   single-flight); claims are TTL leases, so a crashed filler never
   wedges the key.

Peer-filled bytes are charged to the REQUESTER's tenant (token buckets +
kvcache resident gate, ops+bytes, via try_admit) — a block arriving from
a peer's RAM instead of storage is not a quota bypass. Refusal surfaces
as TENANT_THROTTLED with the retry-after hint, and the bytes are NOT
admitted into the tier.

Shared-block refcounts (note_chain/release_chain, fed by the decode
sessions holding prefix chains) install into the host tier's eviction
scan: capacity eviction prefers unshared tails over viral shared
prefixes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from tpu3fs_torch.analytics.spans import span
from tpu3fs_torch.client.hedging import HedgeController
from tpu3fs_torch.kvcache.tier import TieredKVCache
from tpu3fs_torch.rpc.health import HealthRegistry
from tpu3fs_torch.serving.directory import PeerDirectory
from tpu3fs_torch.serving.singleflight import FillClaims, SingleFlight
from tpu3fs_torch.utils.result import Code, FsError, Status

#: transport-level outcomes feed the breaker as FAILURES; an application
#: error reply proves the peer alive (rpc/health.py observe contract)
_TRANSPORT = frozenset({
    Code.TIMEOUT, Code.RPC_CONNECT_FAILED, Code.RPC_SEND_FAILED,
    Code.RPC_TIMEOUT, Code.RPC_PEER_CLOSED, Code.PEER_UNHEALTHY,
})

_RECORDERS = None
_REC_LOCK = threading.Lock()


def recorders():
    """serving.* metric family (docs/observability.md): the peer-fill
    protocol's outcome counters. ONE declaration site — the recorder
    registry checker (tools/check_recorder_registry.py) resolves the
    family here."""
    global _RECORDERS
    if _RECORDERS is None:
        with _REC_LOCK:
            if _RECORDERS is None:
                from tpu3fs_torch.monitor.recorder import CounterRecorder

                _RECORDERS = {
                    "peer_hit": CounterRecorder("serving.peer_hit"),
                    "peer_miss": CounterRecorder("serving.peer_miss"),
                    "fill_coalesced":
                        CounterRecorder("serving.fill_coalesced"),
                    "demotions": CounterRecorder("serving.demotions"),
                    "bytes": CounterRecorder("serving.bytes"),
                }
    return _RECORDERS


class FleetKVCache(TieredKVCache):
    """TieredKVCache whose ``_miss_fill`` runs the fleet ladder."""

    def __init__(self, cache, *, node_id: int, routing, peer_client,
                 health: Optional[HealthRegistry] = None,
                 hedge: Optional[HedgeController] = None,
                 claim_ttl_ms: int = 2000,
                 claim_poll_ms: float = 20.0,
                 claim_polls: int = 3,
                 singleflight_timeout_s: float = 30.0,
                 peer_est_bytes: int = 1 << 20,
                 **kw):
        super().__init__(cache, **kw)
        self.node_id = int(node_id)
        self.health = health if health is not None else HealthRegistry()
        self.directory = PeerDirectory(routing, self.node_id,
                                       health=self.health)
        self.peers = peer_client
        self.hedge = hedge if hedge is not None else HedgeController(
            health=self.health)
        #: this process's claim table — SHARED with its ServingHost
        #: (serving_main passes it to the host) so local and remote
        #: fillers contend on one table when this node is the claim home
        self.claims = FillClaims(ttl_ms=claim_ttl_ms)
        self._sf = SingleFlight()
        self._sf_timeout_s = float(singleflight_timeout_s)
        self._claim_poll_s = float(claim_poll_ms) / 1000.0
        self._claim_polls = max(0, int(claim_polls))
        self._peer_est = int(peer_est_bytes)
        self._cmu = threading.Lock()
        self._counters: Dict[str, int] = {
            "storage_fills": 0, "peer_hits": 0, "peer_misses": 0,
            "coalesced": 0, "demotions": 0, "peer_bytes": 0,
            "throttled": 0,
        }
        self._refcounts: Dict[str, int] = {}
        self._refmu = threading.Lock()
        self.tier.refcount_of = self._refcount

    # -- counters ------------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._cmu:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._cmu:
            return dict(self._counters)

    # -- shared-block refcounts ---------------------------------------------
    def _refcount(self, key: str) -> int:
        with self._refmu:
            return self._refcounts.get(key, 0)

    def note_chain(self, keys: Sequence[str]) -> None:
        """A decode session now references these prefix blocks: eviction
        treats keys with count > 1 as SHARED (viral prefixes outlive
        unshared tails)."""
        with self._refmu:
            for k in keys:
                self._refcounts[k] = self._refcounts.get(k, 0) + 1

    def release_chain(self, keys: Sequence[str]) -> None:
        with self._refmu:
            for k in keys:
                n = self._refcounts.get(k, 0) - 1
                if n <= 0:
                    self._refcounts.pop(k, None)
                else:
                    self._refcounts[k] = n

    # -- tenant admission ----------------------------------------------------
    def _admit_peer_bytes(self, nbytes: int, ops: int = 1) -> None:
        """Charge peer-filled bytes to the requesting tenant with the
        TRUE payload size — whichever tier filled the block, the bytes
        are charged exactly once (the peer's dispatch charged peerRead as
        IOPS only). Refusal = the bytes are not admitted."""
        from tpu3fs_torch.tenant.identity import current_tenant
        from tpu3fs_torch.tenant.quota import registry

        tenant = getattr(self._fs, "_tenant", "") or current_tenant()
        if not tenant:
            return
        wait = registry().try_admit(tenant, ops=float(ops), nbytes=nbytes,
                                    kv_charge=True)
        if wait is not None:
            self._count("throttled")
            raise FsError(Status(
                Code.TENANT_THROTTLED,
                f"retry_after_ms={wait} (peer-filled bytes charged to "
                f"tenant {tenant})"))

    # -- the fleet fill ladder ----------------------------------------------
    def _miss_fill(self, key: str) -> Optional[bytes]:
        result, leader = self._sf.do(
            key, lambda: self._fleet_fill(key), self._sf_timeout_s)
        if not leader:
            self._count("coalesced")
            recorders()["fill_coalesced"].add()
        return result

    def _fleet_fill(self, key: str) -> Optional[bytes]:
        ep, demoted = self.directory.pick(key)
        if demoted:
            # a better-ranked peer was skipped on health: breaker open /
            # latency outlier -> instant demotion toward storage
            self._count("demotions")
            recorders()["demotions"].add()
        if ep is None:
            with span("serving.get", "storage_fill"):
                return self._storage_fill(key)
        return self._deadlined_peer_fill(key, ep)

    def _deadlined_peer_fill(self, key: str, ep) -> Optional[bytes]:
        """ONE inline peerRead bounded by the adaptive hedge point. The
        deadline rides the transport itself (socket timeout / ring-wait
        abandonment), so the fast path has NO helper-thread handoffs on
        it — a peer hit is exactly one RPC — while a straggler costs one
        hedge delay before the fill falls to storage (a deadline expiry
        is a DEMOTION, not a peer miss: the peer may well have had the
        block, it just failed to produce it in time)."""
        deadline_s = self.hedge.delay_s(ep.node_id)
        self.hedge.note_primary()
        t0 = time.monotonic()
        with span("serving.get", "peer_fill"):
            try:
                rsp = self.peers.peer_read(ep, [key],
                                           est_bytes=self._peer_est,
                                           deadline_s=deadline_s)
            except FsError as e:
                self.health.observe(ep.node_id, time.monotonic() - t0,
                                    ok=e.code not in _TRANSPORT)
                self._count("demotions")
                recorders()["demotions"].add()
                with span("serving.get", "storage_fill"):
                    return self._storage_fill(key)
        self.health.observe(ep.node_id, time.monotonic() - t0, ok=True)
        v = (rsp.blobs[0]
             if rsp.found and rsp.found[0] and rsp.blobs else None)
        if v is None:
            self._count("peer_misses")
            recorders()["peer_miss"].add()
            with span("serving.get", "storage_fill"):
                return self._storage_fill(key)
        v = bytes(v)
        self._admit_peer_bytes(len(v))
        self._count("peer_hits")
        self._count("peer_bytes", len(v))
        recorders()["peer_hit"].add()
        recorders()["bytes"].add(len(v))
        return v

    # -- claimed storage fill ------------------------------------------------
    def _storage_fill(self, key: str) -> Optional[bytes]:
        """Storage fill under a cluster-wide fill-intent claim. A denied
        claim = someone else is filling: poll the holder's host tier
        briefly, then (liveness over dedup) fill anyway."""
        home = self.directory.claim_home(key)
        granted, holder = True, self.node_id
        if home == self.node_id or home is None:
            self.claims.prune()
            granted, holder = self.claims.claim(key, self.node_id)
        else:
            home_ep = self.directory.endpoint_of(home)
            if home_ep is not None:
                try:
                    rsp = self.peers.fill_claim(ep=home_ep, key=key,
                                                owner=self.node_id,
                                                ttl_ms=self.claims.ttl_ms)
                    granted, holder = rsp.granted, rsp.holder
                except FsError:
                    pass  # claim home unreachable: claims are best-effort
        if not granted:
            v = self._poll_holder(key, holder)
            if v is not None:
                self._count("coalesced")
                recorders()["fill_coalesced"].add()
                self._admit_peer_bytes(len(v))
                self._count("peer_bytes", len(v))
                recorders()["bytes"].add(len(v))
                return v
        try:
            v = self._fs.get(key)
            self._count("storage_fills")
            return v
        finally:
            if granted:
                self._release_claim(key, home)

    def _release_claim(self, key: str, home) -> None:
        if home == self.node_id or home is None:
            self.claims.release(key, self.node_id)
            return
        home_ep = self.directory.endpoint_of(home)
        if home_ep is not None:
            try:
                self.peers.fill_release(home_ep, key, self.node_id)
            except FsError:
                pass  # lease expiry cleans up

    def _poll_holder(self, key: str, holder: int) -> Optional[bytes]:
        """The claim holder is filling: watch its host tier instead of
        duplicating the storage read."""
        ep = (self.directory.endpoint_of(holder)
              if holder != self.node_id else None)
        for attempt in range(self._claim_polls):
            if attempt:
                time.sleep(self._claim_poll_s)
            if ep is None:
                v = self.tier.get(key)
            else:
                try:
                    rsp = self.peers.peer_read(ep, [key],
                                               est_bytes=self._peer_est)
                    v = (rsp.blobs[0]
                         if rsp.found and rsp.found[0] and rsp.blobs
                         else None)
                except FsError:
                    return None
            if v is not None:
                return bytes(v)
        return None

    # -- batch ---------------------------------------------------------------
    def _miss_fill_batch(self, keys: Sequence[str]) \
            -> List[Optional[bytes]]:
        """Batch misses group by best peer (one peerRead per peer); the
        remainder goes to storage as one striped fs batch. Peer bytes are
        admitted as ONE tenant charge for the whole batch."""
        out: List[Optional[bytes]] = [None] * len(keys)
        by_peer: Dict[int, List[int]] = {}
        eps: Dict[int, object] = {}
        storage_idx: List[int] = []
        for i, key in enumerate(keys):
            ep, demoted = self.directory.pick(key)
            if demoted:
                self._count("demotions")
                recorders()["demotions"].add()
            if ep is None:
                storage_idx.append(i)
            else:
                by_peer.setdefault(ep.node_id, []).append(i)
                eps[ep.node_id] = ep
        peer_bytes = 0
        peer_ops = 0
        for node_id, idxs in by_peer.items():
            ep = eps[node_id]
            t0 = time.monotonic()
            try:
                # the per-op hedge point scales with the batch: a grouped
                # read is one bigger op, not len(idxs) chances to straggle
                rsp = self.peers.peer_read(
                    ep, [keys[i] for i in idxs],
                    est_bytes=self._peer_est * len(idxs),
                    deadline_s=self.hedge.delay_s(node_id) * len(idxs))
            except FsError as e:
                self.health.observe(node_id, time.monotonic() - t0,
                                    ok=e.code not in _TRANSPORT)
                storage_idx.extend(idxs)
                continue
            self.health.observe(node_id, time.monotonic() - t0, ok=True)
            for j, i in enumerate(idxs):
                hit = (j < len(rsp.found) and rsp.found[j]
                       and rsp.blobs[j])
                if hit:
                    out[i] = bytes(rsp.blobs[j])
                    peer_bytes += len(out[i])
                    peer_ops += 1
                    self._count("peer_hits")
                    recorders()["peer_hit"].add()
                else:
                    storage_idx.append(i)
                    self._count("peer_misses")
                    recorders()["peer_miss"].add()
        if peer_bytes:
            self._admit_peer_bytes(peer_bytes, ops=peer_ops)
            self._count("peer_bytes", peer_bytes)
            recorders()["bytes"].add(peer_bytes)
        if storage_idx:
            with span("serving.get", "storage_fill"):
                got = self._fs.batch_get([keys[i] for i in storage_idx])
            self._count("storage_fills", len(storage_idx))
            for i, v in zip(storage_idx, got):
                out[i] = v
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self, flush: bool = True) -> None:
        try:
            super().close(flush=flush)
        finally:
            close_fn = getattr(self.peers, "close", None)
            if callable(close_fn):
                close_fn()
