"""The Serving RPC surface: each serving process's host + peer client.

Service id 7 ("Serving") rides the same TCP transport as every other
service. ``peerRead`` — the only data-plane method — additionally rides
the USRBIO shm rings when requester and peer share a host
(``ServingPeerClient(usrbio=True)``, the default, as in the JAX package);
the client counts its peerRead calls by transport (``transport_calls``).
In one process a caller may also hand ``FleetKVCache`` any object with
``peer_read``/``fill_claim``/``fill_release`` that dispatches into the
peers' ``ServingHost``s.

The host answers ``peerRead`` from its HOST TIER (``TieredKVCache.peek``
— local-only, a peer miss must never recurse into this process's own
fill path), with an optional SERVE-THROUGH: a miss whose fs inode is
still cached reads the entry for one storage round trip and zero meta
RPCs (``KVCacheClient.get_cached``). Serve-through is exactly where the
stale-after-GC hazard lives — a GC'd entry reads back as an all-zero
hole through a cached inode — so the payload is validated with
``layout.zero_hole`` before it ships; zeros-as-KV must never cross the
fleet (docs/serving.md, the ``peer_fill_stale`` chaos bug plants the
skipped validation).

``fillClaim``/``fillRelease`` expose the TTL-leased fill-intent table
(singleflight.FillClaims) that makes storage fills cluster-wide
single-flight; ``servingStats`` snapshots the host; ``servingLoad`` is
the bench/driver workload surface (threads inside the serving process).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu3fs_torch.chaos.bugs import bug_fire
from tpu3fs_torch.kvcache.layout import zero_hole
from tpu3fs_torch.utils.result import Code, FsError, Status

SERVING_SERVICE_ID = 7


# -- wire types --------------------------------------------------------------

@dataclass
class PeerReadReq:
    keys: List[str] = field(default_factory=list)
    #: allow the peer to serve a host-tier miss through its CACHED fs
    #: inodes (one storage read, zero meta RPCs); off = pure tier probe
    serve_through: bool = True


@dataclass
class PeerReadRsp:
    found: List[bool] = field(default_factory=list)
    blobs: List[bytes] = field(default_factory=list)  # b"" where not found
    node_id: int = 0
    #: stale (GC'd) entries detected while serving this request — the
    #: requester's signal that its key set is racing GC
    stale: int = 0


@dataclass
class FillClaimReq:
    key: str
    owner: int
    ttl_ms: int = 2000


@dataclass
class FillClaimRsp:
    granted: bool
    holder: int = 0


@dataclass
class FillReleaseReq:
    key: str
    owner: int


@dataclass
class FillReleaseRsp:
    released: bool = False


@dataclass
class ServingStatsRsp:
    node_id: int = 0
    host_bytes: int = 0
    host_entries: int = 0
    claims_held: int = 0
    peer_reads: int = 0
    keys_served: int = 0
    bytes_served: int = 0
    stale_detected: int = 0
    # fleet-side lifetime counters (0 when the cache is a plain
    # TieredKVCache without the fleet miss path)
    storage_fills: int = 0
    peer_hits: int = 0
    peer_misses: int = 0
    coalesced: int = 0
    demotions: int = 0


@dataclass
class ServingLoadReq:
    """One benchmark workload leg, run INSIDE the serving process."""

    op: str = "get"                     # "get" | "put"
    keys: List[str] = field(default_factory=list)
    value_bytes: int = 0                # put payload size
    concurrency: int = 1
    repeat: int = 1                     # each worker's passes over keys
    write_through: bool = True
    drop_host: bool = False             # clear the host tier first
    #: >1 = gets go through cache.batch_get in chunks of this size (the
    #: decode-step shape: one prefix chain per call, misses grouped into
    #: one peerRead per peer / one striped storage batch — fleet.py
    #: _miss_fill_batch); lat_us then holds per-CHUNK latencies
    batch: int = 0


@dataclass
class ServingLoadRsp:
    ops: int = 0
    hits: int = 0
    nbytes: int = 0
    wall_us: int = 0
    errors: int = 0
    lat_us: List[int] = field(default_factory=list)  # capped sample
    # DELTAS of the fleet counters across the leg — the bench's proof
    # surface (K concurrent misses of one key -> storage_fills == 1)
    storage_fills: int = 0
    peer_hits: int = 0
    peer_misses: int = 0
    coalesced: int = 0
    demotions: int = 0


_LAT_CAP = 4096


# -- per-process host --------------------------------------------------------

class ServingHost:
    """Serves this process's cache over the Serving service."""

    def __init__(self, cache, node_id: int, *, serve_through: bool = True,
                 straggle_ms: float = 0.0, claims=None):
        from tpu3fs_torch.serving.singleflight import FillClaims

        self.cache = cache
        self.node_id = int(node_id)
        self.serve_through = serve_through
        #: injected peerRead latency (bench straggler; --straggle-ms)
        self.straggle_ms = float(straggle_ms)
        #: when the cache is a FleetKVCache, SHARE its claim table, so
        #: local fills and remote fillClaim calls contend on one table
        #: when this node is a key's claim home
        self.claims = claims if claims is not None \
            else getattr(cache, "claims", None) or FillClaims()
        self._mu = threading.Lock()
        self.peer_reads = 0
        self.keys_served = 0
        self.bytes_served = 0
        self.stale_detected = 0

    # -- data plane ----------------------------------------------------------
    def peer_read(self, req: PeerReadReq) -> PeerReadRsp:
        if self.straggle_ms > 0:
            time.sleep(self.straggle_ms / 1000.0)
        found: List[bool] = []
        blobs: List[bytes] = []
        stale0 = self.stale_detected
        for key in req.keys:
            v = self.cache.peek(key)
            if v is None and self.serve_through and req.serve_through:
                v = self._serve_through(key)
            found.append(v is not None)
            blobs.append(bytes(v) if v is not None else b"")
        served = sum(len(b) for b in blobs)
        with self._mu:
            self.peer_reads += 1
            self.keys_served += sum(found)
            self.bytes_served += served
        return PeerReadRsp(found=found, blobs=blobs, node_id=self.node_id,
                           stale=self.stale_detected - stale0)

    def _serve_through(self, key: str) -> Optional[bytes]:
        """Host-tier miss: read via an already-cached fs inode (zero meta
        RPCs). MUST staleness-validate before shipping: through a cached
        inode a GC'd entry reads back as an all-zero hole, and a zero
        hole relayed to a peer becomes zeros-as-KV fleet-wide."""
        fs = self.cache.fs
        raw = fs.get_cached(key)
        if raw is None:
            return None
        if bug_fire("peer_fill_stale"):
            # PLANTED BUG (chaos corpus): skip the zero_hole validation
            # and ship whatever the cached inode read back — after a GC
            # that is an all-zero hole served as live KV bytes. The
            # seeded chaos search must surface this as a kvcache_stale
            # invariant violation (tests/chaos_seeds/).
            return bytes(raw)
        if zero_hole(raw):
            # entry GC'd under the cached inode: invalidate, ONE re-stat
            # (fresh meta lookup), serve the re-written entry or miss —
            # never the zeros
            with self._mu:
                self.stale_detected += 1
            fs.invalidate(key)
            try:
                return fs.get(key)
            except FsError:
                return None
        return bytes(raw)

    # -- fill-intent claims --------------------------------------------------
    def fill_claim(self, req: FillClaimReq) -> FillClaimRsp:
        self.claims.prune()
        granted, holder = self.claims.claim(req.key, req.owner, req.ttl_ms)
        return FillClaimRsp(granted=granted, holder=holder)

    def fill_release(self, req: FillReleaseReq) -> FillReleaseRsp:
        return FillReleaseRsp(released=self.claims.release(req.key, req.owner))

    # -- observability -------------------------------------------------------
    def _fleet_counters(self) -> Dict[str, int]:
        fn = getattr(self.cache, "counters", None)
        return fn() if callable(fn) else {}

    def stats(self) -> ServingStatsRsp:
        c = self._fleet_counters()
        with self._mu:
            return ServingStatsRsp(
                node_id=self.node_id,
                host_bytes=self.cache.tier.bytes,
                host_entries=len(self.cache.tier),
                claims_held=self.claims.held(),
                peer_reads=self.peer_reads,
                keys_served=self.keys_served,
                bytes_served=self.bytes_served,
                stale_detected=self.stale_detected,
                storage_fills=c.get("storage_fills", 0),
                peer_hits=c.get("peer_hits", 0),
                peer_misses=c.get("peer_misses", 0),
                coalesced=c.get("coalesced", 0),
                demotions=c.get("demotions", 0),
            )

    # -- bench workload ------------------------------------------------------
    def load(self, req: ServingLoadReq) -> ServingLoadRsp:
        """Run the leg with real threads in THIS process; returns per-op
        latencies (capped) and fleet-counter deltas."""
        if req.op not in ("get", "put"):
            raise FsError(Status(Code.INVALID_ARG, f"op {req.op!r}"))
        if req.drop_host:
            self.cache.tier.clear()
        c0 = self._fleet_counters()
        # batch applies to BOTH legs: batched gets ride batch_get's
        # node-grouped fan-out, batched puts ride batch_put's single
        # batch_create + striped write + batch_close drain — a put leg
        # with --batch N must never degrade to N serial create round
        # trips (the meta-bound half of the write number)
        stride = max(1, int(req.batch))
        tasks = list(req.keys) * max(1, req.repeat)
        chunks = [tasks[i:i + stride] for i in range(0, len(tasks), stride)]
        nworkers = max(1, min(int(req.concurrency), max(1, len(chunks))))
        value = b"\xa5" * max(0, req.value_bytes)
        cursor = {"i": 0}
        mu = threading.Lock()
        out = {"ops": 0, "hits": 0, "nbytes": 0, "errors": 0}
        lats: List[int] = []
        barrier = threading.Barrier(nworkers + 1)

        def worker():
            barrier.wait()
            while True:
                with mu:
                    i = cursor["i"]
                    if i >= len(chunks):
                        return
                    cursor["i"] = i + 1
                chunk = chunks[i]
                t0 = time.monotonic()
                try:
                    if req.op == "get" and stride > 1:
                        got = self.cache.batch_get(chunk)
                        hit = sum(v is not None for v in got)
                        n = sum(len(v) for v in got if v is not None)
                    elif req.op == "get":
                        v = self.cache.get(chunk[0])
                        hit = int(v is not None)
                        n = len(v) if v is not None else 0
                    elif stride > 1:
                        self.cache.batch_put(
                            [(k, value) for k in chunk],
                            write_through=req.write_through)
                        hit, n = len(chunk), len(value) * len(chunk)
                    else:
                        self.cache.put(chunk[0], value,
                                       write_through=req.write_through)
                        hit, n = 1, len(value)
                    dt = int((time.monotonic() - t0) * 1e6)
                    with mu:
                        out["ops"] += len(chunk)
                        out["hits"] += hit
                        out["nbytes"] += n
                        if len(lats) < _LAT_CAP:
                            lats.append(dt)
                except FsError:
                    with mu:
                        out["ops"] += len(chunk)
                        out["errors"] += len(chunk)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(nworkers)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        wall_us = int((time.monotonic() - t0) * 1e6)
        c1 = self._fleet_counters()
        d = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
        return ServingLoadRsp(
            ops=out["ops"], hits=out["hits"], nbytes=out["nbytes"],
            wall_us=wall_us, errors=out["errors"], lat_us=lats,
            storage_fills=d.get("storage_fills", 0),
            peer_hits=d.get("peer_hits", 0),
            peer_misses=d.get("peer_misses", 0),
            coalesced=d.get("coalesced", 0),
            demotions=d.get("demotions", 0),
        )


def bind_serving_service(server, host: ServingHost):
    """Bind the Serving service onto an RpcServer. The process should
    also bind Usrbio (usrbio/server.py) so co-located peers can drive
    peerRead over shm rings (RING_METHODS maps (7, 1))."""
    from tpu3fs_torch.rpc.net import ServiceDef

    s = ServiceDef(SERVING_SERVICE_ID, "Serving")
    s.method(1, "peerRead", PeerReadReq, PeerReadRsp, host.peer_read)
    s.method(2, "fillClaim", FillClaimReq, FillClaimRsp, host.fill_claim)
    s.method(3, "fillRelease", FillReleaseReq, FillReleaseRsp,
             host.fill_release)
    s.method(4, "servingStats", PeerReadReq, ServingStatsRsp,
             lambda r: host.stats())
    s.method(5, "servingLoad", ServingLoadReq, ServingLoadRsp, host.load)
    server.add_service(s)
    return s


# -- peer client -------------------------------------------------------------

class ServingPeerClient:
    """Client half of the peer-fill protocol: sockets everywhere, shm
    rings when requester and peer share a host (the storage messenger's
    handshake and ring rules, ``usrbio/transport.py:RingTable``, keyed by
    peer node id, with transport errors falling back to the socket path
    and fatal ones dropping the ring)."""

    def __init__(self, rpc_client, *, usrbio: bool = True,
                 entries: int = 64, iov_bytes: int = 8 << 20):
        from tpu3fs_torch.usrbio.transport import RingTable

        self._client = rpc_client
        self._usrbio = usrbio
        self._entries = int(entries)
        self._iov_bytes = int(iov_bytes)
        self._table = RingTable(rpc_client, entries=self._entries,
                                iov_bytes=self._iov_bytes)
        self._mu = threading.Lock()
        #: (transport, node id) -> peerRead calls issued over "ring" or
        #: "socket": a call counts on each transport it was tried on
        self.transport_calls: collections.Counter = collections.Counter()

    def _count(self, transport: str, node_id: int) -> None:
        with self._mu:
            self.transport_calls[(transport, node_id)] += 1

    @staticmethod
    def _addr(ep) -> tuple:
        if not getattr(ep, "host", ""):
            raise FsError(Status(Code.RPC_CONNECT_FAILED,
                                 f"serving endpoint {ep!r} has no address"))
        return ep.host, ep.port

    # -- rings ---------------------------------------------------------------
    @property
    def _rings(self) -> Dict[int, object]:
        return self._table.rings

    def _ring_for(self, ep):
        """The peer's RingClient, or None (sockets)."""
        if not self._usrbio:
            return None
        return self._table.get(
            ep.node_id, lambda: (ep.host, ep.port)
            if getattr(ep, "host", "") else None)

    def close(self) -> None:
        self._table.close()

    # -- calls ---------------------------------------------------------------
    def peer_read(self, ep, keys: List[str], *, serve_through: bool = True,
                  est_bytes: int = 1 << 20,
                  deadline_s: Optional[float] = None) -> PeerReadRsp:
        """``deadline_s`` bounds the attempt on EITHER transport and
        surfaces expiry as RPC_TIMEOUT — which is deliberately NOT a ring
        transport code, so a straggling peer neither tears the ring down
        nor silently retries on sockets: the caller (the fleet fill
        ladder) owns the fallback-to-storage decision."""
        req = PeerReadReq(keys=list(keys), serve_through=serve_through)
        ring = self._ring_for(ep)
        if ring is not None:
            self._count("ring", ep.node_id)
            try:
                # clamp the reply estimate to half the ring arena: a
                # batched read whose worst-case estimate outgrows the
                # arena should still ride the ring (an underestimated
                # reply surfaces as a transport error and falls back to
                # sockets; a permanent downgrade would be silent)
                est = min(int(est_bytes), self._iov_bytes // 2)
                rsp, _segs = ring.call(SERVING_SERVICE_ID, 1, req,
                                       PeerReadRsp,
                                       rsp_data_est=est,
                                       deadline_s=deadline_s)
                return rsp
            except FsError as e:
                self._table.fallback(ep.node_id, ring, e)
        self._count("socket", ep.node_id)
        return self._client.call(self._addr(ep), SERVING_SERVICE_ID, 1,
                                 req, PeerReadRsp, timeout_s=deadline_s)

    def fill_claim(self, ep, key: str, owner: int,
                   ttl_ms: int = 2000) -> FillClaimRsp:
        return self._client.call(
            self._addr(ep), SERVING_SERVICE_ID, 2,
            FillClaimReq(key=key, owner=owner, ttl_ms=ttl_ms), FillClaimRsp)

    def fill_release(self, ep, key: str, owner: int) -> FillReleaseRsp:
        return self._client.call(
            self._addr(ep), SERVING_SERVICE_ID, 3,
            FillReleaseReq(key=key, owner=owner), FillReleaseRsp)

    def stats(self, ep) -> ServingStatsRsp:
        return self._client.call(self._addr(ep), SERVING_SERVICE_ID, 4,
                                 PeerReadReq(), ServingStatsRsp)

    def load(self, ep, req: ServingLoadReq) -> ServingLoadRsp:
        return self._client.call(self._addr(ep), SERVING_SERVICE_ID, 5,
                                 req, ServingLoadRsp)
