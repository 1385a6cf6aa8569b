"""The serving fleet's unit cases that the slice sequence does not reach,
each run over both packages (the JAX package's ``tpu3fs.serving`` and the
port's copy, ``tpu3fs_torch.serving``, on the port's ``Fabric(device=
"cpu")``): single-flight coalescing, claim TTLs, the peer directory's
rendezvous ranking (the port's ranking equal to the JAX package's on the
same keys), the fill ladder's demotions and coalescing, refcounted
eviction, the serving host's zero-hole check and its load legs; and the
port's socket half carrying a peer fill. Tolerance 0."""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

from torch_kvcache_sequence import LoopbackPeers

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("kvcache", "kvcache"), ("serving", "serving"),
        ("service", "serving.service"), ("gtypes", "mgmtd.types"),
        ("fabric", "fabric"), ("result", "utils.result"))}
    return SimpleNamespace(root=root, **mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def fab(pkg):
    cfg = pkg.fabric.SystemSetupConfig(num_storage_nodes=2, num_chains=4,
                                       num_replicas=2, chunk_size=4096)
    kw = {"device": "cpu"} if pkg.root == "tpu3fs_torch" else {}
    f = pkg.fabric.Fabric(cfg, **kw)
    yield f
    f.close()


def _routing(endpoints):
    ri = SimpleNamespace(serving=endpoints)
    return lambda: ri


def _eps(pkg, ids):
    return {i: pkg.gtypes.ServingEndpoint(node_id=i) for i in ids}


class _Health:
    """A fixed deny-set; everything else healthy."""

    def __init__(self, deny=()):
        self.deny = set(deny)

    def allow(self, peer):
        return peer not in self.deny

    def suspect(self, peer):
        return False

    def observe(self, peer, latency_s, ok=True):
        pass

    def ewma_s(self, peer):
        return 0.0


class _Straggling(LoopbackPeers):
    """Loopback peers whose ``slow`` node answers after ``straggle_s``, and
    that give up at the caller's deadline, as the real transports do."""

    def __init__(self, service, slow, straggle_s):
        super().__init__(service)
        self.slow, self.straggle_s, self.calls = slow, straggle_s, 0

    def peer_read(self, ep, keys, *, serve_through=True, est_bytes=0,
                  deadline_s=None):
        self.calls += 1
        if ep.node_id == self.slow:
            wait = self.straggle_s if deadline_s is None else \
                min(self.straggle_s, deadline_s)
            time.sleep(wait)
            if wait < self.straggle_s:
                r = self._result
                raise r.FsError(r.Status(r.Code.RPC_TIMEOUT, "deadline"))
        return super().peer_read(ep, keys, serve_through=serve_through)


def _pair(pkg, fab, peers=None, health=None, **kw):
    """Two FleetKVCaches over one fabric, each with an inode cache, peers
    of each other through ``peers``."""
    peers = peers or LoopbackPeers(pkg.service)
    routing = _routing(_eps(pkg, (1, 2)))
    fleets = {}
    for n in (1, 2):
        fs = pkg.kvcache.KVCacheClient(fab.meta, fab.file_client(),
                                       client_id=f"srv{n}", inode_cache=64)
        fleets[n] = pkg.serving.FleetKVCache(
            fs, node_id=n, routing=routing, peer_client=peers,
            health=health, write_through=True, **kw)
        peers.hosts[n] = pkg.serving.ServingHost(fleets[n], n,
                                                 claims=fleets[n].claims)
    return fleets, peers


def _close(fleets):
    for f in fleets.values():
        f.close(flush=False)


# -- single-flight and claims --------------------------------------------------
def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


@pytest.mark.parametrize("fails", [False, True])
def test_singleflight_one_leader_for_concurrent_callers(pkg, fails):
    sf = pkg.serving.SingleFlight()
    calls, release = {"n": 0}, threading.Event()
    r = pkg.result
    err = r.FsError(r.Status(r.Code.TARGET_OFFLINE, "fill failed"))

    def fn():
        calls["n"] += 1
        release.wait(5)
        if fails:
            raise err
        return "filled"

    out, mu = [], threading.Lock()

    def run():
        try:
            got = sf.do("k", fn, 10.0)
        except pkg.result.FsError:
            got = ("err", None)
        with mu:
            out.append(got)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    assert _wait_for(lambda: calls["n"] == 1)
    time.sleep(0.05)
    release.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert calls["n"] == 1
    if fails:
        assert out == [("err", None)] * 6
    else:
        assert [r for r, _ in out] == ["filled"] * 6
        assert [lead for _, lead in out].count(True) == 1


def test_singleflight_waiter_past_its_patience_self_serves(pkg):
    sf = pkg.serving.SingleFlight()
    release, started = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(5)
        return "slow"

    t = threading.Thread(target=lambda: sf.do("k", slow, 10.0))
    t.start()
    assert started.wait(2)
    assert sf.do("k", lambda: "fast", timeout_s=0.05) == ("fast", False)
    release.set()
    t.join(5)
    assert not t.is_alive()


def test_claims_grant_deny_renew_expire_release(pkg):
    now = [0.0]
    fc = pkg.serving.FillClaims(ttl_ms=1000, clock=lambda: now[0])
    assert fc.claim("k", 1) == (True, 1)
    assert fc.claim("k", 2) == (False, 1)
    assert fc.claim("k", 1) == (True, 1)
    assert fc.claim("k2", 2, ttl_ms=3000) == (True, 2)
    assert fc.held() == 2
    now[0] = 1.5
    assert fc.held() == 1
    assert fc.claim("k", 2) == (True, 2)
    assert not fc.release("k", 1) and fc.release("k", 2)
    now[0] = 9.0
    assert fc.prune() == 1 and fc.held() == 0


# -- the peer directory ---------------------------------------------------------
@pytest.mark.parametrize("ids", [(1,), (1, 2), (1, 2, 3, 4), (3, 17, 101, 6,
                                                               42, 9, 1000)])
def test_directory_ranking_equals_the_jax_package(ids):
    jax_pkg, port = _pkg("tpu3fs"), _pkg("tpu3fs_torch")
    keys = [f"blk/{i}" for i in range(200)] + ["", "é"]
    for self_id in (ids[0], 99):
        dirs = [p.serving.PeerDirectory(_routing(_eps(p, ids)), self_id)
                for p in (jax_pkg, port)]
        for key in keys:
            want, got = (
                [ep.node_id for ep in d.ranked(key)] for d in dirs)
            assert got == want and len(got) == len(set(ids) - {self_id})
            assert dirs[1].claim_home(key) == dirs[0].claim_home(key)


def test_directory_health_gate_demotes(pkg):
    eps = _eps(pkg, (1, 2))
    d = pkg.serving.PeerDirectory(_routing(eps), 99, health=_Health())
    ep, demoted = d.pick("k")
    assert ep is not None and not demoted
    d2 = pkg.serving.PeerDirectory(_routing(eps), 99,
                                   health=_Health(deny={ep.node_id}))
    ep2, demoted2 = d2.pick("k")
    assert demoted2 and ep2.node_id != ep.node_id
    d3 = pkg.serving.PeerDirectory(_routing(eps), 99,
                                   health=_Health(deny={1, 2}))
    assert d3.pick("k") == (None, True)
    empty = pkg.serving.PeerDirectory(_routing({}), 1)
    assert empty.pick("k") == (None, False) and empty.claim_home("k") == 1


# -- the fill ladder ------------------------------------------------------------
def test_peer_fill_hits_the_peer_host_tier(pkg, fab):
    fleets, peers = _pair(pkg, fab)
    try:
        blob = b"kv" * 2048
        fleets[1].put("blk/a", blob)
        assert fleets[2].get("blk/a") == blob
        c = fleets[2].counters()
        assert (c["peer_hits"], c["storage_fills"], c["peer_bytes"]) == \
            (1, 0, len(blob))
        assert peers.hosts[1].peer_reads == 1
    finally:
        _close(fleets)


def test_straggling_peer_demotes_to_storage(pkg, fab):
    peers = _Straggling(pkg.service, slow=1, straggle_s=0.3)
    peers._result = pkg.result
    fleets, _ = _pair(pkg, fab, peers=peers)
    try:
        blob = b"s" * 4096
        fleets[1].put("blk/slow", blob)
        t0 = time.monotonic()
        assert fleets[2].get("blk/slow") == blob
        assert time.monotonic() - t0 < 0.25
        c = fleets[2].counters()
        assert c["demotions"] >= 1 and c["storage_fills"] == 1
        assert c["peer_hits"] == 0
    finally:
        _close(fleets)


def test_breaker_open_peer_is_never_asked(pkg, fab):
    peers = _Straggling(pkg.service, slow=None, straggle_s=0.0)
    fleets, _ = _pair(pkg, fab, peers=peers, health=_Health(deny={1}))
    try:
        fleets[1].put("blk/gated", b"b" * 2048)
        assert fleets[2].get("blk/gated") == b"b" * 2048
        c = fleets[2].counters()
        assert peers.calls == 0
        assert (c["demotions"], c["storage_fills"], c["peer_hits"],
                c["peer_misses"]) == (1, 1, 0, 0)
    finally:
        _close(fleets)


def test_concurrent_misses_are_one_storage_fill(pkg, fab):
    kv = pkg.kvcache.KVCacheClient(fab.meta, fab.file_client(),
                                   client_id="solo")
    fleet = pkg.serving.FleetKVCache(kv, node_id=1, routing=_routing({}),
                                     peer_client=LoopbackPeers(pkg.service),
                                     write_through=True)
    try:
        pkg.kvcache.KVCacheClient(fab.meta, fab.file_client()).put(
            "blk/viral", b"v" * 4096)
        fills, mu = {"n": 0}, threading.Lock()
        real_get = kv.get

        def counted_get(key):
            with mu:
                fills["n"] += 1
            time.sleep(0.2)
            return real_get(key)

        kv.get = counted_get
        barrier, results = threading.Barrier(8), []

        def run():
            barrier.wait()
            v = fleet.get("blk/viral")
            with mu:
                results.append(v)

        threads = [threading.Thread(target=run) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert results == [b"v" * 4096] * 8 and fills["n"] == 1
        c = fleet.counters()
        assert (c["storage_fills"], c["coalesced"]) == (1, 7)
        assert fleet.claims.held() == 0
    finally:
        fleet.close(flush=False)


def test_shared_blocks_outlive_unshared_tails(pkg, fab):
    kv = pkg.kvcache.KVCacheClient(fab.meta, fab.file_client())
    fleet = pkg.serving.FleetKVCache(kv, node_id=1, routing=_routing({}),
                                     peer_client=LoopbackPeers(pkg.service),
                                     write_through=True, capacity_bytes=900)
    try:
        for key in ("sh0", "sh1", "un0", "un1"):
            fleet.put(key, b"x" * 200)
        fleet.note_chain(["sh0", "sh1"])
        fleet.note_chain(["sh0", "sh1"])
        fleet.put("new", b"x" * 200)
        assert fleet.tier.contains("sh0") and fleet.tier.contains("sh1")
        assert not fleet.tier.contains("un0")
        fleet.release_chain(["sh0", "sh1"])
        fleet.release_chain(["sh0", "sh1"])
        fleet.put("newer", b"x" * 200)
        assert not fleet.tier.contains("sh0")
    finally:
        fleet.close(flush=False)


# -- the serving host -----------------------------------------------------------
def test_serve_through_never_ships_a_zero_hole(pkg, fab):
    """A GC'd entry read through the host's cached inode is an all-zero
    hole: the host re-probes meta and answers a miss, never the zeros."""
    fleets, peers = _pair(pkg, fab)
    try:
        fleets[1].put("blk/z", b"\x07" * 3000)
        fleets[1].tier.clear()
        host = peers.hosts[1]
        req = pkg.service.PeerReadReq(keys=["blk/z"])
        assert host.peer_read(req).found == [True]     # served through
        gc = pkg.kvcache.KVCacheGC(fab.meta, ttl_s=0.0, max_shards=1 << 20)
        assert gc.run_once(now=time.time() + 10) == 1
        fab.run_gc()
        rsp = host.peer_read(req)
        assert rsp.found == [False] and rsp.blobs == [b""] and rsp.stale == 1
        assert host.stats().stale_detected == 1
        assert host.peer_read(pkg.service.PeerReadReq(
            keys=["blk/z"], serve_through=False)).found == [False]
    finally:
        _close(fleets)


@pytest.mark.parametrize("op,batch", [("put", 0), ("put", 4), ("get", 0),
                                      ("get", 4)])
def test_host_load_legs(pkg, fab, op, batch):
    fleets, peers = _pair(pkg, fab)
    try:
        keys = [f"ld/{i}" for i in range(8)]
        host = peers.hosts[2]
        if op == "get":
            for k in keys:
                fleets[2].put(k, b"\xa5" * 512)
        rsp = host.load(pkg.service.ServingLoadReq(
            op=op, keys=keys, value_bytes=512, concurrency=3, batch=batch,
            drop_host=(op == "get")))
        assert (rsp.ops, rsp.hits, rsp.nbytes, rsp.errors) == \
            (8, 8, 8 * 512, 0)
        assert rsp.storage_fills == (8 if op == "get" else 0)
        with pytest.raises(pkg.result.FsError):
            host.load(pkg.service.ServingLoadReq(op="scan"))
    finally:
        _close(fleets)


# -- the port's socket half ------------------------------------------------------
def test_port_socket_halves_work():
    """The port's ``bind_serving_service`` and ``ServingPeerClient`` (over
    sockets; the shm rings are ROADMAP M6a-3 and raise) carry a peer fill
    between two fleet members over loopback."""
    from tpu3fs_torch.client.hedging import HedgeController
    from tpu3fs_torch.rpc.net import RpcClient, RpcServer
    from tpu3fs_torch.serving import ServingPeerClient, bind_serving_service

    pkg = _pkg("tpu3fs_torch")
    with pytest.raises(NotImplementedError, match="M6a-3"):
        ServingPeerClient(object(), usrbio=True)
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
        num_storage_nodes=2, num_chains=4, num_replicas=2, chunk_size=4096),
        device="cpu")
    server, rpc, fleets = RpcServer(port=0), RpcClient(), {}
    try:
        loop = LoopbackPeers(pkg.service)
        # a socket round trip under a loaded test run can outlast the
        # default 5 ms hedge floor, which would demote the fill to storage
        fleets, _ = _pair(pkg, fab, peers=loop, hedge=HedgeController(
            delay_floor_ms=5000.0))
        bind_serving_service(server, loop.hosts[1])
        server.start()
        ep = fleets[2].directory._routing().serving[1]
        ep.host, ep.port = "127.0.0.1", server.port
        peers = ServingPeerClient(rpc)
        fleets[2].peers = peers
        fleets[1].put("blk/a", b"\x5a" * 3000)
        assert fleets[2].get("blk/a") == b"\x5a" * 3000
        assert fleets[2].counters()["peer_hits"] == 1
        assert peers.stats(ep).keys_served == 1
    finally:
        server.stop()
        rpc.close()
        _close(fleets)
        fab.close()
