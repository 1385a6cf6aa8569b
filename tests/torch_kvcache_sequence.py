"""One seeded KV-cache serving sequence through an in-process fabric, for
the KV-cache parity tests: the same calls drive the JAX package's
``tpu3fs.kvcache``/``tpu3fs.serving`` over its ``Fabric`` and the port's
``tpu3fs_torch.kvcache``/``tpu3fs_torch.serving`` over its ``Fabric(cfg,
device="cpu")``, and ``run_sequence`` returns a record of everything a
user or an operator could observe. This module imports neither package:
the caller hands it a booted fabric and the package's modules.

Two members (``FleetKVCache`` each, with an inode cache) share the fabric
and reach each other through ``LoopbackPeers``, which dispatches peer
calls straight into the other member's ``ServingHost``. Session A is
``a_blocks`` prefix blocks; session B shares its first ``shared`` blocks
and adds ``own`` of its own. The steps:

1. member 1 stores A write-through (one ``batch_put``);
2. member 2 matches B's prefix (``shared`` blocks), pins it and gets
   those blocks: peer fills from member 1's host tier;
3. member 2 appends B's own blocks through the write-back buffer and
   flushes it;
4. both host tiers are cleared; member 1 matches A and gets it cold (the
   fs tier), then again warm (host hits);
5. the first storage node fails; with both host tiers cleared member 2
   gets all of B (degraded reads); the node restarts and resyncs;
6. ``KVCacheGC.capacity_pass`` to ``a_blocks`` pages' bytes with A's
   shared prefix pinned; every removed entry's chunks are reclaimed
   (``run_gc`` until none is left); both
   members read their sessions again (a GC'd entry read through a cached
   inode must come back as a miss, never as zeros); unpin; a TTL pass
   (``run_once``) with the clock past the TTL removes the rest.

What the fabric does not seed itself is drawn from a seed
(``deterministic``): EC writer nonces and uuids (``os.urandom``), layout
seeds (``time.time_ns``), and the wall clock that stamps mtimes, leases
and touches (``time.time``), which only moves between steps. The
write-back flusher is parked while B's blocks are appended
(``held_flusher``), so it drains them in the same batches on every run.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np

BLOCK_TOKENS = 4
PAGE = (2, 2, 2, BLOCK_TOKENS, 32)     # layers, k/v, heads, tokens, dim
CFG = dict(num_storage_nodes=4, num_chains=2, chunk_size=1024, ec_k=12,
           ec_m=4)                     # a page spans 3 stripes, as at 2 MiB
A_BLOCKS, SHARED, OWN = 8, 6, 2
TTL_S = 3600.0


def page(i: int, shape=PAGE) -> np.ndarray:
    """Block ``i``'s KV page, float16 values in [-3, 3) from seed
    1000 + i (the JAX package's kvcache benchmark's pages)."""
    rng = np.random.default_rng(1000 + i)
    return rng.integers(-3, 3, size=shape).astype(np.float16)


class StepClock:
    """A wall clock that moves only when the sequence says so; every other
    attribute is the real ``time`` module's."""

    def __init__(self, t: float = 1_800_000_000.0):
        self.t = t
        self._ns = itertools.count(1_700_000_000_000_000_000, 1_000_003)

    def time(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return next(self._ns)

    def advance(self, dt: float = 10.0) -> None:
        self.t += dt

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def deterministic(clock_modules, seed: int = 0):
    """``os.urandom`` from ``seed`` (one stream per draw size, so a uuid's
    16 bytes never shift a nonce's 4), and ``clock_modules``' ``time``
    replaced by one StepClock, which is yielded."""
    streams = {}

    def urandom(n: int) -> bytes:
        rng = streams.setdefault(n, np.random.default_rng([seed, n]))
        return rng.bytes(n)

    clock = StepClock()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch("os.urandom", urandom))
        for mod in clock_modules:
            stack.enter_context(mock.patch.object(mod, "time", clock))
        yield clock


@contextlib.contextmanager
def held_flusher(cache):
    """Park a TieredKVCache's write-back flusher for the block, then start
    a fresh one: what was buffered meanwhile drains in ``flush_batch``
    batches in append order."""
    cache._stop.set()
    with cache._cond:
        cache._cond.notify_all()
    cache._flusher.join(timeout=10)
    assert not cache._flusher.is_alive(), "the flusher did not park"
    try:
        yield
    finally:
        cache._stop.clear()
        cache._flusher = threading.Thread(
            target=cache._flush_loop, daemon=True, name="kvcache-flush")
        cache._flusher.start()


class LoopbackPeers:
    """The peer client's surface, dispatching into in-process
    ServingHosts (no sockets, no deadlines)."""

    def __init__(self, service):
        self._svc = service
        self.hosts = {}

    def peer_read(self, ep, keys, *, serve_through=True, est_bytes=0,
                  deadline_s=None):
        return self.hosts[ep.node_id].peer_read(self._svc.PeerReadReq(
            keys=list(keys), serve_through=serve_through))

    def fill_claim(self, ep, key, owner, ttl_ms=2000):
        return self.hosts[ep.node_id].fill_claim(self._svc.FillClaimReq(
            key=key, owner=owner, ttl_ms=ttl_ms))

    def fill_release(self, ep, key, owner):
        return self.hosts[ep.node_id].fill_release(
            self._svc.FillReleaseReq(key=key, owner=owner))

    def close(self):
        self.hosts.clear()


def stored(fab) -> dict:
    """target id -> [(chunk id, versions, length, CRC, pending length and
    CRC, aux, sha256 of the committed bytes)] of every target."""
    out = {}
    for node in fab.nodes.values():
        for target in node.service.targets():
            eng = target.engine
            out[target.target_id] = sorted(
                ((m.chunk_id.file_id, m.chunk_id.index), m.committed_ver,
                 m.pending_ver, m.length, m.checksum.value,
                 m.pending_length, m.pending_checksum.value, m.aux,
                 hashlib.sha256(eng.read(m.chunk_id) if m.committed_ver
                                else b"").hexdigest())
                for m in eng.all_metadata())
    return out


def reclaim(fab) -> int:
    """``run_gc`` until no removed file is left (one call takes at most
    64)."""
    total = n = fab.run_gc()
    while n:
        n = fab.run_gc()
        total += n
    return total


def run_sequence(fab, pkg, clock: StepClock, device, to_host, *,
                 a_blocks: int = A_BLOCKS, shared: int = SHARED,
                 own: int = OWN, page_shape=PAGE) -> dict:
    """Drive steps 1-6 (module docstring) on ``fab`` and return the record.

    ``pkg`` gives ``kvcache``, ``serving`` and ``service`` (the package's
    ``serving.service``) and ``ServingEndpoint``; ``device`` is what
    ``get_blocks(device=)`` takes in that package and ``to_host`` turns
    what it returns into a numpy array. Every block read is checked
    against its page: equal, or None where the entry is gone."""
    kvc, srv = pkg.kvcache, pkg.serving
    bt = page_shape[3]
    toks_a = list(range(a_blocks * bt))
    toks_b = toks_a[:shared * bt] + [10_000_000 + t
                                     for t in range(own * bt)]
    pages_a = [page(i, page_shape) for i in range(a_blocks)]
    pages_b = pages_a[:shared] + [page(5000 + i, page_shape)
                                  for i in range(own)]
    entry = len(kvc.encode_array(pages_a[0]))
    cap = 4 * (a_blocks + own) * entry
    endpoints = {n: pkg.ServingEndpoint(node_id=n) for n in (1, 2)}
    routing = SimpleNamespace(serving=endpoints)
    peers = LoopbackPeers(pkg.service)
    fleet, store, leases = {}, {}, {}
    for n in (1, 2):
        fs = kvc.KVCacheClient(fab.meta, fab.file_client(),
                               client_id=f"member{n}", inode_cache=4096)
        fleet[n] = srv.FleetKVCache(
            fs, node_id=n, routing=lambda: routing, peer_client=peers,
            capacity_bytes=cap, dirty_max_bytes=cap)
        peers.hosts[n] = srv.ServingHost(fleet[n], n, claims=fleet[n].claims)
        leases[n] = kvc.LeaseManager(fab.meta, owner=f"member{n}",
                                     default_ttl_s=TTL_S)
        store[n] = kvc.PrefixBlockStore(fleet[n], block_tokens=bt,
                                        leases=leases[n])
    rec = {"blocks": {}, "counters": {}}

    def get(name, n, toks, want, count=None):
        got = store[n].get_blocks(toks, count=count, device=device)
        shas = []
        for blk, w in zip(got, want):
            if blk is None:
                shas.append(None)
                continue
            host = to_host(blk)
            assert host.dtype == w.dtype and host.shape == w.shape
            assert host.tobytes() == w.tobytes(), f"{name}: a block differs"
            shas.append(hashlib.sha256(host.tobytes()).hexdigest())
        rec["blocks"][name] = shas
        rec["counters"][name] = {m: fleet[m].counters() for m in (1, 2)}
        return shas

    def clear_tiers():
        for m in (1, 2):
            fleet[m].tier.clear()

    try:
        # 1: A write-through
        clock.advance()
        rec["put_a"] = store[1].append_blocks(toks_a, pages_a,
                                              write_through=True)
        # 2: B's prefix matched, pinned, peer-filled
        clock.advance()
        m = store[2].match_prefix(toks_b)
        rec["match_b"] = (m.blocks, m.tokens, m.keys)
        lease = store[2].pin_prefix(m)
        rec["pinned"] = list(lease.keys)
        get("peer_fill_b", 2, toks_b, pages_b[:shared], count=m.blocks)
        # 3: B's own blocks through the write-back buffer
        clock.advance()
        with held_flusher(fleet[2]):
            rec["append_b"] = store[2].append_blocks(
                toks_b, pages_b[shared:], start_block=shared)
        assert fleet[2].flush(timeout=120.0), "the write-back did not drain"
        assert fleet[2].dirty_bytes() == 0 and not fleet[2].flush_poisoned
        # 4: A cold from the fs tier, then warm from the host tier
        clock.advance()
        clear_tiers()
        m = store[1].match_prefix(toks_a)
        rec["match_a"] = (m.blocks, m.tokens)
        get("cold_a", 1, toks_a, pages_a)
        get("warm_a", 1, toks_a, pages_a)
        # 5: B read degraded with the first node down; restart, resync
        clock.advance()
        victim = sorted(fab.nodes)[0]
        fab.fail_node(victim)
        clear_tiers()
        get("degraded_b", 2, toks_b, pages_b)
        fab.restart_node(victim)
        rec["resynced"] = fab.resync_all(rounds=6)
        rec["stored"] = stored(fab)
        # 6: capacity GC with A's shared prefix pinned; stale reads; TTL GC
        clock.advance()
        gc = kvc.KVCacheGC(fab.meta, ttl_s=TTL_S, max_shards=1 << 20)
        budget = a_blocks * pages_a[0].nbytes
        rec["gc_capacity"] = gc.capacity_pass(now=clock.t,
                                              capacity_bytes=budget)
        keys = {"a": store[1].block_keys(toks_a),
                "b": store[2].block_keys(toks_b)}
        rec["present"] = {s: fleet[1].fs.batch_contains(k)
                          for s, k in keys.items()}
        assert all(rec["present"]["a"][:shared]), "a pinned block was GC'd"
        rec["gc_chunks"] = reclaim(fab)
        clear_tiers()
        after_b = get("after_gc_b", 2, toks_b, pages_b)
        after_a = get("after_gc_a", 1, toks_a, pages_a)
        assert [s is not None for s in after_b] == rec["present"]["b"]
        assert [s is not None for s in after_a] == rec["present"]["a"]
        rec["unpinned"] = leases[2].unpin(lease)
        rec["gc_ttl"] = gc.run_once(now=clock.t + TTL_S + 1)
        rec["gc_ttl_chunks"] = reclaim(fab)
        rec["present_after"] = fleet[1].fs.batch_contains(
            keys["a"] + keys["b"])
        rec["final_stored"] = stored(fab)
        rec["hosts"] = {n: vars(peers.hosts[n].stats()) for n in (1, 2)}
    finally:
        for n in (1, 2):
            fleet[n].close(flush=False)
    return rec
