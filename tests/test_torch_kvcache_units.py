"""The KV-cache modules' unit cases that the slice sequence does not reach,
each run over both packages (the JAX package's ``tpu3fs.kvcache`` and the
port's copy, ``tpu3fs_torch.kvcache``, on the port's ``Fabric(device=
"cpu")``): the host tier's LRU and its refcount-aware eviction scan, the
write-back buffer (read-your-writes, its bound, the batched drain and the
poisoned flush), the stale re-probe in ``PrefixBlockStore._decode``,
leases, the GC's cursor and capacity pass, touch batching and the
batched create. Tolerance 0."""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("kvcache", "kvcache"), ("layout", "kvcache.layout"),
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


def _client(pkg, fab, **kw):
    return pkg.kvcache.KVCacheClient(fab.meta, fab.file_client(), **kw)


def _down(pkg):
    r = pkg.result
    return r.FsError(r.Status(r.Code.TARGET_OFFLINE, "storage down"))


# -- host tier -----------------------------------------------------------------
def test_host_tier_lru_order_and_bound(pkg):
    t = pkg.kvcache.HostTier(capacity_bytes=300)
    for key in "abc":
        t.put(key, key.encode() * 100)
    assert t.get("a") == b"a" * 100     # a refreshed: b is now the LRU
    assert t.put("d", b"d" * 100) == 1  # evicts b
    assert t.get("b") is None and t.contains("a") and t.contains("c")
    assert t.bytes == 300 and len(t) == 3
    assert t.put("huge", b"h" * 500) == 0 and t.get("huge") is None
    t.put("a", b"x" * 40)
    assert t.bytes == 240 and t.remove("a") and not t.remove("a")
    t.clear()
    assert t.bytes == 0 and len(t) == 0


@pytest.mark.parametrize("scan", [1, 2, 8])
def test_host_tier_eviction_scan_skips_shared(pkg, scan):
    """With refcounts installed, eviction takes the first UNSHARED entry
    within ``evict_scan`` of the LRU end, else the plain LRU head."""
    t = pkg.kvcache.HostTier(capacity_bytes=400, evict_scan=scan)
    shared = {"s0", "s1"}
    t.refcount_of = lambda key: 2 if key in shared else 1
    for key in ("s0", "s1", "u0", "u1"):
        t.put(key, b"x" * 100)
    t.put("new", b"y" * 100)
    gone = {k for k in ("s0", "s1", "u0", "u1") if not t.contains(k)}
    assert gone == ({"s0"} if scan < 3 else {"u0"})


# -- write-back tier -----------------------------------------------------------
def test_write_back_read_your_writes_then_durable(pkg, fab):
    base = _client(pkg, fab)
    tc = pkg.kvcache.TieredKVCache(base)
    try:
        tc.put("wb", b"payload" * 100)
        assert tc.get("wb") == b"payload" * 100
        assert tc.flush(10.0) and tc.dirty_bytes() == 0
        assert _client(pkg, fab).get("wb") == b"payload" * 100
        tc.put("wt", b"d" * 512, write_through=True)
        assert tc.dirty_bytes() == 0
        assert _client(pkg, fab).get("wt") == b"d" * 512
    finally:
        tc.close()


def test_dirty_value_readable_after_tier_eviction(pkg, fab):
    base = _client(pkg, fab)
    stall = threading.Event()
    real_put, real_batch = base.put, base.batch_put
    base.put = lambda k, v: (stall.wait(10.0), real_put(k, v))[1]
    base.batch_put = lambda items: (stall.wait(10.0), real_batch(items))[1]
    tc = pkg.kvcache.TieredKVCache(base, capacity_bytes=1024,
                                   dirty_max_bytes=1 << 20)
    try:
        for i in range(8):
            tc.put(f"e/{i}", bytes([i]) * 900)
        assert len(tc.tier) <= 1
        assert [tc.get(f"e/{i}") for i in range(8)] == \
            [bytes([i]) * 900 for i in range(8)]
    finally:
        stall.set()
        tc.close()


def test_dirty_buffer_blocks_at_its_bound(pkg, fab):
    base = _client(pkg, fab)
    stall = threading.Event()
    real_put, real_batch = base.put, base.batch_put
    base.put = lambda k, v: (stall.wait(30.0), real_put(k, v))[1]
    base.batch_put = lambda items: (stall.wait(30.0), real_batch(items))[1]
    tc = pkg.kvcache.TieredKVCache(base, dirty_max_bytes=4096)
    try:
        for i in range(4):
            tc.put(f"s/{i}", bytes([i]) * 1024)
        done = threading.Event()
        t = threading.Thread(
            target=lambda: (tc.put("s/over", b"x" * 1024), done.set()),
            daemon=True)
        t.start()
        assert not done.wait(0.3)
        assert tc.dirty_bytes() <= 4096 + 1024
        stall.set()
        assert done.wait(10.0) and tc.flush(10.0)
        t.join(5.0)
        assert not t.is_alive()
    finally:
        stall.set()
        tc.close()


def test_flusher_drains_in_batches(pkg, fab):
    base = _client(pkg, fab)
    batches = []
    real_batch = base.batch_put
    gate = threading.Event()

    def spy(items):
        items = list(items)
        gate.wait(5.0)
        batches.append(len(items))
        return real_batch(items)

    base.batch_put = spy
    tc = pkg.kvcache.TieredKVCache(base, flush_batch=8)
    try:
        tc.put("bf/0", b"\x00" * 500)
        time.sleep(0.05)             # the flusher takes bf/0 and waits
        for i in range(1, 7):
            tc.put(f"bf/{i}", bytes([i]) * 500)
        gate.set()
        assert tc.flush(10.0)
        assert max(batches) > 1, batches
        assert all(base.get(f"bf/{i}") == bytes([i]) * 500 for i in range(7))
    finally:
        gate.set()
        tc.close()


def test_flush_failures_poison_then_recover(pkg, fab):
    base = _client(pkg, fab)
    dead = threading.Event()
    dead.set()
    real_put, real_batch = base.put, base.batch_put

    def put(key, value):
        if dead.is_set():
            raise _down(pkg)
        return real_put(key, value)

    def batch_put(items):
        if dead.is_set():
            raise _down(pkg)
        return real_batch(items)

    base.put, base.batch_put = put, batch_put
    tc = pkg.kvcache.TieredKVCache(base, flush_error_budget=3)
    try:
        tc.put("p/0", b"a" * 100)
        deadline = time.monotonic() + 10.0
        while not tc.flush_poisoned and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tc.flush_poisoned
        with pytest.raises(pkg.result.FsError) as ei:
            tc.put("p/1", b"b" * 100)
        assert ei.value.code == pkg.result.Code.KVCACHE_FLUSH_POISONED
        assert tc.get("p/0") == b"a" * 100
        dead.clear()
        assert tc.flush(10.0) and not tc.flush_poisoned
        tc.put("p/2", b"c" * 100)
        assert tc.flush(10.0) and base.get("p/2") == b"c" * 100
    finally:
        dead.clear()
        tc.close()


def test_remove_drops_tier_and_dirty(pkg, fab):
    base = _client(pkg, fab)
    stall = threading.Event()
    real_put = base.put
    base.put = lambda k, v: (stall.wait(10.0), real_put(k, v))[1]
    tc = pkg.kvcache.TieredKVCache(base)
    try:
        tc.put("gone", b"g" * 256)
        tc.remove("gone")
        assert tc.get("gone") is None
        stall.set()
        assert tc.flush(10.0)
    finally:
        stall.set()
        tc.close()


# -- the stale re-probe --------------------------------------------------------
class _StubCache:
    """batch_get serves ``first``; get serves ``again``."""

    def __init__(self, first, again, invalidate=True):
        self.first, self.again, self.invalidated = first, again, []
        if invalidate:
            self.invalidate = self.invalidated.append

    def batch_get(self, keys):
        return [self.first] * len(keys)

    def get(self, key):
        return self.again


@pytest.mark.parametrize("case", ["rewritten", "gone", "no_invalidate",
                                  "corrupt"])
def test_stale_read_reprobes_once(pkg, case):
    layout = pkg.layout
    page = np.arange(16, dtype=np.float16).reshape(2, 8)
    raw = layout.encode_array(page)
    hole = b"\0" * len(raw)
    cache = {"rewritten": _StubCache(hole, raw),
             "gone": _StubCache(hole, None),
             "no_invalidate": _StubCache(hole, raw, invalidate=False),
             "corrupt": _StubCache(b"\x01" + raw[1:12] + b"\0" * 4, raw)}[case]
    store = pkg.kvcache.PrefixBlockStore(cache, block_tokens=2)
    if case == "corrupt":
        with pytest.raises(pkg.result.FsError) as ei:
            store.get_blocks([1, 2])
        assert ei.value.code == pkg.result.Code.KVCACHE_CORRUPT
        return
    (got,) = store.get_blocks([1, 2])
    if case == "rewritten":
        assert np.array_equal(got, page)
        assert cache.invalidated == store.block_keys([1, 2])
    else:
        assert got is None


# -- leases --------------------------------------------------------------------
def test_unpin_keeps_a_longer_foreign_lease(pkg, fab):
    c = _client(pkg, fab)
    c.put("shared", b"s" * 64)
    long_mgr = pkg.kvcache.LeaseManager(fab.meta, default_ttl_s=600.0,
                                        owner="long")
    short_mgr = pkg.kvcache.LeaseManager(fab.meta, default_ttl_s=60.0,
                                         owner="short")
    long_lease = long_mgr.pin(["shared"])
    short = short_mgr.pin(["shared"])
    assert short_mgr.unpin(short) == 0 and short_mgr.active == 0
    gc = pkg.kvcache.KVCacheGC(fab.meta, ttl_s=0.0, max_shards=1 << 20)
    assert gc.run_once(now=time.time() + 10) == 0
    assert long_mgr.unpin(long_lease) == 1
    assert gc.run_once(now=time.time() + 10) == 1


def test_lease_expiry_and_renewal(pkg, fab):
    c = _client(pkg, fab)
    c.put("brief", b"b" * 128)
    c.put("renewed", b"r")
    mgr = pkg.kvcache.LeaseManager(fab.meta, default_ttl_s=30.0)
    mgr.pin(["brief", "missing"])
    lease = mgr.pin(["renewed"])
    mgr.renew(lease, ttl_s=600.0)
    gc = pkg.kvcache.KVCacheGC(fab.meta, ttl_s=0.0, max_shards=1 << 20)
    # past the 30 s pin, inside the renewed 600 s one
    assert gc.run_once(now=time.time() + 60) == 1
    assert c.get("brief") is None and c.get("renewed") == b"r"


# -- GC ------------------------------------------------------------------------
@pytest.mark.parametrize("max_shards", [1, 1 << 20])
def test_gc_cursor_covers_every_shard_once(pkg, fab, max_shards):
    c = _client(pkg, fab)
    for i in range(8):
        c.put(f"b/{i}", b"x")
    gc = pkg.kvcache.KVCacheGC(fab.meta, ttl_s=0.0, max_shards=max_shards)
    total, passes = 0, 0
    while total < 8 and passes < 600:
        total += gc.run_once(now=time.time() + 10)
        passes += 1
    assert total == 8 and (passes > 1) == (max_shards == 1)
    assert gc.run_once(now=time.time() + 10) == 0


def test_capacity_pass_evicts_oldest_first(pkg, fab):
    c = _client(pkg, fab)
    now = time.time()
    for i in range(4):
        c.put(f"cap/{i}", bytes([i]) * 1000)
        fab.meta.set_attr(pkg.kvcache.shard_path(c.root, f"cap/{i}"),
                          mtime=now - 100 + i)
    gc = pkg.kvcache.KVCacheGC(fab.meta, ttl_s=1e9, capacity_bytes=2000)
    assert gc.capacity_pass(now=now) == 2
    assert [c.get(f"cap/{i}") is None for i in range(4)] == \
        [True, True, False, False]
    assert gc.capacity_pass(now=now) == 0


# -- touches and the batched create -------------------------------------------
def test_batch_get_touches_in_one_metadata_call(pkg, fab):
    c = _client(pkg, fab)
    for i in range(8):
        c.put(f"t/{i}", b"v")
    calls = {"batch": 0, "single": 0}
    real_batch, real_single = fab.meta.batch_set_attr, fab.meta.set_attr

    def spy(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    fab.meta.batch_set_attr = spy("batch", real_batch)
    fab.meta.set_attr = spy("single", real_single)
    assert all(b is not None for b in c.batch_get([f"t/{i}" for i in range(8)]))
    c.get("t/0")
    assert calls == {"batch": 2, "single": 0}


def test_coalesced_touch_drains_once(pkg, fab):
    c = _client(pkg, fab, touch_coalesce_s=30.0)
    c.put("cz", b"z")
    calls = {"n": 0}
    real = fab.meta.batch_set_attr

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    fab.meta.batch_set_attr = spy
    for _ in range(10):
        assert c.get("cz") == b"z"
    assert calls["n"] == 0
    c.flush_touches()
    assert calls["n"] == 1


def test_append_blocks_drain_is_one_batch_create(pkg, fab):
    c = _client(pkg, fab)
    calls = {"create": 0, "batch_create": 0}
    real_create, real_batch = fab.meta.create, fab.meta.batch_create

    def spy_create(*a, **kw):
        calls["create"] += 1
        return real_create(*a, **kw)

    def spy_batch(items, *a, **kw):
        calls["batch_create"] += 1
        return real_batch(items, *a, **kw)

    fab.meta.create, fab.meta.batch_create = spy_create, spy_batch
    store = pkg.kvcache.PrefixBlockStore(c, block_tokens=4)
    blocks = [np.full((2, 2, 4, 8), i, dtype=np.float16) for i in range(4)]
    assert store.append_blocks(list(range(16)), blocks) == 4
    assert calls == {"create": 0, "batch_create": 1}
    assert store.append_blocks(list(range(16)), blocks) == 0
    for got, want in zip(store.get_blocks(list(range(16))), blocks):
        assert np.array_equal(got, want)
