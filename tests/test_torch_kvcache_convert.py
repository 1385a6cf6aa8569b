"""A KV cache carried across from the JAX package: a JAX fabric holding
prefix blocks (written through ``tpu3fs.kvcache``, a prefix pinned by a
lease) is dumped and loaded into the port's ``Fabric`` on the CPU
(``convert.fabric_from_dump``). The port's ``PrefixBlockStore`` must read
every block the JAX package wrote (equal arrays, the same
``match_prefix``), and the leases must still pin under the port's GC.
Tolerance 0."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

import tpu3fs.fabric as jax_fabric
import tpu3fs.kvcache as jax_kvcache
from test_torch_convert import _dump
from torch_fabric_sequence import deterministic
from torch_kvcache_sequence import page

from tpu3fs_torch import convert, kvcache
from tpu3fs_torch.fabric import SystemSetupConfig

SHAPES = {
    "ec_12_4": dict(num_storage_nodes=4, num_chains=2, chunk_size=1024,
                    ec_k=12, ec_m=4),
    "cr_2": dict(num_storage_nodes=3, num_chains=2, num_replicas=2,
                 chunk_size=1024),
}
BT, SHAPE = 4, (2, 2, 2, 4, 32)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def loaded(request):
    cfg = SHAPES[request.param]
    toks_a = list(range(6 * BT))
    toks_b = toks_a[:3 * BT] + [900 + t for t in range(2 * BT)]
    pages_a = [page(i, SHAPE) for i in range(6)]
    pages_b = [page(5000 + i, SHAPE) for i in range(2)]
    with deterministic(seed=4):
        jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**cfg))
        jcache = jax_kvcache.KVCacheClient(jfab.meta, jfab.file_client())
        jleases = jax_kvcache.LeaseManager(jfab.meta, default_ttl_s=1e6,
                                           owner="jax-session")
        jstore = jax_kvcache.PrefixBlockStore(jcache, block_tokens=BT,
                                              leases=jleases)
        jstore.append_blocks(toks_a, pages_a)
        jstore.append_blocks(toks_b, pages_b, start_block=3)
        lease = jstore.pin_prefix(jstore.match_prefix(toks_a[:2 * BT]))
        dump = _dump(jfab)
    fab = convert.fabric_from_dump(dump, SystemSetupConfig(**cfg),
                                   device="cpu")
    store = kvcache.PrefixBlockStore(
        kvcache.KVCacheClient(fab.meta, fab.file_client()), block_tokens=BT)
    yield SimpleNamespace(fab=fab, store=store, jstore=jstore,
                          toks_a=toks_a, toks_b=toks_b, pages_a=pages_a,
                          pages_b=pages_b, lease=lease)
    fab.close()
    jfab.close()


def test_port_reads_every_jax_block(loaded):
    r = loaded
    for toks, want in ((r.toks_a, r.pages_a),
                       (r.toks_b, r.pages_a[:3] + r.pages_b)):
        host = r.store.get_blocks(toks)
        on_cpu = r.store.get_blocks(toks, device="cpu")
        for h, t, w in zip(host, on_cpu, want):
            assert h.dtype == w.dtype and np.array_equal(h, w)
            assert t.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("cut", [0, 1, 3, 5, 6])
def test_match_prefix_equal(loaded, cut):
    r = loaded
    toks = r.toks_a[:cut * BT] + [77] * (6 - cut) * BT
    got, want = r.store.match_prefix(toks), r.jstore.match_prefix(toks)
    assert (got.blocks, got.tokens, got.keys) == \
        (want.blocks, want.tokens, want.keys) and got.blocks == cut


def test_jax_leases_pin_under_the_port_gc(loaded):
    r = loaded
    pinned = set(r.lease.keys)
    assert len(pinned) == 2
    gc = kvcache.KVCacheGC(r.fab.meta, ttl_s=0.0, max_shards=1 << 20)
    assert gc.capacity_pass(now=time.time(), capacity_bytes=0) == 6
    assert gc.run_once(now=time.time() + 10) == 0
    keys = r.store.block_keys(r.toks_a)
    assert r.store.cache.batch_contains(keys) == [k in pinned for k in keys]
    assert r.store.match_prefix(r.toks_a).blocks == 2
