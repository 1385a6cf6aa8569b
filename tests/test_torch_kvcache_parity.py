"""The KV-cache serving slice on the CPU: one seeded sequence (two fleet
members over an RS(12,4) fabric: a write-through prefix, peer fills, a
write-back flush, cold and warm prefix gets, a degraded get with a node
down, capacity and TTL GC with a pinned prefix, stale reads after GC)
through the JAX package's ``tpu3fs.kvcache`` and ``tpu3fs.serving`` and
through the port's, on the port's ``Fabric(device="cpu")``. Replies, every
block's bytes, every target's stored chunks and the GC's removals must be
equal. Tolerance 0."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

import tpu3fs.fabric as jax_fabric
import tpu3fs.kvcache as jax_kvcache
import tpu3fs.meta.store as jax_meta_store
import tpu3fs.meta.types as jax_meta_types
import tpu3fs.serving as jax_serving
import tpu3fs.serving.service as jax_service
from tpu3fs.mgmtd.types import ServingEndpoint as JaxEndpoint
from torch_kvcache_sequence import CFG, deterministic, run_sequence

import tpu3fs_torch.kvcache as kvcache
import tpu3fs_torch.meta.store as meta_store
import tpu3fs_torch.meta.types as meta_types
import tpu3fs_torch.serving as serving
import tpu3fs_torch.serving.service as service
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.mgmtd.types import ServingEndpoint


def _clock_modules(kv, store, types):
    return [store, types, kv.cache, kv.leases, kv.layout]


def _jax_run(**kw):
    pkg = SimpleNamespace(kvcache=jax_kvcache, serving=jax_serving,
                          service=jax_service, ServingEndpoint=JaxEndpoint)
    with deterministic(_clock_modules(jax_kvcache, jax_meta_store,
                                      jax_meta_types)) as clock:
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**CFG))
        try:
            return run_sequence(fab, pkg, clock, jax.devices("cpu")[0],
                                np.asarray, **kw)
        finally:
            fab.close()


def _port_run(**kw):
    pkg = SimpleNamespace(kvcache=kvcache, serving=serving, service=service,
                          ServingEndpoint=ServingEndpoint)
    with deterministic(_clock_modules(kvcache, meta_store,
                                      meta_types)) as clock:
        fab = Fabric(SystemSetupConfig(**CFG), device="cpu")
        try:
            return run_sequence(fab, pkg, clock, "cpu",
                                lambda t: t.numpy(), **kw)
        finally:
            fab.close()


@pytest.fixture(scope="module")
def runs():
    return _jax_run(), _port_run()


def test_port_record_equals_jax(runs):
    jax_rec, port_rec = runs
    assert port_rec == jax_rec


@pytest.mark.parametrize("field", [
    "put_a", "match_b", "pinned", "append_b", "match_a", "resynced",
    "gc_capacity", "present", "gc_chunks", "unpinned", "gc_ttl",
    "gc_ttl_chunks", "present_after"])
def test_each_reply_equal(runs, field):
    jax_rec, port_rec = runs
    assert port_rec[field] == jax_rec[field]


@pytest.mark.parametrize("step", [
    "peer_fill_b", "cold_a", "warm_a", "degraded_b", "after_gc_b",
    "after_gc_a"])
def test_each_read_equal(runs, step):
    jax_rec, port_rec = runs
    assert port_rec["blocks"][step] == jax_rec["blocks"][step]
    assert port_rec["counters"][step] == jax_rec["counters"][step]


def test_stored_chunks_equal(runs):
    jax_rec, port_rec = runs
    assert port_rec["stored"] == jax_rec["stored"]
    assert port_rec["final_stored"] == jax_rec["final_stored"]


def test_sequence_shape(runs):
    """What the sequence must show on its own: A stored whole, B's prefix
    matched and peer-filled, B's own blocks written back, the GC evicting
    the unpinned tail and one of B's blocks, a GC'd block read as a miss,
    and nothing left after the TTL pass."""
    _, rec = runs
    assert rec["put_a"] == 8 and rec["append_b"] == 2
    assert rec["match_b"][:2] == (6, 24) and len(rec["pinned"]) == 6
    assert rec["counters"]["peer_fill_b"][2]["peer_hits"] == 6
    assert rec["counters"]["cold_a"][1]["storage_fills"] == 8
    assert rec["gc_capacity"] == 3
    assert rec["present"]["a"] == [True] * 6 + [False] * 2
    assert rec["present"]["b"].count(False) == 1
    assert rec["blocks"]["after_gc_b"].count(None) == 1
    assert rec["unpinned"] == 6 and rec["gc_ttl"] == 7
    assert not any(rec["present_after"])
    assert rec["final_stored"] == {t: [] for t in rec["final_stored"]}
