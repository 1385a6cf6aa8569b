"""The storage tier's parts in the port, on the CPU: ``crc32c_many`` (one
K2 call over front-padded rows) against ``crc32c_py``, ``Checksum``
against the JAX package's, the mem engine against the JAX package's
over one op sequence, ``engine_from_chunks`` loading a target the JAX
package wrote, the planted ``chain_parity_skip`` bug caught by a degraded
read, and the parts that are not ported raising. Tolerance 0."""

import threading

import numpy as np
import pytest
import torch

from tpu3fs.storage import engine as jengine
from tpu3fs.storage import types as jtypes
from tpu3fs_torch import convert
from tpu3fs_torch.analytics import spans
from tpu3fs_torch.chaos import bugs
from tpu3fs_torch.ops import crc32c as tcrc
from tpu3fs_torch.ops.stripe import get_codec
from tpu3fs_torch.storage import engine as tengine
from tpu3fs_torch.storage import target as ttarget
from tpu3fs_torch.storage import types as ttypes
from tpu3fs_torch.storage.craq import StorageService
from tpu3fs_torch.storage.ec_resync import EcResyncWorker
from tpu3fs_torch.utils.fault_injection import plane
from torch_storage_tier import (EC_CHAIN, Tier, payloads, read_stripe,
                                write_stripes)

# the lengths chip_smoke.py holds crc32c_many to on the card, scaled down
# where they pass a row size: 0, 1, 511, 512, 513, an EC shard, 1 MiB + 3
EDGE_LENGTHS = [0, 1, 511, 512, 513, 1000, 1536, 349_696 // 16, 65_539]


@pytest.mark.parametrize("seed", range(6))
def test_crc32c_many_matches_crc32c_py(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5000, 7).tolist() + EDGE_LENGTHS[:seed + 1]
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    got = tcrc.crc32c_many(bufs, device="cpu")
    assert got == [tcrc.crc32c_py(b) for b in bufs]
    # a buffer alone pads to its own row size and gives the same CRC
    assert [tcrc.crc32c_many([b], device="cpu")[0] for b in bufs[:3]] \
        == got[:3]


def test_crc32c_many_takes_views_and_arrays():
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, 3000, dtype=np.uint8)
    bufs = [memoryview(raw.tobytes())[17:2017], bytearray(raw[:700]),
            raw[5:1205], memoryview(raw.tobytes())[::3]]
    want = [tcrc.crc32c_py(b.tobytes() if isinstance(b, np.ndarray)
                           else bytes(b)) for b in bufs]
    assert tcrc.crc32c_many(bufs, device="cpu") == want
    assert tcrc.crc32c_many([], device="cpu") == []


@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_front_padding_identity(length):
    """crc(x) = crc(0^p || x) ^ crc32c_zeros(L) ^ crc32c_zeros(len x) for
    a row of L = padded_row_size(len x) bytes, through BatchCrc32c's plain
    version."""
    size = tcrc.padded_row_size(length)
    assert size >= max(length, 512) and size % 512 == 0
    x = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8)
    row = np.zeros((1, size), dtype=np.uint8)
    row[0, size - length:] = x
    padded = int(tcrc.BatchCrc32c(size, device="cpu")(
        torch.from_numpy(row))[0])
    assert padded == tcrc.crc32c_py(row[0].tobytes())
    assert padded ^ tcrc.crc32c_zeros(size) ^ tcrc.crc32c_zeros(length) \
        == tcrc.crc32c_py(x.tobytes())


def test_crc32c_many_from_many_threads():
    """The row codecs are cached under a lock: 24 threads over 6 row sizes
    get the right CRCs and one codec a size."""
    sizes = [100, 600, 1500, 3000, 5000, 9000]
    rng = np.random.default_rng(4)
    bufs = {n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in sizes}
    want = {n: tcrc.crc32c_py(b) for n, b in bufs.items()}
    with tcrc._many_lock:
        tcrc._many_codecs.clear()
    errors = []

    def work(i):
        try:
            for r in range(4):
                n = sizes[(i + r) % len(sizes)]
                if tcrc.crc32c_many([bufs[n]], device="cpu") != [want[n]]:
                    errors.append(n)
        except Exception as e:  # a worker's failure fails the test
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    keys = [k for k in tcrc._many_codecs if k[1].type == "cpu"]
    assert sorted(k[0] for k in keys) == sorted(
        {tcrc.padded_row_size(n) for n in sizes})


def test_checksum_matches_jax():
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 700, 4096, 5000)]
    many = ttypes.Checksum.of_many(bufs, device="cpu")
    assert many == [ttypes.Checksum.of(b, device="cpu") for b in bufs]
    assert [(c.value, c.length) for c in many] == [
        (c.value, c.length) for c in jtypes.Checksum.of_many(bufs)]
    a, b = many[2], many[3]
    assert a.combine(b) == ttypes.Checksum.of(bufs[2] + bufs[3], "cpu")


def _engine_ops(pkg_engine, pkg_types, engine):
    """One op sequence through a mem engine: stage, commit, COW partial
    update, validated install, EC stage, truncate, batched update."""
    ChunkId = pkg_types.ChunkId
    rng = np.random.default_rng(11)
    out = []
    a = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    out.append(engine.update(ChunkId(1, 0), 1, 1, a, 0, chunk_size=4096))
    out.append(engine.commit(ChunkId(1, 0), 1, 1))
    out.append(engine.update(ChunkId(1, 0), 2, 1, b, 2950, chunk_size=4096))
    out.append(engine.commit(ChunkId(1, 0), 2, 1))
    crc = pkg_types.Checksum.of(a, **({"device": "cpu"}
                                      if pkg_types is ttypes else {}))
    out.append(engine.update(ChunkId(1, 1), 3, 1, a, 0, full_replace=True,
                             chunk_size=4096, expected_crc=crc.value))
    out.append(engine.update(ChunkId(1, 2), 1, 1, b, 0, stage_replace=True,
                             chunk_size=4096, aux=77))
    out.append(engine.truncate(ChunkId(1, 0), 1000, 1))
    res = engine.batch_update([pkg_engine.EngineUpdateOp(
        ChunkId(2, i), a[:500 * (i + 1)], chunk_size=4096) for i in range(4)],
        1)
    out.append([(int(r.code), r.ver, r.length, r.crc) for r in res])
    out.append([(m.committed_ver, m.pending_ver, m.length, m.checksum.value,
                 m.pending_length, m.pending_checksum.value, m.aux)
                for m in engine.all_metadata()])
    out.append(engine.read_verified(ChunkId(1, 0), 10, 50))
    return [repr(o) for o in out]


def test_mem_engine_matches_jax():
    want = _engine_ops(jengine, jtypes, jengine.MemChunkEngine())
    got = _engine_ops(tengine, ttypes, tengine.MemChunkEngine(device="cpu"))
    assert got == want


def test_engine_from_chunks_loads_a_jax_target():
    jeng = jengine.MemChunkEngine()
    rng = np.random.default_rng(12)
    for i in range(5):
        data = rng.integers(0, 256, 300 * i + 1, dtype=np.uint8).tobytes()
        jeng.update(jtypes.ChunkId(3, i), i + 1, 2, data, 0,
                    full_replace=True, chunk_size=4096, aux=i)
    dump = [{"chunk_id": (m.chunk_id.file_id, m.chunk_id.index),
             "committed_ver": m.committed_ver, "chain_ver": m.chain_ver,
             "data": jeng.read(m.chunk_id), "crc": m.checksum.value,
             "length": m.length, "aux": m.aux} for m in jeng.all_metadata()]
    eng = convert.engine_from_chunks(dump, device="cpu")
    fields = lambda m: (m.chunk_id.file_id, m.chunk_id.index,  # noqa: E731
                        m.chain_ver, m.committed_ver, m.length,
                        m.checksum.value, m.aux)
    assert [fields(m) for m in eng.all_metadata()] == [
        fields(m) for m in jeng.all_metadata()]
    for m in jeng.all_metadata():
        assert eng.read(ttypes.ChunkId(m.chunk_id.file_id, m.chunk_id.index)) \
            == jeng.read(m.chunk_id)
    bad = dict(dump[2], crc=dump[2]["crc"] ^ 1)
    with pytest.raises(ValueError, match="crc"):
        convert.engine_from_chunks([bad], device="cpu")
    with pytest.raises(ValueError, match="length"):
        convert.engine_from_chunks([dict(dump[2], length=7)], device="cpu")


def test_chain_parity_skip_caught_by_degraded_read():
    """The planted hop bug (a hop installs its shard but forwards the
    accumulator unchanged) installs cleanly; a degraded read that decodes
    from parity returns wrong bytes."""
    k, m, S = 3, 2, 1024
    codec = get_codec(k, m, S, device="cpu")
    tier = Tier("tpu3fs_torch", k + m,
                [(EC_CHAIN, list(range(k + m)), k, m, S)], device="cpu")
    ChunkId = tier.types.ChunkId
    data = payloads(np.random.default_rng(6), 2, k * S, 100)
    try:
        plane().configure("point=storage.read,prob=0")  # a crash window
        bugs.arm("chain_parity_skip")
        reps = write_stripes(tier, codec, [(ChunkId(1, i), d)
                                           for i, d in enumerate(data)],
                             1, chain_encode=True)
        assert all(r[0] == 0 for r in reps)  # installs cleanly
    finally:
        bugs.disarm()
        plane().clear()
    reps = write_stripes(tier, codec, [(ChunkId(2, i), d)
                                       for i, d in enumerate(data)],
                         1, chain_encode=True)
    assert all(r[0] == 0 for r in reps)
    for f in (1, 2):  # every shard up: the data shards answer
        assert read_stripe(tier, codec, ChunkId(f, 0)) == data[0]
    tier.fail_node(tier.node_of(tier.chain(EC_CHAIN).target_of_shard(0)
                                .target_id))
    assert read_stripe(tier, codec, ChunkId(1, 0)) != data[0]
    assert read_stripe(tier, codec, ChunkId(2, 0)) == data[0]
    tier.close()


def test_unported_parts_raise():
    svc = StorageService(10, lambda: None, device="cpu")
    with pytest.raises(NotImplementedError, match="M7/M8"):
        EcResyncWorker(svc, lambda *a: None, mesh=object(), device="cpu")
    for kind in ("native", "auto"):
        with pytest.raises(ValueError, match="M6b"):
            ttarget.StorageTarget(1, 1, engine=kind, device="cpu")
    with pytest.raises(NotImplementedError, match="M6a"):
        spans.Tracer().configure(directory="/nonexistent")
    # a target on another device than its service's
    with pytest.raises(ValueError, match="service on cpu"):
        svc.add_target(ttarget.StorageTarget(1, 1, device="meta"))
    with pytest.raises(ValueError, match="service on cpu"):
        EcResyncWorker(svc, lambda *a: None, device="meta")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: StorageService(10, lambda: None),
                 lambda: ttarget.StorageTarget(1, 1),
                 lambda: tengine.MemChunkEngine(),
                 lambda: tcrc.crc32c_many([b"x"]),
                 lambda: ttypes.Checksum.of(b"x"),
                 lambda: EcResyncWorker(StorageService(10, lambda: None,
                                                       device="cpu"),
                                        lambda *a: None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
