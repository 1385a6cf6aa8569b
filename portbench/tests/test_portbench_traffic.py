"""The traffic's bytes from a seed (the pool and the stamps), and its sizes
as their sources give them."""

import numpy as np
import pytest

from portbench.reference import payload
from portbench.tests.cells import load_cell

S = 4096


def test_pool_and_calls_repeat_from_the_seed():
    a = payload.make_pool(2**31 + 5, 1 << 16, "cpu")
    assert np.array_equal(a, payload.make_pool(2**31 + 5, 1 << 16, "cpu"))
    assert not np.array_equal(a, payload.make_pool(2**31 + 6, 1 << 16, "cpu"))
    pool = payload.make_pool(9, payload.pool_bytes(8 * S, S, 4), "cpu")
    one = payload.call_bytes_of(pool, 9, 1, 2, 3, 8 * S, S)
    assert np.array_equal(one, payload.call_bytes_of(pool, 9, 1, 2, 3, 8 * S,
                                                     S))
    assert one.size == 8 * S


def test_every_piece_of_every_call_differs():
    pool = payload.make_pool(3, payload.pool_bytes(4 * S, S, 4), "cpu")
    seen = set()
    for w in range(4):
        for f in range(3):
            for c in range(3):
                buf = payload.call_bytes_of(pool, 3, w, f, c, 4 * S, S)
                for piece in buf.reshape(-1, S):
                    seen.add(piece.tobytes())
    assert len(seen) == 4 * 3 * 3 * 4


def test_stamping_in_place_equals_the_reference_call():
    pool = payload.make_pool(4, payload.pool_bytes(4 * S, S, 2), "cpu")
    buf = payload.base_of(pool, 1, 4 * S, S).copy()
    for c in range(3):  # a writer restamps its one buffer call after call
        payload.stamp(buf, 4, 1, 7, c, S)
        assert np.array_equal(buf, payload.call_bytes_of(pool, 4, 1, 7, c,
                                                         4 * S, S))


def test_the_write_traffic_is_one_ranks_checkpoint():
    """One rank's share of DeepSeek-V3's training state (671e9 parameters,
    FP32 master weights and two BF16 moments, 2048 ranks), saved on two
    threads, a file each, in whole calls of whole stripes."""
    cell = load_cell("ec-write")
    c, t = cell.config, cell.traffic
    shard = 671e9 * (4 + 2 + 2) / 2048
    assert t["writers"] == 2
    assert t["writers"] * t["file_bytes"] == pytest.approx(shard, rel=0.002)
    assert t["file_bytes"] % t["call_bytes"] == 0
    assert t["call_bytes"] % c["chunk_size"] == 0
    assert t["call_bytes"] <= 7168 * 2048 * 4 < t["call_bytes"] + \
        c["chunk_size"]
    assert min(t["check_files"]) >= 1


def test_the_restore_reads_one_ranks_file():
    w, r = load_cell("ec-write").traffic, load_cell("ec-degraded-read").traffic
    assert r["file_bytes"] == w["writers"] * w["file_bytes"]
    assert r["call_bytes"] == w["call_bytes"]
    assert r["readers"] == r["files"] == 1
