"""The port's service apps over sockets against the JAX package's,
tolerance 0.

One seeded file sequence (``tests/torch_fabric_sequence.py``'s: meta
create, full and partial stripe writes, reads, the delta-parity overwrite,
a stopped storage node, the degraded read and a write while it is down,
an empty-disk restart and resync, a chain-encoded file, remove and meta's
GC) runs through a cluster of the JAX package's ``MgmtdApp``,
``StorageApp`` (``engine=mem``, ``usrbio=0``) and ``MetaApp`` and through
the port's (``device="cpu"``), each over loopback TCP
(``tests/torch_socket_sequence.py``), at RS(4,2) on 6 nodes and a CR
cluster of two replicas on 3 nodes. The two must read the same bytes,
store the same chunks (bytes, versions, CRCs), step through the same
routing versions and target states, move the same chunks in the resync
and give the same file lengths.

The same sequence runs again over USRBIO shm rings (the storage apps with
``usrbio=1``, ``TPU3FS_USRBIO=1``), the port's cluster against the JAX
package's: equal reads, stored chunks, routing, resync moves, GC and
lengths, every client and resync messenger of the port's run on rings
only. (The windowed EC path counters are not compared there: the apps'
monitor push resets them every few seconds, and the JAX client waits out
its ring call timeout once at the restart, cut here from 30 s to 2 s: it
learns that an in-process app stopped only when a call times out.)"""

import threading
from unittest import mock

import pytest

from torch_socket_sequence import (
    SHAPES,
    AppCluster,
    deterministic,
    run_sequence,
    threads_left,
)


def _run(pkg: str, shape: str, monkeypatch, usrbio: bool = False,
         **app_kw) -> dict:
    monkeypatch.setenv("TPU3FS_EC_CHAIN_ENCODE", "0")
    monkeypatch.setenv("TPU3FS_USRBIO", "1" if usrbio else "0")
    before = threading.enumerate()
    cluster = None
    try:
        with deterministic(pkg, seed=5):
            cluster = AppCluster(pkg, SHAPES[shape], app_kw=app_kw,
                                 client_kw=app_kw, usrbio=usrbio)
            rec = run_sequence(cluster, monkeypatch.setenv,
                               lambda: None, seed=9)
            rec["transports"] = sorted(
                {t for m in cluster.messengers
                 for t, _, _ in getattr(m, "transport_calls", ())})
            rec["ringed"] = sum(r is not None for m in cluster.messengers
                                for r in m._usrbio_rings.values())
    finally:
        if cluster is not None:
            cluster.close()
    return rec, threads_left(before)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_socket_sequence_matches_jax(shape, monkeypatch):
    want, _ = _run("tpu3fs", shape, monkeypatch)
    got, left = _run("tpu3fs_torch", shape, monkeypatch, device="cpu")
    assert not left, f"threads left by the port's cluster: {left}"
    assert got["reads"] == want["reads"]
    assert got["lengths"] == want["lengths"]
    assert got["failed"] == want["failed"]
    assert got["routing"] == want["routing"]
    assert (got["moved"], got["gc"]) == (want["moved"], want["gc"])
    assert got["ec_paths"] == want["ec_paths"]
    assert got["stored"].keys() == want["stored"].keys()
    for tid, rows in want["stored"].items():
        assert got["stored"][tid] == rows, f"target {tid}"


def test_socket_sequence_runs_the_port_codec_on_every_ec_path(monkeypatch):
    """Over sockets the port's client and storage apps reach what the
    sequence is meant to hold, through the codec's plain versions on the
    CPU: the client encode, the delta-parity RMW, degraded reads, the
    rebuild and the chain encode; every chain ends SERVING."""
    from tpu3fs_torch.ops.crc32c import BatchCrc32c
    from tpu3fs_torch.ops.gf2_matmul import gf2_matmul_plain

    k1, k2 = gf2_matmul_plain.calls, BatchCrc32c.compute.calls
    rec, _ = _run("tpu3fs_torch", "ec_4_2", monkeypatch, device="cpu")
    assert gf2_matmul_plain.calls > k1 and BatchCrc32c.compute.calls > k2
    paths = rec["ec_paths"]
    assert paths["parity_rmw"] >= 1 and paths["degraded"] >= 1
    assert paths["chain_stripes"] == 5 and paths["chain_fallback"] == 0
    assert rec["moved"] >= 1 and rec["gc"] == 1
    assert all(state == "SERVING" for _, (_, ts) in rec["routing"][1].items()
               for _, state in ts)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ring_sequence_matches_jax(shape, monkeypatch):
    from tpu3fs.usrbio.transport import RingClient

    with mock.patch.object(RingClient.__init__, "__defaults__",
                           (128, 64 << 20, 2.0)):
        want, _ = _run("tpu3fs", shape, monkeypatch, usrbio=True)
    got, left = _run("tpu3fs_torch", shape, monkeypatch, usrbio=True,
                     device="cpu")
    assert not left, f"threads left by the port's cluster: {left}"
    assert want["ringed"] and got["ringed"]
    assert got["transports"] == ["ring"]
    assert got["reads"] == want["reads"]
    assert got["lengths"] == want["lengths"]
    assert got["failed"] == want["failed"]
    assert got["routing"] == want["routing"]
    assert (got["moved"], got["gc"]) == (want["moved"], want["gc"])
    assert got["stored"].keys() == want["stored"].keys()
    for tid, rows in want["stored"].items():
        assert got["stored"][tid] == rows, f"target {tid}"
