"""The port's kvd (``tpu3fs_torch.kv.service``) and network KV engine
(``kv.remote``) against the JAX package's, over loopback TCP.

One seeded sequence of Kv RPCs (snapshots, gets, range reads, commits with
read conflicts, versionstamped keys, clears, releases) goes to a JAX kvd
and to a port kvd: every reply (or error code) must serialise to the same
bytes. Each package's ``RemoteKVEngine`` drives the other's server
through ``with_transaction`` to the same results as the JAX package on
its own. A write-ahead log written by one package (with a compaction
snapshot record in it) has the same bytes as the other's, and replays in
the other package to equal contents. Tolerance 0; every server is stopped
in a ``finally``."""

import importlib

import numpy as np
import pytest

PKGS = ("tpu3fs", "tpu3fs_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class Kvd:
    """One package's KvService on an RpcServer of that package, port 0."""

    def __init__(self, pkg: str, **kw):
        self.svc = mod(pkg, "kv.service").KvService(**kw)
        self.server = mod(pkg, "rpc.net").RpcServer(port=0)
        mod(pkg, "kv.service").bind_kv_service(self.server, self.svc)
        self.server.start()
        self.addr = ("127.0.0.1", self.server.port)

    def stop(self):
        self.server.stop()
        self.svc.close()


def _keys(rng, n):
    return sorted({b"k/%03d" % int(i) for i in rng.integers(0, 40, n)})


def _rpc_sequence(addr, seed: int) -> list:
    """Raw Kv RPCs (the JAX package's types and client: the wire is the
    thing compared) -> each reply serialised, or its error code."""
    from tpu3fs.kv import service as S
    from tpu3fs.rpc.net import RpcClient
    from tpu3fs.rpc.serde import serialize
    from tpu3fs.utils.result import FsError

    rng = np.random.default_rng(seed)
    cli = RpcClient()
    out = []

    def call(method, req, rsp_type):
        try:
            rsp = cli.call(addr, S.KV_SERVICE_ID, method, req, rsp_type)
        except FsError as e:
            out.append(("error", int(e.code)))
            return None
        out.append(serialize(rsp))
        return rsp

    try:
        first = [S.WriteEntry(k, rng.bytes(int(rng.integers(0, 24))))
                 for k in _keys(rng, 30)]
        call(4, S.CommitReq(writes=first), S.CommitRsp)
        v1 = call(1, S.SnapshotReq("seq"), S.SnapshotRsp).version
        for k in _keys(rng, 12):
            call(2, S.GetReq(k, v1), S.GetRsp)
        call(3, S.RangeReq(b"k/", b"k0", v1), S.RangeRsp)
        call(3, S.RangeReq(b"k/010", b"k/030", v1, limit=5, reverse=True),
             S.RangeRsp)
        call(3, S.RangeReq(b"k/005", b"k/020", v1, limit=3), S.RangeRsp)
        hot = first[0].key
        # a read-modify-write at v1 commits; a second one at v1 reading
        # the same key conflicts
        call(4, S.CommitReq(read_version=v1, read_keys=[hot],
                            writes=[S.WriteEntry(hot, b"new")]),
             S.CommitRsp)
        call(4, S.CommitReq(read_version=v1, read_keys=[hot],
                            writes=[S.WriteEntry(hot, b"lost")]),
             S.CommitRsp)
        # a read range that a later commit touched conflicts too
        call(4, S.CommitReq(read_version=v1,
                            read_ranges=[S.RangeEntry(b"k/", b"k0")],
                            writes=[S.WriteEntry(b"z", b"1")]),
             S.CommitRsp)
        # versionstamped keys, a tombstone and a cleared range in one commit
        stamps = [S.StampEntry(b"vs/", rng.bytes(3), rng.bytes(5))
                  for _ in range(3)]
        call(4, S.CommitReq(
            writes=[S.WriteEntry(first[1].key, b"", True)],
            clear_ranges=[S.RangeEntry(b"k/020", b"k/030")],
            versionstamped=stamps), S.CommitRsp)
        v2 = call(1, S.SnapshotReq("seq"), S.SnapshotRsp).version
        call(3, S.RangeReq(b"", b"\xff", v2), S.RangeRsp)
        call(3, S.RangeReq(b"vs/", b"vs0", v2, reverse=True), S.RangeRsp)
        call(2, S.GetReq(first[1].key, v2), S.GetRsp)
        call(2, S.GetReq(hot, v1), S.GetRsp)   # the pinned old version
        call(5, S.ReleaseReq(v1), S.EmptyMsg)
        call(5, S.ReleaseReq(v2), S.EmptyMsg)
        call(2, S.GetReq(hot, 0), S.GetRsp)    # below the floor: too old
    finally:
        cli.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpc_sequence_replies_equal(seed):
    kvds = []
    try:
        kvds = [Kvd(pkg) for pkg in PKGS]
        jax_out, port_out = (_rpc_sequence(k.addr, seed) for k in kvds)
    finally:
        for k in kvds:
            k.stop()
    assert port_out == jax_out
    assert ("error", int(mod("tpu3fs", "utils.result").Code.KV_CONFLICT)) \
        in jax_out


def _pairs(pairs) -> list:
    return [(p.key, p.value) for p in pairs]


def _engine_sequence(pkg: str, addr) -> list:
    """``with_transaction`` closures through ``pkg``'s RemoteKVEngine."""
    kv = mod(pkg, "kv.kv")
    result = mod(pkg, "utils.result")
    eng = mod(pkg, "kv.remote").RemoteKVEngine(addr, client_id=f"{pkg}-c")
    out = []
    try:
        kv.with_transaction(eng, lambda tx: [
            tx.set(b"e/%02d" % i, b"v%d" % i) for i in range(12)])
        out.append(kv.with_transaction(eng, lambda tx: tx.get(b"e/03")))
        out.append(kv.with_transaction(eng, lambda tx: _pairs(
            tx.get_range(b"e/02", b"e/09", limit=4))))

        def overlay(tx):
            tx.clear_range(b"e/05", b"e/08")
            tx.set(b"e/06", b"again")
            return [tx.get(b"e/05"), tx.get(b"e/06"),
                    _pairs(tx.get_range(b"e/", b"e0"))]

        out.append(kv.with_transaction(eng, overlay))
        kv.with_transaction(eng, lambda tx: tx.set_versionstamped_key(
            b"st/", b"!", b"stamped"))
        out.append(kv.with_transaction(eng, lambda tx: [
            (len(p.key), p.value) for p in tx.get_range(b"st/", b"st0")]))
        # two transactions race on one key: the later commit conflicts
        t1, t2 = eng.transaction(), eng.transaction()
        for t in (t1, t2):
            t.get(b"e/00")
            t.set(b"e/00", b"race")
        t1.commit()
        with pytest.raises(result.FsError) as ei:
            t2.commit()
        out.append(int(ei.value.code))
        out.append(kv.with_transaction(eng, lambda tx: _pairs(
            tx.get_range(b"", b"\xff"))))
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("client,server", [("tpu3fs", "tpu3fs_torch"),
                                           ("tpu3fs_torch", "tpu3fs")],
                         ids=["jax-client-port-kvd", "port-client-jax-kvd"])
def test_remote_engine_against_the_other_package(client, server):
    kvds = []
    try:
        kvds = [Kvd("tpu3fs"), Kvd(server)]
        want = _engine_sequence("tpu3fs", kvds[0].addr)
        got = _engine_sequence(client, kvds[1].addr)
    finally:
        for k in kvds:
            k.stop()
    assert got == want


def _wal_commits(pkg: str, svc, seed: int) -> None:
    S = mod(pkg, "kv.service")
    rng = np.random.default_rng(seed)
    for step in range(40):
        writes = [S.WriteEntry(b"w/%03d" % int(i), rng.bytes(
            int(rng.integers(0, 300))), bool(rng.integers(0, 6) == 0))
            for i in rng.integers(0, 60, int(rng.integers(1, 6)))]
        clears = ([S.RangeEntry(b"w/%03d" % a, b"w/%03d" % (a + 5))
                   for a in [int(rng.integers(0, 55))]]
                  if step % 7 == 3 else [])
        stamps = ([S.StampEntry(b"s/", b"%d" % step, rng.bytes(4))]
                  if step % 5 == 1 else [])
        svc.commit(S.CommitReq(read_version=svc.engine.version,
                               writes=writes, clear_ranges=clears,
                               versionstamped=stamps))


@pytest.mark.parametrize("writer,reader", [("tpu3fs", "tpu3fs_torch"),
                                           ("tpu3fs_torch", "tpu3fs")],
                         ids=["jax-wal-port-replay", "port-wal-jax-replay"])
def test_wal_replays_across_packages(tmp_path, writer, reader):
    """The WAL has the JAX package's bytes (a compaction snapshot record
    included, by a low ``compact_min_bytes``), and the other package's
    kvd replays it to equal contents and version."""
    paths = {}
    dumps = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.wal")
        svc = mod(pkg, "kv.service").KvService(wal_path=path,
                                               compact_min_bytes=4096)
        _wal_commits(pkg, svc, 5)
        dumps[pkg] = (svc.engine.version,
                      svc.engine.dump_at(svc.engine.version))
        svc.close()
        paths[pkg] = path
    raw = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert raw["tpu3fs"] == raw["tpu3fs_torch"]
    first = mod("tpu3fs", "rpc.serde").deserialize(
        raw["tpu3fs"][4:4 + int.from_bytes(raw["tpu3fs"][:4], "big")],
        mod("tpu3fs", "kv.service").WalRecord)
    assert first.snapshot  # the log was compacted at least once
    replay = mod(reader, "kv.service").KvService(wal_path=paths[writer])
    try:
        eng = replay.engine
        assert eng.dump_at(eng.version) == dumps[writer][1]
        # a commit after replay lands after the writer's last version
        S = mod(reader, "kv.service")
        stamped = replay.commit(S.CommitReq(
            read_version=eng.version,
            versionstamped=[S.StampEntry(b"s/", b"after", b"x")]))
        assert stamped.version > dumps[writer][0]
    finally:
        replay.close()
