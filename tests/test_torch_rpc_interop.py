"""Each package's clients served by the other package's servers, on one
wire, over loopback.

A cluster of service apps (``tests/torch_socket_sequence.py``: mgmtd, six
storage apps with ``engine=mem``, a meta app; an RS(4,2) chain over the
six nodes and a CR chain of three) is booted from one package, and one
package's clients drive it: ``RpcClient`` (the core echo and a storage
``spaceInfo``), ``StorageClient`` over ``RpcMessenger`` (a CR
``write_chunk`` and ``read_chunk``, ``batch_write`` and ``batch_read``,
``write_stripes`` and ``read_stripe``) and ``MetaRpcClient`` (``mkdirs``,
``create``, ``close``, ``stat``, ``rename``, ``list_dir``). The four
pairings (JAX clients on JAX servers, port on JAX, JAX on port, port on
port) must give the same replies, byte for byte as serde encodes them,
with the wall-clock fields (inode times), the session uuids and the
servers' ports zeroed,
and the port's servers must store the bytes the JAX servers store. The
four pairings run again over USRBIO shm rings (``TPU3FS_USRBIO=1``, the
storage apps with ``usrbio=1``): each shows a ring established in its
client's messenger, so it cannot pass over sockets, and its replies and
stored bytes equal the socket reference."""

import dataclasses
import importlib
import threading

import numpy as np
import pytest

from torch_socket_sequence import AppCluster, deterministic, threads_left

WRITE, CREATE = 2, 4
CS = 16 << 10
SHAPE = dict(nodes=6, chunk_size=CS)
EC_CHAIN, CR_CHAIN = 900, 901


class _InteropCluster(AppCluster):
    """An RS(4,2) chain over six nodes and a CR chain of three; the chain
    table holds the CR chain, so meta's files land there."""

    def chain_specs(self, ids):
        return ([(EC_CHAIN, ids, dict(ec_k=4, ec_m=2)),
                 (CR_CHAIN, ids[:3], {})], [CR_CHAIN])


def _blank(value):
    """A reply with its wall-clock fields, session uuids and (routing's)
    server ports zeroed."""
    if isinstance(value, list):
        return [_blank(v) for v in value]
    if isinstance(value, dict):
        return {k: _blank(v) for k, v in value.items()}
    if not dataclasses.is_dataclass(value):
        return value
    kw = {}
    for f in dataclasses.fields(value):
        v = getattr(value, f.name)
        if f.name in ("atime", "mtime", "ctime"):
            v = 0.0
        elif f.name == "session_id":
            v = ""
        elif f.name == "port":  # servers bind port 0
            v = 0
        else:
            v = _blank(v)
        kw[f.name] = v
    return dataclasses.replace(value, **kw)


def _drive(client_pkg: str, cluster, rings=None) -> list:
    """One package's clients against ``cluster`` -> serde bytes of every
    reply, in order. ``rings`` collects the node ids the storage client's
    messenger holds a ring to."""
    mod = lambda name: importlib.import_module(f"{client_pkg}.{name}")  # noqa: E731
    net, svc, serde = mod("rpc.net"), mod("rpc.services"), mod("rpc.serde")
    craq, stypes = mod("storage.craq"), mod("storage.types")
    sc_mod = mod("client.storage_client")
    kw = {"device": "cpu"} if client_pkg == "tpu3fs_torch" else {}
    out = []

    def rec(value):
        value = _blank(value)
        if isinstance(value, list):  # a batch's replies, one by one
            out.append([serde.serialize(v) for v in value])
        else:
            out.append(serde.serialize(value))

    rng = np.random.default_rng(3)
    rpc = net.RpcClient()
    admin = svc.MgmtdAdminRpcClient(cluster.maddr, rpc)
    node = cluster.nodes[cluster.FIRST_STORAGE]
    addr = (node.info.hostname, node.info.port)
    rec(rpc.call(addr, svc.CORE_SERVICE_ID, 1, svc.EchoReq("ping"),
                 svc.EchoRsp))
    rec(rpc.call(addr, svc.STORAGE_SERVICE_ID, 10, svc.Empty(),
                 stypes.SpaceInfo))
    rec(admin.refresh_routing())

    messenger = svc.RpcMessenger(admin.refresh_routing, rpc)
    # no hedged reads: a hedge runs on the client package's process-wide
    # runner pool, whose threads would outlive the cluster
    sc = sc_mod.StorageClient("interop", admin.refresh_routing, messenger,
                              retry=sc_mod.RetryOptions(hedge_reads=False),
                              **kw)
    try:
        cid = stypes.ChunkId
        one = rng.bytes(CS // 2 + 7)
        rec(sc.write_chunk(CR_CHAIN, cid(1, 0), 0, one, chunk_size=CS))
        rec(sc.read_chunk(CR_CHAIN, cid(1, 0)))
        rec(sc.write_chunk(CR_CHAIN, cid(1, 0), 100, rng.bytes(333),
                           chunk_size=CS))
        writes = [(CR_CHAIN, cid(2, i), 0, rng.bytes(CS - 5 * i))
                  for i in range(5)]
        rec(sc.batch_write(writes, chunk_size=CS))
        rec(sc.batch_read([craq.ReadReq(CR_CHAIN, cid(2, i))
                           for i in range(5)]))
        stripes = [(cid(3, i), rng.bytes(CS - 1000 * i)) for i in range(3)]
        rec(sc.write_stripes(EC_CHAIN, stripes, chunk_size=CS))
        for c, _ in stripes:
            rec(sc.read_stripe(EC_CHAIN, c, chunk_size=CS))
        rec(sc.read_stripe(EC_CHAIN, cid(3, 1), 900, 2000, chunk_size=CS))
        if rings is not None:
            rings.extend(sorted(n for n, r in messenger._usrbio_rings.items()
                                if r is not None))
    finally:
        sc.close()

    meta = svc.MetaRpcClient(
        [(cluster.meta_app.info.hostname, cluster.meta_app.info.port)], rpc,
        client_id="interop")
    rec(meta.mkdirs("/d"))
    res = meta.create("/d/f", flags=WRITE | CREATE)
    rec(res)
    rec(meta.close(res.inode.id, res.session_id, length_hint=1234))
    rec(meta.stat("/d/f"))
    meta.rename("/d/f", "/d/g")
    rec(meta.stat("/d/g"))
    rec(svc.ListRsp(meta.list_dir("/d")))
    rpc.close()
    return out


def _stored(cluster) -> dict:
    return {t.target_id: sorted(
        ((m.chunk_id.file_id, m.chunk_id.index), m.committed_ver,
         m.length, m.checksum.value, t.engine.read(m.chunk_id))
        for m in t.engine.all_metadata())
        for app in cluster.nodes.values() for t in app.service.targets()}


def _pairing(server_pkg: str, client_pkg: str, monkeypatch, rings=None):
    """One pairing's replies and stored bytes; over sockets, or over rings
    when ``rings`` is a list (which collects the ringed node ids)."""
    monkeypatch.setenv("TPU3FS_USRBIO", "0" if rings is None else "1")
    kw = {"device": "cpu"} if server_pkg == "tpu3fs_torch" else {}
    before = threading.enumerate()
    cluster = None
    try:
        with deterministic(server_pkg, seed=1), \
                deterministic(client_pkg, seed=1):
            cluster = _InteropCluster(server_pkg, SHAPE, app_kw=kw,
                                      usrbio=rings is not None)
            replies = _drive(client_pkg, cluster, rings)
            stored = _stored(cluster)
    finally:
        if cluster is not None:
            cluster.close()
    left = threads_left(before)
    assert not left, f"threads left: {left}"
    return replies, stored


@pytest.fixture(scope="module")
def reference():
    mp = pytest.MonkeyPatch()
    try:
        return _pairing("tpu3fs", "tpu3fs", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("tpu3fs", "tpu3fs_torch"),
    ("tpu3fs_torch", "tpu3fs"),
    ("tpu3fs_torch", "tpu3fs_torch"),
], ids=["port-clients-on-jax-servers", "jax-clients-on-port-servers",
        "port-on-port"])
def test_clients_and_servers_interoperate(server_pkg, client_pkg,
                                          reference, monkeypatch):
    want_replies, want_stored = reference
    replies, stored = _pairing(server_pkg, client_pkg, monkeypatch)
    assert len(replies) == len(want_replies)
    for i, (got, want) in enumerate(zip(replies, want_replies)):
        assert got == want, f"reply {i}"
    assert stored == want_stored


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("tpu3fs", "tpu3fs"),
    ("tpu3fs", "tpu3fs_torch"),
    ("tpu3fs_torch", "tpu3fs"),
    ("tpu3fs_torch", "tpu3fs_torch"),
], ids=["jax-on-jax", "port-clients-on-jax-servers",
        "jax-clients-on-port-servers", "port-on-port"])
def test_clients_and_servers_interoperate_over_rings(server_pkg, client_pkg,
                                                     reference, monkeypatch):
    want_replies, want_stored = reference
    rings = []
    replies, stored = _pairing(server_pkg, client_pkg, monkeypatch, rings)
    assert rings, "no ring was established: the pairing rode sockets"
    assert len(replies) == len(want_replies)
    for i, (got, want) in enumerate(zip(replies, want_replies)):
        assert got == want, f"reply {i}"
    assert stored == want_stored
