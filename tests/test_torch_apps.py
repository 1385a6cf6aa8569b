"""The port's service binaries over real sockets: the counterpart of
``tests/test_app.py`` for ``tpu3fs_torch.bin`` (``device="cpu"``, the
kernels' plain versions).

An in-process cluster (mgmtd, two storage apps on a CR chain pair, a meta
app, as ``tests/test_app.py:29-83`` builds it, with ``engine=mem``) takes
a file through ``MetaRpcClient`` and ``StorageClient`` over
``RpcMessenger``, applies a config push and answers the core echo, and
keeps writing after a node's death. A storage node started as its own
process (``python -m tpu3fs_torch.bin.storage_main --device cpu``) joins
an in-process mgmtd, serves a write and a read and exits 0 on SIGTERM
within 10 s. The storage and serving apps host USRBIO rings by default
(``usrbio=1``, ``peer_usrbio=1``) and the messenger rides them unless
``TPU3FS_USRBIO=0``, as in the JAX package; a client of the in-process
cluster is shown riding a ring. The native options (``--rpc native``,
``engine=native``, ``StubFactory("native")``) build and serve, and a
cluster on them takes a file; the network KV (``--kv``, one kvd or a group), the
sharded metadata plane (``--meta-partitions``) and the in-memory stubs
serve. An app with no card and no device raises at construction. A received bulk segment is
copied on install and never written. Every wait is bounded and no
cluster thread or child process is left behind."""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tpu3fs_torch.bin.meta_main import MetaApp
from tpu3fs_torch.bin.mgmtd_main import MgmtdApp
from tpu3fs_torch.bin.storage_main import StorageApp
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.client.storage_client import StorageClient
from tpu3fs_torch.client.stubs import StubFactory
from tpu3fs_torch.kv.remote import engine_from_flag
from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcClient
from tpu3fs_torch.rpc.services import (
    CORE_SERVICE_ID,
    EchoReq,
    EchoRsp,
    MetaRpcClient,
    MgmtdAdminRpcClient,
    RpcMessenger,
)
from tpu3fs_torch.storage.types import ChunkId

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _stop_all(apps) -> None:
    for app in reversed(apps):
        app.stop()
    for app in reversed(apps):
        assert app.join(10.0), f"{type(app).__name__} did not stop"


@pytest.fixture
def cluster():
    before = set(threading.enumerate())
    apps = []
    try:
        mgmtd = MgmtdApp(["--node-id", "1", "--config.tick_interval_s=0.2",
                          "--config.heartbeat_timeout_s=60"], **CPU)
        mgmtd.run_background()
        apps.append(mgmtd)
        maddr = f"{mgmtd.info.hostname}:{mgmtd.info.port}"
        storages = []
        for node_id in (101, 102):
            app = StorageApp([
                "--node-id", str(node_id), "--mgmtd", maddr,
                "--heartbeat_interval", "0.3",
                "--config.engine=mem",
                "--config.target_scan_interval_s=0.2",
                "--config.resync_interval_s=0.3",
            ], **CPU)
            app.run_background()
            apps.append(app)
            storages.append(app)
        admin = MgmtdAdminRpcClient((mgmtd.info.hostname, mgmtd.info.port))
        tid, chain_ids = 1001, []
        for c in range(2):
            targets = []
            for app in storages:
                admin.create_target(tid, node_id=app.info.node_id)
                targets.append(tid)
                tid += 1
            admin.upload_chain(900 + c, targets)
            chain_ids.append(900 + c)
        admin.upload_chain_table(1, chain_ids)
        for app in storages:
            app.scan_targets()
            assert len(app.service.targets()) == 2
            assert all(t.device.type == "cpu" for t in app.service.targets())
            app.heartbeat_once()
        meta = MetaApp(["--node-id", "201", "--mgmtd", maddr,
                        "--heartbeat_interval", "0.3",
                        "--config.gc_interval_s=0.3"], **CPU)
        meta.run_background()
        apps.append(meta)
        yield mgmtd, storages, meta, admin
    finally:
        _stop_all(apps)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name != "hedge-runner"]
    assert not left, f"threads left by the cluster: {left}"


def _file_client(admin, client_id: str) -> FileIoClient:
    return FileIoClient(StorageClient(
        client_id, admin.refresh_routing, RpcMessenger(admin.refresh_routing),
        **CPU))


def test_cluster_end_to_end(cluster):
    mgmtd, storages, meta, admin = cluster
    mc = MetaRpcClient([(meta.info.hostname, meta.info.port)],
                       client_id="app-test")
    routing = admin.refresh_routing()
    assert len(routing.chains) == 2
    assert all(n.host for n in routing.nodes.values()
               if n.type == NodeType.STORAGE)
    mc.mkdirs("/data")
    rsp = mc.create("/data/hello", flags=OpenFlags.WRITE | OpenFlags.CREATE)
    fio = _file_client(admin, "app-test")
    try:
        payload = b"cuda-native strikes again " * 1000
        fio.write(rsp.inode, 0, payload)
        assert fio.read(rsp.inode, 0, len(payload)) == payload
        mc.close(rsp.inode.id, rsp.session_id, length_hint=len(payload))
        assert mc.stat("/data/hello").length == len(payload)
    finally:
        fio.storage.close()
    counts = [sum(len(t.engine.all_metadata()) for t in app.service.targets())
              for app in storages]
    assert all(c > 0 for c in counts)


def test_cluster_config_push_and_core_service(cluster):
    mgmtd, storages, meta, admin = cluster
    app = storages[0]
    admin.set_config(NodeType.STORAGE, "resync_interval_s = 9.5\n")
    assert app.heartbeat_once()
    assert app.config.get("resync_interval_s") == 9.5
    rpc = RpcClient()
    try:
        rsp = rpc.call((app.info.hostname, app.info.port), CORE_SERVICE_ID,
                       1, EchoReq("ping"), EchoRsp)
    finally:
        rpc.close()
    assert rsp.text == "ping"


def test_cluster_failover_write_after_node_death(cluster):
    mgmtd, storages, meta, admin = cluster
    mc = MetaRpcClient([(meta.info.hostname, meta.info.port)], client_id="c2")
    rsp = mc.create("/fail.bin", flags=OpenFlags.WRITE | OpenFlags.CREATE)
    fio = _file_client(admin, "c2")
    try:
        fio.write(rsp.inode, 0, b"a" * 4096)
        victim = storages[1]
        victim.stop()
        assert victim.join(10.0)
        mgmtd.mgmtd.config.heartbeat_timeout_s = 1.5
        time.sleep(2.0)
        mgmtd.mgmtd.tick()
        routing = admin.refresh_routing()
        for chain in routing.chains.values():
            assert chain.chain_version > 1
        fio.write(rsp.inode, 0, b"b" * 4096)
        assert fio.read(rsp.inode, 0, 4096) == b"b" * 4096
    finally:
        fio.storage.close()


def test_native_cluster_end_to_end(tmp_path):
    """The JAX README's deployment on the port: every app on ``--rpc
    native``, storage on ``engine=native`` under ``data_dir``, the client
    from ``StubFactory("native")``. A file goes in and out; every target
    runs the C++ engine on disk, and the storage servers' C paths serve
    reads and head writes."""
    from tpu3fs_torch.storage.native_engine import NativeChunkEngine

    before = set(threading.enumerate())
    apps, stubs = [], None
    try:
        mgmtd = MgmtdApp(["--node-id", "1", "--rpc", "native",
                          "--config.tick_interval_s=0.2"], **CPU)
        mgmtd.run_background()
        apps.append(mgmtd)
        maddr = f"{mgmtd.info.hostname}:{mgmtd.info.port}"
        storages = []
        for node_id in (101, 102):
            app = StorageApp([
                "--node-id", str(node_id), "--mgmtd", maddr, "--rpc",
                "native", "--heartbeat_interval", "0.3",
                "--config.engine=native",
                f"--config.data_dir={tmp_path / str(node_id)}",
                "--config.usrbio=0",
                "--config.target_scan_interval_s=0.2"], **CPU)
            app.run_background()
            apps.append(app)
            storages.append(app)
        admin = MgmtdAdminRpcClient((mgmtd.info.hostname, mgmtd.info.port))
        for tid, app in ((1001, storages[0]), (1002, storages[1])):
            admin.create_target(tid, node_id=app.info.node_id)
        admin.upload_chain(900, [1001, 1002])
        admin.upload_chain_table(1, [900])
        for app in storages:
            app.scan_targets()
            app.heartbeat_once()
        meta = MetaApp(["--node-id", "201", "--mgmtd", maddr, "--rpc",
                        "native", "--heartbeat_interval", "0.3"], **CPU)
        meta.run_background()
        apps.append(meta)
        for app in storages:  # routing now SERVING: the fast paths sync
            app.heartbeat_once()
            app.scan_targets()
        stubs = StubFactory("native", mgmtd_addr=(mgmtd.info.hostname,
                                                  mgmtd.info.port),
                            meta_addr=(meta.info.hostname, meta.info.port))
        mc = stubs.meta_client()
        rsp = mc.create("/n.bin", flags=OpenFlags.WRITE | OpenFlags.CREATE)
        fio = stubs.file_client("native-test", **CPU)
        payload = bytes(range(256)) * 300
        fio.write(rsp.inode, 0, payload)
        assert fio.read(rsp.inode, 0, len(payload)) == payload
        fio.close()
        for app in storages:
            assert all(isinstance(t.engine, NativeChunkEngine)
                       and t.path.startswith(str(tmp_path))
                       for t in app.service.targets())
        served = [app.server.fastpath_stats()[0]
                  + app.server.fastpath_write_stats()[0] for app in storages]
        assert sum(served) > 0, served
    finally:
        if stubs is not None:
            stubs.close()
        _stop_all(apps)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name != "hedge-runner"]
    assert not left, f"threads left by the cluster: {left}"


def test_storage_node_process_joins_serves_and_stops_on_sigterm(tmp_path):
    """A storage node from its entry point, in its own process."""
    mgmtd = MgmtdApp(["--node-id", "1", "--config.tick_interval_s=0.2"],
                     **CPU)
    mgmtd.run_background()
    proc = None
    log = tmp_path / "storage.log"
    try:
        admin = MgmtdAdminRpcClient((mgmtd.info.hostname, mgmtd.info.port))
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu3fs_torch.bin.storage_main",
                 "--node-id", "101", "--device", "cpu",
                 "--mgmtd", f"{mgmtd.info.hostname}:{mgmtd.info.port}",
                 "--heartbeat_interval", "0.2",
                 "--config.target_scan_interval_s=0.1"],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(ROOT)})
        node = _wait(lambda: (lambda n: n if n is not None and n.host
                              else None)(
            admin.refresh_routing().nodes.get(101)), 60.0,
            "the storage process to register")
        admin.create_target(1001, node_id=101)
        admin.upload_chain(900, [1001])
        admin.upload_chain_table(1, [900])
        sc = StorageClient("proc-test", admin.refresh_routing,
                           RpcMessenger(admin.refresh_routing), **CPU)
        try:
            body = bytes(range(256)) * 64

            def wrote():
                try:
                    return sc.write_chunk(900, ChunkId(7, 0), 0, body,
                                          chunk_size=1 << 16).ok
                except Exception:
                    return False

            _wait(wrote, 30.0, "the process to open its target")
            got = sc.read_chunk(900, ChunkId(7, 0))
            assert got.ok and bytes(got.data) == body
        finally:
            sc.close()
        assert node.port > 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        mgmtd.stop()
        mgmtd.join(10.0)
    text = log.read_text()
    assert "Traceback" not in text, text


def _serving_app(flags):
    from tpu3fs_torch.bin.serving_main import ServingApp

    return ServingApp(flags, **CPU)


def _kv_app(flags):
    from tpu3fs_torch.bin.kv_main import KvApp

    return KvApp(["--rpc", "native"] + flags, **CPU)


def _echo_native_server(app):
    """The app's server is the C++ transport: start it, echo through the
    port's native client, stop it."""
    from tpu3fs_torch.rpc.native_net import NativeRpcClient, NativeRpcServer

    app.init_server()
    assert isinstance(app.server, NativeRpcServer)
    app.server.start()
    client = NativeRpcClient()
    try:
        return client.call(app.server.address, CORE_SERVICE_ID, 1,
                           EchoReq("native"), EchoRsp).text
    finally:
        client.close()
        app.server.stop()


def _native_target(tmp_path):
    """A storage app on engine=native opens its targets as the JAX
    package's app does: on the C++ engine under data_dir."""
    from tpu3fs_torch.storage.native_engine import NativeChunkEngine
    from tpu3fs_torch.storage.target import StorageTarget

    app = StorageApp(["--config.engine=native",
                      f"--config.data_dir={tmp_path}"], **CPU)
    target = StorageTarget(1, 1, engine=app.config.get("engine"),
                           path=app._target_path(1, 0), device=app.device)
    try:
        assert isinstance(target.engine, NativeChunkEngine)
        target.engine.update(ChunkId(1, 0), 1, 1, b"native", 0,
                             chunk_size=4096)
        target.engine.commit(ChunkId(1, 0), 1, 1)
        return target.engine.read(ChunkId(1, 0)).decode()
    finally:
        target.engine.close()


def _native_stubs():
    """StubFactory("native") hands out the C++ client; it talks to the
    port's Python server."""
    from tpu3fs_torch.rpc.native_net import NativeRpcClient
    from tpu3fs_torch.rpc.net import RpcServer
    from tpu3fs_torch.rpc.services import bind_core_service

    server = RpcServer()
    bind_core_service(server)
    server.start()
    stubs = StubFactory("native")
    try:
        assert isinstance(stubs.rpc_client(), NativeRpcClient)
        return stubs.rpc_client().call(server.address, CORE_SERVICE_ID, 1,
                                       EchoReq("native"), EchoRsp).text
    finally:
        stubs.rpc_client().close()
        server.stop()


@pytest.mark.parametrize("build,item", [
    (lambda tmp: _echo_native_server(MgmtdApp(["--rpc", "native"], **CPU)),
     "native"),
    (_native_target, "native"),
    (lambda tmp: _native_stubs(), "native"),
    (lambda tmp: _echo_native_server(_kv_app([])), "native"),
], ids=["rpc-native", "engine-native", "stubs-native", "kv-rpc-native"])
def test_native_options_build_and_serve(build, item, tmp_path):
    """The options that raised until the native paths were ported (the
    C++ transport for an app, the C++ engine for a storage app, the
    native stubs, kv_main's --rpc native) now build and serve."""
    assert build(tmp_path) == item


@pytest.mark.parametrize("build,key", [
    (lambda flags: StorageApp(flags, **CPU), "usrbio"),
    (_serving_app, "usrbio"),
    (_serving_app, "peer_usrbio"),
], ids=["usrbio", "serving-usrbio", "serving-peer-usrbio"])
@pytest.mark.parametrize("flag", [None, 0, 1], ids=["default", "off", "on"])
def test_ring_options_follow_the_jax_defaults(build, key, flag):
    """Each ring option is 1 unless set, as in the JAX package, and the
    app takes 0 and 1 alike."""
    app = build([] if flag is None else [f"--config.{key}={flag}"])
    assert int(app.config.get(key)) == (1 if flag is None else flag)


@pytest.fixture
def kvd():
    """A port kvd on port 0: the network KV the ``--kv`` flags name."""
    from tpu3fs_torch.kv.service import KvService, bind_kv_service
    from tpu3fs_torch.rpc.net import RpcServer

    svc = KvService()
    server = RpcServer(port=0)
    bind_kv_service(server, svc)
    server.start()
    try:
        yield f"127.0.0.1:{server.port}", svc
    finally:
        server.stop()
        svc.close()


def _mgmtd_kv(addr, svc):
    """mgmtd keeps its state in the kvd: a second mgmtd on the same
    ``--kv`` sees the first one's chain table."""
    first = MgmtdApp(["--node-id", "1", "--kv", addr], **CPU)
    first.run_background()
    try:
        admin = MgmtdAdminRpcClient((first.info.hostname, first.info.port))
        admin.create_target(1001, node_id=101)
        admin.upload_chain(900, [1001])
        admin.upload_chain_table(1, [900])
    finally:
        first.stop()
        assert first.join(10.0)
    assert svc.engine.version > 0
    second = MgmtdApp(["--node-id", "1", "--kv", addr], **CPU)
    second.run_background()
    try:
        admin = MgmtdAdminRpcClient((second.info.hostname,
                                     second.info.port))
        assert admin.refresh_routing().chain_tables[1].chain_ids == [900]
    finally:
        second.stop()
        assert second.join(10.0)


def _meta_kv(addr, svc):
    """Two meta apps on one ``--kv`` share one namespace."""
    from tpu3fs_torch.meta.store import MetaStore

    apps = [MetaApp(["--kv", addr], **CPU) for _ in range(2)]
    res = MetaStore(apps[0].engine).create("/shared", client_id="a")
    assert MetaStore(apps[1].engine).stat("/shared").id == res.inode.id


def _kv_group(addr, svc):
    """``--kv`` of several addresses is a kvd group: a transaction rides
    its leader."""
    import tempfile

    from tpu3fs_torch.kv.kv import with_transaction
    from tpu3fs_torch.kv.remote import ReplicatedRemoteKVEngine
    from torch_kvd_group import Group

    with tempfile.TemporaryDirectory() as tmp:
        g = Group(Path(tmp), {1: "tpu3fs_torch", 2: "tpu3fs_torch",
                              3: "tpu3fs_torch"})
        try:
            g.wait_leader()
            flag = ",".join(f"{h}:{p}" for _, (h, p) in sorted(
                g.peers.items()))
            eng = engine_from_flag(flag)
            assert isinstance(eng, ReplicatedRemoteKVEngine)
            with_transaction(eng, lambda tx: tx.set(b"g", b"1"))
            assert with_transaction(eng, lambda tx: tx.get(b"g")) == b"1"
        finally:
            g.stop()


def _meta_partitions(addr, svc):
    """``--meta-partitions 3`` serves the sharded store: creates through
    the partition-routed client land with their partition's inode tag."""
    from tpu3fs_torch.metashard import ShardedMetaStore, partition_of_inode
    from tpu3fs_torch.metashard.partition import partition_of_path

    mgmtd = MgmtdApp(["--node-id", "1", "--config.meta_partitions=3",
                      "--config.tick_interval_s=0.2"], **CPU)
    mgmtd.run_background()
    meta = None
    try:
        maddr = f"{mgmtd.info.hostname}:{mgmtd.info.port}"
        meta = MetaApp(["--node-id", "201", "--mgmtd", maddr, "--kv", addr,
                        "--meta-partitions", "3",
                        "--heartbeat_interval", "0.2"], **CPU)
        meta.run_background()
        assert isinstance(meta.meta, ShardedMetaStore)
        admin = MgmtdAdminRpcClient((mgmtd.info.hostname, mgmtd.info.port))
        _wait(lambda: len(admin.refresh_routing().meta_partitions) == 3,
              30.0, "the partition table")
        mc = MetaRpcClient([(meta.info.hostname, meta.info.port)],
                           client_id="parts", nparts=3)
        for d in ("/p0", "/p1", "/p2", "/p3"):
            mc.mkdirs(d)
            ino = mc.create(f"{d}/f", flags=OpenFlags.WRITE).inode.id
            assert partition_of_inode(ino, 3) == partition_of_path(
                f"{d}/f", 3)
    finally:
        if meta is not None:
            meta.stop()
            assert meta.join(10.0)
        mgmtd.stop()
        assert mgmtd.join(10.0)


def _stubs_inmem(addr, svc):
    stubs = StubFactory("inmem")
    sc = stubs.storage_client()
    assert sc.write_chunk(7, ChunkId(1, 0), 0, b"in memory",
                          chunk_size=4096).ok
    assert sc.read_chunk(7, ChunkId(1, 0)).data == b"in memory"
    meta = stubs.meta_client()
    res = meta.create("/f", client_id="t")
    assert meta.stat("/f").id == res.inode.id


@pytest.mark.parametrize("run", [_mgmtd_kv, _meta_kv, _kv_group,
                                 _meta_partitions, _stubs_inmem],
                         ids=["mgmtd-kv", "meta-kv", "kv-group",
                              "meta-partitions", "stubs-inmem"])
def test_ported_options_work(kvd, run):
    """The options that raised until the rest of the service layer was
    ported (the network KV, its group, the sharded metadata plane and the
    in-memory stubs) now serve."""
    run(*kvd)


def test_ring_request_raises(monkeypatch):
    """The messenger rides shm rings unless TPU3FS_USRBIO=0, with the JAX
    package's ring settings (128 entries, a 64 MiB iov, one write
    stripe); asking for rings raises nothing."""
    monkeypatch.setenv("TPU3FS_USRBIO", "1")
    assert RpcMessenger(lambda: None)._usrbio
    monkeypatch.delenv("TPU3FS_USRBIO")
    m = RpcMessenger(lambda: None)
    assert m._usrbio and m._usrbio_entries == 128
    assert m._usrbio_iov_bytes == 64 << 20 and m._ring_write_stripes == 1
    monkeypatch.setenv("TPU3FS_USRBIO", "0")
    assert not RpcMessenger(lambda: None)._usrbio


def test_cluster_client_rides_a_ring(cluster):
    """The in-process cluster's storage apps host rings: a client's data
    plane rides one to each node it calls, and no call takes a socket."""
    mgmtd, storages, meta, admin = cluster
    mc = MetaRpcClient([(meta.info.hostname, meta.info.port)], client_id="r")
    rsp = mc.create("/ring.bin", flags=OpenFlags.WRITE | OpenFlags.CREATE)
    fio = _file_client(admin, "ring")
    try:
        body = bytes(range(256)) * 300
        fio.write(rsp.inode, 0, body)
        assert fio.read(rsp.inode, 0, len(body)) == body
        messenger = fio.storage._messenger
        rings = {n: r for n, r in messenger._usrbio_rings.items() if r}
        assert rings and all(r.agent_pid == os.getpid()
                             for r in rings.values())
        calls = messenger.transport_calls
        assert calls and {t for t, _, _ in calls} == {"ring"}
    finally:
        fio.close()
        fio.storage.close()


def test_empty_kv_flag_is_the_memory_engine():
    from tpu3fs_torch.kv.mem import MemKVEngine

    assert isinstance(engine_from_flag(""), MemKVEngine)


def _new_apps():
    from tpu3fs_torch.bin.kv_main import KvApp
    from tpu3fs_torch.bin.monitor_main import MonitorApp
    from tpu3fs_torch.bin.serving_main import ServingApp

    return [KvApp, MonitorApp, ServingApp]


@pytest.mark.parametrize("cls", [MgmtdApp, StorageApp, MetaApp] + _new_apps(),
                         ids=lambda c: c.__name__)
def test_app_without_a_card_or_a_device_raises(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(["--device", "cuda"])
    assert cls(["--device", "cpu"]).device == torch.device("cpu")
    assert cls([], device="cpu").device == torch.device("cpu")


def test_bulk_segment_is_copied_on_install_and_never_written():
    """A received chunk is a memoryview over the transport's receive
    buffer (``rpc/services.py:_attach``): the engine's checksum must not
    write into it, and the install must own a copy, so the buffer is not
    kept alive past the request (a writable view is never adopted)."""
    import numpy as np

    from tpu3fs_torch.ops.crc32c import crc32c_many
    from tpu3fs_torch.rpc.net import pack_bulk_header, split_bulk
    from tpu3fs_torch.storage.engine import MemChunkEngine

    payload = np.random.default_rng(4).bytes(5000)
    frame = bytearray(pack_bulk_header([payload]) + payload)
    (seg,) = split_bulk(memoryview(frame))
    assert not seg.readonly and bytes(seg) == payload
    before = bytes(frame)
    (crc,) = crc32c_many([seg], device="cpu")
    eng = MemChunkEngine(device="cpu")
    cid = ChunkId(9, 0)
    eng.update(cid, 1, 1, seg, 0, chunk_size=1 << 16, expected_crc=crc,
               adopt=True)
    eng.commit(cid, 1, 1)
    assert bytes(frame) == before  # nothing wrote into the buffer
    frame[-5000:] = bytes(5000)  # the transport reuses its buffer
    assert eng.read(cid) == payload
    assert eng.get_meta(cid).checksum.value == crc
