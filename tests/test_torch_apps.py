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
within 10 s. The options the port does not have raise
``NotImplementedError`` naming their ROADMAP item, and an app with no
card and no device raises at construction. A received bulk segment is
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


@pytest.mark.parametrize("build,item", [
    (lambda: MgmtdApp(["--rpc", "native"], **CPU).init_server(), "M6a-3"),
    (lambda: StorageApp(["--config.engine=native"], **CPU), "M6a-3"),
    (lambda: StorageApp(["--config.usrbio=1"], **CPU), "M6a-3"),
    (lambda: MgmtdApp(["--kv", "127.0.0.1:1"], **CPU), "M6a-2b"),
    (lambda: MetaApp(["--kv", "127.0.0.1:1"], **CPU), "M6a-2b"),
    (lambda: engine_from_flag("127.0.0.1:1,127.0.0.1:2"), "M6a-2b"),
    (lambda: MetaApp(["--meta-partitions", "3"], **CPU), "M6a-2b"),
    (lambda: StubFactory("inmem"), "M6a-2b"),
    (lambda: StubFactory("native"), "M6a-3"),
], ids=["rpc-native", "engine-native", "usrbio", "mgmtd-kv", "meta-kv",
        "kv-group", "meta-partitions", "stubs-inmem", "stubs-native"])
def test_unported_options_raise(build, item):
    with pytest.raises(NotImplementedError, match=item):
        build()


def test_ring_request_raises(monkeypatch):
    """The JAX messenger rides shm rings unless TPU3FS_USRBIO=0; asking the
    port's for rings raises, and it never falls back to a socket."""
    monkeypatch.setenv("TPU3FS_USRBIO", "1")
    with pytest.raises(NotImplementedError, match="M6a-3"):
        RpcMessenger(lambda: None)
    monkeypatch.delenv("TPU3FS_USRBIO")
    RpcMessenger(lambda: None)  # unset: sockets, the port's only transport
    monkeypatch.setenv("TPU3FS_USRBIO", "0")
    RpcMessenger(lambda: None)


def test_empty_kv_flag_is_the_memory_engine():
    from tpu3fs_torch.kv.mem import MemKVEngine

    assert isinstance(engine_from_flag(""), MemKVEngine)


@pytest.mark.parametrize("cls", [MgmtdApp, StorageApp, MetaApp])
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
