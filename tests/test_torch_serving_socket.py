"""The serving tier's socket half and the binaries of the deployment, on
the CPU (``device="cpu"``, the kernels' plain versions).

Each package's ``ServingPeerClient(usrbio=False)`` drives the other's
``bind_serving_service`` over loopback (``peerRead``, ``fillClaim``,
``fillRelease``, ``servingStats`` and ``servingLoad``), to replies equal
to the JAX package's on its own (a load leg's wall-clock fields zeroed).
``python -m tpu3fs_torch.bin.serving_main --device cpu`` joins an
in-process cluster, registers in mgmtd's serving directory, answers a peer
read and leaves the directory and exits 0 on SIGTERM within 10 s;
``kv_main`` (a kvd on a write-ahead log, restarted on it) and
``monitor_main`` (a sample push and an ``aggQuery``) do the same as
processes. Every wait is bounded; every server, app and child is stopped
in a ``finally``."""

import importlib
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("tpu3fs", "tpu3fs_torch")
STOP_S = 10.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = pred()
        except Exception:
            got = None
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


class ServingServer:
    """One package's FleetKVCache and ServingHost over its in-process
    fabric (CR, 2 nodes), bound on its package's RpcServer."""

    def __init__(self, pkg: str, node_id: int = 2):
        fabric = mod(pkg, "fabric")
        cfg = fabric.SystemSetupConfig(num_storage_nodes=2, num_chains=4,
                                       num_replicas=2, chunk_size=4096)
        kw = {"device": "cpu"} if pkg == "tpu3fs_torch" else {}
        self.fab = fabric.Fabric(cfg, **kw)
        self.server = None
        try:
            fs = mod(pkg, "kvcache").KVCacheClient(
                self.fab.meta, self.fab.file_client(),
                client_id=f"srv{node_id}", inode_cache=64)
            eps = {node_id: mod(pkg, "mgmtd.types").ServingEndpoint(
                node_id=node_id)}
            routing = type("R", (), {"serving": eps})()
            self.fleet = mod(pkg, "serving").FleetKVCache(
                fs, node_id=node_id, routing=lambda: routing,
                peer_client=None, write_through=True)
            service = mod(pkg, "serving.service")
            self.host = service.ServingHost(self.fleet, node_id,
                                            claims=self.fleet.claims)
            self.server = mod(pkg, "rpc.net").RpcServer(port=0)
            service.bind_serving_service(self.server, self.host)
            self.server.start()
        except BaseException:
            self.stop()
            raise
        self.node_id = node_id

    def stop(self):
        if self.server is not None:
            self.server.stop()
        fleet = getattr(self, "fleet", None)
        if fleet is not None:
            fleet.close(flush=False)
        self.fab.close()


def _peer_calls(client_pkg: str, srv: ServingServer) -> list:
    service = mod(client_pkg, "serving.service")
    serde = mod(client_pkg, "rpc.serde")
    rpc = mod(client_pkg, "rpc.net").RpcClient()
    peers = service.ServingPeerClient(rpc, usrbio=False)
    ep = mod(client_pkg, "mgmtd.types").ServingEndpoint(
        node_id=srv.node_id, host="127.0.0.1", port=srv.server.port)
    rng = np.random.default_rng(9)
    keys = [f"blk/{i}" for i in range(6)]
    out = []
    try:
        for k in keys[:4]:
            srv.fleet.put(k, rng.bytes(int(rng.integers(1, 3000))),
                          write_through=True)
        out.append(peers.peer_read(ep, keys))
        srv.fleet.tier.clear()
        out.append(peers.peer_read(ep, keys, serve_through=False))
        out.append(peers.peer_read(ep, keys[:2], deadline_s=5.0))
        out.append(peers.fill_claim(ep, "viral", owner=5, ttl_ms=60_000))
        out.append(peers.fill_claim(ep, "viral", owner=6))
        out.append(peers.fill_release(ep, "viral", owner=6))
        out.append(peers.fill_release(ep, "viral", owner=5))
        out.append(peers.fill_claim(ep, "viral", owner=6))
        req = service.ServingLoadReq
        out.append(peers.load(ep, req(op="put", keys=[f"ld/{i}" for i in
                                                    range(8)],
                                      value_bytes=700, concurrency=3,
                                      batch=4)))
        out.append(peers.load(ep, req(op="get", keys=[f"ld/{i}" for i in
                                                    range(8)],
                                      concurrency=2, drop_host=True)))
        # K concurrent misses of one key are one storage fill; how many
        # of the others coalesce onto it rather than hit the filled
        # host tier depends on the threads' timing
        viral = peers.load(ep, req(op="get", keys=["ld/0"], concurrency=4,
                                   repeat=4, drop_host=True))
        assert viral.storage_fills == 1
        viral.coalesced = 0
        out.append(viral)
        stats = peers.stats(ep)
        stats.coalesced = 0
        out.append(stats)
        with pytest.raises(mod(client_pkg, "utils.result").FsError):
            peers.load(ep, req(op="scan"))
    finally:
        peers.close()
        rpc.close()
    for rsp in out:
        if hasattr(rsp, "wall_us"):
            rsp.wall_us, rsp.lat_us = 0, []
    return [serde.serialize(r) for r in out]


@pytest.mark.parametrize("client,server", [("tpu3fs", "tpu3fs_torch"),
                                           ("tpu3fs_torch", "tpu3fs"),
                                           ("tpu3fs_torch", "tpu3fs_torch")],
                         ids=["jax-client-port-host", "port-client-jax-host",
                              "port-client-port-host"])
def test_peer_client_against_the_other_packages_host(client, server):
    runs = {}
    for key, (c, s) in (("ref", ("tpu3fs", "tpu3fs")),
                        ("got", (client, server))):
        srv = ServingServer(s)
        try:
            runs[key] = _peer_calls(c, srv)
        finally:
            srv.stop()
    assert runs["got"] == runs["ref"]


def test_peer_client_rings_raise():
    from tpu3fs_torch.client.stubs import StubFactory
    from tpu3fs_torch.serving.service import ServingPeerClient

    with pytest.raises(NotImplementedError, match="M6a-3"):
        ServingPeerClient(object(), usrbio=True)
    with pytest.raises(NotImplementedError, match="M6a-3"):
        StubFactory().serving_peer_client(usrbio=True)
    assert StubFactory().serving_peer_client() is not None  # sockets


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(args, log: Path):
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", *args, "--device", "cpu"], cwd=ROOT,
            stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT)})


def _stop_child(proc, log: Path) -> None:
    """SIGTERM, then the exit code must be 0 within 10 s and the log must
    hold no traceback; a child still running is killed."""
    try:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=STOP_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(STOP_S)
    text = log.read_text()
    assert "Traceback" not in text, text


def test_serving_process_registers_answers_and_stops(tmp_path):
    from tpu3fs_torch.bin.meta_main import MetaApp
    from tpu3fs_torch.bin.mgmtd_main import MgmtdApp
    from tpu3fs_torch.bin.storage_main import StorageApp
    from tpu3fs_torch.mgmtd.types import ServingEndpoint
    from tpu3fs_torch.rpc.net import RpcClient
    from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient
    from tpu3fs_torch.serving.service import (ServingLoadReq,
                                              ServingPeerClient)

    apps, proc = [], None
    log = tmp_path / "serving.log"
    try:
        mgmtd = MgmtdApp(["--node-id", "1", "--config.tick_interval_s=0.2"],
                         device="cpu")
        mgmtd.run_background()
        apps.append(mgmtd)
        maddr = f"{mgmtd.info.hostname}:{mgmtd.info.port}"
        admin = MgmtdAdminRpcClient((mgmtd.info.hostname, mgmtd.info.port))
        storages = []
        for node_id in (101, 102):
            app = StorageApp(["--node-id", str(node_id), "--mgmtd", maddr,
                              "--heartbeat_interval", "0.3",
                              "--config.engine=mem",
                              "--config.target_scan_interval_s=0.2"],
                             device="cpu")
            app.run_background()
            apps.append(app)
            storages.append(app)
        for c, tid in enumerate((1001, 1003)):
            for j, app in enumerate(storages):
                admin.create_target(tid + j, node_id=app.info.node_id)
            admin.upload_chain(900 + c, [tid, tid + 1])
        admin.upload_chain_table(1, [900, 901])
        for app in storages:
            app.scan_targets()
            app.heartbeat_once()
        meta = MetaApp(["--node-id", "201", "--mgmtd", maddr,
                        "--heartbeat_interval", "0.3"], device="cpu")
        meta.run_background()
        apps.append(meta)
        proc = _child(["tpu3fs_torch.bin.serving_main", "--node-id", "61",
                       "--mgmtd", maddr, "--heartbeat_interval", "0.3",
                       "--config.serving_ttl_s=30"], log)
        ep = _wait(lambda: admin.refresh_routing().serving.get(61), 60.0,
                   "the serving process to register")
        assert ep.host and ep.port > 0
        rpc = RpcClient()
        peers = ServingPeerClient(rpc)
        try:
            rsp = peers.load(ep, ServingLoadReq(
                op="put", keys=["k/0", "k/1"], value_bytes=5000, batch=2))
            assert (rsp.ops, rsp.errors) == (2, 0)
            got = peers.peer_read(ep, ["k/0", "k/1", "k/none"])
            assert got.found == [True, True, False]
            assert got.blobs[:2] == [b"\xa5" * 5000] * 2
            assert got.node_id == 61
        finally:
            peers.close()
            rpc.close()
        _stop_child(proc, log)
        assert 61 not in admin.refresh_routing().serving  # unregistered
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(STOP_S)
        for app in reversed(apps):
            app.stop()
        for app in reversed(apps):
            assert app.join(STOP_S)


def test_serving_main_rings_raise():
    from tpu3fs_torch.bin.serving_main import ServingApp

    for flag in ("--config.usrbio=1", "--config.peer_usrbio=1"):
        with pytest.raises(NotImplementedError, match="M6a-3"):
            ServingApp([flag], device="cpu")
    app = ServingApp([], device="cpu")
    assert (app.config.get("usrbio"), app.config.get("peer_usrbio")) == (0, 0)


def test_serving_meta_client_routes_by_partition():
    """On a sharded metadata plane the serving process's meta client is
    routed by mgmtd's partition table, so a batched put's creates reach
    each partition's owner (the JAX package's serving_main builds an
    unrouted client); on an unpartitioned plane it is unrouted."""
    from types import SimpleNamespace

    from tpu3fs_torch.bin.serving_main import ServingApp

    app = ServingApp(["--node-id", "61"], device="cpu")
    for parts, routed in (({0: None, 1: None, 2: None}, True), ({}, False)):
        mgmtd = SimpleNamespace(routing=lambda p=parts: SimpleNamespace(
            meta_partitions=p))
        app.mgmtd_client = mgmtd
        client = app._meta_client([("127.0.0.1", 1)])
        assert client.client_id == "serving-61"
        assert (client._mgmtd is mgmtd) == routed
        if routed:
            assert client.nparts == 3


def test_kv_process_commits_and_replays_its_wal(tmp_path):
    from tpu3fs_torch.kv.kv import with_transaction
    from tpu3fs_torch.kv.remote import engine_from_flag

    wal = tmp_path / "kv.wal"
    for life in range(2):
        port = _free_port()
        log = tmp_path / f"kv{life}.log"
        proc = _child(["tpu3fs_torch.bin.kv_main", "--port", str(port),
                       "--wal", str(wal)], log)
        try:
            eng = engine_from_flag(f"127.0.0.1:{port}")
            if life == 0:
                _wait(lambda: with_transaction(
                    eng, lambda tx: tx.set(b"k", b"durable")) or True,
                    60.0, "the kvd to commit")
            else:
                got = _wait(lambda: with_transaction(
                    eng, lambda tx: tx.get(b"k")), 60.0,
                    "the restarted kvd to answer")
                assert got == b"durable"
            eng.close()
            _stop_child(proc, log)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(STOP_S)
    assert wal.stat().st_size > 0


def test_monitor_process_takes_a_push_and_answers_agg_query(tmp_path):
    from tpu3fs_torch.monitor.collector import (COLLECTOR_SERVICE_ID,
                                                AggQueryReq, AggQueryRsp,
                                                CollectorSink,
                                                SloStatusReq, SloStatusRsp)
    from tpu3fs_torch.monitor.recorder import Sample
    from tpu3fs_torch.rpc.net import RpcClient

    port = _free_port()
    log = tmp_path / "monitor.log"
    proc = _child(["tpu3fs_torch.bin.monitor_main", "--port", str(port),
                   f"--config.out_path={tmp_path / 'samples.db'}"], log)
    rpc = RpcClient()
    try:
        now = time.time()
        sink = CollectorSink(("127.0.0.1", port), rpc)
        _wait(lambda: sink.write([Sample("serving.peer_hits", now,
                                         {"node": "61"}, value=12.0,
                                         count=12)]) or True,
              60.0, "the collector to take a push")
        rsp = rpc.call(("127.0.0.1", port), COLLECTOR_SERVICE_ID, 3,
                       AggQueryReq(name="serving.", prefix=True,
                                   window_s=60.0), AggQueryRsp)
        assert [(r.name, r.vsum) for r in rsp.rows] == \
            [("serving.peer_hits", 12.0)]
        st = rpc.call(("127.0.0.1", port), COLLECTOR_SERVICE_ID, 4,
                      SloStatusReq(), SloStatusRsp)
        assert st.verdict == "OK"
        _stop_child(proc, log)
    finally:
        rpc.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(STOP_S)
