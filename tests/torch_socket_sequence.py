"""One seeded file sequence through a cluster of service apps over loopback
TCP, for the socket parity tests: the same calls drive the JAX package's
``MgmtdApp``/``StorageApp``/``MetaApp`` and the port's, and the record is
``torch_fabric_sequence.run_sequence``'s (the same steps, the same
checks). This module imports neither package statically: ``AppCluster``
takes the package's name and loads its binaries with ``importlib``.

The cluster is built as ``tests/test_app.py`` builds it (mgmtd, storage
apps with ``engine=mem`` and ``usrbio=0``, or ``usrbio=1`` with
``AppCluster(..., usrbio=True)``, a meta app; targets, chains and
a chain table uploaded through ``MgmtdAdminRpcClient``), with every
background loop parked (hour-long intervals): the sequence drives the
heartbeats, mgmtd's ticks, target scans and resync rounds itself, on a
clock of its own for mgmtd, as ``Fabric.fail_node``/``resync_all`` do, so
two runs step through the same routing versions.

Randomness: an EC stripe version carries a writer nonce and a file's
layout seed comes from ``time.time_ns``. ``deterministic`` draws both from
a seed. It patches the client's nonce draw and the meta store's clock
rather than ``os.urandom`` and ``time.time_ns`` themselves (as
``torch_fabric_sequence.deterministic`` does for one thread): over
sockets, every RPC's uuid4 and the servers' threads draw from those too,
in an order the threads decide."""

from __future__ import annotations

import contextlib
import importlib
import itertools
import threading
from types import SimpleNamespace
from unittest import mock

import numpy as np

from torch_fabric_sequence import run_sequence  # noqa: F401  (re-export)

PARKED = "3600"  # seconds: background loops never fire during a run

SHAPES = {
    "ec_4_2": dict(nodes=6, chains=2, chunk_size=16 << 10, ec_k=4, ec_m=2),
    "cr_2": dict(nodes=3, chains=2, chunk_size=16 << 10, replicas=2),
}


class _StepClock:
    """mgmtd's clock: starts at a fixed second and moves only when told."""

    def __init__(self, t: float = 1_800_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _TimeNs:
    """A ``time`` module whose ``time_ns`` counts from a fixed start."""

    def __init__(self, real):
        self._real = real
        self._ns = itertools.count(1_700_000_000_000_000_000, 1_000_003)

    def time_ns(self) -> int:
        return next(self._ns)

    def __getattr__(self, name):
        return getattr(self._real, name)


@contextlib.contextmanager
def deterministic(pkg: str, seed: int = 0):
    """EC writer nonces and layout seeds of ``pkg`` drawn from ``seed``."""
    sc = importlib.import_module(f"{pkg}.client.storage_client")
    store = importlib.import_module(f"{pkg}.meta.store")
    rng = np.random.default_rng(seed)
    lock = threading.Lock()

    def next_ver(self, prev_encoded: int) -> int:
        with lock:
            nonce = int.from_bytes(rng.bytes(4), "big")
        return ((sc.ec_logical_ver(prev_encoded) + 1)
                << sc.EC_VER_SHIFT) | nonce

    with mock.patch.object(sc.StorageClient, "_ec_next_ver", next_ver), \
            mock.patch.object(store, "time", _TimeNs(store.time)):
        yield


class AppCluster:
    """mgmtd, ``nodes`` storage apps and a meta app of package ``pkg`` on
    loopback, with the surface ``run_sequence`` drives (``cfg``, ``meta``,
    ``file_client``, ``nodes``, ``fail_node``, ``restart_node``,
    ``resync_all``, ``run_gc``, ``routing``). ``app_kw`` goes to every app
    (the port's take ``device``); ``client_kw`` to every storage client.
    A failed node's app is stopped (its server closes); a restarted node
    is a new app with empty targets, as a replaced disk. ``close`` stops
    every app and waits for each, with a bound. With ``usrbio`` the storage
    apps host USRBIO rings (the clients ride them unless
    ``TPU3FS_USRBIO=0``); ``close`` then also closes the rings every
    messenger of the cluster opened.

    Storage clients read without hedging: a hedged read runs on the
    client package's process-wide runner pool, whose idle threads would
    outlive the cluster (the replies are the same either way)."""

    MGMTD_ID, META_ID, FIRST_STORAGE = 1, 201, 101

    def __init__(self, pkg: str, shape: dict, *, app_kw=None, client_kw=None,
                 usrbio: bool = False):
        self.pkg = pkg
        self.usrbio = usrbio
        self.shape = dict(shape)
        self.cfg = SimpleNamespace(chunk_size=shape["chunk_size"])
        self._app_kw = dict(app_kw or {})
        self._client_kw = dict(client_kw or {})
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self._bin = SimpleNamespace(
            mgmtd=mod("bin.mgmtd_main"), storage=mod("bin.storage_main"),
            meta=mod("bin.meta_main"))
        self._svc = mod("rpc.services")
        self._sc = mod("client.storage_client")
        self._fio = mod("client.file_io")
        self._resync = mod("storage.resync")
        self._ec_resync = mod("storage.ec_resync")
        self._types = mod("mgmtd.types")
        self.clock = _StepClock()
        self.apps = []
        self.nodes = {}
        self._clients = []
        self.messengers = []   # every messenger the cluster built
        try:
            self._boot()
        except BaseException:
            self.close()
            raise

    # -- boot ---------------------------------------------------------------
    def _boot(self) -> None:
        shape = self.shape
        self.mgmtd_app = self._bin.mgmtd.MgmtdApp(
            ["--node-id", str(self.MGMTD_ID),
             f"--config.tick_interval_s={PARKED}",
             "--config.heartbeat_timeout_s=60"],
            clock=self.clock, **self._app_kw)
        self.mgmtd_app.run_background()
        self.apps.append(self.mgmtd_app)
        self.maddr = (self.mgmtd_app.info.hostname, self.mgmtd_app.info.port)
        self.admin = self._svc.MgmtdAdminRpcClient(self.maddr)
        ids = [self.FIRST_STORAGE + i for i in range(shape["nodes"])]
        for node_id in ids:
            self._start_storage(node_id)
        specs, table = self.chain_specs(ids)
        tid = 1001
        for chain_id, members, ec in specs:
            targets = []
            for node_id in members:
                self.admin.create_target(tid, node_id=node_id)
                targets.append(tid)
                tid += 1
            self.admin.upload_chain(chain_id, targets, **ec)
        self.admin.upload_chain_table(1, table)
        for node_id in ids:
            app = self.nodes[node_id]
            app.scan_targets()
            app.heartbeat_once()
        self.meta_app = self._bin.meta.MetaApp(
            self._two_phase_argv(self.META_ID)
            + [f"--config.gc_interval_s={PARKED}",
               f"--config.chunk_size={shape['chunk_size']}"],
            **self._app_kw)
        self.meta_app.run_background()
        self.apps.append(self.meta_app)
        self.meta = self._svc.MetaRpcClient(
            [(self.meta_app.info.hostname, self.meta_app.info.port)],
            client_id="seq")
        self.tick()

    def chain_specs(self, ids):
        """-> ([(chain id, member node ids, EC keywords)], the chain
        table's chain ids): ``chains`` chains, EC over every node or CR
        of ``replicas`` consecutive nodes."""
        shape, specs = self.shape, []
        for c in range(shape["chains"]):
            if "ec_k" in shape:
                specs.append((900 + c, ids,
                              dict(ec_k=shape["ec_k"], ec_m=shape["ec_m"])))
            else:
                specs.append((900 + c, [ids[(c + r) % len(ids)]
                                        for r in range(shape["replicas"])],
                              {}))
        return specs, [s[0] for s in specs]

    def _two_phase_argv(self, node_id: int) -> list:
        return ["--node-id", str(node_id),
                "--mgmtd", "%s:%d" % self.maddr,
                "--heartbeat_interval", PARKED]

    def _start_storage(self, node_id: int):
        app = self._bin.storage.StorageApp(
            self._two_phase_argv(node_id)
            + ["--config.engine=mem", f"--config.usrbio={int(self.usrbio)}",
               f"--config.target_scan_interval_s={PARKED}",
               f"--config.resync_interval_s={PARKED}",
               f"--config.check_interval_s={PARKED}",
               f"--config.punch_hole_interval_s={PARKED}",
               f"--config.chunk_size={self.shape['chunk_size']}"],
            **self._app_kw)
        app.run_background()
        self.apps.append(app)
        self.nodes[node_id] = app
        return app

    # -- what run_sequence drives ------------------------------------------
    def routing(self):
        return self.mgmtd_app.mgmtd.get_routing_info()

    def messenger(self):
        m = self._svc.RpcMessenger(self.admin.refresh_routing)
        self.messengers.append(m)
        return m

    def storage_client(self, client_id: str = "seq"):
        sc = self._sc.StorageClient(
            client_id, self.admin.refresh_routing, self.messenger(),
            retry=self._sc.RetryOptions(hedge_reads=False),
            **self._client_kw)
        self._clients.append(sc)
        return sc

    def file_client(self):
        return self._fio.FileIoClient(self.storage_client())

    def heartbeat_all(self) -> None:
        for app in list(self.nodes.values()) + [self.meta_app]:
            if not app.stopped:
                app.heartbeat_once()

    def tick(self) -> None:
        """Heartbeats, mgmtd's chain update, then heartbeats again: their
        replies carry the new routing version, and each app refreshes its
        routing on seeing it (the apps' own poll loops are parked)."""
        self.heartbeat_all()
        self.mgmtd_app.mgmtd.tick()
        self.heartbeat_all()

    def fail_node(self, node_id: int) -> None:
        """Stop the node's app, let mgmtd's heartbeat timeout pass, tick."""
        app = self.nodes[node_id]
        app.stop()
        assert join_app(app), f"storage app {node_id} did not stop"
        self.clock.advance(61.0)
        self.tick()

    def restart_node(self, node_id: int) -> None:
        """A new app for the node, its targets empty (a replaced disk)."""
        app = self._start_storage(node_id)
        app.heartbeat_once()  # a stale hb_version: fast-forwards
        app.scan_targets()
        self.tick()

    def resync_all(self, rounds: int = 4) -> int:
        moved = 0
        serving = self._types.PublicTargetState.SERVING
        for _ in range(rounds):
            for app in self.nodes.values():
                if app.stopped:
                    continue
                messenger = self.messenger()
                moved += self._resync.ResyncWorker(
                    app.service, messenger).run_once()
                moved += self._ec_resync.EcResyncWorker(
                    app.service, messenger, **self._app_kw).run_once()
            self.tick()
            if all(t.public_state == serving
                   for chain in self.routing().chains.values()
                   for t in chain.targets):
                break
        return moved

    def run_gc(self) -> int:
        return self.meta_app.run_gc()

    def close(self) -> None:
        for sc in self._clients:
            sc.close()
        for app in reversed(self.apps):
            app.stop()
        for app in reversed(self.apps):
            join_app(app)
            service = getattr(app, "service", None)
            if service is not None and hasattr(service, "stop_workers"):
                # the JAX package's storage app leaves its update workers
                # (the port's joins them on stop)
                service.stop_workers()
            # the storage services' forwarding messengers open rings to
            # their peers (the JAX package's app leaves them to exit)
            close_rings = getattr(getattr(service, "_messenger", None),
                                  "close_rings", None)
            if close_rings is not None:
                close_rings()
        for m in self.messengers:
            m.close_rings()


def join_app(app, timeout: float = 10.0) -> bool:
    """Wait for a stopped ``run_background`` app to finish shutting down:
    the port's ``join``; the JAX package's apps have none, so their
    ``app-wait`` thread is joined."""
    join = getattr(app, "join", None)
    if join is not None:
        return join(timeout)
    for t in list(app._threads):
        if t.name == "app-wait":
            t.join(timeout)
            return not t.is_alive()
    return True


def threads_left(before, timeout: float = 5.0) -> list:
    """Threads started since ``before`` still alive after a bounded join
    (a stopped server's connection threads end once their sockets close).
    The port's process-wide hedge runners are kept by design."""
    new = [t for t in set(threading.enumerate()) - set(before)
           if t.name != "hedge-runner"]
    for t in new:
        t.join(timeout)
    return sorted(t.name for t in new if t.is_alive())
