"""Application lifecycle: the service-binary skeleton.

The port's own copy of ``tpu3fs/app/application.py``. Two additions:
every app takes a keyword ``device`` (else the ``--device`` flag), which
``checked_device`` resolves to ``cuda`` and which raises at construction
when no card is present and none was asked for; the app's storage
services, targets, clients and rebuild workers run their checksums and
codecs there. ``join`` waits, with a bound, for a ``run_background`` app
to finish stopping. ``--rpc native`` (the C++ transport) is not ported
(ROADMAP M6a-3) and raises ``NotImplementedError``.

Re-expresses the reference's app framework (src/common/app/ApplicationBase,
TwoPhaseApplication.h:36-103, OnePhaseApplication.h, src/core/app/
ServerLauncher.h): parse flags -> (two-phase only: launcher registers at
mgmtd and fetches the node-type config template) -> merge config template
<- file <- ``--config.k=v`` flag overrides -> init common components
(logging, monitor) -> build + start the RPC server -> run until stopped.

Two-phase services also run the heartbeat loop: versioned heartbeats carry
per-target local states up and bring config pushes down (hot-updated in
place, ref CoreServiceDef.h hotUpdateConfig via heartbeat); a service that
cannot reach mgmtd for half the failure-declaration timeout stops itself
(design_notes "Failure detection": suicide at T/2).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu3fs_torch.device import checked_device
from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.rpc.services import bind_core_service
from tpu3fs_torch.utils.config import Config
from tpu3fs_torch.utils.logging import init_logging, xlog


@dataclass
class AppInfo:
    """ref flat::AppInfo carried in heartbeats/registration."""

    node_id: int = 0
    node_type: NodeType = NodeType.CLIENT
    hostname: str = "127.0.0.1"
    port: int = 0
    pid: int = field(default_factory=os.getpid)
    start_time: float = field(default_factory=time.time)


class ApplicationBase:
    """Common skeleton; subclasses define node_type/default_config and wire
    their services in build_services()."""

    node_type: NodeType = NodeType.CLIENT

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        self.argv = list(argv or [])
        self.config = self.default_config()
        self.info = AppInfo(node_type=self.node_type)
        self.server: Optional[RpcServer] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._runners: List = []  # PeriodicRunner instances
        self._flags: Dict[str, str] = {}
        self._parse_argv()
        # the keyword wins over --device; neither -> cuda, or raise
        self.device = checked_device(
            device if device is not None else (self.flag("device") or None))

    # -- flags --------------------------------------------------------------
    def _parse_argv(self) -> None:
        """--key value pairs, plus --config.dotted=value overrides applied to
        the config tree (ref TwoPhaseApplication.h:31-33 dynamic overrides)."""
        rest = self.config.apply_flag_overrides(self.argv)
        it = iter(rest)
        for tok in it:
            if tok.startswith("--"):
                key = tok[2:]
                if "=" in key:
                    key, val = key.split("=", 1)
                else:
                    val = next(it, "")
                self._flags[key.replace("-", "_")] = val
        if "node_id" in self._flags:
            self.info.node_id = int(self._flags["node_id"])
        if "host" in self._flags:
            self.info.hostname = self._flags["host"]
        cfg_file = self._flags.get("cfg")
        if cfg_file:
            with open(cfg_file) as f:
                self.config.load_toml(f.read())
            # flag overrides win over the file (ref initConfig merge order)
            self.config.apply_flag_overrides(self.argv)

    def flag(self, name: str, default: str = "") -> str:
        return self._flags.get(name, default)

    # -- subclass hooks -----------------------------------------------------
    def default_config(self) -> Config:
        return Config()

    def build_services(self, server: RpcServer) -> None:
        raise NotImplementedError

    def before_start(self) -> None:
        """Runs after services are bound, before serving (ref beforeStart)."""

    def after_stop(self) -> None:
        """Teardown hook (flush engines, close files)."""

    # -- lifecycle ----------------------------------------------------------
    def init_common_components(self) -> None:
        """ref initCommonComponents: logging + monitor + tracing (IBManager
        has no TPU analogue; ICI links need no per-process bring-up)."""
        init_logging(
            path=self.flag("log_file") or None,
            level=self.flag("log_level", "INFO"),
        )
        self._init_tracing()
        self._init_flight()
        xlog("INFO", "%s node %d starting (pid %d)",
             type(self).__name__, self.info.node_id, self.info.pid)

    def _init_tracing(self) -> None:
        """Configure the per-process tracer (tpu3fs/analytics/spans.py)
        from the config tree's ``trace`` section when the binary declares
        one (hot-updatable via config push), with ``--trace-dir`` /
        ``--trace-sample`` / ``--trace-slow-ms`` flag overrides for
        binaries run by hand."""
        from tpu3fs_torch.analytics.spans import TraceConfig, tracer

        service = type(self).__name__.replace("App", "").lower() or "proc"
        tcfg = getattr(self.config, "trace", None)
        if isinstance(tcfg, TraceConfig):
            if self.flag("trace_dir"):
                tcfg.set("dir", self.flag("trace_dir"))
            if self.flag("trace_sample"):
                tcfg.set("sample_rate", float(self.flag("trace_sample")))
            if self.flag("trace_slow_ms"):
                tcfg.set("slow_op_ms", float(self.flag("trace_slow_ms")))
            tracer().apply_config(tcfg, service=service,
                                  node=self.info.node_id)
        elif self.flag("trace_dir"):
            tracer().configure(
                service=service, node=self.info.node_id,
                directory=self.flag("trace_dir"),
                sample_rate=float(self.flag("trace_sample", "0") or 0),
                slow_op_ms=float(self.flag("trace_slow_ms", "200") or 200))
        if tracer().enabled:
            # bounded visibility lag for live trace consumers (the
            # assembler, trace-show): flush the columnar buffer on a tick
            self.spawn_periodic("trace-flush", 2.0, tracer().flush)

    def _init_flight(self) -> None:
        """Arm the per-process flight recorder (monitor/flight.py): a
        bounded black-box ring of recent slow-op spans, samples, config
        pushes and alerts, dumped on SLO breach / fatal signal /
        ``admin_cli flight-dump``. The ring is ALWAYS on (bounded by
        construction); dumps to disk need a configured ``flight.dir``
        (``--flight-dir`` for binaries run by hand)."""
        from tpu3fs_torch.analytics.spans import tracer
        from tpu3fs_torch.monitor.flight import (
            FlightConfig,
            apply_flight_config,
            flight,
        )
        from tpu3fs_torch.monitor.recorder import Monitor

        service = type(self).__name__.replace("App", "").lower() or "proc"
        fcfg = getattr(self.config, "flight", None)
        if isinstance(fcfg, FlightConfig):
            if self.flag("flight_dir"):
                fcfg.set("dir", self.flag("flight_dir"))
            apply_flight_config(fcfg, service=service,
                                node=self.info.node_id)
        else:
            flight().configure(service=service, node=self.info.node_id,
                               dump_dir=self.flag("flight_dir") or None)
        # feeds: slow-op spans off the tracer's flush hook, recent
        # samples off a Monitor ring sink (the collector keeps the
        # full-fidelity copy; the black box keeps what fits)
        tracer().add_slow_hook(flight().record_spans)
        Monitor.default().add_sink(flight().sample_sink())

    def init_server(self) -> None:
        port = int(self.flag("port", "0"))
        # --rpc=native (the C++ epoll transport) is not ported
        if self.flag("rpc", "python") == "native":
            raise NotImplementedError(
                "--rpc native (the C++ transport, rpc/native_net.py) is not "
                "ported (ROADMAP M6a-3); the port serves over the Python "
                "transport only")
        self.server = RpcServer(self.info.hostname, port)
        self.info.port = self.server.port
        self._init_qos()
        self._init_tenants()
        self._init_fault_plane()
        bind_core_service(self.server, config=self.config,
                          on_shutdown=self.stop)
        self.build_services(self.server)

    def _init_qos(self) -> None:
        """Every service binary whose config tree declares a ``qos``
        section gets an AdmissionController enforced in its RPC dispatch
        (token bucket + concurrency cap per (service, method, traffic
        class), qos/core.py). Limits hot-update through the same config
        tree a mgmtd config push lands in — no restart."""
        self.admission = None
        qos_cfg = getattr(self.config, "qos", None)
        from tpu3fs_torch.qos.core import AdmissionController, QosConfig

        if isinstance(qos_cfg, QosConfig):
            self.admission = AdmissionController(
                qos_cfg, tags={"node": str(self.info.node_id),
                               "kind": type(self).__name__})
            set_adm = getattr(self.server, "set_admission", None)
            if set_adm is not None:
                set_adm(self.admission, exempt=self._qos_exempt_services())

    def _qos_exempt_services(self) -> set:
        """Service ids whose admission happens inside the service itself
        (storage: the QoS manager shares the controller, so RPC-level
        charging would double-count)."""
        return set()

    def _init_tenants(self) -> None:
        """Bind the process-global tenant registry to the binary's
        ``tenants`` config section when it declares one: a mgmtd config
        push of ``[tenants] spec=...`` then retunes the per-tenant quota
        buckets + WFQ lane weights live (tpu3fs/tenant, docs/tenancy.md)."""
        from tpu3fs_torch.tenant.quota import TenantConfig, apply_tenant_config

        tcfg = getattr(self.config, "tenants", None)
        if isinstance(tcfg, TenantConfig):
            apply_tenant_config(tcfg)

    def _init_fault_plane(self) -> None:
        """Bind the process-global cluster fault plane to the binary's
        ``faults`` config section when it declares one: a mgmtd config
        push of ``[faults] spec=...`` then arms/retunes/clears injected
        faults live (utils/fault_injection.py; admin_cli fault verbs)."""
        from tpu3fs_torch.utils.fault_injection import (
            FaultPlaneConfig,
            apply_plane_config,
        )

        fcfg = getattr(self.config, "faults", None)
        if isinstance(fcfg, FaultPlaneConfig):
            apply_plane_config(fcfg)

    def start_server(self) -> None:
        assert self.server is not None
        self.before_start()
        self.server.start()
        xlog("INFO", "node %d serving on %s:%d",
             self.info.node_id, self.info.hostname, self.info.port)

    def _install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> flight dump + graceful stop (unmount, close
        sessions); SIGUSR2 -> flight dump WITHOUT stopping (the live
        "show me your black box" poke). Only possible from the main
        thread; in-process tests skip this."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return

        def _fatal(signum, _frame):
            self._flight_dump(f"signal {signum}")
            self.stop()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _fatal)
        signal.signal(
            signal.SIGUSR2,
            lambda *_: self._flight_dump("SIGUSR2"))

    def _flight_dump(self, reason: str) -> str:
        """Dump the process black box if a dump dir is configured."""
        from tpu3fs_torch.monitor.flight import flight

        try:
            return flight().dump(reason=reason)
        except Exception as e:
            xlog("WARN", "flight dump failed: %r", e)
            return ""

    def run(self, *, block: bool = True) -> "ApplicationBase":
        self.init_common_components()
        self.init_server()
        self.start_server()
        self._start_memory_monitor()
        self._start_monitor_push()
        if block:
            self._install_signal_handlers()
            self.wait()
        return self

    def _start_monitor_push(self) -> None:
        """Ship this process's Monitor samples to monitor_collector on a
        period — every service binary, not just the ones that remembered
        to (ref Monitor.cc periodic collection + MonitorCollectorClient).

        The collector address comes from ``--collector host:port`` or the
        config item ``collector`` (hot: a config push can point the fleet
        at a collector, or away from a dead one, live); the period from
        ``monitor_push_period_s`` (hot) or ``--monitor-period``. With no
        address the loop still collects (recorders reset each window) but
        ships nothing. Outages buffer bounded with drop-counting
        (monitor.collector.BufferedCollectorSink).

        DE-SYNCHRONIZED: each tick jitters ±20% (N binaries configured
        with the same period must not wake and hammer the collector in
        lockstep) and multiplies by the sink's backoff (2x per
        consecutive failed drain, capped 8x) so a dead collector's
        return isn't a thundering herd. A push Ack whose dump_epoch
        grew triggers the local flight-recorder dump (the SLO-breach
        black-box broadcast)."""
        from tpu3fs_torch.monitor.collector import BufferedCollectorSink
        from tpu3fs_torch.monitor.recorder import Monitor

        def addr():
            spec = getattr(self.config, "collector", "")
            return spec or self.flag("collector") or None

        def period() -> float:
            p = getattr(self.config, "monitor_push_period_s", None)
            if p is not None:
                base = float(p)
            else:
                base = float(self.flag("monitor_period", "5") or 5)
            return base * self.monitor_sink.backoff

        self.monitor_sink = BufferedCollectorSink(addr)
        self.monitor_sink.on_dump(
            lambda reason: self._flight_dump(reason))
        monitor = Monitor.default()
        monitor.add_sink(self.monitor_sink)
        self.spawn_periodic("monitor-push", period, monitor.collect,
                            jitter=0.2)

    def _start_memory_monitor(self, interval_s: float = 30.0) -> None:
        """Periodic process-memory gauges (ref src/memory counters), plus
        the subsystem memory sources: content-arena resident/recycled
        extent bytes (storage/engine.py), transport BufferPool leases —
        kvcache host/dirty gauges are set by their owning tier objects."""
        from tpu3fs_torch.monitor.memory import MemoryMonitor

        self.memory_monitor = MemoryMonitor(
            {"node": str(self.info.node_id),
             "kind": type(self).__name__})
        from tpu3fs_torch.storage.engine import arena_stats
        from tpu3fs_torch.utils.bufpool import GLOBAL_POOL

        self.memory_monitor.add_source(
            "mem.arena_resident_bytes",
            lambda: arena_stats()["resident_bytes"])
        self.memory_monitor.add_source(
            "mem.arena_recycled_bytes",
            lambda: arena_stats()["recycled_bytes"])
        self.memory_monitor.add_source(
            "mem.bufpool_pooled_bytes",
            lambda: GLOBAL_POOL.stats()["pooled_bytes"])
        self.memory_monitor.add_source(
            "mem.bufpool_outstanding",
            lambda: GLOBAL_POOL.stats()["outstanding"])

        self.memory_monitor.poll_once()
        self.spawn_periodic("memory-monitor", interval_s,
                            self.memory_monitor.poll_once)

    def wait(self) -> None:
        try:
            while not self._stop.wait(0.2):
                pass
        except KeyboardInterrupt:
            pass
        self._shutdown()

    def stop(self) -> None:
        self._stop.set()
        for r in self._runners:
            r.request_stop()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def _shutdown(self) -> None:
        if self.server is not None:
            self.server.stop()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=2.0)
        self.after_stop()
        # the span sink buffers flush_rows rows; a stop must not lose the
        # tail of the trace (same contract as the storage event trace)
        from tpu3fs_torch.analytics.spans import tracer

        tracer().flush()
        xlog("INFO", "node %d stopped", self.info.node_id)

    def spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def spawn_periodic(self, name: str, interval_s, fn, *,
                       jitter: float = 0.1):
        """Named periodic background task (ref BackgroundRunner.h), tied
        to the app's stop(): interval_s may be a zero-arg callable so
        hot-updated config intervals take effect on the next tick."""
        from tpu3fs_torch.utils.executor import PeriodicRunner

        r = PeriodicRunner(name, interval_s, fn, jitter=jitter)
        r.start()
        self._runners.append(r)
        if r._thread is not None:
            self._threads.append(r._thread)  # joined in _shutdown
        return r

    def run_background(self) -> "ApplicationBase":
        """Start and return without blocking; caller stops via stop()+join()."""
        self.run(block=False)
        self.spawn(self.wait, "app-wait")
        return self

    def join(self, timeout: float = 10.0) -> bool:
        """Wait until a ``run_background`` app has shut down (server
        stopped, runners joined, ``after_stop`` run), at most ``timeout``
        seconds -> True when it has."""
        deadline = time.monotonic() + timeout
        for t in list(self._threads):
            if t.name == "app-wait":
                t.join(timeout=max(0.0, deadline - time.monotonic()))
                return not t.is_alive()
        return True


class OnePhaseApplication(ApplicationBase):
    """Config comes only from the local file + flags (ref
    OnePhaseApplication.h — mgmtd itself and monitor_collector boot this
    way: they cannot fetch config from mgmtd)."""


class TwoPhaseApplication(ApplicationBase):
    """Phase 1 (launcher): connect to mgmtd, fetch the node-type config
    template, register the node. Phase 2: serve + heartbeat loop.
    ref TwoPhaseApplication.h:36-103 + ServerMgmtdClientFetcher."""

    heartbeat_interval_s: float = 10.0
    heartbeat_timeout_s: float = 60.0  # T; suicide at T/2 without contact

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.mgmtd_client = None  # set in launcher_phase
        self._hb_version = 0
        self._config_version = 0
        self._last_mgmtd_contact = time.time()
        self._hb_fail_start = None
        if self.flag("heartbeat_interval"):
            self.heartbeat_interval_s = float(self.flag("heartbeat_interval"))
        if self.flag("heartbeat_timeout"):
            self.heartbeat_timeout_s = float(self.flag("heartbeat_timeout"))

    def _mgmtd_addr(self):
        """--mgmtd host:port[,host:port...] — multiple addresses form the
        client-side failover list (ref MgmtdClient's server list): a dead
        primary's lease expires and a standby takes over, so servers keep
        heartbeating/routing through whichever mgmtd answers."""
        spec = self.flag("mgmtd")
        if not spec:
            raise SystemExit("--mgmtd host:port[,host:port...] is required")
        addrs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue  # tolerate trailing/duplicate commas
            try:
                host, port = part.rsplit(":", 1)
                addrs.append((host, int(port)))
            except ValueError:
                raise SystemExit(
                    f"bad --mgmtd entry {part!r}: want host:port")
        if not addrs:
            raise SystemExit("--mgmtd host:port[,host:port...] is required")
        return addrs  # always a list; MgmtdRpcClient takes either shape

    def launcher_phase(self) -> None:
        from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient
        from tpu3fs_torch.utils.result import FsError

        self.mgmtd_client = MgmtdAdminRpcClient(self._mgmtd_addr())
        # mgmtd may still be booting; the reference launcher retries its
        # config fetch too (ServerMgmtdClientFetcher)
        deadline = time.time() + float(self.flag("launcher_timeout", "30"))
        while True:
            try:
                blob = self.mgmtd_client.get_config(self.node_type)
                break
            except FsError:
                if time.time() >= deadline:
                    raise
                time.sleep(0.5)
        if blob.content:
            self.config.load_toml(blob.content)
            self._config_version = blob.version
            # file + flags still win over the remote template
            cfg_file = self.flag("cfg")
            if cfg_file:
                with open(cfg_file) as f:
                    self.config.load_toml(f.read())
            self.config.apply_flag_overrides(self.argv)

    def register(self) -> None:
        self.mgmtd_client.register_node(
            self.info.node_id, self.node_type,
            self.info.hostname, self.info.port,
        )
        self._last_mgmtd_contact = time.time()

    # -- heartbeat ----------------------------------------------------------
    def local_target_states(self) -> Dict[int, LocalTargetState]:
        """Storage services report per-target states; others report none."""
        return {}

    def meta_partition_loads(self) -> Dict[int, float]:
        """META services report per-partition op counts since the last
        beat (tpu3fs/metashard load spreading); others report none."""
        return {}

    def _apply_config_push(self, version: int, content: str) -> None:
        if version > self._config_version and content:
            from tpu3fs_torch.rpc.services import _flatten
            from tpu3fs_torch.utils.config import tomllib

            from tpu3fs_torch.monitor.flight import flight

            try:
                self.config.hot_update(_flatten(tomllib.loads(content)))
                self._config_version = version
                xlog("INFO", "node %d applied config v%d",
                     self.info.node_id, version)
                flight().record("config", version=version, ok=True,
                                source="mgmtd-heartbeat",
                                nbytes=len(content))
            except Exception as e:
                xlog("ERR", "node %d config push v%d rejected: %r",
                     self.info.node_id, version, e)
                flight().record("config", version=version, ok=False,
                                source="mgmtd-heartbeat", error=repr(e))

    def heartbeat_once(self) -> bool:
        try:
            self._hb_version += 1
            reply = self.mgmtd_client.heartbeat(
                self.info.node_id, self._hb_version,
                self.local_target_states(),
                meta_loads=self.meta_partition_loads() or None,
            )
            self._last_mgmtd_contact = time.time()
            self._hb_fail_start = None
            self._apply_config_push(reply.config_version, reply.config_content)
            # PROMPT routing convergence: the heartbeat reply carries the
            # primary's routing version — when it is ahead of our cached
            # snapshot (e.g. a target was just demoted OFFLINE), expire
            # the TTL cache and refresh NOW instead of serving the stale
            # snapshot for up to a full TTL window
            known = self.mgmtd_client.known_routing_version()
            if 0 <= known < reply.routing_version:
                self.mgmtd_client.invalidate_routing()
                try:
                    self.mgmtd_client.refresh_routing()
                except Exception:
                    pass  # the next data-plane resolve retries
            return True
        except Exception as e:
            xlog("WARN", "node %d heartbeat failed: %r", self.info.node_id, e)
            # STALE-VERSION FAST-FORWARD: a restarted node begins at
            # hb_version 1 while mgmtd remembers its pre-crash counter —
            # without this it would burn one rejected beat per missing
            # version (a SIGKILLed migration destination took ~17s to
            # re-join). The refusal message carries the expected floor
            # ("<ours> < <mgmtd's>"): jump past it and re-join next beat.
            from tpu3fs_torch.utils.result import Code as _Code

            if getattr(e, "code", None) == _Code.MGMTD_STALE_HEARTBEAT:
                try:
                    floor = int(str(e).rstrip("')\"").split("<")[-1])
                    self._hb_version = max(self._hb_version, floor)
                except (ValueError, IndexError):
                    pass
            # a reachable mgmtd that refuses (e.g. standby during the dead
            # primary's residual lease) still proves the FLEET is there:
            # count a successful routing read as contact so T/2 suicide
            # doesn't kill a healthy cluster mid-failover. BOUNDED: a
            # routing read cannot tell 'no primary exists yet' (safe)
            # from 'a live primary I cannot reach' (asymmetric partition
            # — unsafe to keep serving), so the credit only extends the
            # silence budget to ~T total. Past that, a node that cannot
            # HEARTBEAT anywhere exits even though routing reads work —
            # closing the split-brain window roughly when the primary
            # declares it dead. Co-tune lease_length_s <= T/2 so real
            # failovers finish inside the credit.
            now = time.time()
            if self._hb_fail_start is None:
                self._hb_fail_start = now
            within_credit = (now - self._hb_fail_start
                            < self.heartbeat_timeout_s / 2)
            if within_credit:
                try:
                    self.mgmtd_client.refresh_routing()
                    self._last_mgmtd_contact = now
                except Exception:
                    pass
            return False

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            self.heartbeat_once()
            silence = time.time() - self._last_mgmtd_contact
            if silence > self.heartbeat_timeout_s / 2:
                xlog("ERR",
                     "node %d lost mgmtd for %.0fs > T/2=%.0fs: exiting "
                     "(design_notes failure detection)",
                     self.info.node_id, silence, self.heartbeat_timeout_s / 2)
                self.stop()
                return

    def routing(self):
        return self.mgmtd_client.refresh_routing()

    def _routing_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                self.mgmtd_client.refresh_routing()
            except Exception:
                pass

    def run(self, *, block: bool = True) -> "TwoPhaseApplication":
        self.init_common_components()
        self.launcher_phase()
        self.init_server()
        self.register()
        self.start_server()
        self.heartbeat_once()
        self.spawn(self._heartbeat_loop, "heartbeat")
        self.spawn(self._routing_loop, "routing-poll")
        # two-phase services get the same observability plumbing as
        # one-phase ones (this run() does not call the base run(), and
        # several binaries historically shipped no samples at all)
        self._start_memory_monitor()
        self._start_monitor_push()
        if block:
            self._install_signal_handlers()
            self.wait()
        return self
