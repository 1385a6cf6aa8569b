"""QoS core: traffic classes, tagging, token buckets, admission control.

The port's own copy of ``tpu3fs/qos/core.py``,
unchanged but for its imports.

Traffic is classified once, as close to its origin as possible, and the
class rides three channels so every transport sees it:

1. THREAD-LOCAL tag (``tagged``): background workers (resync, EC rebuild,
   migration, GC) tag their own traffic; in-process dispatch (the test
   fabric, direct messengers) inherits the tag for free because the
   handler runs on the tagging thread.
2. RPC ENVELOPE flag bits (``class_to_flags``/``class_from_flags``): the
   Python socket client stamps the current tag into MessagePacket.flags
   (bits 8-11) so a remote server can restore it around the handler. The
   native C++ transport reads the same bits for its cheap admission check.
3. REQUEST-SHAPE inference (``infer_write_class``): a server receiving an
   untagged write can still classify it — resync full-replaces carry
   ``from_target != 0``/``full_replace``, migration writes a
   ``migration-`` client id — so scheduling degrades gracefully on
   transports that do not propagate tags.

Admission is token-bucket + concurrency-cap, keyed (service, method,
traffic class) with per-class fallbacks, limits living in a declarative
``QosConfig`` tree (hot-updatable via mgmtd config push). A shed returns a
retry-after hint; ``format_retry_after``/``retry_after_ms_of`` are the one
encoding of that hint in envelope messages.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import threading
import time
from typing import Dict, Optional, Tuple

from tpu3fs_torch.utils.config import Config, ConfigItem


class TrafficClass(enum.IntEnum):
    """The traffic-class taxonomy (foreground first, background after).

    Mirrors the reference's implicit split of 32 foreground vs 8
    background update threads per disk (UpdateWorker.h:11-46) as an
    explicit, schedulable axis.
    """

    FG_READ = 0       # latency-sensitive client reads
    FG_WRITE = 1      # client writes (incl. chain-internal forwards)
    CONTROL = 2       # heartbeats, routing, config, admin
    RESYNC = 3        # CR full-chunk-replace recovery copies
    EC_REBUILD = 4    # EC decode rebuild + two-phase repair sweeps
    MIGRATION = 5     # chain-to-chain migration jobs
    GC = 6            # garbage collection / trash sweeps
    CKPT = 7          # training-checkpoint save/restore/archival (ckpt/)
    DATALOAD = 8      # training data loader batch reads (dataload/)
    KVCACHE = 9       # inference KV-cache serving tier (kvcache/)


#: Classes whose work is elastic: they self-throttle under pressure and
#: get bounded queue shares so they can never starve foreground IO.
BACKGROUND_CLASSES = frozenset({
    TrafficClass.RESYNC,
    TrafficClass.EC_REBUILD,
    TrafficClass.MIGRATION,
    TrafficClass.GC,
    TrafficClass.CKPT,
})

#: Classes subject to the per-queue share bound. DATALOAD and KVCACHE are
#: here but NOT in BACKGROUND_CLASSES: the training input pipeline and the
#: inference KV-cache tier are latency-coupled to their serving loops
#: (foreground scheduler weight), yet a misconfigured loader or cache-fill
#: flood must still be unable to occupy a whole update queue and starve
#: foreground writes.
SHARE_BOUNDED_CLASSES = BACKGROUND_CLASSES | {TrafficClass.DATALOAD,
                                              TrafficClass.KVCACHE}

#: TrafficClass -> QosConfig section attribute name.
CLASS_ATTRS: Dict[TrafficClass, str] = {
    TrafficClass.FG_READ: "fg_read",
    TrafficClass.FG_WRITE: "fg_write",
    TrafficClass.CONTROL: "control",
    TrafficClass.RESYNC: "resync",
    TrafficClass.EC_REBUILD: "ec_rebuild",
    TrafficClass.MIGRATION: "migration",
    TrafficClass.GC: "gc",
    TrafficClass.CKPT: "ckpt",
    TrafficClass.DATALOAD: "dataload",
    TrafficClass.KVCACHE: "kvcache",
}


# -- context-local tagging ---------------------------------------------------
#
# A ContextVar, not threading.local: per-thread semantics are identical
# (every thread starts untagged), but the tag additionally travels with
# contextvars.copy_context() — which is how WorkerPool.submit carries the
# submitter's class into pool threads (utils/executor.py), so fanned-out
# IO stays tagged like the armed fault_injection state it rides next to.

_tclass_var: contextvars.ContextVar[Optional["TrafficClass"]] = \
    contextvars.ContextVar("tpu3fs_qos_tclass", default=None)


def current_class(default: Optional[TrafficClass] = None):
    """The calling context's traffic class, or `default` when untagged."""
    tc = _tclass_var.get()
    # explicit None test: TrafficClass.FG_READ is 0 and must not fall
    # through to the default like an untagged thread would
    return default if tc is None else tc


@contextlib.contextmanager
def tagged(tclass: TrafficClass):
    """Tag the calling context's traffic for the duration of the block."""
    token = _tclass_var.set(tclass)
    try:
        yield
    finally:
        _tclass_var.reset(token)


# -- envelope flag carriage (MessagePacket.flags bits 8-11) ------------------
# value 0 = untagged (legacy peers); tagged frames carry tclass + 1.

TC_FLAG_SHIFT = 8
TC_FLAG_MASK = 0xF << TC_FLAG_SHIFT


def class_to_flags(tclass: Optional[TrafficClass]) -> int:
    if tclass is None:
        return 0
    return (int(tclass) + 1) << TC_FLAG_SHIFT


def class_from_flags(flags: int) -> Optional[TrafficClass]:
    v = (flags & TC_FLAG_MASK) >> TC_FLAG_SHIFT
    if v == 0:
        return None
    try:
        return TrafficClass(v - 1)
    except ValueError:
        return None  # newer peer with classes we don't know: untagged


#: explicit per-method classes consulted BEFORE the name heuristics:
#: the serving fleet's peer-fill RPCs are KVCACHE traffic whatever their
#: names suggest ("peerRead" must not admission-key as FG_READ — it
#: competes in the kvcache share, like the storage reads it replaces),
#: and its control surface is CONTROL ("servingStats" contains "stat").
#: check_rpc_registry resolves every bound method through here.
METHOD_CLASS_OVERRIDES: Dict[str, TrafficClass] = {
    "peerRead": TrafficClass.KVCACHE,
    "fillClaim": TrafficClass.KVCACHE,
    "fillRelease": TrafficClass.KVCACHE,
    "servingStats": TrafficClass.CONTROL,
    "servingLoad": TrafficClass.KVCACHE,
    "servingRegister": TrafficClass.CONTROL,
    "servingUnregister": TrafficClass.CONTROL,
}


def default_class_for(method_name: str) -> TrafficClass:
    """Fallback classification for untagged RPCs by method name."""
    override = METHOD_CLASS_OVERRIDES.get(method_name)
    if override is not None:
        return override
    name = method_name.lower()
    if "read" in name or "query" in name or "stat" in name:
        return TrafficClass.FG_READ
    if "write" in name or "update" in name or "truncate" in name \
            or "remove" in name:
        return TrafficClass.FG_WRITE
    return TrafficClass.CONTROL


def infer_write_class(req) -> TrafficClass:
    """Classify an untagged WriteReq by shape (transport-independent):
    recovery full-replaces are RESYNC, migration writes carry their job's
    client id, everything else is foreground."""
    if getattr(req, "full_replace", False) and getattr(req, "from_target", 0):
        return TrafficClass.RESYNC
    if str(getattr(req, "client_id", "")).startswith("migration-"):
        return TrafficClass.MIGRATION
    return TrafficClass.FG_WRITE


# -- retry-after hint encoding ----------------------------------------------

_HINT_PREFIX = "retry_after_ms="


def format_retry_after(ms: int, detail: str = "") -> str:
    base = f"{_HINT_PREFIX}{max(1, int(ms))}"
    return f"{base} ({detail})" if detail else base


def retry_after_ms_of(message: str) -> int:
    """Parse a retry-after hint out of an envelope message; 0 = absent."""
    if not message:
        return 0
    i = message.find(_HINT_PREFIX)
    if i < 0:
        return 0
    j = i + len(_HINT_PREFIX)
    end = j
    while end < len(message) and message[end].isdigit():
        end += 1
    try:
        return int(message[j:end])
    except ValueError:
        return 0


# -- primitives --------------------------------------------------------------


class TokenBucket:
    """Thread-safe token bucket. rate <= 0 means unlimited.

    ``try_acquire`` either takes the tokens (returns 0.0) or returns the
    seconds until `cost` tokens will be available — the server's
    retry-after hint, so clients back off for exactly as long as the
    bucket needs instead of guessing exponentially.
    """

    def __init__(self, rate: float, burst: float):
        self._lock = threading.Lock()
        self._rate = float(rate)
        self._burst = max(1.0, float(burst))
        self._tokens = self._burst
        self._last = time.monotonic()

    def configure(self, rate: float, burst: float) -> None:
        with self._lock:
            self._refill_locked()
            self._rate = float(rate)
            self._burst = max(1.0, float(burst))
            self._tokens = min(self._tokens, self._burst)

    def _refill_locked(self) -> None:
        now = time.monotonic()
        if self._rate > 0:
            self._tokens = min(
                self._burst, self._tokens + (now - self._last) * self._rate)
        self._last = now

    def try_acquire(self, cost: float = 1.0) -> float:
        """-> 0.0 when admitted, else seconds until `cost` tokens exist."""
        if self._rate <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            if self._tokens >= cost:
                self._tokens -= cost
                return 0.0
            return (cost - self._tokens) / self._rate

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def burst(self) -> float:
        return self._burst


class ConcurrencyGate:
    """Counted in-flight cap. cap <= 0 means unlimited (still counts)."""

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self._cap = int(cap)
        self._inflight = 0

    def configure(self, cap: int) -> None:
        with self._lock:
            self._cap = int(cap)

    def try_enter(self) -> bool:
        if self._cap <= 0:
            # unlimited: uncounted fast path (no lock on the hot path; a
            # cap hot-updated mid-flight only makes the inflight gauge
            # momentarily conservative — leave() floors at zero)
            return True
        with self._lock:
            if self._inflight >= self._cap:
                return False
            self._inflight += 1
            return True

    def leave(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def cap(self) -> int:
        return self._cap


# -- declarative config ------------------------------------------------------


def _limits(rate: float, burst: float, max_inflight: int, weight: int,
            queue_share: float) -> type:
    """A per-class limits section with these defaults. rate/max_inflight
    of 0 = unlimited; weight drives the WFQ scheduler; queue_share bounds
    the fraction of an update queue one class may occupy."""
    return type("ClassLimits", (Config,), {
        "rate": ConfigItem(float(rate), hot=True,
                           checker=lambda v: v >= 0,
                           doc="token refill rate, ops/s; 0 = unlimited"),
        "burst": ConfigItem(float(burst), hot=True,
                            checker=lambda v: v >= 1,
                            doc="token bucket depth"),
        "max_inflight": ConfigItem(int(max_inflight), hot=True,
                                   checker=lambda v: v >= 0,
                                   doc="concurrency cap; 0 = unlimited"),
        "weight": ConfigItem(int(weight), hot=True,
                             checker=lambda v: v >= 1,
                             doc="weighted-fair scheduler share"),
        "queue_share": ConfigItem(float(queue_share), hot=True,
                                  checker=lambda v: 0.0 < v <= 1.0,
                                  doc="max fraction of the update queue"),
    })


class QosConfig(Config):
    """The hot-updatable QoS limit tree, one per service binary.

    Defaults are deliberately permissive (no token limits, foreground
    unlimited in flight): out of the box only the ORDERING changes —
    foreground outweighs background 8:1 in the update scheduler and
    background classes may fill at most a share of each queue. Operators
    turn on real admission by setting rates/caps, live, via mgmtd config
    push (utils/config.py hot_update)."""

    enabled = ConfigItem(True, hot=True)
    # base hint handed to shed replies; actual hints may be larger when a
    # token bucket can predict its own refill horizon
    shed_retry_after_ms = ConfigItem(50, hot=True, checker=lambda v: v >= 1)
    # per-(service, method[, class]) token overrides, space-separated:
    #   "StorageSerde.write=200/400 Mgmtd.heartbeat:control=50/100"
    # (rate/burst; class omitted = every class). The (service, method,
    # traffic class) admission key of the tentpole spec.
    method_overrides = ConfigItem("", hot=True)
    # cheap native-transport ceiling (native/rpc_net.cpp dispatch): total
    # ops/s per service id before frames even reach Python; 0 = off
    native_ceiling_rate = ConfigItem(0.0, hot=True, checker=lambda v: v >= 0)
    native_ceiling_burst = ConfigItem(256.0, hot=True,
                                      checker=lambda v: v >= 1)
    # per-target update-queue bound (jobs), the depth the overload test
    # asserts stays bounded. HOT: a config push resizes live queues —
    # shrinking only caps new admits (queued work is never dropped; the
    # queue drains below the new cap, storage/craq.py _on_qos_config)
    update_queue_cap = ConfigItem(512, hot=True, checker=lambda v: v >= 1)

    fg_read = _limits(0.0, 256, 0, 8, 1.0)
    fg_write = _limits(0.0, 256, 0, 8, 1.0)
    control = _limits(0.0, 128, 0, 4, 1.0)
    resync = _limits(0.0, 64, 0, 2, 0.5)
    ec_rebuild = _limits(0.0, 64, 0, 2, 0.5)
    migration = _limits(0.0, 64, 0, 1, 0.25)
    gc = _limits(0.0, 64, 0, 1, 0.25)
    # checkpoint saves are bursty whole-model flushes: resync-weight (2)
    # so restores-under-pressure finish, but share-bounded like any
    # background class so a save flood cannot starve foreground IO
    ckpt = _limits(0.0, 64, 0, 2, 0.5)
    # the training data loader is on the step loop's critical path:
    # foreground weight (8) so batch fetches schedule with client IO, but
    # share-bounded (SHARE_BOUNDED_CLASSES) so a loader flood cannot fill
    # an update queue and starve foreground writes
    dataload = _limits(0.0, 128, 0, 8, 0.5)
    # the inference KV-cache tier serves decode-loop reads: foreground
    # weight (8) like dataload — a token can't be generated until its
    # prefix KV arrives — but share-bounded so a cache-fill/write-back
    # flood cannot fill an update queue and starve foreground writes
    kvcache = _limits(0.0, 128, 0, 8, 0.5)


# -- admission ---------------------------------------------------------------


class _Lease:
    """Admission lease: release() returns the concurrency slot (no-op when
    no gate was charged)."""

    __slots__ = ("_gate",)

    def __init__(self, gate: Optional[ConcurrencyGate]):
        self._gate = gate

    def release(self) -> None:
        if self._gate is not None:
            self._gate.leave()
            self._gate = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


_NOOP_LEASE = _Lease(None)


class AdmissionController:
    """Token-bucket + concurrency-cap admission keyed by (service, method,
    traffic class), with per-class fallback limits; enforced in RPC
    dispatch (rpc/net.py) and consulted by service-internal gates.

    Limits come from a ``QosConfig`` tree and follow hot updates live (a
    registered config callback reconfigures the buckets in place). Every
    decision feeds per-class admit/shed counters into the monitor
    pipeline.
    """

    def __init__(self, config: Optional[QosConfig] = None,
                 tags: Optional[Dict[str, str]] = None):
        from tpu3fs_torch.monitor.recorder import CounterRecorder

        self.config = config if config is not None else QosConfig()
        self._lock = threading.Lock()
        self._buckets: Dict[TrafficClass, TokenBucket] = {}
        self._gates: Dict[TrafficClass, ConcurrencyGate] = {}
        # (service, method, tclass|None) -> TokenBucket
        self._overrides: Dict[Tuple[str, str, Optional[TrafficClass]],
                              TokenBucket] = {}
        self._reload_hooks = []
        base_tags = dict(tags or {})
        self._admitted: Dict[TrafficClass, CounterRecorder] = {}
        self._shed: Dict[TrafficClass, CounterRecorder] = {}
        for tc, attr in CLASS_ATTRS.items():
            ctags = {**base_tags, "class": attr}
            self._admitted[tc] = CounterRecorder("qos.admitted", ctags)
            self._shed[tc] = CounterRecorder("qos.shed", ctags)
        self.reload()
        self.config.add_callback(lambda _node: self.reload())

    # -- config ----------------------------------------------------------
    def add_reload_hook(self, fn) -> None:
        """fn(self) invoked after every reload (native ceiling resync)."""
        self._reload_hooks.append(fn)

    def reload(self) -> None:
        """(Re)build limiter state from the config tree; existing bucket
        objects are reconfigured in place so in-flight references stay
        valid across hot updates."""
        with self._lock:
            for tc, attr in CLASS_ATTRS.items():
                sec = getattr(self.config, attr)
                b = self._buckets.get(tc)
                if b is None:
                    self._buckets[tc] = TokenBucket(sec.rate, sec.burst)
                else:
                    b.configure(sec.rate, sec.burst)
                g = self._gates.get(tc)
                if g is None:
                    self._gates[tc] = ConcurrencyGate(sec.max_inflight)
                else:
                    g.configure(sec.max_inflight)
            self._overrides = self._parse_overrides(
                self.config.method_overrides)
        for fn in list(self._reload_hooks):
            try:
                fn(self)
            except Exception:
                pass  # a native-resync failure must not fail a config push

    @staticmethod
    def _parse_overrides(spec: str):
        out: Dict[Tuple[str, str, Optional[TrafficClass]], TokenBucket] = {}
        by_attr = {attr: tc for tc, attr in CLASS_ATTRS.items()}
        for entry in (spec or "").split():
            try:
                key, rb = entry.split("=", 1)
                rate_s, _, burst_s = rb.partition("/")
                rate = float(rate_s)
                burst = float(burst_s) if burst_s else max(1.0, rate)
                name, _, cls = key.partition(":")
                service, method = name.split(".", 1)
                tclass = by_attr[cls] if cls else None
            except (ValueError, KeyError):
                continue  # malformed entry: skip, keep the rest live
            out[(service, method, tclass)] = TokenBucket(rate, burst)
        return out

    # -- decisions --------------------------------------------------------
    @staticmethod
    def _tenant_of(tenant: Optional[str]) -> str:
        if tenant:
            return tenant
        from tpu3fs_torch.tenant.identity import resolved_tenant

        return resolved_tenant()

    @staticmethod
    def _tenant_admit(tenant: str) -> None:
        from tpu3fs_torch.tenant.quota import registry

        registry().account_admit(tenant)

    @staticmethod
    def _tenant_shed(tenant: str) -> None:
        from tpu3fs_torch.tenant.quota import registry

        registry().account_shed(tenant)

    def try_admit(self, service: str, method: str,
                  tclass: Optional[TrafficClass], cost: float = 1.0,
                  *, tenant: Optional[str] = None):
        """-> (lease, None) when admitted, (None, retry_after_ms) when
        shed. Callers MUST release the lease when the op finishes.

        Every decision is ALSO attributed to the op's tenant (explicit
        arg, else the ambient tenant scope) on the ``tenant.admitted`` /
        ``tenant.shed`` recorders — the per-tenant accounting that lets
        the monitor answer "who is hurting whom" even before any quota
        is configured (tpu3fs/tenant)."""
        if tclass is None:
            tclass = default_class_for(method)
        tname = self._tenant_of(tenant)
        if not self.config.enabled:
            self._admitted[tclass].add()
            self._tenant_admit(tname)
            return _NOOP_LEASE, None
        base_ms = int(self.config.shed_retry_after_ms)
        bucket = (self._overrides.get((service, method, tclass))
                  or self._overrides.get((service, method, None))
                  or self._buckets[tclass])
        wait_s = bucket.try_acquire(cost)
        if wait_s > 0.0:
            self._shed[tclass].add()
            self._tenant_shed(tname)
            return None, max(base_ms, int(wait_s * 1000) + 1)
        gate = self._gates[tclass]
        if gate.cap <= 0:
            # unlimited concurrency: skip the counted lease entirely (the
            # hot-path cost of admission must stay a couple of lock-free
            # checks + one counter for fully-open classes)
            self._admitted[tclass].add()
            self._tenant_admit(tname)
            return _NOOP_LEASE, None
        if not gate.try_enter():
            self._shed[tclass].add()
            self._tenant_shed(tname)
            return None, base_ms
        self._admitted[tclass].add()
        self._tenant_admit(tname)
        return _Lease(gate), None

    def snapshot(self) -> Dict[str, dict]:
        """Per-class live state for the admin CLI qos view."""
        out: Dict[str, dict] = {}
        with self._lock:
            for tc, attr in CLASS_ATTRS.items():
                b = self._buckets[tc]
                g = self._gates[tc]
                out[attr] = {
                    "rate": b.rate,
                    "burst": b.burst,
                    "max_inflight": g.cap,
                    "inflight": g.inflight,
                    "weight": getattr(self.config, attr).weight,
                    "queue_share": getattr(self.config, attr).queue_share,
                }
        return out
