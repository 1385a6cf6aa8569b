"""Fault injection: request-scoped contexts + the hot-configurable

The port's own copy of ``tpu3fs/utils/fault_injection.py``,
unchanged but for its imports.

cluster fault plane.

Two layers share one set of injection points (``inject("point")`` calls
sprinkled through the storage/rpc stack):

1. REQUEST-SCOPED contexts (ref src/common/utils/FaultInjection.h:15-29):
   ``with fault_injection(prob, times):`` arms injection for the current
   context; ``inject("point")`` raises FsError(FAULT_INJECTION) with
   probability ``prob`` for at most ``times`` firings. Deterministic when
   constructed with ``seed=`` (chaos drives and tests reproduce runs).

2. THE CLUSTER FAULT PLANE: a process-global rule table configured from a
   ``FaultPlaneConfig`` spec string that rides the EXISTING mgmtd config
   push (``[faults] spec=...`` hot-updates every service binary live, no
   restart — ``admin_cli fault`` is the operator surface). Rules fire at
   the transports' send/dispatch boundaries and at the storage engine
   points, and support three kinds:

   - ``error``: raise FsError(FAULT_INJECTION) (a flaky peer);
   - ``delay_ms``: sleep ``arg`` milliseconds (a gray straggler);
   - ``drop``: raise ConnectionError (the transport tears the
     connection down, like a half-dead NIC).

   Spec grammar — entries separated by ``;``, fields by ``,``::

       point=storage.read,kind=delay_ms,arg=100,prob=1.0,node=11;
       point=rpc.dispatch,kind=error,prob=0.05,times=50

   ``point`` is a PREFIX match on the fired point name; ``node`` (0 =
   any) scopes a rule to one node id so a single type-wide config push
   can make exactly one replica sick. All randomness comes from ONE
   ``random.Random(seed)`` so a chaos run replays bit-identically.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.utils.result import Code, FsError, Status


@dataclass
class _Injection:
    prob: float
    times: int
    only_points: Optional[List[str]] = None
    fired: int = field(default=0)
    # explicit RNG so chaos drives/tests are reproducible (seeded) while
    # legacy callers keep the old unseeded behavior (fresh Random())
    rng: random.Random = field(default_factory=random.Random)

    def should_fire(self, point: str) -> bool:
        if self.times >= 0 and self.fired >= self.times:
            return False
        if self.only_points is not None and point not in self.only_points:
            return False
        if self.rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


_current: contextvars.ContextVar[Optional[_Injection]] = contextvars.ContextVar(
    "tpu3fs_fault_injection", default=None
)


@contextlib.contextmanager
def fault_injection(prob: float, times: int = -1,
                    only_points: Optional[List[str]] = None,
                    seed: Optional[int] = None):
    """Arm fault injection in this context. times<0 means unlimited;
    seed!=None makes the firing sequence reproducible."""
    rng = random.Random(seed) if seed is not None else random.Random()
    token = _current.set(_Injection(prob, times, only_points, rng=rng))
    try:
        yield
    finally:
        _current.reset(token)


def current_injection() -> Optional[_Injection]:
    return _current.get()


# -- the cluster fault plane --------------------------------------------------


@dataclass
class FaultRule:
    point: str                 # prefix match on the fired point name
    kind: str = "error"        # error | delay_ms | drop
    arg: float = 0.0           # delay_ms: milliseconds to sleep
    prob: float = 1.0
    times: int = -1            # max firings; <0 = unlimited
    node: int = 0              # 0 = any node; else only that node id
    fired: int = 0

    _KINDS = ("error", "delay_ms", "drop")


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a fault-plane spec string; malformed entries raise ValueError
    (a config push must reject bad specs atomically, ConfigBase rules)."""
    rules: List[FaultRule] = []
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields = {}
        for part in entry.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"fault spec field without '=': {part!r}")
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
        if "point" not in fields:
            raise ValueError(f"fault spec entry without point=: {entry!r}")
        kind = fields.get("kind", "error")
        if kind not in FaultRule._KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(want one of {FaultRule._KINDS})")
        try:
            rule = FaultRule(
                point=fields["point"],
                kind=kind,
                arg=float(fields.get("arg", 0.0)),
                prob=float(fields.get("prob", 1.0)),
                times=int(fields.get("times", -1)),
                node=int(fields.get("node", 0)),
            )
        except ValueError as e:
            raise ValueError(f"fault spec entry {entry!r}: {e}")
        if not 0.0 <= rule.prob <= 1.0:
            raise ValueError(f"fault prob out of range: {rule.prob}")
        rules.append(rule)
    return rules


def _check_spec(spec: str) -> bool:
    """ConfigItem checker: parseable spec (or empty)."""
    try:
        parse_spec(spec)
        return True
    except ValueError:
        return False


class FaultPlaneConfig(Config):
    """The hot-updatable fault-plane section every service binary carries
    (``[faults]`` in the pushed TOML). An empty spec = no faults."""

    spec = ConfigItem("", hot=True, checker=_check_spec,
                      doc="semicolon-separated fault rules; see "
                          "docs/robustness.md")
    seed = ConfigItem(0, hot=True,
                      doc="RNG seed for probabilistic rules (reproducible "
                          "chaos)")


class FaultPlane:
    """Process-global fault rule table. ``fire(point, node=...)`` is the
    one hook the transports and engine points call — a couple of loads
    when no rules are configured."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self._rng = random.Random(0)
        self._fired_total = 0
        # lazy per-(kind, rule point) faults.fired counters — tagged by
        # the RULE's point prefix (bounded cardinality: one per
        # configured rule), so a soak can assert its schedule actually
        # fired instead of a typo'd spec injecting nothing, silently
        self._recs: dict = {}

    def configure(self, spec: str, seed: int = 0) -> None:
        """Install a new rule set (atomic: a bad spec raises and leaves
        the previous rules live). Reconfiguring resets firing counts and
        reseeds the RNG so a replayed run fires identically."""
        rules = parse_spec(spec)
        with self._lock:
            self._rules = rules
            self._rng = random.Random(seed)

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(point=r.point, kind=r.kind, arg=r.arg,
                         prob=r.prob, times=r.times, node=r.node,
                         fired=r.fired)
                    for r in self._rules]

    @property
    def fired_total(self) -> int:
        return self._fired_total

    def fire(self, point: str, node: int = 0) -> None:
        """Evaluate the rules for one injection point. May sleep (delay),
        raise FsError(FAULT_INJECTION) (error) or raise ConnectionError
        (drop — the transports' connection-error handling tears the
        stream down)."""
        if not self._rules:
            return
        delay_ms = 0.0
        boom: Optional[BaseException] = None
        with self._lock:
            for r in self._rules:
                if not point.startswith(r.point):
                    continue
                if r.node and node and r.node != node:
                    continue
                if r.node and not node:
                    continue  # node-scoped rule, unscoped fire point
                if r.times >= 0 and r.fired >= r.times:
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                self._fired_total += 1
                self._count_fired(r)
                if r.kind == "delay_ms":
                    delay_ms += r.arg
                elif r.kind == "drop":
                    boom = ConnectionError(
                        f"fault plane drop at {point}")
                else:
                    boom = FsError(Status(
                        Code.FAULT_INJECTION,
                        f"fault plane injected at {point}"))
                if boom is not None:
                    break
        if delay_ms > 0:
            time.sleep(delay_ms / 1000.0)
        if boom is not None:
            raise boom

    def _count_fired(self, rule: FaultRule) -> None:
        rec = self._recs.get((rule.kind, rule.point))
        if rec is None:
            from tpu3fs_torch.monitor.recorder import CounterRecorder

            rec = CounterRecorder("faults.fired",
                                  tags={"kind": rule.kind,
                                        "point": rule.point})
            self._recs[(rule.kind, rule.point)] = rec
        rec.add()


_PLANE = FaultPlane()


def plane() -> FaultPlane:
    return _PLANE


def apply_plane_config(cfg: FaultPlaneConfig,
                       target: Optional[FaultPlane] = None) -> None:
    """Bind a FaultPlaneConfig section to a plane and follow its hot
    updates (the service binaries call this once at boot)."""
    pl = target if target is not None else _PLANE

    def _apply(_node=None):
        try:
            pl.configure(cfg.spec, int(cfg.seed))
        except ValueError:
            pass  # checker already rejected; belt and braces

    _apply()
    cfg.add_callback(_apply)


# -- the shared injection hook ------------------------------------------------

def inject(point: str, node: int = 0) -> None:
    """Raise FsError(FAULT_INJECTION) if an armed request-scoped injection
    fires for point, then evaluate the cluster fault plane (which may
    also sleep or drop). ``node`` scopes plane rules to one node id."""
    inj = _current.get()
    if inj is not None and inj.should_fire(point):
        raise FsError(Status(Code.FAULT_INJECTION, f"injected at {point}"))
    _PLANE.fire(point, node)


def inject_result(point: str, node: int = 0) -> Optional[Status]:
    """Non-raising form: returns an error Status when an injection fires
    (plane delays still sleep in place; drops surface as a Status too)."""
    inj = _current.get()
    if inj is not None and inj.should_fire(point):
        return Status(Code.FAULT_INJECTION, f"injected at {point}")
    try:
        _PLANE.fire(point, node)
    except FsError as e:
        return e.status
    except ConnectionError as e:
        return Status(Code.FAULT_INJECTION, str(e))
    return None
