"""Cluster SLO engine: hot-configurable rules over windowed aggregates,
multi-window burn-rate alerting, and the ``SloGate`` hard-gate helper.

The port's own copy of ``tpu3fs/monitor/slo.py``, unchanged but for its
imports.

The collector's ``WindowedAggregator`` (monitor/agg.py) makes every
metric queryable as rate/last/min/max/p50/p90/p99 over any window; this
module JUDGES those aggregates. Rules arrive as ONE spec string riding
the same config machinery as ``[qos]``/``[tenants]``/``[faults]`` —
``[slo] spec=...`` hot-updates the engine live (for the collector
binary, which boots one-phase, ``admin_cli slo set`` pushes the section
through the core ``hotUpdateConfig`` RPC).

Spec grammar — entries separated by ``;``, fields by ``,``::

    rule=read_p99,metric=storage.read.latency_us,agg=p99,max=50000,
        fast_s=10,slow_s=60,severity=degraded;
    rule=shed_rate,metric=qos.shed,agg=rate,max=25;
    rule=rss_ceiling,metric=memory.rss_kb,agg=last,max=4194304;
    rule=node_alive,metric=memory.rss_kb,absent_s=45

- ``agg``: which aggregate to bound — ``p50|p90|p99`` (digest
  quantiles), ``rate`` (value sum / window), ``last`` (gauge), ``sum``,
  ``count``, ``min``, ``max``, ``mean``;
- ``max=`` / ``min=``: the bound (at least one, unless ``absent_s``);
- ``absent_s=N``: an ABSENCE rule — breaches when no matching series
  has reported for N seconds (grace-armed: a freshly configured rule
  waits N seconds before it may fire, so boot doesn't flap);
- tag filters (``class= node= tenant= service= kind= chain= target=``)
  restrict the rule to matching series; each matching series is judged
  separately, so the breach NAMES the offending node/class/tenant;
- MULTI-WINDOW BURN RATE: ``fast_s`` (default 15) is the firing window,
  ``slow_s`` (default 60) the resolve window. The state machine::

      ok --breach(fast)--> pending --persists for_s--> firing
      firing --clean(fast) AND clean(slow)--> ok (resolved)

  A momentary recovery inside a dirty slow window keeps the alert
  FIRING (flap suppression); ``for_s`` (default 0) delays firing until
  the fast-window breach has persisted.
- ``severity=degraded|critical`` (default degraded) sets how a firing
  rule colors the single cluster verdict: OK / DEGRADED / CRITICAL.

Every transition is itself a sample (``slo.alert_pending`` /
``slo.alert_firing`` / ``slo.alert_resolved`` counters tagged
``kind=<rule>``), so alert history lands in the same store the rules
read — and the flight recorder's ring (monitor/flight.py) keeps the
recent transitions for postmortems.

``SloGate`` is the reusable hard gate: drive scripts and benches point
it at a live collector and ``assert_ok()`` raises with the firing rules
when the cluster is not clean — ad-hoc p99 math in every script
replaced by the rules the operators already watch.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.monitor.agg import AggRow, WindowedAggregator
from tpu3fs_torch.monitor.recorder import (
    CounterRecorder,
    DistributionRecorder,
    ValueRecorder,
)
from tpu3fs_torch.utils.config import Config, ConfigItem

_RULE_RE = re.compile(r"^[a-z0-9_-]{1,64}$")
_METRIC_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_AGGS = ("p50", "p90", "p99", "rate", "last", "sum", "count", "min",
         "max", "mean")
_SEVERITIES = ("degraded", "critical")
_TAG_KEYS = ("service", "class", "tenant", "chain", "node", "kind",
             "target")

#: the shipped default rule set (the drive script and the production-day
#: soak start from these; tools/check_recorder_registry.py statically
#: verifies every metric name herein exists in the recorder registry)
DEFAULT_CLUSTER_SPEC = (
    "rule=read_p99,metric=storage.read.latency_us,agg=p99,max=50000,"
    "fast_s=10,slow_s=30;"
    "rule=write_p99,metric=storage.write.latency_us,agg=p99,max=200000,"
    "fast_s=10,slow_s=30;"
    "rule=shed_rate,metric=qos.shed,agg=rate,max=50,fast_s=10,slow_s=30;"
    "rule=push_loss,metric=monitor.push_dropped,agg=rate,max=1,"
    "fast_s=30,slow_s=60;"
    "rule=node_alive,metric=memory.rss_kb,absent_s=90"
)


@dataclass
class SloRule:
    name: str
    metric: str = ""
    agg: str = "p99"
    max_bound: Optional[float] = None
    min_bound: Optional[float] = None
    absent_s: float = 0.0
    fast_s: float = 15.0
    slow_s: float = 60.0
    for_s: float = 0.0
    severity: str = "degraded"
    tags: Dict[str, str] = field(default_factory=dict)

    def describe(self) -> str:
        if self.absent_s > 0:
            cond = f"absent>{self.absent_s:g}s"
        else:
            parts = []
            if self.max_bound is not None:
                parts.append(f"{self.agg}<={self.max_bound:g}")
            if self.min_bound is not None:
                parts.append(f"{self.agg}>={self.min_bound:g}")
            cond = " and ".join(parts)
        tags = "".join(f",{k}={v}" for k, v in sorted(self.tags.items()))
        return f"{self.metric}{tags} {cond}"


def parse_slo_spec(spec: str) -> Dict[str, SloRule]:
    """Parse an ``[slo] spec=`` string; malformed entries raise
    ValueError (a config push must reject bad specs atomically)."""
    out: Dict[str, SloRule] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields: Dict[str, str] = {}
        for part in entry.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"slo spec field without '=': {part!r}")
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
        name = fields.pop("rule", "")
        if not _RULE_RE.match(name):
            raise ValueError(f"slo spec entry with bad rule=: {entry!r}")
        if name in out:
            raise ValueError(f"slo rule {name!r} listed twice")
        metric = fields.pop("metric", "")
        if not _METRIC_RE.match(metric):
            raise ValueError(
                f"slo rule {name!r}: bad metric name {metric!r}")
        tags = {k: fields.pop(k) for k in list(fields)
                if k in _TAG_KEYS}
        try:
            rule = SloRule(
                name=name, metric=metric,
                agg=fields.pop("agg", "p99"),
                max_bound=(float(fields.pop("max"))
                           if "max" in fields else None),
                min_bound=(float(fields.pop("min"))
                           if "min" in fields else None),
                absent_s=float(fields.pop("absent_s", 0.0)),
                fast_s=float(fields.pop("fast_s", 15.0)),
                slow_s=float(fields.pop("slow_s", 60.0)),
                for_s=float(fields.pop("for_s", 0.0)),
                severity=fields.pop("severity", "degraded"),
                tags=tags,
            )
        except ValueError as e:
            raise ValueError(f"slo rule {name!r}: {e}")
        if fields:
            raise ValueError(
                f"slo rule {name!r}: unknown fields {sorted(fields)}")
        if rule.agg not in _AGGS:
            raise ValueError(
                f"slo rule {name!r}: agg must be one of {_AGGS}")
        if rule.severity not in _SEVERITIES:
            raise ValueError(
                f"slo rule {name!r}: severity must be one of "
                f"{_SEVERITIES}")
        if rule.absent_s < 0 or rule.fast_s <= 0 or rule.for_s < 0:
            raise ValueError(f"slo rule {name!r}: out of range")
        if rule.slow_s < rule.fast_s:
            raise ValueError(
                f"slo rule {name!r}: slow_s < fast_s (the resolve "
                "window must contain the firing window)")
        if rule.absent_s == 0 and rule.max_bound is None \
                and rule.min_bound is None:
            raise ValueError(
                f"slo rule {name!r}: needs max=, min= or absent_s=")
        out[name] = rule
    return out


def _check_spec(spec: str) -> bool:
    try:
        parse_slo_spec(spec)
        return True
    except ValueError:
        return False


class SloConfig(Config):
    """The hot-updatable ``[slo]`` section the collector binary carries
    (monitor_main). Empty spec = no rules, verdict always OK."""

    enabled = ConfigItem(True, hot=True)
    spec = ConfigItem("", hot=True, checker=_check_spec,
                      doc="semicolon-separated SLO rules; see docs/slo.md")
    eval_period_s = ConfigItem(2.0, hot=True, checker=lambda v: v > 0)


# verdict ladder (the single cluster verdict slo.health reports)
VERDICTS = ("OK", "DEGRADED", "CRITICAL")


@dataclass
class RuleState:
    """One rule's live state (the sloStatus wire row)."""

    rule: str = ""
    severity: str = "degraded"
    state: str = "ok"          # ok | pending | firing
    since: float = 0.0         # when the current state was entered
    value: float = 0.0         # worst observed aggregate, last eval
    bound: str = ""            # human condition (rule.describe())
    message: str = ""          # offender detail (tags of the worst series)
    fired_count: int = 0


@dataclass
class TransitionRow:
    ts: float = 0.0
    rule: str = ""
    transition: str = ""       # pending | firing | resolved | cleared
    value: float = 0.0
    message: str = ""


class SloEngine:
    """Continuous rule evaluation over a WindowedAggregator."""

    def __init__(self, agg: WindowedAggregator, *,
                 now_fn: Callable[[], float] = time.time):
        self._agg = agg
        self._now = now_fn
        self._lock = threading.Lock()
        self._rules: Dict[str, SloRule] = {}
        self._states: Dict[str, RuleState] = {}
        self._armed: Dict[str, float] = {}   # rule -> configure ts
        self.transitions: collections.deque = collections.deque(
            maxlen=256)
        self._on_firing: List[Callable[[RuleState], None]] = []
        # single declaration site per alert-state sample name; per-rule
        # instances tag kind=<rule> (the fixed tag vocabulary)
        self._recs: Dict[Tuple[str, str], CounterRecorder] = {}
        self._rules_firing = ValueRecorder("slo.rules_firing")
        self._health = ValueRecorder("slo.health")
        self._eval_ms = DistributionRecorder("slo.eval_ms")

    # -- config --------------------------------------------------------------
    def configure(self, spec: str) -> None:
        """Install a rule set; same-named rules keep their alert state
        (a threshold retune must not silently resolve a live alert)."""
        rules = parse_slo_spec(spec)
        now = self._now()
        with self._lock:
            self._rules = rules
            for name in list(self._states):
                if name not in rules:
                    del self._states[name]
            for name, rule in rules.items():
                self._armed.setdefault(name, now)
                st = self._states.get(name)
                if st is None:
                    self._states[name] = RuleState(
                        rule=name, severity=rule.severity, since=now,
                        bound=rule.describe())
                else:
                    st.severity = rule.severity
                    st.bound = rule.describe()
            for name in list(self._armed):
                if name not in rules:
                    del self._armed[name]

    def add_firing_callback(self, fn: Callable[[RuleState], None]) -> None:
        """Called (outside the lock) on every transition INTO firing —
        the flight-recorder dump trigger."""
        self._on_firing.append(fn)

    @property
    def rules(self) -> Dict[str, SloRule]:
        with self._lock:
            return dict(self._rules)

    # -- evaluation ----------------------------------------------------------
    def _observe(self, rule: SloRule, window_s: float,
                 now: float) -> Tuple[bool, float, str]:
        """-> (breach, worst value, offender message) for one window."""
        rows = self._agg.query(rule.metric, rule.tags, window_s,
                               until=now)
        if rule.absent_s > 0:
            newest = max((r.last_ts for r in rows), default=0.0)
            armed = self._armed.get(rule.name, now)
            # grace: a freshly armed rule may not fire until absent_s
            # has elapsed since arming (boot must not flap)
            ref = max(newest, armed)
            silent = now - ref
            return silent >= rule.absent_s, silent, (
                "no matching series has ever reported" if newest == 0.0
                else f"last sample {silent:.1f}s ago")
        breach = False
        worst = 0.0
        msg = ""
        for row in rows:
            if row.count == 0:
                continue  # no data in the window: not a violation
            value = self._value_of(rule, row)
            hi = rule.max_bound is not None and value > rule.max_bound
            lo = rule.min_bound is not None and value < rule.min_bound
            if hi or lo:
                if not breach or (hi and value > worst) \
                        or (lo and value < worst):
                    worst = value
                    tags = ",".join(f"{k}={v}" for k, v in
                                    sorted(row.tags.items()))
                    msg = (f"{rule.agg}={value:g} "
                           f"{'>' if hi else '<'} "
                           f"{rule.max_bound if hi else rule.min_bound:g}"
                           + (f" [{tags}]" if tags else ""))
                breach = True
            elif not breach:
                # report the worst non-breaching value for visibility
                if rule.max_bound is not None:
                    worst = max(worst, value)
                else:
                    worst = min(worst, value) if msg else value
                    msg = " "
        return breach, worst, msg.strip()

    @staticmethod
    def _value_of(rule: SloRule, row: AggRow) -> float:
        agg = rule.agg
        if agg == "rate":
            return row.rate
        if agg == "last":
            return row.last
        if agg == "sum":
            return row.vsum
        if agg == "count":
            return float(row.count)
        if agg == "min":
            return row.vmin
        if agg == "max":
            return row.vmax
        if agg == "mean":
            return row.vsum / row.count if row.count else 0.0
        return getattr(row, agg)  # p50 | p90 | p99

    def evaluate(self, now: Optional[float] = None) -> Dict[str, RuleState]:
        """One evaluation pass over every rule; returns the state map."""
        t0 = time.perf_counter()
        now = self._now() if now is None else now
        fired: List[RuleState] = []
        with self._lock:
            for name, rule in self._rules.items():
                st = self._states[name]
                breach_f, value, msg = self._observe(rule, rule.fast_s,
                                                     now)
                st.value = value
                if msg:
                    st.message = msg
                if st.state == "ok":
                    if breach_f:
                        self._transition(st, "pending", now, value, msg)
                        if rule.for_s <= 0:
                            self._transition(st, "firing", now, value,
                                             msg)
                            fired.append(st)
                elif st.state == "pending":
                    if not breach_f:
                        self._transition(st, "cleared", now, value, msg,
                                         to_state="ok")
                    elif now - st.since >= rule.for_s:
                        self._transition(st, "firing", now, value, msg)
                        fired.append(st)
                elif st.state == "firing":
                    breach_s, _, _ = self._observe(rule, rule.slow_s,
                                                   now)
                    # FLAP SUPPRESSION: resolving needs BOTH windows
                    # clean — a dirty slow window keeps the alert firing
                    # through momentary recoveries
                    if not breach_f and not breach_s:
                        self._transition(st, "resolved", now, value,
                                         msg, to_state="ok")
            firing = [s for s in self._states.values()
                      if s.state == "firing"]
            self._rules_firing.set(float(len(firing)))
            self._health.set(float(VERDICTS.index(self._verdict_locked())))
            states = {n: RuleState(**vars(s))
                      for n, s in self._states.items()}
        self._eval_ms.record((time.perf_counter() - t0) * 1e3)
        for st in fired:
            for fn in self._on_firing:
                try:
                    fn(st)
                except Exception:
                    pass  # a dump hook must never stop evaluation
        return states

    def _transition(self, st: RuleState, kind: str, now: float,
                    value: float, msg: str, *,
                    to_state: Optional[str] = None) -> None:
        st.state = to_state if to_state is not None else kind
        st.since = now
        if kind == "firing":
            st.fired_count += 1
        row = TransitionRow(ts=now, rule=st.rule, transition=kind,
                            value=value, message=msg)
        self.transitions.append(row)
        if kind in ("pending", "firing", "resolved"):
            self._rec(st.rule, kind).add()
        try:
            from tpu3fs_torch.monitor.flight import flight

            flight().record("alert", ts=now, rule=st.rule,
                            transition=kind, value=value, message=msg)
        except Exception:
            pass

    def _rec(self, rule: str, kind: str) -> CounterRecorder:
        rec = self._recs.get((rule, kind))
        if rec is None:
            tags = {"kind": rule}
            if kind == "pending":
                rec = CounterRecorder("slo.alert_pending", tags)
            elif kind == "firing":
                rec = CounterRecorder("slo.alert_firing", tags)
            else:
                rec = CounterRecorder("slo.alert_resolved", tags)
            self._recs[(rule, kind)] = rec
        return rec

    # -- verdict -------------------------------------------------------------
    def _verdict_locked(self) -> str:
        worst = 0
        for st in self._states.values():
            if st.state != "firing":
                continue
            worst = max(worst,
                        2 if st.severity == "critical" else 1)
        return VERDICTS[worst]

    def health(self) -> Tuple[str, List[RuleState]]:
        """-> (verdict, firing rule states)."""
        with self._lock:
            firing = [RuleState(**vars(s))
                      for s in self._states.values()
                      if s.state == "firing"]
            return self._verdict_locked(), firing

    def snapshot(self) -> Dict[str, RuleState]:
        with self._lock:
            return {n: RuleState(**vars(s))
                    for n, s in self._states.items()}


def apply_slo_config(cfg: SloConfig, engine: SloEngine) -> None:
    """Bind an [slo] config section to an engine and follow hot pushes
    (monitor_main calls this once at boot)."""
    def _apply(_node=None):
        try:
            engine.configure(cfg.spec if cfg.enabled else "")
        except ValueError:
            pass  # checker already rejected; belt and braces

    _apply()
    cfg.add_callback(_apply)


# -- the hard gate -----------------------------------------------------------


class SloGateError(AssertionError):
    """Raised by SloGate.assert_ok with the firing rules in the text."""


class SloGate:
    """Reusable SLO gate for drive scripts and benches: point it at a
    live collector and assert cluster health as a hard pass/fail —
    every script judging the cluster through the SAME rules the
    operators watch, instead of ad-hoc p99 math.

        gate = SloGate("127.0.0.1:9123")
        gate.assert_ok()                       # all rules
        gate.assert_ok(rules=["read_p99"])     # a subset
        gate.wait_verdict("DEGRADED", timeout=15)
    """

    def __init__(self, collector, client=None):
        from tpu3fs_torch.rpc.net import RpcClient

        if isinstance(collector, str):
            host, _, port = collector.rpartition(":")
            collector = (host or "127.0.0.1", int(port))
        self._addr = tuple(collector)
        self._client = client or RpcClient()

    def status(self, *, evaluate: bool = True):
        from tpu3fs_torch.monitor.collector import (
            COLLECTOR_SERVICE_ID,
            SloStatusReq,
            SloStatusRsp,
        )

        return self._client.call(
            self._addr, COLLECTOR_SERVICE_ID, 4,
            SloStatusReq(evaluate=evaluate), SloStatusRsp)

    def check(self, rules: Optional[List[str]] = None) -> Tuple[bool, str]:
        """-> (ok, detail). ok iff no selected rule is pending/firing."""
        rsp = self.status()
        bad = [r for r in rsp.rules
               if r.state != "ok" and (rules is None or r.rule in rules)]
        if not bad:
            return True, f"verdict {rsp.verdict}: all rules ok"
        detail = "; ".join(
            f"{r.rule} {r.state} ({r.bound}; observed {r.value:g}"
            + (f"; {r.message}" if r.message else "") + ")"
            for r in bad)
        return False, f"verdict {rsp.verdict}: {detail}"

    def assert_ok(self, rules: Optional[List[str]] = None) -> str:
        ok, detail = self.check(rules)
        if not ok:
            raise SloGateError(f"SLO gate failed: {detail}")
        return detail

    def wait_verdict(self, want: str, *, timeout: float = 30.0,
                     poll_s: float = 0.5):
        """Block until the cluster verdict reaches ``want`` (exact
        match); returns the status reply. Raises SloGateError on
        timeout with the last status in the text."""
        deadline = time.time() + timeout
        rsp = None
        while time.time() < deadline:
            rsp = self.status()
            if rsp.verdict == want:
                return rsp
            time.sleep(poll_s)
        got = rsp.verdict if rsp is not None else "(no reply)"
        firing = ", ".join(r.rule for r in rsp.rules
                           if r.state == "firing") if rsp else ""
        raise SloGateError(
            f"verdict never reached {want} within {timeout:.0f}s "
            f"(last {got}; firing: {firing or 'none'})")
