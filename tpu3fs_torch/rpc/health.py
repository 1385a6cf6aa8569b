"""Per-peer health scoring + circuit breakers for the RPC messengers.

The port's own copy of ``tpu3fs/rpc/health.py``,
unchanged but for its imports.

Dead nodes are handled by mgmtd heartbeats (check_heartbeats rotates
OFFLINE targets), but a SICK node — alive, heartbeating, slow or flaky —
previously inflated every read p99 for up to heartbeat_timeout_s. This
module gives each transport client a local, millisecond-latency view of
its peers:

- EWMA LATENCY per peer (fed by every timed call): the basis for the
  hedged-read arming delay and for demoting persistently slow replicas
  in read selection;
- CONSECUTIVE-ERROR circuit breaker per peer with the classic state
  machine: CLOSED → (error_threshold consecutive transport errors) →
  OPEN → (cooldown elapses) → HALF_OPEN → one probe request → success
  closes, failure re-opens.

Policy split by idempotency (tpu3fs/rpc/idempotency.py):

- READS never fail fast — selection reorders replicas so suspect peers
  are tried LAST (any CRAQ replica serves committed reads, so routing
  around a gray node is free);
- WRITES to an open-breaker peer fail fast with the retryable
  ``Code.PEER_UNHEALTHY`` (no connect/call timeout burned) — the retry
  ladder refreshes routing and retries, and the half-open probe re-tests
  the peer on its own schedule.

Recorders: health.breaker_open / health.breaker_close / health.probe /
health.fail_fast (docs/robustness.md).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Dict, Optional


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class _Peer:
    __slots__ = ("ewma_s", "samples", "err_streak", "state", "opened_at",
                 "probe_inflight")

    def __init__(self):
        self.ewma_s = 0.0
        self.samples = 0
        self.err_streak = 0
        self.state = BreakerState.CLOSED
        self.opened_at = 0.0
        self.probe_inflight = False


class HealthRegistry:
    """Thread-safe per-peer health table keyed by peer id (node id for
    messengers; any hashable works)."""

    def __init__(self, *, error_threshold: int = 3, cooldown_s: float = 1.0,
                 alpha: float = 0.2, slow_ms: float = 20.0,
                 slow_factor: float = 4.0,
                 clock=time.monotonic):
        from tpu3fs_torch.monitor.recorder import CounterRecorder

        self.error_threshold = int(error_threshold)
        self.cooldown_s = float(cooldown_s)
        self.alpha = float(alpha)
        # a peer is SLOW (read-selection demotion) when its EWMA exceeds
        # BOTH the absolute floor and slow_factor x the fastest peer —
        # the relative test keeps a uniformly-loaded cluster from
        # demoting everybody, the absolute floor keeps microsecond noise
        # from demoting anybody
        self.slow_ms = float(slow_ms)
        self.slow_factor = float(slow_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._peers: Dict[object, _Peer] = {}
        self._opened = CounterRecorder("health.breaker_open")
        self._closed = CounterRecorder("health.breaker_close")
        self._probes = CounterRecorder("health.probe")
        self._fail_fast = CounterRecorder("health.fail_fast")
        # lifetime totals (monitor counters reset each collection window)
        self.opened_total = 0
        self.closed_total = 0
        self.probe_total = 0
        self.fail_fast_total = 0

    def _peer(self, peer) -> _Peer:
        p = self._peers.get(peer)
        if p is None:
            p = self._peers[peer] = _Peer()
        return p

    # -- observations -----------------------------------------------------
    def observe(self, peer, latency_s: float, ok: bool = True) -> None:
        """Record one call's outcome. Errors here mean TRANSPORT-level
        failures (connect/timeout/peer-closed) — an application error
        reply proves the peer is alive and healthy."""
        with self._lock:
            p = self._peer(peer)
            if ok:
                if p.samples == 0:
                    p.ewma_s = latency_s
                else:
                    a = self.alpha
                    p.ewma_s = a * latency_s + (1 - a) * p.ewma_s
                p.samples += 1
                p.err_streak = 0
                p.probe_inflight = False
                if p.state != BreakerState.CLOSED:
                    p.state = BreakerState.CLOSED
                    self._closed.add()
                    self.closed_total += 1
                return
            p.err_streak += 1
            p.probe_inflight = False
            if p.state == BreakerState.HALF_OPEN or (
                    p.state == BreakerState.CLOSED
                    and p.err_streak >= self.error_threshold):
                p.state = BreakerState.OPEN
                p.opened_at = self._clock()
                self._opened.add()
                self.opened_total += 1

    # -- decisions --------------------------------------------------------
    def allow(self, peer) -> bool:
        """Gate for FAIL-FAST callers (writes): True = send the call.
        An OPEN breaker past its cooldown transitions to HALF_OPEN and
        admits exactly ONE probe; further calls keep failing fast until
        the probe's outcome lands (observe)."""
        with self._lock:
            p = self._peers.get(peer)
            if p is None or p.state == BreakerState.CLOSED:
                return True
            if p.state == BreakerState.OPEN:
                if self._clock() - p.opened_at < self.cooldown_s:
                    self._fail_fast.add()
                    self.fail_fast_total += 1
                    return False
                p.state = BreakerState.HALF_OPEN
                p.probe_inflight = True
                self._probes.add()
                self.probe_total += 1
                return True
            # HALF_OPEN: one probe at a time
            if p.probe_inflight:
                self._fail_fast.add()
                self.fail_fast_total += 1
                return False
            p.probe_inflight = True
            self._probes.add()
            self.probe_total += 1
            return True

    def suspect(self, peer) -> bool:
        """True when reads should prefer OTHER replicas: breaker not
        closed, or the peer's latency EWMA is an outlier (gray
        straggler)."""
        with self._lock:
            p = self._peers.get(peer)
            if p is None:
                return False
            if p.state != BreakerState.CLOSED:
                return True
            if p.samples == 0 or p.ewma_s * 1000.0 < self.slow_ms:
                return False
            fastest = min(
                (q.ewma_s for q in self._peers.values() if q.samples),
                default=p.ewma_s)
            return p.ewma_s > self.slow_factor * max(fastest, 1e-9)

    def state(self, peer) -> BreakerState:
        with self._lock:
            p = self._peers.get(peer)
            return p.state if p is not None else BreakerState.CLOSED

    def ewma_s(self, peer) -> float:
        with self._lock:
            p = self._peers.get(peer)
            return p.ewma_s if p is not None else 0.0

    def snapshot(self) -> Dict[object, dict]:
        with self._lock:
            return {
                peer: dict(state=p.state.value,
                           ewma_ms=p.ewma_s * 1000.0,
                           err_streak=p.err_streak,
                           samples=p.samples)
                for peer, p in self._peers.items()
            }
