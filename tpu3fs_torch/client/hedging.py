"""Hedged reads: arm a backup request to another replica after an
adaptive delay; first reply wins.

The port's own copy of ``tpu3fs/client/hedging.py``,
unchanged but for its imports.

CRAQ's apportioned queries let ANY serving replica answer a committed
read, so the classic tail-latency defense applies: when the primary
replica has not answered within a small multiple of the observed typical
latency, issue the same read to the next replica and take whichever
reply lands first. A gray (slow-but-alive) replica then costs one hedge
delay instead of its full straggle.

Discipline (the reasons hedging is safe and cheap here):

- IDEMPOTENT ONLY: hedging is statically restricted to the read methods
  classified in tpu3fs/rpc/idempotency.py (enforced by
  tools/check_rpc_registry.py in tier-1).
- BUDGETED: a token bucket earns ``budget_ratio`` tokens per primary
  request and each hedge spends one, so hedges add at most ~ratio extra
  load (default 5%) no matter how sick the cluster is; denied hedges
  count on hedge.suppressed.
- ADAPTIVE DELAY: the arming delay is ``delay_factor`` x the per-peer
  latency EWMA (floored at ``delay_floor_ms``), so a fast cluster hedges
  at milliseconds while a slow one does not hedge prematurely.

Accounting: hedge.sent / hedge.win (backup answered first) / hedge.loss
(primary answered first after all) / hedge.suppressed (budget denied).
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
from typing import Callable, Optional, Tuple

from tpu3fs_torch.monitor.recorder import CounterRecorder


class _RunnerPool:
    """Persistent daemon runners for hedge attempts. A thread PER attempt
    is wrong for a hot read path: in a process with a live server + bench
    threads, a freshly spawned thread's first scheduling quantum costs
    multiple milliseconds (measured 3-8x the whole RPC), which lands
    directly on every hedged read's critical path. Runners are daemon
    threads (a wedged thunk must never block interpreter exit — same
    contract as the old per-call daemon threads), spawned on demand up to
    a cap; past the cap attempts queue, which only happens when that many
    thunks are already wedged."""

    def __init__(self, max_workers: int = 64):
        self._q: "queue.SimpleQueue[Callable[[], None]]" = \
            queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads = 0
        self._idle = 0
        self._max = int(max_workers)

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            spawn = self._idle == 0 and self._threads < self._max
            if spawn:
                self._threads += 1
        if spawn:
            threading.Thread(target=self._loop, daemon=True,
                             name="hedge-runner").start()
        self._q.put(fn)

    def _loop(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            fn = self._q.get()
            with self._lock:
                self._idle -= 1
            try:
                fn()
            except BaseException:
                pass  # _runner already wraps; belt + braces


_pool: Optional[_RunnerPool] = None
_pool_lock = threading.Lock()


def _reset_pool_after_fork() -> None:
    """fork() carries the pool singleton's thread/idle COUNTERS into the
    child but not its runner THREADS: submit() would then see idle
    runners that do not exist and queue thunks nobody drains (every
    hedged call in the forked child times out). Start the child from a
    fresh pool — and a fresh lock, in case the parent forked while a
    sibling thread held it."""
    global _pool, _pool_lock
    _pool = None
    _pool_lock = threading.Lock()


os.register_at_fork(after_in_child=_reset_pool_after_fork)


def _runners() -> _RunnerPool:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = _RunnerPool()
    return _pool


class HedgeController:
    """Budget + adaptive-delay policy shared by one client's read paths.
    Latency observations may come from a messenger HealthRegistry (socket
    transports) or be fed directly by the client (in-process fabrics)."""

    def __init__(self, *, budget_ratio: float = 0.05, burst: float = 16.0,
                 delay_floor_ms: float = 5.0, delay_factor: float = 3.0,
                 health=None):
        self.budget_ratio = float(budget_ratio)
        self.burst = max(1.0, float(burst))
        self.delay_floor_s = float(delay_floor_ms) / 1000.0
        self.delay_factor = float(delay_factor)
        self._health = health
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._sent = CounterRecorder("hedge.sent")
        self._won = CounterRecorder("hedge.win")
        self._lost = CounterRecorder("hedge.loss")
        self._suppressed = CounterRecorder("hedge.suppressed")
        # lifetime totals (monitor counters reset per collection window)
        self.sent_total = 0
        self.win_total = 0
        self.loss_total = 0
        self.suppressed_total = 0
        self.primaries_total = 0

    # -- latency model ----------------------------------------------------
    def observe_latency(self, peer, latency_s: float) -> None:
        h = self._health
        if h is not None:
            h.observe(peer, latency_s, ok=True)

    def delay_s(self, peer=None) -> float:
        """Arming delay before the backup request fires."""
        ewma = 0.0
        h = self._health
        if h is not None and peer is not None:
            ewma = h.ewma_s(peer)
        return max(self.delay_floor_s, self.delay_factor * ewma)

    # -- budget -----------------------------------------------------------
    def note_primary(self, n: int = 1) -> None:
        """Each primary request earns budget_ratio hedge tokens (capped
        at burst) — the mechanism that bounds extra load to ~ratio."""
        with self._lock:
            self.primaries_total += n
            self._tokens = min(self.burst,
                               self._tokens + self.budget_ratio * n)

    def try_hedge(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._sent.add()
                self.sent_total += 1
                return True
        self._suppressed.add()
        self.suppressed_total += 1
        return False

    def record_outcome(self, backup_won: bool) -> None:
        if backup_won:
            self._won.add()
            self.win_total += 1
        else:
            self._lost.add()
            self.loss_total += 1

    def extra_load_ratio(self) -> float:
        """Hedges sent / primaries issued — the bench's budget assertion."""
        if self.primaries_total == 0:
            return 0.0
        return self.sent_total / self.primaries_total

    def stats(self) -> dict:
        return dict(sent=self.sent_total, win=self.win_total,
                    loss=self.loss_total, suppressed=self.suppressed_total,
                    primaries=self.primaries_total,
                    extra_load_ratio=self.extra_load_ratio())


def run_hedged(primary: Callable[[], object],
               backup: Optional[Callable[[], object]],
               delay_s: float,
               controller: HedgeController,
               *,
               good: Callable[[object], bool] = lambda r: True,
               max_wait_s: float = 60.0) -> Tuple[object, bool, bool]:
    """Run ``primary`` on a helper thread; if it has not produced a GOOD
    reply within ``delay_s`` and the budget allows, launch ``backup`` and
    return the first good reply (or the last reply when none is good).

    -> (reply, hedged, backup_won). Both thunks run inside a snapshot of
    the calling context (QoS class, trace, deadline ride along) on the
    persistent runner pool (see _RunnerPool). Thunks must RETURN replies,
    never raise — callers wrap transport errors into reply objects (their
    normal pattern)."""
    controller.note_primary()
    replies: list = [None, None]
    done = [False, False]
    cond = threading.Condition()
    # one context snapshot per attempt: a Context object can only be
    # entered by one thread at a time, so the two runners need their own
    ctxs = (contextvars.copy_context(), contextvars.copy_context())

    def _runner(idx: int, fn: Callable[[], object]) -> None:
        try:
            r = ctxs[idx].run(fn)
        except BaseException as e:  # belt + braces: surface, don't hang
            r = e
        with cond:
            replies[idx] = r
            done[idx] = True
            cond.notify_all()

    _runners().submit(lambda: _runner(0, primary))

    def _winner(expect_backup: bool):
        """First finished-and-good index, else None."""
        for idx in (0, 1) if expect_backup else (0,):
            if done[idx] and not isinstance(replies[idx], BaseException) \
                    and good(replies[idx]):
                return idx
        return None

    with cond:
        cond.wait_for(lambda: done[0], timeout=max(0.0, delay_s))
        if done[0] or backup is None or not controller.try_hedge():
            # no hedge: just wait the primary out
            cond.wait_for(lambda: done[0], timeout=max_wait_s)
            r = replies[0]
            if isinstance(r, BaseException):
                raise r
            return r, False, False
    _runners().submit(lambda: _runner(1, backup))
    with cond:
        cond.wait_for(lambda: _winner(True) is not None
                      or (done[0] and done[1]),
                      timeout=max_wait_s)
        idx = _winner(True)
        if idx is None:
            # neither reply is good: prefer the primary's (its error code
            # drives the caller's existing failover ladder); fall back to
            # the backup's if the primary is still in flight
            idx = 0 if done[0] else 1
            if not done[idx]:
                cond.wait_for(lambda: done[0] or done[1],
                              timeout=max_wait_s)
                idx = 0 if done[0] else 1
        r = replies[idx]
    controller.record_outcome(backup_won=idx == 1)
    if r is None:
        # both attempts hung past max_wait: report as a transport timeout
        from tpu3fs_torch.utils.result import Code, FsError, Status

        raise FsError(Status(Code.RPC_TIMEOUT, "hedged call timed out"))
    if isinstance(r, BaseException):
        raise r
    return r, True, idx == 1
