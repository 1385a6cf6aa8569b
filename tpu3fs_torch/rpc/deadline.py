"""End-to-end deadline propagation: absolute deadlines ride every RPC.

The port's own copy of ``tpu3fs/rpc/deadline.py``,
unchanged but for its imports.

A caller arms an ABSOLUTE wall-clock deadline (``deadline_after`` /
``deadline_scope``); it propagates in-process through a ContextVar (the
same machinery that carries the QoS traffic class and the trace context)
and across the wire in the request envelope's ``message`` field — the
field every decoder, old or new, python or native, already parses and
ignores on requests, so the encoding is version-tolerant in both
directions, exactly like TraceContext (tpu3fs/analytics/spans.py).

Wire form (dot-separated tokens, composing with the trace encoding):

- untraced request:  ``d1.<abs-deadline-unix-micros-hex>``
- traced request:    ``t1.<tid>.<sid>.<flags>.d1.<micros-hex>``
  (decode_wire ignores fields beyond the fourth — "a newer peer may
  append" — so old servers keep their trace AND ignore the deadline;
  new servers parse both)

Servers shed already-expired work at TWO points so it can never reach
the engine stage:

1. RPC ADMISSION (both transports' dispatch, before request decode):
   an expired envelope answers the retryable ``Code.DEADLINE_EXCEEDED``
   immediately — cheaper than any handler;
2. UPDATE-QUEUE DEQUEUE (storage/update_worker.py): a queued write batch
   whose submitter's deadline passed while it waited is answered
   DEADLINE_EXCEEDED at round start instead of being executed for a
   caller that already gave up.

Both sheds count on the ``qos.deadline_shed`` recorder (kind=admission /
kind=dequeue). Clients derive per-attempt budgets from the ambient
deadline: ``StorageClient._sleep`` never sleeps past it, and retry
ladders stop once it expires (docs/robustness.md).

Deadlines use ``time.time()`` (wall clock): monotonic clocks are not
comparable across processes. Single-host skew is negligible; clusters
are expected to run NTP like the reference's deployment.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, Optional

#: wire token introducing the deadline field (hex unix micros follows)
WIRE_TOKEN = "d1"

_deadline_var: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("tpu3fs_deadline", default=None)


# -- context propagation ------------------------------------------------------

def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (unix seconds), or None."""
    return _deadline_var.get()


def remaining(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the ambient deadline (may be <= 0), or `default`
    when none is armed."""
    dl = _deadline_var.get()
    if dl is None:
        return default
    return dl - time.time()


def expired() -> bool:
    """True iff an ambient deadline is armed AND already passed."""
    dl = _deadline_var.get()
    return dl is not None and time.time() > dl


@contextlib.contextmanager
def deadline_scope(abs_deadline: Optional[float]):
    """Arm an absolute deadline for the block. When one is already armed,
    the EARLIER of the two wins (a callee can only tighten the budget —
    the nested-op rule that makes propagation composable). None = no-op."""
    if abs_deadline is None:
        yield None
        return
    outer = _deadline_var.get()
    eff = abs_deadline if outer is None else min(outer, abs_deadline)
    token = _deadline_var.set(eff)
    try:
        yield eff
    finally:
        _deadline_var.reset(token)


def deadline_after(budget_s: float):
    """Arm ``now + budget_s`` (see deadline_scope for nesting rules)."""
    return deadline_scope(time.time() + float(budget_s))


# -- envelope carriage --------------------------------------------------------

def encode_envelope(trace_wire: str, deadline: Optional[float]) -> str:
    """Compose the request envelope message from an (optional) trace wire
    string and an (optional) absolute deadline. '' when both absent."""
    if deadline is None:
        return trace_wire or ""
    tok = f"{WIRE_TOKEN}.{int(deadline * 1e6):x}"
    return f"{trace_wire}.{tok}" if trace_wire else tok


def decode_deadline(message: str) -> Optional[float]:
    """Parse an absolute deadline off a request envelope message; None for
    absent/malformed/legacy encodings. Tokens are positional: standalone
    at field 0, or appended after the 4 trace fields — a trace id that
    happens to spell 'd1' can never be misread as a deadline."""
    if not message or WIRE_TOKEN not in message:
        return None
    parts = message.split(".")
    if parts[0] == WIRE_TOKEN:
        idx = 0
    elif parts[0] == "t1":
        try:
            idx = parts.index(WIRE_TOKEN, 4)
        except ValueError:
            return None
    else:
        return None
    if idx + 1 >= len(parts):
        return None
    try:
        us = int(parts[idx + 1], 16)
    except ValueError:
        return None
    if us <= 0:
        return None
    return us / 1e6


# -- shed accounting ----------------------------------------------------------
# ONE declaration site for the qos.deadline_shed name (recorder-registry
# uniqueness rule); both shed points report through record_shed().

_SHED: Dict[str, object] = {}
_SHED_TOTALS: Dict[str, int] = {"admission": 0, "dequeue": 0}


def _shed_recorders() -> Dict[str, object]:
    if not _SHED:
        from tpu3fs_torch.monitor.recorder import CounterRecorder

        for stage in ("admission", "dequeue"):
            _SHED[stage] = CounterRecorder("qos.deadline_shed",
                                           {"kind": stage})
    return _SHED


def record_shed(stage: str, n: int = 1) -> None:
    """Count expired-work sheds; stage is 'admission' or 'dequeue'."""
    rec = _shed_recorders().get(stage)
    if rec is not None:
        rec.add(n)
    _SHED_TOTALS[stage] = _SHED_TOTALS.get(stage, 0) + n


def shed_totals() -> Dict[str, int]:
    """Process-lifetime shed counts by stage (tests/drives; the monitor
    counters reset every collection window, these never do)."""
    return dict(_SHED_TOTALS)
