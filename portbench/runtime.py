"""What a driver and a metric reader are handed: the run's context, the
harness's spans, and the record of a finished window."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

Span = Tuple[str, int, int, int]  # name, start ns, end ns, bytes


class SpanLog:
    """Spans the harness takes around its calls into the program, on the
    host's monotonic clock (``time.perf_counter_ns``), from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: List[Span] = []

    def add(self, name: str, t0: int, t1: int, nbytes: int = 0) -> None:
        with self._lock:
            self.spans.append((name, t0, t1, nbytes))

    @contextmanager
    def span(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns(), nbytes)

    def clear(self) -> None:
        with self._lock:
            self.spans = []

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s[0] == name]


@dataclass
class Check:
    """One number the run compares, with its limit: ``value <= limit``
    (``op`` "<=") or ``value >= limit`` (``op`` ">=")."""

    name: str
    value: float
    limit: float
    op: str = "<="

    @property
    def ok(self) -> bool:
        return (self.value <= self.limit if self.op == "<="
                else self.value >= self.limit)


@dataclass
class Context:
    cell: object            # spec.Cell
    seed: int
    device: object          # torch.device
    spans: SpanLog
    log: Callable[[str], None] = print
    control: Optional[str] = None   # a control or fault to plant, or None

    @contextmanager
    def phase(self, name: str):
        """Log how long a step of the set-up took."""
        t0 = time.perf_counter()
        yield
        self.log(f"# setup: {name} {time.perf_counter() - t0:.3f} s")


@dataclass
class Record:
    """A finished window, as the per-layer readers see it. Times are
    ``perf_counter_ns``; device events are on that clock too."""

    cell: object
    t0: int
    t1: int                          # the last completion
    unit: str                        # the spans that count as work done
    spans: List[Span]
    before: dict
    after: dict
    work: dict                       # job -> bytes the traffic needed
    jobs: dict                       # job -> kernel names
    hbm_bytes_per_s: float
    device: Optional[dict] = None    # events, busy_s, window_s (traced)
    setup_s: float = 0.0             # process start to the window's start

    def counter(self, key: str) -> Optional[float]:
        if key not in self.before or key not in self.after:
            return None
        return self.after[key] - self.before[key]

    def done(self) -> List[Span]:
        return [s for s in self.spans if s[0] == self.unit]

    @property
    def done_bytes(self) -> int:
        return sum(s[3] for s in self.done())
