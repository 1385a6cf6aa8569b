"""Adaptive coalesce-gap controller: learn the span-merge threshold from
observed batch latency.

``recordio.plan_coalesced`` merges sorted record extents whose gap is
below a threshold — trading over-read wire bytes against per-span round
trips. The 64 KiB default was measured ONCE on one host/record-size
combination (dataload_bench sweep); the right value moves with record
size, transport and storage load. This controller learns it online from
the ``dataload.batch_ms`` signal the loader already measures per batch
(the stage-timing substrate of the tracing PR), with no extra IO:

- a fixed LADDER of candidate gaps is explored round-robin for
  ``probes_per_arm`` batches each (deterministic: no randomness, so the
  convergence test can pin the trajectory exactly);
- after exploration the arm with the best per-byte-normalized EWMA cost
  is exploited;
- every ``reprobe_every`` batches one NEIGHBOR of the current arm is
  probed once (hill climbing), so the controller tracks drift — a
  storage tier that got slower per round trip pushes the gap up, a
  faster one pulls it down — without ever leaving steady state more
  than 1/reprobe_every of the time.

Costs are normalized per payload byte (ms/MiB) so batches of different
sizes share one scale.

The port's own copy of ``tpu3fs/dataload/autotune.py`` (host code).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

#: candidate gaps: 8 KiB .. 256 KiB around the measured 64 KiB optimum
DEFAULT_LADDER: Tuple[int, ...] = tuple(
    1 << s for s in range(13, 19))  # 8K, 16K, 32K, 64K, 128K, 256K


class GapController:
    """Online hill-climbing tuner for ``coalesce_gap``.

    Protocol: call ``next_gap()`` to get the gap for the upcoming batch,
    then ``observe(gap, batch_ms, nbytes)`` with the measured wall —
    keyed by the gap actually used, so concurrent fetch workers
    attribute correctly whatever order they finish in.
    """

    def __init__(self, ladder: Sequence[int] = DEFAULT_LADDER, *,
                 probes_per_arm: int = 3, ewma: float = 0.3,
                 reprobe_every: int = 64):
        if not ladder:
            raise ValueError("empty gap ladder")
        self._ladder = tuple(sorted(set(int(g) for g in ladder)))
        self._probes_per_arm = max(1, int(probes_per_arm))
        self._alpha = float(ewma)
        self._reprobe_every = max(2, int(reprobe_every))
        self._lock = threading.Lock()
        # per-arm EWMA of ms per MiB (None = never observed)
        self._cost: Dict[int, Optional[float]] = {
            g: None for g in self._ladder}
        self._issued = 0          # next_gap() calls (drives the schedule)
        self._observed = 0
        self._best = self._ladder[len(self._ladder) // 2]
        self._probe_flip = False  # alternate up/down neighbor reprobes

    @property
    def explore_batches(self) -> int:
        """Length of the deterministic exploration phase."""
        return len(self._ladder) * self._probes_per_arm

    @property
    def gap(self) -> int:
        """Current steady-state choice (the exploit arm)."""
        with self._lock:
            return self._best

    def next_gap(self) -> int:
        """The gap the next batch should coalesce with."""
        with self._lock:
            i = self._issued
            self._issued += 1
            if i < self.explore_batches:
                # round-robin exploration: arm changes every batch so a
                # transient host hiccup spreads over arms instead of
                # poisoning one
                return self._ladder[i % len(self._ladder)]
            if (i - self.explore_batches) % self._reprobe_every == \
                    self._reprobe_every - 1:
                # hill-climb probe: one neighbor, alternating sides
                idx = self._ladder.index(self._best)
                self._probe_flip = not self._probe_flip
                nidx = idx + (1 if self._probe_flip else -1)
                if 0 <= nidx < len(self._ladder):
                    return self._ladder[nidx]
            return self._best

    def observe(self, gap: int, batch_ms: float, nbytes: int) -> None:
        """Feed one batch's measured wall back (gap = the value
        next_gap() handed out for it)."""
        if gap not in self._cost or batch_ms <= 0:
            return
        cost = batch_ms / max(1, nbytes) * (1 << 20)  # ms per MiB
        with self._lock:
            prev = self._cost[gap]
            self._cost[gap] = (cost if prev is None
                               else prev + self._alpha * (cost - prev))
            self._observed += 1
            if self._observed >= self.explore_batches:
                known = [(c, g) for g, c in self._cost.items()
                         if c is not None]
                if known:
                    self._best = min(known)[1]

    def snapshot(self) -> Dict[int, Optional[float]]:
        with self._lock:
            return dict(self._cost)
