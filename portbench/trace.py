"""The traced run: the card's own events from ``torch.profiler`` (CUDA
activity only), put on the host's ``perf_counter_ns`` clock, and what is
read from them: busy time, time by kernel, the idle gaps by what the
harness's calls were doing, and a job's kernel time.

The profiler's device clock and ``perf_counter_ns`` differ by an offset.
Right after the profiler starts, a marker kernel (``torch.cuda._sleep``,
named ``spin_kernel``) runs between two host readings; its start, set at
their midpoint, gives the offset (to within the launch, tens of us).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, int, int]  # name, start ns, end ns

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self._prof = None
        self._mark: Optional[Tuple[int, int]] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        a = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        self._mark = (a, time.perf_counter_ns())

    def stop(self) -> List[Event]:
        """Stop and return the device's events on the host clock, the
        marker left out."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._prof.stop()
        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        self._prof = None
        marks = [ev for ev in raw if MARKER in ev[0]]
        if not marks:
            raise RuntimeError("the profiler trace holds no marker kernel: "
                               "it recorded no device activity")
        mark = min(marks, key=lambda ev: ev[1])
        offset = mark[1] - (self._mark[0] + self._mark[1]) // 2
        return sorted(((n, s - offset, e - offset) for n, s, e in raw
                       if (n, s, e) != mark), key=lambda ev: ev[1])


def clip(events: Sequence[Event], t0: int, t1: int) -> List[Event]:
    return [(n, max(s, t0), min(e, t1)) for n, s, e in events
            if e > t0 and s < t1]


def busy_intervals(events: Sequence[Event], t0: int,
                   t1: int) -> List[Tuple[int, int]]:
    """The union of the events' intervals inside [t0, t1], sorted."""
    out: List[Tuple[int, int]] = []
    for _, s, e in sorted(clip(events, t0, t1), key=lambda ev: ev[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(events: Sequence[Event], t0: int, t1: int) -> float:
    return sum(e - s for s, e in busy_intervals(events, t0, t1)) / 1e9


def top_ops(events: Sequence[Event], t0: int, t1: int,
            n: int = 10) -> List[list]:
    """[[name, seconds], ...]: the device's events by name, most time first."""
    total: Dict[str, int] = {}
    for name, s, e in clip(events, t0, t1):
        total[name] = total.get(name, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:96], ns / 1e9] for name, ns in ranked]


def job_seconds(events: Sequence[Event], kernels: Sequence[str], t0: int,
                t1: int) -> float:
    """Device seconds of the events whose name holds one of ``kernels``."""
    return sum(e - s for name, s, e in clip(events, t0, t1)
               if any(k in name for k in kernels)) / 1e9


def idle_gaps(events: Sequence[Event], spans, t0: int, t1: int,
              n: int = 10) -> List[list]:
    """[[label, seconds], ...]: the device's idle time in [t0, t1], each
    gap named by the harness spans open at its middle (names joined by
    "+", sorted; "none" where no call was open), most time first."""
    busy = busy_intervals(events, t0, t1)
    gaps = []
    cur = t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    # one sweep over span starts (kind 0), gap middles (1), span ends (2)
    sweep = [(s, 0, name) for name, s, _, _ in spans]
    sweep += [(e, 2, name) for name, _, e, _ in spans]
    sweep += [((g0 + g1) // 2, 1, g1 - g0) for g0, g1 in gaps]
    sweep.sort(key=lambda x: (x[0], x[1]))
    open_: Dict[str, int] = {}
    total: Dict[str, int] = {}
    for _, kind, what in sweep:
        if kind == 0:
            open_[what] = open_.get(what, 0) + 1
        elif kind == 2:
            open_[what] -= 1
        else:
            names = sorted(k for k, v in open_.items() if v > 0)
            label = "+".join(names) if names else "none"
            total[label] = total.get(label, 0) + what
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[label[:96], ns / 1e9] for label, ns in ranked]
