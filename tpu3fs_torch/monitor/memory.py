"""Process memory counters for the monitoring stack.

The port's own copy of ``tpu3fs/monitor/memory.py``,
unchanged but for its imports.

Re-expresses the reference's src/memory counters (jemalloc/mimalloc
allocated-memory stats pushed through monitor::Recorder): here the process
allocator is CPython's (no global override to hook), so the gauges come from
/proc/self/status (RSS, peak, virtual) plus optional per-engine accounting
(native chunk-engine used bytes), published through the same ValueRecorder
path every other metric rides.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from tpu3fs_torch.monitor.recorder import ValueRecorder

_FIELDS = {
    "VmRSS": "memory.rss_kb",
    "VmHWM": "memory.rss_peak_kb",
    "VmSize": "memory.vsize_kb",
    "VmData": "memory.data_kb",
}


def read_proc_status(path: str = "/proc/self/status") -> Dict[str, int]:
    """-> {metric_name: kB} for the tracked VM fields."""
    out: Dict[str, int] = {}
    try:
        with open(path) as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in _FIELDS:
                    out[_FIELDS[key]] = int(rest.split()[0])
    except OSError:
        pass
    return out


class MemoryMonitor:
    """Publishes memory gauges; optional extra sources (e.g. a native chunk
    engine's used_size) are polled alongside (ref src/memory counters)."""

    def __init__(self, tags: Optional[Dict[str, str]] = None, *,
                 monitor=None):
        self._tags = tags or {}
        self._monitor = monitor
        self._gauges: Dict[str, ValueRecorder] = {}
        self._sources: List = []  # (metric_name, fn) pairs

    def add_source(self, metric: str, fn: Callable[[], float]) -> None:
        self._sources.append((metric, fn))

    def _gauge(self, name: str) -> ValueRecorder:
        g = self._gauges.get(name)
        if g is None:
            g = ValueRecorder(name, dict(self._tags), monitor=self._monitor)
            self._gauges[name] = g
        return g

    def poll_once(self) -> Dict[str, float]:
        vals: Dict[str, float] = dict(read_proc_status())
        for metric, fn in self._sources:
            try:
                vals[metric] = float(fn())
            except Exception:
                continue  # a dead source must not break the poll loop
        for name, v in vals.items():
            self._gauge(name).set(v)
        return vals
