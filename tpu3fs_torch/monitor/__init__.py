"""Metric recorders (``recorder``), the flight recorder (``flight``), the
process-memory gauges (``memory``), windowed rollups (``agg``), the SLO
engine (``slo``) and the collector service with its push sinks
(``collector``): the port's own copies of ``tpu3fs/monitor/``."""

from tpu3fs_torch.monitor.recorder import (  # noqa: F401
    CounterRecorder,
    DistributionRecorder,
    LatencyRecorder,
    Monitor,
    Sample,
)
