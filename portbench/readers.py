"""Arithmetic the per-layer readers share (``metrics/<name>.py``)."""

from __future__ import annotations

import math
from typing import Optional

from portbench.trace import job_seconds

GIB = float(1 << 30)


def rate_gibps(rec) -> Optional[float]:
    """All the bytes the window's calls did, over the time from its start
    to the last completion, GiB/s."""
    if rec.t1 <= rec.t0 or rec.done_bytes == 0:
        return None
    return rec.done_bytes / ((rec.t1 - rec.t0) / 1e9) / GIB


def p95_ms(rec) -> Optional[float]:
    """The 95th percentile (nearest rank) of the done calls' times, ms."""
    times = sorted(s[2] - s[1] for s in rec.done())
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1] / 1e6


def per_gib(rec, key: str) -> Optional[float]:
    """A counter's change over the window per GiB of work done."""
    delta = rec.counter(key)
    if delta is None or rec.done_bytes == 0:
        return None
    return delta / (rec.done_bytes / GIB)


def roofline_pct(rec, job: str) -> Optional[float]:
    """The least time the card needs for the job's bytes (the traffic's
    count, at the card's published HBM bandwidth) over the device time of
    the kernels that do the job, in %; None without a trace, work or
    kernel time."""
    if rec.device is None or not rec.work.get(job) or not rec.hbm_bytes_per_s:
        return None
    spent = job_seconds(rec.device["events"], rec.jobs.get(job, []),
                        rec.t0, rec.t1)
    if spent <= 0:
        return None
    return 100.0 * rec.work[job] / rec.hbm_bytes_per_s / spent


def idle_pct(rec) -> Optional[float]:
    """The share of the window in which no operation ran on the card, %."""
    if rec.device is None or rec.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.device["busy_s"] / rec.device["window_s"])
