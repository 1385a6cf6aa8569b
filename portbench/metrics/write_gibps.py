"""Acknowledged file bytes over the window's whole time, GiB/s: issuing
stops at the deadline, calls in flight finish and count."""

from portbench.readers import rate_gibps


def read(rec):
    return rate_gibps(rec)
