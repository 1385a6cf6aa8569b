"""File bytes returned over the window's whole time, GiB/s: issuing stops
at the deadline, calls in flight finish and count; a sample drawn from the
seed is held against the bytes written once the window has closed."""

from portbench.readers import rate_gibps


def read(rec):
    return rate_gibps(rec)
