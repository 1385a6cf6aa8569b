"""p95 of the window's FileIoClient.read calls with a node down, ms."""

from portbench.readers import p95_ms


def read(rec):
    return p95_ms(rec)
