"""p95 of the window's FileIoClient.write calls, ms, on the harness's clock."""

from portbench.readers import p95_ms


def read(rec):
    return p95_ms(rec)
