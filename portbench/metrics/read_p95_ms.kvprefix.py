"""p95 of the window's KV loads (match_prefix and get_blocks into the pool),
ms, on the harness's clock."""

from portbench.readers import p95_ms


def read(rec):
    return p95_ms(rec)
