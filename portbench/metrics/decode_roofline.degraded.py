"""The decode kernels' share of their roofline, %: k survivors read and the
lost shard written a degraded stripe, at the card's HBM bandwidth, over
their device time."""

from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "decode")
