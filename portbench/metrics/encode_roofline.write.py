"""The encode kernels' share of their roofline, %: (k+m)/k of the acknowledged
bytes at the card's HBM bandwidth over their device time."""

from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "encode")
