"""The checksum kernels' share of their roofline, %: 2(k+m)/k of the
acknowledged bytes (client and installing target) at the card's HBM
bandwidth over their device time."""

from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "checksum")
