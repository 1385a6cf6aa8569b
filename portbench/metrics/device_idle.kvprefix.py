"""The share of the traced window in which no operation ran on the card, %."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
