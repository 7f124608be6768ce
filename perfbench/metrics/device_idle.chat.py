"""The share of the traced window in which no kernel, copy or fill ran
on the card: 1 - the union of their intervals over the window."""
from perfbench import readers


def read(run):
    return readers.idle_pct(run)
