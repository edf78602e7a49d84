"""The share of the window in which the card ran nothing, in %: the
traced segment's busy time a call against the window's time a call
(``device_idle.<cell kind>``: one reader for each cell's metric)."""
from cellbench.metrics._lib import idle_pct


def read(run):
    return idle_pct(run)
