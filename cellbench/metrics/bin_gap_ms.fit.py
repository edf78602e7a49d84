"""Device idle ms a training step in the gaps whose midpoint falls inside
the span ``ptgs.bin`` on the program's thread: the card waiting on the
binning's host work. CUPTI's cost a launch is in it (``_spans.py``)."""
from cellbench.metrics._spans import gap_ms_per


def read(run):
    return gap_ms_per(run, "ptgs.bin", "steps")
