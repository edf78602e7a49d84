"""Device idle ms a path-traced sample in the gaps whose midpoint falls
inside the span ``ptgs.shade`` (or a child of it): the card waiting on
the shading's launches. CUPTI's cost a launch is in it (``_spans.py``)."""
from cellbench.metrics._spans import gap_ms_per


def read(run):
    return gap_ms_per(run, "ptgs.shade", "samples")
