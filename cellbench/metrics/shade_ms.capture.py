"""Device ms a path-traced sample in the span ``ptgs.shade`` itself, less
its child spans ``ptgs.lights`` and ``ptgs.vis``: emission, MIS, the NEE
arithmetic, the scatter and roulette, credited by launch (``_spans.py``)."""
from cellbench.metrics._spans import ms_per


def read(run):
    return ms_per(run, "ptgs.shade", "samples", self_only=True)
