"""Device ms a path-traced sample under the span ``ptgs.lights``
(``lights.sample_emissive`` and ``sample_punctual``: the CDF search, the
scales' argsort, the gathers), credited by launch (``_spans.py``)."""
from cellbench.metrics._spans import ms_per


def read(run):
    return ms_per(run, "ptgs.lights", "samples")
