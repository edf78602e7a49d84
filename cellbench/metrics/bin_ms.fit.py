"""Device ms a training step under the span ``ptgs.bin`` (the port's
``render/tiled.prepare_tiles``: projection, binning, packet features and
gather), the work credited by launch (``_spans.py``)."""
from cellbench.metrics._spans import ms_per


def read(run):
    return ms_per(run, "ptgs.bin", "steps")
