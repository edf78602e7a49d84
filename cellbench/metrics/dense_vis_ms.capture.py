"""Device ms a path-traced sample in the dense shadow rays, the span
``ptgs.dense_vis`` of ``render/pipeline._dense_vis``: K2 and its glue. On
the capture's path the span launches K2 alone (its arguments are views
and the backend's cached table), so its time is K2's, read by name in
the card's segment, with no join to shift (``_dense.py``)."""
from cellbench.metrics._dense import is_vis
from cellbench.metrics._lib import kernel_ms_per
from cellbench.metrics._spans import host_spans


def read(run):
    if host_spans(run, "ptgs.dense_vis", "samples") is None:
        return None
    return kernel_ms_per(run, is_vis, "samples")
