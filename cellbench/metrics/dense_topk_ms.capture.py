"""Device ms a path-traced sample in the dense top-K, the span
``ptgs.topk`` of ``render/reference.dense_topk``: K1 and its arguments. On
the capture's path the span launches K1 alone (its arguments are views
and the backend's cached table), so its time is K1's, read by name in
the card's segment, with no join to shift (``_dense.py``)."""
from cellbench.metrics._dense import is_topk
from cellbench.metrics._lib import kernel_ms_per
from cellbench.metrics._spans import host_spans


def read(run):
    if host_spans(run, "ptgs.topk", "samples") is None:
        return None
    return kernel_ms_per(run, is_topk, "samples")
