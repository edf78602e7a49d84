"""Device ms a path-traced sample in the dense trace's (R, K) feature
gathers, the span ``ptgs.gather`` of ``render/reference.trace_dense``: the
kernels launched inside it, joined to their launches from the K1 launch
before them (``_dense.anchored_s``)."""
from cellbench.metrics._dense import anchored_s
from cellbench.metrics._spans import host_spans


def read(run):
    got = host_spans(run, "ptgs.gather", "samples")
    if got is None:
        return None
    spent = anchored_s(run.trace.host, "ptgs.gather")
    return None if spent is None else 1e3 * spent / got[1]
