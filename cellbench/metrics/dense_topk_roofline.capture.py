"""The dense top-K kernel's (K1's, ``csrc/dense_topk.cu``) share of its
function's bound on the traced poses, in %: the least time of the work
its counters count (``_dense.py``) over the kernel's device time, both
over the two traced segments (the counters count in both)."""
from cellbench.metrics._dense import counters, is_topk, topk_bound_s
from cellbench.metrics._spans import host_spans


def read(run):
    if host_spans(run, "ptgs.topk", "samples") is None:
        return None
    got = counters()
    if got is None:
        return None
    segments = (run.trace, run.trace.host)
    launches = sum(s.kernel_count(is_topk) for s in segments)
    spent = sum(s.kernel_s(is_topk) for s in segments)
    if not launches or spent <= 0:
        return None
    return 100.0 * topk_bound_s(got, launches, run.driver.cfg["n"]) / spent
