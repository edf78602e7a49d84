"""The share of the dense top-K's (R, K) list slots that hold a
contributor, in %: the port's counters ``dense_list_filled`` (entries with
alpha > 0) over ``dense_list_slots`` (R x K), summed at each top-K while
a profiler records (over the traced segments). The rest is padding that
the gathers and the composite still read."""
from cellbench.metrics._dense import counters
from cellbench.metrics._spans import host_spans


def read(run):
    if host_spans(run, "ptgs.topk", "samples") is None:
        return None
    got = counters()
    if got is None:
        return None
    return 100.0 * got["dense_list_filled"] / got["dense_list_slots"]
