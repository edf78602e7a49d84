"""The share of the packets' slots that the packet gather's backward reads,
in %: the port's counters ``packet_slots_live`` over ``packet_slots``
(``utils/profiling.count``, summed at each training step's backward while
a profiler records: over the traced segments). The rest are masked slots,
padding that the backward never reads."""
from importlib import import_module

from cellbench.metrics._spans import host_spans

PROFILING = "pathtracer_gaussiansplatting_tpu_torch.utils.profiling"


def read(run):
    if host_spans(run, "ptgs.bin", "steps") is None:
        return None
    counts = getattr(import_module(PROFILING), "counts", None)
    got = counts() if counts is not None else {}
    if not got.get("packet_slots"):
        return None
    return 100.0 * got["packet_slots_live"] / got["packet_slots"]
