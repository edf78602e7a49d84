"""The share of the dense trace's rays that the composite kernel
composited, in %: the port's counters ``dense_composite_rays`` (counted
where ``render/reference.trace_dense`` launches
``dense_trace.dense_composite``) over ``dense_rays`` (every top-K's
rays), summed while a profiler records (over the traced segments). The
rest went through the plain gathers and einsums. None where the program
counts no composite (a program without the kernel) or no dense ray."""
from importlib import import_module

from cellbench.metrics._spans import host_spans

PROFILING = "pathtracer_gaussiansplatting_tpu_torch.utils.profiling"


def read(run):
    if host_spans(run, "ptgs.gather", "samples") is None:
        return None
    counts = getattr(import_module(PROFILING), "counts", None)
    got = counts() if counts is not None else {}
    if got.get("dense_composite_rays") is None or not got.get("dense_rays"):
        return None
    return 100.0 * got["dense_composite_rays"] / got["dense_rays"]
