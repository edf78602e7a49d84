"""The share of the rays the bounce loop shades that are alive, in %:
the port's counters ``rays_alive`` over ``rays_shaded``
(``utils/profiling.count``, summed at every bounce past the first while a
profiler records: over the traced segments). Rays are masked, never
compacted, so the rest is shading spent on dead rays."""
from importlib import import_module

from cellbench.metrics._spans import host_spans

PROFILING = "pathtracer_gaussiansplatting_tpu_torch.utils.profiling"


def read(run):
    if host_spans(run, "ptgs.shade", "samples") is None:
        return None
    counts = getattr(import_module(PROFILING), "counts", None)
    got = counts() if counts is not None else {}
    if not got.get("rays_shaded"):
        return None
    return 100.0 * got["rays_alive"] / got["rays_shaded"]
