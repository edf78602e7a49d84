"""The dense composite kernel's share of the dense rays
(``dense_composite_share.capture``) against hand counts, and nothing to
read where the program counts no composite (a program without the
kernel, or the CPU's plain path) or the run holds no gathers' span."""
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from test_cellbench_dense import TOY, toy_run
from test_cellbench_spans import reader


def test_dense_composite_share():
    from pathtracer_gaussiansplatting_tpu_torch.utils import profiling
    r = reader("dense_composite_share.capture")
    profiling.reset_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.count("dense_rays", 100)
        assert r.read(toy_run()) is None      # rays, but no composite count
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.count("dense_rays", 100)
            profiling.count("dense_composite_rays", 100)
            profiling.count("dense_rays", 50)
        assert r.read(toy_run()) == pytest.approx(100.0 * 100 / 250)
        # No trace, no host segment, no samples, or no gathers' span.
        no_host = types.SimpleNamespace(trace=types.SimpleNamespace(
            host=None))
        bare = [e for e in TOY if e.name() != "ptgs.gather"]
        for run in (types.SimpleNamespace(trace=None), no_host,
                    toy_run(units={}), toy_run(events=bare)):
            assert r.read(run) is None
        profiling.reset_counts()
        assert r.read(toy_run()) is None
    finally:
        profiling.reset_counts()
