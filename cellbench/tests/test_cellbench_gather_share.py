"""The packet gather's live-slot share (``gather_live_share.fit``) against
hand counts, and nothing to read where the program records no counter."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_cellbench_spans import reader, span_events, span_host, span_run


def test_gather_live_share():
    from pathtracer_gaussiansplatting_tpu_torch.utils import profiling
    r = reader("gather_live_share.fit")
    profiling.reset_counts()
    assert r.read(span_run()) is None        # no counter recorded
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("packet_slots", 8)
        profiling.count("packet_slots_live",
                        torch.tensor([[True, False, True, True]]))
        profiling.count("packet_slots", 8)
        profiling.count("packet_slots_live", torch.tensor([True, False]))
    try:
        assert r.read(span_run()) == pytest.approx(25.0)
        # No trace, no host segment, no steps, or no binning span.
        no_host = types.SimpleNamespace(trace=span_host())
        bare = [e for e in span_events() if not e.name().startswith("ptgs.")]
        for run in (types.SimpleNamespace(trace=None), no_host,
                    span_run(units={}), span_run(events=bare)):
            assert r.read(run) is None
    finally:
        profiling.reset_counts()
