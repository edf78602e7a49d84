"""The span readers (``metrics/_spans.py``) against hand counts on toy
segments: device ops joined to their launches in stream order, credited
to the innermost span at the launch, self time, gaps by midpoint."""
import types

import pytest
import torch

from cellbench import trace as trace_mod
from cellbench.metrics._spans import NONE, UNJOINED, Spans
from cellbench.run import load_module, reader_path

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """A profiler event: name, device, start and length in ns."""

    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._l = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._l

    def is_user_annotation(self):
        return self._n.startswith("ptgs.") and self._d == CPU


def span_events():
    """Host: ptgs.bin [0, 100), ptgs.shade [200, 600) holding ptgs.lights
    [250, 300) and ptgs.vis [400, 450). The n-th device op of a kind is
    the n-th launch of its kind, the march reading as starting before its
    launch (the card's clock drifts from the host's); a last kernel and a
    set have no launch."""
    launch = "cudaLaunchKernel"
    return [
        Ev("ptgs.bin", CPU, 0, 100), Ev("ptgs.shade", CPU, 200, 400),
        Ev("ptgs.lights", CPU, 250, 50), Ev("ptgs.vis", CPU, 400, 50),
        Ev("ptgs.shade", CUDA, 200, 400),        # the mirrored range
        Ev(launch, CPU, 10, 2), Ev("DeviceRadixSortOnesweep", CUDA, 20, 20),
        Ev(launch, CPU, 30, 2), Ev("CatArrayBatchedCopy", CUDA, 90, 10),
        Ev("aten::add", CPU, 205, 10),           # no launch
        Ev(launch, CPU, 210, 2), Ev("elementwise_kernel", CUDA, 215, 30),
        Ev(launch, CPU, 260, 2), Ev("radixSortKVInPlace", CUDA, 262, 40),
        Ev("cudaLaunchKernelExC", CPU, 410, 3),
        Ev("grid_march_kernel<false, 2>", CUDA, 405, 60),
        Ev("cudaMemcpyAsync", CPU, 500, 2),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 500, 10),
        Ev("cudaStreamSynchronize", CPU, 503, 5),
        # autograd's backward while the program's thread waits: no span
        Ev(launch, CPU, 690, 2), Ev("indexing_backward_kernel", CUDA, 705,
                                    20),
        Ev(launch, CPU, 700, 2), Ev("k_outside", CUDA, 725, 5),
        Ev("Memset (Device)", CUDA, 730, 5),     # no set launched
        Ev("orphan", CUDA, 740, 5),              # beyond the launches
    ]


def span_host(events=None, units=None):
    if units is None:
        units = dict(samples=2, steps=2, frames=2)
    return trace_mod.Trace(span_events() if events is None else events,
                           window_s=1e-6, units=units)


def span_run(**kw):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(host=span_host(**kw)), extras=None)


def reader(name):
    return load_module(reader_path(name), "t_" + name.replace(".", "_"))


def test_spans_self_time_and_credit():
    sp = Spans(span_host())
    assert sp.count("ptgs.shade") == 1 and sp.count("ptgs.lights") == 1
    assert sp.device_s("ptgs.bin") == pytest.approx(30e-9)
    assert sp.device_s("ptgs.shade") == pytest.approx(140e-9)
    assert sp.device_s("ptgs.shade", self_only=True) == pytest.approx(
        40e-9)
    assert sp.device_s("ptgs.lights") == pytest.approx(40e-9)
    assert sp.device_s("ptgs.vis") == pytest.approx(60e-9)
    credit = dict(zip(sp.op_names, sp.credit.tolist()))
    name = {c: sp.name[c] for c in credit.values() if c >= 0}
    assert name[credit["radixSortKVInPlace"]] == "ptgs.lights"
    assert name[credit["grid_march_kernel<false, 2>"]] == "ptgs.vis"
    assert name[credit["Memcpy DtoH (Device -> Pageable)"]] == "ptgs.shade"
    # Launched outside every span: none. No launch: unjoined.
    assert credit["k_outside"] == NONE
    assert credit["indexing_backward_kernel"] == NONE
    assert credit["orphan"] == UNJOINED
    assert credit["Memset (Device)"] == UNJOINED
    # Every op goes to exactly one span, none or unjoined.
    parts = sum(sp.device_s(n, self_only=True) for n in set(sp.name))
    rest = sp.op_ns[sp.credit < 0].sum() * 1e-9
    assert parts + rest == pytest.approx(sp.op_ns.sum() * 1e-9)


def test_spans_gaps_by_midpoint():
    """Gaps [40, 90) in bin, [100, 215) between spans, [245, 262) in
    lights, [302, 405) and [465, 500) in shade itself, [510, 705) and
    [735, 740) after shade's end."""
    sp = Spans(span_host())
    assert sorted(sp.gap_ns.tolist()) == [5, 17, 35, 50, 103, 115, 195]
    assert sp.gap_s("ptgs.bin") == pytest.approx(50e-9)
    assert sp.gap_s("ptgs.lights") == pytest.approx(17e-9)
    assert sp.gap_s("ptgs.shade") == pytest.approx(155e-9)
    assert sp.gap_s("ptgs.vis") == 0


def test_span_readers():
    run = span_run()
    assert reader("bin_ms.fit").read(run) == pytest.approx(1.5e-5)
    assert reader("bin_gap_ms.fit").read(run) == pytest.approx(2.5e-5)
    assert reader("bin_ms.interact").read(run) == pytest.approx(3e-5)
    assert reader("shade_ms.capture").read(run) == pytest.approx(2e-5)
    assert reader("light_sample_ms.capture").read(run) == pytest.approx(
        2e-5)
    assert reader("shade_gap_ms.capture").read(run) == pytest.approx(
        7.75e-5)


SPAN_READERS = ("bin_ms.fit", "bin_gap_ms.fit", "bin_ms.interact",
                "shade_ms.capture", "light_sample_ms.capture",
                "shade_gap_ms.capture", "shaded_alive_share.capture")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_without_a_segment(name):
    """None without a trace, without a host segment, with no units of the
    metric's kind, or with no span of its name (a program that records
    none)."""
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_gaussiansplatting_tpu_torch.utils import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rays_shaded", 8)
        profiling.count("rays_alive", 2)
    try:
        r = reader(name)
        no_host = types.SimpleNamespace(trace=span_host())
        for run in (types.SimpleNamespace(trace=None), no_host,
                    span_run(units={})):
            assert r.read(run) is None
        assert r.read(span_run()) is not None
        bare = [e for e in span_events() if not e.name().startswith("ptgs.")]
        assert r.read(span_run(events=bare)) is None
    finally:
        profiling.reset_counts()


def test_shaded_alive_share():
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_gaussiansplatting_tpu_torch.utils import profiling
    r = reader("shaded_alive_share.capture")
    profiling.reset_counts()
    assert r.read(span_run()) is None        # no counter recorded
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rays_shaded", 8)
        profiling.count("rays_alive", torch.tensor([True, False, True]))
    try:
        assert r.read(span_run()) == pytest.approx(25.0)
    finally:
        profiling.reset_counts()
