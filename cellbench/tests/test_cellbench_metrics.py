"""The metric arithmetic against hand counts, and the tile kernels'
operation count against the port's ``bench.tile_bounds``."""
import types

import numpy as np
import pytest
import torch

from cellbench import trace as trace_mod
from cellbench.metrics import _tilecount
from cellbench.reference import tiles as ref_tiles
from cellbench.reference import types as ref_types
from cellbench.run import load_module, reader_path
from cellbench.scenes import random_cloud

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


def toy_trace():
    # Device: two overlapping kernels [0, 30) and [10, 40), a gap, a
    # hand kernel [100, 150), a copy [150, 160), a gap, [300, 310).
    events = [
        Ev("elementwise_kernel", CUDA, 1000, 30),
        Ev("elementwise_kernel", CUDA, 1010, 30),
        Ev("void grid_march_kernel<true, 3>", CUDA, 1100, 50),
        Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 1150, 10),
        Ev("indexing_backward_kernel", CUDA, 1300, 10),
        Ev("ptgs.shade", CUDA, 1000, 400),         # a range, not device work
        Ev("ptgs.shade", CPU, 990, 5),
        Ev("aten::sort", CPU, 1000, 100),          # covers gap 1 (40-100)
        Ev("aten::item", CPU, 1150, 200),
        Ev("aten::copy_", CPU, 1200, 10),          # innermost at 235
    ]
    return trace_mod.Trace(events, window_s=400e-9,
                           units=dict(samples=2, steps=2, frames=2,
                                      calls=2))


def test_trace_sums():
    tr = toy_trace()
    assert tr.busy_s == pytest.approx(40e-9 + 60e-9 + 10e-9)
    assert tr.kernel_s(lambda n: True) == pytest.approx(120e-9)
    assert tr.kernel_count() == 4
    assert tr.kernel_s(trace_mod.is_hand) == pytest.approx(50e-9)
    assert tr.device_ops(2) == [
        ["elementwise_kernel", pytest.approx(60e-9)],
        ["void grid_march_kernel<true, 3>", pytest.approx(50e-9)]]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::item", pytest.approx(140e-9)]
    assert gaps[1] == ["aten::sort", pytest.approx(60e-9)]


def reader(name):
    return load_module(reader_path(name), "t_" + name.replace(".", "_"))


def test_readers():
    tr = toy_trace()
    run = types.SimpleNamespace(
        trace=tr, extras=None, setup_s=12.5, window_s=2.0,
        units=dict(camera_rays=64_000_000, train_rays=1_280_000,
                   frames=20, calls=20),
        latencies=[0.1 * (i + 1) for i in range(20)])
    assert reader("capture_rays_per_s").read(run) == 32_000_000
    assert reader("fit_rays_per_s").read(run) == 640_000
    assert reader("setup_s").read(run) == 12.5
    assert reader("frame_ms_p95").read(run) == pytest.approx(
        1e3 * np.percentile(run.latencies, 95))
    assert reader("frame_ms_p50.interact").read(run) == pytest.approx(1050)
    # busy 110 ns over the segment's 2 calls against the window's 0.1 s
    idle = 100 * (1 - 55e-9 / 0.1)
    for cell in ("capture", "fit", "interact"):
        assert reader(f"device_idle.{cell}").read(run) == pytest.approx(idle)
    assert reader("launches_per_sample.capture").read(run) == 2
    assert reader("grid_march_ms.capture").read(run) == pytest.approx(
        25e-6)
    assert reader("grid_march_ms.interact").read(run) == pytest.approx(
        25e-6)
    assert reader("elementwise_ms.capture").read(run) == pytest.approx(
        35e-6)
    assert reader("gather_bwd_ms.fit").read(run) == pytest.approx(5e-6)
    # Nothing to read: no trace, or no units of its kind.
    empty = types.SimpleNamespace(trace=None, extras=None, units={},
                                  window_s=1.0, latencies=[])
    for name in ("capture_rays_per_s", "fit_rays_per_s", "frame_ms_p95",
                 "device_idle.fit", "grid_march_ms.capture",
                 "tile_fwd_roofline.fit"):
        assert reader(name).read(empty) is None


def test_roofline_share():
    tr = trace_mod.Trace([Ev("tile_composite_fwd_kernel", CUDA, 0, 400),
                          Ev("tile_composite_bwd_kernel", CUDA, 500, 1000)],
                         window_s=2e-6, units=dict(steps=2))
    driver = types.SimpleNamespace(
        tile_bounds=lambda extras: dict(fwd_s=50e-9, bwd_s=125e-9))
    run = types.SimpleNamespace(trace=tr, extras=[1], driver=driver)
    assert reader("tile_fwd_roofline.fit").read(run) == pytest.approx(25.0)
    assert reader("tile_bwd_roofline.fit").read(run) == pytest.approx(25.0)
    run.extras = None    # no step's inputs kept: nothing to read
    assert reader("tile_fwd_roofline.fit").read(run) is None


def test_reader_by_stem():
    """A metric with no reader of its own takes its stem's; one with its
    own reader takes that."""
    assert reader_path("device_idle.capture").name == "device_idle.py"
    assert reader_path("grid_march_ms.interact").name == "grid_march_ms.py"
    assert reader_path("gather_bwd_ms.fit").name == "gather_bwd_ms.fit.py"


@pytest.mark.parametrize("k", [128, 256])
def test_tile_count_matches_bench(k):
    """The count from the reference's packets equals the port's bench's
    function bound on the port's packets of the same frame."""
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles,
    )
    raw = random_cloud(6000, 2 ** 31 + 7, "cpu", spread=1.5)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    cfg = BinningConfig(max_per_tile=k)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                             device="cpu"), fov_y_deg=50.0, width=48,
                 height=48)
    packets = prepare_tiles(GaussianScene(**raw), cam, settings, cfg)
    dirs, _ = _tile_dirs(cam, cfg)
    want = bench.tile_bounds(packets, dirs, settings)
    got = _tilecount.step_bounds(
        ref_types.GaussianScene(**raw),
        ref_tiles.Camera(ref_tiles.look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                                           "cpu"), 50.0, 48, 48),
        ref_types.RenderSettings(background=(0.1, 0.2, 0.3)),
        ref_tiles.BinningConfig(max_per_tile=k))
    assert got["fwd_s"] * 1e3 == pytest.approx(
        want["fwd"]["function_bound_ms"], rel=1e-6)
    assert got["bwd_s"] * 1e3 == pytest.approx(
        want["bwd"]["function_bound_ms"], rel=1e-6)
