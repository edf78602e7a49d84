"""The dense backend's spans and counters (utils/profiling.span, count) on
the CPU under ``torch.profiler``: the bounce trace ``ptgs.trace`` on every
backend, the top-K ``ptgs.topk`` and the gathers ``ptgs.gather`` inside
it, the shadow rays ``ptgs.dense_vis`` inside ``ptgs.vis``; the list
counters against the list the trace returned; the image bit for bit the
same with the profiler on or off; and the capture's route for a scene of
the dense cell's size."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_gaussiansplatting_tpu_torch.core import rng
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays, look_at,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
    make_accumulating_renderer, render_pose, resolve_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
    surface_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.render import pathtrace as tpt
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
SIZE, DEPTH, CHUNK = 32, 3, 512


@pytest.fixture(scope="module")
def room():
    scene = surface_scene(2000, device=CPU)
    settings = RenderSettings(max_depth=DEPTH, rr_start_depth=2,
                              ambient=(0.05, 0.05, 0.06, 1.0))
    c2w = look_at((0.3, 0.1, 1.2), (0.0, -0.2, 0.0), device=CPU)
    return dict(scene=scene, settings=settings, c2w=c2w)


def recorded(run):
    """(run's result, [(name, start ns, end ns)] of the ranges it recorded
    under a CPU profiler, in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, sorted(spans, key=lambda s: s[1])


def within(spans, inner: str, outer: str) -> bool:
    """Whether every ``inner`` range lies inside some ``outer`` range."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in spans if n == inner)


def overlap(spans, a: str, b: str) -> bool:
    return any(s0 < e1 and s1 < e0
               for n0, s0, e0 in spans if n0 == a
               for n1, s1, e1 in spans if n1 == b)


def flat_pose(room):
    """One pose of the capture's flat renderer on the dense backend, 2
    samples, in chunks of CHUNK rays."""
    render = make_accumulating_renderer(room["scene"], room["settings"],
                                        None, spp=2, backend="dense")
    return render_pose(render, room["c2w"], SIZE, SIZE, 50.0, chunk=CHUNK)


def test_dense_spans_nest(room):
    """A trace a bounce (the camera trace too) for each chunk-sample, its
    top-K and gathers inside it; a dense shadow march inside each
    shadow-ray range, none inside a trace; the trace outside the
    shading."""
    img, spans = recorded(lambda: flat_pose(room))
    got = [n for n, _, _ in spans]
    chunk_samples = 2 * (SIZE * SIZE // CHUNK)
    assert got.count("ptgs.trace") == DEPTH * chunk_samples
    assert got.count("ptgs.topk") == got.count("ptgs.gather") \
        == got.count("ptgs.trace")
    assert got.count("ptgs.dense_vis") == got.count("ptgs.vis") \
        == DEPTH * chunk_samples
    assert within(spans, "ptgs.topk", "ptgs.trace")
    assert within(spans, "ptgs.gather", "ptgs.trace")
    assert within(spans, "ptgs.dense_vis", "ptgs.vis")
    assert within(spans, "ptgs.vis", "ptgs.shade")
    assert not overlap(spans, "ptgs.trace", "ptgs.shade")
    assert not overlap(spans, "ptgs.topk", "ptgs.gather")
    assert img.shape == (SIZE, SIZE, 3)


def test_list_counters_match_the_list(room):
    """dense_rays R, dense_list_slots R x K and dense_list_filled the
    entries with alpha > 0 of the list the top-K returned, with and
    without an active mask."""
    cam = Camera(c2w=room["c2w"], fov_y_deg=50.0, width=SIZE, height=SIZE)
    rays = generate_rays(cam)
    active = torch.arange(rays.num_rays) % 3 > 0
    settings = room["settings"]
    k = settings.max_contribs
    profiling.reset_counts()
    lists = []

    def run():
        for mask in (None, active):
            lists.append(ref.dense_topk(room["scene"], rays, settings,
                                        active=mask)[2])

    _, spans = recorded(run)
    got = profiling.counts()
    profiling.reset_counts()
    r = rays.num_rays
    assert [n for n, _, _ in spans].count("ptgs.topk") == 2
    assert got["dense_rays"] == 2 * r
    assert got["dense_list_slots"] == 2 * r * k
    filled = sum(int((a > 0).sum()) for a in lists)
    assert got["dense_list_filled"] == filled
    assert 0 < int((lists[1] > 0).sum()) < int((lists[0] > 0).sum())


def test_counters_cost_nothing_untraced(room):
    """Without a profiler the top-K counts nothing, and the filled count's
    device work is never made."""
    cam = Camera(c2w=room["c2w"], fov_y_deg=50.0, width=8, height=8)
    profiling.reset_counts()
    ref.dense_topk(room["scene"], generate_rays(cam), room["settings"])
    assert profiling.counts() == {}
    made = []
    profiling.count("x", lambda: made.append(1) or 3)
    assert made == [] and profiling.counts() == {}


def test_grid_bounce_trace_is_a_trace_span(room):
    """On the grid backend of the tiled capture sample the bounce traces
    (depth - 1; the tile pass gives the first hit) are ``ptgs.trace``
    ranges, each holding the backend's whole call and none inside the
    shading, whose ranges hold no trace."""
    base = make_trace_backend(room["scene"], room["settings"], "grid",
                              max_per_cell=32)

    def trace(*a, **kw):
        with torch.profiler.record_function("test.backend_trace"):
            return base.trace(*a, **kw)

    backend = dataclasses.replace(base, trace=trace)
    cam = Camera(c2w=room["c2w"], fov_y_deg=50.0, width=SIZE, height=SIZE)
    _, spans = recorded(lambda: tpt.pathtrace_camera(
        room["scene"], cam, room["settings"], rng.prng_key(3),
        backend=backend))
    got = [n for n, _, _ in spans]
    assert got.count("ptgs.trace") == got.count("test.backend_trace") \
        == DEPTH - 1
    assert got.count("ptgs.shade") == DEPTH
    assert within(spans, "test.backend_trace", "ptgs.trace")
    assert not overlap(spans, "ptgs.trace", "ptgs.shade")
    assert "ptgs.topk" not in got and "ptgs.dense_vis" not in got


def test_dense_image_bit_equal_with_profiler(room):
    plain = flat_pose(room)
    traced, _ = recorded(lambda: flat_pose(room))
    profiling.reset_counts()
    assert torch.equal(plain, traced)


def test_dense_cells_scene_takes_the_dense_route():
    """The capture's route 'auto' for a scene of the dense capture cell's
    size (cellbench's surface40k: 40,000 Gaussians) is the dense route, as
    for the downstream loop's fitted scene (39,734)."""
    assert resolve_backend("auto", 40000) == "dense"
    assert resolve_backend("auto", 39734) == "dense"
    assert resolve_backend("auto", 500000) == "tiled+grid"
