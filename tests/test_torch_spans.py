"""The port's spans and counters (utils/profiling.span, count) on the CPU
under ``torch.profiler``: each range at its layer boundary, as often as its
layer runs; the shaded-rays counter against the alive masks the bounce
loop traces with; nothing recorded, and the results bit for bit the same,
with the profiler on or off."""
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_gaussiansplatting_tpu_torch.core import rng
from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera, look_at
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    RenderSettings, make_punctual_lights,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
    SceneParams, random_cloud,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (
    make_optimizer, make_tiled_train_step,
)
from pathtracer_gaussiansplatting_tpu_torch.render import pathtrace as tpt
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.render.session import (
    InteractiveSession,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")

H, W = 24, 32
DEPTH = 3


@pytest.fixture(scope="module")
def world():
    scene = random_cloud(300, seed=13, spread=1.2, scale_range=(-1.8, -0.8),
                         emissive_frac=0.05, device=CPU)
    lights = make_punctual_lights(position=[[0.5, 2.0, 2.5]],
                                  intensity=[8.0], light_type=[0], device=CPU)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=CPU),
                 fov_y_deg=50.0, width=W, height=H)
    settings = RenderSettings(max_depth=DEPTH, rr_start_depth=2,
                              ambient=(0.05, 0.05, 0.06, 1.0))
    return dict(scene=scene, lights=lights, cam=cam, settings=settings)


def recorded(run):
    """(run's result, [(name, start ns, end ns)] of the ptgs.* ranges it
    recorded under a CPU profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("ptgs.")]
    return out, spans


def names(spans):
    return [n for n, _, _ in spans]


def sample(world, backend=None):
    return tpt.pathtrace_camera(
        world["scene"], world["cam"], world["settings"], rng.prng_key(5),
        punctual=world["lights"], backend=backend)


def test_span_is_a_no_op_without_a_profiler():
    assert isinstance(profiling.span("ptgs.x"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(profiling.span("ptgs.x"),
                              contextlib.nullcontext)


def test_pathtrace_camera_spans(world):
    """One binning, a draw and a shading range a bounce; every light
    sample and shadow ray inside a shading range, one of each for the
    emissive and the punctual strategy a bounce."""
    img, spans = recorded(lambda: sample(world))
    got = names(spans)
    assert got.count("ptgs.bin") == 1
    assert got.count("ptgs.rng") == got.count("ptgs.shade") == DEPTH
    assert got.count("ptgs.lights") == got.count("ptgs.vis") == 2 * DEPTH
    shades = [(s, e) for n, s, e in spans if n == "ptgs.shade"]
    for n, s, e in spans:
        if n in ("ptgs.lights", "ptgs.vis"):
            assert any(s0 <= s and e <= e0 for s0, e0 in shades), n
    assert img.shape == (H * W, 3)


def test_results_bit_equal_with_profiler(world):
    plain = sample(world)
    traced, _ = recorded(lambda: sample(world))
    assert torch.equal(plain, traced)


def fit_step(world, params):
    step = make_tiled_train_step(RenderSettings(background=(0.1, 0.2, 0.3)),
                                 make_optimizer(5e-3), BinningConfig())
    target = torch.full((H, W, 3), 0.4)
    _, _, loss = step(params, make_optimizer(5e-3)(params.parameters()),
                      world["cam"], target)
    return loss


def test_train_step_bins_once(world):
    plain = fit_step(world, SceneParams.from_scene(world["scene"]))
    params = SceneParams.from_scene(world["scene"])
    loss, spans = recorded(lambda: fit_step(world, params))
    assert names(spans).count("ptgs.bin") == 1
    assert torch.equal(loss, plain)


def test_session_bins_after_a_move(world):
    sess = InteractiveSession(world["scene"], world["settings"], width=W,
                              height=H, backend="dense")
    _, first = recorded(sess.step)
    _, still = recorded(sess.step)
    sess.look(12.0, -4.0)
    _, moved = recorded(sess.step)
    assert names(first).count("ptgs.bin") == 1
    assert "ptgs.bin" not in names(still)
    assert names(moved).count("ptgs.bin") == 1
    assert names(still).count("ptgs.shade") == DEPTH


def test_shaded_rays_counter(world):
    """rays_shaded: every ray (R, the tile-major batch with its padding) at
    each bounce past the first; rays_alive: the alive masks the loop
    traces those bounces with."""
    base = make_trace_backend(world["scene"], world["settings"], "dense")
    masks = []

    def trace(scene, rays, settings, active=None):
        if active is not None:
            masks.append((active.numel(), int(active.sum())))
        return base.trace(scene, rays, settings, active=active)

    backend = dataclasses.replace(base, trace=trace)
    profiling.reset_counts()
    sample(world, backend)
    assert profiling.counts() == {} and len(masks) == DEPTH - 1
    masks.clear()
    _, _ = recorded(lambda: sample(world, backend))
    got = profiling.counts()
    profiling.reset_counts()
    r = masks[0][0]
    assert r >= H * W and all(n == r for n, _ in masks)
    assert got["rays_shaded"] == r * (DEPTH - 1)
    assert got["rays_alive"] == sum(a for _, a in masks)
    assert 0 < got["rays_alive"] < got["rays_shaded"]


def test_count_sums_tensors_and_ints():
    profiling.reset_counts()
    profiling.count("a", 3)
    assert profiling.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("a", 3)
        profiling.count("a", 4)
        profiling.count("b", torch.tensor([True, False, True]))
        profiling.count("b", torch.ones(5, dtype=torch.bool))
    assert profiling.counts() == {"a": 7, "b": 7}
    profiling.reset_counts()
    assert profiling.counts() == {}
