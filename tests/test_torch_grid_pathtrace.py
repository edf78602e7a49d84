"""Path tracing through the port's grid backend: one sample against the
JAX package on the CPU, and the tiled pose renderer with grid bounces."""
import jax
import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import (
    Camera as JCamera, generate_rays as j_generate_rays, look_at as j_look_at,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.render import grid_trace as jgt
from pathtracer_gaussiansplatting_tpu.render import pathtrace as jpt
from pathtracer_gaussiansplatting_tpu.render import pipeline as jpipe
from pathtracer_gaussiansplatting_tpu_torch.core.camera import look_at
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt
from pathtracer_gaussiansplatting_tpu_torch.render import pathtrace as tpt
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe

import torch_divergence as div
from torch_parity import (
    CPU, TORCH_THREADS, np_of, share_outside, to_torch_key, to_torch_scene,
)
from utils import random_scene

torch.set_num_threads(TORCH_THREADS)


def test_pathtrace_grid_backend_matches():
    """Two bounces through the grid backend (bounce traces and shadow rays)
    against the JAX package's, on tests/test_grid_trace.py's scene and
    camera, 24x16, one sample."""
    js = random_scene(300, np.random.default_rng(13), spread=1.0)
    ts = to_torch_scene(js)
    ja = jgt.build_grid_accel(js, dims=(16, 16, 16), max_per_cell=128)
    ta = tgt.build_grid_accel(ts, dims=(16, 16, 16), max_per_cell=128)
    rays = j_generate_rays(JCamera(c2w=j_look_at((0, 0.3, 4.0), (0, 0, 0)),
                                   fov_y_deg=45.0, width=24, height=16))
    jset = JRenderSettings(max_contribs=64, max_depth=2,
                           ambient=(0.05, 0.05, 0.05, 1.0))
    tset = RenderSettings(max_contribs=64, max_depth=2,
                          ambient=(0.05, 0.05, 0.05, 1.0))
    jtrace, jvis = jpipe.make_trace_backend(js, jset, "grid", accel=ja)
    key = jax.random.PRNGKey(13)
    want = jpt.pathtrace(js, rays, jset, key, trace_fn=jtrace,
                         visibility_fn=jvis)
    backend = tpipe.make_trace_backend(ts, tset, "grid", accel=ta)
    got = tpt.pathtrace(ts, Rays(torch.from_numpy(np.asarray(rays.origins)),
                                 torch.from_numpy(
                                     np.asarray(rays.directions))),
                        tset, to_torch_key(key), backend=backend)
    share = share_outside(got, want, 1e-3, 3e-4)
    mean_abs = float(np.abs(np_of(got) - np.asarray(want)).mean())
    assert np.isfinite(np_of(got)).all()
    # Bounce rays inherit the march's ~1e-4 differences from the JAX
    # package (test_torch_grid_trace.py: XLA's FMAs); a few may flip a
    # Gaussian at a cutoff and take another path (ROADMAP section 3).
    assert share <= 0.05 and mean_abs <= 1e-3, (share, mean_abs)


def test_bench_depth12_matches():
    """chip_smoke.py phase 10b's setting, the bench's depth-12 workload
    (pathtrace_camera, max_depth 12, opaque_depth 4, the grid backend, the
    2000-Gaussian surface scene lit by its panel, 96x64), and the same
    sample cut at depth 4, against the JAX package (key 1 of
    tests/torch_divergence.py): both depths within its gates; depth 12
    changes the glass-first pixels alone, as many as in the JAX package,
    and what bounces 5-12 add, E = I12 - I4, has the JAX package's mean."""
    imgs = div.images((1,))
    for depth in div.DEPTHS:
        got, want = imgs[depth, 1]
        c = div.compare(got, want)
        print(f"depth {depth}: {c}")
        assert np.isfinite(got).all() and got.shape == (64 * 96, 3)
        assert c["within"] >= div.MIN_SHARE, (depth, c)
        assert c["mean_frac"] <= div.MAX_MEAN_FRAC, (depth, c)
    e = div.extra(imgs[12, 1][0], imgs[4, 1][0], imgs[12, 1][1],
                  imgs[4, 1][1])
    print(e)
    assert 0.0 < e["changed_ref"] < 0.5 and e["frac_ref"] > 0.01, e
    assert abs(e["changed"] - e["changed_ref"]) <= div.CHANGED_DIFF, e
    assert e["rel"] <= div.EXTRA_REL, e


def test_grid_pose_renderer_runs():
    """make_tiled_pose_renderer with grid bounces and a shared accel: a
    finite image, and the frozen count reported."""
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    scene = surface_scene(2000, seed=13, device=CPU)
    settings = RenderSettings(max_depth=2, ambient=(0.05, 0.05, 0.06, 1.0))
    accel = tgt.build_grid_accel(scene)
    render = capture.make_tiled_pose_renderer(
        scene, settings, None, 1, bounce_backend="grid", accel=accel)
    stats = {}
    img = render(look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5), device=CPU),
                 32, 16, 60.0, stats_out=stats)
    assert img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0 and "frozen_alive" in stats


def test_grid_pose_renderer_reports_grid_stats():
    """stats_out carries the grid's truncation stats as grid_<key> under
    the JAX package's key names (its numeric ones, as its capture copies
    them), set from the accel, beside the binning stats."""
    from pathtracer_gaussiansplatting_tpu.models.scene import (
        surface_scene as j_surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data import capture

    js = j_surface_scene(1000, seed=13)
    ts = to_torch_scene(js)
    want = {"grid_" + k: float(v) for k, v in
            jgt.build_grid_accel(js, max_per_cell=32).stats_dict.items()
            if isinstance(v, (int, float))}
    accel = tgt.build_grid_accel(ts, max_per_cell=32)
    render = capture.make_tiled_pose_renderer(
        ts, RenderSettings(max_depth=1), None, 1, bounce_backend="grid",
        accel=accel)
    stats = {}
    for _ in range(2):   # set, not summed, over poses
        render(look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5), device=CPU),
               16, 8, 60.0, stats_out=stats)
    got = {k: v for k, v in stats.items() if k.startswith("grid_")}
    assert set(got) == set(want) and "grid_dropped_frac" in got
    for k, v in accel.stats_dict.items():
        if isinstance(v, (int, float)):
            assert got["grid_" + k] == float(v)
            assert abs(got["grid_" + k] - want["grid_" + k]) <= 1e-6 * max(
                1.0, abs(want["grid_" + k])), k
    assert "frozen_alive" in stats and "grid_dims" not in stats


def test_grid_accuracy_against_dense_matches_reference():
    """benchmarks/grid_accuracy.py's measure (the grid's primary
    interaction against the dense oracle, albedo PSNR) at a reduced size,
    surface_scene(20k) at 64x36, Kc=32: the port's grid sits as far from
    its dense backend as the JAX package's grid from its own, on the
    CPU."""
    from pathtracer_gaussiansplatting_tpu.models.scene import (
        surface_scene as j_surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu.render.reference import (
        trace_dense as j_trace_dense,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
        trace_dense,
    )

    js = j_surface_scene(20_000, seed=13)
    jset = JRenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    tset = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    rays = j_generate_rays(JCamera(
        c2w=j_look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5)), fov_y_deg=60.0,
        width=64, height=36))
    ts = to_torch_scene(js)
    trays = Rays(torch.from_numpy(np.array(rays.origins)),
                 torch.from_numpy(np.array(rays.directions)))

    def psnr(a, b):
        return 10.0 * np.log10(1.0 / np.mean((np_of(a) - np_of(b)) ** 2))

    j_grid = jgt.trace_grid(js, rays, jset,
                            jgt.build_grid_accel(js, max_per_cell=32))
    j_psnr = psnr(j_grid["albedo"], j_trace_dense(js, rays, jset)["albedo"])
    t_grid = tgt.trace_grid(ts, trays, tset,
                            tgt.build_grid_accel(ts, max_per_cell=32))
    t_psnr = psnr(t_grid["albedo"], trace_dense(ts, trays, tset)["albedo"])
    print(f"psnr_albedo grid vs dense: port {t_psnr:.3f} dB, JAX package "
          f"{j_psnr:.3f} dB")
    assert int(t_grid["frozen_alive"]) == int(j_grid["frozen_alive"]) == 0
    assert abs(t_psnr - j_psnr) <= 0.3, (t_psnr, j_psnr)
