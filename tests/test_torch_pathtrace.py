"""The port's path tracer vs the JAX package (CPU): one sample of
pathtrace, pathtrace_camera, both pose renderers, with the same keys; the
backend protocol and its failures; and the reference's path-tracing
physics checks (tests/test_pathtrace.py, tests/test_materials.py) run on
the port."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import rng as jrng
from pathtracer_gaussiansplatting_tpu.core.camera import (
    generate_rays as j_generate_rays,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
    make_punctual_lights as j_make_punctual_lights,
)
from pathtracer_gaussiansplatting_tpu.data import capture as jcap
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops.binning import (
    BinningConfig as JBinningConfig,
)
from pathtracer_gaussiansplatting_tpu.render import lights as jl
from pathtracer_gaussiansplatting_tpu.render import pathtrace as jpt
from pathtracer_gaussiansplatting_tpu_torch.core import rng as trng
from pathtracer_gaussiansplatting_tpu_torch.core import types as ttypes
from pathtracer_gaussiansplatting_tpu_torch.core.camera import generate_rays
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    Rays, RenderSettings, make_punctual_lights, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.data import capture as tcap
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.render import lights as tl
from pathtracer_gaussiansplatting_tpu_torch.render import pathtrace as tpt
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe

from torch_parity import (
    ATOL, CPU, RTOL, TORCH_THREADS, assert_close, assert_image_close, cameras,
    np_of, share_outside, to_torch_key, to_torch_lights, to_torch_scene,
    to_torch_tables,
)

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
KW = dict(max_depth=4, rr_start_depth=2, opaque_depth=3,
          ambient=(0.05, 0.05, 0.06, 1.0))


@pytest.fixture(scope="module")
def world():
    n = 400
    js = j_random_cloud(n, seed=13, spread=1.2, scale_range=(-1.8, -0.8),
                        emissive_frac=0.05)
    i = jnp.arange(n)
    js = js.replace(transmission=jnp.where(i % 7 == 0, 0.8, 0.0),
                    clearcoat=jnp.where(i % 5 == 0, 0.7, 0.0))
    jp = j_make_punctual_lights(position=[[0.5, 2.0, 2.5]], intensity=[8.0],
                                light_type=[0])
    jcam, tcam = cameras(width=W, height=H)
    return dict(js=js, ts=to_torch_scene(js), jp=jp, tp=to_torch_lights(jp),
                jcam=jcam, tcam=tcam, jkey=jax.random.PRNGKey(13),
                tkey=trng.prng_key(13))


@pytest.mark.parametrize("variant", ["full", "no_nee", "punctual_only"])
def test_pathtrace_sample_matches(world, variant):
    """One sample: depth 4 with roulette and adaptive depth, emissive and
    punctual lights; NEE off (depth 3); punctual lights alone (depth 2)."""
    kw = dict(KW)
    js, ts = world["js"], world["ts"]
    if variant == "no_nee":
        kw.update(nee=False, max_depth=3)
    if variant == "punctual_only":
        kw.update(max_depth=2)
        js = js.replace(emission=jnp.zeros_like(js.emission))
        ts = ts.replace(emission=torch.zeros_like(ts.emission))
    want = jpt.pathtrace(js, j_generate_rays(world["jcam"]),
                         JRenderSettings(**kw), world["jkey"],
                         punctual=world["jp"])
    got = tpt.pathtrace(ts, generate_rays(world["tcam"]),
                        RenderSettings(**kw), world["tkey"],
                        punctual=world["tp"])
    assert_image_close(got, want, f"pathtrace {variant}")
    assert float(got.mean()) > 0.01


def test_thin_surfel_divergence_grows_with_depth():
    """ROADMAP section 3: on the surface scene's thin surfels (normal sigma
    ~0.01 against distances ~1) the quadratic cancels, one ulp in a ray
    flips Gaussians at the alpha cutoffs, and every bounce adds such rays:
    the packages agree on nearly every pixel at depth 1 and on fewer at
    depth 4, while the image mean holds."""
    from pathtracer_gaussiansplatting_tpu.core.camera import (
        Camera as JCamera, look_at as j_look_at,
    )
    from pathtracer_gaussiansplatting_tpu.models.scene import (
        surface_scene as j_surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )

    js = j_surface_scene(2000, seed=13)
    ts = to_torch_scene(js)
    jp = j_make_punctual_lights(position=[[0.6, 0.9, -0.4]], intensity=[4.0],
                                light_type=[0])
    eye, target = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
    jr = j_generate_rays(JCamera(c2w=j_look_at(eye, target), fov_y_deg=60.0,
                                 width=W, height=H))
    tr = generate_rays(Camera(c2w=look_at(eye, target, device=CPU),
                              fov_y_deg=60.0,
                              width=W, height=H))
    shares = []
    for depth in (1, 4):
        kw = dict(KW, max_depth=depth)
        want = jpt.pathtrace(js, jr, JRenderSettings(**kw), jax.random.PRNGKey(
            13), punctual=jp)
        got = tpt.pathtrace(ts, tr, RenderSettings(**kw), trng.prng_key(13),
                            punctual=to_torch_lights(jp))
        shares.append(share_outside(got, want, RTOL, ATOL))
        mean_abs = float(np.abs(np_of(got) - np_of(want)).mean())
        print(f"surface scene, depth {depth}: {shares[-1]:.4%} of pixels "
              f"outside, mean abs diff {mean_abs:.3e}")
        assert mean_abs <= 0.01 * float(np.asarray(want).mean())
    assert shares[0] <= 0.02 and shares[1] <= 0.10


def test_glass_paths_past_opaque_depth_match():
    """The bench's depth-12 shape, cut to depth 8 with opaque_depth 2, on
    the surface scene lit by its emissive panel: past opaque_depth only
    glass-first paths bounce on, so going from depth 2 to depth 8 changes
    some pixels but not most. Held to the JAX package with the thin-surfel
    test's deep gates."""
    from pathtracer_gaussiansplatting_tpu.core.camera import (
        Camera as JCamera, look_at as j_look_at,
    )
    from pathtracer_gaussiansplatting_tpu.models.scene import (
        surface_scene as j_surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )

    js = j_surface_scene(2000, seed=13)
    ts = to_torch_scene(js)
    eye, target = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
    jr = j_generate_rays(JCamera(c2w=j_look_at(eye, target), fov_y_deg=60.0,
                                 width=W, height=H))
    tr = generate_rays(Camera(c2w=look_at(eye, target, device=CPU),
                              fov_y_deg=60.0, width=W, height=H))
    kw = dict(max_depth=8, opaque_depth=2, ambient=(0.05, 0.05, 0.06, 1.0))
    want = jpt.pathtrace(js, jr, JRenderSettings(**kw),
                         jax.random.PRNGKey(13))
    got = tpt.pathtrace(ts, tr, RenderSettings(**kw), trng.prng_key(13))
    share = share_outside(got, want, RTOL, ATOL)
    mean_abs = float(np.abs(np_of(got) - np_of(want)).mean())
    print(f"surface scene, depth 8, opaque_depth 2: {share:.4%} of pixels "
          f"outside, mean abs diff {mean_abs:.3e}")
    assert np.isfinite(np_of(got)).all()
    assert share <= 0.10
    assert mean_abs <= 0.01 * float(np.asarray(want).mean())
    shallow = tpt.pathtrace(ts, tr, RenderSettings(**dict(kw, max_depth=2)),
                            trng.prng_key(13))
    deeper = float((got != shallow).any(-1).double().mean())
    assert 0.0 < deeper < 0.5, deeper


def test_pathtrace_on_reference_tables(world):
    """The JAX light tables carried across give the same sample as the
    port's own tables."""
    jt = jl.build_light_tables(world["js"], world["jp"])
    rays = generate_rays(world["tcam"])
    settings = RenderSettings(**dict(KW, max_depth=2))
    a = tpt.pathtrace(world["ts"], rays, settings, world["tkey"],
                      tables=to_torch_tables(jt), punctual=world["tp"])
    b = tpt.pathtrace(world["ts"], rays, settings, world["tkey"],
                      punctual=world["tp"])
    assert_close(a, b, 1e-5, 1e-6)


def test_pathtrace_camera_matches(world):
    """The tile pass gives the primary hit (the reference's kernel runs as
    its own tests run it on the CPU); bounces in tile-major order."""
    jcfg, tcfg = JBinningConfig(max_per_tile=128), BinningConfig(
        max_per_tile=128)
    jit = np.random.default_rng(1).uniform(0, 1, (H, W, 2)).astype(
        np.float32)
    want = jpt.pathtrace_camera(
        world["js"], world["jcam"], JRenderSettings(**KW), world["jkey"],
        punctual=world["jp"], config=jcfg, jitter=jnp.asarray(jit))
    got = tpt.pathtrace_camera(
        world["ts"], world["tcam"], RenderSettings(**KW), world["tkey"],
        punctual=world["tp"], config=tcfg, jitter=torch.from_numpy(jit))
    assert got.shape == (H * W, 3)
    assert_image_close(got, want, "pathtrace_camera")


def test_flat_route_matches(world):
    """make_accumulating_renderer + render_pose, 2 spp, in chunks of 500
    rays: the random numbers follow each ray's index in its chunk."""
    jset, tset = JRenderSettings(**KW), RenderSettings(**KW)
    jrender = jcap.make_accumulating_renderer(world["js"], jset, world["jp"],
                                              2, backend="dense")
    trender = tcap.make_accumulating_renderer(world["ts"], tset, world["tp"],
                                              2, backend="dense")
    want = jcap.render_pose(jrender, world["jcam"].c2w, W, H, 50.0,
                            chunk=500)
    got = tcap.render_pose(trender, world["tcam"].c2w, W, H, 50.0,
                           chunk=500)
    assert got.shape == (H, W, 3)
    assert_image_close(got, want, "flat route, 2 spp")
    # The chunk is part of the result: one chunk gives another image.
    one = tcap.render_pose(trender, world["tcam"].c2w, W, H, 50.0,
                           chunk=H * W)
    assert float((one - got).abs().max()) > 1e-3


def test_tiled_route_matches(world, tmp_path):
    jset, tset = JRenderSettings(**KW), RenderSettings(**KW)
    jrender = jcap.make_tiled_pose_renderer(
        world["js"], jset, world["jp"], 2, bounce_backend="dense",
        binning_config=JBinningConfig(max_per_tile=128))
    trender = tcap.make_tiled_pose_renderer(
        world["ts"], tset, world["tp"], 2, bounce_backend="dense",
        binning_config=BinningConfig(max_per_tile=128))
    want = jrender(world["jcam"].c2w, W, H, 50.0)
    stats = {}
    got = trender(world["tcam"].c2w, W, H, 50.0, stats_out=stats)
    assert got.shape == (H, W, 3)
    assert_image_close(got, want, "tiled route, 2 spp")
    assert stats["frozen_alive"] == 0.0 and "tile_overflow" in stats
    # A mid-pose checkpoint after the first sample, a crash, a resume: the
    # same bits as the uninterrupted pose, and the state file removed.
    state = str(tmp_path / "pose.npz")
    assert trender(world["tcam"].c2w, W, H, 50.0, state_path=state,
                   checkpoint_every=1, stop_after_segments=1) is None
    resumed = trender(world["tcam"].c2w, W, H, 50.0, state_path=state,
                      checkpoint_every=1)
    assert torch.equal(resumed, got) and not os.path.exists(state)


def test_interaction_from_tiles_matches(world):
    rng = np.random.default_rng(2)
    feats = rng.uniform(0, 1, (H, W, 14)).astype(np.float32)
    alpha = rng.uniform(0, 1, (H, W)).astype(np.float32)
    alpha[0] = 0.0
    depth = rng.uniform(0.5, 5, (H, W)).astype(np.float32)
    jr, tr = j_generate_rays(world["jcam"]), generate_rays(world["tcam"])
    jset, tset = JRenderSettings(), RenderSettings()
    want = jpt.interaction_from_tiles(
        dict(feats=jnp.asarray(feats), alpha_acc=jnp.asarray(alpha),
             depth=jnp.asarray(depth)), jr, jset)
    got = tpt.interaction_from_tiles(
        dict(feats=torch.from_numpy(feats), alpha_acc=torch.from_numpy(alpha),
             depth=torch.from_numpy(depth)), tr, tset)
    tile = tpt.interaction_from_tile_arrays(
        dict(tile_feats=torch.from_numpy(feats),
             tile_alpha=torch.from_numpy(alpha),
             tile_depth=torch.from_numpy(depth)),
        tr.origins, tr.directions, tset)
    for k in want:
        assert_close(got[k], want[k], 1e-5, 1e-6, err_msg=k)
        assert torch.equal(tile[k], got[k])


def test_ray_uniform_and_lights_carry_across():
    key = jax.random.PRNGKey(7)
    for dim, num in ((7, 1), (8, 2), (20, 1)):
        got = np_of(trng.ray_uniform(to_torch_key(jax.random.fold_in(key, 3)),
                                     100, dim, num, CPU))
        want = np.asarray(jrng.ray_uniform(jax.random.fold_in(key, 3), 100,
                                           dim, num))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    args = dict(position=[[0, 1, 2], [3, 4, 5]], intensity=[2.0, 3.0],
                light_type=[1, 2])
    got = make_punctual_lights(**args, device=CPU)
    want = j_make_punctual_lights(**args)
    carried = to_torch_lights(want)
    for f in ttypes.PUNCTUAL_FIELDS:
        assert np.array_equal(np_of(getattr(got, f)),
                              np.asarray(getattr(want, f)))
        assert getattr(carried, f).dtype == getattr(got, f).dtype
    assert got.light_type.dtype == torch.int32
    assert make_punctual_lights(device=CPU).num_lights == 0


def test_backend_protocol_and_failures(world):
    backend = tpipe.make_trace_backend(world["ts"], RenderSettings(), "auto")
    assert isinstance(backend, tpipe.TraceBackend)
    assert backend.name == "dense" and backend.accel is None
    grid = tpipe.make_trace_backend(world["ts"], RenderSettings(), "grid")
    assert grid.name == "grid" and grid.accel is not None
    with pytest.raises(ValueError, match="accel=<mesh>"):
        tpipe.make_trace_backend(world["ts"], RenderSettings(), "spatial")
    with pytest.raises(ValueError, match="unknown backend"):
        tpipe.make_trace_backend(world["ts"], RenderSettings(), "bvh")
    assert tpipe.AUTO_DENSE_LIMIT == 50_000
    assert tcap.CAPTURE_SEED == jcap.CAPTURE_SEED
    n = tpipe.AUTO_DENSE_LIMIT + 1
    for backend, count in (("auto", 10), ("auto", n), ("tiled+dense", 10)):
        assert tcap.resolve_backend(backend, count) == \
            jcap.resolve_backend(backend, count)


def test_port_path_tracer_imports_without_jax():
    code = ("import sys\n"
            "import pathtracer_gaussiansplatting_tpu_torch.render.pathtrace\n"
            "import pathtracer_gaussiansplatting_tpu_torch.data.capture\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the reference's physics checks, on the port ----------------------

KEY = trng.prng_key(13)


def wall_scene(albedo=(0.8, 0.8, 0.8), emissive=None, extra=None,
               transmission=None):
    """tests/test_pathtrace.py's wall: a flat white surfel at z = 0, plus an
    optional emitter and extra Gaussians."""
    means, scales = [[0.0, 0.0, 0.0]], [[3.0, 3.0, 0.01]]
    quats, opac, colors, emission = [[1.0, 0, 0, 0]], [9.0], [list(albedo)], \
        [[0.0, 0, 0]]
    if emissive is not None:
        means.append(emissive["mean"])
        scales.append(emissive.get("scales", [0.3, 0.3, 0.01]))
        quats.append([1.0, 0, 0, 0])
        opac.append(9.0)
        colors.append([0, 0, 0])
        emission.append(emissive["emission"])
    for g in extra or ():
        means.append(g["mean"])
        scales.append(g["scales"])
        quats.append([1.0, 0, 0, 0])
        opac.append(9.0)
        colors.append([0.5, 0.5, 0.5])
        emission.append([0, 0, 0])
    return make_scene(means=means, log_scales=np.log(scales), quats=quats,
                      opacity_logits=opac, colors=colors, emission=emission,
                      roughness=np.ones(len(means)), device=CPU)


def down_rays(n=4, z=2.0, span=0.2):
    xs = np.linspace(-span, span, n, dtype=np.float32)
    o = np.stack([xs, np.zeros(n, np.float32), np.full(n, z, np.float32)], -1)
    d = np.tile(np.array([0, 0, -1.0], np.float32), (n, 1))
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


def test_sky_only():
    scene = wall_scene().replace(opacity_logits=torch.full((1,), -20.0))
    out = tpt.pathtrace(scene, down_rays(), RenderSettings(
        max_depth=2, ambient=(0.2, 0.3, 0.4, 1.0)), KEY)
    np.testing.assert_allclose(np_of(out), np.tile([0.4, 0.6, 0.8], (4, 1)),
                               atol=5e-3)


def test_direct_emission():
    scene = wall_scene(emissive=dict(mean=[0, 0, 0.5], scales=[3, 3, 0.01],
                                     emission=[2.0, 1.0, 0.5]))
    out = tpt.pathtrace(scene, down_rays(),
                        RenderSettings(max_depth=1, nee=False), KEY)
    np.testing.assert_allclose(np_of(out), np.tile([2.0, 1.0, 0.5], (4, 1)),
                               rtol=0.05)


def test_nee_point_light_analytic():
    rho, h, intensity = 0.8, 2.0, 10.0
    pl = make_punctual_lights(position=[[0, 0, h]], intensity=[intensity],
                              light_type=[0], color=[[1, 1, 1]], device=CPU)
    out = tpt.pathtrace(wall_scene(albedo=(rho,) * 3), down_rays(1, span=0),
                        RenderSettings(max_depth=1, ambient=(0, 0, 0, 1.0)),
                        KEY, punctual=pl)
    np.testing.assert_allclose(np_of(out)[0], rho / np.pi * intensity / h ** 2,
                               rtol=0.1)


def test_shadowing():
    pl = make_punctual_lights(position=[[2.0, 0, 2.0]], intensity=[10.0],
                              light_type=[0], device=CPU)
    settings = RenderSettings(max_depth=1, ambient=(0, 0, 0, 1.0))
    lit = tpt.pathtrace(wall_scene(), down_rays(1, span=0), settings, KEY,
                        punctual=pl)
    blocked = tpt.pathtrace(
        wall_scene(extra=[dict(mean=[1.0, 0, 1.0], scales=[0.6, 0.6, 0.01])]),
        down_rays(1, span=0), settings, KEY, punctual=pl)
    assert float(blocked[0, 0]) < 0.1 * float(lit[0, 0])


def test_mis_consistency_nee_vs_bsdf():
    """NEE and BSDF-only estimators converge to the same mean (600
    samples of one ray)."""
    scene = wall_scene(emissive=dict(mean=[0.8, 0.0, 1.2],
                                     scales=[0.4, 0.4, 0.01],
                                     emission=[8.0, 8.0, 8.0]))
    rays = down_rays(600, span=0)   # 600 rays: 600 independent samples

    def avg(nee):
        return np_of(tpt.pathtrace(scene, rays, RenderSettings(
            max_depth=2, nee=nee), KEY)).mean(0)

    with_nee, no_nee = avg(True), avg(False)
    assert with_nee[0] > 0.005
    np.testing.assert_allclose(with_nee, no_nee, rtol=0.35)


def test_firefly_clamp():
    scene = wall_scene(emissive=dict(mean=[0, 0, 0.5], scales=[3, 3, 0.01],
                                     emission=[100.0] * 3))
    out = tpt.pathtrace(scene, down_rays(), RenderSettings(
        max_depth=1, nee=False, firefly_clamp=5.0), KEY)
    assert float(out.max()) <= 5.0 + 1e-5


def _panels(transmission=0.0):
    """tests/test_materials.py's scene: an emissive panel at z = -4 behind
    a (possibly glass) panel at z = 0, 8x8 surfels each."""
    xs = (np.arange(8) + 0.5) / 8 * 4 - 2
    xx, yy = np.meshgrid(xs, xs)
    grid = np.stack([xx.ravel(), yy.ravel()], -1)
    means = np.concatenate([np.c_[grid, np.zeros(64)],
                            np.c_[grid, np.full(64, -4.0)]])
    return make_scene(
        means=means, log_scales=np.tile(np.log([0.3, 0.3, 0.01]), (128, 1)),
        quats=np.tile([1.0, 0, 0, 0], (128, 1)),
        opacity_logits=np.full(128, 9.0),
        colors=np.r_[np.tile([0.6, 0.6, 0.6], (64, 1)), np.ones((64, 3))],
        emission=np.r_[np.zeros((64, 3)), np.full((64, 3), 6.0)],
        roughness=np.full(128, 0.8),
        transmission=np.r_[np.full(64, transmission), np.zeros(64)],
        device=CPU)


def _panel_rays():
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )

    return generate_rays(Camera(c2w=look_at((0.0, 0.0, 3.0), (0, 0, -4.0),
                                            device=CPU),
                                fov_y_deg=30.0, width=8, height=8))


def test_glass_panel_passes_light():
    settings = RenderSettings(max_depth=4, max_contribs=48,
                              ambient=(0.0, 0.0, 0.0, 1.0))

    def mean_radiance(transmission):
        scene = _panels(transmission)
        return float(np.mean([np_of(tpt.pathtrace(
            scene, _panel_rays(), settings, trng.fold_in(
                trng.prng_key(3), f))).mean() for f in range(8)]))

    assert mean_radiance(0.95) > 1.5 * mean_radiance(0.0)


def test_adaptive_depth_kills_opaque_paths():
    kw = dict(max_depth=6, max_contribs=48, ambient=(0.3, 0.3, 0.3, 1.0))
    scene, rays, key = _panels(), _panel_rays(), trng.prng_key(5)
    deep = tpt.pathtrace(scene, rays, RenderSettings(**kw), key)
    capped = tpt.pathtrace(scene, rays, RenderSettings(opaque_depth=1, **kw),
                           key)
    assert float(capped.mean()) < float(deep.mean()) + 1e-6


def test_accumulate_streaming_mean():
    xs = np.random.default_rng(13).normal(size=(10, 4, 3)).astype(np.float32)
    acc = torch.zeros(4, 3)
    for i, x in enumerate(xs):
        acc = tpt.accumulate(acc, torch.from_numpy(x), i)
    np.testing.assert_allclose(np_of(acc), xs.mean(0), atol=1e-5)


def test_light_tables_stay_on_device(world):
    """The bounce loop reads no table value on the host: every table entry
    is a tensor."""
    tables = tl.build_light_tables(world["ts"], world["tp"])
    assert all(isinstance(getattr(tables, f), torch.Tensor)
               for f in tables.__dataclass_fields__)
