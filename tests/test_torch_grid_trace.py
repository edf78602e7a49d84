"""Parity of the port's grid backend with the JAX package on the CPU: the
host binning, the grid tables and the plain march (trace and visibility,
on both batch paths); backend selection. Path tracing through the grid is
in test_torch_grid_pathtrace.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import (
    Camera as JCamera, generate_rays as j_generate_rays, look_at as j_look_at,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.csrc import build as jnative
from pathtracer_gaussiansplatting_tpu.render import grid_trace as jgt
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    Rays, RenderSettings, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.csrc import grid_bin
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe

from torch_parity import (
    CPU, TORCH_THREADS, assert_fill_counts_rows, np_of, to_torch_scene,
)
from utils import random_scene

torch.set_num_threads(TORCH_THREADS)

# The march against the JAX package. XLA on the CPU contracts a * b + c into
# one FMA (jit(a * b + c) equals the FMA on every one of 1e6 random inputs)
# where the port rounds each operation, as its CUDA kernel does; the
# quadratic q = (a t + 2 b) t + c cancels (c ~ (4 / 0.08)^2 = 2.5e3 for a
# sigma 0.08 splat at distance 4), so alpha differs by up to ~1e-4 between
# the packages (8.2e-5 measured on this scene). RTOL / ATOL are 1e-5 / 1e-6
# widened by that, and no further.
RTOL, ATOL = 1e-4, 2e-4
FULL_COV = ((1.0, 8, 24), (1.0, 16, 64), (1.0, 40, 160))


@pytest.fixture(scope="module")
def world():
    """tests/test_grid_trace.py's scene, grid and camera in both
    packages."""
    js = random_scene(300, np.random.default_rng(13), spread=1.0)
    ts = to_torch_scene(js)
    ja = jgt.build_grid_accel(js, dims=(16, 16, 16), max_per_cell=128)
    ta = tgt.build_grid_accel(ts, dims=(16, 16, 16), max_per_cell=128)
    jcam = JCamera(c2w=j_look_at((0, 0.3, 4.0), (0, 0, 0)), fov_y_deg=45.0,
                   width=24, height=16)
    return dict(js=js, ts=ts, ja=ja, ta=ta, rays=j_generate_rays(jcam),
                jset=JRenderSettings(max_contribs=64),
                tset=RenderSettings(max_contribs=64))


def random_rays(seed, r, center=(0.0, 0.0, 0.0), sigma=0.8):
    rng = np.random.default_rng(seed)
    o = (rng.normal(0, sigma, (r, 3)) + center).astype(np.float32)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def assert_sums_close(got, want, name):
    g, w = np_of(got), np_of(want)
    err = np.abs(g - w)
    bad = err > ATOL + RTOL * np.abs(w)
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} outside "
                           f"rtol {RTOL} / atol {ATOL}, max {err.max():.3e}")


def test_grid_bin_matches_numpy_and_reference():
    """The host C++ binning (overflowing cells evict the lowest priority,
    first minimum) and the chebyshev transform against the port's numpy
    versions and the reference's native library."""
    rng = np.random.default_rng(3)
    n, dims = 1500, (9, 7, 8)
    centers = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    exts = rng.uniform(0.02, 0.4, (n, 3)).astype(np.float32)
    prio = rng.uniform(0, 1, n).astype(np.float32)
    prio[::7] = 0.5                      # ties: the first minimum goes
    lo, hi = np.full(3, -1.2, np.float32), np.full(3, 1.2, np.float32)
    got = grid_bin.grid_bin_aniso(centers, exts, prio, dims, lo, hi, 16)
    plain = grid_bin.grid_bin_aniso_plain(centers, exts, prio, dims, lo, hi,
                                          16)
    ref = jnative.grid_bin_aniso(centers, exts, prio, dims, lo, hi, 16)
    assert (got[1] > 16).any()           # eviction ran
    for a, b in ((got, plain), (got, ref)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    occ = got[1] > 30
    cheb = grid_bin.chebyshev_dist(occ, dims, cap=5)
    assert np.array_equal(cheb, grid_bin.chebyshev_dist_plain(occ, dims,
                                                              cap=5))
    assert np.array_equal(cheb, jnative.chebyshev_dist(occ, dims, cap=5))


@pytest.mark.parametrize("dims", [(16, 16, 16), None])
def test_build_grid_accel_matches(world, dims):
    """Fixed and auto-fitted grids: the block table and stats equal, the
    tables within 1e-6 of each column's scale (XLA's FMAs round Q's
    cancelling off-diagonal sums differently)."""
    js, ts = world["js"], world["ts"]
    ja = jgt.build_grid_accel(js, dims=dims, max_per_cell=128)
    ta = tgt.build_grid_accel(ts, dims=dims, max_per_cell=128)
    assert ta.dims == ja.dims and ta.jump_unit == ja.jump_unit
    assert ta.stats == ja.stats
    assert np.array_equal(np_of(ta.btab), np.asarray(ja.btab))
    for name in ("geom", "packet", "lo", "hi"):
        g, w = np_of(getattr(ta, name)), np.asarray(getattr(ja, name))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("max_per_cell", [32, 144])
def test_fill_counts_each_rows_slots(world, max_per_cell):
    """GridAccel.fill, which bounds a cell's work in the wide march
    kernels: each row's filled slots, min(count, Kc), equal to the JAX
    package's count of the same row's Gaussians, every slot at or past it
    zero in geom and packet. The world's 16^3 grid overflows Kc=32 and
    fits Kc=144."""
    dims = (16, 16, 16)
    ja = jgt.build_grid_accel(world["js"], dims=dims,
                              max_per_cell=max_per_cell)
    ta = tgt.build_grid_accel(world["ts"], dims=dims,
                              max_per_cell=max_per_cell)
    overflow = ta.stats_dict["overflow_cell_frac"]
    assert (overflow > 0.0) == (max_per_cell == 32)
    assert_fill_counts_rows(ta.geom, ta.packet, ta.fill, max_per_cell,
                            tgt.G_OPAC)
    jgeom = np.asarray(ja.geom).reshape(ja.geom.shape[0], -1, max_per_cell)
    np.testing.assert_array_equal(np_of(ta.fill),
                                  (jgeom[:, tgt.G_OPAC] > 0).sum(1))
    assert ta.max_fill == int(ta.fill.max())
    assert (ta.max_fill == max_per_cell) == (overflow > 0.0)


def test_march_plain_is_blind_to_zero_slots(world):
    """Where no cell overflows Kc=144, the Kc=256 grid only adds zero
    slots past each row's fill, and march_plain gives the same trans, sums
    and frozen rays bit for bit, trace and shadow segments: the invariant
    that lets the wide kernels stop a cell at its fill."""
    dims = (16, 16, 16)
    a144, a256 = (tgt.build_grid_accel(world["ts"], dims=dims,
                                       max_per_cell=kc) for kc in (144, 256))
    assert a144.stats_dict["overflow_cell_frac"] == 0.0
    assert torch.equal(a144.fill, a256.fill)
    o, d = (torch.from_numpy(x) for x in random_rays(5, 512))
    t_end = torch.from_numpy(np.random.default_rng(11).uniform(
        0.5, 6.0, 512).astype(np.float32))
    settings = RenderSettings()
    for kw in (dict(with_features=True),
               dict(t_end=t_end, with_features=False)):
        got, want = (tgt.march_plain(a, o, d, settings, 64, **kw)
                     for a in (a256, a144))
        assert float(got[0].min()) < 0.5       # the rays cross Gaussians
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


def _trace_both(world, o, d, active=None, **kw):
    jout = jgt.trace_grid(world["js"], JRays(jnp.asarray(o), jnp.asarray(d)),
                          world["jset"], world["ja"],
                          active=None if active is None
                          else jnp.asarray(active), **kw)
    tout = tgt.trace_grid(world["ts"], Rays(torch.from_numpy(o),
                                            torch.from_numpy(d)),
                          world["tset"], world["ta"],
                          active=None if active is None
                          else torch.from_numpy(active), **kw)
    return jout, tout


TRACE_CASES = {
    # name: (rays, active share, trace_grid keywords)
    "camera_default": ("camera", None, dict(max_steps=64)),
    "camera_frozen": ("camera", None, dict(max_steps=1)),
    "compact_default_active": ("random", 0.5,
                               dict(max_steps=64, compact_min=256)),
    "compact_full_cov": ("random", None, dict(max_steps=64, compact_min=256,
                                              schedule=FULL_COV)),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_grid_matches(world, case):
    """The plain march against trace_grid: the default schedule and the
    reference's full-coverage one, with and without an active mask, on the
    single-batch and the compaction path; frozen_alive equal."""
    kind, share, kw = TRACE_CASES[case]
    if kind == "camera":
        o = np.asarray(world["rays"].origins)
        d = np.asarray(world["rays"].directions)
    else:
        o, d = random_rays(5, 512)
    active = None if share is None else \
        np.random.default_rng(7).uniform(size=len(o)) < share
    jout, tout = _trace_both(world, o, d, active, **kw)
    assert int(tout["frozen_alive"]) == int(jout["frozen_alive"])
    if case == "camera_frozen":
        assert int(tout["frozen_alive"]) > 0
    for k in ("alpha_acc", "trans", "albedo", "radiance_emitted",
              "metallic", "roughness"):
        assert_sums_close(tout[k], jout[k], f"{case} {k}")
    hit = np.asarray(jout["alpha_acc"]) > 1e-3
    assert_sums_close(tout["depth"][hit], np.asarray(jout["depth"])[hit],
                      f"{case} depth")
    if active is not None:
        assert float(tout["alpha_acc"][~torch.from_numpy(active)].abs()
                     .max()) == 0.0


VIS_CASES = {
    "camera_default_active": ("camera", 0.6, dict(max_steps=64)),
    "compact_full_cov": ("random", None, dict(max_steps=64, compact_min=128,
                                              schedule=FULL_COV)),
    "compact_default_active": ("random", 0.5,
                               dict(max_steps=64, compact_min=128)),
}


@pytest.mark.parametrize("case", list(VIS_CASES))
def test_visibility_grid_matches(world, case):
    kind, share, kw = VIS_CASES[case]
    if kind == "camera":
        o = np.asarray(world["rays"].origins)
        d = np.asarray(world["rays"].directions)
    else:
        o, d = random_rays(9, 1024)
    rng = np.random.default_rng(11)
    t_end = rng.uniform(0.5, 6.0, len(o)).astype(np.float32)
    active = None if share is None else rng.uniform(size=len(o)) < share
    jv, jf = jgt.visibility_grid(
        world["js"], world["ja"], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_end), world["jset"], return_frozen=True,
        active=None if active is None else jnp.asarray(active), **kw)
    tv, tf = tgt.visibility_grid(
        world["ts"], world["ta"], torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_end), world["tset"], return_frozen=True,
        active=None if active is None else torch.from_numpy(active), **kw)
    assert int(tf) == int(jf)
    assert_sums_close(tv, jv, case)
    assert float(tv.min()) < 0.5   # some segments are shadowed


@pytest.mark.parametrize("max_per_cell", [144, 256])
def test_march_matches_above_128_a_cell(world, max_per_cell):
    """Cells wider than 128 slots (the kernels' wide instantiation on the
    card): on a 4x4x4 grid of the scene, where cells hold more than 128
    Gaussians, the plain march's trace and shadow visibility against the
    JAX package's, frozen counts equal."""
    dims = (4, 4, 4)
    wide = dict(world, ja=jgt.build_grid_accel(world["js"], dims=dims,
                                              max_per_cell=max_per_cell),
                ta=tgt.build_grid_accel(world["ts"], dims=dims,
                                        max_per_cell=max_per_cell))
    over = tgt.build_grid_accel(world["ts"], dims=dims, max_per_cell=128)
    assert over.stats_dict["overflow_cell_frac"] > 0.0
    o, d = random_rays(5, 512)
    jout, tout = _trace_both(wide, o, d, max_steps=64, compact_min=256)
    assert int(tout["frozen_alive"]) == int(jout["frozen_alive"])
    for k in ("alpha_acc", "trans", "albedo", "radiance_emitted"):
        assert_sums_close(tout[k], jout[k], f"Kc={max_per_cell} {k}")
    t_end = np.random.default_rng(11).uniform(0.5, 6.0, len(o)).astype(
        np.float32)
    jv, jf = jgt.visibility_grid(
        wide["js"], wide["ja"], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_end), wide["jset"], return_frozen=True, max_steps=64)
    tv, tf = tgt.visibility_grid(
        wide["ts"], wide["ta"], torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_end), wide["tset"], return_frozen=True,
        max_steps=64)
    assert int(tf) == int(jf)
    assert_sums_close(tv, jv, f"Kc={max_per_cell} visibility")
    assert float(tv.min()) < 0.5


def test_compaction_capacity_freezes_like_reference():
    """Above compact_min a later round resumes only the first `cap` rays by
    sort key; the others stay frozen, counted. 17000 rays cross the whole
    cloud along z with no transmittance cutoff, so more than round 1's cap
    (4352) outlive round 0's 8 cells, and both packages freeze the same
    ones."""
    js = random_scene(300, np.random.default_rng(13), spread=1.0)
    ja = jgt.build_grid_accel(js, dims=(16, 16, 16), max_per_cell=16)
    ta = tgt.build_grid_accel(to_torch_scene(js), dims=(16, 16, 16),
                              max_per_cell=16)
    rng = np.random.default_rng(3)
    r = 17000
    o = np.c_[rng.uniform(-0.6, 0.6, (r, 2)), np.full(r, -3.0)]
    d = np.c_[rng.normal(0, 0.05, (r, 2)), np.ones(r)]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_end = np.full(r, 6.0, np.float32)
    jv, jf = jgt.visibility_grid(js, ja, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_end),
                                 JRenderSettings(transmittance_min=0.0),
                                 max_steps=9, return_frozen=True)
    tv, tf = tgt.visibility_grid(None, ta, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 torch.from_numpy(t_end),
                                 RenderSettings(transmittance_min=0.0),
                                 max_steps=9, return_frozen=True)
    assert int(tf) == int(jf) > r - 4352
    assert_sums_close(tv, jv, "capacity")


def test_auto_picks_grid_above_dense_limit():
    n = tpipe.AUTO_DENSE_LIMIT + 1
    rng = np.random.default_rng(1)
    big = make_scene(means=rng.uniform(-1, 1, (n, 3)),
                     log_scales=np.full((n, 3), -3.0),
                     quats=np.tile([1.0, 0, 0, 0], (n, 1)),
                     opacity_logits=np.zeros(n), device=CPU)
    backend = tpipe.make_trace_backend(big, RenderSettings(), "auto")
    assert backend.name == "grid" and backend.accel.max_per_cell == 32
    small = dataclasses.replace(big, **{
        f: getattr(big, f)[:100] for f in ("means", "log_scales", "quats",
                                           "opacity_logits", "sh_coeffs",
                                           "emission", "metallic",
                                           "roughness", "clearcoat",
                                           "clearcoat_roughness",
                                           "transmission")})
    assert tpipe.make_trace_backend(small, RenderSettings(), "auto").name \
        == "dense"


def test_march_dispatch_and_stats(world):
    """CPU rays run march_plain through the dispatch; the kernel wrapper
    refuses them. The plain march's stats (read for the kernel's bound)
    count each composited cell visit and mark each block row probed."""
    from pathtracer_gaussiansplatting_tpu_torch.kernels import grid_march

    ta, settings = world["ta"], RenderSettings()
    o, d = (torch.from_numpy(x) for x in random_rays(5, 512, sigma=0.5))
    stats = {}
    want = tgt.march_plain(ta, o, d, settings, 64, stats=stats)
    got = tgt.march(ta, o, d, settings, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="plain march"):
        grid_march.march_kernel(ta, o, d, settings,
                                tgt.clip_schedule(tgt.DEFAULT_SCHEDULE, 64))
    visits, seen = stats["slot_visits"], stats["block_seen"]
    assert visits.shape == (ta.geom.shape[0],)
    assert seen.shape == (ta.btab.shape[0],)
    assert 0 < int((visits > 0).sum()) <= int(visits.sum())
    assert 0 < int(seen.sum()) <= stats["probes"]
    # The probes by kind: each that enters a sub-box checks 1-4 in-block
    # steps and takes at most as many.
    hits = stats["probes"] - stats["probes_empty"] - stats["probes_missed"]
    assert min(stats[k] for k in tgt.PROBE_STAT_KEYS) >= 0 and hits > 0
    assert stats["block_exits"] <= hits
    assert hits <= stats["step_checks"] <= 4 * hits
    assert 0 < stats["steps"] <= stats["step_checks"]
    # Every composited cell lies in a probed, occupied block.
    occupied = torch.nonzero(ta.btab[:, 0] >= 0)[:, 0]
    bases = ta.btab[occupied, 1].contiguous()        # ascending slots
    k = torch.searchsorted(bases, torch.nonzero(visits)[:, 0].int(),
                           right=True) - 1
    assert bool(seen[occupied[k]].all())


@pytest.mark.cuda
@pytest.mark.parametrize("max_per_cell", [16, 32, 48, 128])
def test_grid_kernels_match_plain_on_card(max_per_cell):
    """On the card, with no batch-level schedule in play (4096 rays, the
    full-coverage schedule without exit fractions), the kernel follows the
    plain march ray for ray: only sums and products round in another
    order. The kernel spreads a cell's Kc slots over a ray's lanes (a warp
    for a trace, one to four slots a lane; half a warp for a shadow
    segment, one to eight), so each lane mapping is run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    dev = torch.device("cuda", 0)
    scene = surface_scene(5000, seed=13, device=dev)
    accel = tgt.build_grid_accel(scene, max_per_cell=max_per_cell)
    o, d = random_rays(4, 4096, sigma=0.8)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_end = torch.full((4096,), 2.0, device=dev)
    settings = RenderSettings()
    for kw in (dict(with_features=True), dict(t_end=t_end,
                                              with_features=False)):
        before = (launch.launches["grid_trace"], launch.launches["grid_visibility"])
        got = tgt.march(accel, o, d, settings, 64, schedule=FULL_COV, **kw)
        torch.cuda.synchronize()
        assert (launch.launches["grid_trace"], launch.launches["grid_visibility"]) != before
        want = tgt.march_plain(accel, o, d, settings, 64, schedule=FULL_COV,
                               **kw)
        assert torch.equal(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            if w is not None:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("max_per_cell", [144, 256])
def test_grid_wide_kernels_match_plain_on_card(max_per_cell):
    """The kernels' wide instantiation (Kc above 128: a trace's cells of
    at most 64 slots on the register walk, fuller ones in shared memory, a
    segment's in passes of its lanes, each cell's work bounded by its
    fill) follows the plain march ray for ray as the register one does, on
    an 8x8x8 grid of surface_scene(5000), where cells hold more than 128
    Gaussians; and no cell overflows Kc=144 there, so the Kc=144 and
    Kc=256 kernels give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    dev = torch.device("cuda", 0)
    scene = surface_scene(5000, seed=13, device=dev)
    over = tgt.build_grid_accel(scene, dims=(8, 8, 8), max_per_cell=128)
    assert over.stats_dict["overflow_cell_frac"] > 0.0
    accel = tgt.build_grid_accel(scene, dims=(8, 8, 8),
                                 max_per_cell=max_per_cell)
    other_kc = {144: 256, 256: 144}[max_per_cell]
    other = tgt.build_grid_accel(scene, dims=(8, 8, 8), max_per_cell=other_kc)
    assert accel.max_fill == other.max_fill > 128
    assert torch.equal(accel.fill, other.fill)
    o, d = random_rays(4, 4096, sigma=0.8)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_end = torch.full((4096,), 2.0, device=dev)
    settings = RenderSettings()
    for kw in (dict(with_features=True), dict(t_end=t_end,
                                              with_features=False)):
        before = (launch.launches["grid_trace_wide"],
                  launch.launches["grid_visibility_wide"], launch.launches["grid_trace"],
                  launch.launches["grid_visibility"])
        got = tgt.march(accel, o, d, settings, 64, schedule=FULL_COV, **kw)
        torch.cuda.synchronize()
        after = (launch.launches["grid_trace_wide"],
                 launch.launches["grid_visibility_wide"], launch.launches["grid_trace"],
                 launch.launches["grid_visibility"])
        assert sum(after[:2]) == sum(before[:2]) + 1
        assert after[2:] == before[2:]
        want = tgt.march_plain(accel, o, d, settings, 64, schedule=FULL_COV,
                               **kw)
        assert torch.equal(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            if w is not None:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        same = tgt.march(other, o, d, settings, 64, schedule=FULL_COV, **kw)
        for g, s in zip(got, same):
            assert (g is None) == (s is None)
            if g is not None:
                assert torch.equal(g, s)


def test_march_chunks_feed_the_march():
    """The measured chunks (bounce rays, shadow segments to the emissive
    panel, a 50% active mask) at a small size on the CPU: finite rays of
    the asked count, segments of positive length where active, and the
    plain march finishes them all."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    scene = surface_scene(2000, seed=13, device=CPU)
    cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5), device=CPU),
                 fov_y_deg=60.0, width=32, height=16)
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    chunks = tch.march_chunks(scene, cam, settings, BinningConfig(), n=128)
    accel = tgt.build_grid_accel(scene, max_per_cell=32)
    assert [c[0] for c in chunks] == [
        "bounce rays", "shadow segments to the emissive panel",
        "bounce rays, 50% active"]
    n_active = []
    for name, o, d, kw in chunks:
        assert o.shape == d.shape == (128, 3)
        assert bool(torch.isfinite(o).all() and torch.isfinite(d).all())
        active = kw["active"]
        n_active.append(int(active.sum()))
        if "t_end" in kw:
            assert bool((kw["t_end"][active] > 0).all())
        trans, _, frozen = tgt.march(accel, o, d, settings, 192,
                                     with_features="t_end" not in kw, **kw)
        assert not bool(frozen.any())
        assert bool(((trans >= 0) & (trans <= 1)).all())
    assert 0 < n_active[2] < n_active[0]
