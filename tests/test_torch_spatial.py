"""The port's spatial slab ring (parallel/spatial.py) and its "spatial"
trace backend against the JAX package, on the CPU: the JAX functions on
the 8-virtual-device mesh of tests/conftest.py cut to n devices, the
port's on n spawned gloo ranks (tests/torch_mesh_ranks.py; one spawn per
module runs every case), the same mesh shapes and numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.parallel import mesh as jmesh
from pathtracer_gaussiansplatting_tpu.parallel import spatial as jspatial
from pathtracer_gaussiansplatting_tpu.render.pathtrace import (
    pathtrace as j_pathtrace,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt

import torch_mesh_ranks as ranks
from torch_parity import (
    CPU, TORCH_THREADS, assert_fill_counts_rows, assert_image_close, np_of,
    to_torch_scene,
)
from utils import random_scene

torch.set_num_threads(TORCH_THREADS)

# tests/test_spatial.py's tolerance for the ring's radiance and interaction
# against its oracle; the port's ring against the JAX package's is held to
# it.
RTOL, ATOL = 3e-4, 3e-4
# Grid slabs, the port against the JAX package: the march's XLA FMA
# allowance (tests/test_torch_grid_trace.py).
GRID_RTOL, GRID_ATOL = 1e-4, 2e-4
# Grid slabs against dense slabs (tests/test_spatial.py): transmittance is
# order-free; the feature sums differ by the in-slab order (t_peak against
# the mean's projection).
GRID_TRANS_ATOL, GRID_ALBEDO_ATOL, GRID_DEPTH_ATOL = 5e-3, 8e-2, 0.3
# The ring against one device's grid march (tests/test_spatial.py).
GRID_VIS_ATOL = 1e-5
# render_spatial's gradients on the (2, 2) ring against one slab on one
# rank (tests/test_spatial.py): forward, then gradient.
FWD1_RTOL, FWD1_ATOL, GRAD1_RTOL, GRAD1_ATOL = 1e-4, 1e-5, 2e-3, 2e-5
SHORT_STEPS = 2  # max_steps that leaves rays frozen on the grid slabs


def _mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _rays(rng, r, toward=(0, 0, -1), spread=0.3):
    """tests/test_spatial.py's rays: from (0, 0, 4) toward ``toward``."""
    o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (r, 1))
    d = np.asarray(toward, np.float32)[None] + \
        rng.normal(0, spread, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _mixed_rays(rng):
    """tests/test_spatial.py's rays with and against the slab axis."""
    o = np.concatenate([np.tile([[0.0, 0.0, 4.0]], (32, 1)),
                        np.tile([[0.0, 0.0, -4.0]], (32, 1))]).astype(
                            np.float32)
    d = np.concatenate([np.tile([[0.05, 0.0, -1.0]], (32, 1)),
                        np.tile([[0.0, 0.05, 1.0]], (32, 1))])
    d = (d + rng.normal(0, 0.2, d.shape)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _sharded(mesh, *arrays):
    sh = jspatial.spatial_sharding(mesh)
    return tuple(jax.device_put(jnp.asarray(x), sh) for x in arrays)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(7)
    w = dict(
        scene=random_scene(96, rng, emissive_frac=0.1),
        mixed=_mixed_rays(rng),
        grad=random_scene(64, rng, spread=1.0), grad_rays=_rays(rng, 64),
        trace=random_scene(64, rng, emissive_frac=0.1),
        trace_rays=_rays(rng, 32),
        pt=random_scene(64, rng, emissive_frac=0.15,
                        scale_range=(-1.6, -0.7)),
        pt_rays=_rays(rng, 256))
    # The grid slabs: tests/test_spatial.py::TestGridSlabBackend's scene
    # and rays, on which it bounds the grid slabs against the dense ones.
    grid_rng = np.random.default_rng(7)
    w["grid"] = random_scene(160, grid_rng, spread=1.0)
    w["grid_rays"] = _rays(grid_rng, 64)
    n = 64
    w["trace"] = w["trace"].replace(
        transmission=jnp.where(jnp.arange(n) % 3 == 0, 0.5, 0.0),
        clearcoat=jnp.where(jnp.arange(n) % 4 == 0, 0.7, 0.0))
    t_end = np.full((32,), 6.0, np.float32)
    grid_t_end = np.full((64,), 3.0, np.float32)
    io = tmp_path_factory.mktemp("spatial_ranks")
    arrays = dict(t_end=t_end, grid_t_end=grid_t_end,
                  short_steps=np.asarray(SHORT_STEPS))
    for key in ("scene", "grad", "trace", "grid", "pt"):
        arrays.update(ranks.scene_arrays(key, w[key]))
    for key, rays in (("mixed", w["mixed"]), ("grad", w["grad_rays"]),
                      ("trace", w["trace_rays"]), ("grid", w["grid_rays"]),
                      ("pt", w["pt_rays"])):
        arrays[key + "_o"], arrays[key + "_d"] = rays
    ranks.save_inputs(io, **arrays)
    w.update(t_end=t_end, grid_t_end=grid_t_end,
             out=ranks.spawn("spatial_cases", io))
    return w


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_render_spatial_matches(world, shape):
    """render_spatial on mixed-direction rays: the slab order folds both
    ways around the ring."""
    mesh = _mesh(shape)
    scene = world["scene"]
    settings = JRenderSettings(max_contribs=scene.num_gaussians,
                               background=(0.1, 0.2, 0.3))
    slabbed, _ = jspatial.partition_slabs(scene, shape[1])
    o, d = _sharded(mesh, *world["mixed"])
    want = jspatial.render_spatial(slabbed, JRays(o, d), settings, mesh)
    np.testing.assert_allclose(world["out"][f"render_{shape[0]}x{shape[1]}"],
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_render_spatial_grads_match(world):
    """The means' gradient through the (2, 2) ring (its shifts carry the
    gradient back) against one slab on one rank, and against the JAX
    package's (2, 2) ring."""
    out = world["out"]
    np.testing.assert_allclose(out["grad_render"], out["grad_render_1"],
                               rtol=FWD1_RTOL, atol=FWD1_ATOL)
    np.testing.assert_allclose(out["grad_means"], out["grad_means_1"],
                               rtol=GRAD1_RTOL, atol=GRAD1_ATOL)
    assert np.abs(out["grad_means"]).max() > 0
    mesh = _mesh((2, 2))
    settings = JRenderSettings(max_contribs=96, background=(0.1, 0.2, 0.3))
    slabbed, _ = jspatial.partition_slabs(world["grad"], 2)
    sharded = jmesh.shard_scene(slabbed, mesh)
    rays = JRays(*_sharded(mesh, *world["grad_rays"]))
    g = jax.grad(lambda m: jnp.mean(jspatial.render_spatial(
        sharded.replace(means=m), rays, settings, mesh) ** 2))(sharded.means)
    np.testing.assert_allclose(out["grad_means"], np.asarray(g),
                               rtol=GRAD1_RTOL, atol=GRAD1_ATOL)


def test_trace_and_visibility_spatial_match(world):
    """trace_spatial's interaction channels and visibility_spatial's
    shadow transmittance over dense slabs at (1, 4)."""
    mesh = _mesh((1, 4))
    scene = world["trace"]
    settings = JRenderSettings(max_contribs=scene.num_gaussians)
    slabbed, _ = jspatial.partition_slabs(scene, 4)
    o, d, t_end = _sharded(mesh, *world["trace_rays"], world["t_end"])
    want = jspatial.trace_spatial(slabbed, JRays(o, d), settings, mesh)
    out = world["out"]
    for key, w in want.items():
        np.testing.assert_allclose(out[f"trace/{key}"], np.asarray(w),
                                   rtol=RTOL, atol=RTOL, err_msg=key)
    vis = jspatial.visibility_spatial(slabbed, o, d, t_end, settings, mesh)
    np.testing.assert_allclose(out["vis"], np.asarray(vis), rtol=RTOL,
                               atol=ATOL)


def _grid_world(world, max_steps):
    mesh = _mesh((1, 4))
    scene = world["grid"]
    settings = JRenderSettings(max_contribs=scene.num_gaussians)
    slabbed, axis = jspatial.partition_slabs(scene, 4)
    tables, meta = jspatial.build_slab_accels(slabbed, 4, max_per_cell=64,
                                              radius_percentile=100.0)
    tables = jax.tree.map(lambda x: jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            "gauss"))), tables)
    o, d, t_end = _sharded(mesh, *world["grid_rays"], world["grid_t_end"])
    kw = dict(slab_accel=tables, accel_meta=meta, max_steps=max_steps)
    return (jspatial.trace_spatial(slabbed, JRays(o, d), settings, mesh, axis,
                                   **kw),
            jspatial.visibility_spatial(slabbed, o, d, t_end, settings, mesh,
                                        axis, **kw))


def test_grid_slabs_match(world):
    """trace_spatial and visibility_spatial on grid slabs at (1, 4): the
    JAX package's values, the dense slabs' within tests/test_spatial.py's
    bounds, one device's march for the shadow rays, and nothing frozen."""
    out = world["out"]
    trace, vis = _grid_world(world, 256)
    for key in ("trans", "albedo", "depth", "alpha_acc", "normal"):
        np.testing.assert_allclose(out[f"grid/{key}"], np.asarray(trace[key]),
                                   rtol=GRID_RTOL, atol=GRID_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["gvis"], np.asarray(vis), rtol=GRID_RTOL,
                               atol=GRID_ATOL)
    np.testing.assert_allclose(out["grid/trans"], out["dense/trans"],
                               atol=GRID_TRANS_ATOL)
    np.testing.assert_allclose(out["grid/albedo"], out["dense/albedo"],
                               atol=GRID_ALBEDO_ATOL)
    np.testing.assert_allclose(out["grid/depth"], out["dense/depth"],
                               atol=GRID_DEPTH_ATOL)
    slabbed, _ = spatial.partition_slabs(to_torch_scene(world["grid"]), 4)
    accel1 = tgt.build_grid_accel(slabbed, max_per_cell=64,
                                  radius_percentile=100.0)
    o, d = (torch.from_numpy(x) for x in world["grid_rays"])
    one = tgt.visibility_grid(None, accel1, o, d,
                              torch.from_numpy(world["grid_t_end"]),
                              RenderSettings(max_contribs=160), max_steps=256,
                              compact_min=spatial.PLAIN_COMPACT_MIN)
    np.testing.assert_allclose(out["gvis"], np_of(one), atol=GRID_VIS_ATOL)
    assert out["frozen/grid"] == 0 and out["frozen/gvis"] == 0
    assert out["warnings_quiet"] == 0


def test_grid_slab_truncation_is_counted(world):
    """With a max_steps that leaves rays alive, the ring sums each slab's
    frozen marches into frozen_alive and warns on the gspt logger; the
    values the JAX package returns stay as they are."""
    out = world["out"]
    trace, _ = _grid_world(world, SHORT_STEPS)
    for key in ("trans", "albedo", "depth"):
        np.testing.assert_allclose(out[f"short/{key}"],
                                   np.asarray(trace[key]), rtol=GRID_RTOL,
                                   atol=GRID_ATOL, err_msg=key)
    assert out["frozen/short"] > 0
    assert len(out["warnings"]) == 1
    assert "grid slab trace truncation" in str(out["warnings"][0])


def test_grid_slabs_need_one_slab_a_rank(world):
    """Eight slabs' tables on a gauss axis of four would give each rank
    two; the JAX package marches the first and drops the other, the port
    raises."""
    assert "this rank holds 2 slabs' tables" in str(world["out"]["guard"])


def test_pathtrace_through_spatial_backend_matches(world):
    """A depth-2 path trace at (2, 2), every rank tracing the whole batch
    through make_trace_backend(..., "spatial", accel=mesh), against the
    JAX package's pathtrace with trace_spatial / visibility_spatial and
    the same key."""
    mesh = _mesh((2, 2))
    scene = world["pt"]
    settings = JRenderSettings(max_depth=2, max_contribs=scene.num_gaussians,
                               ambient=(0.05, 0.05, 0.08, 1.0))
    slabbed, _ = jspatial.partition_slabs(scene, 2)
    rays = JRays(*_sharded(mesh, *world["pt_rays"]))
    want = j_pathtrace(
        slabbed, rays, settings, jax.random.PRNGKey(3),
        trace_fn=lambda s, rr, st: jspatial.trace_spatial(slabbed, rr, st,
                                                          mesh),
        visibility_fn=lambda o, d, t: jspatial.visibility_spatial(
            slabbed, o, d, t, settings, mesh))
    assert_image_close(world["out"]["pathtrace"], np.asarray(want),
                       "pathtrace, spatial backend")


def test_partition_and_slab_tables_match():
    """partition_slabs' order and padding, and build_slab_accels' tables,
    equal the JAX package's."""
    js = random_scene(50, np.random.default_rng(3), spread=1.0)
    jsl, jaxis = jspatial.partition_slabs(js, 4)
    tsl, taxis = spatial.partition_slabs(to_torch_scene(js), 4)
    np.testing.assert_array_equal(taxis, jaxis)
    for f in ("means", "log_scales", "opacity_logits", "sh_coeffs"):
        np.testing.assert_array_equal(np_of(getattr(tsl, f)),
                                      np.asarray(getattr(jsl, f)), err_msg=f)
    js = random_scene(64, np.random.default_rng(4), spread=1.0)
    jtab, jmeta = jspatial.build_slab_accels(
        jspatial.partition_slabs(js, 4)[0], 4, max_per_cell=32)
    ttab, tmeta = spatial.build_slab_accels(
        spatial.partition_slabs(to_torch_scene(js), 4)[0], 4, max_per_cell=32)
    assert tmeta.dims == jmeta.dims
    assert tmeta.jump_unit == pytest.approx(jmeta.jump_unit, rel=1e-6)
    np.testing.assert_array_equal(np_of(ttab["btab"]),
                                  np.asarray(jtab["btab"]))
    for key in ("geom", "packet", "lo", "hi"):
        np.testing.assert_allclose(np_of(ttab[key]), np.asarray(jtab[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("max_per_cell", [32, 144])
def test_slab_fills_count_each_rows_slots(max_per_cell):
    """build_slab_accels' fill (S, Smax): each slab row's filled slots,
    equal to the JAX package's count of the same row's Gaussians, every
    slot at or past it zero, the padding rows' fill 0; a rank's GridAccel
    carries its slab's. The slabs overflow Kc=32 and fit Kc=144."""
    js = random_scene(300, np.random.default_rng(13), spread=1.0)
    jtab, _ = jspatial.build_slab_accels(
        jspatial.partition_slabs(js, 4)[0], 4, max_per_cell=max_per_cell)
    ttab, tmeta = spatial.build_slab_accels(
        spatial.partition_slabs(to_torch_scene(js), 4)[0], 4,
        max_per_cell=max_per_cell)
    dropped = dict(tmeta.stats)["dropped_frac"]
    assert (dropped > 0.0) == (max_per_cell == 32)
    jgeom = np.asarray(jtab["geom"]).reshape(4, ttab["fill"].shape[1], -1,
                                             max_per_cell)
    np.testing.assert_array_equal(np_of(ttab["fill"]),
                                  (jgeom[:, :, tgt.G_OPAC] > 0).sum(-1))
    assert int((ttab["fill"] == 0).sum()) > 0     # padding rows
    for g in range(4):
        one = spatial._slab_grid({k: v[g:g + 1] for k, v in ttab.items()},
                                 tmeta, None)
        assert torch.equal(one.fill, ttab["fill"][g])
        assert_fill_counts_rows(one.geom, one.packet, one.fill,
                                max_per_cell, tgt.G_OPAC)


def test_slab_k_cap_on_the_card():
    """A slab composite keeps K = min(max_contribs, Nb) a ray, on the card
    as on the CPU: the top-K kernel takes every K up to N (above 128 its
    list kernel), so nothing caps K below the JAX package's."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )

    settings = RenderSettings(max_contribs=160)
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32)), dim=-1)
    axis = torch.tensor([0.0, 0.0, 1.0])
    for nb, k in ((200, 160), (100, 100)):
        block = random_cloud(nb, seed=nb, device=CPU)
        idx, t, alpha, _ = spatial._slab_topk(
            block, o, d, axis, settings, spatial._slab_table(block, settings))
        assert idx.shape == t.shape == alpha.shape == (8, k)
