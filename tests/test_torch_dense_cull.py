"""The dense kernels' cull, table and gradients (CPU; the card's gradients
in a cuda-marked test).

- The conservative cull of csrc/dense_common.cuh, as the torch predicate
  ``dense_cull_keep``, never drops a pair whose plain alpha is > 0, for
  the trace's and the shadow segment's q_lim, on rays aimed at the cutoff
  of thin surfels seen from far, from inside Gaussians, past them, at
  opacities within an ulp of alpha_min and on short segments.
- The 16-column table against a numpy formula; a prebuilt table (and the
  dense backend's, built once) gives the results of a table built per call.
- The dense backend's table cache counts the calls it cannot serve.
- The top-K kernel's two-level group test: each super-group's sphere holds
  its groups' spheres, every (ray, group) the group test keeps lies in a
  super-group the super-group test keeps (primary, bounce and thin-far
  rays; N not a multiple of 1024), its cull columns are the rows', and
  cull_counts counts its path.
- Gradients of render_radiance_dense, of trace_dense's depth and of
  visibility_dense reach the geometry and opacity and match jax.grad of
  the JAX package's functions; the recomputed t and alpha are bit-equal to
  the plain outputs. The card's shadow gradient path (the kernel's pairs
  with alpha > 0, their alpha recomputed in torch, shadow_product) is
  driven on the CPU with the plain version's pairs and matches jax.grad
  too; its value is the plain product's, bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given
from hypothesis import settings as hyp_settings
from hypothesis import strategies as st

from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.render import reference as jref
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    Rays, RenderSettings, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace as dt
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as tgauss
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import (
    quat_to_rotmat,
)
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe
from pathtracer_gaussiansplatting_tpu_torch.render import reference as tref

from torch_parity import CPU, TORCH_THREADS, assert_close, cameras, np_of, \
    to_torch_scene

torch.set_num_threads(TORCH_THREADS)

# chip_smoke.py phase 5's camera: eye and target (its distance ~2.28).
PHASE5_EYE, PHASE5_TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
FAR = 20.0 * math.dist(PHASE5_EYE, PHASE5_TARGET)
N_G, N_R = 48, 96
KINDS = ("thin_far", "near", "inside", "behind", "ulp_opacity",
         "short_segment")
GEOMETRY = ("means", "log_scales", "quats", "opacity_logits")
# Gradients against jax.grad: the packages round the quadratic apart by
# ~c * eps32 (test_torch_reference.py), which the chain rule carries.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _cull_case(seed: int, kind: str):
    """A table of N_G Gaussians and N_R rays, each aimed at one Gaussian so
    that its line passes at the Mahalanobis radius of the cutoff (times
    0.98-1.02): (table, origins, dirs, t_end)."""
    rng = np.random.default_rng(seed)
    thin = kind in ("thin_far", "behind", "short_segment")
    s_max = rng.uniform(0.01, 0.3, N_G)
    ratio = rng.uniform(0.005, 0.05, N_G) if thin \
        else rng.uniform(0.05, 1.0, N_G)
    scales = np.stack([s_max, s_max * rng.uniform(ratio, 1.0), s_max * ratio],
                      axis=-1)
    scales = np.take_along_axis(scales, rng.permuted(
        np.tile(np.arange(3), (N_G, 1)), axis=1), axis=1)
    quats = rng.normal(size=(N_G, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scene = make_scene(
        means=rng.uniform(-1, 1, (N_G, 3)), log_scales=np.log(scales),
        quats=quats, opacity_logits=rng.uniform(-4.0, 5.0, N_G),
        colors=np.full((N_G, 3), 0.5), device=CPU)
    settings = RenderSettings()
    table = dt.gaussian_table(scene, settings)
    if kind == "ulp_opacity":   # opacities within an ulp or two of alpha_min
        a = np.float32(settings.alpha_min)
        near = np.array([np.nextafter(a, np.float32(0)), a,
                         np.nextafter(a, np.float32(1)),
                         np.nextafter(np.nextafter(a, np.float32(1)),
                                      np.float32(1))], np.float32)
        table[:, 12] = torch.from_numpy(near[rng.integers(0, 4, N_G)])
        table[:, 13:] = torch.stack(dt.cull_radii(
            scene.log_scales, table[:, 12], settings), dim=-1)
    opac = table[:, 12].double().numpy()
    ln_term = 2.0 * np.log(opac / settings.alpha_min)
    q_lim = np.where(rng.uniform(size=N_G) < 0.5, ln_term,
                     np.minimum(ln_term, settings.sigma_cut ** 2))
    rot = quat_to_rotmat(torch.from_numpy(quats).float()).double().numpy()
    scales = np.exp(scene.log_scales.double().numpy())
    means = scene.means.double().numpy()
    g = rng.integers(0, N_G, N_R)
    r_m = np.sqrt(np.clip(q_lim[g], 0.0, None)) * rng.uniform(0.98, 1.02, N_R)
    if kind == "ulp_opacity":
        r_m = rng.uniform(0.0, 2e-3, N_R)
    w = _unit(rng, N_R) * r_m[:, None]                 # canonical offset
    e = _unit(rng, N_R)
    e -= (e * w).sum(-1, keepdims=True) * w / np.maximum(
        (w * w).sum(-1, keepdims=True), 1e-30)         # e ⊥ w
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    p = means[g] + np.einsum("rij,rj->ri", rot[g], scales[g] * w)
    d = np.einsum("rij,rj->ri", rot[g], scales[g] * e)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    length = dict(thin_far=rng.uniform(0.9, 1.1, N_R) * FAR,
                  behind=-rng.uniform(0.005, 2.0, N_R),
                  inside=rng.uniform(0.0, 1.0, N_R) * s_max[g]).get(
        kind, rng.uniform(0.05, 3.0, N_R))
    o = p - length[:, None] * d
    if kind == "inside":   # half of them from inside, in random directions
        o[::2] = means[g[::2]] + np.einsum(
            "rij,rj->ri", rot[g[::2]],
            scales[g[::2]] * rng.uniform(-0.7, 0.7, (len(g[::2]), 3)))
        d[::2] = _unit(rng, len(g[::2]))
    if kind == "short_segment":   # ending before t_min, or behind
        t_end = rng.uniform(-0.01, 0.05, N_R)
    else:
        t_end = np.abs(length) * rng.uniform(0.5, 1.5, N_R)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    return table, f(o), f(d), f(t_end)


@hyp_settings(max_examples=60, deadline=None, derandomize=True,
              database=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 32 - 1), kind=st.sampled_from(KINDS))
def test_cull_keeps_every_contributing_pair(seed, kind):
    """No pair with plain alpha > 0 is culled, for the trace (with
    sigma_cut) and for shadow segments (without)."""
    table, o, d, t_end = _cull_case(seed, kind)
    s = RenderSettings()
    mean, m, opac = dt._unpack(table)
    _, gval = tgauss.peak_response(o[:, None], d[:, None], mean, m, s.t_min,
                                   s.t_max)
    alpha = tgauss.alpha_from_response(opac, gval, s.alpha_min, s.alpha_max,
                                       s.sigma_cut)
    seg = tgauss.segment_transmittance_alpha(
        o[:, None], d[:, None], mean, m, opac, s.t_min, t_end[:, None],
        s.alpha_min, s.alpha_max)
    for name, a, keep in (
            ("trace", alpha, dt.dense_cull_keep(o, d, table, s)),
            ("shadow", seg, dt.dense_cull_keep(o, d, table, s, t_end))):
        dropped = int(((a > 0) & ~keep).sum())
        assert dropped == 0, \
            f"{kind} {name}: {dropped} contributing pairs culled"


def test_cull_boundary_cases_contribute_and_cull():
    """The aimed rays really sit at the cutoff: over a few seeds of every
    kind, aimed pairs contribute and other pairs are culled."""
    s = RenderSettings()
    for kind in KINDS:
        contributing = culled = 0
        for seed in range(4):
            table, o, d, t_end = _cull_case(seed, kind)
            mean, m, opac = dt._unpack(table)
            seg = tgauss.segment_transmittance_alpha(
                o[:, None], d[:, None], mean, m, opac, s.t_min,
                t_end[:, None], s.alpha_min, s.alpha_max)
            contributing += int((seg > 0).sum())
            culled += int((~dt.dense_cull_keep(o, d, table, s, t_end)).sum())
        # From far away a thin surfel's quadratic loses all its digits
        # (|M x|^2 eps32 >> q_lim), so the cull must keep most such pairs.
        assert contributing >= 8 and culled >= 100, \
            (kind, contributing, culled)


def test_cull_on_surface_scene():
    """surface_scene(2000) through phase 5's camera: the cull keeps every
    contributing pair and drops most of the others."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    scene = surface_scene(2000, seed=13, device=CPU)
    s = RenderSettings()
    table = dt.gaussian_table(scene, s)
    rays = generate_rays(Camera(c2w=look_at(PHASE5_EYE, PHASE5_TARGET,
                                            device=CPU),
                                fov_y_deg=60.0, width=32, height=24))
    mean, m, opac = dt._unpack(table)
    _, gval = tgauss.peak_response(rays.origins[:, None],
                                   rays.directions[:, None], mean, m,
                                   s.t_min, s.t_max)
    alpha = tgauss.alpha_from_response(opac, gval, s.alpha_min, s.alpha_max,
                                       s.sigma_cut)
    keep = dt.dense_cull_keep(rays.origins, rays.directions, table, s)
    assert not bool(((alpha > 0) & ~keep).any())
    assert float(keep.float().mean()) < 0.1
    assert int(keep.sum()) > int((alpha > 0).sum()) > 0


def test_gaussian_table_matches_numpy():
    rng = np.random.default_rng(21)
    n = 200
    log_scales = rng.uniform(-5.0, -0.5, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    logits = rng.uniform(-8.0, 4.0, n).astype(np.float32)   # some below
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scene = make_scene(means=means, log_scales=log_scales, quats=quats,
                       opacity_logits=logits, colors=np.full((n, 3), 0.5),
                       device=CPU)
    s = RenderSettings(sigma_cut=2.5, alpha_min=0.01)
    table = np_of(dt.gaussian_table(scene, s))
    assert table.shape == (n, dt.TABLE_COLS) and table.dtype == np.float32

    q = quats.astype(np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    inv_s = np.exp(-log_scales.astype(np.float64))
    m = inv_s[:, :, None] * rot.transpose(0, 2, 1)
    opac = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    eps, delta = 2.0 ** -24, 0.01
    s_max, rho = 1.0 / inv_s.min(-1), inv_s.max(-1) / inv_s.min(-1)
    grow = (1 + delta) * (1 + 32 * eps * rho)
    ln_term = 2 * np.log(opac / s.alpha_min)

    def r0(q_raw):
        r = s_max ** 2 * (np.maximum(q_raw, 0.0) + 1e-5) * grow
        return np.where(q_raw < -1e-5, -np.inf, r)

    r1 = (rho ** 2 * (56 * eps + 108 * eps ** 2 * (1 + rho) ** 2 / delta)
          * (1 + 1e-4) + 16 * eps) * grow
    want = np.concatenate([means, m.reshape(n, 9), opac[:, None],
                           r0(np.minimum(ln_term, s.sigma_cut ** 2))[:, None],
                           r1[:, None], r0(ln_term)[:, None]], -1)
    # M's entries carry float32 rounding of the order of its row's 1/s.
    row = inv_s.max(-1)[:, None]
    np.testing.assert_allclose(table[:, 3:12] / row, want[:, 3:12] / row,
                               atol=1e-6)
    np.testing.assert_allclose(table[:, [0, 1, 2, 12]], want[:, [0, 1, 2, 12]],
                               rtol=1e-6)
    np.testing.assert_allclose(table[:, 13:], want[:, 13:], rtol=1e-5)
    assert np.isneginf(table[:, 13]).any()   # opacities below alpha_min


@pytest.fixture(scope="module")
def cloud():
    """A JAX cloud of sigma 0.17-0.45 (no alpha near a cutoff) and its
    port copy, with 24x16 rays of a camera 2 units from its center, half
    of them moved inside the cloud in random directions. From farther away
    the packages' rounding of the quadratic (~|M x|^2 eps32) reaches the
    gradients' tolerance."""
    js = j_random_cloud(150, seed=17, spread=1.0, scale_range=(-1.8, -0.8),
                        emissive_frac=0.1)
    from pathtracer_gaussiansplatting_tpu.core.camera import generate_rays

    jr = generate_rays(cameras(eye=(0.0, 0.3, 2.0), fov=70.0, width=24,
                               height=16)[0])
    rng = np.random.default_rng(5)
    o, d = np.array(jr.origins), np.array(jr.directions)
    o[::2] = rng.uniform(-1, 1, (len(o[::2]), 3))
    d[::2] = _unit(rng, len(d[::2]))
    o, d = o.astype(np.float32), d.astype(np.float32)
    return dict(jscene=js, tscene=to_torch_scene(js),
                jrays=JRays(jnp.asarray(o), jnp.asarray(d)),
                trays=Rays(torch.from_numpy(o), torch.from_numpy(d)))


def test_prebuilt_table_equals_built(cloud):
    ts, tr = cloud["tscene"], cloud["trays"]
    s = RenderSettings(max_contribs=32)
    table = dt.gaussian_table(ts, s)
    rng = np.random.default_rng(3)
    active = torch.from_numpy(rng.uniform(0, 1, tr.num_rays) < 0.7)
    sd = ts.means[:, 2].clone()
    t_end = torch.from_numpy(rng.uniform(0.1, 4.0, tr.num_rays)
                             .astype(np.float32))
    for kw in (dict(), dict(sort_depths=sd), dict(active=active)):
        got = tref.dense_topk(ts, tr, s, table=table, **kw)
        want = tref.dense_topk(ts, tr, s, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(
        tref.visibility_dense(ts, tr.origins, tr.directions, t_end, s,
                              active, table),
        tref.visibility_dense(ts, tr.origins, tr.directions, t_end, s,
                              active))
    got = tref.trace_dense(ts, tr, s, active=active, table=table)
    want = tref.trace_dense(ts, tr, s, active=active)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(tref.render_radiance_dense(ts, tr, s, table=table),
                       tref.render_radiance_dense(ts, tr, s))

    # The dense backend builds its table once and serves only its scene,
    # unchanged, at its sigma_cut and alpha_min.
    backend = tpipe.make_trace_backend(ts, s, "dense")
    cache = backend.trace.args[0]
    assert torch.equal(cache.get(ts, s).rows, table)
    assert cache.get(ts, dataclasses.replace(s, max_depth=2)) is cache.table
    assert cache.get(ts, dataclasses.replace(s, alpha_min=0.02)) is None
    assert cache.get(ts.replace(means=ts.means.clone()), s) is None
    got = backend.trace(ts, tr, s, active=active)
    assert all(torch.equal(got[k], want[k]) for k in want)
    vis, frozen = backend.visibility(tr.origins, tr.directions, t_end, active)
    assert frozen == 0 and torch.equal(vis, tref.visibility_dense(
        ts, tr.origins, tr.directions, t_end, s, active))
    moved = ts.replace(means=ts.means.clone())
    stale = tpipe.make_trace_backend(moved, s, "dense").trace.args[0]
    moved.means.add_(0.25)   # in place: the table no longer matches
    assert stale.get(moved, s) is None


def test_table_cache_counts_misses(cloud):
    """Every call the dense backend's table cannot serve is counted in
    pipeline.TABLE_MISSES; a served call is not."""
    ts, tr = cloud["tscene"], cloud["trays"]
    s = RenderSettings(max_contribs=16)
    backend = tpipe.make_trace_backend(ts, s, "dense")
    cache = backend.trace.args[0]
    before = tpipe.TABLE_MISSES
    backend.trace(ts, tr, s)
    backend.visibility(tr.origins, tr.directions,
                       torch.full((tr.num_rays,), 2.0))
    assert tpipe.TABLE_MISSES == before
    assert cache.get(ts.replace(means=ts.means.clone()), s) is None
    assert cache.get(ts, dataclasses.replace(s, sigma_cut=2.0)) is None
    assert cache.get(_leaves(ts), s) is None   # autograd wants the geometry
    assert tpipe.TABLE_MISSES == before + 3
    with torch.no_grad():
        backend.trace(_leaves(ts), tr, s)      # another scene object
    assert tpipe.TABLE_MISSES == before + 4


def test_dense_table_groups():
    """The kernels' view of the table: rows in Morton order with their
    indices (or in any order given to table_in_order), each 32-row
    group's sphere holding its means and its largest radii; and the group
    test never drops a group holding a contributing pair, on
    surface_scene(12000) seen by phase 5's camera and on rays leaving its
    surfels."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    n = 12_000
    scene = surface_scene(n, seed=13, device=CPU)
    s = RenderSettings()
    table = dt.gaussian_table(scene, s)
    dtab = dt.dense_table(table)
    order = dtab.order.long()
    assert dtab.order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    assert torch.equal(dtab.sorted_rows, table[order])
    assert dtab.groups.shape == (375, dt.GROUP_COLS)
    for i in range(375):
        rows = dtab.sorted_rows[i * 32:(i + 1) * 32].double()
        st = dtab.groups[i].double()
        assert float((rows[:, :3] - st[:3]).norm(dim=-1).max()) <= st[3]
        assert torch.equal(st[4:7], rows[:, 13:16].amax(0))
    # Morton order keeps a group's means together: its sphere is far
    # smaller than the scene.
    assert float(dtab.groups[:, 3].median()) < 0.1 * float(
        (table[:, :3].amax(0) - table[:, :3].amin(0)).norm())
    flat = dt.table_in_order(table, torch.arange(n))
    assert torch.equal(flat.order.long(), torch.arange(n))
    assert torch.equal(flat.sorted_rows, table)
    assert bool((table[:, :3].reshape(375, 32, 3) - flat.groups[:, None, :3])
                .norm(dim=-1).le(flat.groups[:, None, 3]).all())

    rays = generate_rays(Camera(c2w=look_at(PHASE5_EYE, PHASE5_TARGET,
                                            device=CPU),
                                fov_y_deg=60.0, width=32, height=24))
    o, d = rays.origins, rays.directions
    rng = np.random.default_rng(8)
    bo = scene.means[rng.integers(0, n, 768)] + 0.01
    bd = torch.from_numpy(_unit(rng, 768).astype(np.float32))
    mean, m, opac = dt._unpack(dtab.sorted_rows)
    for oo, dd_ in ((o, d), (bo, bd)):
        t_end = torch.from_numpy(rng.uniform(-0.01, 3.0, oo.shape[0])
                                 .astype(np.float32))
        _, gval = tgauss.peak_response(oo[:, None], dd_[:, None], mean, m,
                                       s.t_min, s.t_max)
        alpha = tgauss.alpha_from_response(opac, gval, s.alpha_min,
                                           s.alpha_max, s.sigma_cut)
        seg = tgauss.segment_transmittance_alpha(
            oo[:, None], dd_[:, None], mean, m, opac, s.t_min,
            t_end[:, None], s.alpha_min, s.alpha_max)
        for a, reach in (
                (alpha, dt.dense_group_keep(oo, dd_, dtab, s)),
                (seg, dt.dense_group_keep(oo, dd_, dtab, s, t_end))):
            rows = reach.repeat_interleave(32, dim=1)[:, :n]
            assert not bool(((a > 0) & ~rows).any())
            assert float(reach.float().mean()) < 0.5


def _super_world(name: str):
    """A scene whose N is not a multiple of 1024 rows (a short last
    super-group) and its DenseTable: surface_scene(12000) (375 groups,
    the last super-group 23 of them) or random_cloud(5000) (157 groups,
    the last 29)."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud, surface_scene,
    )

    scene = surface_scene(12_000, seed=13, device=CPU) if name == "surface" \
        else random_cloud(5000, seed=13, spread=1.5, device=CPU)
    return scene, dt.dense_table(dt.gaussian_table(scene, RenderSettings()))


def _super_rays(scene, kind: str, n_rays: int = 512):
    """Seeded rays of phase 5's camera ("primary", 32x16 of its view),
    rays leaving the scene's means in random directions ("bounce"), or the
    camera 20x as far through a 20x narrower view ("thin_far")."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )

    if kind == "bounce":
        rng = np.random.default_rng(31)
        o = scene.means[rng.integers(0, scene.num_gaussians, n_rays)] + 0.01
        return o, torch.from_numpy(_unit(rng, n_rays).astype(np.float32))
    eye = PHASE5_EYE if kind == "primary" else tuple(
        t + 20.0 * (e - t) for e, t in zip(PHASE5_EYE, PHASE5_TARGET))
    fov = 60.0 if kind == "primary" else 3.0
    rays = generate_rays(Camera(c2w=look_at(eye, PHASE5_TARGET, device=CPU),
                                fov_y_deg=fov, width=32, height=16))
    return rays.origins, rays.directions


@pytest.mark.parametrize("world", ["surface", "cloud"])
def test_super_groups_bound_their_groups(world):
    """Each super-group's sphere holds its (up to) 32 groups' spheres, in
    float64 from the float32 table, and its radii are their largest; the
    last super-group of a scene whose N is not a multiple of 1024 holds
    only the groups there are. In index order too."""
    scene, dtab = _super_world(world)
    n_groups = dtab.groups.shape[0]
    assert n_groups % dt.SUPER_GROUPS != 0
    for tab in (dtab, dt.table_in_order(dtab.rows,
                                        torch.arange(scene.num_gaussians))):
        assert tab.supers.shape == (-(-n_groups // dt.SUPER_GROUPS),
                                    dt.GROUP_COLS)
        assert tab.supers.dtype == torch.float32
        grp, sup = tab.groups.double(), tab.supers.double()
        owner = torch.arange(n_groups) // dt.SUPER_GROUPS
        reach = (grp[:, :3] - sup[owner, :3]).norm(dim=-1) + grp[:, 3]
        assert bool((reach <= sup[owner, 3]).all())
        for i in range(sup.shape[0]):
            members = tab.groups[owner == i]
            assert torch.equal(tab.supers[i, 4:7], members[:, 4:7].amax(0))
        assert not bool(tab.supers[:, 7].any())
    # Morton order keeps a super-group's groups together: its sphere is
    # far smaller than the scene's.
    extent = (dtab.rows[:, :3].amax(0) - dtab.rows[:, :3].amin(0)).norm()
    assert float(dtab.supers[:, 3].median()) < 0.5 * float(extent)


@pytest.mark.parametrize("world", ["surface", "cloud"])
def test_dense_table_cull_columns(world):
    """The top-K kernel's cull columns: sorted_rows' mean, R0 of the trace
    and R1, a (5, N) array, bit for bit; dense_cull_keep on them gives the
    kernel's predicate."""
    scene, dtab = _super_world(world)
    n = scene.num_gaussians
    assert dtab.cull.shape == (5, n) and dtab.cull.is_contiguous()
    assert torch.equal(dtab.cull, dtab.sorted_rows[
        :, [0, 1, 2, dt.COL_R0_TRACE, dt.COL_R1]].t())
    o, d = _super_rays(scene, "primary")
    s = RenderSettings()
    cols = torch.zeros((n, dt.TABLE_COLS))
    cols[:, [0, 1, 2, dt.COL_R0_TRACE, dt.COL_R1]] = dtab.cull.t()
    assert torch.equal(dt.dense_cull_keep(o, d, cols, s),
                       dt.dense_cull_keep(o, d, dtab.sorted_rows, s))


@pytest.mark.parametrize("kind", ["primary", "bounce", "thin_far"])
@pytest.mark.parametrize("world", ["surface", "cloud"])
def test_super_keep_covers_group_keep(world, kind):
    """The top-K kernel's two-level test: every (ray, group) that
    dense_group_keep keeps lies in a super-group dense_super_keep keeps,
    so the rows reaching the exact path and the lists do not change; and
    every pair with alpha > 0 lies in a kept super-group. In the room
    the super-group test skips some (in the cloud, 5 super-groups across
    the whole volume, most rays reach them all)."""
    scene, dtab = _super_world(world)
    o, d = _super_rays(scene, kind)
    s = RenderSettings()
    sup = dt.dense_super_keep(o, d, dtab, s)
    grp = dt.dense_group_keep(o, d, dtab, s)
    assert sup.shape == (o.shape[0], dtab.supers.shape[0])
    owner = torch.arange(grp.shape[1]) // dt.SUPER_GROUPS
    assert not bool((grp & ~sup[:, owner]).any())
    mean, m, opac = dt._unpack(dtab.sorted_rows)
    _, gval = tgauss.peak_response(o[:, None], d[:, None], mean, m, s.t_min,
                                   s.t_max)
    alpha = tgauss.alpha_from_response(opac, gval, s.alpha_min, s.alpha_max,
                                       s.sigma_cut)
    rows = sup.repeat_interleave(dt.SUPER_GROUPS * dt.GROUP_ROWS, dim=1)[
        :, :scene.num_gaussians]
    assert int((alpha > 0).sum()) > 0
    assert not bool(((alpha > 0) & ~rows).any())
    if world == "surface":
        assert float(sup.float().mean()) < 1.0


def test_two_level_cull_counts():
    """tools/chunks.cull_counts on the top-K kernel's path
    (supers=True): a super-group test for each (live ray, super-group),
    group tests only in the super-groups reached (32 each, fewer in the
    short last one), the same rows tested and kept as the one-level count
    (the groups kept lie in the super-groups kept), and the exact path's
    turns, 32 kept rows a turn."""
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    scene, dtab = _super_world("surface")
    o, d = _super_rays(scene, "primary")
    s = RenderSettings()
    active = torch.from_numpy(np.random.default_rng(32).uniform(
        size=o.shape[0]) < 0.75)
    one = tch.cull_counts(dt, o, d, dtab, s, active, rays_per_pass=96)
    two = tch.cull_counts(dt, o, d, dtab, s, active, rays_per_pass=96,
                          supers=True)
    n_live, n_groups = int(active.sum()), dtab.groups.shape[0]
    assert two["live"] == n_live
    assert two["super_tests"] == n_live * dtab.supers.shape[0]
    assert one["group_tests"] == two["live_groups"] == n_live * n_groups
    sup = dt.dense_super_keep(o, d, dtab, s)[active]
    size = torch.full((dtab.supers.shape[0],), dt.SUPER_GROUPS)
    size[-1] = n_groups - dt.SUPER_GROUPS * (dtab.supers.shape[0] - 1)
    assert two["group_tests"] == int((sup * size).sum()) < one["group_tests"]
    assert (two["tested"], two["kept"]) == (one["tested"], one["kept"])
    keep = dt.dense_cull_keep(o, d, dtab.sorted_rows, s)[active]
    grp = dt.dense_group_keep(o, d, dtab, s)[active]
    kept = (keep & grp.repeat_interleave(dt.GROUP_ROWS, dim=1)[
        :, :scene.num_gaussians]).sum(1)
    assert two["kept"] == int(kept.sum()) > 0
    assert two["exact_turns"] == int(((kept + 31) // 32).sum())


def _leaves(ts, requires_grad=True):
    """The port scene with fresh leaves for GEOMETRY and sh_coeffs."""
    return ts.replace(**{k: getattr(ts, k).detach().clone()
                         .requires_grad_(requires_grad)
                         for k in GEOMETRY + ("sh_coeffs",)})


def _contributors_off_cutoffs(cloud, s):
    """Rays none of whose pairs lies within 1e-3 (relative) of the
    sigma_cut or alpha_min step (there the gradient jumps)."""
    ts, tr = cloud["tscene"], cloud["trays"]
    table = dt.gaussian_table(ts, s)
    mean, m, opac = dt._unpack(table)
    _, gval = tgauss.peak_response(tr.origins[:, None], tr.directions[:, None],
                                   mean, m, s.t_min, s.t_max)
    cut = math.exp(-0.5 * s.sigma_cut ** 2)
    near = ((gval / cut - 1.0).abs() < 1e-3) \
        | ((opac * gval / s.alpha_min - 1.0).abs() < 1e-3)
    return np.flatnonzero(~np_of(near.any(-1)))


@pytest.mark.parametrize("output", ["render_radiance_dense",
                                    "trace_dense_depth"])
def test_dense_gradients_match_jax(cloud, output):
    s, js = RenderSettings(max_contribs=32), cloud["jscene"]
    jset = JRenderSettings(max_contribs=32)
    keep = _contributors_off_cutoffs(cloud, s)
    assert len(keep) > 0.8 * cloud["trays"].num_rays
    jr = JRays(cloud["jrays"].origins[keep], cloud["jrays"].directions[keep])
    tr = Rays(cloud["trays"].origins[keep], cloud["trays"].directions[keep])
    w = np.random.default_rng(4).uniform(-1, 1, (len(keep), 3)).astype(
        np.float32)
    if output == "render_radiance_dense":
        def jloss(sc):
            return jnp.sum(jnp.asarray(w) * jref.render_radiance_dense(
                sc, jr, jset))

        def tloss(sc):
            return (torch.from_numpy(w) * tref.render_radiance_dense(
                sc, tr, s)).sum()
    else:
        def jloss(sc):
            return jnp.sum(jnp.asarray(w[:, 0])
                           * jref.trace_dense(sc, jr, jset)["depth"])

        def tloss(sc):
            return (torch.from_numpy(w[:, 0])
                    * tref.trace_dense(sc, tr, s)["depth"]).sum()

    want = jax.grad(jloss)(js)
    ts = _leaves(cloud["tscene"])
    names = GEOMETRY + ("sh_coeffs",)
    got = torch.autograd.grad(tloss(ts), [getattr(ts, k) for k in names],
                              allow_unused=True)
    for k, g in zip(names, got):
        wk = np.asarray(getattr(want, k))
        if output == "trace_dense_depth" and k == "sh_coeffs":
            assert g is None and not wk.any()   # depth ignores color
            continue
        assert g is not None and float(g.abs().max()) > 0, k
        assert_close(g, wk, GRAD_RTOL, GRAD_ATOL,
                     err_msg=k)


def test_recomputed_peaks_bit_equal_plain(cloud):
    """Where autograd wants t and alpha, dense_topk recomputes them for the
    selected pairs; on the CPU they equal the plain outputs bit for bit."""
    ts, tr = cloud["tscene"], cloud["trays"]
    s = RenderSettings(max_contribs=48)
    table = dt.gaussian_table(ts, s)
    rng = np.random.default_rng(6)
    active = torch.from_numpy(rng.uniform(0, 1, tr.num_rays) < 0.6)
    for kw in (dict(), dict(sort_depths=ts.means[:, 2].clone()),
               dict(active=active)):
        idx, t, alpha = dt.dense_topk_plain(tr.origins, tr.directions, table,
                                            48, s, **kw)
        t2, a2 = tref.selected_peaks(ts, tr.origins, tr.directions, idx,
                                     alpha > 0, s)
        assert torch.equal(t, t2) and torch.equal(alpha, a2)
        leaves = _leaves(ts)
        with torch.no_grad():
            plain = tref.dense_topk(leaves, tr, s, **kw)
        grad = tref.dense_topk(leaves, tr, s, **kw)
        assert grad[1].requires_grad and grad[2].requires_grad
        assert all(torch.equal(a, b) for a, b in zip(plain, grad))
    # Without a leaf that needs grad nothing is recomputed.
    no_grad = tref.dense_topk(_leaves(ts, False), tr, s)
    assert not no_grad[1].requires_grad


def _shadow_case(cloud, s):
    """Segments of the cloud's rays with no pair within 1e-3 (relative) of
    the alpha_min step: (o, d, t_end) numpy arrays."""
    ts, tr = cloud["tscene"], cloud["trays"]
    t_end = np.random.default_rng(9).uniform(0.2, 3.0, tr.num_rays).astype(
        np.float32)
    mean, m, opac = dt._unpack(dt.gaussian_table(ts, s))
    raw = tgauss.segment_transmittance_alpha(
        tr.origins[:, None], tr.directions[:, None], mean, m, opac, s.t_min,
        torch.from_numpy(t_end)[:, None], 0.0, s.alpha_max)
    keep = np.flatnonzero(~np_of(((raw / s.alpha_min - 1.0).abs() < 1e-3)
                                 .any(-1)))
    assert len(keep) > 0.8 * tr.num_rays
    return (np_of(tr.origins)[keep], np_of(tr.directions)[keep],
            t_end[keep])


def test_dense_visibility_gradients_match_jax(cloud):
    """On the CPU, visibility_dense differentiates through the plain
    version as the JAX reference does (segments with no pair within 1e-3
    of the alpha_min step)."""
    s, jset = RenderSettings(), JRenderSettings()
    o, d, te = _shadow_case(cloud, s)
    w = np.random.default_rng(10).uniform(-1, 1, len(te)).astype(
        np.float32)

    def jloss(sc):
        return jnp.sum(jnp.asarray(w) * jref.visibility_dense(
            sc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(te), jset))

    want = jax.grad(jloss)(cloud["jscene"])
    leaves = _leaves(cloud["tscene"])
    vis = tref.visibility_dense(leaves, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(te), s)
    got = torch.autograd.grad((torch.from_numpy(w) * vis).sum(),
                              [getattr(leaves, k) for k in GEOMETRY])
    for k, g in zip(GEOMETRY, got):
        assert float(g.abs().max()) > 0, k
        assert_close(g, np.asarray(getattr(want, k)), GRAD_RTOL, GRAD_ATOL,
                     err_msg=k)


def test_shadow_pairs_gradients_match_jax(cloud):
    """The card's shadow gradient path on the CPU: the pairs with alpha > 0
    (dense_visibility_pairs, here the plain version's), their alpha
    recomputed from the leaves and shadow_product give the gradients of
    jax.grad of the JAX visibility_dense for means, log_scales, quats and
    opacity_logits (segments off the alpha_min step)."""
    s, jset = RenderSettings(), JRenderSettings()
    o, d, te = _shadow_case(cloud, s)
    w = np.random.default_rng(10).uniform(-1, 1, len(te)).astype(np.float32)

    def jloss(sc):
        return jnp.sum(jnp.asarray(w) * jref.visibility_dense(
            sc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(te), jset))

    want = jax.grad(jloss)(cloud["jscene"])
    leaves = _leaves(cloud["tscene"])
    to, td, tte = (torch.from_numpy(x) for x in (o, d, te))
    vis, seg, gid = dt.dense_visibility_pairs(
        to, td, tte, dt.gaussian_table(leaves, s).detach(), s)
    assert seg.numel() > 0 and not vis.requires_grad
    got_vis = tref.shadow_product(leaves, to, td, tte, seg, gid, vis, s)
    got = torch.autograd.grad((torch.from_numpy(w) * got_vis).sum(),
                              [getattr(leaves, k) for k in GEOMETRY])
    for k, g in zip(GEOMETRY, got):
        assert float(g.abs().max()) > 0, k
        assert_close(g, np.asarray(getattr(want, k)), GRAD_RTOL, GRAD_ATOL,
                     err_msg=k)


def test_shadow_pairs_value_equals_plain(cloud):
    """dense_visibility_pairs on the CPU: vis bit-equal to
    dense_visibility_plain and the pairs exactly those with alpha > 0 (none
    of a masked-out segment); shadow_product keeps that value bit for bit,
    and its own product of the recomputed pairs agrees with it to
    float32 rounding."""
    s = RenderSettings()
    o, d, te = (torch.from_numpy(x) for x in _shadow_case(cloud, s))
    ts = cloud["tscene"]
    table = dt.gaussian_table(ts, s)
    active = torch.from_numpy(np.random.default_rng(12).uniform(
        0, 1, len(te)) < 0.7)
    vis, seg, gid = dt.dense_visibility_pairs(o, d, te, table, s, active)
    plain = dt.dense_visibility_plain(o, d, te, table, s, active)
    assert torch.equal(vis, plain)
    mean, m, opac = dt._unpack(table)
    alpha = tgauss.segment_transmittance_alpha(
        o[:, None], d[:, None], mean, m, opac, s.t_min, te[:, None],
        s.alpha_min, s.alpha_max)
    want_seg, want_gid = torch.nonzero((alpha > 0) & active[:, None],
                                       as_tuple=True)
    assert torch.equal(seg, want_seg) and torch.equal(gid, want_gid)
    assert not bool(active[seg].logical_not().any())
    leaves = _leaves(ts)
    out = tref.shadow_product(leaves, o, d, te, seg, gid, vis, s)
    assert out.requires_grad and torch.equal(out.detach(), plain)
    prod = torch.exp(torch.zeros_like(vis).index_add(
        0, seg, torch.log1p(-alpha[seg, gid])))
    assert_close(prod, plain, 1e-5, 1e-7)


@pytest.mark.cuda
def test_dense_visibility_gradients_on_card_match_cpu(cloud):
    """On the card visibility_dense lists the pairs with alpha > 0 and
    recomputes them in torch: its value is the no-grad launch's, bit for
    bit, and its geometry and opacity gradients match the CPU's (within
    1e-3 of each leaf's largest, as chip_smoke.py 5e: CUDA and the CPU
    round exp differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    s = RenderSettings()
    o, d, te = _shadow_case(cloud, s)
    w = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, len(te)).astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        ts = _leaves(cloud["tscene"].to(dev))
        args = tuple(torch.from_numpy(x).to(dev) for x in (o, d, te)) + (s,)
        before = launch.launches["dense_visibility_pairs"]
        vis = tref.visibility_dense(ts, *args)
        grads.append([g.cpu() for g in torch.autograd.grad(
            (w.to(dev) * vis).sum(), [getattr(ts, k) for k in GEOMETRY])])
        if dev == "cuda":
            assert launch.launches["dense_visibility_pairs"] == before + 2
            with torch.no_grad():
                assert torch.equal(vis.detach(),
                                   tref.visibility_dense(ts, *args))
    for k, g, c in zip(GEOMETRY, *grads):
        scale = float(c.abs().max())
        assert scale > 0 and float(g.abs().max()) > 0, k
        assert float((g - c).abs().max()) <= 1e-3 * scale, k


@pytest.mark.cuda
def test_dense_gradients_on_card_match_cpu(cloud):
    """The card's kernel selects, torch recomputes: gradients reach the
    geometry and match the CPU's (rtol 1e-3 of each leaf's largest, as
    chip_smoke.py 5e: CUDA and the CPU round exp differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    s = RenderSettings(max_contribs=32)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (cloud["trays"].num_rays, 3)).astype(np.float32))
    names = GEOMETRY + ("sh_coeffs",)
    grads = []
    for dev in ("cuda", "cpu"):
        ts = _leaves(cloud["tscene"].to(dev))
        tr = Rays(cloud["trays"].origins.to(dev),
                  cloud["trays"].directions.to(dev))
        before = launch.launches["dense_topk"]
        loss = (w.to(dev) * tref.render_radiance_dense(ts, tr, s)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(
            loss, [getattr(ts, k) for k in names])])
        if dev == "cuda":   # one launch of the top-K kernel
            assert launch.launches["dense_topk"] == before + 1
    for k, g, c in zip(names, *grads):
        scale = float(c.abs().max())
        assert scale > 0 and float(g.abs().max()) > 0, k
        assert float((g - c).abs().max()) <= 1e-3 * scale, k
