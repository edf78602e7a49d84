"""The dense trace's composite (``dense_trace.dense_composite``): on the
CPU its plain version against ``render/reference.trace_dense``'s gathers,
SH, normals, cumprod and weighted sums, the dispatch that keeps the plain
path on the CPU and wherever autograd wants the trace, and the dense
backend's feature table cache; on a CUDA card the kernel
(``csrc/dense_composite.cu``) against the plain version at the dense
capture's shapes, launch to launch, and its launch count."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays, look_at,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace as dt
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
    random_cloud, surface_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe
from pathtracer_gaussiansplatting_tpu_torch.render import reference as tref
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling

from torch_parity import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

# The plain version and the plain trace differ only in the order of float32
# sums (the einsum's batching; on the card the kernel's scan and per-lane
# sums): a few ulps of each sum, over at most K = 130 terms, and the
# position's sum of w o taken as o (1 - trans).
RTOL, ATOL = 1e-5, 2e-6
MATERIALS = ("metallic", "roughness", "clearcoat", "clearcoat_roughness",
             "transmission")


def shaded_scene(n, degree, seed, device="cpu", base=None):
    """``base`` (default a random cloud) with random SH of ``degree``,
    emission and materials, so every feature column is exercised."""
    scene = base if base is not None else random_cloud(n, seed=seed,
                                                       device=device)
    n = scene.num_gaussians
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    return scene.replace(
        sh_coeffs=0.4 * (rand(n, (degree + 1) ** 2, 3) - 0.5),
        emission=rand(n, 3), **{k: rand(n) for k in MATERIALS})


def inward_rays(r, seed, device="cpu", spread=0.3, dist=3.0):
    """Unit directions and origins ``dist`` back along them, through the
    middle of a cloud."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((r, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    o = -dist * d + spread * torch.randn((r, 3), generator=g, device=device)
    return Rays(o.contiguous(), d.contiguous())


def synthetic_lists(r, k, n, seed, settings, device="cpu"):
    """(idx, t, alpha) (R, K) with zeros of alpha between the contributors
    as well as after them, the padding as K1 writes it (idx 0, t_max)."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, n, (r, k), generator=g, device=device,
                        dtype=torch.int32)
    alpha = 0.9 * torch.rand((r, k), generator=g, device=device)
    alpha = torch.where(torch.rand((r, k), generator=g, device=device) < 0.3,
                        0.0, alpha)
    t = torch.sort(4.0 * torch.rand((r, k), generator=g, device=device),
                   dim=1).values
    tail = torch.arange(k, device=device)[None] >= torch.randint(
        0, k + 1, (r, 1), generator=g, device=device)
    return (torch.where(tail, 0, idx).to(torch.int32),
            torch.where(tail, settings.t_max, t),
            torch.where(tail, 0.0, alpha))


def assert_interactions_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for key in want:
        if key == "hit":
            assert torch.equal(got[key], want[key])
            continue
        torch.testing.assert_close(got[key], want[key], rtol=rtol, atol=atol,
                                   msg=key)


def plain_via_composite(scene, rays, settings, lists):
    """The interaction of ``lists`` through the plain composite and the
    epilogue the kernel path uses."""
    degree = dt.composite_degree(scene, settings)
    out = dt.dense_composite_plain(*lists, rays.directions,
                                   dt.composite_table(scene, degree), degree)
    return tref.interaction_from_composite(out, rays, settings)


@pytest.mark.parametrize("k", [8, 64, 130])
@pytest.mark.parametrize("degree", [0, 1, 3])
def test_plain_matches_trace_dense(monkeypatch, degree, k):
    """The plain composite of the table's rows against trace_dense's plain
    path, on K1's lists (padded, an active mask) and on lists with alpha
    zeros between their contributors."""
    scene = shaded_scene(300, degree, seed=degree + 1)
    rays = inward_rays(96, seed=k)
    settings = RenderSettings(max_contribs=k)
    active = torch.arange(96) % 5 != 2
    lists = tref.dense_topk(scene, rays, settings, active=active)
    assert bool((lists[2] == 0).any()) and bool((lists[2] > 0).any())
    assert bool((lists[2][~active] == 0).all())
    want = tref.trace_dense(scene, rays, settings, active=active)
    assert_interactions_close(
        plain_via_composite(scene, rays, settings, lists), want)

    fake = synthetic_lists(96, k, 300, seed=degree * 7 + k, settings=settings)
    monkeypatch.setattr(tref, "dense_topk", lambda *a, **kw: fake)
    want = tref.trace_dense(scene, rays, settings)
    assert_interactions_close(
        plain_via_composite(scene, rays, settings, fake), want)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_composite_table_rows(degree):
    """A row: the SH coefficients of the degree, emission, the five
    materials, the unflipped surfel normal, zeros; 16-byte rows."""
    from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
    scene = shaded_scene(50, 3, seed=4)
    table = dt.composite_table(scene, degree)
    kb = (degree + 1) ** 2
    cols = dt.composite_cols(degree)
    assert table.shape == (50, cols) and cols % 4 == 0
    assert cols == {0: 16, 1: 24, 2: 40, 3: 60}[degree]
    assert torch.equal(table[:, :3 * kb],
                       scene.sh_coeffs[:, :kb].reshape(50, -1))
    assert torch.equal(table[:, 3 * kb:3 * kb + 3], scene.emission)
    for j, key in enumerate(MATERIALS):
        assert torch.equal(table[:, 3 * kb + 3 + j], getattr(scene, key))
    assert torch.equal(table[:, 3 * kb + 8:3 * kb + 11],
                       gops.surfel_normal(scene.log_scales, scene.quats))
    assert not table[:, 3 * kb + 11:].any()


@pytest.mark.parametrize("leaf", SCENE_FIELDS)
def test_dispatch_keeps_plain_where_grad_is_wanted(leaf):
    """The kernel composites only rays on the card with no scene leaf (nor
    ray) wanted by autograd; a leaf that requires grad keeps the plain
    path under grad mode (and its gradient flows), not under no_grad."""
    scene = shaded_scene(200, 1, seed=2)
    rays = inward_rays(32, seed=5)
    assert not tref._trace_needs_grad(scene, rays)
    x = getattr(scene, leaf).clone().requires_grad_()
    wanting = scene.replace(**{leaf: x})
    assert tref._trace_needs_grad(wanting, rays)
    assert not tref.composite_on_card(wanting, rays)
    with torch.no_grad():
        assert not tref._trace_needs_grad(wanting, rays)
    settings = RenderSettings(max_contribs=32)
    inter = tref.trace_dense(wanting, rays, settings)
    loss = sum(v.float().sum() for k, v in inter.items() if k != "hit")
    (g,) = torch.autograd.grad(loss, x)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_cpu_takes_the_plain_path():
    """On the CPU trace_dense composites in torch: no launch, no
    ``dense_composite_rays`` count, the plain path's own bits (the
    gathers' span still encloses the work)."""
    scene = shaded_scene(200, 0, seed=6)
    rays = inward_rays(48, seed=6)
    settings = RenderSettings(max_contribs=32)
    assert not rays.origins.is_cuda
    assert not tref.composite_on_card(scene, rays)
    before = launch.launches["dense_composite"]
    profiling.reset_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                got = tref.trace_dense(scene, rays, settings)
        assert "dense_composite_rays" not in profiling.counts()
        assert profiling.counts()["dense_rays"] == 48
    finally:
        profiling.reset_counts()
    assert launch.launches["dense_composite"] == before
    assert "ptgs.gather" in {e.name for e in prof.events()}
    want = tref.trace_dense(scene, rays, settings)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("leaf", ["sh_coeffs", "emission", *MATERIALS,
                                  "log_scales", "quats"])
def test_feature_cache_refuses_stale_rows(leaf):
    """The dense backend's feature table serves its scene object only
    while no leaf has changed in place and at its SH degree; a stale or
    foreign call gets None (counted in TABLE_MISSES) and builds its own.
    The K1/K2 table still serves an edit that leaves the geometry as it
    was."""
    scene = shaded_scene(120, 1, seed=8)
    settings = RenderSettings(max_contribs=16)
    cache = tpipe.make_trace_backend(scene, settings, "dense").trace.args[0]
    assert torch.equal(cache.features(scene, settings),
                       dt.composite_table(scene, 1))
    misses = tpipe.TABLE_MISSES
    assert cache.features(scene, RenderSettings(sh_degree=0)) is None
    assert cache.features(scene.replace(), settings) is None
    assert tpipe.TABLE_MISSES == misses + 2
    with torch.no_grad():
        getattr(scene, leaf).add_(0.125)
    assert cache.features(scene, settings) is None
    assert tpipe.TABLE_MISSES == misses + 3
    geometry = leaf in ("log_scales", "quats")
    assert (cache.get(scene, settings) is None) == geometry
    rebuilt = tpipe.make_trace_backend(scene, settings, "dense").trace
    assert torch.equal(rebuilt.args[0].features(scene, settings),
                       dt.composite_table(scene, 1))


# ---- on the card -----------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def capture_lists(dev, degree=0):
    """The dense capture cell's shapes: the 40k-Gaussian room, a 65536-ray
    chunk of an 800x800 pose from inside it (the middle rows) and one of
    rays from the room's middle in all directions (as bounce rays), K1's
    lists at K = 64."""
    scene = surface_scene(40_000, seed=13, device=dev)
    if degree:
        scene = shaded_scene(0, degree, seed=21, device=dev, base=scene)
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5), device=dev),
                 fov_y_deg=45.0, width=800, height=800)
    rays = generate_rays(cam)
    mid = slice(400 * 800 - 32768, 400 * 800 + 32768)
    primary = Rays(rays.origins[mid].contiguous(),
                   rays.directions[mid].contiguous())
    bounce = inward_rays(65536, seed=3, device=dev, spread=0.4, dist=0.0)
    table = dt.dense_table(dt.gaussian_table(scene, settings))
    out = []
    for r in (primary, bounce):
        with torch.no_grad():
            lists = tref.dense_topk(scene, r, settings, table=table)
        out.append((r, lists))
    return scene, settings, out


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 3])
def test_kernel_matches_plain_on_card(degree):
    """At the dense capture's shapes (N = 40k, R = 65536, K = 64): the
    kernel against the plain version on the card; two launches give the
    same bits; one count under "dense_composite" a call."""
    dev = card()
    scene, settings, chunks = capture_lists(dev, degree)
    table = dt.composite_table(scene, degree)
    for rays, lists in chunks:
        assert float((lists[2] > 0).float().mean()) > 0.01
        want = dt.dense_composite_plain(*lists, rays.directions, table,
                                        degree)
        before = launch.launches["dense_composite"]
        got = dt.dense_composite(*lists, rays.directions, table, degree)
        again = dt.dense_composite(*lists, rays.directions, table, degree)
        torch.cuda.synchronize()
        assert launch.launches["dense_composite"] == before + 2
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 64, 130])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_kernel_synthetic_lists_on_card(degree, k):
    """Lists with alpha zeros among the contributors, the transmittance
    carried across 64-slot steps (K = 130), partial steps (K = 1, 8):
    the kernel against the plain version."""
    dev = card()
    settings = RenderSettings(max_contribs=k)
    scene = shaded_scene(500, degree, seed=k, device=dev)
    rays = inward_rays(3000, seed=k + degree, device=dev)
    lists = synthetic_lists(3000, k, 500, seed=degree, settings=settings,
                            device=dev)
    table = dt.composite_table(scene, degree)
    want = dt.dense_composite_plain(*lists, rays.directions, table, degree)
    got = dt.dense_composite(*lists, rays.directions, table, degree)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_trace_dense_on_card():
    """trace_dense on the card: under no_grad the kernel (one launch a
    trace, ``dense_composite_rays`` counted, the span ``ptgs.gather``
    around it) and the plain path's interaction within the sums' order;
    with an SH leaf that requires grad the plain path, whose gradient
    reaches the leaf. The dense backend serves its feature table."""
    dev = card()
    scene, settings, chunks = capture_lists(dev)
    rays, _ = chunks[0]
    backend = tpipe.make_trace_backend(scene, settings, "dense")
    misses, before = tpipe.TABLE_MISSES, launch.launches["dense_composite"]
    profiling.reset_counts()
    try:
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = backend.trace(scene, rays, settings)
            torch.cuda.synchronize()
        assert profiling.counts()["dense_composite_rays"] == rays.num_rays
    finally:
        profiling.reset_counts()
    assert launch.launches["dense_composite"] == before + 1
    assert tpipe.TABLE_MISSES == misses
    names = [e.name for e in prof.events()]
    assert "ptgs.gather" in names
    assert any("dense_composite_kernel" in x for x in names)
    assert not any("vectorized_gather_kernel" in x for x in names)
    sh = scene.sh_coeffs.clone().requires_grad_()
    wanting = scene.replace(sh_coeffs=sh)
    want = tref.trace_dense(wanting, rays, settings)
    assert launch.launches["dense_composite"] == before + 1
    (g,) = torch.autograd.grad(want["albedo"].sum(), sh)
    assert float(g.abs().sum()) > 0
    want = {k: v.detach() for k, v in want.items()}
    hit = want["alpha_acc"] > 1e-3
    assert float(hit.float().mean()) > 0.5
    for key in want:
        if key in ("hit", "normal"):
            continue
        torch.testing.assert_close(got[key], want[key], rtol=RTOL, atol=ATOL,
                                   msg=key)
    # The normal is normalized: compare where the rays hit something.
    torch.testing.assert_close(got["normal"][hit], want["normal"][hit],
                               rtol=1e-4, atol=1e-5)
    assert np.isclose(float((got["hit"] != want["hit"]).float().mean()), 0.0,
                      atol=1e-4)
