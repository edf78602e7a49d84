"""The port's dense backend vs the JAX package (CPU): the quadratic ops,
compositing, dense_topk (with and without sort depths, with ties),
trace_dense (with an active mask), visibility_dense and
render_radiance_dense; the plain versions chunked and unchunked; and the
dense kernels against their plain versions (on a CUDA card only)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops import composite as jcomp
from pathtracer_gaussiansplatting_tpu.ops import gaussians as jgauss
from pathtracer_gaussiansplatting_tpu.render import pipeline as jpipe
from pathtracer_gaussiansplatting_tpu.render import reference as jref
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace as dt
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.ops import composite as tcomp
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as tgauss
from pathtracer_gaussiansplatting_tpu_torch.ops import safe_math as tsafe
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe
from pathtracer_gaussiansplatting_tpu_torch.render import reference as tref

from torch_parity import (
    TORCH_THREADS, assert_close, cameras, np_of, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

# Splats of sigma 0.2-0.5 keep the quadratic well conditioned (ROADMAP
# section 3, cutoff flips): no alpha sits at a cutoff. XLA's einsum and the
# port's multiply-add chains still round q = c - b^2/a differently by
# ~c * eps32 (c ~ 400 for camera rays), so gval and alpha agree to ~1e-4
# relative.
RTOL, ATOL = 2e-4, 2e-6
N_GAUSS = 300


@pytest.fixture(scope="module")
def scene_rays():
    jscene = j_random_cloud(N_GAUSS, seed=13, spread=1.2,
                            scale_range=(-1.8, -0.8), emissive_frac=0.1)
    jcam, tcam = cameras(width=48, height=32)
    from pathtracer_gaussiansplatting_tpu.core.camera import generate_rays
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        generate_rays as t_generate_rays,
    )

    jr, tr = generate_rays(jcam), t_generate_rays(tcam)
    # Half the rays start inside the cloud in random directions, as bounce
    # rays do.
    rng = np.random.default_rng(9)
    o = np.array(jr.origins)
    d = np.array(jr.directions)
    o[::2] = rng.uniform(-1, 1, (len(o[::2]), 3))
    dd = rng.normal(size=(len(d[::2]), 3))
    d[::2] = dd / np.linalg.norm(dd, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return dict(jscene=jscene, tscene=to_torch_scene(jscene),
                jrays=JRays(jnp.asarray(o), jnp.asarray(d)),
                trays=Rays(torch.from_numpy(o), torch.from_numpy(d)))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_gaussian_ops_match(scene_rays):
    js = scene_rays["jscene"]
    ts = scene_rays["tscene"]
    o = scene_rays["jrays"].origins[:, None]
    d = scene_rays["jrays"].directions[:, None]
    to, td = scene_rays["trays"].origins[:, None], \
        scene_rays["trays"].directions[:, None]
    jm = jgauss.canonical_transforms(js.log_scales, js.quats)[None]
    tm = tgauss.canonical_transforms(ts.log_scales, ts.quats)[None]
    jmu, tmu = js.means[None], ts.means[None]
    for g, w in zip(tgauss.ray_quadratic(to, td, tmu, tm),
                    jgauss.ray_quadratic(o, d, jmu, jm)):
        assert_close(g, w, 1e-4, 1e-4)
    for g, w in zip(tgauss.peak_response(to, td, tmu, tm),
                    jgauss.peak_response(o, d, jmu, jm)):
        assert_close(g, w, RTOL, ATOL)
    rng = np.random.default_rng(2)
    t_end = rng.uniform(0.1, 6.0, (o.shape[0], 1)).astype(np.float32)
    assert_close(
        tgauss.segment_transmittance_alpha(
            to, td, tmu, tm, ts.opacities[None], 1e-3,
            torch.from_numpy(t_end)),
        jgauss.segment_transmittance_alpha(
            o, d, jmu, jm, js.opacities[None], 1e-3, jnp.asarray(t_end)),
        RTOL, ATOL)
    x = _rand(rng, 64, 3)
    view = _rand(rng, 64, 3)
    for vd in (None, view):
        assert_close(
            tgauss.gaussian_normal(
                torch.from_numpy(x), ts.means[:64], tm[0, :64],
                None if vd is None else torch.from_numpy(vd)),
            jgauss.gaussian_normal(jnp.asarray(x), js.means[:64], jm[0, :64],
                                   None if vd is None else jnp.asarray(vd)),
            1e-4, 1e-5)


def test_composite_and_safe_sqrt_match():
    rng = np.random.default_rng(6)
    alphas = rng.uniform(0, 0.999, (32, 40)).astype(np.float32)
    alphas[:, ::4] = 0.0
    feats = _rand(rng, 32, 40, 5)
    for g, w in zip(tcomp.composite(torch.from_numpy(alphas),
                                    torch.from_numpy(feats)),
                    jcomp.composite(jnp.asarray(alphas), jnp.asarray(feats))):
        assert_close(g, w, 1e-5, 1e-6)
    assert_close(tcomp.transmittance(torch.from_numpy(alphas)),
                 jcomp.transmittance(jnp.asarray(alphas)), 1e-5, 1e-7)
    x = np.array([-1.0, 0.0, 1e-14, 1e-6, 2.0], np.float32)
    from pathtracer_gaussiansplatting_tpu.ops.safe_math import safe_sqrt

    assert_close(tsafe.safe_sqrt(torch.from_numpy(x)), safe_sqrt(x), 0, 0)


def _sort_depths(scene, ties: bool):
    depth = np.asarray(scene.means)[:, 2] * -1.0 + 4.0
    if ties:   # quarter-unit steps: many Gaussians share each depth
        depth = np.round(depth * 4.0) / 4.0
    return depth.astype(np.float32)


@pytest.mark.parametrize("order", ["peak_t", "sort_depths", "tied_depths",
                                   "k_above_n", "k_above_128"])
def test_dense_topk_matches(scene_rays, order):
    """The top-K against the JAX package: K = 64 by peak t and by sort
    depths (with ties), K above N, and 128 < K < N (the card's list
    kernel), where some rays keep more than K."""
    js, ts = scene_rays["jscene"], scene_rays["tscene"]
    max_contribs = dict(k_above_n=400, k_above_128=160).get(order, 64)
    jset = JRenderSettings(max_contribs=max_contribs)
    tset = RenderSettings(max_contribs=max_contribs)
    sd = None if order in ("peak_t", "k_above_n", "k_above_128") \
        else _sort_depths(js, order == "tied_depths")
    want = jref.dense_topk(js, scene_rays["jrays"], jset,
                           None if sd is None else jnp.asarray(sd))
    got = tref.dense_topk(ts, scene_rays["trays"], tset,
                          None if sd is None else torch.from_numpy(sd))
    k = min(max_contribs, N_GAUSS)
    assert got[0].shape == (scene_rays["trays"].num_rays, k)
    assert got[0].dtype == torch.int32
    valid = np.asarray(want[2]) > 0
    assert np.array_equal(np_of(got[2]) > 0, valid)
    if order != "k_above_n":
        assert valid.sum(-1).max() == k   # rays with more than K kept
    # Ordered by the per-ray t, two Gaussians whose t differ by an ulp or
    # two may swap between the packages (exact ties, as at the t_min clamp,
    # go by index in both); sort depths are the same floats in both, so
    # there every slot must match.
    t = np.asarray(want[1])
    near_tie = np.zeros_like(valid)
    if sd is None:
        gap = np.abs(np.diff(t, axis=-1))
        close = (gap > 0) & (gap <= 1e-5 * np.abs(t[:, 1:]))
        near_tie[:, 1:] |= close
        near_tie[:, :-1] |= close
        assert (near_tie & valid).sum() <= 1e-2 * valid.sum()
    sure = valid & ~near_tie
    assert np.array_equal(np_of(got[0])[sure], np.asarray(want[0])[sure])
    assert (np_of(got[0])[~valid] == 0).all()
    assert_close(got[1], want[1], RTOL, ATOL)
    assert_close(np_of(got[2])[sure], np.asarray(want[2])[sure], RTOL, ATOL)
    if order == "tied_depths":   # ties really happen among the kept slots
        kept = np.where(valid, sd[np.asarray(want[0])], np.nan)
        assert (np.diff(kept, axis=-1) == 0).sum() > 100


def test_trace_dense_matches(scene_rays):
    js, ts = scene_rays["jscene"], scene_rays["tscene"]
    active = np.random.default_rng(8).uniform(
        0, 1, scene_rays["trays"].num_rays) < 0.7
    jset = JRenderSettings(max_contribs=48)
    tset = RenderSettings(max_contribs=48)
    for act in (None, active):
        want = jref.trace_dense(js, scene_rays["jrays"], jset,
                                active=None if act is None
                                else jnp.asarray(act))
        got = tref.trace_dense(ts, scene_rays["trays"], tset,
                               active=None if act is None
                               else torch.from_numpy(act))
        assert set(got) == set(want)
        for k in want:
            if k == "hit":
                assert np.array_equal(np_of(got[k]), np.asarray(want[k]))
            else:
                assert_close(got[k], want[k], 1e-4, 1e-5, err_msg=k)
        if act is not None:
            assert (np_of(got["alpha_acc"])[~act] == 0).all()
            assert (np_of(got["alpha_acc"])[act] > 0.5).any()


def test_visibility_dense_matches(scene_rays):
    js, ts = scene_rays["jscene"], scene_rays["tscene"]
    rng = np.random.default_rng(10)
    r = scene_rays["trays"].num_rays
    t_end = rng.uniform(-0.1, 6.0, r).astype(np.float32)   # some empty
    active = rng.uniform(0, 1, r) < 0.6
    o, d = scene_rays["jrays"].origins, scene_rays["jrays"].directions
    to, td = scene_rays["trays"].origins, scene_rays["trays"].directions
    want = jref.visibility_dense(js, o, d, jnp.asarray(t_end),
                                 JRenderSettings())
    got = tref.visibility_dense(ts, to, td, torch.from_numpy(t_end),
                                RenderSettings())
    assert_close(got, want, RTOL, 1e-6)
    assert float(got.min()) < 0.5
    # The backends' visibility with the active mask.
    jvis = jpipe.make_trace_backend(js, JRenderSettings(), "dense")[1]
    want = jvis(o, d, jnp.asarray(t_end), active=jnp.asarray(active))
    vis, frozen = tpipe.make_trace_backend(ts, RenderSettings(), "dense"
                                           ).visibility(
        to, td, torch.from_numpy(t_end), torch.from_numpy(active))
    assert frozen == 0
    assert_close(vis, want, RTOL, 1e-6)
    assert (np_of(vis)[~active] == 1.0).all()


def test_render_radiance_dense_matches(scene_rays):
    bg = (0.1, 0.2, 0.3)
    want = jref.render_radiance_dense(scene_rays["jscene"],
                                      scene_rays["jrays"],
                                      JRenderSettings(background=bg))
    got = tref.render_radiance_dense(scene_rays["tscene"],
                                     scene_rays["trays"],
                                     RenderSettings(background=bg))
    assert_close(got, want, 1e-4, 1e-5)


def test_plain_chunked_equals_unchunked(scene_rays, monkeypatch):
    """Chunks of 7 rays, bit-equal to one chunk, with sort depths and an
    active mask."""
    ts, tr = scene_rays["tscene"], scene_rays["trays"]
    table = dt.gaussian_table(ts, RenderSettings())
    rng = np.random.default_rng(12)
    active = torch.from_numpy(rng.uniform(0, 1, tr.num_rays) < 0.5)
    t_end = torch.from_numpy(rng.uniform(0.1, 6, tr.num_rays)
                             .astype(np.float32))
    sd = torch.from_numpy(_sort_depths(scene_rays["jscene"], True))
    s = RenderSettings()
    args = (tr.origins, tr.directions, table, 64, s)
    whole = (dt.dense_topk_plain(*args),
             dt.dense_topk_plain(*args, sort_depths=sd, active=active),
             dt.dense_visibility_plain(tr.origins, tr.directions, t_end,
                                       table, s, active))
    monkeypatch.setattr(dt, "PLAIN_CHUNK_ELEMS", 7 * N_GAUSS)
    chunked = (dt.dense_topk_plain(*args),
               dt.dense_topk_plain(*args, sort_depths=sd, active=active),
               dt.dense_visibility_plain(tr.origins, tr.directions, t_end,
                                         table, s, active))
    for a, b in zip(whole[:2], chunked[:2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(whole[2], chunked[2])
    # An inactive ray holds exactly the invalid slots.
    idx, t, alpha = whole[1]
    assert (idx[~active] == 0).all() and (alpha[~active] == 0).all()
    assert (t[~active] == s.t_max).all()


def test_dispatch_cpu_and_no_fallback(scene_rays):
    ts, tr = scene_rays["tscene"], scene_rays["trays"]
    table = dt.gaussian_table(ts, RenderSettings())
    s = RenderSettings()
    before = (launch.launches["dense_topk"], launch.launches["dense_visibility"])
    got = dt.dense_topk(tr.origins, tr.directions, table, 64, s)
    want = dt.dense_topk_plain(tr.origins, tr.directions, table, 64, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    t_end = torch.full((tr.num_rays,), 3.0)
    assert torch.equal(
        dt.dense_visibility(tr.origins, tr.directions, t_end, table, s),
        dt.dense_visibility_plain(tr.origins, tr.directions, t_end, table,
                                  s))
    assert (launch.launches["dense_topk"], launch.launches["dense_visibility"]) == before
    meta = [x.to("meta") for x in (tr.origins, tr.directions, table)]
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        dt.dense_topk(*meta, 64, s)
    with pytest.raises(ValueError):
        dt.dense_visibility(meta[0], tr.directions, t_end, table, s)


def _card_inputs(n_rays=4096, thin_far=False):
    """Surface-scene rays on the card: half camera rays, half from the
    surfaces in random directions; or (thin_far) rays of a camera 20 times
    farther than chip_smoke.py phase 5's at surfels 50 times thinner than
    wide."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    dev = torch.device("cuda", 0)
    scene = surface_scene(5000, seed=13, flatness=0.02 if thin_far else 0.1,
                          device=dev)
    rng = np.random.default_rng(14)
    eye = np.array([0.0, 0.2, 1.7])
    if thin_far:   # phase 5's eye, 20x farther from its target
        eye = np.array([0.0, -0.4, -0.5]) + 20.0 * (eye - [0.0, -0.4, -0.5])
    o = np.tile(eye[None], (n_rays, 1))
    d = rng.normal(size=(n_rays, 3))
    if thin_far:   # towards the room
        d = rng.uniform(-1.5, 1.5, (n_rays, 3)) - eye
    else:
        o[::2] = np.asarray(scene.means.cpu())[:n_rays // 2] + 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa
    return scene, dt.gaussian_table(scene, RenderSettings()), f(o), f(d), \
        f(rng.uniform(0.1, 3.0, n_rays)), torch.from_numpy(rng.uniform(
            0, 1, n_rays) < 0.8).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1", "k32", "k64", "k128", "tied_depths",
                                  "thin_far", "k_n"])
def test_dense_topk_kernel_matches_plain_on_card(case):
    """The culled kernel against the unculled plain version: every output
    bit-equal, at K = 1, 32, 64, 128 and N, ordered by sort depths with
    ties, and for thin surfels seen from far; one launch of the one
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    scene, table, o, d, _, active = _card_inputs(thin_far=case == "thin_far")
    k = dict(k1=1, k32=32, k128=128,
             k_n=scene.num_gaussians).get(case, 64)
    sd = None
    if case == "tied_depths":   # quarter-unit steps: many equal keys
        sd = torch.round(scene.means[:, 2] * 4.0) / 4.0
    s = RenderSettings()
    before = launch.launches["dense_topk"]
    got = dt.dense_topk(o, d, table, k, s, sort_depths=sd, active=active)
    torch.cuda.synchronize()
    assert launch.launches["dense_topk"] == before + 1
    want = dt.dense_topk_plain(o, d, table, k, s, sort_depths=sd,
                               active=active)
    assert int((want[2] > 0).sum()) > 0
    for g, w in zip(got, want):   # the same operations, rounded alike
        assert torch.equal(g, w)


def _cloud_inputs(n_rays=4096):
    """Rays through a dense cloud on the card (random_cloud(5000), 177
    contributions a camera ray on average, up to 542): half from the
    camera, half from inside the cloud in random directions; with an
    active mask."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )

    dev = torch.device("cuda", 0)
    scene = random_cloud(5000, seed=13, spread=1.5, device=dev)
    rng = np.random.default_rng(15)
    o = np.tile(np.array([[0.0, 0.5, 4.0]]), (n_rays, 1))
    d = np.array([0.0, 0.0, 0.0]) - o + rng.uniform(-1.5, 1.5, o.shape)
    o[1::2] = rng.uniform(-1.0, 1.0, (n_rays // 2, 3))
    d[1::2] = rng.normal(size=(n_rays // 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa
    return scene, dt.gaussian_table(scene, RenderSettings()), f(o), f(d), \
        torch.from_numpy(rng.uniform(0, 1, n_rays) < 0.8).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k160", "k256_tied", "k512", "k2048",
                                  "k_n", "k160_thin_far"])
def test_dense_topk_list_kernel_matches_plain_on_card(case):
    """The kernel's lists above K = 128 against the plain version, every
    output bit-equal: in shared memory at K = 160, 256 (ordered by sort
    depths with ties) and 512, in global memory at K = 2048 and at K = N,
    on rays with up to ~540 contributions; and at K = 160 for thin surfels
    seen from far (the group tests' skips); one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    if case == "k160_thin_far":
        scene, table, o, d, _, active = _card_inputs(thin_far=True)
    else:
        scene, table, o, d, active = _cloud_inputs()
    n = scene.num_gaussians
    k = dict(k256_tied=256, k512=512, k2048=2048, k_n=n).get(case, 160)
    sd = None
    if case == "k256_tied":   # quarter-unit steps: many equal keys
        sd = torch.round(scene.means[:, 2] * 4.0) / 4.0
    s = RenderSettings()
    before = launch.launches["dense_topk"]
    got = dt.dense_topk(o, d, table, k, s, sort_depths=sd, active=active)
    torch.cuda.synchronize()
    assert launch.launches["dense_topk"] == before + 1
    want = dt.dense_topk_plain(o, d, table, k, s, sort_depths=sd,
                               active=active)
    assert int((want[2] > 0).sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["segments", "thin_far"])
def test_dense_visibility_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    _, table, o, d, t_end, active = _card_inputs(thin_far=case == "thin_far")
    if case == "thin_far":
        t_end = t_end * 20.0
    s = RenderSettings()
    before = launch.launches["dense_visibility"]
    got = dt.dense_visibility(o, d, t_end, table, s, active)
    torch.cuda.synchronize()
    assert launch.launches["dense_visibility"] == before + 1
    want = dt.dense_visibility_plain(o, d, t_end, table, s, active)
    # The product runs in another order than torch.prod's reduction.
    assert_close(got, want, 1e-5, 1e-6)
