"""The port's gradients vs the JAX package (CPU): the compositing VJP, the
fused tile composite's backward (plain version and autograd Function), and
the whole tile pipeline; the backward kernel vs its plain version (on a
CUDA card only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.kernels import tile_composite as jtc
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops import composite as jcomposite
from pathtracer_gaussiansplatting_tpu.ops.binning import (
    BinningConfig as JBinningConfig,
)
from pathtracer_gaussiansplatting_tpu.render import tiled as jtiled
from pathtracer_gaussiansplatting_tpu.utils import metrics as jmetrics
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, RenderSettings, scene_from_numpy, scene_to_numpy,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc
from pathtracer_gaussiansplatting_tpu_torch.models.scene import SceneParams
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)
from pathtracer_gaussiansplatting_tpu_torch.render import tiled
from pathtracer_gaussiansplatting_tpu_torch.utils import metrics

from torch_parity import (
    CPU, TORCH_THREADS, assert_close, cameras, np_of, pose_packets,
    to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

# The reference's tolerance for its analytic backward against autodiff
# (tests/test_pallas_kernels.py, TestAnalyticBackward).
BWD_RTOL, BWD_ATOL = 2e-3, 2e-4
GRAD_NAMES = ("d_geom", "d_featsT", "d_dirs")


def _cotangent(t_total, p, f, alpha_acc, seed=3):
    """Seeded cotangents (out, alpha_acc, depth), the depth one masked
    where alpha_acc <= 1e-3 (its gradient divides by alpha_acc)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t_total, p, f)).astype(np.float32),
            rng.normal(size=(t_total, p)).astype(np.float32),
            (rng.normal(size=(t_total, p))
             * (np.asarray(alpha_acc) > 1e-3)).astype(np.float32))


@pytest.fixture(scope="module")
def multi_chunk():
    """K=256 packets (two 128-slot chunks) of a near, dense pose where the
    second chunk is skipped on some tiles, with a seeded cotangent."""
    packets, dirs, tpk, tdirs = pose_packets(
        600, 1.0, 256, eye=(0.0, 0.0, 1.5), scale_range=(-2.0, -1.0))
    packets = {k: packets[k] for k in ("geom", "featsT", "count")}
    settings = JRenderSettings()
    alpha_acc = jtc._tile_composite_xla(packets, dirs, settings)[1]
    cot = _cotangent(*tdirs.shape[:2], tpk["featsT"].shape[1], alpha_acc)
    # Tiles whose second chunk the kernels skip: transmittance after the
    # first 128 slots at or below the threshold.
    first = dict(packets, geom=packets["geom"][..., :128],
                 featsT=packets["featsT"][..., :128])
    trans1 = 1.0 - np.asarray(jtc._tile_composite_xla(first, dirs,
                                                      settings)[1])
    skipped = ((np.asarray(packets["count"]) > 128)
               & (trans1.max(-1) <= settings.transmittance_min))
    return dict(packets=packets, dirs=dirs, tpk=tpk, tdirs=tdirs, cot=cot,
                skipped=skipped)


@pytest.mark.parametrize("k", [8, 64])
def test_composite_weights_grad_matches_jax(k):
    """The analytic suffix-sum VJP vs the reference's custom VJP, with
    alphas at 0 (masked) and at alpha_max among them."""
    rng = np.random.default_rng(k)
    alphas = rng.uniform(0.0, 0.999, size=(3, 5, k)).astype(np.float32)
    alphas[rng.uniform(size=alphas.shape) < 0.2] = 0.0
    alphas[rng.uniform(size=alphas.shape) < 0.1] = 0.999
    g_w = rng.normal(size=alphas.shape).astype(np.float32)
    g_t = rng.normal(size=alphas.shape[:-1]).astype(np.float32)
    (jw, jt), vjp = jax.vjp(jcomposite.composite_weights, jnp.asarray(alphas))
    (ja,) = vjp((jnp.asarray(g_w), jnp.asarray(g_t)))
    ta = torch.from_numpy(alphas).requires_grad_()
    tw, tt = composite_weights(ta)
    (ga,) = torch.autograd.grad((tw, tt), ta, (torch.from_numpy(g_w),
                                               torch.from_numpy(g_t)))
    assert_close(tw, jw, 1e-6, 1e-7, err_msg="weights")
    assert_close(tt, jt, 1e-6, 1e-7, err_msg="trans")
    assert_close(ga, ja, 1e-4, 1e-5, err_msg="d_alpha")


def test_bwd_plain_matches_xla_vjp(multi_chunk, monkeypatch):
    """tile_composite_bwd_plain vs jax.vjp of the reference's oracle
    (_tile_composite_xla) at the default settings, in chunks of 5 tiles."""
    monkeypatch.setattr(tc, "PLAIN_CHUNK_ELEMS", 5 * 256 * 256)
    mc = multi_chunk
    settings = JRenderSettings()
    _, vjp = jax.vjp(lambda pk, dd: jtc._tile_composite_xla(pk, dd, settings),
                     mc["packets"], mc["dirs"])
    want_pk, want_dirs = vjp(tuple(jnp.asarray(c) for c in mc["cot"]))
    got = tc.tile_composite_bwd_plain(
        mc["tpk"], mc["tdirs"], tuple(torch.from_numpy(c) for c in mc["cot"]),
        RenderSettings())
    want = (want_pk["geom"], want_pk["featsT"], want_dirs)
    for g, w, name in zip(got, want, GRAD_NAMES):
        assert_close(g, w, BWD_RTOL, BWD_ATOL, err_msg=name)


@pytest.mark.parametrize("transmittance_min", [0.0, None])
def test_function_grads_match_pallas(multi_chunk, transmittance_min):
    """Gradients through tile_composite (the TileComposite Function) vs the
    reference's analytic Pallas backward in interpret mode. With no
    transmittance cutoff everywhere; at the default cutoff on the tiles
    where the Pallas kernel skips no chunk (it gives skipped chunks exactly
    zero, the port's plain backward their full-K gradient)."""
    mc = multi_chunk
    jset, tset = JRenderSettings(), RenderSettings()
    if transmittance_min is not None:
        jset = dataclasses.replace(jset, transmittance_min=transmittance_min)
        tset = dataclasses.replace(tset, transmittance_min=transmittance_min)
    _, vjp = jax.vjp(lambda pk, dd: jtc.tile_composite(pk, dd, jset, True),
                     mc["packets"], mc["dirs"])
    want_pk, want_dirs = vjp(tuple(jnp.asarray(c) for c in mc["cot"]))
    ins = [mc["tpk"]["geom"].clone().requires_grad_(),
           mc["tpk"]["featsT"].clone().requires_grad_(),
           mc["tdirs"].clone().requires_grad_()]
    before = launch.launches["tile_bwd"]
    outs = tc.tile_composite(dict(geom=ins[0], featsT=ins[1],
                                  count=mc["tpk"]["count"]), ins[2], tset)
    got = torch.autograd.grad(outs, ins, tuple(torch.from_numpy(c)
                                               for c in mc["cot"]))
    assert launch.launches["tile_bwd"] == before
    keep = slice(None) if transmittance_min == 0.0 else ~mc["skipped"]
    assert mc["skipped"].any() and (~mc["skipped"]).any()
    want = (want_pk["geom"], want_pk["featsT"], want_dirs)
    for g, w, name in zip(got, want, GRAD_NAMES):
        assert_close(np_of(g)[keep], np_of(w)[keep], BWD_RTOL, BWD_ATOL,
                     err_msg=name)


@pytest.mark.parametrize("tile_size", [8, 12, 24, 32, 48])
def test_function_grads_match_pallas_tile_sizes(tile_size):
    """Gradients through tile_composite vs the Pallas backward in interpret
    mode at tile sizes other than 16 (P = 64, 144, 576, 1024 and 2304
    pixels a tile), with no transmittance cutoff, on multi_chunk's near
    pose (far thin splats' gradients cancel in float32: dirs_term_mass in
    chip_smoke.py)."""
    packets, dirs, tpk, tdirs = pose_packets(
        600, 1.0, 128, eye=(0.0, 0.0, 1.5), scale_range=(-2.0, -1.0),
        tile_size=tile_size)
    packets = {k: packets[k] for k in ("geom", "featsT", "count")}
    jset = JRenderSettings(transmittance_min=0.0)
    tset = RenderSettings(transmittance_min=0.0)
    alpha_acc = jtc._tile_composite_xla(packets, dirs, jset)[1]
    cot = _cotangent(*tdirs.shape[:2], tpk["featsT"].shape[1], alpha_acc,
                     seed=tile_size)
    _, vjp = jax.vjp(lambda pk, dd: jtc.tile_composite(pk, dd, jset, True),
                     packets, dirs)
    want_pk, want_dirs = vjp(tuple(jnp.asarray(c) for c in cot))
    ins = [tpk["geom"].clone().requires_grad_(),
           tpk["featsT"].clone().requires_grad_(),
           tdirs.clone().requires_grad_()]
    outs = tc.tile_composite(dict(geom=ins[0], featsT=ins[1],
                                  count=tpk["count"]), ins[2], tset)
    got = torch.autograd.grad(outs, ins, tuple(torch.from_numpy(c)
                                               for c in cot))
    want = (want_pk["geom"], want_pk["featsT"], want_dirs)
    for g, w, name in zip(got, want, GRAD_NAMES):
        assert_close(g, w, BWD_RTOL, BWD_ATOL, err_msg=name)


def test_pipeline_scene_grads_match_jax():
    """Scene gradients of mean(color^2) through prepare_tiles +
    render_prepared in both packages (the reference's Pallas kernels in
    interpret mode): each leaf within 1e-3 of its largest |gradient| (plus
    rtol 2e-3); the leaves the color does not see get exactly 0 in both."""
    jscene = j_random_cloud(96, seed=13, scale_range=(-1.8, -0.8))
    jcam, tcam = cameras(width=32, height=32)
    jcfg, tcfg = JBinningConfig(max_per_tile=32), BinningConfig(max_per_tile=32)
    jset, tset = JRenderSettings(), RenderSettings()

    def jloss(scene):
        pk = jtiled.prepare_tiles(scene, jcam, jset, jcfg)
        img = jtiled.render_prepared(pk, jcam, jset, jcfg,
                                     outputs=("color",))["color"]
        return jnp.mean(img ** 2)

    jl, jg = jax.value_and_grad(jloss)(jscene)
    params = SceneParams.from_scene(to_torch_scene(jscene))
    pk = tiled.prepare_tiles(params.scene(), tcam, tset, tcfg)
    img = tiled.render_prepared(pk, tcam, tset, tcfg,
                                outputs=("color",))["color"]
    tl = torch.mean(img ** 2)
    tl.backward()
    assert_close(tl, jl, 1e-5, 0.0)
    tg = scene_to_numpy(params.grad_scene())
    for f in SCENE_FIELDS:
        want = np.asarray(getattr(jg, f))
        scale = np.abs(want).max()
        if scale == 0:
            assert not tg[f].any(), f
        else:
            assert_close(tg[f], want, 2e-3, 1e-3 * scale, err_msg=f)


@pytest.mark.parametrize("shape", [(40, 33, 3), (24, 30)])
def test_metrics_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("mse", "psnr", "ssim"):
        got = getattr(metrics, name)(ta, tb)
        want = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))
        assert_close(got, want, 1e-5, 1e-7, err_msg=name)


def test_scene_params_round_trip():
    """SceneParams holds the 11 leaves as parameters; scene_to_numpy undoes
    scene_from_numpy, for parameters and for their gradients."""
    jscene = j_random_cloud(20, seed=3, sh_degree=1)
    leaves = {f: np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS}
    params = SceneParams.from_scene(scene_from_numpy(leaves, CPU))
    assert [n for n, _ in params.named_parameters()] == list(SCENE_FIELDS)
    assert all(p.requires_grad for p in params.parameters())
    back = scene_to_numpy(params.scene())
    for f in SCENE_FIELDS:
        assert back[f].dtype == np.float32
        np.testing.assert_array_equal(back[f], leaves[f], err_msg=f)
    assert not any(g.any() for g in scene_to_numpy(
        params.grad_scene()).values())
    torch.sum(params.scene().opacities).backward()
    grads = scene_to_numpy(params.grad_scene())
    s = 1.0 / (1.0 + np.exp(-leaves["opacity_logits"]))
    np.testing.assert_allclose(grads["opacity_logits"], s * (1 - s),
                               rtol=1e-6)
    assert not grads["means"].any()


def test_bwd_dispatch_cpu_and_no_fallback(multi_chunk):
    """CPU tensors take the plain backward; any other device must launch
    the kernel or raise, never fall back."""
    mc = multi_chunk
    cot = tuple(torch.from_numpy(c) for c in mc["cot"])
    settings = RenderSettings()
    before = launch.launches["tile_bwd"]
    got = tc.tile_composite_bwd(mc["tpk"], mc["tdirs"], cot, settings)
    want = tc.tile_composite_bwd_plain(mc["tpk"], mc["tdirs"], cot, settings)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch.launches["tile_bwd"] == before
    meta = {k: v.to("meta") for k, v in mc["tpk"].items()}
    meta_cot = tuple(c.to("meta") for c in cot)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tc.tile_composite_bwd(meta, mc["tdirs"].to("meta"), meta_cot,
                              settings)
    with pytest.raises(ValueError):
        tc.tile_composite_bwd(mc["tpk"], mc["tdirs"], meta_cot, settings)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tc.TileComposite.apply(meta["geom"], meta["featsT"],
                               mc["tdirs"].to("meta"), meta["count"],
                               settings)
    assert launch.launches["tile_bwd"] == before


def test_function_d_dirs_only_where_asked(multi_chunk):
    """TileComposite passes down whether dirs requires grad: d_geom and
    d_featsT are identical either way, and no d_dirs comes back (dirs.grad
    stays None) where it is not asked; tile_composite_bwd and its plain
    version drop it the same way."""
    mc = multi_chunk
    cot = tuple(torch.from_numpy(c) for c in mc["cot"])
    settings = RenderSettings()
    grads = {}
    for want_dirs in (True, False):
        ins = [mc["tpk"]["geom"].clone().requires_grad_(),
               mc["tpk"]["featsT"].clone().requires_grad_(),
               mc["tdirs"].clone().requires_grad_(want_dirs)]
        outs = tc.tile_composite(dict(geom=ins[0], featsT=ins[1],
                                      count=mc["tpk"]["count"]), ins[2],
                                 settings)
        torch.autograd.backward(outs, cot)
        grads[want_dirs] = [x.grad for x in ins]
    assert all(torch.equal(a, b) for a, b in zip(grads[True][:2],
                                                 grads[False][:2]))
    assert grads[True][2] is not None and grads[False][2] is None
    full = tc.tile_composite_bwd(mc["tpk"], mc["tdirs"], cot, settings)
    for fn in (tc.tile_composite_bwd, tc.tile_composite_bwd_plain):
        got = fn(mc["tpk"], mc["tdirs"], cot, settings, want_dirs=False)
        assert got[2] is None
        assert all(torch.equal(a, b) for a, b in zip(got[:2], full[:2]))


@pytest.mark.cuda
def test_bwd_kernel_matches_plain_on_card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    mc = request.getfixturevalue("multi_chunk")
    dev = torch.device("cuda", 0)
    packets = {k: v.to(dev) for k, v in mc["tpk"].items()}
    dirs = mc["tdirs"].to(dev)
    cot = tuple(torch.from_numpy(c).to(dev) for c in mc["cot"])
    settings = RenderSettings(transmittance_min=0.0)
    before = launch.launches["tile_bwd"]
    got = tc.tile_composite_bwd(packets, dirs, cot, settings)
    torch.cuda.synchronize()
    assert launch.launches["tile_bwd"] == before + 1
    want = tc.tile_composite_bwd_plain(packets, dirs, cot, settings)
    for g, w, name in zip(got, want, GRAD_NAMES):
        assert_close(g, w, BWD_RTOL, BWD_ATOL, err_msg=name)


@pytest.mark.cuda
def test_bwd_kernel_without_dirs_on_card(request):
    """The kernel's launch without d_dirs (training's) gives d_geom and
    d_featsT bit-equal to the launch with it, within the plain version's
    tolerance, and exact zeros on the chunks the forward skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    mc = request.getfixturevalue("multi_chunk")
    dev = torch.device("cuda", 0)
    packets = {k: v.to(dev) for k, v in mc["tpk"].items()}
    dirs = mc["tdirs"].to(dev)
    cot = tuple(torch.from_numpy(c).to(dev) for c in mc["cot"])
    settings = RenderSettings()
    before = launch.launches["tile_bwd"]
    got = tc.tile_composite_bwd(packets, dirs, cot, settings,
                                want_dirs=False)
    full = tc.tile_composite_bwd(packets, dirs, cot, settings)
    torch.cuda.synchronize()
    assert launch.launches["tile_bwd"] == before + 2 and got[2] is None
    assert all(torch.equal(a, b) for a, b in zip(got[:2], full[:2]))
    want = tc.tile_composite_bwd_plain(packets, dirs, cot, settings)
    keep = torch.from_numpy(~mc["skipped"]).to(dev)
    for g, w, name in zip(got[:2], want[:2], GRAD_NAMES):
        assert_close(g[keep], w[keep], BWD_RTOL, BWD_ATOL, err_msg=name)
        assert not bool(g[~keep][..., 128:].any()), name
