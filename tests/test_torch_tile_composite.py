"""The port's fused tile composite vs the JAX package (CPU), the
exactness of the kernels' dead-warp skip (CPU), and the CUDA kernel vs its
plain version (on a CUDA card only)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given
from hypothesis import settings as hyp_settings
from hypothesis import strategies as st

from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.kernels import tile_composite as jtc
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops import gaussians as jgauss
from pathtracer_gaussiansplatting_tpu.render import tiled as jtiled
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as tgauss
from pathtracer_gaussiansplatting_tpu_torch.render import tiled

from utils import random_scene
from torch_parity import (
    TORCH_THREADS, assert_close, np_of, pose_packets, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)


@pytest.mark.parametrize("k", [64, 128])
def test_plain_matches_xla(k, monkeypatch):
    """tile_composite_plain vs the reference's own oracle semantics, in
    chunks of 5 tiles."""
    monkeypatch.setattr(tc, "PLAIN_CHUNK_ELEMS", 5 * 256 * k)
    packets, dirs, tpk, tdirs = pose_packets(250, 1.2, k)
    want = jtc._tile_composite_xla(packets, dirs, JRenderSettings())
    got = tc.tile_composite_plain(tpk, tdirs, RenderSettings())
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 2e-4, 2e-5, err_msg=name)


def test_plain_matches_pallas_interpret():
    """tile_composite_plain vs the Pallas kernel in interpret mode at K=256:
    two 128-slot chunks, with the second skipped on saturated tiles."""
    packets, dirs, tpk, tdirs = pose_packets(
        600, 1.0, 256, eye=(0.0, 0.0, 1.5), scale_range=(-2.0, -1.0))
    settings = JRenderSettings()
    count = np.asarray(packets["count"])
    # The kernel's skip must really happen: tiles past 128 slots whose
    # transmittance after the first chunk is at or below the threshold.
    first = dict(packets, geom=packets["geom"][..., :128],
                 featsT=packets["featsT"][..., :128])
    trans1 = 1.0 - np.asarray(jtc._tile_composite_xla(first, dirs,
                                                      settings)[1])
    skipped = (count > 128) & (trans1.max(-1) <= settings.transmittance_min)
    assert skipped.any() and (~skipped & (count > 128)).any()
    want = jtc.tile_composite(packets, dirs, settings, interpret=True)
    got = tc.tile_composite_plain(tpk, tdirs, RenderSettings())
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 1e-3, 3e-4, err_msg=name)


@pytest.mark.parametrize("tile_size", [8, 12, 24, 32, 48])
def test_plain_matches_pallas_tile_sizes(tile_size):
    """tile_composite_plain vs the Pallas kernel in interpret mode at tile
    sizes other than 16: P = 64, 144 (not a multiple of 32), 576 and 1024
    (the card's cluster kernels above 256) and 2304 pixels a tile (its
    group-loop kernels above 2048)."""
    packets, dirs, tpk, tdirs = pose_packets(600, 1.0, 128,
                                             tile_size=tile_size)
    assert tdirs.shape[1] == tile_size * tile_size
    settings = JRenderSettings()
    want = jtc.tile_composite(packets, dirs, settings, interpret=True)
    got = tc.tile_composite_plain(tpk, tdirs, RenderSettings())
    assert float(np_of(got[1]).max()) > 0.5
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 1e-3, 3e-4, err_msg=name)


# The per-tile oracle forms q = c - b^2/a from M = diag(1/s) R^T, the packet
# path from Q = M^T M; with the camera far from small splats c reaches ~2e3,
# and the cancellation costs each form ~3e-4 in q (against a float64
# evaluation) whatever the framework. Oracle comparisons are therefore held
# to the kernel tolerance, rtol 1e-3 / atol 3e-4.
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 3e-4


def test_reference_oracle_matches():
    """The per-tile oracle tile_composite_reference in both packages."""
    rng = np.random.default_rng(5)
    scene = j_random_cloud(40, seed=5, spread=1.0)
    origin = np.array([0.0, 0.0, 4.0], np.float32)
    d = rng.normal(size=(3, 32, 3))
    d[..., 2] = -np.abs(d[..., 2]) - 1.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    feats = rng.uniform(size=(40, 14)).astype(np.float32)
    idx = np.stack([rng.permutation(40) for _ in range(3)])
    mask = rng.uniform(size=(3, 40)) > 0.2
    m = jgauss.canonical_transforms(scene.log_scales, scene.quats)
    settings = JRenderSettings()
    want = [jtiled.tile_composite_reference(
        jnp.asarray(origin), jnp.asarray(d[i]), scene.means[idx[i]],
        m[idx[i]], scene.opacities[idx[i]], jnp.asarray(feats)[idx[i]],
        jnp.asarray(mask[i]), settings) for i in range(3)]
    ts = to_torch_scene(scene)
    tm = tgauss.canonical_transforms(ts.log_scales, ts.quats)
    ti = torch.from_numpy(idx).long()
    got = tiled.tile_composite_reference(
        torch.from_numpy(origin), torch.from_numpy(d), ts.means[ti], tm[ti],
        ts.opacities[ti], torch.from_numpy(feats)[ti],
        torch.from_numpy(mask), RenderSettings())
    for j, name in enumerate(("out", "alpha_acc", "depth")):
        assert_close(got[j], np.stack([np.asarray(w[j]) for w in want]),
                     ORACLE_RTOL, ORACLE_ATOL, err_msg=name)


def test_plain_matches_oracle(rng):
    """The port's plain composite vs its per-tile oracle, on the inputs of
    the reference's own check of its kernel math (TestKernelMath in
    tests/test_pallas_kernels.py)."""
    scene = to_torch_scene(random_scene(32, rng, spread=1.0))
    origin = torch.tensor([0.0, 0.0, 4.0])
    d = rng.normal(size=(64, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs = torch.from_numpy(d.astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(32, 5)).astype(np.float32))
    mask = torch.ones(32, dtype=torch.bool)
    m = tgauss.canonical_transforms(scene.log_scales, scene.quats)
    ref_out, ref_acc, ref_depth = tiled.tile_composite_reference(
        origin, dirs, scene.means, m, scene.opacities, feats, mask,
        RenderSettings())
    packets = tc.build_tile_packets(scene, feats, origin,
                                    torch.arange(32, dtype=torch.int32)[None],
                                    mask[None])
    out, acc, depth = tc.tile_composite_plain(packets, dirs[None],
                                              RenderSettings())
    assert_close(out[0], ref_out, ORACLE_RTOL, ORACLE_ATOL)
    assert_close(acc[0], ref_acc, ORACLE_RTOL, ORACLE_ATOL)
    hit = np_of(ref_acc) > 1e-3
    np.testing.assert_allclose(np_of(depth[0])[hit], np_of(ref_depth)[hit],
                               rtol=1e-3)


def test_dispatch_cpu_and_no_fallback():
    """CPU tensors take the plain version; any other device must launch the
    kernel or raise, never fall back."""
    _, _, tpk, tdirs = pose_packets(120, 1.0, 64)
    settings = RenderSettings()
    before = launch.launches["tile_fwd"]
    got = tc.tile_composite(tpk, tdirs, settings)
    want = tc.tile_composite_plain(tpk, tdirs, settings)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch.launches["tile_fwd"] == before
    meta = {k: v.to("meta") for k, v in tpk.items()}
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tc.tile_composite(meta, tdirs.to("meta"), settings)
    with pytest.raises(ValueError):
        tc.tile_composite(meta, tdirs, settings)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    _, _, tpk, tdirs = pose_packets(2000, 0.8, 256)
    dev = torch.device("cuda", 0)
    packets = {k: v.to(dev) for k, v in tpk.items()}
    settings = RenderSettings()
    before = launch.launches["tile_fwd"]
    got = tc.tile_composite(packets, tdirs.to(dev), settings)
    torch.cuda.synchronize()
    assert launch.launches["tile_fwd"] == before + 1
    want = tc.tile_composite_plain(packets, tdirs.to(dev), settings)
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 1e-3, 3e-4, err_msg=name)


def _cutoff_tile(seed: int, ulps: int, p: int = 64, k: int = 48):
    """One tile's packets (geom (1, 16, K), featsT (1, 14, K)) and dirs
    (1, P, 3) whose slots each put one pixel within ``ulps`` float32 ulps
    of a cutoff: the alpha_min step (through the opacity) for even slots,
    the sigma_cut step (through c) for odd ones."""
    rng = np.random.default_rng(seed)
    s = RenderSettings()
    d = rng.normal(size=(1, p, 3)) * [0.3, 0.3, 1.0] + [0.0, 0.0, -1.0]
    dirs = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True))
                            .astype(np.float32))
    inv_s2 = rng.uniform(1.0, 400.0, (k, 3))
    og = rng.normal(size=(k, 3)) * [0.3, 0.3, 1.0] + [0.0, 0.0, 4.0]
    geom = np.zeros((1, 16, k), np.float32)
    geom[0, :3] = inv_s2.T
    geom[0, 6:9] = (inv_s2 * og).T
    geom[0, 9] = (inv_s2 * og * og).sum(-1)
    geom[0, 10] = 1.0
    geom = torch.from_numpy(geom)
    t, _ = tc._t_alpha(*tc._quadratic_ab(dirs, geom), geom,
                       RenderSettings(alpha_min=0.0, sigma_cut=1e3))
    a, b = tc._quadratic_ab(dirs, geom)
    a = torch.clamp_min(a, 1e-12)
    q = (a * t + 2.0 * b) * t + geom[:, 9:10]          # (1, P, K)
    pick = torch.from_numpy(rng.integers(0, p, k))
    q_p = q[0, pick, torch.arange(k)]
    step = 2.0 ** -23 * ulps
    cut2 = s.sigma_cut ** 2
    # Odd slots: q at the picked pixel onto sigma_cut^2; even slots: that
    # pixel's response onto alpha_min through the opacity.
    geom[0, 9, 1::2] += (cut2 - q_p[1::2]) * (1.0 + step)
    gval = torch.exp(-0.5 * torch.clamp_min(q_p[0::2], 0.0))
    geom[0, 10, 0::2] = s.alpha_min / gval * (1.0 + step)
    geom[0, 10, 1::2] = torch.from_numpy(rng.uniform(0.2, 0.99, k // 2)
                                         .astype(np.float32))
    featsT = torch.from_numpy(rng.normal(size=(1, tc.FEATURE_DIM, k))
                              .astype(np.float32))
    return geom, featsT, dirs


def _sequential_composite(alpha, t, featsT, skip=None):
    """The kernels' per-slot step in torch, slot by slot (w = T alpha,
    T *= 1 - alpha, sums += w x); with ``skip`` (P, K) bool, a pixel leaves
    out the slots where it is set."""
    p, k = alpha.shape
    trans = torch.ones(p)
    depth = torch.zeros(p)
    acc = torch.zeros(p, featsT.shape[0])
    for j in range(k):
        run = torch.ones(p, dtype=torch.bool) if skip is None else ~skip[:, j]
        a = alpha[:, j]
        w = trans * a
        trans = torch.where(run, trans * (1.0 - a), trans)
        depth = torch.where(run, depth + w * t[:, j], depth)
        acc = torch.where(run[:, None], acc + w[:, None] * featsT[None, :, j],
                          acc)
    return acc, trans, depth


@hyp_settings(max_examples=25, deadline=None, derandomize=True,
              database=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 32 - 1), ulps=st.integers(-3, 3))
def test_dead_warp_skip_is_exact(seed, ulps):
    """The kernels skip a (warp, slot) where none of the warp's 32 pixels
    has alpha > 0: the forward's composite step, the backward's VJP and
    reduction. With one pixel a slot within a few ulps of the alpha_min or
    sigma_cut step, the composite that leaves those slots out equals the
    one that runs them, bit for bit: alpha = 0 gives w = 0, T (1 - 0) = T
    and s + 0 x = s."""
    geom, featsT, dirs = _cutoff_tile(seed, ulps)
    t, alpha = tc._t_alpha(*tc._quadratic_ab(dirs, geom), geom,
                           RenderSettings())
    t, alpha = t[0], alpha[0]                            # (P, K)
    p, k = alpha.shape
    warp_dead = ~(alpha > 0).reshape(p // 32, 32, k).any(1)   # (W, K)
    skip = warp_dead.repeat_interleave(32, dim=0)             # (P, K)
    assert bool(skip.any()) and bool((~skip).any())
    full = _sequential_composite(alpha, t, featsT[0])
    skipped = _sequential_composite(alpha, t, featsT[0], skip)
    for a, b in zip(full, skipped):
        assert torch.equal(a, b)
    # At these cutoffs the alpha_min / sigma_cut steps decide liveness: the
    # plain version's output is the full composite's.
    out, alpha_acc, _ = tc.tile_composite_plain(
        dict(geom=geom, featsT=featsT), dirs, RenderSettings())
    assert_close(out[0], full[0], 1e-5, 1e-6)
    assert_close(alpha_acc[0], 1.0 - full[1], 1e-6, 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(80, 256), (512, 256), (256, 64),
                                 (256, 32)])
def test_kernel_chunk_shapes_on_card(k, p):
    """The kernels' stages of 32 slots on other shapes: a single chunk of
    K = 80 (a partial last stage), four 128-slot chunks of K = 512, and
    tiles of 64 and 32 pixels (2 and 1 warps: the backward's shared-memory
    layout for fewer warps); the forward's outputs within the plain
    version's tolerance, and the backward's too (without the transmittance
    cutoff)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    _, _, tpk, tdirs = pose_packets(1500, 0.8, k)
    dev = torch.device("cuda", 0)
    packets = {key: v.to(dev) for key, v in tpk.items()}
    dirs = tdirs[:, :p].contiguous().to(dev)
    settings = RenderSettings()
    got = tc.tile_composite(packets, dirs, settings)
    want = tc.tile_composite_plain(packets, dirs, settings)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 1e-3, 3e-4, err_msg=name)
    rng = np.random.default_rng(k)
    cot = tuple(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)
                                 ).to(dev) * (want[1] > 1e-3 if i == 2 else 1)
                for i, x in enumerate(want))
    full = RenderSettings(transmittance_min=0.0)
    got = tc.tile_composite_bwd(packets, dirs, cot, full, want_dirs=False)
    want = tc.tile_composite_bwd_plain(packets, dirs, cot, full)
    torch.cuda.synchronize()
    for g, w, name in zip(got[:2], want[:2], ("d_geom", "d_featsT")):
        assert_close(g, w, 2e-3, 2e-4, err_msg=name)


def _launches(bwd: bool) -> dict:
    """The tile kernels' launch counts by path (any_p_plan's names)."""
    d = "bwd" if bwd else "fwd"
    return {path: launch.launches[f"tile_{d}" if path == "one_block"
                                  else f"tile_{d}_{path}"]
            for path in ("one_block", "cluster", "group_loop")}


@pytest.mark.parametrize("p, plan", [
    (64, ("one_block", 1, 64)), (144, ("cluster", 1, 160)),
    (256, ("one_block", 1, 256)), (576, ("cluster", 3, 256)),
    (1024, ("cluster", 4, 256)), (2048, ("cluster", 8, 256)),
    (2304, ("group_loop", 1, 256))])
def test_any_p_plan(p, plan):
    """The kernel each tile size takes: tiles 8 and 16 the one-block
    kernels; tile 12 a cluster of one CTA of 160 threads; tiles 24, 32 and
    45 (P up to 2048) clusters of ceil(P / 256) CTAs; tile 48 the
    group-loop kernels. one_block agrees."""
    assert tc.any_p_plan(p) == plan
    assert tc.one_block(p) == (plan[0] == "one_block")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [8, 12, 24, 32, 48])
def test_kernel_tile_sizes_on_card(tile_size):
    """Tile sizes other than 16 on the card: P = 64 on the one-block
    kernels, 144, 576 and 1024 on the cluster kernels, 2304 on the
    group-loop kernels, each launch counted under its path. The forward
    within the plain version's tolerance at the default cutoff; without it
    (so that no chunk skip depends on how the pixels are grouped) bit-equal
    to the one-block kernel on the same pixels cut into 16x16-sized tiles;
    the backward within its tolerance, with and without d_dirs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    _, _, tpk, tdirs = pose_packets(1500, 0.8, 256, tile_size=tile_size)
    dev = torch.device("cuda", 0)
    packets = {key: v.to(dev) for key, v in tpk.items()}
    dirs = tdirs.to(dev)
    p = tile_size * tile_size
    path = tc.any_p_plan(p)[0]
    settings = RenderSettings()
    before = _launches(bwd=False)
    got = tc.tile_composite(packets, dirs, settings)
    torch.cuda.synchronize()
    assert _launches(bwd=False) == dict(before, **{path: before[path] + 1})
    want = tc.tile_composite_plain(packets, dirs, settings)
    for g, w, name in zip(got, want, ("out", "alpha_acc", "depth")):
        assert_close(g, w, 1e-3, 3e-4, err_msg=name)
    full = RenderSettings(transmittance_min=0.0)
    got = tc.tile_composite(packets, dirs, full)
    bpk, bdirs, _ = tc.as_block_tiles(packets, dirs)
    ref = tc.tile_composite(bpk, bdirs, full)
    for g, r in zip(got, ref):
        r = r.reshape(g.shape[0], -1, *r.shape[2:])[:, :p]
        assert torch.equal(g, r)
    rng = np.random.default_rng(tile_size)
    cot = tuple(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)
                                 ).to(dev) * (want[1] > 1e-3 if i == 2 else 1)
                for i, x in enumerate(want))
    want = tc.tile_composite_bwd_plain(packets, dirs, cot, full)
    for want_dirs in (False, True):
        before = _launches(bwd=True)
        got = tc.tile_composite_bwd(packets, dirs, cot, full, want_dirs)
        torch.cuda.synchronize()
        assert _launches(bwd=True) == dict(before,
                                           **{path: before[path] + 1})
        for g, w, name in zip(got[:2], want[:2], ("d_geom", "d_featsT")):
            assert_close(g, w, 2e-3, 2e-4, err_msg=name)
    assert torch.isfinite(got[2]).all()
