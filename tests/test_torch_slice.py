"""The port's tile-binned primary render as a whole vs the JAX package
(CPU): prepare_tiles -> jittered render_prepared -> accumulate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import rng as jrng
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops.binning import (
    BinningConfig as JBinningConfig,
)
from pathtracer_gaussiansplatting_tpu.render import tiled as jtiled
from pathtracer_gaussiansplatting_tpu.render.pathtrace import (
    accumulate as j_accumulate,
)
from pathtracer_gaussiansplatting_tpu_torch.core import rng as trng
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.render import tiled
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import accumulate

from torch_parity import (
    CPU, TORCH_THREADS, assert_close, cameras, np_of, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

RTOL, ATOL = 1e-3, 3e-4   # the reference's kernel-vs-oracle tolerances
BG = (0.1, 0.2, 0.3)
H, W = 48, 64
IMAGE_OUTPUTS = ("color", "feats", "alpha_acc")


@pytest.fixture(scope="module")
def pose():
    # Splat size vs camera distance sets how well q = c - b^2/a is
    # conditioned (c = |M(o - mu)|^2): for sigma ~0.05 at distance 4, c is
    # ~6e3, one float32 ulp in any input moves q by ~1e-4, and a pair whose
    # q sits that close to the sigma_cut or alpha_min step switches a ~1%
    # contribution on or off between any two implementations. Splats of
    # sigma 0.2-0.5 keep c below ~400 and the packages agree to ~1e-5.
    jscene = j_random_cloud(300, seed=13, spread=1.2,
                            scale_range=(-1.8, -0.8))
    jcam, tcam = cameras(width=W, height=H)
    return dict(jscene=jscene, tscene=to_torch_scene(jscene), jcam=jcam,
                tcam=tcam)


def test_slice_matches_reference(pose):
    """Three jittered, accumulated samples of one pose through both
    packages, the reference's Pallas kernel in interpret mode; K=128 with
    tiles overflowing it."""
    jset, tset = JRenderSettings(background=BG), RenderSettings(background=BG)
    jcfg, tcfg = JBinningConfig(max_per_tile=128), BinningConfig(
        max_per_tile=128)
    jpk = jtiled.prepare_tiles(pose["jscene"], pose["jcam"], jset, jcfg)
    tpk = tiled.prepare_tiles(pose["tscene"], pose["tcam"], tset, tcfg)
    for k, v in jpk.items():
        if k.startswith("stat_"):
            assert float(tpk[k]) == float(v), k
    assert float(tpk["stat_tile_dropped"]) > 0

    jkey, tkey = jax.random.PRNGKey(13), trng.prng_key(13)
    j_acc = {o: jnp.zeros((H, W, 14 if o == "feats" else 3))
             for o in IMAGE_OUTPUTS}
    j_acc["alpha_acc"] = jnp.zeros((H, W))
    t_acc = {o: torch.from_numpy(np.zeros(v.shape, np.float32))
             for o, v in j_acc.items()}
    for f in range(3):
        jo = jtiled.render_prepared(
            jpk, pose["jcam"], jset, jcfg, interpret=True,
            jitter=jrng.subpixel_jitter(jkey, H, W, f))
        to = tiled.render_prepared(
            tpk, pose["tcam"], tset, tcfg,
            jitter=trng.subpixel_jitter(tkey, H, W, f, device=CPU))
        for o in IMAGE_OUTPUTS:
            j_acc[o] = j_accumulate(j_acc[o], jo[o], f)
            t_acc[o] = accumulate(t_acc[o], to[o], f)
        hit = np.asarray(jo["alpha_acc"]) > 1e-3
        np.testing.assert_allclose(np_of(to["depth"])[hit],
                                   np.asarray(jo["depth"])[hit],
                                   rtol=RTOL, atol=ATOL)
    for o in IMAGE_OUTPUTS:
        assert t_acc[o].shape == j_acc[o].shape
        assert_close(t_acc[o], j_acc[o], RTOL, ATOL, err_msg=o)
    assert float(t_acc["alpha_acc"].max()) > 0.5


def test_render_tiled_matches_reference(pose):
    """The chunked per-tile oracle render_tiled in both packages."""
    jcfg, tcfg = JBinningConfig(max_per_tile=96), BinningConfig(
        max_per_tile=96)
    want = jtiled.render_tiled(pose["jscene"], pose["jcam"],
                               JRenderSettings(background=BG), jcfg)
    got = tiled.render_tiled(pose["tscene"], pose["tcam"],
                             RenderSettings(background=BG), tcfg, chunk=5)
    for o in ("color", "feats", "alpha_acc"):
        assert_close(got[o], want[o], RTOL, ATOL, err_msg=o)


def test_fused_path_matches_oracle_path(pose):
    """render_tiled_fused (packets + the fused compositor) vs render_tiled
    (per-tile oracle), as the reference holds its kernel path to its
    oracle path."""
    settings, cfg = RenderSettings(background=BG), BinningConfig(
        max_per_tile=128)
    fused = tiled.render_tiled_fused(pose["tscene"], pose["tcam"], settings,
                                     cfg)
    oracle = tiled.render_tiled(pose["tscene"], pose["tcam"], settings, cfg)
    for o in ("color", "alpha_acc"):
        assert_close(fused[o], oracle[o], RTOL, ATOL, err_msg=o)


def test_tile_major_outputs_untile_to_images(pose):
    settings, cfg = RenderSettings(background=BG), BinningConfig(
        max_per_tile=64)
    packets = tiled.prepare_tiles(pose["tscene"], pose["tcam"], settings, cfg)
    jit = trng.subpixel_jitter(trng.prng_key(3), H, W, 2, device=CPU)
    imgs = tiled.render_prepared(packets, pose["tcam"], settings, cfg,
                                 jitter=jit)
    tiles = tiled.render_prepared(
        packets, pose["tcam"], settings, cfg, jitter=jit,
        outputs=("tile_feats", "tile_alpha", "tile_depth", "tile_dirs"))
    assert set(imgs) == set(tiled.ALL_OUTPUTS)
    assert tiles["tile_dirs"].shape == (12, 256, 3)
    untile = lambda x: tiled.untile_image(x, pose["tcam"], cfg)  # noqa: E731
    assert torch.equal(untile(tiles["tile_feats"]), imgs["feats"])
    assert torch.equal(untile(tiles["tile_alpha"][..., None])[..., 0],
                       imgs["alpha_acc"])
    assert torch.equal(untile(tiles["tile_depth"][..., None])[..., 0],
                       imgs["depth"])
    bg = torch.tensor(BG)
    assert torch.allclose(imgs["color"], imgs["feats"][..., :3]
                          + (1 - imgs["alpha_acc"][..., None]) * bg)
