"""PyTorch port vs the JAX package: EWA projection, tile binning and the
per-tile packet gather (CPU)."""
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
from pathtracer_gaussiansplatting_tpu.ops import binning as jb
from pathtracer_gaussiansplatting_tpu.render import tiled as jtiled
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc
from pathtracer_gaussiansplatting_tpu_torch.ops import binning as tb
from pathtracer_gaussiansplatting_tpu_torch.render import tiled

from torch_parity import (
    TORCH_THREADS, assert_close, cameras, np_of, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

# (scene spread, camera eye, config): a cloud whose dense tiles overflow K,
# and a tight cluster close to the camera that also hits the per-Gaussian
# tile cap.
CASES = {
    "overflow": (1.2, (-2.5, -1.0), (0.0, 0.5, 4.0),
                 dict(max_per_tile=128)),
    "cap": (0.05, (1.0, 1.5), (0.0, 0.0, 1.0),
            dict(max_per_tile=32, max_tiles_per_gaussian=4)),
}


def _setup(case):
    spread, scale_range, eye, cfg_kw = CASES[case]
    jscene = j_random_cloud(300, seed=11, spread=spread,
                            scale_range=scale_range)
    jcam, tcam = cameras(eye=eye)
    return (jscene, to_torch_scene(jscene), jcam, tcam,
            jb.BinningConfig(**cfg_kw), tb.BinningConfig(**cfg_kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_project_gaussians_matches(case):
    jscene, tscene, jcam, tcam, jcfg, tcfg = _setup(case)
    want = jb.project_gaussians(jscene, jcam, jcfg)
    got = tb.project_gaussians(tscene, tcam, tcfg)
    for k in ("xy", "depth", "rx", "ry", "radius"):
        assert_close(got[k], want[k], 1e-5, 1e-5, err_msg=k)
    assert np.array_equal(np_of(got["valid"]), np.asarray(want["valid"]))
    assert tb.num_tiles(tcam, tcfg) == jb.num_tiles(jcam, jcfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_gaussians_matches(case):
    jscene, tscene, jcam, tcam, jcfg, tcfg = _setup(case)
    tx, ty = jb.num_tiles(jcam, jcfg)
    j_idx, j_mask, j_count, j_stats = jb.bin_gaussians(
        jb.project_gaussians(jscene, jcam, jcfg), tx, ty, jcfg)
    t_idx, t_mask, t_count, t_stats = tb.bin_gaussians(
        tb.project_gaussians(tscene, tcam, tcfg), tx, ty, tcfg)
    for k in ("cap_dropped_tiles", "cap_truncated", "tile_overflow",
              "tile_dropped"):
        assert float(t_stats[k]) == float(j_stats[k]), k
    assert float(t_stats["tile_dropped"]) > 0
    if case == "cap":
        assert float(t_stats["cap_dropped_tiles"]) > 0
    assert np.array_equal(np_of(t_count), np.asarray(j_count))
    assert np.array_equal(np_of(t_mask), np.asarray(j_mask))
    j_idx, j_mask = np.asarray(j_idx), np.asarray(j_mask)
    t_idx, t_mask = np_of(t_idx), np_of(t_mask)
    run_le_k = np.asarray(j_count) < jcfg.max_per_tile
    assert run_le_k.any()
    # Ties in the packed key may sort differently (the reference's sort is
    # not stable): compare each tile's set, where its whole run fits in K.
    for t in np.nonzero(run_le_k)[0]:
        assert set(t_idx[t][t_mask[t]]) == set(j_idx[t][j_mask[t]]), t


def test_build_tile_packets_matches():
    jscene, tscene, jcam, tcam, jcfg, _ = _setup("overflow")
    tx, ty = jb.num_tiles(jcam, jcfg)
    idx, mask, _, _ = jb.bin_gaussians(
        jb.project_gaussians(jscene, jcam, jcfg), tx, ty, jcfg)
    settings = JRenderSettings()
    origin = jcam.c2w[:3, 3]
    j_feats = jtiled._packet_features(jscene, origin, settings)
    t_feats = tiled._packet_features(tscene, tcam.c2w[:3, 3],
                                     RenderSettings())
    assert_close(t_feats, j_feats, 0, 1e-6)
    want = jtc.build_tile_packets(jscene, j_feats, origin, idx, mask)
    got = tc.build_tile_packets(tscene, t_feats, tcam.c2w[:3, 3],
                                torch.from_numpy(np.array(idx)),
                                torch.from_numpy(np.array(mask)))
    assert got["geom"].shape == want["geom"].shape
    # geom rows are sums of products of inverse variances (up to ~1e4):
    # hold them to float32 resolution of each row's scale.
    geom_w, geom_g = np.asarray(want["geom"]), np_of(got["geom"])
    scale = np.abs(geom_w).max(axis=(0, 2), keepdims=True) + 1e-30
    np.testing.assert_allclose(geom_g / scale, geom_w / scale, rtol=0,
                               atol=2e-6)
    assert_close(got["featsT"], want["featsT"], 0, 1e-6)
    assert np.array_equal(np_of(got["count"]), np.asarray(want["count"]))


def test_alpha_min_mismatch_raises():
    _, tscene, _, tcam, _, _ = _setup("overflow")
    with pytest.raises(ValueError, match="alpha_min"):
        tiled.prepare_tiles(tscene, tcam, RenderSettings(alpha_min=0.01),
                            tb.BinningConfig())
