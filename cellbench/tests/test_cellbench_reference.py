"""The plain reference against the port's CPU path on tiny scenes."""
import numpy as np
import pytest
import torch

from cellbench import scenes
from cellbench.reference import capture as ref_capture
from cellbench.reference import grid as ref_grid
from cellbench.reference import rng as ref_rng
from cellbench.reference import tiles as ref_tiles
from cellbench.reference import train as ref_train
from cellbench.reference import types as ref_types

AMBIENT = (0.05, 0.05, 0.06, 1.0)


def test_rng_matches_port():
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    key = rng.frame_key(rng.prng_key(13), 5)
    want = rng.ray_uniform(rng.fold_in(key, 2), 1000, 14, 2, device="cpu")
    k = ref_rng.dim_key(ref_rng.fold_in(ref_rng.frame_key(
        ref_rng.prng_key(13), 5), 2), 14)
    idx = torch.arange(1000)[:, None] * 2 + torch.arange(2)[None]
    assert torch.equal(ref_rng.uniform_at(k[0], k[1], idx), want)
    jit = rng.subpixel_jitter(rng.prng_key(13), 8, 8, 3, device="cpu")
    jk = ref_rng.dim_key(ref_rng.frame_key(ref_rng.prng_key(13), 3), 0)
    r2 = ref_rng.r2_host(3)
    u = ref_rng.uniform_at(jk[0], jk[1], torch.arange(128)).reshape(8, 8, 2)
    assert torch.equal(torch.fmod(u + torch.tensor(r2), 1.0), jit)


@pytest.mark.parametrize("kc", [16, 32])
def test_grid_build_matches_port(kc):
    """The grid, its block table and its tables bit for bit, the
    eviction rule of the host binning included (cells overflow at Kc)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.grid_trace import (
        build_grid_accel,
    )
    raw = scenes.surface_room(6000, 2 ** 31 + 17, "cpu")
    want = build_grid_accel(GaussianScene(**raw), max_per_cell=kc)
    got = ref_grid.build_grid_accel(ref_types.GaussianScene(**raw),
                                    max_per_cell=kc)
    assert want.stats_dict["overflow_cell_frac"] > 0
    assert got.dims == want.dims
    for k in ("btab", "geom", "packet", "fill", "lo", "hi"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_capture_pixels_match_port():
    """Sampled pixels of a grid-backend capture pose (2 spp, depth 4)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        toroidal_c2w,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
        make_tiled_pose_renderer,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.grid_trace import (
        build_grid_accel,
    )
    raw = scenes.surface_room(4000, 2 ** 31 + 19, "cpu")
    scene = GaussianScene(**raw)
    render = make_tiled_pose_renderer(
        scene, RenderSettings(max_depth=4, ambient=AMBIENT), None, spp=2,
        bounce_backend="grid", accel=build_grid_accel(scene))
    img = render(toroidal_c2w(200.0, -20.0, 1.2, 0.2, device="cpu"), 48, 32,
                 45.0).reshape(-1, 3)
    flat = np.random.default_rng(5).choice(48 * 32, 300, replace=False)
    rscene = ref_types.GaussianScene(**raw)
    cam = ref_tiles.Camera(ref_tiles.toroidal_c2w(200.0, -20.0, 1.2, 0.2,
                                                  "cpu"), 45.0, 48, 32)
    ref = ref_capture.render_pixels(
        rscene, ref_grid.build_grid_accel(rscene), [cam],
        [(torch.as_tensor(flat // 48), torch.as_tensor(flat % 48))],
        ref_types.RenderSettings(max_depth=4, ambient=AMBIENT),
        ref_tiles.BinningConfig(), [2], ref_capture.capture_keys(2))[0]
    prog = img[torch.as_tensor(flat)]
    assert float(ref.mean()) > 0.05
    rel = float((prog - ref).abs().sum() / ref.abs().sum())
    assert rel < 1e-3


def test_train_steps_match_port():
    """Three tiled train steps: losses, first gradients and the leaves'
    change."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (
        make_optimizer, make_tiled_train_step,
    )
    raw = scenes.random_cloud(3000, 2 ** 31 + 23, "cpu", spread=1.5)
    eyes = [(0.0, 0.5, 4.0), (3.0, 1.0, 2.0), (-2.0, -1.0, 3.0)]
    bg = (0.1, 0.2, 0.3)
    rcams = [ref_tiles.Camera(ref_tiles.look_at(e, (0, 0, 0), "cpu"), 50.0,
                              32, 32) for e in eyes]
    shown = dict(raw, sh_coeffs=raw["sh_coeffs"] * 0.5)
    rset = ref_types.RenderSettings(background=bg)
    rcfg = ref_tiles.BinningConfig(max_per_tile=128)
    targets = ref_train.render_targets(shown, rcams, rset, rcfg)
    ref = ref_train.fit_steps(raw, rcams, targets, rset, rcfg, 5e-3, 3)

    params = SceneParams.from_scene(GaussianScene(**raw))
    opt = make_optimizer(5e-3)(params.parameters())
    step = make_tiled_train_step(RenderSettings(background=bg),
                                 make_optimizer(5e-3),
                                 BinningConfig(max_per_tile=128))
    losses = []
    for i, e in enumerate(eyes):
        cam = Camera(c2w=look_at(e, (0, 0, 0), device="cpu"),
                     fov_y_deg=50.0, width=32, height=32)
        params, opt, loss = step(params, opt, cam, targets[i])
        losses.append(float(loss))
        if i == 0:
            grad1 = {f: opt.state[p]["exp_avg"] / 0.1
                     for f, p in params.named_parameters() if p in opt.state}
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for f, g in grad1.items():
        np.testing.assert_allclose(float(g.norm()),
                                   float(ref["grad1"][f].norm()),
                                   rtol=1e-4, atol=1e-12)
    for f, p in params.named_parameters():
        np.testing.assert_allclose(
            float((p.detach() - raw[f]).norm()),
            float((ref["params"][f] - raw[f]).norm()), rtol=1e-4, atol=1e-9)
