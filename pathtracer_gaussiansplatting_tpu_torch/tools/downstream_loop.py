"""The downstream loop: capture a dataset, fit a fresh scene to it from its
point cloud, and score the fit on the held-out poses.

Counterpart of ``benchmarks/downstream_loop.py``, the reference's only
published success metric (3DGS reconstruction quality on its captured
datasets):

  1. ``capture_scene_data`` on the Cornell-style ``surface_scene`` (tiled
     primary hit, grid bounces) writes ``train/*.jpg``,
     ``transforms_{train,test}.json`` and ``points3d.ply``;
  2. a fresh scene is built from the captured point cloud, with no SfM
     step (:func:`init_from_point_cloud`);
  3. ``fit_scene_tiled`` fits it to the train images;
  4. PSNR and SSIM are measured on the test poses (every 4th pose).

The sizes are the reference's ``GSPT_DS_*`` variables with its defaults
(``N`` 50000 Gaussians, ``POSES`` 8, ``SPP`` 32, ``RES`` 200,
``PC_RAYS`` 40000, ``STEPS`` 600; ``DIR`` the dataset directory). The
result goes to ``downstream.json`` in that directory, which defaults to
``chiprun_out/downstream/`` in the repository. Run on the CUDA card:

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.downstream_loop

or on the CPU at a small size (``--device cpu``; each kernel's plain
version), for example ``GSPT_DS_N=2000 GSPT_DS_POSES=4 GSPT_DS_SPP=2
GSPT_DS_RES=48 GSPT_DS_PC_RAYS=2000 GSPT_DS_STEPS=6``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera
from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
    capture_scene_data,
)
from pathtracer_gaussiansplatting_tpu_torch.data.images import srgb_to_linear
from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
    load_point_cloud_ply,
)
from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
    load_transforms_json,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import surface_scene
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (
    fit_scene_tiled,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
    render_tiled_fused,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(ROOT, "chiprun_out", "downstream")
# The capture's render settings and torus (benchmarks/downstream_loop.py:
# 68-71): the torus lies inside the room (half extents 2, 1.5, 2).
CAPTURE_SETTINGS = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
TORUS = dict(major_radius=1.2, minor_radius=0.4, height=0.2)
# The fit (:125-133).
FIT_SETTINGS = RenderSettings(background=(0.1, 0.1, 0.12), sh_degree=1)
FIT_LR = 5e-3


def load_split(out_dir: str, name: str, device=None):
    """The ``name`` split of a captured dataset: (cameras, images), each
    camera on ``device`` (None: the CUDA card), each image the JPG decoded
    to linear radiance, an (H, W, 3) float32 tensor there."""
    from PIL import Image

    device = resolve_device(device)
    meta = load_transforms_json(os.path.join(out_dir,
                                             f"transforms_{name}.json"))
    fov_x = meta["camera_angle_x"]
    cams, imgs = [], []
    for fr in meta["frames"]:
        path = os.path.join(out_dir, fr["file_path"].lstrip("./") + ".jpg")
        img = srgb_to_linear(np.asarray(Image.open(path), np.float32)
                             / 255.0).astype(np.float32)
        h, w = img.shape[:2]
        fov_y = 2.0 * np.arctan(np.tan(fov_x / 2.0) * h / w)
        cams.append(Camera(c2w=torch.as_tensor(fr["transform_matrix"],
                                               device=device),
                           fov_y_deg=float(np.degrees(fov_y)), width=w,
                           height=h))
        imgs.append(torch.from_numpy(img).to(device))
    return cams, imgs


def init_from_point_cloud(pc: dict, device=None) -> GaussianScene:
    """A fresh scene from a point cloud (``load_point_cloud_ply``'s dict):
    an isotropic splat on each point, its size the spacing of the points
    spread over their bounding box's surface, opacity logit -1, the
    point's color as the DC band of degree-1 SH."""
    pos = np.asarray(pc["positions"], np.float32)
    col = np.asarray(pc["colors"], np.float32)
    m = pos.shape[0]
    bbox = pos.max(0) - pos.min(0)
    area = 2.0 * (bbox[0] * bbox[1] + bbox[1] * bbox[2] + bbox[0] * bbox[2])
    spacing = float(np.sqrt(area / max(m, 1)))
    return make_scene(
        means=pos,
        log_scales=np.full((m, 3), np.log(spacing), np.float32),
        quats=np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (m, 1)),
        opacity_logits=np.full((m,), -1.0, np.float32),
        colors=np.clip(col, 0.0, 1.0), sh_degree=1, device=device)


@torch.no_grad()
def held_out_metrics(fitted: GaussianScene, cams, imgs,
                     settings: RenderSettings = FIT_SETTINGS,
                     config: Optional[BinningConfig] = None):
    """(psnrs, ssims): each test pose rendered through the fused tile
    pipeline against its image."""
    config = config or BinningConfig()
    psnrs, ssims = [], []
    for cam, img in zip(cams, imgs):
        color = render_tiled_fused(fitted, cam, settings, config)["color"]
        psnrs.append(float(metrics.psnr(color, img)))
        ssims.append(float(metrics.ssim(color, img)))
    return psnrs, ssims


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type."""
    if device.type != "cuda":
        return device.type
    from pathtracer_gaussiansplatting_tpu_torch.bench import card_line

    return card_line(device.index or 0)


def run_downstream(out_dir: str = DEFAULT_DIR, n_gt: int = 50_000,
                   poses: int = 8, spp: int = 32, res: int = 200,
                   n_pc_rays: int = 40_000, fit_steps: int = 600,
                   device=None,
                   progress: Optional[Callable[[str], None]] = print) -> dict:
    """The loop end to end on ``device`` (None: the CUDA card). Returns the
    reference's result dict (:144-157; times unrounded), with the median
    fit step's wall ms over steps 2 on (``fit_step_ms``; each step ends on
    its loss's read) and the fitted scene (``fitted``, not written)."""
    device = resolve_device(device)
    say = progress or (lambda msg: None)
    scene_gt = surface_scene(n_gt, seed=13, device=device)
    torus = TorusConfig(num_rays=n_pc_rays, **TORUS)
    _sync(device)
    t0 = time.perf_counter()
    capture_scene_data(
        scene_gt, out_dir, CAPTURE_SETTINGS, torus=torus,
        accumulation_steps=spp, total_positions=poses, image_divisor=1,
        width=res, height=res, fov_y_deg=50.0, backend="tiled+grid",
        num_rays=n_pc_rays, progress=lambda m: say(f"[capture] {m}"))
    _sync(device)
    t_capture = time.perf_counter() - t0
    del scene_gt
    say(f"capture done in {t_capture:.1f} s")

    train_cams, train_imgs = load_split(out_dir, "train", device)
    test_cams, test_imgs = load_split(out_dir, "test", device)
    say(f"loaded {len(train_cams)} train / {len(test_cams)} test poses")
    pc = load_point_cloud_ply(os.path.join(out_dir, "points3d.ply"))
    init = init_from_point_cloud(pc, device)
    m = init.num_gaussians
    say(f"point cloud: {m} points")

    cfg = BinningConfig()
    stamps = []

    def fit_progress(i: int, loss: float) -> None:
        stamps.append(time.perf_counter())   # the loss was read: synced
        if i % 100 == 0:
            say(f"[fit] step {i}: loss {loss:.5f}")

    t0 = time.perf_counter()
    fitted, losses, final = fit_scene_tiled(
        init, train_cams, train_imgs, FIT_SETTINGS, steps=fit_steps,
        lr=FIT_LR, config=cfg, progress=fit_progress)
    _sync(device)
    t_fit = time.perf_counter() - t0
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    psnrs, ssims = held_out_metrics(fitted, test_cams, test_imgs,
                                    FIT_SETTINGS, cfg)
    return dict(
        config=dict(gt_gaussians=n_gt, poses=poses, spp=spp, res=res,
                    pc_rays=n_pc_rays, fit_steps=fit_steps,
                    fitted_gaussians=int(m),
                    backend="tiled+grid capture -> tiled fwd+bwd fit"),
        capture_s=t_capture,
        fit_s=t_fit,
        train_loss_first=losses[0], train_loss_last=losses[-1],
        train_pose0_psnr=final["psnr"], train_pose0_ssim=final["ssim"],
        test_psnr_mean=float(np.mean(psnrs)),
        test_ssim_mean=float(np.mean(ssims)),
        test_psnr=psnrs, test_ssim=ssims,
        device=device_line(device),
        fit_step_ms=statistics.median(step_ms) if step_ms else None,
        fitted=fitted)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    env = os.environ.get
    out_dir = env("GSPT_DS_DIR", DEFAULT_DIR)
    result = run_downstream(
        out_dir, n_gt=int(env("GSPT_DS_N", 50_000)),
        poses=int(env("GSPT_DS_POSES", 8)), spp=int(env("GSPT_DS_SPP", 32)),
        res=int(env("GSPT_DS_RES", 200)),
        n_pc_rays=int(env("GSPT_DS_PC_RAYS", 40_000)),
        fit_steps=int(env("GSPT_DS_STEPS", 600)), device=args.device)
    result.pop("fitted")
    print(json.dumps(result, indent=1), flush=True)
    path = os.path.join(out_dir, "downstream.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return result


if __name__ == "__main__":
    main()
