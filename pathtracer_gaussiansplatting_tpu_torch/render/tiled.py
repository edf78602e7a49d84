"""Tile-binned primary-ray renderer.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/tiled.py``
(``_packet_features``, ``tile_composite_reference``, ``_tile_dirs``,
``prepare_tiles``, ``render_prepared``, ``untile_image``, ``render_tiled``;
``render_tiled_fused`` is its ``render_tiled_pallas``). Each 16x16 screen
tile composites its K front-to-back Gaussians (ops/binning.py) in
mean-depth order, the ordering approximation of 3DGS rasterizers.

Per pose, :func:`prepare_tiles` projects, bins and gathers the packets
once; per sample, :func:`render_prepared` composites them for (optionally
jittered) rays through the fused kernel (kernels/tile_composite.py).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels.tile_composite import (
    build_tile_packets, tile_composite,
)
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
    BinningConfig, bin_gaussians, num_tiles, project_gaussians,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.safe_math import (
    safe_normalize,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.profiling import span

ALL_OUTPUTS = ("color", "feats", "alpha_acc", "depth")


def _packet_features(scene: GaussianScene, cam_pos: torch.Tensor,
                     settings: RenderSettings) -> torch.Tensor:
    """Per-Gaussian feature rows (N, 14): rgb(3) emission(3) metallic(1)
    roughness(1) normal(3) clearcoat(1) clearcoat_roughness(1)
    transmission(1). Color is SH along camera->mean; the normal is the
    surfel normal faced toward the camera."""
    dirs = safe_normalize(scene.means - cam_pos[None])
    color = sh_mod.eval_sh(scene.sh_coeffs, dirs, settings.sh_degree)
    normal = gops.surfel_normal(scene.log_scales, scene.quats, view_dir=dirs)
    return torch.cat([
        color, scene.emission, scene.metallic[:, None],
        scene.roughness[:, None], normal, scene.clearcoat[:, None],
        scene.clearcoat_roughness[:, None], scene.transmission[:, None],
    ], dim=-1)


def tile_composite_reference(origin, pixel_dirs, means, m_mats, opacities,
                             feats, mask, settings: RenderSettings):
    """Composite tiles from their gathered Gaussians: the semantic spec of
    the fused kernel, batched over leading tile dims.

    Args:
      origin: (3,) shared ray origin; pixel_dirs: (..., P, 3);
      means (..., K, 3), m_mats (..., K, 3, 3), opacities (..., K),
      feats (..., K, F), mask (..., K) bool — sorted front to back.
    Returns out (..., P, F), alpha_acc (..., P), depth (..., P).
    """
    og = torch.einsum("...kij,...kj->...ki", m_mats, origin - means)
    dg = torch.einsum("...kij,...pj->...pki", m_mats, pixel_dirs)
    a = torch.clamp_min(torch.sum(dg * dg, dim=-1), 1e-12)
    b = torch.einsum("...pki,...ki->...pk", dg, og)
    c = torch.sum(og * og, dim=-1)[..., None, :]
    t_peak = torch.clamp(-b / a, settings.t_min, settings.t_max)
    q = a * t_peak * t_peak + 2.0 * b * t_peak + c
    gval = torch.exp(-0.5 * torch.clamp_min(q, 0.0))
    alpha = gops.alpha_from_response(
        opacities[..., None, :], gval, settings.alpha_min,
        settings.alpha_max, settings.sigma_cut)
    alpha = torch.where(mask[..., None, :], alpha, torch.zeros_like(alpha))
    weights, trans = composite_weights(alpha)
    out = weights @ feats
    alpha_acc = 1.0 - trans
    depth = torch.sum(weights * t_peak, dim=-1) / torch.clamp_min(alpha_acc,
                                                                  1e-8)
    return out, alpha_acc, depth


def untile_image(x: torch.Tensor, camera: Camera,
                 config: BinningConfig) -> torch.Tensor:
    """(T, P, C) tile-major -> (H, W, C) row-major image."""
    ts = config.tile_size
    tiles_x, tiles_y = num_tiles(camera, config)
    ch = x.shape[-1]
    x = x.reshape(tiles_y, tiles_x, ts, ts, ch).permute(0, 2, 1, 3, 4)
    return x.reshape(tiles_y * ts, tiles_x * ts, ch)[:camera.height,
                                                     :camera.width]


def _tile_dirs(camera: Camera, config: BinningConfig,
               jitter: Optional[torch.Tensor] = None):
    """Per-tile pixel directions (T, P, 3), edge-padded to whole tiles, and
    the ``untile`` that maps (T, P, C) back to (H, W, C)."""
    ts = config.tile_size
    tiles_x, tiles_y = num_tiles(camera, config)
    pad_w, pad_h = tiles_x * ts, tiles_y * ts
    h, w = camera.height, camera.width
    dirs = generate_rays(camera, jitter=jitter).directions.reshape(h, w, 3)
    dev = dirs.device
    rows = torch.clamp_max(torch.arange(pad_h, device=dev), h - 1)
    cols = torch.clamp_max(torch.arange(pad_w, device=dev), w - 1)
    dirs = dirs[rows][:, cols]                                # edge padding
    dirs_t = dirs.reshape(tiles_y, ts, tiles_x, ts, 3).permute(0, 2, 1, 3, 4)
    dirs_t = dirs_t.reshape(tiles_y * tiles_x, ts * ts, 3)
    return dirs_t, functools.partial(untile_image, camera=camera,
                                     config=config)


def prepare_tiles(scene: GaussianScene, camera: Camera,
                  settings: RenderSettings = RenderSettings(),
                  config: BinningConfig = BinningConfig()
                  ) -> Dict[str, torch.Tensor]:
    """Per-(scene, pose) preprocessing: projection, binning, packet gather.

    Runs once per pose; :func:`render_prepared` then runs per sample.
    Returns the packets (geom, featsT, count) plus the binning stats as
    ``stat_*`` scalar tensors. While a profiler records, the work is the
    range ``ptgs.bin``.
    """
    if config.alpha_min != settings.alpha_min:
        # The footprint shrink assumes the compositor kills alpha below the
        # same cutoff; a mismatch drops splats near tile edges.
        raise ValueError(
            f"BinningConfig.alpha_min ({config.alpha_min}) must match "
            f"RenderSettings.alpha_min ({settings.alpha_min})")
    with span("ptgs.bin"):
        tiles_x, tiles_y = num_tiles(camera, config)
        # Binning yields indices, masks and stats: nothing to differentiate.
        with torch.no_grad():
            proj = project_gaussians(scene, camera, config)
            tile_idx, tile_mask, _, stats = bin_gaussians(proj, tiles_x,
                                                          tiles_y, config)
        origin = camera.c2w[:3, 3]
        feats_all = _packet_features(scene, origin, settings)
        packets = build_tile_packets(scene, feats_all, origin, tile_idx,
                                     tile_mask)
        for k, v in stats.items():
            packets["stat_" + k] = v
        return packets


def render_prepared(packets, camera: Camera,
                    settings: RenderSettings = RenderSettings(),
                    config: BinningConfig = BinningConfig(),
                    jitter: Optional[torch.Tensor] = None,
                    outputs: tuple = ALL_OUTPUTS) -> Dict[str, torch.Tensor]:
    """Composite one sample from prepared packets.

    ``outputs`` selects the results: image-shaped "color" (with
    background), "feats", "alpha_acc", "depth", or tile-major
    "tile_feats" (T, P, F), "tile_alpha" (T, P), "tile_depth" (T, P),
    "tile_dirs" (T, P, 3), which skip the untile.
    """
    dirs_t, untile = _tile_dirs(camera, config, jitter=jitter)
    out, alpha_acc, depth = tile_composite(packets, dirs_t, settings)
    res = {}
    if "tile_feats" in outputs:
        res["tile_feats"] = out
    if "tile_alpha" in outputs:
        res["tile_alpha"] = alpha_acc
    if "tile_depth" in outputs:
        res["tile_depth"] = depth
    if "tile_dirs" in outputs:
        res["tile_dirs"] = dirs_t
    if "alpha_acc" in outputs or "color" in outputs:
        alpha_img = untile(alpha_acc[..., None])[..., 0]
    if "color" in outputs:
        bg = torch.tensor(settings.background, dtype=torch.float32,
                          device=out.device)
        res["color"] = untile(out[..., :3]) + (1.0 - alpha_img[..., None]) * bg
    if "feats" in outputs:
        res["feats"] = untile(out)
    if "alpha_acc" in outputs:
        res["alpha_acc"] = alpha_img
    if "depth" in outputs:
        res["depth"] = untile(depth[..., None])[..., 0]
    return res


def render_tiled_fused(scene: GaussianScene, camera: Camera,
                       settings: RenderSettings = RenderSettings(),
                       config: BinningConfig = BinningConfig()):
    """:func:`render_tiled` semantics through the fused compositor
    (``prepare_tiles`` + ``render_prepared``)."""
    packets = prepare_tiles(scene, camera, settings, config)
    return render_prepared(packets, camera, settings, config)


def render_tiled(scene: GaussianScene, camera: Camera,
                 settings: RenderSettings = RenderSettings(),
                 config: BinningConfig = BinningConfig(), chunk: int = 64):
    """Primary rays through tile binning and the per-tile oracle
    (:func:`tile_composite_reference`), ``chunk`` tiles at a time.

    Returns full-image color (with background), feats, alpha_acc, depth.
    """
    tiles_x, tiles_y = num_tiles(camera, config)
    with torch.no_grad():
        proj = project_gaussians(scene, camera, config)
        tile_idx, tile_mask, _, _ = bin_gaussians(proj, tiles_x, tiles_y,
                                                  config)
    dirs_t, untile = _tile_dirs(camera, config)
    origin = camera.c2w[:3, 3]
    m_all = gops.canonical_transforms(scene.log_scales, scene.quats)
    feats_all = _packet_features(scene, origin, settings)
    opac_all = scene.opacities
    parts = []
    for s in range(0, tile_idx.shape[0], chunk):
        idx = tile_idx[s:s + chunk].long()
        parts.append(tile_composite_reference(
            origin, dirs_t[s:s + chunk], scene.means[idx], m_all[idx],
            opac_all[idx], feats_all[idx], tile_mask[s:s + chunk], settings))
    out, alpha_acc, depth = (torch.cat(x, dim=0) for x in zip(*parts))
    out_img = untile(out)
    alpha_img = untile(alpha_acc[..., None])[..., 0]
    bg = torch.tensor(settings.background, dtype=torch.float32,
                      device=out.device)
    return dict(color=out_img[..., :3] + (1.0 - alpha_img[..., None]) * bg,
                feats=out_img, alpha_acc=alpha_img,
                depth=untile(depth[..., None])[..., 0])
