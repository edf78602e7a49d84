"""Screen-tile binning of Gaussians: EWA projection and dup-and-sort lists.

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/binning.py``
(``BinningConfig``, ``project_gaussians``, ``num_tiles``, ``_footprint``,
``bin_gaussians``). Each Gaussian stamps the tiles its effective-sigma
rectangle covers (a centered window of at most ``max_tiles_per_gaussian``
tiles); the (tile, Gaussian) pairs are sorted once by a packed int32 key
(tile << depth_bits | quantized depth) and the first K of each tile's run
form its front-to-back list. Every truncation is counted in ``stats``.

Order within a tile: the sort is stable here and not in the reference, so
pairs whose packed keys tie may come out in another order. Tests compare
per-tile sets, not the raw order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, view_matrix,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import GaussianScene
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import rotmat_cols


@dataclasses.dataclass(frozen=True)
class BinningConfig:
    """Binning knobs; every default equals the JAX ``BinningConfig``."""

    tile_size: int = 16
    max_tiles_per_gaussian: int = 16  # cap on stamped tiles per Gaussian
    max_per_tile: int = 512           # K: per-tile list capacity
    sigma_extent: float = 3.0         # stamp tiles within k sigma
    near: float = 0.05                # cull behind this view depth
    radius_clamp_px: float = 512.0    # cap on the projected radius
    alpha_min: float = 1.0 / 255.0    # must match RenderSettings.alpha_min


def project_gaussians(scene: GaussianScene, camera: Camera,
                      config: BinningConfig) -> Dict[str, torch.Tensor]:
    """EWA projection of the Gaussians to screen space.

    Returns per-Gaussian xy (N, 2) pixel center, depth (N,) view depth,
    rx / ry (N,) conservative pixel half-extents of the opacity-aware
    effective-sigma ellipse, radius = max(rx, ry), and valid (N,) bool.
    """
    w2c = view_matrix(camera)
    a00, a01, a02 = w2c[0, 0], w2c[0, 1], w2c[0, 2]
    a10, a11, a12 = w2c[1, 0], w2c[1, 1], w2c[1, 2]
    a20, a21, a22 = w2c[2, 0], w2c[2, 1], w2c[2, 2]
    t0, t1, t2 = w2c[0, 3], w2c[1, 3], w2c[2, 3]
    mx, my, mz = scene.means[:, 0], scene.means[:, 1], scene.means[:, 2]
    p0 = a00 * mx + a01 * my + a02 * mz + t0   # view space, camera looks -z
    p1 = a10 * mx + a11 * my + a12 * mz + t1
    p2 = a20 * mx + a21 * my + a22 * mz + t2
    depth = -p2
    h, w = camera.height, camera.width
    fov = torch.tensor(camera.fov_y_deg, dtype=torch.float32,
                       device=w2c.device)
    fy = 0.5 * h / torch.tan(torch.deg2rad(fov) / 2.0)
    fx = fy  # square pixels

    z = torch.clamp_min(depth, config.near)
    inv_z = 1.0 / z
    x_ndc = p0 * inv_z
    y_ndc = -p1 * inv_z  # image y grows downward
    xy = torch.stack([fx * x_ndc + 0.5 * w, fy * y_ndc + 0.5 * h], dim=-1)

    # World covariance C = R diag(exp(2 log_s)) R^T, entry by entry.
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_cols(scene.quats)
    s0 = torch.exp(2.0 * scene.log_scales[:, 0])
    s1 = torch.exp(2.0 * scene.log_scales[:, 1])
    s2 = torch.exp(2.0 * scene.log_scales[:, 2])
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    # View covariance V = A C A^T with A the w2c rotation.
    b00 = a00 * c00 + a01 * c01 + a02 * c02
    b01 = a00 * c01 + a01 * c11 + a02 * c12
    b02 = a00 * c02 + a01 * c12 + a02 * c22
    b10 = a10 * c00 + a11 * c01 + a12 * c02
    b11 = a10 * c01 + a11 * c11 + a12 * c12
    b12 = a10 * c02 + a11 * c12 + a12 * c22
    b20 = a20 * c00 + a21 * c01 + a22 * c02
    b21 = a20 * c01 + a21 * c11 + a22 * c12
    b22 = a20 * c02 + a21 * c12 + a22 * c22
    v00 = b00 * a00 + b01 * a01 + b02 * a02
    v02 = b00 * a20 + b01 * a21 + b02 * a22
    v11 = b10 * a10 + b11 * a11 + b12 * a12
    v12 = b10 * a20 + b11 * a21 + b12 * a22
    v22 = b20 * a20 + b21 * a21 + b22 * a22

    # Perspective Jacobian at the mean; depth = -z_view flips the d/dz terms.
    j00 = fx * inv_z
    j02 = fx * p0 * inv_z * inv_z
    j11 = -fy * inv_z
    j12 = fy * p1 * inv_z * inv_z
    # Only the diagonal of the 2D covariance: the radii below are per axis.
    cov00 = j00 * j00 * v00 + 2.0 * j00 * j02 * v02 + j02 * j02 * v22
    cov11 = j11 * j11 * v11 + 2.0 * j11 * j12 * v12 + j12 * j12 * v22
    cov00 = cov00 + 0.3   # low-pass: each splat at least ~a pixel wide
    cov11 = cov11 + 0.3

    # Past q = 2 ln(opac / alpha_min) the compositor kills alpha anyway.
    opac = scene.opacities
    sig_eff = torch.clamp_max(torch.sqrt(torch.clamp_min(
        2.0 * torch.log(torch.clamp_min(opac, 1e-12) / config.alpha_min),
        1e-12)), config.sigma_extent)
    # |dx| > sigma sqrt(cov00) implies q > sigma^2: the (rx, ry) rectangle
    # is conservative.
    rx = torch.clamp_max(sig_eff * torch.sqrt(cov00), config.radius_clamp_px)
    ry = torch.clamp_max(sig_eff * torch.sqrt(cov11), config.radius_clamp_px)

    valid = (depth > config.near) & (opac > config.alpha_min)
    valid &= (xy[:, 0] + rx > 0) & (xy[:, 0] - rx < w)
    valid &= (xy[:, 1] + ry > 0) & (xy[:, 1] - ry < h)
    return dict(xy=xy, depth=depth, rx=rx, ry=ry,
                radius=torch.maximum(rx, ry), valid=valid)


def num_tiles(camera: Camera, config: BinningConfig) -> Tuple[int, int]:
    ts = config.tile_size
    return (-(-camera.width // ts), -(-camera.height // ts))


def _footprint(proj, tiles_x: int, tiles_y: int, config: BinningConfig):
    """Tile window per Gaussian: the clamped bbox cut to a centered window
    of at most ``max_tiles_per_gaussian`` tiles.

    Returns (cx0, cy0, bw_c, count_c, valid, dropped): window origin
    (int32), window width and tile count (float32), validity, and the
    tiles each Gaussian lost to the cap (float32).
    """
    ts = config.tile_size
    m_cap = config.max_tiles_per_gaussian
    xy, valid = proj["xy"], proj["valid"]
    rx, ry = proj["rx"], proj["ry"]
    tx0 = torch.clamp(torch.floor((xy[:, 0] - rx) / ts), 0, tiles_x - 1)
    tx1 = torch.clamp(torch.floor((xy[:, 0] + rx) / ts), 0, tiles_x - 1)
    ty0 = torch.clamp(torch.floor((xy[:, 1] - ry) / ts), 0, tiles_y - 1)
    ty1 = torch.clamp(torch.floor((xy[:, 1] + ry) / ts), 0, tiles_y - 1)
    bw = tx1 - tx0 + 1.0
    bh = ty1 - ty0 + 1.0
    cover = bw * bh
    # Largest centered window with <= m_cap tiles, aspect kept.
    scale = torch.clamp_max(torch.sqrt(m_cap / cover), 1.0)
    bw_c = torch.clamp_min(torch.floor(bw * scale), 1.0)
    bh_c = torch.clamp_min(torch.floor(bh * scale), 1.0)
    bh_c = torch.minimum(bh_c, torch.floor(m_cap / bw_c))
    cx0 = tx0 + torch.floor(0.5 * (bw - bw_c))
    cy0 = ty0 + torch.floor(0.5 * (bh - bh_c))
    count_c = bw_c * bh_c
    dropped = torch.where(valid, cover - count_c, torch.zeros_like(cover))
    return (cx0.to(torch.int32), cy0.to(torch.int32), bw_c, count_c, valid,
            dropped)


def bin_gaussians(proj, tiles_x: int, tiles_y: int, config: BinningConfig):
    """Per-tile depth-sorted Gaussian lists.

    Returns:
      tile_idx (T, K) int32 Gaussian indices front to back (0 where masked);
      tile_mask (T, K) bool; tile_count (T,) int32 (clamped to K);
      stats: cap_dropped_tiles (pairs lost to the per-Gaussian cap),
        cap_truncated (Gaussians affected), tile_overflow (tiles whose run
        exceeded K), tile_dropped (pairs lost to the per-tile K).
    """
    m_cap = config.max_tiles_per_gaussian
    depth = proj["depth"]
    dev = depth.device
    n = depth.shape[0]
    t_total = tiles_x * tiles_y
    k = config.max_per_tile

    cx0, cy0, bw_c, count_c, valid, dropped = _footprint(
        proj, tiles_x, tiles_y, config)
    stats = dict(cap_dropped_tiles=torch.sum(dropped),
                 cap_truncated=torch.sum((dropped > 0).to(torch.int32)))

    tile_bits = max(1, math.ceil(math.log2(t_total + 2)))
    depth_bits = 30 - tile_bits
    depth_scale = 2 ** depth_bits
    # m-th covered tile of each window, row-major, laid out (M, N).
    m_f = torch.arange(m_cap, dtype=torch.float32, device=dev)[:, None]
    myf = torch.floor(m_f / bw_c[None, :])
    mxf = m_f - myf * bw_c[None, :]
    pair_tile = ((cy0[None, :] + myf.to(torch.int32)) * tiles_x
                 + (cx0[None, :] + mxf.to(torch.int32)))
    pair_ok = valid[None, :] & (m_f < count_c[None, :])
    inf = torch.tensor(float("inf"), device=dev)
    d_lo = torch.min(torch.where(valid, depth, inf))
    d_hi = torch.max(torch.where(valid, depth, -inf))
    d_scale = (depth_scale - 1.0) / torch.clamp_min(d_hi - d_lo, 1e-6)
    depth_q = torch.clamp((depth - d_lo) * d_scale, 0.0,
                          depth_scale - 1.0).to(torch.int32)
    sentinel = (t_total + 1) * depth_scale - 1
    key = torch.where(pair_ok, pair_tile * depth_scale + depth_q[None, :],
                      torch.full_like(pair_tile, sentinel))
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    sorted_gauss = order % n            # pair (m, g) sits at m * n + g
    bounds = torch.searchsorted(
        sorted_key,
        torch.arange(t_total + 1, dtype=torch.int32, device=dev)
        * depth_scale)
    starts, ends = bounds[:-1], bounds[1:]
    slot = torch.arange(k, device=dev)[None, :]
    gather_pos = torch.clamp_max(starts[:, None] + slot,
                                 sorted_key.shape[0] - 1)
    tile_mask = slot < (ends - starts)[:, None]
    tile_idx = torch.where(tile_mask, sorted_gauss[gather_pos],
                           torch.zeros_like(gather_pos)).to(torch.int32)

    run = ends - starts
    tile_count = torch.clamp_max(run, k).to(torch.int32)
    stats["tile_overflow"] = torch.sum((run > k).to(torch.int32))
    stats["tile_dropped"] = torch.sum(torch.clamp_min(run - k, 0))
    return tile_idx, tile_mask, tile_count, stats
