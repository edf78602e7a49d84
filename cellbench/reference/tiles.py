"""Primary rays through the tile binning and the tile composite, in plain
torch: the EWA projection and dup-and-sort binning, the packet features
and gather, and the full-K composite (frozen copies of the port's
``ops/binning.py``, ``render/tiled.py`` and ``kernels/tile_composite.py``
plain versions), with the camera's rays worked out pixel by pixel.

``lowp=True`` rounds the packets and the per-pair quadratic to bfloat16
(the benchmark's control: a precision below the configuration's float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from . import sh as sh_mod
from .gaussians import surfel_normal
from .quaternions import rotmat_cols
from .safe_math import safe_normalize
from .types import GaussianScene


# Geometry packet rows (geom (T, 16, K)): Q upper triangle
# [q00, q11, q22, 2q01, 2q02, 2q12], Q (o - mu), c, opacity; rows 11-15 zero.
ROW_C, ROW_OPAC, GEOM_ROWS = 9, 10, 16


def rnd(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """x rounded to bfloat16 and back where ``lowp``, else x."""
    return x.to(torch.bfloat16).to(x.dtype) if lowp else x


@dataclasses.dataclass(frozen=True)
class Camera:
    c2w: torch.Tensor
    fov_y_deg: float
    width: int
    height: int


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-8)


def _c2w(rot_cols, pos) -> torch.Tensor:
    c2w = torch.eye(4, dtype=torch.float32, device=pos.device)
    c2w[:3, :3] = torch.stack(rot_cols, dim=-1)
    c2w[:3, 3] = pos
    return c2w


def look_at(eye, target, device, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    eye, target, up = (torch.tensor(v, dtype=torch.float32, device=device)
                       for v in (eye, target, up))
    fwd = _unit(target - eye)
    right = _unit(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    return _c2w([right, true_up, -fwd], eye)


def _rotate_about_axis(v, axis, angle_rad):
    axis = _unit(axis)
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    return (v * c + torch.linalg.cross(axis, v) * s
            + axis * torch.dot(axis, v) * (1.0 - c))


def toroidal_c2w(alpha_deg, beta_deg, major_radius, height,
                 device) -> torch.Tensor:
    """The pose on the torus centerline (``core/camera.toroidal_c2w``)."""
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.deg2rad(torch.remainder(torch.tensor(alpha_deg, **f32), 360.0))
    b = torch.deg2rad(torch.remainder(torch.tensor(beta_deg, **f32), 360.0))
    zero = torch.zeros_like(a)
    pos = torch.stack([torch.cos(a), zero, torch.sin(a)]) * major_radius
    pos = pos + torch.tensor([0.0, height, 0.0], **f32)
    base_forward = torch.stack([-torch.cos(a), zero, -torch.sin(a)])
    base_up = torch.tensor([0.0, 1.0, 0.0], **f32)
    right = _unit(torch.linalg.cross(base_forward, base_up))
    fwd = _rotate_about_axis(base_forward, right, b)
    up = _rotate_about_axis(base_up, right, b)
    return _c2w([right, up, -fwd], pos)


def pixel_dirs(camera: Camera, py: torch.Tensor, px: torch.Tensor,
               jx=0.5, jy=0.5) -> torch.Tensor:
    """Unit ray directions of pixels (py, px) (int tensors) with subpixel
    offsets (jx, jy), as ``core/camera.generate_rays`` makes them."""
    h, w = camera.height, camera.width
    dev = camera.c2w.device
    fy = torch.deg2rad(torch.tensor(camera.fov_y_deg, dtype=torch.float32,
                                    device=dev))
    tan_y = torch.tan(fy / 2.0)
    tan_x = tan_y * (w / h)
    u = ((px.float() + jx) / w) * 2.0 - 1.0
    v = ((py.float() + jy) / h) * 2.0 - 1.0
    right, up, fwd = camera.c2w[:3, 0], camera.c2w[:3, 1], -camera.c2w[:3, 2]
    dirs = fwd + u[..., None] * tan_x * right - v[..., None] * tan_y * up
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


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


def _packet_features(scene: GaussianScene, cam_pos: torch.Tensor,
                     settings) -> torch.Tensor:
    """Per-Gaussian feature rows (N, 14): rgb(3) emission(3) metallic(1)
    roughness(1) normal(3) clearcoat(1) clearcoat_roughness(1)
    transmission(1). Color is SH along camera->mean; the normal is the
    surfel normal faced toward the camera."""
    dirs = safe_normalize(scene.means - cam_pos[None])
    color = sh_mod.eval_sh(scene.sh_coeffs, dirs, settings.sh_degree)
    normal = surfel_normal(scene.log_scales, scene.quats, view_dir=dirs)
    return torch.cat([
        color, scene.emission, scene.metallic[:, None],
        scene.roughness[:, None], normal, scene.clearcoat[:, None],
        scene.clearcoat_roughness[:, None], scene.transmission[:, None],
    ], dim=-1)


def build_tile_packets(scene: GaussianScene, feats_all: torch.Tensor,
                       origin: torch.Tensor, tile_idx: torch.Tensor,
                       tile_mask: torch.Tensor, lowp: bool = False):
    """Gather per-tile Gaussian packets for the compositor.

    Args:
      scene: the full scene; feats_all: (N, F) per-Gaussian features;
      origin: (3,) camera position; tile_idx / tile_mask: (T, K) binning
      tables.

    Returns dict: geom (T, 16, K), featsT (T, F, K) and count (T,) float32,
    1 + the index of the tile's last valid slot.
    """
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_cols(scene.quats)
    d0 = torch.exp(-2.0 * scene.log_scales[:, 0])
    d1 = torch.exp(-2.0 * scene.log_scales[:, 1])
    d2 = torch.exp(-2.0 * scene.log_scales[:, 2])
    q00 = r00 * r00 * d0 + r01 * r01 * d1 + r02 * r02 * d2
    q11 = r10 * r10 * d0 + r11 * r11 * d1 + r12 * r12 * d2
    q22 = r20 * r20 * d0 + r21 * r21 * d1 + r22 * r22 * d2
    q01 = r00 * r10 * d0 + r01 * r11 * d1 + r02 * r12 * d2
    q02 = r00 * r20 * d0 + r01 * r21 * d1 + r02 * r22 * d2
    q12 = r10 * r20 * d0 + r11 * r21 * d1 + r12 * r22 * d2
    ogx = origin[0] - scene.means[:, 0]
    ogy = origin[1] - scene.means[:, 1]
    ogz = origin[2] - scene.means[:, 2]
    wb0 = q00 * ogx + q01 * ogy + q02 * ogz
    wb1 = q01 * ogx + q11 * ogy + q12 * ogz
    wb2 = q02 * ogx + q12 * ogy + q22 * ogz
    c_all = wb0 * ogx + wb1 * ogy + wb2 * ogz

    # One (N, 11 + F) table and one row gather.
    cols = [q00, q11, q22, 2.0 * q01, 2.0 * q02, 2.0 * q12,
            wb0, wb1, wb2, c_all, scene.opacities]
    table = rnd(torch.cat([torch.stack(cols, dim=-1), feats_all], dim=-1),
                lowp)
    rows = table[tile_idx.long()]                          # (T, K, 11 + F)
    t_total, k = tile_idx.shape
    geom = rows.new_zeros((t_total, GEOM_ROWS, k))
    geom[:, :ROW_OPAC] = rows[..., :ROW_OPAC].transpose(1, 2)
    geom[:, ROW_OPAC] = torch.where(tile_mask, rows[..., ROW_OPAC],
                                    torch.zeros_like(rows[..., ROW_OPAC]))
    featsT = rows[..., ROW_OPAC + 1:].transpose(1, 2).contiguous()
    slot1 = torch.arange(1, k + 1, dtype=torch.float32,
                         device=tile_idx.device)
    count = torch.amax(torch.where(tile_mask, slot1, torch.zeros_like(slot1)),
                       dim=-1)
    return dict(geom=geom, featsT=featsT, count=count)


def _cumprod_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along the last axis by Hillis-Steele doubling (the
    reference's expansion, kept for identical rounding)."""
    k = x.shape[-1]
    ones = torch.ones_like(x[..., :1])
    y = torch.cat([ones, x[..., :-1]], dim=-1)
    shift = 1
    while shift < k:
        y = y * torch.cat([ones.expand(*x.shape[:-1], shift), y[..., :-shift]],
                          dim=-1)
        shift *= 2
    return y


def _quadratic_ab(dirs: torch.Tensor, geom: torch.Tensor):
    """a = d^T Q d (before its clamp) and b = d^T Q (o - mu), (B, P, K),
    for dirs (B, P, 3) and geom (B, 16, K)."""
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]  # (B, P, 1)
    g = geom[:, :, None, :]                                  # (B, 16, 1, K)
    a = (dx * dx * g[:, 0] + dy * dy * g[:, 1] + dz * dz * g[:, 2]
         + dx * dy * g[:, 3] + dx * dz * g[:, 4] + dy * dz * g[:, 5])
    b = dx * g[:, 6] + dy * g[:, 7] + dz * g[:, 8]
    return a, b


def _t_alpha(a: torch.Tensor, b: torch.Tensor, geom: torch.Tensor,
             settings, lowp: bool = False):
    """(t, alpha) (B, P, K) of every (pixel, slot) pair from the quadratic
    forms (:func:`_quadratic_ab`), with the cutoffs and clamp."""
    g = geom[:, :, None, :]
    a = torch.clamp_min(a, 1e-12)
    t = torch.clamp(-b / a, settings.t_min, settings.t_max)
    qv = (a * t + 2.0 * b) * t + g[:, ROW_C]
    gval = rnd(torch.exp(-0.5 * torch.clamp_min(rnd(qv, lowp), 0.0)), lowp)
    alpha0 = g[:, ROW_OPAC] * gval
    cut = math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)
    live = (gval >= cut) & (alpha0 >= settings.alpha_min)
    alpha = torch.where(live, torch.clamp_max(alpha0, settings.alpha_max),
                        torch.zeros_like(alpha0))
    return t, alpha


def _composite_from_ab(a: torch.Tensor, b: torch.Tensor, geom: torch.Tensor,
                       featsT: torch.Tensor, settings, lowp: bool = False):
    """Full-K composite (no chunking, no early exit) of a batch of tiles
    from their quadratic forms (:func:`_quadratic_ab`)."""
    t, alpha = _t_alpha(rnd(a, lowp), rnd(b, lowp), geom, settings, lowp)
    om = 1.0 - alpha
    excl = _cumprod_excl(om)
    w = excl * alpha
    out = torch.matmul(w, featsT.transpose(1, 2))               # (B, P, F)
    alpha_acc = 1.0 - excl[..., -1] * om[..., -1]
    depth = torch.sum(w * t, dim=-1) / torch.clamp_min(alpha_acc, 1e-8)
    return out, alpha_acc, depth


def view_matrix(camera: Camera) -> torch.Tensor:
    """World-to-camera matrix (4, 4)."""
    r, t = camera.c2w[:3, :3], camera.c2w[:3, 3]
    w2c = torch.eye(4, dtype=torch.float32, device=r.device)
    w2c[:3, :3] = r.T
    w2c[:3, 3] = -(r.T @ t)
    return w2c


PLAIN_CHUNK_ELEMS = 1 << 24  # (rays or tiles, P, K) elements per chunk


def composite(geom, featsT, dirs, settings, lowp: bool = False):
    """(out (B, P, F), alpha_acc (B, P), depth (B, P)) of dirs (B, P, 3)
    through packets geom (B, 16, K), featsT (B, F, K), in chunks."""
    b_total, p, _ = dirs.shape
    k = geom.shape[-1]
    step = max(1, PLAIN_CHUNK_ELEMS // max(p * k, 1))
    parts = [_composite_from_ab(*_quadratic_ab(dirs[s:s + step],
                                               geom[s:s + step]),
                                geom[s:s + step], featsT[s:s + step],
                                settings, lowp)
             for s in range(0, b_total, step)]
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def prepare(scene: GaussianScene, camera: Camera, settings,
            config: BinningConfig, lowp: bool = False):
    """Per-pose packets (geom, featsT) of every tile, as the port's
    ``prepare_tiles`` makes them; differentiable in the scene."""
    tiles_x, tiles_y = num_tiles(camera, config)
    with torch.no_grad():
        proj = project_gaussians(scene, camera, config)
        tile_idx, tile_mask, _, _ = bin_gaussians(proj, tiles_x, tiles_y,
                                                  config)
    origin = camera.c2w[:3, 3]
    feats_all = _packet_features(scene, origin, settings)
    return build_tile_packets(scene, feats_all, origin, tile_idx, tile_mask,
                              lowp)


def tile_pixels(camera: Camera, config: BinningConfig):
    """(py, px) (T, P) of every tile's pixels, edge-padded as the port's
    ``_tile_dirs`` pads them."""
    ts = config.tile_size
    tiles_x, tiles_y = num_tiles(camera, config)
    dev = camera.c2w.device
    ty = torch.arange(tiles_y, device=dev).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=dev).repeat(tiles_y)
    iy = torch.arange(ts, device=dev).repeat_interleave(ts)
    ix = torch.arange(ts, device=dev).repeat(ts)
    py = torch.clamp_max(ty[:, None] * ts + iy[None], camera.height - 1)
    px = torch.clamp_max(tx[:, None] * ts + ix[None], camera.width - 1)
    return py, px


def render_image(scene: GaussianScene, camera: Camera, settings,
                 config: BinningConfig, lowp: bool = False) -> torch.Tensor:
    """(H, W, 3) unjittered colour with the background, as the port's
    ``render_prepared(..., outputs=("color",))``; differentiable."""
    packets = prepare(scene, camera, settings, config, lowp)
    py, px = tile_pixels(camera, config)
    dirs = pixel_dirs(camera, py, px)
    out, alpha, _ = composite(packets["geom"], packets["featsT"], dirs,
                              settings, lowp)
    ts = config.tile_size
    tiles_x, tiles_y = num_tiles(camera, config)

    def untile(x):
        ch = x.shape[-1]
        x = x.reshape(tiles_y, tiles_x, ts, ts, ch).permute(0, 2, 1, 3, 4)
        return x.reshape(tiles_y * ts, tiles_x * ts, ch)[:camera.height,
                                                         :camera.width]

    bg = torch.tensor(settings.background, dtype=torch.float32,
                      device=out.device)
    return untile(out[..., :3]) + (1.0 - untile(alpha[..., None])) * bg
