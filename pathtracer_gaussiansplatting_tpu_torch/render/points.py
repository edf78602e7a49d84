"""Point-cloud view: a z-buffered point rasterizer.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/points.py``
(``rasterize_points``, ``render_point_cloud``): one point per captured
hit, misses discarded, in two placements, "world" (the hit positions) and
"torus" (each point on the torus sensor at the (u, v) that generated its
ray, which shows the sampling's coverage).

The depth test is the JAX package's packed (depth, id) scatter-min: each
point's quantized depth in the high bits and its id in the low bits of one
int32, min-reduced per pixel (``scatter_reduce_`` with "amin"), so the
nearest point wins in one deterministic scatter. Points are splatted as
point_size x point_size pixel squares (2 by default). It is plain torch,
as the reference is plain XLA.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, view_matrix,
)
from pathtracer_gaussiansplatting_tpu_torch.core.torus import (
    TorusConfig, torus_point_normal,
)


def _project(points: torch.Tensor, camera: Camera):
    """World -> pixel coordinates and view depth: (xy (N, 2), depth (N,))."""
    w2c = view_matrix(camera)
    p_view = points @ w2c[:3, :3].T + w2c[:3, 3]
    depth = -p_view[:, 2]
    z = torch.clamp_min(depth, 1e-6)
    fov = torch.deg2rad(torch.tensor(camera.fov_y_deg, dtype=torch.float32,
                                     device=points.device))
    fy = 0.5 * camera.height / torch.tan(fov / 2.0)
    x = fy * (p_view[:, 0] / z) + 0.5 * camera.width
    y = fy * (-p_view[:, 1] / z) + 0.5 * camera.height
    return torch.stack([x, y], -1), depth


@torch.no_grad()
def rasterize_points(points: torch.Tensor, colors: torch.Tensor,
                     valid: torch.Tensor, camera: Camera,
                     background=(0.0, 0.0, 0.0),
                     point_size: int = 2) -> torch.Tensor:
    """Render points with the nearest depth winning; (H, W, 3) on the
    points' device.

    Args:
      points: (N, 3) world positions; colors: (N, 3); valid: (N,) bool
        (points with a flag <= 0 are discarded).
    """
    h, w = camera.height, camera.width
    dev = points.device
    xy, depth = _project(points, camera)
    n = points.shape[0]
    ix = torch.floor(xy[:, 0]).to(torch.int32)
    iy = torch.floor(xy[:, 1]).to(torch.int32)
    ok = valid & (depth > 1e-4) & (ix >= 0) & (iy >= 0) \
        & (ix < w) & (iy < h)

    # The id takes ceil(log2 N) bits; the depth the rest, capped at 22 bits
    # so its quantized value is exact in float32 (2^22 < 2^24) and the
    # packed int32 stays below the sentinel (depth_bits + id_bits <= 29).
    id_bits = max(1, math.ceil(math.log2(n + 1)))
    depth_bits = min(29 - id_bits, 22)
    assert depth_bits >= 4, f"too many points for the packed z-test: {n}"
    inf = torch.tensor(math.inf, device=dev)
    d_lo = torch.min(torch.where(ok, depth, inf))
    d_hi = torch.max(torch.where(ok, depth, -inf))
    top = 2.0 ** depth_bits - 1.0
    scale = top / torch.clamp_min(d_hi - d_lo, 1e-6)
    dq = torch.clamp((depth - d_lo) * scale, 0, top)
    ids = torch.arange(n, dtype=torch.int32, device=dev) % (2 ** id_bits)
    packed = dq.to(torch.int32) * (2 ** id_bits) + ids
    sentinel = 2 ** 30
    packed = torch.where(ok, packed, sentinel)

    zbuf = torch.full((h * w,), sentinel, dtype=torch.int32, device=dev)
    for dy in range(point_size):
        for dx in range(point_size):
            px = torch.clamp(ix + dx, 0, w - 1)
            py = torch.clamp(iy + dy, 0, h - 1)
            zbuf.scatter_reduce_(0, (py * w + px).long(), packed, "amin")

    hit = zbuf < sentinel
    win_id = (zbuf % (2 ** id_bits)).long()
    bg = torch.tensor(background, dtype=torch.float32, device=dev)
    img = torch.where(hit[:, None], colors[win_id], bg[None])
    return img.reshape(h, w, 3)


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def render_point_cloud(positions, colors, flags, camera: Camera,
                       mode: str = "world", uv=None,
                       torus: TorusConfig = None,
                       background=(0.0, 0.0, 0.0),
                       point_size: int = 2) -> torch.Tensor:
    """Point-cloud view of a capture's hits on the camera's device.

    Args:
      positions, colors, flags: the torus capture's per-ray hits (or a
        loaded points3d.ply); flags > 0 marks a hit.
      mode: "world" places the points at their hit positions; "torus" on
        the torus surface at their generating (u, v) (needs ``uv`` and
        ``torus``).
    """
    dev = camera.c2w.device
    positions = _tensor(positions, dev).float()
    colors = _tensor(colors, dev).float()
    valid = _tensor(flags, dev) > 0
    if mode == "torus":
        if uv is None or torus is None:
            raise ValueError("mode='torus' needs uv samples and TorusConfig")
        positions, _ = torus_point_normal(_tensor(uv, dev).float(), torus)
    elif mode != "world":
        raise ValueError(f"unknown mode {mode!r}")
    return rasterize_points(positions, colors, valid, camera,
                            background=background, point_size=point_size)
