"""Toroidal ray sensor: the dataset capture's point-cloud ray source.

Counterpart of ``pathtracer_gaussiansplatting_tpu/core/torus.py``
(``TorusConfig``, ``torus_point_normal``, ``torus_rays``, ``torus_mesh``):
rays start on the torus surface and shoot outward along its normal. The
defaults are the reference's (R=16, r=1, h=8, 1M rays).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays


@dataclasses.dataclass(frozen=True)
class TorusConfig:
    """Torus sensor parameters; the same fields and defaults as the JAX
    ``TorusConfig``."""

    major_radius: float = 16.0
    minor_radius: float = 1.0
    height: float = 8.0
    num_rays: int = 1_000_000
    major_segments: int = 500   # mesh resolution (visualization only)
    minor_segments: int = 32
    origin_offset: float = 0.05  # the ray origin's offset along the normal


def _uv_tensor(uv, device) -> torch.Tensor:
    """``uv`` as float32 on its own device if it is a tensor and no device
    is given, else on ``device`` (None: the CUDA card)."""
    if isinstance(uv, torch.Tensor):
        return uv.to(device=uv.device if device is None else device,
                     dtype=torch.float32)
    return torch.as_tensor(np.asarray(uv, np.float32),
                           device=resolve_device(device))


def torus_point_normal(uv, config: TorusConfig, device=None):
    """Surface point and outward unit normal, each (..., 3), for (..., 2)
    samples (u, v) in [0, 1]^2 (u around the major ring, v around the
    tube; y up, lifted by ``config.height``)."""
    uv = _uv_tensor(uv, device)
    u = uv[..., 0] * 2.0 * math.pi
    v = uv[..., 1] * 2.0 * math.pi
    big_r, r = config.major_radius, config.minor_radius
    cos_u, sin_u, cos_v, sin_v = u.cos(), u.sin(), v.cos(), v.sin()
    ring = big_r + r * cos_v
    pos = torch.stack([ring * cos_u, r * sin_v + config.height,
                       ring * sin_u], -1)
    normal = torch.stack([cos_v * cos_u, sin_v, cos_v * sin_u], -1)
    return pos, normal


def torus_rays(uv, config: TorusConfig, device=None) -> Rays:
    """Outward rays from (N, 2) uv samples: direction the surface normal,
    origin the surface point nudged ``origin_offset`` along it."""
    pos, normal = torus_point_normal(uv, config, device)
    return Rays(origins=pos + normal * config.origin_offset,
                directions=normal)


def torus_mesh(config: TorusConfig):
    """Triangle mesh of the torus for visualization and export, as numpy:
    (vertices (V, 3), normals (V, 3), faces (F, 3) int32)."""
    nu, nv = config.major_segments, config.minor_segments
    uu, vv = np.meshgrid(np.arange(nu) / nu, np.arange(nv) / nv,
                         indexing="ij")
    uv = np.stack([uu, vv], -1).reshape(-1, 2)
    pos, nrm = torus_point_normal(uv, config, device="cpu")
    i, j = (x.reshape(-1) for x in np.meshgrid(np.arange(nu), np.arange(nv),
                                               indexing="ij"))
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                     1).reshape(-1, 3)
    return pos.numpy(), nrm.numpy(), faces.astype(np.int32)
