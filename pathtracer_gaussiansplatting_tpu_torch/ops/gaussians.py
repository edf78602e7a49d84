"""Ray-Gaussian interaction math, broadcast over leading dims.

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/gaussians.py``
(``canonical_transforms``, ``surfel_normal``, ``alpha_from_response``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import (
    quat_to_rotmat, rotmat_cols,
)


def canonical_transforms(log_scales: torch.Tensor,
                         quats: torch.Tensor) -> torch.Tensor:
    """M = diag(1/s) R^T, (..., 3, 3): world -> canonical Gaussian frame."""
    inv_s = torch.exp(-log_scales)
    r = quat_to_rotmat(quats)
    return inv_s[..., :, None] * r.transpose(-1, -2)


def surfel_normal(log_scales: torch.Tensor, quats: torch.Tensor,
                  view_dir: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shortest-principal-axis normal (..., 3) of a Gaussian surfel,
    flipped to face the viewer when ``view_dir`` (ray direction) is given.
    Ties pick the first index, as argmin does."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_cols(quats)
    s0, s1, s2 = log_scales[..., 0], log_scales[..., 1], log_scales[..., 2]
    pick0 = (s0 <= s1) & (s0 <= s2)
    pick1 = (~(s0 <= s1)) & (s1 <= s2)
    nx = torch.where(pick0, r00, torch.where(pick1, r01, r02))
    ny = torch.where(pick0, r10, torch.where(pick1, r11, r12))
    nz = torch.where(pick0, r20, torch.where(pick1, r21, r22))
    n = torch.stack([nx, ny, nz], dim=-1)
    if view_dir is not None:
        flip = torch.sum(n * view_dir, dim=-1, keepdim=True) > 0
        n = torch.where(flip, -n, n)
    return n


def alpha_from_response(opacity: torch.Tensor, gval: torch.Tensor,
                        alpha_min: float = 1.0 / 255.0,
                        alpha_max: float = 0.999,
                        sigma_cut: float = 3.0) -> torch.Tensor:
    """Contribution alpha = opacity * gval with the sigma_cut, alpha_min
    and alpha_max cutoffs."""
    alpha = opacity * gval
    cut = math.exp(-0.5 * sigma_cut * sigma_cut)
    alpha = torch.where(gval < cut, torch.zeros_like(alpha), alpha)
    return torch.where(alpha < alpha_min, torch.zeros_like(alpha),
                       torch.clamp_max(alpha, alpha_max))
