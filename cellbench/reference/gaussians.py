"""Ray-Gaussian interaction math, broadcast over leading dims (a frozen copy
of the port's plain module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/gaussians.py``
(``canonical_transforms``, ``ray_quadratic``, ``peak_response``,
``segment_transmittance_alpha``, ``gaussian_normal``, ``surfel_normal``,
``alpha_from_response``).

The quadratic is written as explicit elementwise multiply and add chains,
not as a matmul or einsum: the dense-trace kernels
(``csrc/dense_topk.cu``, ``csrc/dense_visibility.cu``) repeat these
operations in this order, rounded op by op, so that alpha comes out
bit-equal. One ulp at the sigma_cut or alpha_min step would otherwise
change which Gaussians a ray keeps.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .quaternions import (
    quat_to_rotmat, rotmat_cols,
)
from .safe_math import (
    safe_normalize,
)


def canonical_transforms(log_scales: torch.Tensor,
                         quats: torch.Tensor) -> torch.Tensor:
    """M = diag(1/s) R^T, (..., 3, 3): world -> canonical Gaussian frame."""
    inv_s = torch.exp(-log_scales)
    r = quat_to_rotmat(quats)
    return inv_s[..., :, None] * r.transpose(-1, -2)


def _mat_vec(m: torch.Tensor, v0, v1, v2):
    """The three rows of M v for M (..., 3, 3), each one chain
    (m_i0 v0 + m_i1 v1) + m_i2 v2."""
    return tuple(m[..., i, 0] * v0 + m[..., i, 1] * v1 + m[..., i, 2] * v2
                 for i in range(3))


def ray_quadratic(o: torch.Tensor, d: torch.Tensor, mean: torch.Tensor,
                  m: torch.Tensor):
    """Coefficients (a, b, c) of ||M(o + t d - mu)||^2 = a t^2 + 2 b t + c,
    for o, d, mean (..., 3) and m (..., 3, 3) broadcast together."""
    og = _mat_vec(m, o[..., 0] - mean[..., 0], o[..., 1] - mean[..., 1],
                  o[..., 2] - mean[..., 2])
    dg = _mat_vec(m, d[..., 0], d[..., 1], d[..., 2])
    a = dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
    b = og[0] * dg[0] + og[1] * dg[1] + og[2] * dg[2]
    c = og[0] * og[0] + og[1] * og[1] + og[2] * og[2]
    return a, b, c


def _response(a, b, c, t):
    """exp(-q(t) / 2) with q = a t^2 + 2 b t + c, clamped at q >= 0."""
    q = a * t * t + 2.0 * b * t + c
    return torch.exp(-0.5 * torch.clamp_min(q, 0.0))


def peak_response(o, d, mean, m, t_min: float = 1e-3, t_max: float = 1e4):
    """(t_peak, gval): the argmax of the response along the ray, clamped
    into [t_min, t_max], and exp(-q(t_peak) / 2) in (0, 1]."""
    a, b, c = ray_quadratic(o, d, mean, m)
    a = torch.clamp_min(a, 1e-12)
    t_peak = torch.clamp(-b / a, t_min, t_max)
    return t_peak, _response(a, b, c, t_peak)


def segment_transmittance_alpha(o, d, mean, m, opacity, t_start, t_end,
                                alpha_min: float = 1.0 / 255.0,
                                alpha_max: float = 0.999):
    """Alpha of each Gaussian on the segment [t_start, t_end] (shadow
    rays): the response at the peak clamped into the segment, with the
    alpha_min cutoff and alpha_max clamp but no sigma_cut. ``t_end`` may
    be a tensor broadcast against the Gaussians."""
    a, b, c = ray_quadratic(o, d, mean, m)
    a = torch.clamp_min(a, 1e-12)
    t = torch.clamp_min(-b / a, t_start)
    t = torch.minimum(t, t_end) if isinstance(t_end, torch.Tensor) \
        else torch.clamp_max(t, t_end)
    alpha = opacity * _response(a, b, c, t)
    return torch.where(alpha < alpha_min, torch.zeros_like(alpha),
                       torch.clamp_max(alpha, alpha_max))


def gaussian_normal(x, mean, m, view_dir=None, eps: float = 1e-8):
    """Outward normal -(M^T M)(x - mu), normalized, of the Gaussian's
    isodensity surface at x; flipped to face the viewer when ``view_dir``
    (the ray direction) is given."""
    y = torch.einsum("...ij,...j->...i", m, x - mean)
    n = safe_normalize(-torch.einsum("...ji,...j->...i", m, y), eps=eps)
    if view_dir is not None:
        flip = torch.sign(torch.sum(n * view_dir, dim=-1, keepdim=True))
        n = torch.where(flip > 0, -n, n)
    return n


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
