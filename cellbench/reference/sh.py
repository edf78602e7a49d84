"""Real spherical harmonics (degrees 0..3), 3DGS convention (a frozen copy of
the port's plain module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/core/sh.py``
(``SH_C0``, ``sh_basis``, ``eval_sh``).
"""
from __future__ import annotations

from typing import Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis for unit directions (..., 3) -> (..., (degree+1)^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(sh_coeffs: torch.Tensor, dirs: torch.Tensor,
            degree: Optional[int] = None) -> torch.Tensor:
    """SH color (..., 3) of coefficients (..., K, 3) in directions (..., 3).

    Offset by +0.5 and clamped at 0 (3DGS convention); ``degree`` defaults
    to the one K implies.
    """
    k = sh_coeffs.shape[-2]
    if degree is None:
        degree = int(round(k ** 0.5)) - 1
    kb = (degree + 1) ** 2
    basis = sh_basis(dirs, degree)
    color = torch.einsum("...kc,...k->...c", sh_coeffs[..., :kb, :], basis)
    return torch.clamp_min(color + 0.5, 0.0)
