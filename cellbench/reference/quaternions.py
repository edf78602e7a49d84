"""Quaternion utilities, (w, x, y, z) order, batched over leading dims (a
frozen copy of the port's plain module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/quaternions.py``
(``normalize``, ``quat_to_rotmat``, ``rotmat_cols``, ``rotmat_to_quat``).
"""
from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize quaternions (..., 4)."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True), eps)


def rotmat_cols(q: torch.Tensor):
    """Rotation-matrix entries of (..., 4) quaternions as nine (...,) tensors.

    Returns (r00, r01, r02, r10, r11, r12, r20, r21, r22); the columns of R
    are the rotated basis vectors (same convention as quat_to_rotmat).
    """
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) -> rotation matrices (..., 3, 3).

    Columns are the rotated basis vectors: R @ v takes v from the Gaussian's
    canonical frame to world space.
    """
    r = torch.stack(rotmat_cols(q), dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Inverse of quat_to_rotmat for (..., 3, 3) rotation matrices.

    Branch-free Shepperd-style construction (the reference's formula).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    return normalize(torch.stack([qw, qx, qy, qz], dim=-1))
