"""Morton (Z-order) codes, 2D and 3D, in numpy.

A copy of the numpy parts of ``pathtracer_gaussiansplatting_tpu/ops/
morton.py`` (``morton2d``, ``morton3d``, ``morton_sort_2d``,
``morton_order_points``), which ``sampling/strategies.py`` needs: the
ray-coherence sort of the torus (u, v) samples, 15 bits an axis in 2D and
10 in 3D. Importing the JAX module would run the JAX package's
``__init__``, which imports jax.
"""
from __future__ import annotations

import numpy as np


def _expand_bits_2d(x):
    x = np.asarray(x, dtype=np.uint32)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def morton2d(u, v):
    """30-bit Morton code of (u, v) in [0,1]^2, 15 bits an axis."""
    x = np.clip(np.asarray(u) * 32768.0, 0.0, 32767.0).astype(np.uint32)
    y = np.clip(np.asarray(v) * 32768.0, 0.0, 32767.0).astype(np.uint32)
    return _expand_bits_2d(x) | (_expand_bits_2d(y) << 1)


def _expand_bits_3d(x):
    x = np.asarray(x, dtype=np.uint32)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def morton3d(x, y, z):
    """30-bit Morton code of (x, y, z) in [0,1]^3, 10 bits an axis."""
    xi = np.clip(np.asarray(x) * 1024.0, 0.0, 1023.0).astype(np.uint32)
    yi = np.clip(np.asarray(y) * 1024.0, 0.0, 1023.0).astype(np.uint32)
    zi = np.clip(np.asarray(z) * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (_expand_bits_3d(xi) | (_expand_bits_3d(yi) << 1)
            | (_expand_bits_3d(zi) << 2))


def morton_sort_2d(uv):
    """(N, 2) uv samples sorted by Morton code (stable)."""
    uv = np.asarray(uv)
    codes = morton2d(uv[:, 0], uv[:, 1])
    return uv[np.argsort(codes, kind="stable")]


def morton_order_points(points, lo=None, hi=None):
    """Permutation ordering 3D points by Morton code within their AABB."""
    points = np.asarray(points)
    lo = points.min(0) if lo is None else np.asarray(lo)
    hi = points.max(0) if hi is None else np.asarray(hi)
    ext = np.maximum(hi - lo, 1e-12)
    q = (points - lo) / ext
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    return np.argsort(codes, kind="stable")
