"""Host-side grid binning: ctypes wrappers of ``csrc/grid_bin.cpp`` and
their plain numpy versions.

Counterpart of ``grid_bin_aniso`` and ``chebyshev_dist`` in
``pathtracer_gaussiansplatting_tpu/csrc/build.py``, whose numpy fallbacks
are copied here as ``grid_bin_aniso_plain`` and ``chebyshev_dist_plain``
(the test oracles). The wrappers always run the C++ library (built with
g++ at first use, ``csrc/build.py:build_host``): a failed build raises, and
nothing drops to numpy, whose Python loop takes minutes at 500k Gaussians.
"""
from __future__ import annotations

import ctypes

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build

    lib = build.load_host()
    i32 = ctypes.c_int32
    lib.ptgs_grid_bin_aniso.argtypes = [_F32P, _F32P, _F32P, ctypes.c_int64,
                                        _F32P, _F32P, i32, i32, i32, i32,
                                        _I32P, _I32P]
    lib.ptgs_grid_bin_aniso.restype = None
    lib.ptgs_chebyshev_dist.argtypes = [_U8P, i32, i32, i32, i32, _U8P]
    lib.ptgs_chebyshev_dist.restype = None
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def grid_bin_aniso(centers, extents, priority, grid_dims, lo, hi,
                   max_per_cell: int = 16):
    """Bin axis-aligned boxes (center +- per-axis extent) into a grid.

    When a cell overflows ``max_per_cell``, the lowest-``priority`` entry
    is evicted (keep the strongest contributors). Returns
    (cell_indices (gz*gy*gx, max_per_cell) int32 padded with -1,
     cell_counts (gz*gy*gx,) int32 untruncated).
    """
    centers, extents, priority = _f32(centers), _f32(extents), _f32(priority)
    lo, hi = _f32(lo), _f32(hi)
    gx, gy, gz = (int(d) for d in grid_dims)
    idx = np.empty((gx * gy * gz, max_per_cell), np.int32)
    cnt = np.empty(gx * gy * gz, np.int32)
    _lib().ptgs_grid_bin_aniso(
        _fptr(centers), _fptr(extents), _fptr(priority), len(centers),
        _fptr(lo), _fptr(hi), gx, gy, gz, max_per_cell,
        idx.ctypes.data_as(_I32P), cnt.ctypes.data_as(_I32P))
    return idx, cnt


def grid_bin_aniso_plain(centers, extents, priority, grid_dims, lo, hi,
                         max_per_cell: int = 16):
    """Plain numpy version of :func:`grid_bin_aniso` (the reference's
    fallback, one Python loop over the Gaussians)."""
    centers, extents, priority = _f32(centers), _f32(extents), _f32(priority)
    lo, hi = _f32(lo), _f32(hi)
    gx, gy, gz = (int(d) for d in grid_dims)
    n_cells = gx * gy * gz
    ext = np.maximum(hi - lo, 1e-12)
    dims = np.array([gx, gy, gz])
    c0 = np.clip(np.floor((centers - extents - lo) / ext * dims),
                 0, dims - 1).astype(np.int64)
    c1 = np.clip(np.floor((centers + extents - lo) / ext * dims),
                 0, dims - 1).astype(np.int64)
    idx = np.full((n_cells, max_per_cell), -1, np.int32)
    prio = np.zeros((n_cells, max_per_cell), np.float32)
    cnt = np.zeros(n_cells, np.int32)
    for i in range(len(centers)):
        for z in range(c0[i, 2], c1[i, 2] + 1):
            for y in range(c0[i, 1], c1[i, 1] + 1):
                for x in range(c0[i, 0], c1[i, 0] + 1):
                    cell = (z * gy + y) * gx + x
                    c = cnt[cell]
                    cnt[cell] = c + 1
                    if c < max_per_cell:
                        idx[cell, c] = i
                        prio[cell, c] = priority[i]
                    else:
                        s = int(np.argmin(prio[cell]))
                        if priority[i] > prio[cell, s]:
                            idx[cell, s] = i
                            prio[cell, s] = priority[i]
    return idx, cnt


def chebyshev_dist(occupied, grid_dims, cap: int = 32) -> np.ndarray:
    """Exact chessboard distance to the nearest occupied cell (<= cap).

    occupied: (gz*gy*gx,) bool/uint8 in z-major linear order. Returns
    (gz*gy*gx,) uint8, 0 at occupied cells.
    """
    gx, gy, gz = (int(d) for d in grid_dims)
    occ = np.ascontiguousarray(
        np.asarray(occupied, np.uint8).reshape(gz * gy * gx))
    out = np.empty(gz * gy * gx, np.uint8)
    _lib().ptgs_chebyshev_dist(occ.ctypes.data_as(_U8P), gx, gy, gz, cap,
                               out.ctypes.data_as(_U8P))
    return out


def chebyshev_dist_plain(occupied, grid_dims, cap: int = 32) -> np.ndarray:
    """Plain numpy version of :func:`chebyshev_dist`: iterative 26-neighbor
    dilation, cap passes."""
    gx, gy, gz = (int(d) for d in grid_dims)
    occ3 = np.asarray(occupied, np.uint8).reshape(gz, gy, gx).astype(bool)
    dist = np.where(occ3, 0, cap).astype(np.int32)
    frontier = occ3
    for step in range(1, cap):
        if not frontier.any():
            break
        grown = np.zeros_like(frontier)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    sl = grown[max(dz, 0) or None:gz + min(dz, 0) or None,
                               max(dy, 0) or None:gy + min(dy, 0) or None,
                               max(dx, 0) or None:gx + min(dx, 0) or None]
                    src = frontier[max(-dz, 0) or None:
                                   gz + min(-dz, 0) or None,
                                   max(-dy, 0) or None:
                                   gy + min(-dy, 0) or None,
                                   max(-dx, 0) or None:
                                   gx + min(-dx, 0) or None]
                    np.logical_or(sl, src, out=sl)
        newly = grown & (dist > step)
        dist[newly] = step
        frontier = grown
    return dist.astype(np.uint8).reshape(-1)
