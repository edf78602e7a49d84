"""Dense ray-Gaussian trace and shadow visibility: kernel wrappers and
plain versions.

Counterpart of the (R, N) stages of
``pathtracer_gaussiansplatting_tpu/render/reference.py``: ``dense_topk``
(its ``dense_topk``: every Gaussian against every ray, the K nearest
contributors kept) and ``dense_visibility`` (its ``visibility_dense`` with
the active mask of ``render/pipeline.py:_dense_vis``). Both evaluate the
Gaussians from one (N, 13) table, :func:`gaussian_table`.

For CUDA tensors they launch the CUDA kernels ``csrc/dense_topk.cu``
(counted in ``TOPK_LAUNCHES``) and ``csrc/dense_visibility.cu`` (counted in
``VIS_LAUNCHES``); for CPU tensors they run ``dense_topk_plain`` and
``dense_visibility_plain``. There is no fallback from the card to the
plain versions: a CUDA input either launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels.tile_composite import (
    _kernel_fn, _on_cpu,
)
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops

TABLE_COLS = 13  # mean (3), M = diag(1/s) R^T row-major (9), opacity (1)
MAX_K = 128      # the largest list the top-K kernel keeps per ray

TOPK_LAUNCHES = 0  # dense_topk kernel launches; read by chip_smoke.py
VIS_LAUNCHES = 0   # dense_visibility kernel launches; read by chip_smoke.py
PLAIN_CHUNK_ELEMS = 1 << 24  # (rays, N) pairs per plain-version chunk


def gaussian_table(scene: GaussianScene) -> torch.Tensor:
    """The (N, 13) float32 table both kernels read: mean, the canonical
    transform M = diag(1/s) R^T row-major, opacity."""
    m = gops.canonical_transforms(scene.log_scales, scene.quats)
    return torch.cat([scene.means, m.reshape(-1, 9),
                      scene.opacities[:, None]], dim=-1).contiguous()


def _unpack(table: torch.Tensor):
    """(mean (1, N, 3), M (1, N, 3, 3), opacity (1, N)) of the table."""
    return (table[None, :, 0:3], table[None, :, 3:12].reshape(1, -1, 3, 3),
            table[None, :, 12])


def _ray_chunks(n_rays: int, n_gauss: int):
    step = max(1, PLAIN_CHUNK_ELEMS // max(n_gauss, 1))
    return [(s, min(s + step, n_rays)) for s in range(0, n_rays, step)]


def _gval_cut(settings: RenderSettings) -> float:
    return math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)


def dense_topk_plain(origins: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, k: int, settings: RenderSettings,
                     sort_depths: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the top-K trace, in chunks of about
    ``PLAIN_CHUNK_ELEMS`` (ray, Gaussian) pairs; a chunk's rays are
    independent, so chunking changes no bit.

    Returns idx (R, K) int32, t (R, K) and alpha (R, K) float32 in
    ascending key order (t, or ``sort_depths``), equal keys in index
    order; slots past the contributors hold idx 0, t = t_max, alpha 0, as
    do all slots of a ray that ``active`` masks out.
    """
    mean, m, opac = _unpack(table)
    parts = []
    for s, e in _ray_chunks(origins.shape[0], table.shape[0]):
        t, gval = gops.peak_response(origins[s:e, None], dirs[s:e, None],
                                     mean, m, settings.t_min, settings.t_max)
        alpha = gops.alpha_from_response(opac, gval, settings.alpha_min,
                                         settings.alpha_max,
                                         settings.sigma_cut)
        key = t if sort_depths is None else sort_depths[None].expand_as(t)
        key = torch.where(alpha > 0.0, key, math.inf)
        # A stable sort keeps equal keys in index order, as lax.top_k does
        # (torch.topk makes no such promise).
        skey, order = torch.sort(key, dim=1, stable=True)
        skey, order = skey[:, :k], order[:, :k]
        valid = torch.isfinite(skey)
        if active is not None:
            valid = valid & active[s:e, None]
        parts.append((
            torch.where(valid, order, 0).to(torch.int32),
            torch.where(valid, torch.gather(t, 1, order), settings.t_max),
            torch.where(valid, torch.gather(alpha, 1, order), 0.0)))
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def dense_visibility_plain(origins: torch.Tensor, dirs: torch.Tensor,
                           t_end: torch.Tensor, table: torch.Tensor,
                           settings: RenderSettings,
                           active: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the shadow visibility: (R,)
    prod_i (1 - alpha_i) over the segments [t_min, t_end], 1 where
    ``active`` masks the ray out; in chunks of rays as
    :func:`dense_topk_plain`."""
    mean, m, opac = _unpack(table)
    parts = []
    for s, e in _ray_chunks(origins.shape[0], table.shape[0]):
        alpha = gops.segment_transmittance_alpha(
            origins[s:e, None], dirs[s:e, None], mean, m, opac,
            settings.t_min, t_end[s:e, None], settings.alpha_min,
            settings.alpha_max)
        parts.append(torch.prod(1.0 - alpha, dim=-1))
    vis = torch.cat(parts, dim=0)
    if active is not None:
        vis = torch.where(active, vis, 1.0)
    return vis


def _check(name: str, tensors: dict, expect: dict) -> None:
    for key, x in tensors.items():
        dtype = torch.bool if key == "active" else torch.float32
        if tuple(x.shape) != expect[key] or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} tensor of shape "
                f"{expect[key]}, got {x.dtype} {tuple(x.shape)} "
                f"contiguous={x.is_contiguous()}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


_TOPK_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_VIS_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def dense_topk(origins: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
               k: int, settings: RenderSettings,
               sort_depths: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None):
    """The K nearest contributing Gaussians of every ray (see
    :func:`dense_topk_plain` for the outputs). CPU tensors run the plain
    version; CUDA tensors launch ``csrc/dense_topk.cu``, bit-equal to it.

    Args: origins, dirs (R, 3); table (N, 13) from :func:`gaussian_table`;
    1 <= k <= min(N, 128); sort_depths (N,) to order by in place of t;
    active (R,) bool.
    """
    global TOPK_LAUNCHES
    tensors = dict(origins=origins, dirs=dirs, table=table)
    if sort_depths is not None:
        tensors["sort_depths"] = sort_depths
    if active is not None:
        tensors["active"] = active
    if _on_cpu("dense_topk", tensors):
        return dense_topk_plain(origins, dirs, table, k, settings,
                                sort_depths, active)
    r, n = origins.shape[0], table.shape[0]
    _check("dense_topk", tensors, dict(
        origins=(r, 3), dirs=(r, 3), table=(n, TABLE_COLS),
        sort_depths=(n,), active=(r,)))
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"dense_topk: K={k} must lie in [1, min(N={n}, "
                         f"{MAX_K})]")
    dev = origins.device
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    t = torch.empty((r, k), dtype=torch.float32, device=dev)
    alpha = torch.empty((r, k), dtype=torch.float32, device=dev)
    if r == 0:
        return idx, t, alpha
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn("ptgs_dense_topk", _TOPK_ARGTYPES)(
            origins.data_ptr(), dirs.data_ptr(), table.data_ptr(),
            _ptr(sort_depths), _ptr(active), idx.data_ptr(), t.data_ptr(),
            alpha.data_ptr(), r, n, k, settings.t_min, settings.t_max,
            settings.alpha_min, settings.alpha_max, _gval_cut(settings),
            stream)
    if err != 0:
        raise RuntimeError(f"dense_topk: kernel launch failed with CUDA "
                           f"error {err}")
    TOPK_LAUNCHES += 1
    return idx, t, alpha


def dense_visibility(origins: torch.Tensor, dirs: torch.Tensor,
                     t_end: torch.Tensor, table: torch.Tensor,
                     settings: RenderSettings,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shadow visibility (R,) of the segments [t_min, t_end] (see
    :func:`dense_visibility_plain`). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/dense_visibility.cu``."""
    global VIS_LAUNCHES
    tensors = dict(origins=origins, dirs=dirs, t_end=t_end, table=table)
    if active is not None:
        tensors["active"] = active
    if _on_cpu("dense_visibility", tensors):
        return dense_visibility_plain(origins, dirs, t_end, table, settings,
                                      active)
    r, n = origins.shape[0], table.shape[0]
    _check("dense_visibility", tensors, dict(
        origins=(r, 3), dirs=(r, 3), t_end=(r,), table=(n, TABLE_COLS),
        active=(r,)))
    vis = torch.empty((r,), dtype=torch.float32, device=origins.device)
    if r == 0 or n == 0:
        return vis.fill_(1.0)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = _kernel_fn("ptgs_dense_visibility", _VIS_ARGTYPES)(
            origins.data_ptr(), dirs.data_ptr(), t_end.data_ptr(),
            table.data_ptr(), _ptr(active), vis.data_ptr(), r, n,
            settings.t_min, settings.alpha_min, settings.alpha_max, stream)
    if err != 0:
        raise RuntimeError(f"dense_visibility: kernel launch failed with "
                           f"CUDA error {err}")
    VIS_LAUNCHES += 1
    return vis
