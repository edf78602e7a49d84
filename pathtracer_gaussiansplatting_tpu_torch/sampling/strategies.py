"""Torus-sensor ray samples: the reference engine's 7 strategies.

A copy of ``pathtracer_gaussiansplatting_tpu/sampling/strategies.py``
(numpy only; importing it would run the JAX package's ``__init__``, which
imports jax). Each strategy gives (num_rays, 2) uv samples in [0,1]^2 over
the torus surface, Morton-sorted for coherent traversal, from the fixed
seed 13. The two importance strategies take the previous pass's per-ray
colors or hit flags (the capture's one device -> host -> device loop).
The same inputs give the same bits as the JAX package.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from pathtracer_gaussiansplatting_tpu_torch.ops.morton import morton_sort_2d

SEED = 13  # sampling.cpp:3


class SamplingMethod(enum.Enum):
    """Mirrors the reference's SamplingMethod enum (GeneralHeaders.h)."""

    RANDOM = "random"
    UNIFORM = "uniform"
    STRATIFIED = "stratified"
    LHS = "lhs"
    HALTON = "halton"
    IMP_COL = "imp_col"
    IMP_HIT = "imp_hit"


def _grid_dims(num_rays: int):
    cols = int(np.ceil(np.sqrt(num_rays)))
    rows = int(np.ceil(num_rays / cols))
    return cols, rows


def random_samples(num_rays: int, seed: int = SEED) -> np.ndarray:
    rng = np.random.RandomState(seed)  # MT19937, like std::mt19937(13)
    uv = rng.uniform(0.0, 1.0, (num_rays, 2)).astype(np.float32)
    return morton_sort_2d(uv)


def uniform_samples(num_rays: int) -> np.ndarray:
    """Grid cell centers (sampling.cpp generateUniformSamples)."""
    cols, rows = _grid_dims(num_rays)
    i = np.arange(num_rays)
    u = ((i % cols) + 0.5) / cols
    v = ((i // cols) + 0.5) / rows
    return morton_sort_2d(np.stack([u, v], -1).astype(np.float32))


def stratified_samples(num_rays: int, seed: int = SEED) -> np.ndarray:
    """Jittered grid (sampling.cpp generateStratifiedSamples)."""
    cols, rows = _grid_dims(num_rays)
    rng = np.random.RandomState(seed)
    i = np.arange(num_rays)
    u = ((i % cols) + rng.uniform(size=num_rays)) / cols
    v = ((i // cols) + rng.uniform(size=num_rays)) / rows
    return morton_sort_2d(np.stack([u, v], -1).astype(np.float32))


def lhs_samples(num_rays: int, seed: int = SEED) -> np.ndarray:
    """Latin hypercube: independent axis shuffles + jitter
    (sampling.cpp generateLatinHypercubeSamples)."""
    rng = np.random.RandomState(seed)
    ui = rng.permutation(num_rays)
    vi = rng.permutation(num_rays)
    u = (ui + rng.uniform(size=num_rays)) / num_rays
    v = (vi + rng.uniform(size=num_rays)) / num_rays
    return morton_sort_2d(np.stack([u, v], -1).astype(np.float32))


def _halton_1d(indices: np.ndarray, base: int) -> np.ndarray:
    """Vectorized radical inverse (sampling.cpp:halton)."""
    result = np.zeros(indices.shape, np.float64)
    f = 1.0
    i = indices.astype(np.int64).copy()
    while i.max() > 0:
        f /= base
        result += f * (i % base)
        i //= base
    return result


def halton_samples(num_rays: int) -> np.ndarray:
    idx = np.arange(1, num_rays + 1)
    uv = np.stack([_halton_1d(idx, 2), _halton_1d(idx, 3)], -1)
    return morton_sort_2d(uv.astype(np.float32))


def _cdf_inverse_samples(importance: np.ndarray, grid_res: int,
                         num_rays: int, rng) -> np.ndarray:
    """Shared CDF inverse-transform + in-cell jitter (sampling.cpp:120-157)."""
    total = importance.sum()
    cdf = np.cumsum(importance) / max(total, 1e-12)
    r = rng.uniform(size=num_rays)
    idx = np.searchsorted(cdf, r, side="left")
    idx = np.clip(idx, 0, grid_res * grid_res - 1)
    x = idx % grid_res
    y = idx // grid_res
    u = (x + rng.uniform(size=num_rays)) / grid_res
    v = (y + rng.uniform(size=num_rays)) / grid_res
    return np.stack([u, v], -1).astype(np.float32)


def _bin_to_grid(prev_uv: np.ndarray, values: np.ndarray, grid_res: int):
    """Accumulate per-sample values into a grid; returns (sum, count)."""
    x = np.clip((prev_uv[:, 0] * grid_res).astype(np.int64), 0, grid_res - 1)
    y = np.clip((prev_uv[:, 1] * grid_res).astype(np.int64), 0, grid_res - 1)
    idx = y * grid_res + x
    shape = (grid_res * grid_res,) + values.shape[1:]
    sums = np.zeros(shape, np.float64)
    np.add.at(sums, idx, values)
    counts = np.zeros(grid_res * grid_res, np.float64)
    np.add.at(counts, idx, 1.0)
    return sums, counts


def importance_color_samples(num_rays: int, prev_uv: np.ndarray,
                             prev_colors: np.ndarray, grid_res: int = 256,
                             seed: int = SEED) -> np.ndarray:
    """Luminance-gradient importance (sampling.cpp generateImportanceSamples):
    bin previous colors into a grid, central-difference gradient magnitude of
    luminance + 0.05 epsilon, CDF inverse-transform."""
    sums, counts = _bin_to_grid(prev_uv, prev_colors[:, :3], grid_res)
    avg = np.where(counts[:, None] > 0, sums / np.maximum(counts[:, None], 1),
                   0.0).reshape(grid_res, grid_res, 3)
    lum = avg @ np.array([0.2126, 0.7152, 0.0722])
    padded = np.pad(lum, 1, mode="constant")
    dx = padded[1:-1, 2:] - padded[1:-1, :-2]
    dy = padded[2:, 1:-1] - padded[:-2, 1:-1]
    weight = np.sqrt(dx * dx + dy * dy) + 0.05
    rng = np.random.RandomState(seed)
    uv = _cdf_inverse_samples(weight.reshape(-1), grid_res, num_rays, rng)
    return morton_sort_2d(uv)


def importance_hit_samples(num_rays: int, prev_uv: np.ndarray,
                           prev_flags: np.ndarray, grid_res: int = 256,
                           seed: int = SEED) -> np.ndarray:
    """Hit-ratio importance (sampling.cpp generateHitBasedImportanceSamples):
    per-cell hit fraction + 0.01 epsilon -> CDF."""
    hits = (np.asarray(prev_flags) > 0.0).astype(np.float64)
    sums, counts = _bin_to_grid(prev_uv, hits[:, None], grid_res)
    ratio = np.where(counts > 0, sums[:, 0] / np.maximum(counts, 1), 0.0)
    weight = ratio + 0.01
    rng = np.random.RandomState(seed)
    uv = _cdf_inverse_samples(weight, grid_res, num_rays, rng)
    return morton_sort_2d(uv)


def generate_samples(method: SamplingMethod, num_rays: int,
                     prev_uv: Optional[np.ndarray] = None,
                     prev_colors: Optional[np.ndarray] = None,
                     prev_flags: Optional[np.ndarray] = None,
                     grid_res: int = 256, seed: int = SEED) -> np.ndarray:
    """Strategy dispatcher (sampling.cpp:366-434 updateSampling)."""
    method = SamplingMethod(method)
    if method == SamplingMethod.RANDOM:
        return random_samples(num_rays, seed)
    if method == SamplingMethod.UNIFORM:
        return uniform_samples(num_rays)
    if method == SamplingMethod.STRATIFIED:
        return stratified_samples(num_rays, seed)
    if method == SamplingMethod.LHS:
        return lhs_samples(num_rays, seed)
    if method == SamplingMethod.HALTON:
        return halton_samples(num_rays)
    if method == SamplingMethod.IMP_COL:
        if prev_uv is None or prev_colors is None:
            return random_samples(num_rays, seed)
        return importance_color_samples(num_rays, prev_uv, prev_colors,
                                        grid_res, seed)
    if method == SamplingMethod.IMP_HIT:
        if prev_uv is None or prev_flags is None:
            return random_samples(num_rays, seed)
        return importance_hit_samples(num_rays, prev_uv, prev_flags,
                                      grid_res, seed)
    raise ValueError(f"unknown sampling method {method}")
