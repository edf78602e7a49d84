"""The tile kernels' operations and bytes on one step, counted from the
step's inputs (the port's ``bench.py`` arithmetic: ``bound``,
``chunk_schedule``, ``tile_pairs``, ``tile_bytes`` and the function's
bound of ``tile_bounds``), and the card's peaks. Whatever kernel does the
work, the count stays the same: 33 flops on each (pixel, slot) pair the
inputs need evaluated, 33 (forward) or 112 (backward) more on each pair
with alpha > 0, each input and output byte once.
"""
from __future__ import annotations

import torch

from cellbench.reference import tiles as ref_tiles

# The H100 SXM's published HBM rate and float32 (non-tensor) peak.
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12
PAIR_EVAL_FLOPS, PAIR_COMPOSITE_FLOPS, BWD_LIVE_PAIR_FLOPS = 33, 33, 112


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def chunk_size(k: int) -> int:
    return 128 if k % 128 == 0 else k


def run_mask(packets, dirs, settings) -> torch.Tensor:
    """(T, K) the slots the kernels must evaluate: under the tile's count,
    in chunks before the first one the plain forward's transmittance at
    its entry (with a 10% margin around transmittance_min) lets them
    skip."""
    count, geom, featsT = packets["count"], packets["geom"], packets["featsT"]
    k = geom.shape[-1]
    kc = chunk_size(k)
    tmin = settings.transmittance_min
    no_skip = count > 0
    skip_from = torch.full_like(count, k // kc, dtype=torch.long)
    for ci in range(1, k // kc):
        s = ci * kc
        tmax = (1.0 - ref_tiles.composite(
            geom[..., :s].contiguous(), featsT[..., :s].contiguous(), dirs,
            settings)[1]).amax(-1)
        live = no_skip & (count > s)
        skip_from[live & (tmax <= 0.9 * tmin)] = ci
        no_skip &= ~(live & ~(tmax > 1.1 * tmin))
    slot = torch.arange(k, device=count.device)
    return (slot[None] < torch.ceil(count).long()[:, None]) \
        & (slot[None] // kc < skip_from[:, None])


def live_pairs(packets, dirs, settings, run) -> int:
    """Evaluated (pixel, slot) pairs with alpha > 0."""
    geom = packets["geom"]
    t_total, p, _ = dirs.shape
    step = max(1, ref_tiles.PLAIN_CHUNK_ELEMS // (p * geom.shape[-1]))
    n = 0
    for s in range(0, t_total, step):
        g = geom[s:s + step]
        _, alpha = ref_tiles._t_alpha(
            *ref_tiles._quadratic_ab(dirs[s:s + step], g), g, settings)
        n += int(((alpha > 0) & run[s:s + step, None]).sum())
    return n


def tile_bytes(packets, dirs, backward: bool = False) -> float:
    """count, dirs, the 11 geometry rows and the features read once, the
    outputs written once; for the backward the cotangent in and the three
    gradients out besides."""
    t_total, p, _ = dirs.shape
    k = packets["geom"].shape[-1]
    f = packets["featsT"].shape[1]
    n = t_total * (1 + p * 3 + 11 * k + f * k) + t_total * p * (f + 2)
    if backward:
        n += t_total * (p * 3 + 16 * k + f * k)
    return 4.0 * n


@torch.no_grad()
def step_bounds(scene, camera, settings, config) -> dict:
    """The forward's and the backward's least seconds on the packets of
    one unjittered frame of ``scene`` from ``camera``."""
    packets = ref_tiles.prepare(scene, camera, settings, config)
    py, px = ref_tiles.tile_pixels(camera, config)
    dirs = ref_tiles.pixel_dirs(camera, py, px)
    run = run_mask(packets, dirs, settings)
    pairs = int(run.sum()) * dirs.shape[1]
    live = live_pairs(packets, dirs, settings, run)
    return dict(
        fwd_s=bound_s(tile_bytes(packets, dirs),
                      pairs * PAIR_EVAL_FLOPS + live * PAIR_COMPOSITE_FLOPS),
        bwd_s=bound_s(tile_bytes(packets, dirs, backward=True),
                      pairs * PAIR_EVAL_FLOPS + live * BWD_LIVE_PAIR_FLOPS))
