"""The numbers that judge rendered pixels against the reference's."""
from __future__ import annotations

import torch


TRIM = 0.01   # the share of pixels, worst first, that rel_l1_trim leaves out


def image_numbers(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """Rendered pixels (S, 3) against the reference's.

    rel_l1_trim: the L1 gap over the reference's L1, leaving out the 1% of
    pixels with the largest gaps (a path that flips between a hit and a
    miss of a thin surfel at a later bounce can reach the emitter, or the
    firefly clamp, in one implementation and not the other: a handful of
    such pixels set the untrimmed sum). bad_pixel_share: the share of
    pixels off by more than 0.05 plus 5% of the reference in a channel.
    rel_l1 and top_share (the untrimmed gap and the share of it in the
    trimmed pixels) are the look behind the trim, not compared.
    """
    prog, ref = prog.reshape(-1, 3), ref.reshape(-1, 3)
    gap = (prog - ref).abs().sum(-1)
    size = ref.abs().sum(-1)
    cut = max(1, int(round(TRIM * gap.shape[0])))
    order = torch.argsort(gap, descending=True)
    rest = order[cut:]
    bad = ((prog - ref).abs() > 0.05 + 0.05 * ref.abs()).any(-1)
    total = float(gap.sum())
    return dict(
        rel_l1_trim=float(gap[rest].sum() / size[rest].sum().clamp_min(
            1e-12)),
        bad_pixel_share=float(bad.float().mean()),
        rel_l1=total / max(float(size.sum()), 1e-12),
        top_share=float(gap[order[:cut]].sum()) / max(total, 1e-30))

