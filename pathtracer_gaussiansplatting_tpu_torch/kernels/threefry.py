"""Threefry uniforms kernel wrapper: ``csrc/threefry.cu`` (K5) on the card.

Counterpart of ``jax.random.uniform`` as the reference calls it in
``pathtracer_gaussiansplatting_tpu/core/rng.py:44-56`` (plain XLA there,
not Pallas). :func:`threefry_uniforms` launches ``ptgs_threefry_uniforms``
once for a table of draws, each an (R, num) block of float32 uniforms
under its own key, or for one frame's subpixel jitter (``r2`` given),
counted in ``launch.launches`` under "threefry". The keys are folded on the host and go to the
kernel by value, as a launch parameter. The dispatch, and the plain
version that CPU tensors run, are ``core.rng.bounce_uniforms`` /
``uniforms_plain`` and ``subpixel_jitter`` / ``jitter_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from pathtracer_gaussiansplatting_tpu_torch.kernels import launch

MAX_DIMS = 16  # draws one launch takes (a bounce draws at most 9)


def threefry_uniforms(keys: Sequence[Tuple[int, int]], nums: Sequence[int],
                      r: int, device,
                      r2: Optional[Tuple[float, float]] = None
                      ) -> torch.Tensor:
    """Launch K5 on a CUDA ``device``: the flat float32 buffer of
    r * sum(nums) uniforms, draw j (key words ``keys[j]``, ``nums[j]``
    columns) at r * sum(nums[:j]), row-major (r, nums[j]). With ``r2``
    (the frame's two float32 R2 offsets) the one draw (r, 2) is the
    subpixel jitter, (u + r2) modulo 1. The CPU raises: it runs the plain
    version, ``core.rng.uniforms_plain``."""
    if len(keys) != len(nums) or not 0 < len(keys) <= MAX_DIMS:
        raise ValueError(f"threefry: {len(keys)} keys and {len(nums)} nums; "
                         f"one launch takes 1 to {MAX_DIMS} draws")
    if any(n < 1 for n in nums) or r < 0:
        raise ValueError(f"threefry: nums {list(nums)} and r {r} must be "
                         "positive")
    if r2 is not None and list(nums) != [2]:
        raise ValueError(f"threefry: the jitter is one draw of 2 columns, "
                         f"got nums {list(nums)}")
    out = torch.empty((r * sum(nums),), dtype=torch.float32, device=device)
    if launch.on_cpu("threefry", dict(out=out)):
        raise ValueError("threefry: the CPU runs the plain version, "
                         "core.rng.uniforms_plain")
    if r == 0:
        return out
    words = (ctypes.c_uint32 * (2 * len(keys)))(
        *[w & 0xFFFFFFFF for key in keys for w in key])
    cols = (ctypes.c_int * len(nums))(*nums)
    r2x, r2y = (0.0, 0.0) if r2 is None else r2
    launch.launch("threefry", "ptgs_threefry_uniforms", out.data_ptr(),
                  ctypes.addressof(words), ctypes.addressof(cols), len(keys),
                  r, int(r2 is not None), r2x, r2y, device=out.device,
                  count="threefry")
    return out
