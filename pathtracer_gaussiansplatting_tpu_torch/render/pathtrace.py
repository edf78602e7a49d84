"""Path tracing driver (so far only progressive accumulation).

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/pathtrace.py``;
this slice ports ``accumulate``. The bounce loop and ``pathtrace_camera``
come with the path-tracing slice.
"""
from __future__ import annotations

import torch


def accumulate(prev: torch.Tensor, cur: torch.Tensor,
               frame: int) -> torch.Tensor:
    """Progressive accumulation mix(prev, cur, 1 / (frame + 1)); ``frame``
    counts completed samples. The blend is computed in float32, as the
    reference does."""
    blend = 1.0 / (torch.tensor(float(frame), dtype=torch.float32) + 1.0)
    return prev + (cur - prev) * blend  # a 0-dim host tensor joins any device
