"""Vector helpers that stay finite at 0 (a frozen copy of the port's plain
module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/safe_math.py``
(``safe_norm``, ``safe_normalize``, ``safe_sqrt``).
"""
from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(x^2) + eps): finite value and gradient at x = 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-12) -> torch.Tensor:
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt clamped away from 0, where its derivative is infinite."""
    return torch.sqrt(torch.clamp_min(x, eps))
