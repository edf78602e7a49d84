"""The device the port's constructors build on.

The port's entry points run on the CUDA card unless the caller asks for
another device: ``device=None`` means ``cuda``, and on a machine without
CUDA it raises rather than carrying on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Raises RuntimeError for None when CUDA is not available: pass
    ``device="cpu"`` to build on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given: the port "
            "builds on the CUDA card by default; pass device=\"cpu\" to build "
            "on the CPU")
    return torch.device("cuda")
