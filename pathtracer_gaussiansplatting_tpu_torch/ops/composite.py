"""Front-to-back alpha compositing weights (forward only).

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/composite.py``
(``composite_weights``). The JAX version carries an analytic custom VJP;
the port's autograd counterpart comes with the training slice.
"""
from __future__ import annotations

import torch


def composite_weights(alphas: torch.Tensor):
    """Weights w_i = T_i * alpha_i, T_i = prod_{j<i}(1 - alpha_j), for
    alphas (..., K) sorted front to back; also the final transmittance."""
    cp = torch.cumprod(1.0 - alphas, dim=-1)
    trans_in = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    return trans_in * alphas, cp[..., -1]
