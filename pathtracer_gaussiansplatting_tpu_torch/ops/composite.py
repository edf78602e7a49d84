"""Front-to-back alpha compositing weights with an analytic backward.

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/composite.py``
(``composite_weights`` and its custom VJP, ``composite``,
``transmittance``): the backward is the suffix-sum
form of 3DGS rasterizers, with no O(K^2) graph and no division by a
cumprod that may underflow to zero.
"""
from __future__ import annotations

import torch


def _exclusive_cumprod_one_minus(alphas: torch.Tensor):
    """T_i = prod_{j<i}(1 - alpha_j) and the final transmittance."""
    cp = torch.cumprod(1.0 - alphas, dim=-1)
    trans_in = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    return trans_in, cp[..., -1]


class _CompositeWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alphas):
        trans_in, trans_out = _exclusive_cumprod_one_minus(alphas)
        weights = trans_in * alphas
        ctx.save_for_backward(alphas, trans_in, weights, trans_out)
        return weights, trans_out

    @staticmethod
    def backward(ctx, g_w, g_t):
        alphas, trans_in, weights, trans_out = ctx.saved_tensors
        # dL/dalpha_k = g_k T_k - (sum_{i>k} g_i w_i + g_t T_out) / (1 - alpha_k)
        gw_w = g_w * weights
        suffix = torch.flip(torch.cumsum(torch.flip(gw_w, (-1,)), -1),
                            (-1,)) - gw_w
        denom = torch.clamp_min(1.0 - alphas, 1e-6)
        return g_w * trans_in - (suffix + (g_t * trans_out)[..., None]) / denom


def composite_weights(alphas: torch.Tensor):
    """Weights w_i = T_i * alpha_i, T_i = prod_{j<i}(1 - alpha_j), for
    alphas (..., K) in [0, alpha_max] sorted front to back; also the final
    transmittance (...,)."""
    return _CompositeWeights.apply(alphas)


def composite(alphas: torch.Tensor, feats: torch.Tensor):
    """Composite features (..., K, F) front to back under alphas (..., K):
    (sum_i w_i feats_i (..., F), accumulated opacity, transmittance)."""
    weights, trans = composite_weights(alphas)
    out = torch.einsum("...k,...kf->...f", weights, feats)
    return out, 1.0 - trans, trans


def transmittance(alphas: torch.Tensor) -> torch.Tensor:
    """prod(1 - alpha_i) along the last axis (shadow-ray visibility)."""
    return torch.prod(1.0 - alphas, dim=-1)
