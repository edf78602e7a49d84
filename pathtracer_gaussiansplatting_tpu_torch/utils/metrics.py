"""Image quality metrics: MSE, PSNR and SSIM (differentiable torch).

Counterpart of ``pathtracer_gaussiansplatting_tpu/utils/metrics.py``: the
same definitions (SSIM with an 11-tap Gaussian window of sigma 1.5 and
edge padding, as used by 3DGS evaluation).
"""
from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over [0, max_val] images."""
    m = mse(a, b)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(m, 1e-12))


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over (H, W, C) images (Wang et al. 2004, Gaussian
    window)."""
    a = a.float()
    b = b.float()
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel1d(kernel_size, sigma, a.device)
    pad = kernel_size // 2
    taps = torch.arange(kernel_size, device=a.device)[None] - pad

    def blur(img):
        # Separable Gaussian over H, then W; clamped indices = edge padding.
        h, w = img.shape[:2]
        ih = torch.clamp(torch.arange(h, device=img.device)[:, None] + taps,
                         0, h - 1)
        xh = torch.einsum("k,hkwc->hwc", k, img[ih])
        iw = torch.clamp(torch.arange(w, device=img.device)[:, None] + taps,
                         0, w - 1)
        return torch.einsum("k,hwkc->hwc", k, xh[:, iw])

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
