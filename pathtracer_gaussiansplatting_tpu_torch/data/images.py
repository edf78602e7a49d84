"""Image output: sRGB encoding, box downscale, JPG/PNG writers.

A copy of ``pathtracer_gaussiansplatting_tpu/data/images.py``
(``linear_to_srgb``, ``srgb_to_linear``, ``box_downscale``, ``save_jpg``,
``save_png``): that module is numpy-only, but importing it runs the JAX
package's ``__init__``, which imports jax. Renders are linear radiance; the writers
apply the sRGB transfer.
"""
from __future__ import annotations

import os

import numpy as np


def linear_to_srgb(x):
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def box_downscale(img, divisor: int):
    """Repeated 2x box filtering until the total divisor is reached."""
    img = np.asarray(img)
    d = int(divisor)
    while d > 1:
        h, w = img.shape[:2]
        h2, w2 = h // 2, w // 2
        img = img[: h2 * 2, : w2 * 2]
        img = img.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        d //= 2
    return img


def to_uint8_srgb(linear_img):
    return (linear_to_srgb(linear_img) * 255.0 + 0.5).astype(np.uint8)


def save_jpg(path, linear_img, quality: int = 92):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8_srgb(linear_img)).save(path, quality=quality)


def save_png(path, linear_img):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8_srgb(linear_img)).save(path)
