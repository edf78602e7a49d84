"""glTF texture stack: decode, mip chain and bilinear taps (host side).

A copy of ``pathtracer_gaussiansplatting_tpu/data/textures.py``
(``srgb_to_linear``, ``decode_image``, ``build_mips``, ``sample_bilinear``,
``apply_texture_transform``, ``TextureSampler``): that module is
numpy-only, but importing it runs the JAX package's ``__init__``, which
imports jax. Every texture channel of a glTF material is sampled once per
surfel at its interpolated UV when the mesh is surfelized
(``data/gltf.py``): color channels (baseColor, emissive, the
specular-glossiness pair) in sRGB, decoded after filtering, data channels
(metal-rough, normal, occlusion, clearcoat) raw; KHR_texture_transform;
the glTF wrap modes; and an optional mip level per surfel from its texel
footprint. The same inputs give the same bits as the JAX package.
"""
from __future__ import annotations

import base64
import io
import math
import os
from typing import List, Optional

import numpy as np

# glTF sampler wrap modes
_CLAMP, _MIRROR, _REPEAT = 33071, 33648, 10497


def srgb_to_linear(c):
    """IEC 61966-2-1 EOTF on [0,1] arrays (reference scans color textures
    as VK_FORMAT_*_SRGB so the GPU applied this in hardware)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def decode_image(gltf: dict, buffers: List[bytes], base_dir: str,
                 image_index: int) -> np.ndarray:
    """Decode one glTF image (bufferView / data URI / file) to (H, W, 4)
    float32 in [0, 1], raw values (no color-space conversion here)."""
    from PIL import Image

    img = gltf["images"][image_index]
    if "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        data = buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        raw = data[off:off + view["byteLength"]]
    else:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                raw = f.read()
    pil = Image.open(io.BytesIO(raw)).convert("RGBA")
    return np.asarray(pil, np.float32) / 255.0


def build_mips(img: np.ndarray) -> List[np.ndarray]:
    """Full mip chain by 2x2 box filtering (Image::generateMipmaps uses
    linear-filtered blits, image.cpp:203-265)."""
    mips = [img]
    cur = img
    while max(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        cur = cur[:h2 * 2, :w2 * 2]
        if h >= 2 and w >= 2:
            cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
        elif h >= 2:
            cur = 0.5 * (cur[0::2] + cur[1::2])
        else:
            cur = 0.5 * (cur[:, 0::2] + cur[:, 1::2])
        mips.append(cur.astype(np.float32))
    return mips


def _wrap(coord: np.ndarray, size: int, mode: int) -> np.ndarray:
    if mode == _CLAMP:
        return np.clip(coord, 0, size - 1)
    if mode == _MIRROR:
        period = 2 * size
        c = np.mod(coord, period)
        return np.where(c < size, c, period - 1 - c)
    return np.mod(coord, size)  # REPEAT (glTF default)


def sample_bilinear(img: np.ndarray, uv: np.ndarray,
                    wrap_s: int = _REPEAT, wrap_t: int = _REPEAT
                    ) -> np.ndarray:
    """Bilinear taps of (H, W, C) at uv (N, 2) in texture space
    ([0,1] maps to the full image; texel centers at (i+0.5)/size)."""
    h, w = img.shape[:2]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None].astype(np.float32)
    fy = (y - y0)[:, None].astype(np.float32)
    x0w = _wrap(x0, w, wrap_s)
    x1w = _wrap(x0 + 1, w, wrap_s)
    y0w = _wrap(y0, h, wrap_t)
    y1w = _wrap(y0 + 1, h, wrap_t)
    c00 = img[y0w, x0w]
    c10 = img[y0w, x1w]
    c01 = img[y1w, x0w]
    c11 = img[y1w, x1w]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def apply_texture_transform(uv: np.ndarray, transform: Optional[dict]
                            ) -> np.ndarray:
    """KHR_texture_transform: uv' = offset + R(-rotation) @ (scale * uv)
    (the reference applies the extension's 3x3 matrix,
    gameobject.cpp:getTextureTransform)."""
    if not transform:
        return uv
    scale = np.asarray(transform.get("scale", [1.0, 1.0]), np.float32)
    offset = np.asarray(transform.get("offset", [0.0, 0.0]), np.float32)
    rot = float(transform.get("rotation", 0.0))
    out = uv * scale[None, :]
    if rot != 0.0:
        c, s = math.cos(rot), math.sin(rot)
        out = np.stack([c * out[:, 0] + s * out[:, 1],
                        -s * out[:, 0] + c * out[:, 1]], axis=-1)
    return (out + offset[None, :]).astype(np.float32)


class TextureSampler:
    """One glTF texture: decoded image + sampler + mips, sampled at UVs.

    ``srgb`` marks color textures (baseColor / emissive / SG diffuse+spec):
    values convert to linear AFTER filtering — matching GPU sRGB samplers,
    which filter in the stored space. Data textures (normal, metal-rough,
    occlusion) stay raw.
    """

    def __init__(self, gltf: dict, buffers: List[bytes], base_dir: str,
                 texture_index: int, srgb: bool,
                 image_cache: Optional[dict] = None):
        tex = gltf["textures"][texture_index]
        # KHR_texture_basisu and friends not supported; 'source' required.
        image_index = tex["source"]
        cache = image_cache if image_cache is not None else {}
        if image_index not in cache:
            cache[image_index] = build_mips(
                decode_image(gltf, buffers, base_dir, image_index))
        self.mips = cache[image_index]
        self.srgb = srgb
        sampler = {}
        if tex.get("sampler") is not None:
            sampler = gltf.get("samplers", [])[tex["sampler"]]
        self.wrap_s = sampler.get("wrapS", _REPEAT)
        self.wrap_t = sampler.get("wrapT", _REPEAT)

    @property
    def size(self):
        return self.mips[0].shape[1], self.mips[0].shape[0]

    def sample(self, uv: np.ndarray, lod: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """(N, 4) RGBA at uv (N, 2); ``lod`` (N,) optional per-sample mip
        level (trilinear between floor/ceil), the surfel-footprint analog
        of the reference's ray-cone LOD (closesthit.rchit:21-37)."""
        if lod is None:
            out = sample_bilinear(self.mips[0], uv, self.wrap_s, self.wrap_t)
        else:
            lod = np.clip(lod, 0.0, len(self.mips) - 1)
            lo = np.floor(lod).astype(np.int64)
            frac = (lod - lo).astype(np.float32)[:, None]
            out = np.empty((uv.shape[0], 4), np.float32)
            for level in np.unique(lo):
                m = lo == level
                a = sample_bilinear(self.mips[int(level)], uv[m],
                                    self.wrap_s, self.wrap_t)
                b = sample_bilinear(
                    self.mips[min(int(level) + 1, len(self.mips) - 1)],
                    uv[m], self.wrap_s, self.wrap_t)
                out[m] = a * (1 - frac[m]) + b * frac[m]
        if self.srgb:
            out = np.concatenate(
                [srgb_to_linear(out[:, :3]), out[:, 3:]], axis=-1)
        return out
