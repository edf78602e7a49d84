"""Counter-based RNG for rendering, bit-exact with the reference's keys.

Counterpart of ``pathtracer_gaussiansplatting_tpu/core/rng.py``
(``r2_sequence``, ``frame_key``, ``dim_key``, ``ray_uniform``,
``subpixel_jitter``). The
reference draws from ``jax.random`` with the threefry2x32 generator in its
partitionable bit layout; this module
reimplements that hash, ``fold_in`` and float32 ``uniform`` so every
jitter and uniform matches the reference bit for bit.

A key is a (2,) int64 tensor holding two uint32 words; it is passed in
explicitly and lives on the host, where keys are folded in Python ints.
On a CUDA device every draw is one launch of the hand-written kernel K5
(``kernels/threefry.py``, ``csrc/threefry.cu``), which hashes in native
uint32 arithmetic: :func:`bounce_uniforms` takes all of a bounce's draws
in one launch, :func:`subpixel_jitter` a frame's jitter. On the CPU they
run the plain version (:func:`uniform_plain`, :func:`uniforms_plain`,
:func:`jitter_plain`): the same hash op by op on int64 tensors masked to
32 bits, since torch has no uint32 shifts on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.kernels import threefry as k5

FRAME_MIX = 719393
R2_A1 = 0.75487766624669276
R2_A2 = 0.56984029099805327

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of counter words (x1, x2) under key
    (k1, k2). Words are Python ints or int64 tensors holding uint32
    values; returns the two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _words(key: torch.Tensor):
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def prng_key(seed: int) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` holds, for a 64-bit seed."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and a uint32."""
    y1, y2 = threefry2x32(*_words(key), 0, int(data) & _M32)
    return torch.tensor([y1, y2], dtype=torch.int64)


def uniform_plain(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1), op by op.

    Partitionable layout: element i hashes the counter (i >> 32, i & M32)
    and takes the XOR of the two output words; the top 23 bits become the
    mantissa of a float in [1, 2), minus 1.
    """
    k1, k2 = _words(key)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0).reshape(shape)


def uniforms_plain(draws, r: int, device) -> list:
    """The plain version of one K5 launch: for each (key, num) of
    ``draws`` its (r, num) uniforms, one :func:`uniform_plain` each."""
    return [uniform_plain(key, (r, num), device) for key, num in draws]


def _launch(draws, r: int, device, r2=None) -> list:
    """One K5 launch for ``draws`` ((key, num) pairs): each draw's (r, num)
    block of the packed buffer, a contiguous view."""
    nums = [num for _, num in draws]
    buf = k5.threefry_uniforms([_words(key) for key, _ in draws], nums, r,
                               device, r2)
    out, off = [], 0
    for num in nums:
        out.append(buf[off:off + r * num].view(r, num))
        off += r * num
    return out


def _draw(draws, r: int, device) -> list:
    if device.type == "cpu":
        return uniforms_plain(draws, r, device)
    return _launch(draws, r, device)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1), on ``device``
    (None: the CUDA card, one K5 launch)."""
    device = resolve_device(device)
    return _draw([(key, 1)], math.prod(shape), device)[0].reshape(shape)


def r2_sequence(i: int, device=None) -> torch.Tensor:
    """Fractional part of the 2D R2 quasirandom sequence at index i, (2,),
    on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    i = torch.tensor(float(i), dtype=torch.float32, device=device)
    a = torch.tensor([R2_A1, R2_A2], dtype=torch.float32, device=device)
    return torch.fmod(i * a, 1.0)


def r2_host(i: int) -> tuple:
    """:func:`r2_sequence` computed on the host in float32: the same two
    values, as Python floats."""
    x = np.float32(i)
    return tuple(float(np.fmod(x * np.float32(a), np.float32(1.0)))
                 for a in (R2_A1, R2_A2))


def frame_key(base_key: torch.Tensor, frame: int) -> torch.Tensor:
    """Key for one accumulation frame (``frame`` a Python int)."""
    return fold_in(base_key, frame * FRAME_MIX % (2 ** 31 - 1))


def dim_key(key: torch.Tensor, dimension: int) -> torch.Tensor:
    """Key for one random dimension of the estimator (jitter, lobe, ...)."""
    return fold_in(key, dimension)


def ray_uniform(key: torch.Tensor, num_rays: int, dimension: int,
                num: int = 1, device=None) -> torch.Tensor:
    """(num_rays, num) uniforms in [0, 1) for one random dimension, one
    row per ray (the ray's index in its batch), on ``device`` (None: the
    CUDA card, one K5 launch)."""
    device = resolve_device(device)
    return _draw([(dim_key(key, dimension), num)], num_rays, device)[0]


def bounce_uniforms(key: torch.Tensor, r: int, dims: dict,
                    device=None) -> dict:
    """Every uniform one bounce draws: {name: (r, num) uniforms of
    ``ray_uniform(key, r, dim, num)``} for ``dims`` = {name: (dim, num)},
    on ``device`` (None: the CUDA card). On CUDA it is one K5 launch, each
    draw a contiguous view of its buffer; on the CPU the plain version."""
    device = resolve_device(device)
    if not dims:
        return {}
    draws = [(dim_key(key, dim), num) for dim, num in dims.values()]
    return dict(zip(dims, _draw(draws, r, device)))


def jitter_plain(key: torch.Tensor, height: int, width: int,
                 r2: tuple, device) -> torch.Tensor:
    """The plain version of K5's jitter mode: (H, W, 2) uniforms of the
    frame's jitter key plus the host's R2 offsets ``r2``, modulo 1."""
    u = uniform_plain(key, (height, width, 2), device)
    return torch.fmod(u + torch.tensor(r2, dtype=torch.float32,
                                       device=device), 1.0)


def subpixel_jitter(key: torch.Tensor, height: int, width: int, frame: int,
                    device=None) -> torch.Tensor:
    """(H, W, 2) subpixel jitter for ``frame``: pixel-uniform random jitter
    shifted by the frame's R2 offset, modulo 1, on ``device`` (None: the
    CUDA card, one K5 launch in its jitter mode)."""
    device = resolve_device(device)
    jkey, r2 = dim_key(frame_key(key, frame), 0), r2_host(frame)
    if device.type == "cpu":
        return jitter_plain(jkey, height, width, r2, device)
    return _launch([(jkey, 2)], height * width, device, r2)[0].view(
        height, width, 2)
