"""The render RNG in plain int64 torch: threefry2x32, ``fold_in`` and the
float32 uniform of ``jax.random`` in its partitionable layout (a frozen
copy of the port's ``core/rng.py`` plain version).

Counter-based, so any one ray's numbers can be drawn alone: element
``i`` of a draw of shape (R, num) hashes the counter ``i = ray * num +
j``. The keys may be per-element int64 tensors, which lets one call draw
the numbers of rays from several frames at once.
"""
from __future__ import annotations

import numpy as np
import torch

FRAME_MIX = 719393
R2_A1 = 0.75487766624669276
R2_A2 = 0.56984029099805327
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counter words (x1, x2) under key (k1,
    k2); Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def prng_key(seed: int) -> tuple:
    seed &= (1 << 64) - 1
    return (seed >> 32, seed & M32)


def fold_in(key: tuple, data: int) -> tuple:
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def frame_key(base: tuple, frame: int) -> tuple:
    return fold_in(base, frame * FRAME_MIX % (2 ** 31 - 1))


def dim_key(key: tuple, dimension: int) -> tuple:
    return fold_in(key, dimension)


def uniform_at(k1, k2, counter: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) at int64 ``counter`` under keys (k1, k2)
    (ints, or int64 tensors broadcast against ``counter``)."""
    y1, y2 = threefry2x32(k1, k2, counter >> 32, counter & M32)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0,
                           0.0)


def r2_host(i: int) -> tuple:
    x = np.float32(i)
    return tuple(float(np.fmod(x * np.float32(a), np.float32(1.0)))
                 for a in (R2_A1, R2_A2))
