"""Checkpoint and resume for long renders.

Counterpart of ``pathtracer_gaussiansplatting_tpu/utils/checkpoint.py``:

  * :func:`save_render_state` / :func:`load_render_state` keep a pose's
    accumulation buffer, its completed-sample count and the base key, so a
    pose resumes mid-accumulation with the same bits (sample f is keyed on
    the absolute frame index and the accumulation is a fold over f). The
    file is the JAX package's: either package reads the other's, and the
    key comes back as the port's (2,) int64 key.
  * :func:`save_scene` / :func:`load_scene` keep a GaussianScene (npz).
  * :class:`CaptureProgress` journals the finished capture poses, so a
    restarted capture skips them.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_render_state(path: str, accumulation, frames_done: int,
                      base_key, extra: Optional[dict] = None):
    """Write the state of a pose in progress; the key as uint32[2], as the
    JAX package writes its ``jax.random`` key."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        accumulation=_numpy(accumulation),
        frames_done=np.int64(frames_done),
        base_key=_numpy(base_key).astype(np.uint32),
        extra=json.dumps(extra or {}),
    )


def load_render_state(path: str, device=None) -> dict:
    """The state :func:`save_render_state` wrote (either package's file):
    accumulation as a float32 tensor on ``device`` (None: the CUDA card),
    frames_done, base_key as a (2,) int64 tensor (``core/rng.prng_key``'s
    form) and extra."""
    with np.load(path, allow_pickle=False) as z:
        return dict(
            accumulation=torch.as_tensor(
                np.asarray(z["accumulation"], np.float32),
                device=resolve_device(device)),
            frames_done=int(z["frames_done"]),
            base_key=torch.from_numpy(z["base_key"].astype(np.int64)),
            extra=json.loads(str(z["extra"])),
        )


def save_scene(path: str, scene: GaussianScene):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{f: _numpy(getattr(scene, f))
                                 for f in SCENE_FIELDS})


def load_scene(path: str, device=None) -> GaussianScene:
    """The scene :func:`save_scene` (or the JAX package's) wrote, on
    ``device`` (None: the CUDA card). A file from before a material channel
    existed loads with that channel's default (clearcoat 0, clearcoat
    roughness 0.03, transmission 0)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        data = {k: torch.as_tensor(np.asarray(z[k], np.float32),
                                   device=device) for k in z.files}
    n = data["means"].shape[0]
    defaults = dict(clearcoat=0.0, clearcoat_roughness=0.03,
                    transmission=0.0)
    for f, value in defaults.items():
        if f not in data:
            data[f] = torch.full((n,), value, dtype=torch.float32,
                                 device=device)
    return GaussianScene(**data)


class CaptureProgress:
    """Journal of finished capture poses (a JSON file, rewritten
    atomically).

    ``fingerprint`` guards a resume against a changed configuration: a
    journal written under another fingerprint (camera geometry,
    resolution, spp, scene, lights, shading, ...) is discarded with a
    warning, so old images are never paired with new cameras.
    """

    def __init__(self, path: str, fingerprint=None):
        self.path = path
        self.done = set()
        self.fingerprint = fingerprint
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            old_fp = data.get("fingerprint")
            if fingerprint is not None and old_fp is not None \
                    and old_fp != fingerprint:
                get_logger().warning(
                    "capture journal %s was written under a different "
                    "configuration (fingerprint %s != %s) — discarding "
                    "it; all poses will be re-captured",
                    path, old_fp, fingerprint)
            else:
                self.done = set(data["done"])

    def is_done(self, index: int) -> bool:
        return index in self.done

    def mark(self, index: int):
        self.done.add(index)
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(dict(done=sorted(self.done),
                           fingerprint=self.fingerprint), f)
        os.replace(tmp, self.path)
