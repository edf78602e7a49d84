"""NeRF-blender ``transforms_*.json`` writer and reader.

A copy of ``pathtracer_gaussiansplatting_tpu/data/transforms.py``
(``save_transforms_json``, ``load_transforms_json``; numpy only, but
importing it would run the JAX package's ``__init__``, which imports jax):
{"camera_angle_x": fov_x, "frames": [{"file_path": "./train/r_i",
"transform_matrix": 4x4 camera-to-world, row-major}]} with a 4-space
indent, in the OpenGL/NeRF convention of ``core/camera.py``.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def save_transforms_json(path, camera_angle_x: float, frames: Sequence[dict]):
    """frames: [{"file_path": str, "transform_matrix": (4, 4) array}]."""
    root = {
        "camera_angle_x": float(camera_angle_x),
        "frames": [
            {
                "file_path": fr["file_path"],
                "transform_matrix": np.asarray(
                    fr["transform_matrix"], np.float64).tolist(),
            }
            for fr in frames
        ],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(root, f, indent=4)


def load_transforms_json(path):
    with open(path) as f:
        root = json.load(f)
    frames = [
        dict(file_path=fr["file_path"],
             transform_matrix=np.asarray(fr["transform_matrix"], np.float32))
        for fr in root["frames"]
    ]
    return dict(camera_angle_x=float(root["camera_angle_x"]), frames=frames)
