"""Scene config: the JSON schema of the reference engine's scene files.

A copy of ``pathtracer_gaussiansplatting_tpu/utils/config.py``
(``SunConfig``, ``CaptureConfig``, ``ObjectConfig``, ``SceneConfig``,
``load_scene_config``, ``load_rtbox_config``): that module is numpy-only,
but importing it runs the JAX package's ``__init__``, which imports jax.
The same file gives the same fields, with the same defaults:

  * ``main_scene.json`` may be an indirection {"scene": "<path>"};
  * ``settings``: use_rt_box, rt_box_file, render_torus, render_pointcloud,
    ambient_light[4] (default 0,0,0,1), torus_settings{major_radius=16,
    minor_radius=1, height=8, major_segments=500, minor_segments=500,
    num_rays}, sun{color, direction, intensity} (a directional light),
    use_lod, lod_factor, the capture keys (accumulation_steps=512,
    total_positions=336, min_beta=-45, max_beta=45, image_divisor=2,
    capture_images, capture_pointcloud) and the render extras (width,
    height, fov, max_depth, sampling_method, backend);
  * ``objects``: [{model, position, scale, rotation}], where a model is a
    3DGS ``.ply`` checkpoint, a glTF file or a ``builtin:`` scene;
  * ``rtbox.json``: position, dimensions, panels{floor, ceiling,
    back_wall, left_wall, right_wall} with material{base_color, metallic,
    roughness} and light{intensity}.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig


@dataclasses.dataclass
class SunConfig:
    color: tuple = (1.0, 1.0, 1.0)
    direction: tuple = (0.0, -1.0, 0.0)
    intensity: float = 1.0


@dataclasses.dataclass
class CaptureConfig:
    accumulation_steps: int = 512
    total_positions: int = 336
    min_beta: float = -45.0
    max_beta: float = 45.0
    image_divisor: int = 2
    capture_images: bool = True
    capture_pointcloud: bool = True


@dataclasses.dataclass
class ObjectConfig:
    model: str = ""
    position: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0)  # euler degrees XYZ


@dataclasses.dataclass
class SceneConfig:
    use_rt_box: bool = False
    rt_box_file: str = ""
    render_torus: bool = False
    render_pointcloud: bool = False
    ambient_light: tuple = (0.0, 0.0, 0.0, 1.0)
    torus: TorusConfig = dataclasses.field(default_factory=TorusConfig)
    sun: Optional[SunConfig] = None
    use_lod: bool = False
    lod_factor: float = 1.0
    capture: CaptureConfig = dataclasses.field(default_factory=CaptureConfig)
    objects: List[ObjectConfig] = dataclasses.field(default_factory=list)
    # image size and field of view of the capture cameras
    width: int = 800
    height: int = 800
    fov_y_deg: float = 45.0
    max_depth: int = 4
    sampling_method: str = "uniform"
    # Traversal backend: 'auto' picks tiled+grid above the dense-scene
    # threshold (render/pipeline.AUTO_DENSE_LIMIT); explicit values:
    # 'dense', 'grid', 'tiled+grid', 'tiled+dense'.
    backend: str = "auto"


def _tup(x, n, default):
    if x is None:
        return tuple(default)
    x = list(np.atleast_1d(x).astype(float))
    if len(x) == 1:
        x = x * n
    return tuple(x[:n])


def load_scene_config(path: str) -> SceneConfig:
    """Load a scene JSON (following the main_scene indirection if present)."""
    with open(path) as f:
        data = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    if "scene" in data and isinstance(data["scene"], str):
        sub = data["scene"]
        sub_path = sub if os.path.isabs(sub) else os.path.join(base, sub)
        return load_scene_config(sub_path)

    cfg = SceneConfig()
    s = data.get("settings", {})
    cfg.use_rt_box = s.get("use_rt_box", False)
    cfg.rt_box_file = s.get("rt_box_file", "")
    cfg.render_torus = s.get("render_torus", cfg.render_torus)
    cfg.render_pointcloud = s.get("render_pointcloud", cfg.render_pointcloud)
    cfg.ambient_light = _tup(s.get("ambient_light"), 4, (0, 0, 0, 1))
    t = s.get("torus_settings", {})
    cfg.torus = TorusConfig(
        major_radius=t.get("major_radius", 16.0),
        minor_radius=t.get("minor_radius", 1.0),
        height=t.get("height", 8.0),
        major_segments=t.get("major_segments", 500),
        minor_segments=t.get("minor_segments", 500),
        num_rays=t.get("num_rays", 1_000_000),
    )
    if "sun" in s:
        sun = s["sun"]
        cfg.sun = SunConfig(color=_tup(sun.get("color"), 3, (1, 1, 1)),
                            direction=_tup(sun.get("direction"), 3, (0, -1, 0)),
                            intensity=sun.get("intensity", 1.0))
    cfg.use_lod = s.get("use_lod", False)
    cfg.lod_factor = s.get("lod_factor", 1.0)
    cfg.capture = CaptureConfig(
        accumulation_steps=s.get("accumulation_steps", 512),
        total_positions=s.get("total_positions", 336),
        min_beta=s.get("min_beta", -45.0),
        max_beta=s.get("max_beta", 45.0),
        image_divisor=int(s.get("image_divisor", 2)),
        capture_images=s.get("capture_images", True),
        capture_pointcloud=s.get("capture_pointcloud", True),
    )
    cfg.width = s.get("width", cfg.width)
    cfg.height = s.get("height", cfg.height)
    cfg.fov_y_deg = s.get("fov", cfg.fov_y_deg)
    cfg.max_depth = s.get("max_depth", cfg.max_depth)
    cfg.sampling_method = s.get("sampling_method", cfg.sampling_method)
    cfg.backend = s.get("backend", cfg.backend)
    for obj in data.get("objects", []):
        cfg.objects.append(ObjectConfig(
            model=obj.get("model", ""),
            position=_tup(obj.get("position"), 3, (0, 0, 0)),
            scale=_tup(obj.get("scale"), 3, (1, 1, 1)),
            rotation=_tup(obj.get("rotation"), 3, (0, 0, 0)),
        ))
    return cfg


def load_rtbox_config(path: str) -> Dict[str, Any]:
    """Parse an rtbox.json: position, dimensions and, per panel, its
    base_color, metallic, roughness and light_intensity."""
    with open(path) as f:
        data = json.load(f)
    panels = {}
    for name, p in data.get("panels", {}).items():
        mat = p.get("material", {})
        panels[name] = dict(
            base_color=_tup(mat.get("base_color"), 3, (0.8, 0.8, 0.8)),
            metallic=mat.get("metallic", 0.0),
            roughness=mat.get("roughness", 1.0),
            light_intensity=p.get("light", {}).get("intensity", 0.0),
        )
    return dict(
        position=_tup(data.get("position"), 3, (0, 0, 0)),
        dimensions=_tup(data.get("dimensions"), 3, (10, 10, 10)),
        panels=panels,
    )
