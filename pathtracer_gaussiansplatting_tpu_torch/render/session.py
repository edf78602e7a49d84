"""Headless interactive session: the reference engine's interactive loop,
driven by scripted input.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/session.py``
(``InteractiveSession``). Callers (the ``interact`` subcommand, scripts,
tests) feed key and cursor events and step the session one accumulated
sample at a time; any input that changes the view zeroes the
accumulation, and torus edits resize the sensor live.

Key map:
  w/a/s/d          free-camera translation      c     toggle camera mode
  look dx dy       cursor deltas (yaw/pitch or toroidal alpha/beta)
  z/x  torus major radius +/-    m/n  torus minor radius +/-
  u/j  torus height +/-          r    camera reset
  1-7  sampling strategy for the point-cloud pass
  p    toggle the point-cloud view

One trace backend (``render/pipeline.make_trace_backend``) serves the
session for its scene: above 50k Gaussians "auto" builds one grid, so a
camera-mode step runs the forward tile kernel for the primary hit and
the grid march kernels for the bounces and shadows. Sample f of a pose is
keyed ``fold_in(PRNGKey(seed), f)`` with the port's bit-exact threefry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core import rng
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, FreeCamera, toroidal_c2w,
)
from pathtracer_gaussiansplatting_tpu_torch.core.torus import (
    TorusConfig, torus_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.render.lights import (
    build_light_tables,
)
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
    accumulate, pathtrace_camera,
)
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.render.points import (
    render_point_cloud,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import prepare_tiles
from pathtracer_gaussiansplatting_tpu_torch.sampling.strategies import (
    SamplingMethod, generate_samples,
)

_METHOD_KEYS = {str(i + 1): m for i, m in enumerate(SamplingMethod)}


class InteractiveSession:
    """Progressive renderer and input state machine, one sample per
    step().

    ``step()`` renders one path-traced sample of the current pose and
    folds it into the accumulation, mix(prev, cur, 1 / (n + 1)). Every
    input that changes the view (camera motion, a mode switch, a torus
    resize) resets the accumulation and the pose's tile packets. The
    session renders on the scene's device.
    """

    def __init__(self, scene, settings: RenderSettings,
                 width: int = 320, height: int = 240,
                 torus: TorusConfig = TorusConfig(),
                 punctual=None, backend: str = "auto", seed: int = 13):
        self.scene = scene
        self.settings = settings
        self.width, self.height = width, height
        self.torus = torus
        self.punctual = punctual
        self.device = scene.means.device
        self.free_cam = FreeCamera()
        self.camera_mode = "free"        # or "toroidal"
        self.alpha_deg, self.beta_deg = 0.0, 0.0
        self.render_mode = "camera"      # or "pointcloud"
        self.sampling = SamplingMethod.UNIFORM
        self.frame = 0                   # accumulated samples at this pose
        self._accum: Optional[torch.Tensor] = None
        # the previous point-cloud pass's hits, for IMP_COL / IMP_HIT
        self._prev_uv: Optional[np.ndarray] = None
        self._prev_colors: Optional[np.ndarray] = None
        self._prev_flags: Optional[np.ndarray] = None
        self._packets = None
        self._key = rng.prng_key(seed)
        self._tables = build_light_tables(scene, punctual)
        self._backend = make_trace_backend(scene, settings, backend)

    # ---- input: every view change resets the accumulation ----

    def _dirty(self):
        self.frame = 0
        self._accum = None
        self._packets = None

    def key(self, ch: str, dt: float = 0.1) -> None:
        """One hotkey press."""
        moves = dict(w=(1, 0, 0), s=(-1, 0, 0), a=(0, -1, 0), d=(0, 1, 0))
        if ch in moves and self.camera_mode == "free":
            f, st, asc = moves[ch]
            self.free_cam.move(dt, forward=f, strafe=st, ascend=asc)
            self._dirty()
        elif ch == "c":
            self.camera_mode = ("toroidal" if self.camera_mode == "free"
                                else "free")
            self._dirty()
        elif ch == "r":
            self.free_cam.reset()
            self._dirty()
        elif ch == "p":
            self.render_mode = ("pointcloud"
                                if self.render_mode == "camera"
                                else "camera")
            self._dirty()
        elif ch in _METHOD_KEYS:
            self.sampling = _METHOD_KEYS[ch]
        elif ch in "zxmnuj":
            t = self.torus
            if ch == "z":
                t = dataclasses.replace(
                    t, major_radius=t.major_radius + 0.5)
            elif ch == "x":
                t = dataclasses.replace(
                    t, major_radius=max(0.5, t.major_radius - 0.5))
            elif ch == "m":
                t = dataclasses.replace(
                    t, minor_radius=t.minor_radius + 0.1)
            elif ch == "n":
                t = dataclasses.replace(
                    t, minor_radius=max(0.05, t.minor_radius - 0.1))
            elif ch == "u":
                t = dataclasses.replace(t, height=t.height + 0.25)
            elif ch == "j":
                t = dataclasses.replace(t, height=t.height - 0.25)
            self.torus = t
            self._dirty()

    def look(self, dx: float, dy: float) -> None:
        """Cursor deltas: free-camera yaw/pitch, or toroidal alpha/beta."""
        if self.camera_mode == "free":
            self.free_cam.rotate(dx, dy)
        else:
            self.alpha_deg = float(np.mod(self.alpha_deg + 0.2 * dx, 360.0))
            self.beta_deg = float(np.clip(self.beta_deg + 0.2 * dy,
                                          -89.0, 89.0))
        self._dirty()

    # ---- rendering ----

    @property
    def camera(self) -> Camera:
        if self.camera_mode == "free":
            return self.free_cam.camera(self.width, self.height, self.device)
        c2w = toroidal_c2w(self.alpha_deg, self.beta_deg,
                           self.torus.major_radius, self.torus.height,
                           device=self.device)
        return Camera(c2w=c2w, fov_y_deg=self.free_cam.fov_y_deg,
                      width=self.width, height=self.height)

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """Render and accumulate one sample; returns the (H, W, 3) image
        as host numpy."""
        if self.render_mode == "pointcloud":
            return self._step_pointcloud()
        cam = self.camera
        cfg = BinningConfig(alpha_min=self.settings.alpha_min)
        if self._packets is None:
            self._packets = prepare_tiles(self.scene, cam, self.settings,
                                          cfg)
        cur = pathtrace_camera(
            self.scene, cam, self.settings,
            rng.fold_in(self._key, self.frame),
            packets=self._packets, tables=self._tables,
            punctual=self.punctual, backend=self._backend, config=cfg)
        prev = torch.zeros_like(cur) if self._accum is None else self._accum
        self._accum = accumulate(prev, cur, self.frame)
        self.frame += 1
        return self._accum.reshape(self.height, self.width, 3).cpu().numpy()

    def _step_pointcloud(self) -> np.ndarray:
        """The point-cloud view: the torus sensor's hits splatted as 2-px
        points (render/points.py)."""
        n = min(self.torus.num_rays, 65536)
        # IMP_COL / IMP_HIT re-sample from the previous pass's hits; the
        # first pass has none and falls back to RANDOM.
        uv = generate_samples(self.sampling, n,
                              prev_uv=self._prev_uv,
                              prev_colors=self._prev_colors,
                              prev_flags=self._prev_flags)
        rays = torus_rays(uv, self.torus, self.device)
        inter = self._backend.trace(self.scene, rays, self.settings)
        hit = inter["alpha_acc"] > self.settings.hit_opacity_threshold
        self._prev_uv = np.asarray(uv)
        self._prev_colors = inter["albedo"].cpu().numpy()
        self._prev_flags = hit.cpu().numpy().astype(np.float32)
        img = render_point_cloud(
            inter["position"], inter["albedo"], hit, self.camera)
        self.frame += 1
        return img.cpu().numpy()
