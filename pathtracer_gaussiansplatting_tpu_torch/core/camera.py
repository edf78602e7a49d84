"""Pinhole cameras: look-at and toroidal poses, perspective ray generation.

Counterpart of ``pathtracer_gaussiansplatting_tpu/core/camera.py``
(``Camera``, ``look_at``, ``toroidal_c2w``, ``generate_rays``,
``orthographic_rays``, ``FreeCamera``, ``view_matrix``). Camera-to-world
matrices use the OpenGL convention: the camera looks along -Z, columns of
c2w[:3, :3] are (right, up, back).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: ``c2w`` a (4, 4) float32 tensor, ``fov_y_deg`` the
    full vertical field of view in degrees, image ``width`` x ``height``."""

    c2w: torch.Tensor
    fov_y_deg: float
    width: int
    height: int

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def fov_x_rad(self) -> float:
        fy = np.radians(self.fov_y_deg)
        return float(2.0 * np.arctan(np.tan(fy / 2.0) * self.aspect))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-8)


def _c2w(rot_cols, pos) -> torch.Tensor:
    c2w = torch.eye(4, dtype=torch.float32, device=pos.device)
    c2w[:3, :3] = torch.stack(rot_cols, dim=-1)
    c2w[:3, 3] = pos
    return c2w


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """Camera-to-world matrix (OpenGL convention) looking from eye at
    target, on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    eye, target, up = (_f32(v, device) for v in (eye, target, up))
    fwd = _unit(target - eye)
    right = _unit(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    return _c2w([right, true_up, -fwd], eye)


def _rotate_about_axis(v, axis, angle_rad):
    """Rodrigues rotation of v about axis."""
    axis = _unit(axis)
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    return (v * c + torch.linalg.cross(axis, v) * s
            + axis * torch.dot(axis, v) * (1.0 - c))


def toroidal_c2w(alpha_deg, beta_deg, major_radius, height,
                 device=None) -> torch.Tensor:
    """Camera pose on the torus centerline: ``alpha`` around the major ring,
    ``beta`` pitch about the local right axis, with the up vector rotated
    along so nothing snaps past 90 degrees. On ``device`` (None: the CUDA
    card)."""
    device = resolve_device(device)
    a = torch.deg2rad(torch.remainder(_f32(alpha_deg, device), 360.0))
    b = torch.deg2rad(torch.remainder(_f32(beta_deg, device), 360.0))
    zero = torch.zeros_like(a)
    pos = torch.stack([torch.cos(a), zero, torch.sin(a)]) * major_radius
    pos = pos + _f32([0.0, height, 0.0], device)
    base_forward = torch.stack([-torch.cos(a), zero, -torch.sin(a)])
    base_up = _f32([0.0, 1.0, 0.0], device)
    right = _unit(torch.linalg.cross(base_forward, base_up))
    fwd = _rotate_about_axis(base_forward, right, b)
    up = _rotate_about_axis(base_up, right, b)
    return _c2w([right, up, -fwd], pos)


def generate_rays(camera: Camera,
                  jitter: Optional[torch.Tensor] = None) -> Rays:
    """One ray per pixel, row-major (H*W rays), on the device of c2w.

    Pixel centers sit at +0.5 unless a per-pixel ``jitter`` (H, W, 2) in
    [0, 1) is given (subpixel antialiasing). Row 0 is the top of the image.
    """
    h, w = camera.height, camera.width
    dev = camera.c2w.device
    fy = torch.deg2rad(torch.tensor(camera.fov_y_deg, dtype=torch.float32,
                                    device=dev))
    tan_y = torch.tan(fy / 2.0)
    tan_x = tan_y * (w / h)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    u = (((px + jx) / w) * 2.0 - 1.0).expand(h, w)
    v = (((py + jy) / h) * 2.0 - 1.0).expand(h, w)
    right, up, fwd = camera.c2w[:3, 0], camera.c2w[:3, 1], -camera.c2w[:3, 2]
    dirs = (fwd + u[..., None] * tan_x * right
            - v[..., None] * tan_y * up)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origins = camera.c2w[:3, 3].expand(h * w, 3)
    return Rays(origins=origins, directions=dirs.reshape(-1, 3))


def orthographic_rays(center, direction, up, extent, width, height,
                      device=None) -> Rays:
    """Orthographic ray grid, row-major, on ``device`` (None: the CUDA
    card): rays start on the plane through ``center`` spanned by (right,
    up), all along ``direction``; ``extent`` is the plane's half-width."""
    device = resolve_device(device)
    direction = _f32(direction, device)
    direction = direction / torch.linalg.vector_norm(direction)
    up = _f32(up, device)
    right = _unit(torch.linalg.cross(direction, up))
    true_up = torch.linalg.cross(right, direction)
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height * 2.0 - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    origins = (_f32(center, device)
               + uu[..., None] * extent * right
               - vv[..., None] * extent * true_up)
    dirs = direction.expand(origins.shape)
    return Rays(origins=origins.reshape(-1, 3),
                directions=dirs.reshape(-1, 3))


@dataclasses.dataclass
class FreeCamera:
    """Free-fly camera state: yaw/pitch driven by cursor deltas, local
    WASD + ascend translation, speed and field-of-view modifiers, reset to
    the construction pose. Host numpy state (control logic); ``camera()``
    gives the ``Camera`` for the current pose."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 3.0], np.float32))
    yaw_deg: float = -90.0          # looking down -Z
    pitch_deg: float = 0.0
    fov_y_deg: float = 45.0
    speed: float = 2.5              # units/s
    sensitivity: float = 0.1        # degrees per cursor count

    def __post_init__(self):
        self._home = (self.position.copy(), self.yaw_deg, self.pitch_deg,
                      self.fov_y_deg)

    @property
    def forward(self) -> np.ndarray:
        cy, sy = np.cos(np.radians(self.yaw_deg)), np.sin(
            np.radians(self.yaw_deg))
        cp, sp = np.cos(np.radians(self.pitch_deg)), np.sin(
            np.radians(self.pitch_deg))
        f = np.array([cy * cp, sp, sy * cp], np.float32)
        return f / np.linalg.norm(f)

    def rotate(self, dx_counts: float, dy_counts: float) -> None:
        """Cursor-delta look: yaw += dx, pitch += dy, pitch clamped to
        +/-89 degrees."""
        self.yaw_deg = float(np.mod(self.yaw_deg + dx_counts
                                    * self.sensitivity, 360.0))
        self.pitch_deg = float(np.clip(self.pitch_deg + dy_counts
                                       * self.sensitivity, -89.0, 89.0))

    def move(self, dt: float, forward: float = 0.0, strafe: float = 0.0,
             ascend: float = 0.0) -> None:
        """WASD + ascend translation in the local frame; inputs in
        [-1, 1]."""
        f = self.forward
        r = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
        r /= max(np.linalg.norm(r), 1e-8)
        step = self.speed * dt
        self.position = (self.position + step
                         * (forward * f + strafe * r
                            + ascend * np.array([0.0, 1.0, 0.0], np.float32))
                         ).astype(np.float32)

    def adjust_speed(self, factor: float) -> None:
        self.speed = float(np.clip(self.speed * factor, 0.01, 100.0))

    def adjust_fov(self, delta_deg: float) -> None:
        self.fov_y_deg = float(np.clip(self.fov_y_deg + delta_deg,
                                       10.0, 120.0))

    def reset(self) -> None:
        """Back to the construction pose."""
        pos, yaw, pitch, fov = self._home
        self.position = pos.copy()
        self.yaw_deg, self.pitch_deg, self.fov_y_deg = yaw, pitch, fov

    def camera(self, width: int, height: int, device=None) -> Camera:
        """The Camera at this pose, on ``device`` (None: the CUDA card)."""
        eye = np.asarray(self.position, np.float32)
        return Camera(c2w=look_at(eye, eye + self.forward, device=device),
                      fov_y_deg=self.fov_y_deg, width=width, height=height)


def view_matrix(camera: Camera) -> torch.Tensor:
    """World-to-camera matrix (4, 4)."""
    r, t = camera.c2w[:3, :3], camera.c2w[:3, 3]
    w2c = torch.eye(4, dtype=torch.float32, device=r.device)
    w2c[:3, :3] = r.T
    w2c[:3, 3] = -(r.T @ t)
    return w2c

