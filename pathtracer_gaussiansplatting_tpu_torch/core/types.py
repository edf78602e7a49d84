"""Scene, ray and settings types.

Counterpart of ``pathtracer_gaussiansplatting_tpu/core/types.py``
(``GaussianScene``, ``make_scene``, ``PunctualLights``,
``make_punctual_lights``, ``Rays``, ``RenderSettings``).
``GaussianScene`` is a frozen dataclass of float32 tensors (struct of
arrays over N Gaussians); ``scene_from_numpy`` builds it from the JAX
scene's leaves so both packages compute on identical parameters, and
``scene_to_numpy`` takes them back out.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.sh import SH_C0


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """N anisotropic 3D Gaussians, every field a float32 tensor.

    means (N, 3); log_scales (N, 3); quats (N, 4) (w, x, y, z);
    opacity_logits (N,); sh_coeffs (N, K, 3) with K = (deg+1)^2;
    emission (N, 3); metallic, roughness, clearcoat, clearcoat_roughness,
    transmission (N,). Field meanings follow the JAX ``GaussianScene``.
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor
    sh_coeffs: torch.Tensor
    emission: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    transmission: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh_coeffs.shape[1] ** 0.5)) - 1

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    def replace(self, **kw) -> "GaussianScene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GaussianScene":
        return GaussianScene(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianScene))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def make_scene(means, log_scales, quats, opacity_logits, sh_coeffs=None,
               emission=None, metallic=None, roughness=None, clearcoat=None,
               clearcoat_roughness=None, transmission=None, colors=None,
               sh_degree: int = 0, device=None) -> GaussianScene:
    """Build a GaussianScene from array-likes, filling default channels.

    ``colors`` (N, 3) in [0, 1] may replace ``sh_coeffs``: it becomes the
    DC SH band, dc = (c - 0.5) / SH_C0 (3DGS convention). The scene is
    built on ``device`` (None: the CUDA card, see ``core/device.py``).
    """
    device = resolve_device(device)
    means = _f32(means, device)
    n = means.shape[0]

    def full(value, shape=(n,)):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    if sh_coeffs is None:
        sh_coeffs = torch.zeros((n, (sh_degree + 1) ** 2, 3),
                                dtype=torch.float32, device=device)
        if colors is not None:
            sh_coeffs[:, 0, :] = (_f32(colors, device) - 0.5) / SH_C0
    else:
        sh_coeffs = _f32(sh_coeffs, device)

    def opt(x, default, shape=(n,)):
        return full(default, shape) if x is None else _f32(x, device)

    return GaussianScene(
        means=means,
        log_scales=_f32(log_scales, device),
        quats=_f32(quats, device),
        opacity_logits=_f32(opacity_logits, device),
        sh_coeffs=sh_coeffs,
        emission=opt(emission, 0.0, (n, 3)),
        metallic=opt(metallic, 0.0),
        roughness=opt(roughness, 0.8),
        clearcoat=opt(clearcoat, 0.0),
        clearcoat_roughness=opt(clearcoat_roughness, 0.03),
        transmission=opt(transmission, 0.0),
    )


def scene_from_numpy(d: Mapping[str, np.ndarray],
                     device=None) -> GaussianScene:
    """GaussianScene from a dict of the scene's leaves as numpy arrays
    (for example ``{f: np.asarray(getattr(jax_scene, f)) for f in
    SCENE_FIELDS}``), on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return GaussianScene(**{f: _f32(d[f], device) for f in SCENE_FIELDS})


def scene_to_numpy(scene: GaussianScene) -> dict:
    """The scene's leaves as float32 numpy arrays, the inverse of
    :func:`scene_from_numpy` (also for a scene of gradients)."""
    return {f: getattr(scene, f).detach().cpu().numpy() for f in SCENE_FIELDS}


@dataclasses.dataclass(frozen=True)
class PunctualLights:
    """Punctual lights: position, direction, color (L, 3) and intensity,
    range (<= 0: unlimited), inner_cone_cos, outer_cone_cos (L,) float32
    tensors; light_type (L,) int32, 1 directional, 0 point, 2 spot."""

    position: torch.Tensor
    direction: torch.Tensor
    color: torch.Tensor
    intensity: torch.Tensor
    light_type: torch.Tensor
    range: torch.Tensor
    inner_cone_cos: torch.Tensor
    outer_cone_cos: torch.Tensor

    @property
    def num_lights(self) -> int:
        return self.position.shape[0]


PUNCTUAL_FIELDS = tuple(f.name for f in dataclasses.fields(PunctualLights))


def make_punctual_lights(position=None, direction=None, color=None,
                         intensity=None, light_type=None, range=None,
                         inner_cone_cos=None, outer_cone_cos=None,
                         num: Optional[int] = None,
                         device=None) -> PunctualLights:
    """PunctualLights from array-likes; a missing field takes the JAX
    ``make_punctual_lights`` default (direction (0, -1, 0), white, unit
    intensity, point light, unlimited range, cones 1 / 0.7). Built on
    ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    if num is None:
        num = next((len(a) for a in (position, direction, color, intensity,
                                     light_type) if a is not None), 0)

    def arr(x, default, shape, dtype=np.float32):
        if x is None:
            return torch.tensor(np.full(shape, default, dtype), device=device)
        return torch.tensor(np.asarray(x, dtype).reshape(shape),
                            device=device)

    return PunctualLights(
        position=arr(position, 0.0, (num, 3)),
        direction=arr(direction if direction is not None
                      else np.tile([[0.0, -1.0, 0.0]], (num, 1)), 0.0,
                      (num, 3)),
        color=arr(color, 1.0, (num, 3)),
        intensity=arr(intensity, 1.0, (num,)),
        light_type=arr(light_type, 0, (num,), np.int32),
        range=arr(range, 0.0, (num,)),
        inner_cone_cos=arr(inner_cone_cos, 1.0, (num,)),
        outer_cone_cos=arr(outer_cone_cos, 0.7, (num,)),
    )


def punctual_from_numpy(d: Mapping[str, np.ndarray],
                        device=None) -> PunctualLights:
    """PunctualLights from a dict of the lights' leaves as numpy arrays
    (for example ``{f: np.asarray(getattr(jax_lights, f)) for f in
    PUNCTUAL_FIELDS}``); ``light_type`` stays int32. Built on ``device``
    (None: the CUDA card)."""
    device = resolve_device(device)
    return PunctualLights(**{
        f: torch.tensor(np.asarray(d[f], np.int32 if f == "light_type"
                                   else np.float32), device=device)
        for f in PUNCTUAL_FIELDS})


@dataclasses.dataclass(frozen=True)
class Rays:
    """A batch of rays: origins (R, 3), directions (R, 3), unit length."""

    origins: torch.Tensor
    directions: torch.Tensor

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration; every default equals the JAX
    ``RenderSettings`` (a test holds them equal)."""

    max_depth: int = 4
    opaque_depth: int = 0
    glass_ior: float = 1.01
    firefly_clamp: float = 5.0
    rr_start_depth: int = 4
    rr_min: float = 0.05
    rr_max: float = 0.95
    min_throughput: float = 1e-3
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.999
    sigma_cut: float = 3.0
    max_contribs: int = 64
    t_min: float = 1e-3
    t_max: float = 1e4
    transmittance_min: float = 1e-4
    shadow_eps: float = 0.05
    background: tuple = (0.0, 0.0, 0.0)
    ambient: tuple = (0.0, 0.0, 0.0, 1.0)
    hit_opacity_threshold: float = 0.5
    nee: bool = True
    sh_degree: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "background", tuple(self.background))
        object.__setattr__(self, "ambient", tuple(self.ambient))
