"""The reference's scene, light, ray and settings types: frozen copies of
the port's ``core/types.py`` classes, without its constructors."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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


SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianScene))
