"""Light sampling: the emissive-Gaussian flux CDF, punctual lights, MIS (a
frozen copy of the port's plain module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/lights.py``:
``LightTables``, ``surfel_area``, ``build_light_tables``,
``sample_emissive``, ``pdf_nee_solid_angle``, ``sample_punctual`` and
``power2_mis``. Per-emitter flux is ||emission|| * surfel area * opacity;
punctual flux is intensity * 400 for directional lights and intensity * 4
pi otherwise; the strategy mix p_emissive is the emissive share of the
total flux, clamped into [0.1, 0.9] when both kinds of light exist. The
tables stay tensors on the scene's device, so the bounce loop never waits
on the host for them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .types import (
    GaussianScene, PunctualLights,
)
from .quaternions import (
    quat_to_rotmat,
)
from .safe_math import (
    safe_norm, safe_normalize,
)


@dataclasses.dataclass(frozen=True)
class LightTables:
    """Sampling tables (rebuild when the scene moves), float32 tensors.

    emissive_cdf (N,) normalized inclusive CDF over Gaussians;
    emissive_strength (N,) ||emission||; emissive_flux () total;
    punctual_cdf, punctual_prob (L,) ((1,) when there are none);
    punctual_flux () total; p_emissive () the strategy mix.
    """

    emissive_cdf: torch.Tensor
    emissive_strength: torch.Tensor
    emissive_flux: torch.Tensor
    punctual_cdf: torch.Tensor
    punctual_prob: torch.Tensor
    punctual_flux: torch.Tensor
    p_emissive: torch.Tensor


def surfel_area(scene: GaussianScene) -> torch.Tensor:
    """pi * s_a * s_b of each Gaussian's two largest axes (N,)."""
    s = torch.sort(torch.exp(scene.log_scales), dim=-1).values
    return math.pi * s[:, 1] * s[:, 2]


def build_light_tables(scene: GaussianScene,
                       punctual: Optional[PunctualLights] = None
                       ) -> LightTables:
    strength = safe_norm(scene.emission, dim=-1)
    # Non-emitters carry exactly 0 flux, not safe_norm's epsilon floor.
    strength = torch.where(strength > 1e-5, strength, 0.0)
    flux = strength * surfel_area(scene) * scene.opacities
    total_e = torch.sum(flux)
    cdf_e = torch.cumsum(flux, dim=0) / torch.clamp_min(total_e, 1e-12)
    cdf_e = torch.where(total_e > 0, cdf_e, torch.ones_like(cdf_e))

    dev = scene.means.device
    if punctual is None or punctual.num_lights == 0:
        cdf_p = torch.ones((1,), dtype=torch.float32, device=dev)
        prob_p = torch.ones((1,), dtype=torch.float32, device=dev)
        total_p = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        pflux = torch.where(punctual.light_type == 1,
                            punctual.intensity * 400.0,
                            punctual.intensity * 4.0 * math.pi)
        total_p = torch.sum(pflux)
        prob_p = pflux / torch.clamp_min(total_p, 1e-12)
        cdf_p = torch.cumsum(prob_p, dim=0)

    total = total_e + total_p
    p_em = torch.where(
        (total_e > 0) & (total_p > 0),
        torch.clamp(total_e / torch.clamp_min(total, 1e-12), 0.1, 0.9),
        torch.where(total_e > 0, 1.0, 0.0))
    return LightTables(emissive_cdf=cdf_e, emissive_strength=strength,
                       emissive_flux=total_e, punctual_cdf=cdf_p,
                       punctual_prob=prob_p, punctual_flux=total_p,
                       p_emissive=p_em)


def sample_emissive(u_select: torch.Tensor, u_disk: torch.Tensor,
                    scene: GaussianScene, tables: LightTables) -> dict:
    """A point on a flux-chosen emissive surfel per ray.

    Args: u_select (R,) uniforms for the CDF inversion; u_disk (R, 2)
    uniforms for the point on the surfel's disk.
    Returns dict: position (R, 3), normal (R, 3) (the surfel's shortest
    axis, not oriented), emission (R, 3), strength (R,), index (R,).
    """
    idx = torch.searchsorted(tables.emissive_cdf, u_select.contiguous())
    idx = torch.clamp(idx, 0, scene.num_gaussians - 1)
    rot = quat_to_rotmat(scene.quats[idx])                    # (R, 3, 3)
    s = torch.exp(scene.log_scales[idx])                      # (R, 3)
    order = torch.argsort(s, dim=-1, stable=True)             # ascending

    def axis(j):
        return torch.gather(rot, 2, order[:, None, j:j + 1].expand(-1, 3, 1)
                            )[..., 0]

    s_sorted = torch.gather(s, 1, order)
    r = torch.sqrt(u_disk[:, 0])
    phi = 2.0 * math.pi * u_disk[:, 1]
    pos = (scene.means[idx]
           + (r * torch.cos(phi) * s_sorted[:, 2])[:, None] * axis(2)
           + (r * torch.sin(phi) * s_sorted[:, 1])[:, None] * axis(1))
    return dict(position=pos, normal=axis(0), emission=scene.emission[idx],
                strength=tables.emissive_strength[idx],
                index=idx.to(torch.int32))


def pdf_nee_solid_angle(strength, total_flux, dist_sq, cos_light):
    """Solid-angle NEE pdf (strength / total_flux) * dist^2 / cos_light of
    an emitter sample or hit; 0 when the scene has no emissive flux."""
    return torch.where(
        total_flux > 0,
        (strength / torch.clamp_min(total_flux, 1e-12))
        * dist_sq / torch.clamp_min(cos_light, 1e-3),
        0.0)


def sample_punctual(u_select: torch.Tensor, lights: PunctualLights,
                    tables: LightTables, shade_pos: torch.Tensor) -> dict:
    """Pick a punctual light by its flux CDF for each shading point.

    Returns dict: direction (R, 3) toward the light, dist (R,) (1e4 for
    directional lights), radiance (R, 3) attenuated (1 / dist^2, the glTF
    range window applied once, the spot cone), inv_prob (R,) the
    selection weight.
    """
    idx = torch.searchsorted(tables.punctual_cdf, u_select.contiguous())
    idx = torch.clamp(idx, 0, lights.num_lights - 1)
    ltype = lights.light_type[idx]
    ldir = safe_normalize(lights.direction[idx])

    to_l = lights.position[idx] - shade_pos
    dist_sq = torch.clamp_min(torch.sum(to_l * to_l, dim=-1), 1e-2)
    dist = torch.sqrt(dist_sq)
    is_dir = ltype == 1
    l = torch.where(is_dir[:, None], -ldir, to_l / dist[:, None])
    dist_out = torch.where(is_dir, 1e4, dist)

    atten = torch.where(is_dir, 1.0, 1.0 / dist_sq)
    rng = lights.range[idx]
    window = torch.clamp(1.0 - (dist / torch.clamp_min(rng, 1e-6)) ** 4,
                         0.0, 1.0)
    atten = torch.where((~is_dir) & (rng > 0), window / dist_sq, atten)
    inner, outer = lights.inner_cone_cos[idx], lights.outer_cone_cos[idx]
    cos_dir = torch.sum(-l * ldir, dim=-1)
    scale = 1.0 / torch.clamp_min(inner - outer, 1e-3)
    spot = torch.clamp(cos_dir * scale - outer * scale, 0.0, 1.0)
    atten = torch.where(ltype == 2, atten * spot * spot, atten)

    le = lights.color[idx] * (lights.intensity[idx] * atten)[:, None]
    inv_prob = 1.0 / torch.clamp_min(tables.punctual_prob[idx], 1e-6)
    return dict(direction=l, dist=dist_out, radiance=le, inv_prob=inv_prob)


def power2_mis(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power-2 MIS weight of strategy a against b."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-12)
