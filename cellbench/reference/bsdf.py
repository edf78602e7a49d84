"""Surface scattering: Lambert + GGX specular, clearcoat and glass lobes (a
frozen copy of the port's plain module).

Counterpart of ``pathtracer_gaussiansplatting_tpu/ops/bsdf.py``, function
for function. Every function is batched over leading ray axes and
branch-free: each lobe is evaluated for every ray and the sampled one is
selected with ``torch.where``. Selection probabilities are detached, as
the reference stop-gradients them, so a weight is f / p with p constant.
"""
from __future__ import annotations

import math

import torch

from .safe_math import (
    safe_normalize, safe_sqrt,
)

PI = math.pi


def _dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def orthonormal_basis(n: torch.Tensor):
    """Branch-free orthonormal basis (t, b) around unit normals (..., 3)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt


def cosine_hemisphere(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about n from uniforms u (..., 2)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    t, b = orthonormal_basis(n)
    return ((r * torch.cos(phi))[..., None] * t
            + (r * torch.sin(phi))[..., None] * b + z[..., None] * n)


def sample_ggx_half(u: torch.Tensor, n: torch.Tensor,
                    roughness: torch.Tensor) -> torch.Tensor:
    """A GGX half-vector about n (NDF sampling, alpha = roughness^2)."""
    a2 = torch.clamp_min(roughness, 1e-3) ** 4
    cos2 = (1.0 - u[..., 0]) / (1.0 + (a2 - 1.0) * u[..., 0] + 1e-12)
    cos_t = safe_sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = safe_sqrt(1.0 - cos2)
    phi = 2.0 * PI * u[..., 1]
    t, b = orthonormal_basis(n)
    return ((sin_t * torch.cos(phi))[..., None] * t
            + (sin_t * torch.sin(phi))[..., None] * b + cos_t[..., None] * n)


def d_ggx(n_dot_h: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    a = torch.clamp_min(roughness, 1e-3) ** 2
    a2 = a * a
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(PI * denom * denom, 1e-8)


def v_smith_ggx_fast(n_dot_v, n_dot_l, roughness) -> torch.Tensor:
    a = torch.clamp_min(roughness, 1e-3) ** 2
    v = n_dot_l * (n_dot_v * (1.0 - a) + a)
    lv = n_dot_v * (n_dot_l * (1.0 - a) + a)
    return 0.5 / torch.clamp_min(v + lv, 1e-5)


def f_schlick(cos_t, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_t, 0.0, 1.0),
                                       5.0)


def pdf_ggx(n, v, l, roughness) -> torch.Tensor:
    h = safe_normalize(v + l)
    n_dot_h = torch.clamp_min(_dot(n, h), 0.0)
    v_dot_h = torch.clamp_min(_dot(v, h), 0.0)
    return d_ggx(n_dot_h, roughness) * n_dot_h / (4.0 * v_dot_h + 1e-4)


def pdf_lambert(n, l) -> torch.Tensor:
    return torch.clamp_min(_dot(n, l), 0.0) / PI


def specular_prob(n, v, metallic) -> torch.Tensor:
    """Lobe-selection probability, clamped into [0.05, 0.95]."""
    n_dot_v = torch.clamp_min(_dot(n, v), 0.0)
    p = 0.04 + (1.0 - 0.04) * metallic
    p = p + (1.0 - p) * torch.pow(1.0 - n_dot_v, 5.0)
    return torch.clamp(p, 0.05, 0.95)


def f0_of(albedo, metallic) -> torch.Tensor:
    """Dielectric F0 = 0.04, blended to the albedo for metals."""
    return 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]


def eval_bsdf(n, v, l, albedo, metallic, roughness) -> torch.Tensor:
    """BRDF * NdotL (..., 3) for NEE: diffuse albedo (1 - metallic) / pi
    under 1 - F, plus GGX specular."""
    n_dot_l = torch.clamp_min(_dot(n, l), 0.0)
    n_dot_v = torch.clamp_min(_dot(n, v), 0.0)
    h = safe_normalize(v + l)
    f0 = f0_of(albedo, metallic)
    ndf = d_ggx(torch.clamp_min(_dot(n, h), 0.0), roughness)
    vis = v_smith_ggx_fast(n_dot_v, n_dot_l, roughness)
    fr = f_schlick(torch.clamp_min(_dot(h, v), 0.0)[..., None], f0)
    specular = (ndf * vis)[..., None] * fr
    diffuse = (1.0 - fr) * albedo * (1.0 - metallic[..., None]) / PI
    return (diffuse + specular) * n_dot_l[..., None]


def mixture_pdf(n, v, l, metallic, roughness) -> torch.Tensor:
    p_spec = specular_prob(n, v, metallic)
    return (p_spec * pdf_ggx(n, v, l, roughness)
            + (1.0 - p_spec) * pdf_lambert(n, l))


def sample_bsdf(u_lobe, u_dir, n, v, albedo, metallic, roughness) -> dict:
    """Sample the scatter direction: specular with probability
    ``specular_prob``, else cosine-weighted diffuse.

    Returns dict(direction (..., 3), weight (..., 3) carrying 1/pdf and
    1/p_lobe, pdf (the mixture pdf), valid (direction above the surface)).
    """
    p_spec = specular_prob(n, v, metallic).detach()
    take_spec = u_lobe < p_spec

    h = sample_ggx_half(u_dir, n, roughness)
    l_spec = 2.0 * _dot(v, h, keepdim=True) * h - v
    n_dot_l_s = torch.clamp_min(_dot(n, l_spec), 0.0)
    n_dot_v = torch.clamp_min(_dot(n, v), 0.0)
    n_dot_h = torch.clamp_min(_dot(n, h), 0.0)
    v_dot_h = torch.clamp_min(_dot(v, h), 0.0)
    fr = f_schlick(v_dot_h[..., None], f0_of(albedo, metallic))
    vis = v_smith_ggx_fast(n_dot_v, n_dot_l_s, roughness)
    w_spec = fr * (vis * 4.0 * n_dot_l_s * v_dot_h
                   / torch.clamp_min(n_dot_h, 1e-4))[..., None]
    w_spec = w_spec / torch.clamp_min(p_spec, 1e-3)[..., None]

    l_diff = cosine_hemisphere(u_dir, n)
    w_diff = albedo * (1.0 - metallic[..., None]) \
        / torch.clamp_min(1.0 - p_spec, 1e-3)[..., None]

    l = torch.where(take_spec[..., None], l_spec, l_diff)
    w = torch.where(take_spec[..., None], w_spec, w_diff)
    valid = _dot(n, l) > 1e-4
    w = torch.where(valid[..., None], w, 0.0)
    pdf = torch.where(valid, mixture_pdf(n, v, l, metallic, roughness), 0.0)
    return dict(direction=l, weight=w, pdf=pdf, valid=valid)


def sample_clearcoated(u_cc, u_lobe, u_dir, n, v, albedo, metallic,
                       roughness, clearcoat, cc_roughness) -> dict:
    """Scatter off the base BSDF under a clearcoat layer: the coat's GGX
    lobe (F0 0.04, scaled by clearcoat) with probability
    F_cc(NdotV) * clearcoat, else the base lobes attenuated by the energy
    through the coat. Returns the keys of :func:`sample_bsdf`."""
    n_dot_v = torch.clamp_min(_dot(n, v), 0.0)
    f_cc_view = f_schlick(n_dot_v, 0.04) * clearcoat
    cc_prob = torch.clamp(f_cc_view, 0.0, 1.0).detach()
    take_cc = (clearcoat > 0.0) & (u_cc < cc_prob)

    ccr = torch.clamp_min(cc_roughness, 1e-3)
    h_cc = sample_ggx_half(u_dir, n, ccr)
    l_cc = 2.0 * _dot(v, h_cc, keepdim=True) * h_cc - v
    n_dot_l = torch.clamp_min(_dot(n, l_cc), 0.0)
    n_dot_h = torch.clamp_min(_dot(n, h_cc), 0.0)
    v_dot_h = torch.clamp_min(_dot(v, h_cc), 0.0)
    f_cc = f_schlick(v_dot_h, 0.04) * clearcoat
    vis = v_smith_ggx_fast(n_dot_v, n_dot_l, ccr)
    w_cc = f_cc * vis * 4.0 * n_dot_l * v_dot_h \
        / torch.clamp_min(n_dot_h, 1e-4)
    w_cc = (w_cc / torch.clamp_min(cc_prob, 1e-3))[..., None].expand(
        *w_cc.shape, 3)
    pdf_cc_total = (cc_prob * pdf_ggx(n, v, l_cc, ccr)
                    + (1.0 - cc_prob) * mixture_pdf(n, v, l_cc, metallic,
                                                    roughness))
    valid_cc = n_dot_l > 1e-4

    base = sample_bsdf(u_lobe, u_dir, n, v, albedo, metallic, roughness)
    atten = ((1.0 - f_cc_view)
             / torch.clamp_min(1.0 - cc_prob, 1e-3))[..., None]
    take = take_cc[..., None]
    return dict(
        direction=torch.where(take, l_cc, base["direction"]),
        weight=torch.where(take, w_cc, base["weight"] * atten),
        pdf=torch.where(take_cc, pdf_cc_total, base["pdf"] * (1.0 - cc_prob)),
        valid=torch.where(take_cc, valid_cc, base["valid"]),
    )


def refract(d, n, eta: float):
    """Refract incident directions d (into the surface) about unit normals
    n with relative IOR eta: (direction, tir); on total internal reflection
    the direction is the zero vector (GLSL ``refract``)."""
    cos_i = -_dot(d, n, keepdim=True)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t[..., 0] > 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    out = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(tir[..., None], 0.0, out), tir


def sample_glass(u_reflect, n, v, albedo, metallic, ior: float) -> dict:
    """Fresnel-weighted reflect or refract through a viewer-facing surfel
    (eta = 1 / ior; total internal reflection reflects). Returns
    dict(direction, weight (1 for reflection, albedo for refraction),
    offset_sign (+1 above the surface, -1 below)); both lobes are deltas,
    so there is no pdf."""
    fr = f_schlick(torch.abs(_dot(n, v))[..., None], f0_of(albedo, metallic))
    prob_reflect = torch.amax(fr, dim=-1).detach()
    l_refl = 2.0 * _dot(n, v, keepdim=True) * n - v
    l_refr, tir = refract(-v, n, 1.0 / ior)
    take_reflect = (u_reflect < prob_reflect) | tir
    take = take_reflect[..., None]
    return dict(direction=torch.where(take, l_refl, l_refr),
                weight=torch.where(take, torch.ones_like(albedo), albedo),
                offset_sign=torch.where(take_reflect, 1.0, -1.0))
