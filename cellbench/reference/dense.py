"""The dense trace backend in plain torch (a frozen copy of the port's
plain ``render/reference.py`` and ``kernels/dense_trace.py``, without the
kernels' culls): every ray against every Gaussian, in blocks of rays.

The trace takes the K nearest contributors of each ray by ``torch.topk``
over the (R, N) keys (the peak t where alpha > 0), gathers their (R, K)
features and composites them front to back into one interaction; the
shadow product multiplies 1 - alpha over all N Gaussians. ``DenseBackend``
gives both the calls of ``pathtrace.pathtrace``'s backend, and
``render_pixels`` the flat capture renderer's accumulated radiance for
chosen pixels of chosen poses.

``lowp=True`` rounds the Gaussians, the rays and the per-pair quadratic
to bfloat16 (the benchmark's control: a precision below the
configuration's float32).
"""
from __future__ import annotations

import math

import torch

from . import lights as lights_mod
from . import sh as sh_mod
from .gaussians import canonical_transforms, ray_quadratic, surfel_normal
from .pathtrace import RayKeys, pathtrace
from .safe_math import safe_normalize
from .tiles import pixel_dirs, rnd
from .types import Rays

BLOCK_PAIRS = 1 << 25   # (ray, Gaussian) pairs a block of rays holds


def _blocks(n_rays: int, n_gauss: int):
    step = max(1, BLOCK_PAIRS // max(n_gauss, 1))
    return [(s, min(s + step, n_rays)) for s in range(0, n_rays, step)]


class _Gaussians:
    """The scene's per-Gaussian trace operands, (1, N, ...) each: means,
    M = diag(1/s) R^T and opacities, rounded where ``lowp``."""

    def __init__(self, scene, lowp: bool):
        self.mean = rnd(scene.means, lowp)[None]
        self.m = rnd(canonical_transforms(scene.log_scales, scene.quats),
                     lowp)[None]
        self.opac = rnd(scene.opacities, lowp)[None]
        self.lowp = lowp

    def quadratic(self, o, d):
        """(a, b, c) of each (ray, Gaussian) pair, (R, N) each, a clamped
        at 1e-12."""
        a, b, c = (rnd(x, self.lowp) for x in ray_quadratic(
            rnd(o, self.lowp)[:, None], rnd(d, self.lowp)[:, None],
            self.mean, self.m))
        return torch.clamp_min(a, 1e-12), b, c


def _response(a, b, c, t):
    return torch.exp(-0.5 * torch.clamp_min(a * t * t + 2.0 * b * t + c,
                                            0.0))


def topk(g: _Gaussians, origins, dirs, k: int, settings, active=None):
    """idx (R, K) int64, t (R, K), alpha (R, K) of each ray's K nearest
    contributors (alpha > 0, by peak t); idx 0, t_max and alpha 0 past
    them and on every slot of a ray ``active`` masks out."""
    cut = math.exp(-0.5 * settings.sigma_cut ** 2)
    parts = []
    for s, e in _blocks(origins.shape[0], g.mean.shape[1]):
        a, b, c = g.quadratic(origins[s:e], dirs[s:e])
        t = torch.clamp(-b / a, settings.t_min, settings.t_max)
        gval = _response(a, b, c, t)
        alpha = g.opac * gval
        alpha = torch.where((gval < cut) | (alpha < settings.alpha_min),
                            0.0, torch.clamp_max(alpha, settings.alpha_max))
        key = torch.where(alpha > 0.0, t, math.inf)
        skey, order = torch.topk(key, k, dim=1, largest=False, sorted=True)
        # Equal keys (peaks clamped to t_min) in index order, as the port's
        # stable sort has them; topk keeps no order among them.
        order, by_index = torch.sort(order, dim=1)
        skey, by_key = torch.sort(torch.gather(skey, 1, by_index), dim=1,
                                  stable=True)
        order = torch.gather(order, 1, by_key)
        valid = torch.isfinite(skey)
        if active is not None:
            valid = valid & active[s:e, None]
        parts.append((torch.where(valid, order, 0),
                      torch.where(valid, torch.gather(t, 1, order),
                                  settings.t_max),
                      torch.where(valid, torch.gather(alpha, 1, order), 0.0)))
    return tuple(torch.cat(x) for x in zip(*parts))


def visibility(g: _Gaussians, origins, dirs, t_end, settings, active=None):
    """(R,) prod over every Gaussian of 1 - alpha on the segment [t_min,
    t_end] (the peak clamped into it, alpha_min and alpha_max, no
    sigma_cut); 1 where ``active`` is false."""
    parts = []
    for s, e in _blocks(origins.shape[0], g.mean.shape[1]):
        a, b, c = g.quadratic(origins[s:e], dirs[s:e])
        t = torch.minimum(torch.clamp_min(-b / a, settings.t_min),
                          t_end[s:e, None])
        alpha = g.opac * _response(a, b, c, t)
        alpha = torch.where(alpha < settings.alpha_min, 0.0,
                            torch.clamp_max(alpha, settings.alpha_max))
        parts.append(torch.prod(1.0 - alpha, dim=-1))
    vis = torch.cat(parts)
    return vis if active is None else torch.where(active, vis, 1.0)


def interaction(scene, origins, dirs, idx, t, alpha, settings) -> dict:
    """The trace's aggregate interaction: the (R, K) features of the
    listed Gaussians at their peak points, composited front to back with
    weights alpha_i prod_{j<i} (1 - alpha_j)."""
    d = dirs[:, None, :]
    x = origins[:, None, :] + t[..., None] * d
    feats = dict(
        color=sh_mod.eval_sh(scene.sh_coeffs[idx], d.expand(x.shape),
                             settings.sh_degree),
        emission=scene.emission[idx],
        normal=surfel_normal(scene.log_scales[idx], scene.quats[idx],
                             view_dir=d),
        metallic=scene.metallic[idx], roughness=scene.roughness[idx],
        clearcoat=scene.clearcoat[idx],
        cc_roughness=scene.clearcoat_roughness[idx],
        transmission=scene.transmission[idx], position=x)
    cp = torch.cumprod(1.0 - alpha, dim=-1)
    weights = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], -1) * alpha
    trans = cp[:, -1]
    alpha_acc = 1.0 - trans
    denom = torch.clamp_min(alpha_acc, 1e-8)

    def wsum(f):
        w = weights.reshape(weights.shape + (1,) * (f.dim() - 2))
        return (w * f).sum(1)

    return dict(
        radiance_emitted=wsum(feats["emission"]),
        albedo=wsum(feats["color"]),
        normal=safe_normalize(wsum(feats["normal"])),
        position=wsum(feats["position"]) / denom[:, None],
        depth=wsum(t) / denom,
        metallic=wsum(feats["metallic"]) / denom,
        roughness=wsum(feats["roughness"]) / denom,
        clearcoat=wsum(feats["clearcoat"]) / denom,
        cc_roughness=wsum(feats["cc_roughness"]) / denom,
        transmission=wsum(feats["transmission"]) / denom,
        alpha_acc=alpha_acc, trans=trans,
        hit=alpha_acc > settings.hit_opacity_threshold)


class DenseBackend:
    """The dense backend's two calls (the port's ``render/pipeline.py``),
    on the all-pairs trace and shadow product."""

    def __init__(self, scene, settings, lowp: bool = False):
        self.settings = settings
        self.k = min(settings.max_contribs, scene.num_gaussians)
        self.g = _Gaussians(scene, lowp)

    def trace(self, scene, rays, settings, active=None):
        o, d = rays.origins, rays.directions
        idx, t, alpha = topk(self.g, o, d, self.k, settings, active)
        return interaction(scene, o, d, idx, t, alpha, settings)

    def visibility(self, origins, dirs, t_end, active=None):
        return visibility(self.g, origins, dirs, t_end, self.settings,
                          active), 0


@torch.no_grad()
def render_pixels(scene, cams, pixels, settings, spp: int, keys: dict,
                  chunk: int, lowp: bool = False):
    """[(S, 3)] accumulated radiance of the pixels ``pixels`` = [(py, px)
    (S,) int64 each] of each camera over spp samples (frames 0 .. spp -
    1, keyed by ``keys``), as the flat capture renderer makes them: rays
    through pixel centres, row-major in chunks of ``chunk`` rays, so that
    a ray's random numbers follow its index within its chunk; acc += (cur
    - acc) / (f + 1); no punctual lights."""
    tables = lights_mod.build_light_tables(scene, None)
    backend = DenseBackend(scene, settings, lowp)
    origins, dirs, frames, index = [], [], [], []
    for cam, (py, px) in zip(cams, pixels):
        d = pixel_dirs(cam, py, px)
        within = (py * cam.width + px) % chunk
        for f in range(spp):
            origins.append(cam.c2w[:3, 3][None].expand(d.shape[0], 3))
            dirs.append(d)
            frames.append(torch.full_like(py, f))
            index.append(within)
    rays = Rays(torch.cat(origins), torch.cat(dirs))
    primary = backend.trace(scene, rays, settings)
    radiance = pathtrace(scene, rays, settings,
                         RayKeys(keys, torch.cat(frames), torch.cat(index)),
                         tables, backend, primary)
    out, at = [], 0
    for py, _ in pixels:
        s = py.shape[0]
        part = radiance[at:at + spp * s].reshape(spp, s, 3)
        at += spp * s
        acc = torch.zeros_like(part[0])
        for f in range(spp):
            acc = acc + (part[f] - acc) / torch.tensor(f + 1.0)
        out.append(acc)
    return out
