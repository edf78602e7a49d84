"""Dense renderer: every Gaussian against every ray, exact per-ray order.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/reference.py``
(``dense_topk``, ``_gather_features``, ``trace_dense``,
``render_radiance_dense``, ``visibility_dense``). The (R, N) stages run in
``kernels/dense_trace.py`` (a CUDA kernel on the card, the plain version on
the CPU). ``trace_dense``'s (R, K) feature gather and composite run as one
kernel, ``dense_trace.dense_composite``, where the rays are on the card
and autograd wants no scene leaf (:func:`composite_on_card`); elsewhere,
and in ``render_radiance_dense``, they are plain torch.

While a ``torch.profiler`` records (``utils/profiling``), the top-K (K1
and its arguments) is the range ``ptgs.topk`` and the trace's feature
gather and composite ``ptgs.gather``; the counters ``dense_rays`` (R, the
rays of each top-K), ``dense_list_slots`` (R x K) and
``dense_list_filled`` (the entries with alpha > 0) give the share of the
lists that holds contributors, and ``dense_composite_rays`` (R) the rays
the composite kernel took.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.safe_math import (
    safe_normalize,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.profiling import (
    count, span,
)


def _geometry_needs_grad(scene: GaussianScene) -> bool:
    """Whether autograd wants t and alpha: grad mode is on and a geometry
    or opacity leaf requires grad."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (scene.means, scene.log_scales, scene.quats,
                                  scene.opacity_logits))


def _trace_needs_grad(scene: GaussianScene, rays: Rays) -> bool:
    """Whether autograd wants anything of the trace: grad mode is on and a
    scene leaf (geometry, opacity, SH, emission or a material) or the rays
    require grad."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (*(getattr(scene, f) for f in SCENE_FIELDS),
                                  rays.origins, rays.directions))


def composite_on_card(scene: GaussianScene, rays: Rays) -> bool:
    """Whether :func:`trace_dense` composites with the kernel
    ``dense_trace.dense_composite``: the rays are CUDA tensors and autograd
    wants nothing of the trace (its outputs carry no gradient)."""
    return rays.origins.is_cuda and not _trace_needs_grad(scene, rays)


def selected_peaks(scene: GaussianScene, origins: torch.Tensor,
                   dirs: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                   settings: RenderSettings):
    """(t, alpha) (R, K) of the selected pairs ``idx`` recomputed in torch
    from the scene's parameters, so differentiable: the plain version's
    operations on the same operands (bit-equal to it on the CPU); t_max
    and 0 where ``valid`` is false."""
    i = idx.long()
    m = gops.canonical_transforms(scene.log_scales[i], scene.quats[i])
    t, gval = gops.peak_response(origins[:, None], dirs[:, None],
                                 scene.means[i], m, settings.t_min,
                                 settings.t_max)
    alpha = gops.alpha_from_response(scene.opacities[i], gval,
                                     settings.alpha_min, settings.alpha_max,
                                     settings.sigma_cut)
    return (torch.where(valid, t, settings.t_max),
            torch.where(valid, alpha, 0.0))


def dense_topk(scene: GaussianScene, rays: Rays, settings: RenderSettings,
               sort_depths: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None,
               table: Optional[dense_trace.Table] = None):
    """Top-K nearest contributing Gaussians per ray, front to back, K =
    min(max_contribs, N).

    ``sort_depths`` (N,) orders by per-Gaussian depths in place of the
    per-ray peak t (the tile path's mean-depth order). ``table`` is
    ``dense_trace.gaussian_table(scene, settings)`` or its ``dense_table``,
    built once by the caller (built here when None). Returns idx (R, K)
    int32 (0 where invalid), t (R, K) (t_max where invalid) and alpha
    (R, K) (0 where invalid or where ``active`` (R,) is false). Where
    autograd wants them (a geometry or opacity leaf requires grad), t and
    alpha are recomputed from the scene for the selected pairs
    (:func:`selected_peaks`), since the kernel's outputs carry no
    gradient; only idx and validity come from the kernel.
    """
    k = min(settings.max_contribs, scene.num_gaussians)
    with span("ptgs.topk"):
        if table is None:
            table = dense_trace.gaussian_table(scene, settings)
        o, d = rays.origins.contiguous(), rays.directions.contiguous()
        idx, t, alpha = dense_trace.dense_topk(o, d, table, k, settings,
                                               sort_depths, active)
        if _geometry_needs_grad(scene):
            t, alpha = selected_peaks(scene, o, d, idx, alpha > 0, settings)
    count("dense_rays", o.shape[0])
    count("dense_list_slots", o.shape[0] * k)
    count("dense_list_filled", lambda: alpha > 0)
    return idx, t, alpha


def _gather_features(scene: GaussianScene, rays: Rays, idx: torch.Tensor,
                     t: torch.Tensor, settings: RenderSettings) -> dict:
    """(R, K, ...) shading features at the peak points: SH color,
    emission, viewer-facing surfel normal, materials and position."""
    idx = idx.long()
    d = rays.directions[:, None, :]
    x = rays.origins[:, None, :] + t[..., None] * d
    color = sh_mod.eval_sh(scene.sh_coeffs[idx], d.expand(x.shape),
                           settings.sh_degree)
    normal = gops.surfel_normal(scene.log_scales[idx], scene.quats[idx],
                                view_dir=d)
    return dict(color=color, emission=scene.emission[idx], normal=normal,
                 metallic=scene.metallic[idx],
                 roughness=scene.roughness[idx],
                 clearcoat=scene.clearcoat[idx],
                 cc_roughness=scene.clearcoat_roughness[idx],
                 transmission=scene.transmission[idx], position=x)


def trace_dense(scene: GaussianScene, rays: Rays, settings: RenderSettings,
                sort_depths: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                table: Optional[dense_trace.Table] = None,
                features: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Trace rays against the whole scene and composite one aggregate
    surface interaction per ray: (R, ...) radiance_emitted, albedo,
    normal, position, depth, metallic, roughness, clearcoat, cc_roughness,
    transmission, alpha_acc, trans and hit. A ray that ``active`` masks
    out composites nothing (alpha 0 everywhere). ``table`` as in
    :func:`dense_topk`; ``features`` the scene's
    ``dense_trace.composite_table`` at the trace's SH degree (built here
    when None and the kernel composites, :func:`composite_on_card`)."""
    idx, t, alpha = dense_topk(scene, rays, settings, sort_depths, active,
                               table)
    if composite_on_card(scene, rays):
        with span("ptgs.gather"):
            degree = dense_trace.composite_degree(scene, settings)
            if features is None:
                features = dense_trace.composite_table(scene, degree)
            out = dense_trace.dense_composite(
                idx, t, alpha, rays.directions.contiguous(), features, degree)
            count("dense_composite_rays", idx.shape[0])
            return interaction_from_composite(out, rays, settings)
    with span("ptgs.gather"):
        feats = _gather_features(scene, rays, idx, t, settings)
    weights, trans = composite_weights(alpha)
    alpha_acc = 1.0 - trans

    def wsum(f):
        return torch.einsum("rk,rk...->r...", weights, f)

    denom = torch.clamp_min(alpha_acc, 1e-8)
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
        alpha_acc=alpha_acc,
        trans=trans,
        hit=alpha_acc > settings.hit_opacity_threshold,
    )


def interaction_from_composite(out: torch.Tensor, rays: Rays,
                               settings: RenderSettings) -> dict:
    """:func:`trace_dense`'s interaction from ``dense_trace
    .dense_composite``'s (R, 16): the weighted sums as the plain path
    divides and normalizes them. The position's sum of w (o + t d) is
    o (1 - trans) + d sum(w t): the weights sum to 1 - trans."""
    trans = out[:, 0]
    alpha_acc = 1.0 - trans
    denom = torch.clamp_min(alpha_acc, 1e-8)
    scaled = out[:, 10:16] / denom[:, None]   # depth, then the materials
    return dict(
        radiance_emitted=out[:, 4:7],
        albedo=out[:, 1:4],
        normal=safe_normalize(out[:, 7:10]),
        position=(rays.origins * alpha_acc[:, None]
                  + rays.directions * out[:, 10:11]) / denom[:, None],
        depth=scaled[:, 0],
        metallic=scaled[:, 1],
        roughness=scaled[:, 2],
        clearcoat=scaled[:, 3],
        cc_roughness=scaled[:, 4],
        transmission=scaled[:, 5],
        alpha_acc=alpha_acc,
        trans=trans,
        hit=alpha_acc > settings.hit_opacity_threshold,
    )


def render_radiance_dense(scene: GaussianScene, rays: Rays,
                          settings: RenderSettings,
                          sort_depths: Optional[torch.Tensor] = None,
                          table: Optional[dense_trace.Table] = None
                          ) -> torch.Tensor:
    """Radiance-field rendering (R, 3): composited SH color + emission
    over the background; ``table`` as in :func:`dense_topk`."""
    idx, _, alpha = dense_topk(scene, rays, settings, sort_depths,
                               table=table)
    idx = idx.long()
    d = rays.directions[:, None, :].expand(idx.shape[0], idx.shape[1], 3)
    color = sh_mod.eval_sh(scene.sh_coeffs[idx], d, settings.sh_degree) \
        + scene.emission[idx]
    weights, trans = composite_weights(alpha)
    bg = torch.tensor(settings.background, dtype=torch.float32,
                      device=color.device)
    return torch.einsum("rk,rkc->rc", weights, color) + trans[:, None] * bg


def shadow_product(scene: GaussianScene, origins: torch.Tensor,
                   dirs: torch.Tensor, t_end: torch.Tensor,
                   seg: torch.Tensor, gid: torch.Tensor, vis: torch.Tensor,
                   settings: RenderSettings) -> torch.Tensor:
    """``vis`` (R,) carrying the gradient of prod(1 - alpha) over the
    (segment, Gaussian) pairs ``seg``, ``gid`` (M,): the pairs' alpha
    recomputed in torch from the scene's parameters with the plain
    version's operations (as :func:`selected_peaks` does for the trace),
    their product taken as exp(sum log(1 - alpha)) per segment, and
    ``vis`` + (product - product.detach()): the value is ``vis``'s, bit
    for bit, and the gradient the product's. Pairs left out have alpha =
    0, where the reference's gradient is 0 as well."""
    m = gops.canonical_transforms(scene.log_scales[gid], scene.quats[gid])
    alpha = gops.segment_transmittance_alpha(
        origins[seg], dirs[seg], scene.means[gid], m, scene.opacities[gid],
        settings.t_min, t_end[seg], settings.alpha_min, settings.alpha_max)
    log_t = torch.zeros_like(vis).index_add(0, seg, torch.log1p(-alpha))
    prod = torch.exp(log_t)
    return vis.detach() + (prod - prod.detach())


def visibility_dense(scene: GaussianScene, origins: torch.Tensor,
                     directions: torch.Tensor, t_end: torch.Tensor,
                     settings: RenderSettings,
                     active: Optional[torch.Tensor] = None,
                     table: Optional[dense_trace.Table] = None
                     ) -> torch.Tensor:
    """Soft-shadow transmittance (R,) prod(1 - alpha_i) from origins along
    directions up to t_end; 1 where ``active`` (R,) is false; ``table`` as
    in :func:`dense_topk`. On the CPU it differentiates through the plain
    version, as the JAX reference does. On the card, where autograd wants
    the geometry (a geometry or opacity leaf requires grad), the kernel
    also lists the pairs with alpha > 0 (``dense_trace
    .dense_visibility_pairs``) and :func:`shadow_product` gives its value
    their gradient."""
    if table is None:
        table = dense_trace.gaussian_table(scene, settings)
    o, d, te = (x.contiguous() for x in (origins, directions, t_end))
    if origins.device.type == "cpu" or not _geometry_needs_grad(scene):
        return dense_trace.dense_visibility(o, d, te, table, settings, active)
    vis, seg, gid = dense_trace.dense_visibility_pairs(o, d, te, table,
                                                       settings, active)
    return shadow_product(scene, o, d, te, seg, gid, vis, settings)
