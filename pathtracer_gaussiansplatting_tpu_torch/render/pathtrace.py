"""Multi-bounce path tracer over Gaussian scenes.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/pathtrace.py``
(``_nee``, ``pathtrace``, ``interaction_from_tiles``,
``interaction_from_tile_arrays``, ``pathtrace_camera``, ``accumulate``).
Each trace composites a ray's Gaussians into one aggregate interaction:
the escaping fraction T = 1 - alpha_acc sees the sky (ambient * 2) at
once, the interacting fraction continues the path. Per bounce: emission
with power-2 MIS against the previous BSDF pdf, one NEE sample (emissive
surfels with probability p_emissive, else punctual lights, each with a
shadow ray), then a scatter (glass with probability = transmission, else
clearcoat over the base lobes), adaptive depth, Russian roulette, and the
firefly clamp. Rays are masked, never compacted: dead rays multiply by
zero.

Random numbers are the reference's, bit for bit: bounce d draws
``ray_uniform(fold_in(key, d), R, dim)`` over the ray's index in its
batch, dimensions 7, 8, 10 (NEE), 11-15 (scatter) and 20 (roulette), all
in one ``rng.bounce_uniforms`` call (one K5 launch on the card). So
the batch a ray is traced in is part of the result, as in the reference.

The loop takes no host sync: light tables, fluxes, the alive mask and the
last pdf stay tensors; only settings and the lights' count are Python
branches.

While a ``torch.profiler`` records (``utils/profiling.span``), each
bounce's trace (``backend.trace``, every backend) is the range
``ptgs.trace``, its random draws ``ptgs.rng`` and its shading
(emission, MIS, NEE, scatter, roulette) ``ptgs.shade``; inside the
shading, the light samples (``lights.sample_emissive``,
``sample_punctual``) are ``ptgs.lights`` and the shadow rays
(``backend.visibility``) ``ptgs.vis``. The counters ``rays_shaded`` (R at
each bounce d >= 1) and ``rays_alive`` (the alive mask's sum there) give
the share of the masked shading's rays that are alive.
"""
from __future__ import annotations

from typing import Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core import rng as rng_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, PunctualLights, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.ops import bsdf as bsdf_mod
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.ops.safe_math import (
    safe_norm, safe_normalize,
)
from pathtracer_gaussiansplatting_tpu_torch.render import lights as lights_mod
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    TraceBackend, make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
    prepare_tiles, render_prepared, untile_image,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.profiling import (
    count, span,
)


def bounce_dims(settings: RenderSettings, d: int) -> dict:
    """The draws bounce d makes, by name: {name: (dimension, num)}."""
    dims = {}
    if settings.nee:
        dims.update(strat=(10, 1), sel=(7, 1), disk=(8, 2))
    if d + 1 < settings.max_depth:
        dims.update(lobe=(13, 1), dir=(14, 2), cc=(12, 1), glass=(15, 1),
                    reflect=(11, 1))
        if d + 1 >= settings.rr_start_depth:
            dims.update(rr=(20, 1))
    return dims


def _bounce_uniforms(dkey: torch.Tensor, r: int, device, settings,
                     d: int) -> dict:
    """The uniforms bounce d uses, by name: (R, 1) or (R, 2) each."""
    dims = bounce_dims(settings, d)
    with span("ptgs.rng"):
        return rng_mod.bounce_uniforms(dkey, r, dims, device)


def _nee(u: dict, scene: GaussianScene, tables: lights_mod.LightTables,
         punctual: Optional[PunctualLights], inter: dict, view, settings,
         backend: TraceBackend, use_nee=None, alive=None):
    """One next-event-estimation sample per ray from the uniforms ``u``
    (strat, sel, disk). Returns ((R, 3) radiance, frozen: the shadow rays
    the backend stopped short).

    ``use_nee`` (R,) gates the emissive strategy (no light samples on
    glass or mirror-smooth hits); punctual lights are still sampled there,
    attenuated by 1 - transmission.
    """
    pos, n = inter["position"], inter["normal"]
    alpha = torch.clamp_min(inter["alpha_acc"], 1e-8)
    albedo = inter["albedo"] / alpha[:, None]
    metallic = inter["metallic"]
    rough = torch.clamp_min(inter["roughness"], 1e-3)
    u_sel = u["sel"][:, 0]
    take_emissive = u["strat"][:, 0] < tables.p_emissive
    eps = settings.shadow_eps

    # Emissive surfels.
    with span("ptgs.lights"):
        em = lights_mod.sample_emissive(u_sel, u["disk"], scene, tables)
    to_l = em["position"] - pos
    dist_sq = torch.clamp_min(torch.sum(to_l * to_l, dim=-1), 1e-4)
    dist = torch.sqrt(dist_sq)
    l_dir = to_l / dist[:, None]
    n_dot_l = torch.sum(n * l_dir, dim=-1)
    cos_light = torch.abs(torch.sum(-l_dir * em["normal"], dim=-1))
    pdf_nee = lights_mod.pdf_nee_solid_angle(
        em["strength"], tables.emissive_flux, dist_sq, cos_light)
    mis = lights_mod.power2_mis(
        pdf_nee, bsdf_mod.mixture_pdf(n, view, l_dir, metallic, rough))
    brdf = bsdf_mod.eval_bsdf(n, view, l_dir, albedo, metallic, rough)
    ok = (n_dot_l > 1e-3) & (cos_light > 1e-3) & (pdf_nee > 1e-10)
    has_e = tables.emissive_flux > 0
    active_e = ok & take_emissive & has_e
    if alive is not None:
        active_e = active_e & alive
    if use_nee is not None:
        active_e = active_e & use_nee
    with span("ptgs.vis"):
        vis, frozen = backend.visibility(pos + n * eps, l_dir,
                                         dist - 2 * eps, active_e)
    e_contrib = brdf * em["emission"] \
        / torch.clamp_min(pdf_nee, 1e-10)[:, None]
    e_contrib = e_contrib * (mis * vis)[:, None] * settings.ambient[3]
    e_contrib = torch.where(ok[:, None], e_contrib, 0.0)
    e_contrib = e_contrib / torch.clamp_min(tables.p_emissive, 1e-3)
    if use_nee is not None:
        e_contrib = torch.where(use_nee[:, None], e_contrib, 0.0)
    contrib = torch.where(take_emissive[:, None] & has_e, e_contrib, 0.0)

    # Punctual lights.
    if punctual is not None and punctual.num_lights > 0:
        with span("ptgs.lights"):
            pl = lights_mod.sample_punctual(u_sel, punctual, tables, pos)
        n_dot_lp = torch.sum(n * pl["direction"], dim=-1)
        brdf_p = bsdf_mod.eval_bsdf(n, view, pl["direction"], albedo,
                                    metallic, rough)
        active_p = (n_dot_lp > 1e-3) & ~take_emissive
        if alive is not None:
            active_p = active_p & alive
        with span("ptgs.vis"):
            vis_p, frozen_p = backend.visibility(
                pos + n * eps, pl["direction"], pl["dist"] - 2 * eps,
                active_p)
        frozen = frozen + frozen_p
        p_contrib = brdf_p * pl["radiance"] \
            * (vis_p * pl["inv_prob"])[:, None]
        p_contrib = p_contrib * torch.clamp(
            1.0 - inter["transmission"], 0.0, 1.0)[:, None]
        p_contrib = torch.where((n_dot_lp > 1e-3)[:, None], p_contrib, 0.0)
        p_punct = torch.clamp_min(1.0 - tables.p_emissive, 1e-3)
        p_contrib = p_contrib / torch.where(has_e, p_punct, 1.0)
        contrib = contrib + torch.where(take_emissive[:, None], 0.0,
                                        p_contrib)
    return contrib, frozen


@torch.no_grad()
def pathtrace(scene: GaussianScene, rays: Rays, settings: RenderSettings,
              key: torch.Tensor,
              tables: Optional[lights_mod.LightTables] = None,
              punctual: Optional[PunctualLights] = None,
              backend: Optional[TraceBackend] = None,
              primary_interaction: Optional[dict] = None,
              return_aux: bool = False):
    """One sample per ray of path-traced radiance, (R, 3) linear.

    Args:
      key: the frame's key (``rng.frame_key(base, frame)``), on the host.
      tables: light tables (built from the scene and ``punctual`` when
        None).
      backend: the TraceBackend for bounce traces and shadow rays (dense
        when None).
      primary_interaction: a precomputed depth-0 interaction (the fused
        tile pass, see :func:`pathtrace_camera`); the camera trace is then
        skipped.
      return_aux: also return dict(frozen_alive=...), the rays the
        backend stopped short (bounce traces and shadow rays), summed over
        the sample.
    """
    if backend is None:
        backend = make_trace_backend(scene, settings, "dense")
    if tables is None:
        tables = lights_mod.build_light_tables(scene, punctual)
    r = rays.num_rays
    dev = rays.origins.device
    sky = torch.tensor(settings.ambient[:3], dtype=torch.float32,
                       device=dev) * 2.0
    origins, dirs = rays.origins, rays.directions
    throughput = torch.ones((r, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    last_pdf = torch.zeros((r,), dtype=torch.float32, device=dev)
    frozen_total = 0

    for d in range(settings.max_depth):
        u = _bounce_uniforms(rng_mod.fold_in(key, d), r, dev, settings, d)
        if d == 0 and primary_interaction is not None:
            inter = primary_interaction
        else:
            with span("ptgs.trace"):
                inter = backend.trace(scene, Rays(origins, dirs), settings,
                                      active=None if d == 0 else alive)
            if "frozen_alive" in inter:
                frozen_total = frozen_total + inter["frozen_alive"]
        if d >= 1:
            count("rays_shaded", r)
            count("rays_alive", alive)
        with span("ptgs.shade"):
            alpha = inter["alpha_acc"]
            # The escaping fraction sees the sky.
            radiance = radiance + torch.where(
                alive[:, None], throughput * inter["trans"][:, None] * sky,
                0.0)

            # Emission, MIS-weighted against the previous BSDF pdf. Glass
            # and mirror-smooth hits take no light samples, so an emitter
            # seen through them adds fully.
            use_nee_hit = (inter["transmission"] < 1e-3) \
                & (inter["roughness"] > 1e-3)
            if d == 0:
                # Glass first hits keep bouncing past opaque_depth.
                glass_first = inter["transmission"] > 0.05
            emitted = inter["radiance_emitted"]
            strength = safe_norm(emitted, dim=-1) \
                / torch.clamp_min(alpha, 1e-6)
            cos_l = torch.abs(torch.sum(inter["normal"] * dirs, dim=-1))
            pdf_nee_hit = lights_mod.pdf_nee_solid_angle(
                strength, tables.emissive_flux, inter["depth"] ** 2, cos_l)
            pdf_nee_hit = pdf_nee_hit * torch.where(
                tables.punctual_flux > 0, tables.p_emissive, 1.0)
            mis_on = (last_pdf > 0) & use_nee_hit & settings.nee
            mis_e = torch.where(
                mis_on, lights_mod.power2_mis(last_pdf, pdf_nee_hit), 1.0)
            radiance = radiance + torch.where(
                alive[:, None], throughput * emitted * mis_e[:, None], 0.0)

            # Direct lighting at the aggregate surface.
            view = -dirs
            if settings.nee:
                nee_li, frozen = _nee(u, scene, tables, punctual, inter,
                                      view, settings, backend,
                                      use_nee=use_nee_hit, alive=alive)
                frozen_total = frozen_total + frozen
                radiance = radiance + torch.where(
                    alive[:, None], throughput * alpha[:, None] * nee_li,
                    0.0)
            radiance = torch.clamp_max(radiance, settings.firefly_clamp)
            if d + 1 == settings.max_depth:
                break

            # Scatter: glass (Fresnel reflect / refract) with probability
            # = transmission, else clearcoat over the base lobes.
            alpha_safe = torch.clamp_min(alpha, 1e-8)
            albedo_hat = inter["albedo"] / alpha_safe[:, None]
            scat = bsdf_mod.sample_clearcoated(
                u["cc"][:, 0], u["lobe"][:, 0], u["dir"], inter["normal"],
                view, albedo_hat, inter["metallic"],
                torch.clamp_min(inter["roughness"], 1e-3),
                inter["clearcoat"], inter["cc_roughness"])
            glass = bsdf_mod.sample_glass(u["reflect"][:, 0], inter["normal"],
                                          view, albedo_hat, inter["metallic"],
                                          settings.glass_ior)
            # Select with the detached probability, reweight by the
            # continuous transmission (both ratios are exactly 1 here).
            t_hat = torch.clamp(inter["transmission"], 0.0, 1.0)
            p_g = t_hat.detach()
            take_glass = u["glass"][:, 0] < p_g
            tg = take_glass[:, None]
            w_glass = glass["weight"] \
                * (t_hat / torch.clamp_min(p_g, 1e-6))[:, None]
            w_base = scat["weight"] * ((1.0 - t_hat)
                                       / torch.clamp_min(1.0 - p_g, 1e-6)
                                       )[:, None]
            weight = torch.where(tg, w_glass, w_base)
            # Delta lobes carry no pdf.
            last_pdf = torch.where(take_glass, 0.0, scat["pdf"])
            valid = take_glass | scat["valid"]
            offset = torch.where(take_glass, glass["offset_sign"], 1.0) \
                * settings.shadow_eps
            throughput = throughput * alpha[:, None] * weight
            origins = inter["position"] + inter["normal"] * offset[:, None]
            dirs = torch.where(tg, glass["direction"], scat["direction"])

            max_t = torch.amax(throughput, dim=-1)
            alive = alive & valid & (alpha > 1e-4) \
                & (max_t > settings.min_throughput)
            if settings.opaque_depth and d + 1 >= settings.opaque_depth:
                alive = alive & glass_first
            if d + 1 >= settings.rr_start_depth:  # Russian roulette
                p = torch.clamp(max_t, settings.rr_min, settings.rr_max)
                survive = u["rr"][:, 0] <= p
                throughput = torch.where(survive[:, None],
                                         throughput / p[:, None], throughput)
                alive = alive & survive

    radiance = torch.clamp_max(radiance, settings.firefly_clamp)
    if return_aux:
        return radiance, dict(frozen_alive=frozen_total)
    return radiance


def _interaction(feats, alpha, depth, origins, dirs, settings) -> dict:
    """A trace_dense-style interaction from alpha-weighted tile feature
    sums (render/tiled._packet_features: rgb, emission, metallic,
    roughness, normal, clearcoat, cc_roughness, transmission), with the
    intrinsic properties renormalized by the accumulated alpha."""
    denom = torch.clamp_min(alpha, 1e-8)
    return dict(
        radiance_emitted=feats[:, 3:6],
        albedo=feats[:, 0:3],
        normal=safe_normalize(feats[:, 8:11]),
        position=origins + depth[:, None] * dirs,
        depth=depth,
        metallic=feats[:, 6] / denom,
        roughness=feats[:, 7] / denom,
        clearcoat=feats[:, 11] / denom,
        cc_roughness=feats[:, 12] / denom,
        transmission=feats[:, 13] / denom,
        alpha_acc=alpha,
        trans=1.0 - alpha,
        hit=alpha > settings.hit_opacity_threshold,
    )


def interaction_from_tiles(out: dict, rays: Rays,
                           settings: RenderSettings) -> dict:
    """The interaction of image-shaped ``render_prepared`` outputs (feats
    (H, W, F), alpha_acc, depth) for row-major rays."""
    f = out["feats"].shape[-1]
    return _interaction(out["feats"].reshape(-1, f),
                        out["alpha_acc"].reshape(-1),
                        out["depth"].reshape(-1), rays.origins,
                        rays.directions, settings)


def interaction_from_tile_arrays(out: dict, origins: torch.Tensor,
                                 dirs: torch.Tensor,
                                 settings: RenderSettings) -> dict:
    """The interaction of tile-major ``render_prepared`` outputs
    (tile_feats, tile_alpha, tile_depth) for rays in the same tile-major
    order: the bounces run in that order and only the final image is
    untiled."""
    f = out["tile_feats"].shape[-1]
    return _interaction(out["tile_feats"].reshape(-1, f),
                        out["tile_alpha"].reshape(-1),
                        out["tile_depth"].reshape(-1), origins, dirs,
                        settings)


@torch.no_grad()
def pathtrace_camera(scene: GaussianScene, camera, settings: RenderSettings,
                     key: torch.Tensor, packets=None, tables=None,
                     punctual=None, backend: Optional[TraceBackend] = None,
                     config=None, jitter=None, return_aux: bool = False):
    """One path-traced sample of a camera pose, (H*W, 3) row-major: the
    fused tile pass (``packets`` from prepare_tiles, made here when None)
    gives the primary hit for the jittered rays, the backend traces the
    bounces and shadow rays of all pixels as one batch, in tile-major
    order."""
    config = config or BinningConfig()
    if packets is None:
        packets = prepare_tiles(scene, camera, settings, config)
    out = render_prepared(
        packets, camera, settings, config, jitter=jitter,
        outputs=("tile_feats", "tile_alpha", "tile_depth", "tile_dirs"))
    t, p, _ = out["tile_dirs"].shape
    dirs = out["tile_dirs"].reshape(t * p, 3)
    origins = camera.c2w[:3, 3][None].expand(t * p, 3)
    primary = interaction_from_tile_arrays(out, origins, dirs, settings)
    res = pathtrace(scene, Rays(origins, dirs), settings, key, tables=tables,
                    punctual=punctual, backend=backend,
                    primary_interaction=primary, return_aux=return_aux)
    radiance, aux = res if return_aux else (res, None)
    img = untile_image(radiance.reshape(t, p, 3), camera, config)
    if return_aux:
        return img.reshape(-1, 3), aux
    return img.reshape(-1, 3)


def accumulate(prev: torch.Tensor, cur: torch.Tensor,
               frame: int) -> torch.Tensor:
    """Progressive accumulation mix(prev, cur, 1 / (frame + 1)); ``frame``
    counts completed samples. The blend is computed in float32, as the
    reference does."""
    blend = 1.0 / (torch.tensor(float(frame), dtype=torch.float32) + 1.0)
    return prev + (cur - prev) * blend  # a 0-dim host tensor joins any device
