"""The ray chunks that ``chip_smoke.py``, ``tools/turns.py`` and the tests
feed the march and dense kernels, and the work the dense kernels' culls
leave on them.

:func:`march_chunks`: bounce rays and shadow segments from a camera's
primary hit, for the grid march kernels (``chip_smoke.py``'s phase 6b).
:func:`dense_chunks`: primary, bounce and thin-far rays and shadow
segments of one pose, for the dense kernels (phase 5a).
:func:`cull_counts`: what the dense kernels' group and pair culls leave of
a chunk, counted in torch with the kernels' predicates.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 65536   # rays a chunk (render_pose's chunk in chip_smoke.py)
# The path-trace bench's camera (bench.py:124-128): eye and target.
EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)


def march_chunks(scene, cam, settings, cfg, n: int = CHUNK) -> list:
    """Three chunks of n rays, strided over the camera's primary hit:
    bounce rays (sampled as the bounce loop samples them), shadow segments
    to the emissive panel, and the bounce rays under a 50% active mask.
    Each is (name, origins, dirs, march keywords)."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.ops import bsdf
    from pathtracer_gaussiansplatting_tpu_torch.render import lights
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        interaction_from_tile_arrays,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles, render_prepared,
    )

    packets = prepare_tiles(scene, cam, settings, cfg)
    out = render_prepared(packets, cam, settings, cfg, outputs=(
        "tile_feats", "tile_alpha", "tile_depth", "tile_dirs"))
    dirs = out["tile_dirs"].reshape(-1, 3)
    origins = cam.c2w[:3, 3][None].expand(dirs.shape[0], 3)
    inter = interaction_from_tile_arrays(out, origins, dirs, settings)
    sel = torch.arange(0, dirs.shape[0], dirs.shape[0] // n,
                       device=dirs.device)[:n]
    inter = {k: v[sel] for k, v in inter.items()}
    d = dirs[sel]
    u = {dim: rng.ray_uniform(rng.fold_in(rng.prng_key(13), 1), n, dim, num,
                              d.device)
         for dim, num in ((7, 1), (8, 2), (12, 1), (13, 1), (14, 2))}
    alpha = inter["alpha_acc"].clamp_min(1e-8)
    normal = inter["normal"]
    scat = bsdf.sample_clearcoated(
        u[12][:, 0], u[13][:, 0], u[14], normal, -d,
        inter["albedo"] / alpha[:, None], inter["metallic"],
        inter["roughness"].clamp_min(1e-3), inter["clearcoat"],
        inter["cc_roughness"])
    eps = settings.shadow_eps
    hit = inter["alpha_acc"] > 1e-4
    bo = (inter["position"] + normal * eps).contiguous()
    bd = scat["direction"].contiguous()
    tables = lights.build_light_tables(scene, None)
    em = lights.sample_emissive(u[7][:, 0], u[8], scene, tables)
    to_l = em["position"] - inter["position"]
    dist = torch.sqrt(torch.clamp_min((to_l * to_l).sum(-1), 1e-4))
    l_dir = (to_l / dist[:, None]).contiguous()
    half = torch.from_numpy(np.random.default_rng(21).uniform(size=n)
                            < 0.5).to(d.device)
    return [("bounce rays", bo, bd, dict(active=hit)),
            ("shadow segments to the emissive panel", bo, l_dir,
             dict(t_end=(dist - 2 * eps).contiguous(),
                  active=hit & ((normal * l_dir).sum(-1) > 1e-3))),
            ("bounce rays, 50% active", bo, bd, dict(active=hit & half))]


def dense_chunks(dt, scene, light, cam, settings, n: int = CHUNK) -> dict:
    """Chunks of n rays of the camera's pose (EYE to TARGET): the first
    primary rays, bounce rays sampled from their hits as the bounce loop
    samples them, the pose seen from 20x as far (thin-far), and shadow
    segments from the hits to emissive surfels and to the point light.
    Returns the shipped table, K, the segments' origins, the first 4 n
    primary rays ("wide"), and the chunks: "topk" (name, origins, dirs)
    and "vis" (name, dirs, t_end, active)."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays
    from pathtracer_gaussiansplatting_tpu_torch.ops import bsdf
    from pathtracer_gaussiansplatting_tpu_torch.render import lights
    from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref

    rays = generate_rays(cam)
    o = rays.origins[:n].contiguous()
    d = rays.directions[:n].contiguous()
    wide = (rays.origins[:4 * n].contiguous(),
            rays.directions[:4 * n].contiguous())
    table = dt.dense_table(dt.gaussian_table(scene, settings))
    k = min(settings.max_contribs, scene.num_gaussians)

    # Bounce rays from the hits, sampled as the bounce loop samples them.
    with torch.no_grad():
        inter = ref.trace_dense(scene, Rays(o, d), settings, table=table)
    dkey = rng.fold_in(rng.prng_key(13), 0)
    u = {dim: rng.ray_uniform(dkey, n, dim, num, o.device)
         for dim, num in ((7, 1), (8, 2), (12, 1), (13, 1), (14, 2))}
    alpha = inter["alpha_acc"].clamp_min(1e-8)
    nrm = inter["normal"]
    scat = bsdf.sample_clearcoated(
        u[12][:, 0], u[13][:, 0], u[14], nrm, -d,
        inter["albedo"] / alpha[:, None], inter["metallic"],
        inter["roughness"].clamp_min(1e-3), inter["clearcoat"],
        inter["cc_roughness"])
    eps = settings.shadow_eps
    bo = (inter["position"] + nrm * eps).contiguous()
    bd = scat["direction"].contiguous()

    # The pose seen from 20x as far, through a 20x narrower field of view:
    # the surfels' quadratic loses most of its digits, so the cull keeps
    # far more pairs (dense_common.cuh).
    far_eye = tuple(t + 20.0 * (e - t) for e, t in zip(EYE, TARGET))
    far_cam = Camera(c2w=look_at(far_eye, TARGET, device=o.device),
                     fov_y_deg=cam.fov_y_deg / 20.0, width=cam.width,
                     height=cam.height)
    far = generate_rays(far_cam)
    fo = far.origins[:n].contiguous()
    fd = far.directions[:n].contiguous()

    # Shadow segments to emissive surfels and to the point light.
    tables = lights.build_light_tables(scene, light)
    hit = inter["alpha_acc"] > 1e-4
    em = lights.sample_emissive(u[7][:, 0], u[8], scene, tables)
    to_l = em["position"] - inter["position"]
    dist = torch.sqrt(torch.clamp_min((to_l * to_l).sum(-1), 1e-4))
    l_dir = (to_l / dist[:, None]).contiguous()
    act_e = hit & ((nrm * l_dir).sum(-1) > 1e-3)
    t_end_e = (dist - 2 * eps).contiguous()
    pl = lights.sample_punctual(u[7][:, 0], light, tables, inter["position"])
    act_p = hit & ((nrm * pl["direction"]).sum(-1) > 1e-3)
    p_dir = pl["direction"].contiguous()
    t_end_p = (pl["dist"] - 2 * eps).contiguous()

    return dict(
        table=table, k=k, origins=bo, wide=wide,
        topk=(("primary rays", o, d), ("bounce rays", bo, bd),
              ("thin-far rays", fo, fd)),
        vis=(("emissive shadow segments", l_dir, t_end_e, act_e),
             ("point-light shadow segments", p_dir, t_end_p, act_p)))


def cull_counts(dt, o, d, table, settings, active=None, t_end=None,
                rays_per_pass: int = 512, supers: bool = False) -> dict:
    """What the kernel's culls leave on these rays, counted in torch over
    ray chunks with the kernel's predicates (dense_super_keep,
    dense_group_keep and dense_cull_keep) on the DenseTable's rows in its
    order: group tests, the share of (warp, group) pairs a 32-ray warp
    reaches, pairs tested by the per-pair cull (live rays x rows of the
    groups they reach), pairs kept (the exact path's), (warp, row) pairs
    some lane of a 32-ray warp keeps, and the exact path's turns per
    warp (over each group, its busiest lane's kept rows), against warps x
    N: the shadow kernel's code path, a thread a segment. With ``supers``
    (the top-K kernel's path, a warp a ray): super-group tests (live rays
    x super-groups), group tests only in the super-groups a ray reaches,
    the rows of the groups it reaches in those, and the exact path's turns
    (its kept rows, 32 a turn) over the live rays. live_groups is live
    rays x groups either way."""
    n_rays, n = o.shape[0], table.rows.shape[0]
    g = dt.GROUP_ROWS
    n_groups = -(-n // g)
    live = torch.ones(n_rays, dtype=torch.bool, device=o.device) \
        if active is None else active
    tested = kept = warp = turns = warp_groups = group_tests = 0
    exact_turns = 0
    for s in range(0, n_rays, rays_per_pass):
        e = min(s + rays_per_pass, n_rays)
        te = None if t_end is None else t_end[s:e]
        reach = live[s:e, None] & dt.dense_group_keep(o[s:e], d[s:e], table,
                                                      settings, te)
        if supers:
            sup = live[s:e, None] & dt.dense_super_keep(o[s:e], d[s:e],
                                                        table, settings)
            in_sup = sup.repeat_interleave(dt.SUPER_GROUPS, dim=1)[
                :, :n_groups]
            group_tests += int(in_sup.sum())
            reach &= in_sup
        keep = dt.dense_cull_keep(o[s:e], d[s:e], table.sorted_rows,
                                  settings, te)
        keep = torch.nn.functional.pad(keep, (0, -n % g)).reshape(
            e - s, -1, g) & reach[..., None]
        tested += int(reach.sum()) * g
        kept += int(keep.sum())
        exact_turns += int(((keep.sum((1, 2)) + 31) // 32).sum())
        pad = -(e - s) % 32
        lanes = torch.nn.functional.pad(keep, (0, 0, 0, 0, 0, pad)).reshape(
            -1, 32, reach.shape[1], g)
        warp_groups += int(torch.nn.functional.pad(reach, (0, 0, 0, pad))
                           .reshape(-1, 32, reach.shape[1]).any(1).sum())
        warp += int(lanes.any(1).sum())
        turns += int(lanes.sum(-1).amax(1).sum())
    warps = -(-n_rays // 32)
    n_live = int(live.sum())
    res = dict(group_tests=n_live * n_groups, live_groups=n_live * n_groups,
               warp_group_share=warp_groups / (warps * n_groups),
               tested=tested, kept=kept, warp=warp, turns=turns,
               warps=warps * n)
    if supers:
        res.update(super_tests=n_live * -(-n_groups // dt.SUPER_GROUPS),
                   group_tests=group_tests, exact_turns=exact_turns,
                   live=n_live)
    return res
