"""Row order and group test of the dense kernels: each kernel timed on its
shipped table against two other tables of the same Gaussians.

``csrc/dense_topk.cu`` and ``csrc/dense_visibility.cu`` read a
``kernels/dense_trace.DenseTable``: the rows in Morton order of the means,
for each 32 rows a sphere that a warp tests before it tests the rows, and
(the top-K kernel's first test) for each 32 groups a sphere around
theirs. This script builds, from the same ``gaussian_table``, the tables

  shipped        ``dense_table``: Morton order, the group and super-group
                 spheres;
  no group test  the same rows, every sphere of infinite radius (a warp
                 reaches every group: the group tests never skip);
  index order    the rows in index order, spheres of infinite radius;

and times each kernel on each of :func:`dense_chunks`' five 65536-ray
chunks (``surface_scene(50k, seed 13)`` and its point light at 800x800,
``chip_smoke.py``'s phase 5a) in turns, shipped, no group test, index
order, index order, no group test, shipped, 5 launches a turn (CUDA
events), beside the exact path's turns that each table leaves
(:func:`cull_counts`: a ray's for the top-K kernel, a warp's for the
shadow kernel). Every table must give the shipped one's outputs
bit for bit, but for a shadow product in index order, which the kernel
multiplies in another order: within rtol 1e-5 / atol 1e-6.

Run on a CUDA card from the repository root (about a minute):

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.dense_table_order
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys

import torch

CHUNK = 65536   # rays a chunk (render_pose's chunk in chip_smoke.py)
# The path-trace bench's camera (bench.py:124-128): eye and target.
EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
VIS_RTOL, VIS_ATOL = 1e-5, 1e-6
TURN_LAUNCHES = 5


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


def table_variants(dt, table) -> dict:
    """The shipped DenseTable and the two it is timed against (see the
    module's docstring), in that order."""
    def unbounded(tab):
        groups, supers = tab.groups.clone(), tab.supers.clone()
        groups[:, 3] = supers[:, 3] = math.inf   # the spheres' radii
        return dataclasses.replace(tab, groups=groups, supers=supers)

    index = torch.arange(table.rows.shape[0], device=table.rows.device)
    return {"shipped": table, "no group test": unbounded(table),
            "index order": unbounded(dt.table_in_order(table.rows, index))}


def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_tables(dt, chunks: dict, settings) -> list:
    """Each kernel on each chunk with each of :func:`table_variants`: the
    outputs checked against the shipped table's (raises on a miss), the
    times in turns, the exact path's turns per warp. One dict a chunk."""
    tables = table_variants(dt, chunks["table"])
    k, bo = chunks["k"], chunks["origins"]
    runs = [(name, False, lambda tab, o=o, d=d: dt.dense_topk(
                o, d, tab, k, settings), dict(o=o, d=d))
            for name, o, d in chunks["topk"]]
    runs += [(name, True, lambda tab, d=d, te=te, act=act: (
                 dt.dense_visibility(bo, d, te, tab, settings, act),),
              dict(o=bo, d=d, active=act, t_end=te))
             for name, d, te, act in chunks["vis"]]
    results = []
    for name, product, fn, rays in runs:
        want = fn(tables["shipped"])
        for label, tab in tables.items():
            for a, b in zip(fn(tab), want):
                if product and label == "index order":
                    torch.testing.assert_close(a, b, rtol=VIS_RTOL,
                                               atol=VIS_ATOL)
                elif not torch.equal(a, b):
                    raise RuntimeError(f"{name}: the {label} table's "
                                       f"outputs differ from the shipped")
        ms = {label: [] for label in tables}
        for label in list(tables) + list(tables)[::-1]:
            ms[label].append(_cuda_ms(lambda: fn(tables[label]),
                                      TURN_LAUNCHES))
        counts = {label: cull_counts(dt, rays["o"], rays["d"], tab,
                                     settings, rays.get("active"),
                                     rays.get("t_end"), supers=not product)
                  for label, tab in tables.items()}
        # The top-K kernel's exact-path turns a ray (32 kept rows a turn);
        # the shadow kernel's a (warp, row) pair.
        results.append(dict(name=name, rays=rays["o"].shape[0], ms=ms,
                            turns={label: c["exact_turns"] / c["live"]
                                   if not product else c["turns"] / c["warps"]
                                   for label, c in counts.items()}))
    return results


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("dense_table_order: needs a CUDA card", file=sys.stderr)
        return 2
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings, make_punctual_lights,
    )
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
    from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    build.load()
    scene = surface_scene(50_000, seed=13)
    light = make_punctual_lights(position=[[0.6, 0.9, -0.4]],
                                 intensity=[4.0], color=[[1.0, 0.95, 0.85]],
                                 light_type=[0])
    cam = Camera(c2w=look_at(EYE, TARGET), fov_y_deg=60.0, width=800,
                 height=800)
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    chunks = dense_chunks(dense_trace, scene, light, cam, settings)
    for res in compare_tables(dense_trace, chunks, settings):
        topk = "rays" in res["name"]
        kernel = "dense_topk" if topk else "dense_visibility"
        print(f"{kernel}, {res['name']}, R={res['rays']}: " + "; ".join(
            f"{label} {', '.join(f'{t:.3f}' for t in ms)} ms, exact-path "
            + (f"turns {res['turns'][label]:.2f} a ray" if topk else
               f"turns {res['turns'][label]:.4%} of (warp, row) pairs")
            for label, ms in res["ms"].items())
            + f" (in turns, {TURN_LAUNCHES} launches a turn, CUDA events; "
            f"outputs equal; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
