"""One hand kernel of several checkouts timed in turns on one card, on the
shapes the main paths give it.

Each checkout is a directory holding a
``pathtracer_gaussiansplatting_tpu_torch`` package: the repository itself
(``.``), or another commit's files unpacked into a gitignored directory
(``git archive <commit> pathtracer_gaussiansplatting_tpu_torch | tar -x
-C _archive/<name>``).
For each checkout in turn, forwards then backwards (A B C C B A), a worker
process with that checkout first on its path builds the checkout's
kernels, makes the inputs with the checkout's own code (the ray chunks by
``tools/chunks.py`` beside this file, which calls the checkout's package)
and times the kernel that ``--kernel`` names (CUDA events, ``--iters``
launches a shape):

  dense_topk: K1, ``dense_topk``, on 5a's chunks (``chunks.dense_chunks``:
  65536 primary, bounce and thin-far rays of ``surface_scene(50k)`` at
  800x800) at each K of ``--ks``, and its first 4 x 65536 primary rays in
  one launch, at K=64; the tiled route's first bounce trace (5d: the first
  ``dense_topk`` call of one sample of ``make_tiled_pose_renderer``,
  640000 rays), at the dense default K=64; 11a's reverse-key launch (4096
  rays of a 64x64 tile of a 4K frame through ``random_cloud(2M)`` in one
  slab, K=64, ordered by minus the means' projection on the slab axis).

  grid_march: K3 and K4, ``march_kernel``, at each Kc of ``--kcs`` on
  ``surface_scene(500k, seed 13)``'s grid (built at that Kc, budget 16e9
  B): 6b's chunks (``chunks.march_chunks``: 65536 bounce rays and 65536
  shadow segments to the emissive panel from the 1080p primary hit of the
  path-trace bench's camera) on the default schedule clipped to 192
  occupied cells; at each Kc of ``--pose-kcs``, 6e's and 14e's first
  bounce trace and first shadow march (the first ``march_kernel`` call of
  each kind in one sample of ``make_tiled_pose_renderer`` with grid
  bounces at ``toroidal_c2w(123, 20, 2.5, 0.3)``, 800x800, fov 45: 640000
  rays). Kc = 32 and 64 run the register instantiations, Kc above 128 the
  wide ones.

  tile_any: the tile composite kernels at each tile size of
  ``--tile-sizes`` (sizes other than 8 and 16 take the any-P kernels) on
  the headline's packets: ``random_cloud(1M, seed 13, spread 1.5)`` at
  800x800, fov 50, from (0, 0.5, 4), K=256, jittered by
  ``subpixel_jitter(prng_key(13), ..., 0)``; the forward at the default
  settings and at transmittance_min = 0, the backward at the default
  settings on a seeded cotangent (numpy seed 17; the depth cotangent
  masked where the forward's alpha_acc is at or below 1e-3), without
  d_dirs (training's) and with it; each beside the shape's bound
  (``bench.tile_bounds``, the first worker's) and the kernel path
  (``tile_composite.any_p_plan``).

Every checkout must give the same outputs on every shape, bit for bit (a
digest of each output's bytes); the script prints each time beside each
checkout's other turns and exits 1 where the outputs differ.

Run on a CUDA card from the repository root (each worker ~20 s to 2 min):

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.turns \\
        --kernel dense_topk --checkouts _archive/parent .
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)   # 5a's camera, the bench's
DENSE_K = 64   # RenderSettings' max_contribs default
# 11a (chip_smoke.py): a SLAB_TILE x SLAB_TILE tile at the center of a 4K
# frame through random_cloud(SLAB_N, spread 2) in one slab.
SLAB_N, SLAB_TILE, SLAB_FRAME = 2_000_000, 64, (3840, 2160)
GRID_MAX_STEPS = 192   # render/pipeline.make_trace_backend's default
BUDGET = 16e9          # chip_smoke.py's WIDE_BUDGET: the Kc=256 tables fit
POSE = (123.0, 20.0, 2.5, 0.3)                      # bench.py's capture pose
ITERS = dict(dense_topk=5, grid_march=5, tile_any=10)  # --iters' defaults


def _cuda_ms(torch, fn, iters: int) -> float:
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


def _digest(xs) -> str:
    return hashlib.sha256(b"".join(
        x.detach().cpu().numpy().tobytes() for x in xs
        if x is not None)).hexdigest()[:16]


def _chunks():
    """``tools/chunks.py`` beside this file; its functions call the package
    first on sys.path (a checkout from before the module existed too)."""
    spec = importlib.util.spec_from_file_location(
        "turns_chunks", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "chunks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dense_topk_shapes(args):
    """(record, fn) of every K1 shape."""
    import torch
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings, Rays, make_punctual_lights,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        dense_trace as dt,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud, surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial

    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene = surface_scene(50_000, seed=13)
    light = make_punctual_lights(position=[[0.6, 0.9, -0.4]],
                                 intensity=[4.0], color=[[1.0, 0.95, 0.85]],
                                 light_type=[0])
    cam = Camera(c2w=look_at(EYE, TARGET), fov_y_deg=60.0, width=800,
                 height=800)
    ch = _chunks().dense_chunks(dt, scene, light, cam, settings)
    table = ch["table"]
    out = [(f"5a {name}", k, (o, d, table, k, settings))
           for k in [int(k) for k in args.ks.split(",")]
           for name, o, d in ch["topk"]]
    out.append(("5a four chunks", DENSE_K,
                (*ch["wide"], table, DENSE_K, settings)))

    # 5d: the tiled route's first bounce trace, as the renderer calls it.
    calls, plain = [], dt.dense_topk

    def first(*a, **kw):
        if not calls:
            calls.append((a, kw))
        return plain(*a, **kw)

    dt.dense_topk = first
    try:
        with torch.no_grad():
            capture.make_tiled_pose_renderer(
                scene, settings, light, 1, bounce_backend="dense")(
                cam.c2w, cam.width, cam.height, cam.fov_y_deg)
    finally:
        dt.dense_topk = plain
    (a, kw), = calls
    bound = inspect.signature(plain).bind(*a, **kw)
    bound.apply_defaults()
    out.append(("5d first trace", bound.arguments["k"],
                tuple(bound.arguments.values())))
    del ch

    # 11a: the slab's reverse-key launch.
    slabbed, axis = spatial.partition_slabs(
        random_cloud(SLAB_N, seed=13, spread=2.0), 1)
    w, h = SLAB_FRAME
    full = generate_rays(Camera(c2w=look_at((0.0, 0.5, 6.0), (0.0, 0.0, 0.0)),
                                fov_y_deg=50.0, width=w, height=h))
    rows = torch.arange(h // 2 - SLAB_TILE // 2, h // 2 + SLAB_TILE // 2,
                        device=full.origins.device)
    cols = torch.arange(w // 2 - SLAB_TILE // 2, w // 2 + SLAB_TILE // 2,
                        device=rows.device)
    sel = (rows[:, None] * w + cols[None]).reshape(-1)
    rays = Rays(full.origins[sel].contiguous(),
                full.directions[sel].contiguous())
    del full
    st = RenderSettings(max_contribs=DENSE_K)
    axis_t = torch.as_tensor(axis, device=rays.origins.device)
    proj = slabbed.means @ axis_t
    fwd = torch.sum(rays.directions * axis_t[None], dim=-1) >= 0.0
    slab = dt.dense_table(dt.gaussian_table(slabbed, st))
    out.append(("11a reverse key", DENSE_K,
                (rays.origins, rays.directions, slab, DENSE_K, st, -proj,
                 ~fwd)))
    for name, k, a in out:
        yield (dict(label=f"{name}, R={int(a[0].shape[0])}, K={k}"),
               lambda a=a: dt.dense_topk(*a))


def _pose_marches(gm, capture, scene, settings, accel) -> list:
    """(name, args, keywords) of the first bounce trace and the first shadow
    march of one capture-pose sample on ``accel`` (tensors cloned)."""
    import torch
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        toroidal_c2w,
    )

    calls, plain = {}, gm.march_kernel

    def first(*args, **kw):
        feat = kw.get("with_features", True)
        if feat not in calls:
            calls[feat] = tuple(
                x.clone() if torch.is_tensor(x) else x
                for x in args), {k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in kw.items()}
        return plain(*args, **kw)

    gm.march_kernel = first
    try:
        with torch.no_grad():
            capture.make_tiled_pose_renderer(
                scene, settings, None, 1, bounce_backend="grid",
                accel=accel)(toroidal_c2w(*POSE), 800, 800, 45.0)
    finally:
        gm.march_kernel = plain
    return [(f"pose {'first trace' if feat else 'first shadow march'}",
             *calls[feat]) for feat in (True, False)]


def grid_march_shapes(args):
    """(record, fn) of every K3 / K4 shape, Kc by Kc."""
    import torch
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        grid_march as gm,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as gt

    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene = surface_scene(500_000, seed=13)
    cam = Camera(c2w=look_at(EYE, TARGET), fov_y_deg=60.0, width=1920,
                 height=1080)
    with torch.no_grad():
        chunks = _chunks().march_chunks(scene, cam, settings,
                                        BinningConfig())[:2]
    rounds = gt.clip_schedule(gt.DEFAULT_SCHEDULE, GRID_MAX_STEPS)
    pose_kcs = [int(k) for k in args.pose_kcs.split(",") if k]
    for kc in [int(k) for k in args.kcs.split(",")]:
        accel = gt.build_grid_accel(scene, max_per_cell=kc,
                                    memory_budget_bytes=BUDGET)
        shapes = [(f"6b {name}", (accel, o, d, settings, rounds),
                   dict(kw, with_features="t_end" not in kw))
                  for name, o, d, kw in chunks]
        if kc in pose_kcs:
            shapes += _pose_marches(gm, capture, scene, settings, accel)
        for name, a, kw in shapes:
            yield (dict(label=f"{name}, R={int(a[1].shape[0])}, Kc={kc}",
                        name=name, kc=kc),
                   lambda a=a, kw=kw: gm.march_kernel(*a, **kw))
        del accel, shapes


def tile_any_shapes(args):
    """(record, fn) of every tile shape, tile size by tile size; first each
    size's inputs (fn None, their digest in the record)."""
    import numpy as np
    import torch
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        tile_composite as tc,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles,
    )

    dev = torch.device("cuda", 0)
    scene = random_cloud(1_000_000, seed=13, spread=1.5, device=dev)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=800, height=800)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    full = dataclasses.replace(settings, transmittance_min=0.0)
    jitter = rng.subpixel_jitter(rng.prng_key(13), cam.height, cam.width, 0,
                                 device=dev)
    for ts in [int(t) for t in args.tile_sizes.split(",")]:
        cfg = BinningConfig(max_per_tile=256, tile_size=ts)
        with torch.no_grad():
            prepared = prepare_tiles(scene, cam, settings, cfg)
            packets = {k: prepared[k] for k in ("geom", "featsT", "count")}
            dirs, _ = _tile_dirs(cam, cfg, jitter)
        t_total, p, _ = dirs.shape
        alpha_acc = tc.tile_composite(packets, dirs, settings)[1]
        r = np.random.default_rng(17)

        def normal(*shape):
            return torch.from_numpy(
                r.standard_normal(shape, dtype=np.float32)).to(dev)

        cot = (normal(t_total, p, tc.FEATURE_DIM), normal(t_total, p),
               normal(t_total, p) * (alpha_acc > 1e-3))
        bnds = {}
        if args.bounds:
            bnds = {name: bench.tile_bounds(packets, dirs, st)
                    for name, st in (("default", settings), ("full", full))}
        head = f"tile {ts} (T={t_total}, P={p})"
        yield dict(label=f"{head} inputs", digest=_digest(
            [packets["geom"], packets["featsT"], packets["count"], dirs]
            + list(cot))), None
        shapes = [
            ("fwd", "default", lambda: tc.tile_composite(packets, dirs,
                                                         settings)),
            ("fwd", "full", lambda: tc.tile_composite(packets, dirs, full)),
            ("bwd", "default", lambda: tc.tile_composite_bwd(
                packets, dirs, cot, settings, want_dirs=False)),
            ("bwd_dirs", "default", lambda: tc.tile_composite_bwd(
                packets, dirs, cot, settings, want_dirs=True)),
        ]
        for kind, st, fn in shapes:
            bnd = bnds.get(st, {}).get("bwd" if kind.startswith("bwd")
                                       else "fwd", {})
            yield dict(label=f"{head} {kind} {st}",
                       path=tc.any_p_plan(p)[0],
                       bound_ms=bnd.get("bound_ms"),
                       function_bound_ms=bnd.get("function_bound_ms")), fn
        del prepared, packets, dirs, cot, alpha_acc


SHAPES = dict(dense_topk=dense_topk_shapes, grid_march=grid_march_shapes,
              tile_any=tile_any_shapes)


def worker(checkout: str, args) -> None:
    """Times the checkout's kernel on every shape; prints one JSON line a
    shape."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import pathtracer_gaussiansplatting_tpu_torch as pkg
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build

    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported the package from {where}, not "
                           f"{checkout}")
    build.load()
    for rec, fn in SHAPES[args.kernel](args):
        if fn is not None:
            with torch.no_grad():
                got = fn()
                torch.cuda.synchronize()
                rec.update(digest=_digest(got),
                           ms=_cuda_ms(torch, fn, args.iters))
        print(json.dumps(dict(rec, checkout=checkout)), flush=True)


def _report(runs: dict, iters: int, card: str) -> bool:
    """Prints each shape's turns; whether every shape's outputs agree."""
    same = True
    for label, by in runs.items():
        digests = {r["digest"] for rs in by.values() for r in rs}
        same &= len(digests) == 1
        outputs = "equal" if len(digests) == 1 else "DIFFER"
        recs = [r for rs in by.values() for r in rs]
        if "ms" not in recs[0]:
            print(f"{label}: {outputs} between the checkouts", flush=True)
            continue
        bnd = next((r["bound_ms"] for r in recs
                    if r.get("bound_ms") is not None), None)
        fn_bnd = next((r["function_bound_ms"] for r in recs
                       if r.get("function_bound_ms") is not None), None)
        parts = []
        for c, rs in by.items():
            share = "" if bnd is None else \
                f" ({bnd / min(r['ms'] for r in rs):.1%} of the bound)"
            path = f", path {rs[0]['path']}" if "path" in rs[0] else ""
            parts.append(f"{c} {', '.join(f'{r['ms']:.4f}' for r in rs)} "
                         f"ms{share}{path}")
        print(f"{label}: " + "; ".join(parts)
              + ("" if bnd is None else
                 f"; bound {bnd:.4f} ms, the function's {fn_bnd:.4f} ms")
              + f" (in turns, {iters} launches a turn, CUDA events; "
              f"outputs {outputs}; {card})", flush=True)
    return same


def _wide_kcs(runs: dict) -> None:
    """Where no cell overflows the narrower Kc, two wide Kc hold the same
    Gaussians a cell and give the same bits: prints whether they do."""
    recs = [r for by in runs.values() for rs in by.values() for r in rs]
    for name in dict.fromkeys(r["name"] for r in recs):
        by_kc = {}
        for r in recs:
            if r["name"] == name and r["kc"] > 128:
                by_kc.setdefault(r["kc"], set()).add(r["digest"])
        if len(by_kc) > 1:
            equal = len(set.union(*by_kc.values())) == 1
            print(f"{name}: Kc={', '.join(map(str, by_kc))} outputs "
                  f"{'equal' if equal else 'differ'}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(SHAPES))
    ap.add_argument("--checkouts", nargs="+", default=["."])
    ap.add_argument("--iters", type=int, default=None,
                    help=f"launches a turn (default {ITERS})")
    ap.add_argument("--ks", default="64,256", help="dense_topk's K")
    ap.add_argument("--kcs", default="32,64,144,256", help="grid_march's Kc")
    ap.add_argument("--pose-kcs", default="32,256",
                    help="grid_march's Kc of the capture pose's marches")
    ap.add_argument("--tile-sizes", default="12,24,32,48",
                    help="tile_any's tile sizes")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--bounds", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.iters = args.iters or ITERS[args.kernel]
    if args.worker:
        worker(args.worker, args)
        return 0
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = {}
    for i, checkout in enumerate(args.checkouts + args.checkouts[::-1]):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", checkout,
             "--kernel", args.kernel, "--iters", str(args.iters),
             "--ks", args.ks, "--kcs", args.kcs, "--pose-kcs", args.pose_kcs,
             "--tile-sizes", args.tile_sizes]
            + (["--bounds"] if i == 0 else []),
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], flush=True)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs.setdefault(r["label"], {}).setdefault(
                    checkout, []).append(r)
    same = _report(runs, args.iters, card)
    if args.kernel == "grid_march":
        _wide_kcs(runs)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
