"""The any-P tile composite kernels (tile sizes other than 8 and 16) of
several checkouts timed in turns on one card, on the headline's packets.

Each checkout is a directory holding a
``pathtracer_gaussiansplatting_tpu_torch`` package: the repository itself
(``.``), or another commit's files unpacked into a gitignored directory
(``git archive <commit> pathtracer_gaussiansplatting_tpu_torch | tar -x
-C _archive/<name>``).
For each checkout in turn, forwards then backwards (A B B A), a worker
process with that checkout first on its path builds the checkout's
kernels, makes the inputs with the checkout's own code and times them
(CUDA events, ``--iters`` launches a shape) at each tile size of
``--tile-sizes`` on the headline's packets: ``random_cloud(1M, seed 13,
spread 1.5)`` at 800x800, fov 50, from (0, 0.5, 4), K=256, jittered by
``subpixel_jitter(prng_key(13), ..., 0)``:

  the forward at the default settings and at transmittance_min = 0;
  the backward at the default settings on a seeded cotangent (numpy seed
  17; the depth cotangent masked where the forward's alpha_acc is at or
  below 1e-3), without d_dirs (training's) and with it.

Every checkout must give the same outputs on every shape, bit for bit (a
digest of each output's bytes); the script prints each time beside each
checkout's other turns and the shape's bound (``bench.tile_bounds``, the
first worker's), the launches by kernel path where the checkout counts
them, and exits 1 where the outputs differ.

Run on a CUDA card from the repository root (each worker ~30-60 s):

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.tile_any_turns \\
        --checkouts _archive/parent .
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

COUNTERS = ("LAUNCHES", "ANY_LAUNCHES", "ANY_GROUP_LAUNCHES", "BWD_LAUNCHES",
            "BWD_ANY_LAUNCHES", "BWD_ANY_GROUP_LAUNCHES")


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


def worker(checkout: str, tile_sizes, iters: int, bounds: bool) -> None:
    """Times the checkout's tile kernels on every shape; prints one JSON
    line a shape."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch
    import pathtracer_gaussiansplatting_tpu_torch as pkg
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
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

    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported the package from {where}, not "
                           f"{checkout}")
    build.load()
    dev = torch.device("cuda", 0)
    scene = random_cloud(1_000_000, seed=13, spread=1.5, device=dev)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=800, height=800)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    full = dataclasses.replace(settings, transmittance_min=0.0)
    jitter = rng.subpixel_jitter(rng.prng_key(13), cam.height, cam.width, 0,
                                 device=dev)

    def counts():
        return {n: getattr(tc, n) for n in COUNTERS if hasattr(tc, n)}

    for ts in tile_sizes:
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
        if bounds:
            bnds = {name: bench.tile_bounds(packets, dirs, st)
                    for name, st in (("default", settings), ("full", full))}
        shapes = [
            ("fwd", "default", lambda: tc.tile_composite(packets, dirs,
                                                         settings)),
            ("fwd", "full", lambda: tc.tile_composite(packets, dirs, full)),
            ("bwd", "default", lambda: tc.tile_composite_bwd(
                packets, dirs, cot, settings, want_dirs=False)),
            ("bwd_dirs", "default", lambda: tc.tile_composite_bwd(
                packets, dirs, cot, settings, want_dirs=True)),
        ]
        print(json.dumps(dict(checkout=checkout, tile=ts, shape="inputs",
                              t=t_total, p=p, digest=_digest(
                                  [packets["geom"], packets["featsT"],
                                   packets["count"], dirs] + list(cot)))),
              flush=True)
        for kind, st, fn in shapes:
            before = counts()
            with torch.no_grad():
                got = fn()
            torch.cuda.synchronize()
            launched = {n: v - before[n] for n, v in counts().items()
                        if v != before[n]}
            ms = _cuda_ms(torch, fn, iters)
            bnd = bnds.get(st, {}).get("bwd" if kind.startswith("bwd")
                                       else "fwd", {})
            print(json.dumps(dict(
                checkout=checkout, tile=ts, shape=f"{kind} {st}", t=t_total,
                p=p, ms=ms, digest=_digest(got), launched=launched,
                bound_ms=bnd.get("bound_ms"),
                function_bound_ms=bnd.get("function_bound_ms"))),
                flush=True)
        del prepared, packets, dirs, cot, alpha_acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkouts", nargs="+", default=["."])
    ap.add_argument("--tile-sizes", default="12,24,32,48")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--bounds", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    tile_sizes = [int(t) for t in args.tile_sizes.split(",")]
    if args.worker:
        worker(args.worker, tile_sizes, args.iters, args.bounds)
        return 0
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = {}
    order = args.checkouts + args.checkouts[::-1]
    for i, checkout in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", checkout,
             "--tile-sizes", args.tile_sizes, "--iters", str(args.iters)]
            + (["--bounds"] if i == 0 else []),
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], flush=True)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs.setdefault((r["tile"], r["shape"]), {}).setdefault(
                    checkout, []).append(r)
    same = True
    for (tile, shape), by in runs.items():
        digests = {r["digest"] for rs in by.values() for r in rs}
        same &= len(digests) == 1
        first = next(iter(by.values()))[0]
        head = f"tile {tile} (T={first['t']}, P={first['p']}) {shape}"
        if shape == "inputs":
            print(f"{head}: {'equal' if len(digests) == 1 else 'DIFFER'} "
                  "between the checkouts", flush=True)
            continue
        bnd = next((r["bound_ms"] for rs in by.values() for r in rs
                    if r["bound_ms"] is not None), None)
        fn_bnd = next((r["function_bound_ms"] for rs in by.values()
                       for r in rs if r["function_bound_ms"] is not None),
                      None)
        parts = []
        for c, rs in by.items():
            times = ", ".join(f"{r['ms']:.4f}" for r in rs)
            share = "" if bnd is None else \
                f" ({bnd / min(r['ms'] for r in rs):.1%} of the bound)"
            parts.append(f"{c} {times} ms{share}, launched {rs[0]['launched']}")
        print(f"{head}: " + "; ".join(parts)
              + ("" if bnd is None else
                 f"; bound {bnd:.4f} ms, the function's {fn_bnd:.4f} ms")
              + f" (in turns, {args.iters} launches a turn, CUDA events; "
              f"outputs {'equal' if len(digests) == 1 else 'DIFFER'}; "
              f"{card})", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
