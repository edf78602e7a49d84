"""K3 and K4, the grid march kernels, of several checkouts timed in turns on
one card, on the shapes the main paths give them.

Each checkout is a directory holding a
``pathtracer_gaussiansplatting_tpu_torch`` package: the repository itself
(``.``), or another commit's files unpacked into a gitignored directory
(``git archive <commit> pathtracer_gaussiansplatting_tpu_torch | tar -x
-C _archive/<name>``).
For each checkout in turn, forwards then backwards (A B C C B A), a worker
process with that checkout first on its path builds the checkout's
kernels, makes the inputs with the checkout's own code and times its
``march_kernel`` (CUDA events, ``--iters`` launches a shape) at each Kc of
``--kcs`` on ``surface_scene(500k, seed 13)``'s grid (built at that Kc,
budget 16e9 B) on:

  6b's chunks (``grid_march_lanes.march_chunks``: 65536 bounce rays and
  65536 shadow segments to the emissive panel from the 1080p primary hit
  of the path-trace bench's camera), on the default schedule clipped to
  192 occupied cells;
  at each Kc of ``--pose-kcs``, 6e's and 14e's first bounce trace and
  first shadow march (the first ``march_kernel`` call of each kind in one
  sample of ``make_tiled_pose_renderer`` with grid bounces at
  ``toroidal_c2w(123, 20, 2.5, 0.3)``, 800x800, fov 45: 640000 rays).

Kc = 32 and 64 run the register instantiations, Kc above 128 the wide
ones. Every checkout must give the same outputs on every shape, bit for
bit (a digest of trans, sums and frozen); the script prints each time
beside each checkout's other turns and exits 1 where the outputs differ.

Run on a CUDA card from the repository root (each worker ~1-2 min):

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.grid_march_turns \\
        --checkouts _archive/parent .
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

GRID_MAX_STEPS = 192   # render/pipeline.make_trace_backend's default
BUDGET = 16e9          # chip_smoke.py's WIDE_BUDGET: the Kc=256 tables fit
EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)   # the bench's camera
POSE = (123.0, 20.0, 2.5, 0.3)                      # bench.py's capture pose


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


def worker(checkout: str, kcs, pose_kcs, iters: int) -> None:
    """Times the checkout's march kernels on every shape; prints one JSON
    line a shape."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import pathtracer_gaussiansplatting_tpu_torch as pkg
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
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
    from pathtracer_gaussiansplatting_tpu_torch.tools.grid_march_lanes import (
        march_chunks,
    )

    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported the package from {where}, not "
                           f"{checkout}")
    build.load()
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene = surface_scene(500_000, seed=13)
    cam = Camera(c2w=look_at(EYE, TARGET), fov_y_deg=60.0, width=1920,
                 height=1080)
    with torch.no_grad():
        chunks = march_chunks(scene, cam, settings, BinningConfig())[:2]
    rounds = gt.clip_schedule(gt.DEFAULT_SCHEDULE, GRID_MAX_STEPS)
    for kc in kcs:
        accel = gt.build_grid_accel(scene, max_per_cell=kc,
                                    memory_budget_bytes=BUDGET)
        shapes = [(f"6b {name}", (accel, o, d, settings, rounds),
                   dict(kw, with_features="t_end" not in kw))
                  for name, o, d, kw in chunks]
        if kc in pose_kcs:
            shapes += _pose_marches(gm, capture, scene, settings, accel)
        for name, args, kw in shapes:
            with torch.no_grad():
                got = gm.march_kernel(*args, **kw)
                torch.cuda.synchronize()
                digest = hashlib.sha256(b"".join(
                    x.cpu().numpy().tobytes() for x in got
                    if x is not None)).hexdigest()[:16]
                ms = _cuda_ms(torch, lambda: gm.march_kernel(*args, **kw),
                              iters)
            print(json.dumps(dict(checkout=checkout, shape=name, kc=kc,
                                  rays=int(args[1].shape[0]), ms=ms,
                                  digest=digest)), flush=True)
        del accel, shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkouts", nargs="+", default=["."])
    ap.add_argument("--kcs", default="32,64,144,256")
    ap.add_argument("--pose-kcs", default="32,256")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kcs = [int(k) for k in args.kcs.split(",")]
    pose_kcs = [int(k) for k in args.pose_kcs.split(",") if k]
    if args.worker:
        worker(args.worker, kcs, pose_kcs, args.iters)
        return 0
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = {}
    for checkout in args.checkouts + args.checkouts[::-1]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", checkout,
             "--kcs", args.kcs, "--pose-kcs", args.pose_kcs,
             "--iters", str(args.iters)],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], flush=True)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs.setdefault((r["shape"], r["kc"]), {}).setdefault(
                    checkout, []).append(r)
    same = True
    for (shape, kc), by in runs.items():
        digests = {r["digest"] for rs in by.values() for r in rs}
        same &= len(digests) == 1
        rays = next(iter(by.values()))[0]["rays"]
        print(f"{shape}, R={rays}, Kc={kc}: " + "; ".join(
            f"{c} {', '.join(f'{r['ms']:.3f}' for r in rs)} ms"
            for c, rs in by.items())
            + f" (in turns, {args.iters} launches a turn, CUDA events; "
            f"outputs {'equal' if len(digests) == 1 else 'DIFFER'}; "
            f"{card})", flush=True)
    # Where no cell overflows the narrower Kc, two wide Kc hold the same
    # Gaussians a cell and give the same bits.
    for shape in dict.fromkeys(s for s, _ in runs):
        by_kc = {kc: {r["digest"] for rs in by.values() for r in rs}
                 for (s, kc), by in runs.items() if s == shape and kc > 128}
        if len(by_kc) > 1:
            equal = len(set.union(*by_kc.values())) == 1
            print(f"{shape}: Kc={', '.join(map(str, by_kc))} outputs "
                  f"{'equal' if equal else 'differ'}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
