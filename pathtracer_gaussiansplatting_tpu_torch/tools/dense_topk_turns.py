"""K1, the dense top-K kernel, of several checkouts timed in turns on one
card, on the shapes the main paths give it.

Each checkout is a directory holding a
``pathtracer_gaussiansplatting_tpu_torch`` package: the repository itself
(``.``), or another commit's files unpacked into a gitignored directory
(``git archive <commit> pathtracer_gaussiansplatting_tpu_torch | tar -x
-C _archive/<name>``).
For each checkout in turn, forwards then backwards (A B C C B A), a worker
process with that checkout first on its path builds the checkout's
kernels, makes the inputs with the checkout's own code and times its
``dense_topk`` (CUDA events, ``--iters`` launches a shape) on:

  5a's chunks (``dense_table_order.dense_chunks``: 65536 primary, bounce
  and thin-far rays of ``surface_scene(50k)`` at 800x800) at each K of
  ``--ks``, and its first 4 x 65536 primary rays in one launch, at K=64;
  the tiled route's first bounce trace (5d: the first ``dense_topk`` call
  of one sample of ``make_tiled_pose_renderer``, 640000 rays), at the
  dense default K=64;
  11a's reverse-key launch (4096 rays of a 64x64 tile of a 4K frame
  through ``random_cloud(2M)`` in one slab, K=64, ordered by minus the
  means' projection on the slab axis).

Every checkout must give the same outputs on every shape, bit for bit (a
digest of idx, t and alpha); the script prints each time beside each
checkout's other turns and exits 1 where the outputs differ.

Run on a CUDA card from the repository root (each worker ~20-40 s):

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.dense_topk_turns \\
        --checkouts _archive/parent .
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

CHUNK = 65536
EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)   # 5a's camera
DENSE_K = 64   # RenderSettings' max_contribs default
# 11a (chip_smoke.py): a SLAB_TILE x SLAB_TILE tile at the center of a 4K
# frame through random_cloud(SLAB_N, spread 2) in one slab.
SLAB_N, SLAB_TILE, SLAB_FRAME = 2_000_000, 64, (3840, 2160)


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


def _shapes(ks) -> list:
    """(name, K, args of dense_topk) of every shape, made by the package
    first on sys.path."""
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
    from pathtracer_gaussiansplatting_tpu_torch.tools import (
        dense_table_order as dto,
    )

    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene = surface_scene(50_000, seed=13)
    light = make_punctual_lights(position=[[0.6, 0.9, -0.4]],
                                 intensity=[4.0], color=[[1.0, 0.95, 0.85]],
                                 light_type=[0])
    cam = Camera(c2w=look_at(EYE, TARGET), fov_y_deg=60.0, width=800,
                 height=800)
    ch = dto.dense_chunks(dt, scene, light, cam, settings, CHUNK)
    table = ch["table"]
    out = [(f"5a {name}", k, (o, d, table, k, settings))
           for k in ks for name, o, d in ch["topk"]]
    out.append(("5a four chunks", DENSE_K,
                (*ch["wide"], table, DENSE_K, settings)))

    # 5d: the tiled route's first bounce trace, as the renderer calls it.
    calls, plain = [], dt.dense_topk

    def first(*args, **kw):
        if not calls:
            calls.append((args, kw))
        return plain(*args, **kw)

    dt.dense_topk = first
    try:
        with torch.no_grad():
            capture.make_tiled_pose_renderer(
                scene, settings, light, 1, bounce_backend="dense")(
                cam.c2w, cam.width, cam.height, cam.fov_y_deg)
    finally:
        dt.dense_topk = plain
    (args, kw), = calls
    bound = inspect.signature(plain).bind(*args, **kw)
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
    return out


def worker(checkout: str, ks, iters: int) -> None:
    """Times the checkout's dense_topk on every shape; prints one JSON line
    a shape."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    import pathtracer_gaussiansplatting_tpu_torch as pkg
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        dense_trace as dt,
    )

    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported the package from {where}, not "
                           f"{checkout}")
    build.load()
    for name, k, args in _shapes(ks):
        with torch.no_grad():
            got = dt.dense_topk(*args)
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                x.cpu().numpy().tobytes() for x in got)).hexdigest()[:16]
            ms = _cuda_ms(torch, lambda: dt.dense_topk(*args), iters)
        print(json.dumps(dict(checkout=checkout, shape=name, k=k,
                              rays=int(args[0].shape[0]), ms=ms,
                              digest=digest)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkouts", nargs="+", default=["."])
    ap.add_argument("--ks", default="64,256")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]
    if args.worker:
        worker(args.worker, ks, args.iters)
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
             "--ks", args.ks, "--iters", str(args.iters)],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr[-4000:], flush=True)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs.setdefault((r["shape"], r["k"]), {}).setdefault(
                    checkout, []).append(r)
    same = True
    for (shape, k), by in runs.items():
        digests = {r["digest"] for rs in by.values() for r in rs}
        same &= len(digests) == 1
        rays = next(iter(by.values()))[0]["rays"]
        print(f"{shape}, R={rays}, K={k}: " + "; ".join(
            f"{c} {', '.join(f'{r['ms']:.3f}' for r in rs)} ms"
            for c, rs in by.items())
            + f" (in turns, {args.iters} launches a turn, CUDA events; "
            f"outputs {'equal' if len(digests) == 1 else 'DIFFER'}; "
            f"{card})", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
