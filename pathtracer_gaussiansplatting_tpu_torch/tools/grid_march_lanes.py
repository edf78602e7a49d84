"""Lanes a ray in the grid march kernels: each kernel timed against itself
built with the lanes swapped.

``csrc/grid_march.cu`` gives a feature trace (``ptgs_grid_trace``) a warp
per ray and a shadow segment (``ptgs_grid_visibility``) half a warp, as the
compile-time constants ``kTraceLanes`` and ``kVisLanes``. This script
compiles a second copy of that source with the two swapped (a trace on 16
lanes, a segment on 32) and times both builds in turns, shipped, swapped,
swapped, shipped, 5 launches a turn (CUDA events), on the same rays: the
65536 bounce rays and 65536 shadow segments of :func:`march_chunks` (the
1080p primary hit of ``surface_scene(500k, seed 13)`` on its Kc=32 grid,
``chip_smoke.py``'s phase 6b), and the same rays ``--reps`` times over (32
by default: 2097152 rays, about one launch of a 1080p sample). Both builds
must give the same trans and frozen rays and, for a trace, sums within
rtol 1e-5 / atol 1e-6: the lanes change only the order of the sums.

Run on a CUDA card from the repository root:

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.grid_march_lanes [--reps N]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

# The shipped constants' lines and their swapped values.
SWAP = (("kTraceLanes = 32;", "kTraceLanes = 16;"),
        ("kVisLanes = 16;", "kVisLanes = 32;"))
CHUNK = 65536         # rays a chunk
MAX_STEPS = 192       # render/pipeline.make_trace_backend's default
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6


def swapped_source(text: str) -> str:
    """``grid_march.cu``'s text with the lanes a ray swapped (``SWAP``);
    ValueError unless each constant's line occurs exactly once."""
    for old, new in SWAP:
        if text.count(old) != 1:
            raise ValueError(f"grid_march.cu: {old!r} occurs "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_swapped():
    """Compile the swapped copy with the kernels' nvcc flags into the build
    directory: (the library's path, nvcc's output with ptxas's report)."""
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "grid_march_lanes_swapped.cu"
    src.write_text(swapped_source((build.CSRC_DIR / "grid_march.cu")
                                  .read_text()))
    lib = src.with_suffix(".so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
           "-shared", "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True,
                         env=dict(os.environ, TMPDIR=str(build.BUILD_DIR)))
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode} on the "
                           f"swapped copy:\n{out[-4000:]}")
    return lib, out


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


def compare_lanes(accel, settings, chunks, lib, reps: int) -> list:
    """Each chunk's kernel, shipped and swapped (``lib``), in turns on the
    chunk and on it ``reps`` times over; raises where the outputs differ.
    One dict per (chunk, size): the lanes of each build and its times."""
    from pathtracer_gaussiansplatting_tpu_torch.kernels import grid_march
    from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace

    alt = ctypes.CDLL(str(lib))
    shipped = grid_march._kernel_fn

    def alt_fn(name, argtypes):
        fn = getattr(alt, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    results = []
    for name, o, d, kw in chunks:
        feat = "t_end" not in kw
        lanes = (32, 16) if feat else (16, 32)  # shipped, swapped
        for k in (1, reps):
            def rep(x):
                return x.repeat(k, *([1] * (x.dim() - 1)))
            ro, rd, rkw = rep(o), rep(d), {n: rep(v) for n, v in kw.items()}

            def run():
                return grid_trace.march(accel, ro, rd, settings, MAX_STEPS,
                                        with_features=feat, **rkw)
            out, ms = {}, {False: [], True: []}
            try:
                for swapped in (False, True, True, False):
                    grid_march._kernel_fn = alt_fn if swapped else shipped
                    out[swapped] = run()
                    ms[swapped].append(_cuda_ms(run, 5))
            finally:
                grid_march._kernel_fn = shipped
            (ts, sums, fs), (ta, sums_a, fa) = out[False], out[True]
            if not (torch.equal(ts, ta) and torch.equal(fs, fa)):
                raise RuntimeError(f"{name}: trans or frozen rays differ at "
                                   f"{lanes[1]} lanes a ray")
            if feat:
                torch.testing.assert_close(sums_a, sums, rtol=SUM_RTOL,
                                           atol=SUM_ATOL)
            results.append(dict(name=name, rays=ro.shape[0],
                                shipped=(lanes[0], ms[False]),
                                swapped=(lanes[1], ms[True])))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=32,
                    help="times the chunks repeat in the larger run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grid_march_lanes: needs a CUDA card", file=sys.stderr)
        return 2
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    build.load()
    lib, nvcc_out = build_swapped()
    name, frame = "", ""
    for line in nvcc_out.splitlines():
        m = re.search(r"grid_march_kernelILb([01])ELi(\d+)E", line)
        if m:
            feat = "true" if m.group(1) == "1" else "false"
            name = f"grid_march_kernel<{feat}, {m.group(2)}>"
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            print(f"swapped build, {name}: "
                  f"{line.split(':', 1)[-1].strip()}; {frame}", flush=True)
    scene = surface_scene(500_000, seed=13)
    cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5)),
                 fov_y_deg=60.0, width=1920, height=1080)
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    accel = grid_trace.build_grid_accel(scene, max_per_cell=32,
                                        memory_budget_bytes=2.5e9)
    chunks = march_chunks(scene, cam, settings, BinningConfig())[:2]
    for res in compare_lanes(accel, settings, chunks, lib, args.reps):
        print(f"{res['name']}, R={res['rays']}: " + "; ".join(
            f"{lanes} lanes{' (shipped)' if which == 'shipped' else ''} "
            f"{sum(ms) / len(ms):.3f} ms ({', '.join(f'{t:.3f}' for t in ms)})"
            for which in ("shipped", "swapped")
            for lanes, ms in [res[which]])
            + f", in turns (CUDA events); trans and frozen rays equal "
            f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
