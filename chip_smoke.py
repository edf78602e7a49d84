#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py    # build, check, render; exit 0 on success

The port's hot kernel (the fused forward tile composite,
``pathtracer_gaussiansplatting_tpu_torch/csrc/tile_composite_fwd.cu``) is
built from the checkout at first use. Then:

  phase 1  the kernel against its plain PyTorch version on the card, at the
           headline pose's packets (T=2500 tiles, K=256) with jittered rays,
           and the whole slice on the card against the CPU at a small size;
  phase 2  the headline slice: random_cloud(1M, seed 13, spread 1.5),
           800x800, K=256 — one prepare_tiles, then 16 jittered samples of
           render_prepared, each accumulated; then one sample and one
           prepare_tiles under torch.profiler (tables in
           chiprun_out/chip_smoke/);
  phase 3  the primary stage at the path-trace bench's size:
           surface_scene(500k, seed 13), 1920x1080, K=512 — the kernel
           against its plain version at these shapes, then one
           prepare_tiles and 4 jittered samples; the image is written to
           chiprun_out/chip_smoke/, and one sample is profiled.

Every failure (a build error, a launch error, a tolerance miss, a
non-finite image, a kernel the main path never launched) raises and ends
the run with a non-zero exit before any result line is printed. Without
CUDA the script exits with code 2 at once. The last line printed is
{"ok": true, "device": {...}}; the line before it is the kernel table.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
KERNEL_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                 "tile_composite_fwd.cu")
KERNEL_REPLACES = ("pathtracer_gaussiansplatting_tpu/kernels/"
                   "tile_composite.py:244")
RTOL, ATOL = 1e-3, 3e-4  # the reference's kernel-vs-oracle tolerances


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(got, want, name: str, mask=None) -> float:
    """Max abs error of got vs want (rtol/atol as above); raises on a miss."""
    g, w = got.double(), want.double()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite values")
    bad = err > ATOL + RTOL * w.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
          f"rtol {RTOL} / atol {ATOL} (max abs err {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn, timed with CUDA events."""
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


def host_ms(fn):
    """(result, wall milliseconds) of fn, ended by a synchronize."""
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def profile_once(name: str, fn, wall_ms: float, card: str) -> None:
    """Run fn once under torch.profiler; log its device time against the
    unprofiled wall time and write the op table (by device time) to
    OUT_DIR."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The first traced run after start-up may miss kernel records, so the
    # second of two is kept.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    # Device-side rows only: an aten op's row repeats its kernels.
    dev_rows = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
    os.makedirs(OUT_DIR, exist_ok=True)
    table = os.path.join(OUT_DIR, f"profile_{name}.txt")
    with open(table, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total",
                              row_limit=40))
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:3]
    log(f"profile {name}: device time {dev_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall (unprofiled median) = {dev_ms / wall_ms:.1%} busy, "
        f"{sum(e.count for e in dev_rows)} kernel launches; top: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in top)
        + f"; table {os.path.relpath(table, ROOT)} ({card})")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        tile_composite as tc,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud, surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        accumulate,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles, render_prepared,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # Full float32 everywhere: no TF32 in the plain version's matmul.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log(f"build: {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())

    key = rng.prng_key(13)

    # ---- phase 1: kernel vs plain on the card ------------------------
    res, spp, n_samples = 800, 512, 16
    scene = random_cloud(1_000_000, seed=13, spread=1.5, device=dev)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=res, height=res)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    cfg = BinningConfig(max_per_tile=256)
    packets = prepare_tiles(scene, cam, settings, cfg)   # also a warm-up
    dirs_t, _ = _tile_dirs(cam, cfg, rng.subpixel_jitter(key, res, res, 0,
                                                         device=dev))
    log(f"phase 1: packets geom {tuple(packets['geom'].shape)} featsT "
        f"{tuple(packets['featsT'].shape)} dirs {tuple(dirs_t.shape)}")
    got = tc.tile_composite(packets, dirs_t, settings)
    want = tc.tile_composite_plain(packets, dirs_t, settings)
    torch.cuda.synchronize()
    err_out = compare(got[0], want[0], "out")
    err_acc = compare(got[1], want[1], "alpha_acc")
    err_depth = compare(got[2], want[2], "depth", mask=want[1] > 1e-3)
    max_abs_err = max(err_out, err_acc, err_depth)
    kernel_ms = cuda_ms(lambda: tc.tile_composite(packets, dirs_t, settings),
                        20)
    plain_ms = cuda_ms(
        lambda: tc.tile_composite_plain(packets, dirs_t, settings), 3)
    log(f"phase 1: kernel vs plain max abs err out {err_out:.3e} alpha_acc "
        f"{err_acc:.3e} depth {err_depth:.3e} (rtol {RTOL}, atol {ATOL})")
    log(f"phase 1: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(CUDA events; {card})")

    # The slice end to end at a small size: card (kernel) vs CPU (plain).
    # Splats large against the camera distance keep q = c - b^2/a well
    # conditioned, so no pair sits within rounding of an alpha cutoff
    # (CPU and CUDA round exp differently).
    small = random_cloud(2000, seed=7, spread=1.2, scale_range=(-1.8, -0.8))
    small_cam = dict(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0)),
                     fov_y_deg=50.0, width=96, height=64)
    small_cfg = BinningConfig(max_per_tile=512)
    imgs = []
    for device in (dev, torch.device("cpu")):
        c = Camera(**{**small_cam, "c2w": small_cam["c2w"].to(device)})
        pk = prepare_tiles(small.to(device), c, settings, small_cfg)
        acc = torch.zeros((c.height, c.width, 3), device=device)
        for f in range(2):
            jit = rng.subpixel_jitter(key, c.height, c.width, f, device=device)
            out = render_prepared(pk, c, settings, small_cfg, jitter=jit,
                                  outputs=("color",))
            acc = accumulate(acc, out["color"], f)
        imgs.append(acc.cpu())
    small_err = compare(imgs[0], imgs[1], "small slice, card vs CPU")
    log(f"phase 1: small slice (2000 Gaussians, 96x64, K=512, 2 spp) card "
        f"vs CPU max abs err {small_err:.3e}")

    # ---- phase 2: the headline slice ---------------------------------
    del packets, got, want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.LAUNCHES = 0
    packets, prep_ms = host_ms(
        lambda: prepare_tiles(scene, cam, settings, cfg))
    acc = torch.zeros((res, res, 3), device=dev)
    sample_ms = []
    for f in range(n_samples):
        def sample():
            jit = rng.subpixel_jitter(key, res, res, f, device=dev)
            out = render_prepared(packets, cam, settings, cfg, jitter=jit,
                                  outputs=("color",))
            return accumulate(acc, out["color"], f)
        acc, ms = host_ms(sample)
        sample_ms.append(ms)
    launches_p2 = tc.LAUNCHES
    check(launches_p2 == n_samples,
          f"phase 2 launched the kernel {launches_p2} times, not {n_samples}")
    stats = {k[5:]: float(v) for k, v in packets.items()
             if k.startswith("stat_")}
    img = acc.cpu().numpy()
    check(img.shape == (res, res, 3), f"phase 2 image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "phase 2 image is not finite")
    check(0.0 < float(img.mean()) < 2.0,
          f"phase 2 image mean {img.mean()} out of range")
    prep2_ms = statistics.median(
        host_ms(lambda: prepare_tiles(scene, cam, settings, cfg))[1]
        for _ in range(3))
    med = statistics.median(sample_ms[1:])
    rays = res * res
    amortized = spp * rays / ((prep2_ms + spp * med) * 1e-3)
    mean_count = float(packets["count"].mean())
    log(f"phase 2: 1M Gaussians, {res}x{res}, K=256: prepare {prep_ms:.1f} ms"
        f" (first), {prep2_ms:.1f} ms (median of 3 more); samples "
        f"{n_samples}: first {sample_ms[0]:.2f} ms, median of the rest "
        f"{med:.2f} ms; LAUNCHES {launches_p2}; ({card})")
    log(f"phase 2: amortized over {spp} spp: {amortized:.4e} rays/s; "
        f"per-sample {rays / (med * 1e-3):.4e} rays/s; mean tile count "
        f"{mean_count:.1f} of 256; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase 2: binning stats {json.dumps(stats)}")
    log(f"phase 2: image finite, mean {img.mean():.5f}, min {img.min():.5f},"
        f" max {img.max():.5f}")
    # One more sample and one prepare_tiles under the profiler.
    profile_once("phase2_sample", lambda: accumulate(acc, render_prepared(
        packets, cam, settings, cfg, outputs=("color",),
        jitter=rng.subpixel_jitter(key, res, res, 99, device=dev))["color"],
        99), med, card)
    profile_once("phase2_prepare",
                 lambda: prepare_tiles(scene, cam, settings, cfg), prep2_ms,
                 card)
    del packets, scene

    # ---- phase 3: the primary stage at the path-trace bench's size ----
    pt_scene = surface_scene(500_000, seed=13, device=dev)
    pt_cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5),
                                device=dev),
                    fov_y_deg=60.0, width=1920, height=1080)
    pt_settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    pt_cfg = BinningConfig()
    pt_packets = prepare_tiles(pt_scene, pt_cam, pt_settings, pt_cfg)
    pt_dirs, _ = _tile_dirs(pt_cam, pt_cfg, rng.subpixel_jitter(
        key, 1080, 1920, 0, device=dev))
    got = tc.tile_composite(pt_packets, pt_dirs, pt_settings)
    want = tc.tile_composite_plain(pt_packets, pt_dirs, pt_settings)
    pt_err = max(compare(got[0], want[0], "1080p out"),
                 compare(got[1], want[1], "1080p alpha_acc"),
                 compare(got[2], want[2], "1080p depth", mask=want[1] > 1e-3))
    max_abs_err = max(max_abs_err, pt_err)
    pt_kernel_ms = cuda_ms(
        lambda: tc.tile_composite(pt_packets, pt_dirs, pt_settings), 20)
    pt_plain_ms = cuda_ms(
        lambda: tc.tile_composite_plain(pt_packets, pt_dirs, pt_settings), 3)
    log(f"phase 3: kernel vs plain at T={pt_dirs.shape[0]}, K=512: max abs "
        f"err {pt_err:.3e}; kernel {pt_kernel_ms:.3f} ms, plain "
        f"{pt_plain_ms:.3f} ms (CUDA events; {card})")
    del pt_packets, pt_dirs, got, want

    tc.LAUNCHES = 0
    pt_packets, pt_prep_ms = host_ms(
        lambda: prepare_tiles(pt_scene, pt_cam, pt_settings, pt_cfg))
    pt_acc = torch.zeros((1080, 1920, 3), device=dev)
    pt_ms = []
    for f in range(4):
        def pt_sample():
            jit = rng.subpixel_jitter(key, 1080, 1920, f, device=dev)
            out = render_prepared(pt_packets, pt_cam, pt_settings, pt_cfg,
                                  jitter=jit, outputs=("color",))
            return accumulate(pt_acc, out["color"], f)
        pt_acc, ms = host_ms(pt_sample)
        pt_ms.append(ms)
    launches_p3 = tc.LAUNCHES
    check(launches_p3 == 4,
          f"phase 3 launched the kernel {launches_p3} times, not 4")
    pt_img = pt_acc.cpu().numpy()
    check(bool(np.isfinite(pt_img).all()), "phase 3 image is not finite")
    check(0.0 < float(pt_img.mean()) < 2.0,
          f"phase 3 image mean {pt_img.mean()} out of range")
    jpg = os.path.join(OUT_DIR, "phase3_surface_500k_1080p_4spp.jpg")
    save_jpg(jpg, pt_img)
    pt_stats = {k[5:]: float(v) for k, v in pt_packets.items()
                if k.startswith("stat_")}
    log(f"phase 3: 500k surface Gaussians, 1920x1080, K=512: prepare "
        f"{pt_prep_ms:.1f} ms; samples {', '.join(f'{m:.2f}' for m in pt_ms)}"
        f" ms (median {statistics.median(pt_ms[1:]):.2f}); LAUNCHES "
        f"{launches_p3}; ({card})")
    log(f"phase 3: binning stats {json.dumps(pt_stats)}; mean tile count "
        f"{float(pt_packets['count'].mean()):.1f} of 512")
    log(f"phase 3: image finite, mean {pt_img.mean():.5f}; saved "
        f"{os.path.relpath(jpg, ROOT)}")
    profile_once("phase3_sample", lambda: accumulate(
        pt_acc, render_prepared(
            pt_packets, pt_cam, pt_settings, pt_cfg, outputs=("color",),
            jitter=rng.subpixel_jitter(key, 1080, 1920, 99, device=dev)
        )["color"], 99), statistics.median(pt_ms[1:]), card)

    check("jax" not in sys.modules, "jax was imported")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "tile_composite_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches_p2 + launches_p3,
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
