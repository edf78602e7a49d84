"""Ablation harness of the forward tile composite: plain versions, kernel
wrapper and the timing driver.

Counterpart of ``benchmarks/variant_kernel.py`` (``_variant_kernel``,
``run_variant``, ``main``): copies of the forward composite with single
stages disabled or re-lowered, timed to find where a sample's composite time
goes. ``MODES`` lists the 19 modes in the reference's docstring order; the
CUDA kernel ``csrc/tile_composite_variants.cu`` (counted in
``launch.launches`` under "tile_variant")
runs each on the forward kernel's pipeline (its ``full`` mode is the
forward's own code, bit-equal to ``tile_composite_fwd``) and says what
each does on the card. The tensor-core modes (mxu, mxu3, lowdot,
dot3) change only how the same math rounds, so their plain version is
``full``'s math and the kernel's error against it is the measurement.

Run on the card (the reference's ``python benchmarks/variant_kernel.py``):

    python -m pathtracer_gaussiansplatting_tpu_torch.kernels.tile_composite_variants [mode ...]

at its input (``random_cloud(1M, seed 13, spread 1.5)``, 800x800, K=256,
20 iterations per mode; ``GSPT_BENCH_{N,RES,K,ITERS}`` override them):
milliseconds per mode and, for the modes that keep the math, the error
against ``full``.
"""
from __future__ import annotations

import math
import os
import sys

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc

MODES = ("full", "noquad", "noexp", "nodiv", "noscan", "nodepth",
         "onechunk", "hoist", "mxu", "mxu3", "floor", "skeleton", "lowdot",
         "dot3", "skel16", "skel32", "noif", "nodirs", "noout")
# Modes whose alpha ignores the quadratic, whose weights skip the running
# transmittance, whose composite is acc[f] += w of slot f, and that keep
# no depth sum (the reference's _SKEL tuples).
SKEL_ALPHA = ("noquad", "floor", "skeleton", "skel16", "skel32", "nodirs",
              "noout")
NO_SCAN = ("noscan", "floor", "skeleton", "skel16", "skel32", "nodirs",
           "noout")
NO_DOT = ("skeleton", "skel16", "skel32", "nodirs", "noout")
NO_DEPTH = ("nodepth", "floor") + NO_DOT
# Modes that compute full's math, rounded another way on the card.
TENSOR_CORE = ("mxu", "mxu3", "lowdot", "dot3")
# Modes whose output the reference compares with full ("max rel err").
SAME_MATH = ("hoist", "mxu", "mxu3", "onechunk", "lowdot", "dot3", "noif")
FP = 16  # the 14 packet features padded to a multiple of 8


def chunk_size(mode: str, k: int) -> int:
    return k if mode == "onechunk" else tc.chunk_size(k)


def out_channels(mode: str) -> int:
    return 8 if mode == "noout" else FP + 2


def tile_composite_variant_plain(mode: str, geom: torch.Tensor,
                                 featsT: torch.Tensor, dirs: torch.Tensor,
                                 count: torch.Tensor,
                                 settings: RenderSettings) -> torch.Tensor:
    """Plain PyTorch version of one mode, the reference's
    ``_variant_kernel`` chunk by chunk (the chunk skip per tile as the
    kernel takes it), batched over tiles.

    Args: geom (T, 16, K), featsT (T, F, K), dirs (T, P, 3), count (T,).
    Returns (T, P, FP + 2): FP composited features (zero-padded), alpha_acc
    and depth; for "noout" (T, P, 8): six features, alpha_acc, depth.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}'; modes: {MODES}")
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    dev = dirs.device
    feats = torch.nn.functional.pad(featsT, (0, 0, 0, FP - featsT.shape[1]))
    kc = chunk_size(mode, k)
    trans = torch.ones((t_total, p, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((t_total, p, FP + 1), dtype=torch.float32, device=dev)
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    dd = (dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz)
    cut = math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)
    for ci in range(k // kc):
        start = ci * kc
        g = geom[:, :, None, start:start + kc]               # (T, 16, 1, kc)
        opac = g[:, tc.ROW_OPAC]
        if mode == "nodirs":
            row = torch.arange(p, dtype=torch.float32, device=dev)[None, :,
                                                                   None]
            alpha = torch.clamp_max(torch.abs(row * 1e-5 * opac), 0.03)
            t = alpha + 1.0
        elif mode in SKEL_ALPHA:
            alpha = torch.clamp_max(torch.abs(dd[0] * opac), 0.03)
            t = alpha + 1.0
        else:
            a = (dd[0] * g[:, 0] + dd[1] * g[:, 1] + dd[2] * g[:, 2]
                 + dd[3] * g[:, 3] + dd[4] * g[:, 4] + dd[5] * g[:, 5])
            a = torch.clamp_min(a, 1e-12)
            b = dx * g[:, 6] + dy * g[:, 7] + dz * g[:, 8]
            if mode == "nodiv":
                t = torch.ones_like(a)
            else:
                t = torch.clamp(-b / a, settings.t_min, settings.t_max)
            qv = (a * t + 2.0 * b) * t + g[:, tc.ROW_C]
            if mode == "noexp":
                gval = torch.clamp_min(1.0 - 0.5 * qv, 0.0)
            else:
                gval = torch.exp(-0.5 * torch.clamp_min(qv, 0.0))
            alpha0 = opac * gval
            live = (gval >= cut) & (alpha0 >= settings.alpha_min)
            alpha = torch.where(live, torch.clamp_max(alpha0,
                                                      settings.alpha_max),
                                0.0)
        om = 1.0 - alpha
        if mode in NO_SCAN:
            w = trans * alpha
            last = om[..., kc - 1:kc]
        else:
            excl = tc.cumprod_excl(om)
            w = trans * excl * alpha
            last = excl[..., kc - 1:kc] * om[..., kc - 1:kc]
        if mode in NO_DOT:
            contrib = w[..., :FP]
        else:
            contrib = torch.matmul(w, feats[:, :, start:start + kc]
                                   .transpose(1, 2))
        if mode == "noif":
            run = torch.ones((t_total, 1, 1), dtype=torch.bool, device=dev)
        else:
            run = (count > start)[:, None, None]
            if ci > 0:
                run = run & (trans.amax(dim=(1, 2), keepdim=True)
                             > settings.transmittance_min)
        acc[..., :FP] += torch.where(run, contrib, 0.0)
        if mode not in NO_DEPTH:
            acc[..., FP:] += torch.where(
                run, torch.sum(w * t, dim=-1, keepdim=True), 0.0)
        trans = torch.where(run, trans * last, trans)
    alpha_acc = 1.0 - trans
    depth = acc[..., FP:] / torch.clamp_min(alpha_acc, 1e-8)
    n_feat = 6 if mode == "noout" else FP
    return torch.cat([acc[..., :n_feat], alpha_acc, depth], dim=-1)


def tile_composite_variant(mode: str, geom: torch.Tensor,
                           featsT: torch.Tensor, dirs: torch.Tensor,
                           count: torch.Tensor,
                           settings: RenderSettings) -> torch.Tensor:
    """One mode of the harness (see :func:`tile_composite_variant_plain`
    for the shapes). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/tile_composite_variants.cu``."""
    tensors = dict(dirs=dirs, geom=geom, featsT=featsT, count=count)
    if launch.on_cpu("tile_composite_variant", tensors):
        return tile_composite_variant_plain(mode, geom, featsT, dirs, count,
                                            settings)
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}'; modes: {MODES}")
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    launch.check("tile_composite_variant", tensors, dict(
        dirs=(t_total, p, 3), geom=(t_total, tc.GEOM_ROWS, k),
        featsT=(t_total, tc.FEATURE_DIM, k), count=(t_total,)))
    out = torch.empty((t_total, p, out_channels(mode)), dtype=torch.float32,
                      device=dirs.device)
    if t_total == 0:
        return out
    launch.launch(f"tile_composite_variant({mode})",
                  "ptgs_tile_composite_variant", MODES.index(mode),
                  count.data_ptr(), dirs.data_ptr(), geom.data_ptr(),
                  featsT.data_ptr(), out.data_ptr(), t_total, p, k,
                  chunk_size(mode, k), *tc.kernel_settings(settings),
                  device=dirs.device, count="tile_variant")
    return out


def headline_inputs(n: int = 1_000_000, res: int = 800, k: int = 256,
                    device=None):
    """The reference harness's input: one prepare_tiles of
    random_cloud(n, seed 13, spread 1.5) at res x res, K slots, and its
    tile directions: (geom, featsT, dirs, count, settings)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
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

    scene = random_cloud(n, seed=13, spread=1.5, device=device)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                             device=device),
                 fov_y_deg=50.0, width=res, height=res)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    cfg = BinningConfig(max_per_tile=k)
    pk = prepare_tiles(scene, cam, settings, cfg)
    dirs, _ = _tile_dirs(cam, cfg)
    return (pk["geom"].contiguous(), pk["featsT"].contiguous(),
            dirs.contiguous(), pk["count"].contiguous(), settings)


def time_mode(mode: str, inputs, iters: int) -> float:
    """Mean milliseconds of one launch of ``mode`` over ``iters`` launches
    (CUDA events, after one warm-up launch)."""
    geom, featsT, dirs, count, settings = inputs
    tile_composite_variant(mode, geom, featsT, dirs, count, settings)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        tile_composite_variant(mode, geom, featsT, dirs, count, settings)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_harness(modes, inputs, iters: int) -> list:
    """Times each mode (:func:`time_mode`) in turn: [(mode, ms, max
    relative error against full or None)], the error for the modes that
    keep full's math once full has run."""
    rows, ref = [], None
    for mode in modes:
        ms = time_mode(mode, inputs, iters)
        out = tile_composite_variant(mode, *inputs)
        err = None
        if mode == "full":
            ref = out
        elif ref is not None and mode in SAME_MATH:
            err = float((out - ref).abs().max() / (ref.abs().max() + 1e-12))
        rows.append((mode, ms, err))
    return rows


def main(argv=None) -> int:
    modes = list(sys.argv[1:] if argv is None else argv) or list(MODES)
    n = int(os.environ.get("GSPT_BENCH_N", 1_000_000))
    res = int(os.environ.get("GSPT_BENCH_RES", 800))
    k = int(os.environ.get("GSPT_BENCH_K", 256))
    iters = int(os.environ.get("GSPT_BENCH_ITERS", 20))
    inputs = headline_inputs(n, res, k)
    print(f"{torch.cuda.get_device_name(0)}: T={inputs[0].shape[0]}, K={k}, "
          f"{iters} launches per mode", flush=True)
    for mode, ms, err in run_harness(modes, inputs, iters):
        note = "" if err is None else f"  max rel err vs full: {err:.2e}"
        print(f"{mode:>10s}: {ms:8.3f} ms{note}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
