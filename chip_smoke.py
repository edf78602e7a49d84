#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py    # build, check, render; exit 0 on success

The port's kernels (every ``pathtracer_gaussiansplatting_tpu_torch/csrc/
*.cu``, one nvcc each, started together) are built from the checkout at
first use. Then:

  phase 1  the forward kernel against its plain PyTorch version on the card,
           at the headline pose's packets (T=2500 tiles, K=256) with
           jittered rays, and the whole slice on the card against the CPU
           at a small size;
  phase 2  the headline slice: random_cloud(1M, seed 13, spread 1.5),
           800x800, K=256 — one prepare_tiles, then 16 jittered samples of
           render_prepared, each accumulated; then one sample and one
           prepare_tiles under torch.profiler (tables in
           chiprun_out/chip_smoke/);
  phase 3  the primary stage at the path-trace bench's size:
           surface_scene(500k, seed 13), 1920x1080, K=512 — the kernel
           against its plain version at these shapes, then one
           prepare_tiles and 4 jittered samples; the image is written to
           chiprun_out/chip_smoke/, and one sample is profiled;
  phase 4  training: (a) the backward kernel, with and without d_dirs,
           against its plain version at the packets of phases 2 and 3,
           with no transmittance cutoff everywhere and, at the default
           cutoff, exact zeros on the chunks it skips; d_geom and d_featsT
           the same bits either way; both launches timed, and the share of
           (warp, slot) pairs with a live pixel counted, with both
           bounds (the yardstick and the function's); the packet
           gather's backward (csrc/packet_gather.cu) bit-equal to its plain
           version, index_put_ with accumulate, at phase 2's packets,
           timed beside it, its bound and index_put_ on the live slots
           alone; (b) fit_scene_tiled on the headline cloud, 800x800,
           K=256, 8 steps over two poses (timed, one launch of each kernel
           a step, one step profiled and its device time split into the
           backward kernel, the packet gather's backward and the rest),
           and a color-only fit at the same size that must
           learn; (c) the training step on the card against the CPU at
           phase 1's small size;
  phase 5  path tracing on the dense backend (csrc/dense_topk.cu,
           csrc/dense_visibility.cu): surface_scene(50k, seed 13) plus a
           point light, 800x800, depth 4. (a) both kernels against their
           plain versions (the top-K kernel bit-equal) on 65536-ray chunks
           of primary rays, bounce rays and the pose seen from 20x as far
           (thin-far), and of shadow segments to emissive surfels and to
           the light, and the top-K kernel on four chunks of primary rays
           in one launch (bit-equal); each kernel timed on each chunk
           beside its culls' counts (the top-K kernel's super-group and
           group tests, the shadow kernel's group tests), the pairs its
           cull keeps, the pairs with alpha > 0, its bound by code path
           and the function's bound; the top-K kernel's launches; the shadow
           kernel's listing modes (visibility_dense's gradient) on each
           shadow chunk: vis bit-equal to the plain launch, exactly the
           pairs with alpha > 0 listed, timed; (c) the flat
           route, make_accumulating_renderer + render_pose in 65536-ray
           chunks, 8 spp (timed, one sample profiled); (d) the tiled
           route, make_tiled_pose_renderer, 4 spp, the forward tile
           kernel once per sample, and both dense kernels held to their
           plain versions with (a)'s gates on the first sample's first
           bounce trace and shadow march (640000 rays in one launch);
           both routes must serve every dense call the backend's table
           (render/pipeline.TABLE_MISSES stays 0); last, (b) one sample
           of pathtrace and of
           pathtrace_camera on the card against the CPU at 2000 Gaussians,
           96x64, at depth 1 and depth 4; (e) gradients of
           render_radiance_dense through the top-K kernel against the
           CPU's, at 2000 Gaussians, 64x48, and of visibility_dense
           through the shadow kernel's pair list on segments into the
           same cloud. Both images are written to
           chiprun_out/chip_smoke/; (f) the composite kernel
           (csrc/dense_composite.cu) against its plain version on K1's
           lists of 65536 primary, bounce and thin-far rays at 40k
           Gaussians, K=64, timed beside its bound by bytes (5c counts
           its launches: one a bounce trace);
  phase 6  the grid backend (csrc/grid_march.cu) at 500k Gaussians
           (surface_scene(500k, seed 13), built without a device: on the
           card): (a) build_grid_accel (Kc=32, 2.5e9 B), timed, its stats
           against GRID_ACCURACY.json, the host C++ binning against numpy;
           (b) both march kernels against the plain march on three
           65536-ray chunks from the 1080p primary hit (bounce rays, shadow
           segments to the emissive panel, a 50% active mask), on the
           default schedule and, ray for ray, on its rounds at capacity 1
           without exit fractions; the latter again at Kc=64 on
           surface_scene(50k)'s grid; (c) grid against dense on the
           primary interaction at 320x180 (psnr_albedo within 0.3 dB of
           GRID_ACCURACY_CPU.json's, the JAX package's float32 figure,
           nothing frozen); (c') the same at Kc=64 (budget 6e9 B): the
           build timed, its stats against that file's kc64 row, its
           psnr_albedo against 6c's dense oracle within 0.3 dB of the
           row's, nothing frozen, both march kernels on (b)'s bounce and
           shadow chunks with (b)'s gates, timed beside their Kc=32 times,
           and the grids' bytes; (d) bench.py's path-trace workload,
           pathtrace_camera at 1920x1080, depth 4, grid bounces, 1 warm and
           3 timed samples (the card's clocks, temperature and power read
           around each), one profiled; (e) bench.py's capture pose through
           make_tiled_pose_renderer(accel=shared), 800x800, 8 spp, one
           sample profiled, and both march kernels held to the plain march
           (in 65536-ray chunks) on that sample's first bounce trace and
           first shadow march with (b)'s default-schedule gates, and timed
           there beside their bound (the plain march's counts over those
           rays); (f) the grid backend on the card against the CPU as in
           phase 5b;
  phase 7  the ablation harness (csrc/tile_composite_variants.cu, each
           mode the forward kernel with one stage removed or re-lowered):
           at the headline packets (T=2500, K=256) every mode's kernel
           against its plain version, full and hoist bit-equal to the
           forward kernel, onechunk and noif within the transmittance_min
           bound of full; at phase 3's 1080p packets (T=8160, K=512) full
           and hoist bit-equal to the forward; at both, full timed against
           the forward back to back (at most FULL_TIME_RATIO of its time),
           then the timing run, 20 launches a mode: ms, share of full, and
           the saving against full as ms and as a share of full's distance
           to the function's bound;
  phase 8  the dataset capture: (a) capture_scene_data through "auto"
           (tiled+grid) on surface_scene(500k, seed 13) with its emissive
           panel, depth 4, 4 poses at 800x800 (fov 45, halved), 16 spp,
           1M uniform rays from the downstream loop's torus (R 1.2, r 0.4,
           h 0.2), debug_checks on; then capture_panorama (2 frames, 4
           spp): the layout, the 3/1 split, 400x400 JPGs, the PLY's rows
           (finite, as many as num_points), one grid build, the report
           lines, the kernels' launches; (b) a small capture
           (surface_scene(2000), tiled+grid, 4 poses at 96x64, 2 spp,
           depth 1, 4096 rays) on the card against the CPU; (c) pose 0 at
           8 spp checkpointed every 4 samples, cut after the first segment
           and resumed, against the uninterrupted render (bit for bit, or
           the first operation that differs between two runs); (d) the
           capture's times (prepare, sample, pose, the point-cloud pass,
           the PLY write, the grid build, one profiled sample's busy
           share, peak memory) and the reference's default dataset
           extrapolated from them;
  phase 9  the command line (pathtracer_gaussiansplatting_tpu_torch/cli.py)
           and its scene loaders: (a) a scene config written in a temporary
           directory (phase 8's room, surface_scene(500k, seed 13), as a
           3DGS checkpoint written by save_3dgs_ply and turned and moved by
           the config; a textured glTF cube, its base color a PNG data URI
           under KHR_texture_transform, with a KHR_lights_punctual spot
           light; an rtbox with one emissive panel; a sun; phase 8's
           torus, 1M uniform rays; 4 poses x 16 spp at 800x800, halved,
           depth 4), then cli.main(["capture-dataset", ...]) with no
           --device: the loaders timed, "auto" -> tiled+grid, the Gaussian
           count, one grid build, the kernels' launches, 8a's file gates,
           the printed {"points", "train", "test"} line, each object hit
           by the primary rays of a pose, the times and one profiled
           sample; (b) ``python -m pathtracer_gaussiansplatting_tpu_torch
           .cli render --scene <(a)'s config> --spp 4`` as a subprocess:
           exit 0, an 800x800 PNG, its wall time; (c) a small config
           (tests/test_utils_cli.py's debug cube, a small 3DGS checkpoint
           and a glTF cube) through capture-dataset and render with
           --device cuda and --device cpu, held to 8b's gates; (d) on
           (a)'s config: render (800x800, 16 spp), panorama (2 x 4 spp),
           fit with its defaults (64x64, 500 Gaussians, 200 steps, lr
           5e-3; its target through dense_topk over the 500k+ scene; the
           loss falls, fitted.ply loads back), view-pointcloud on (a)'s
           points3d.ply in both placements, and interact with a command
           file (every input resets the accumulation; each camera-mode
           step launches the tile kernel and the march kernels);
  phase 10 the bench (pathtracer_gaussiansplatting_tpu_torch/bench.py):
           (a) cli.main(["bench"]) at its defaults, no --device and no
           GSPT_BENCH_* variable: the printed line has the root bench.py's
           keys (fwd_bound_share in vpu_tslots_per_s's place), every
           number finite and positive, value equal to spp·W·H /
           (binning_ms + spp·sample_ms), mfu and fwd_bound_share at most
           BENCH_SHARE_MAX, the card's line as its device; the forward,
           backward, top-K and both march kernels launched at least as
           often as the bench's code implies; its wall time; (b) the
           bench's depth-12 workload (pathtrace_camera, opaque_depth 4,
           grid bounces, the surface scene lit by its panel) at 2000
           Gaussians, 96x64, and the same sample cut at depth 4, on the
           card against the CPU on three keys (PT12_MIN_SHARE and
           PT12_MEAN_FRAC at both depths; what bounces 5-12 add within
           PT12_EXTRA_REL and PT12_CHANGED_DIFF); (c) one depth-12 sample
           at the bench's 1080p timed and profiled (the march kernels'
           share once most paths have ended); (d) the bench's dense
           baseline (K = 256, the root bench's min(K, 256)): one call's
           wall time, the table's build, the
           top-K kernel against its plain version and timed beside the
           plain version, its cull's counts and its bound; (e) the
           bench's headline sample timed as sample_ms is, with Python's
           garbage collector on and off, beside the card's span by CUDA
           events and one sample profiled;
  phase 11 the (rays, gauss) mesh and the spatial slab ring
           (pathtracer_gaussiansplatting_tpu_torch/parallel/) on a world of
           one: parallel.mesh.initialize_multihost() with no rendezvous
           (NCCL for CUDA tensors, gloo for CPU ones), make_mesh((1, 1)) on
           the card and on the CPU; (a) render_spatial over
           random_cloud(2M, seed 13, spread 2) in one slab on a 64x64 tile
           of a 3840x2160 frame, K=64, forward and backward to
           opacity_logits (ms, peak memory, the top-K kernel's launches),
           against the same ring over the plain top-K on 256 rays; (b)
           pathtrace_camera through make_trace_backend(..., "spatial",
           accel=mesh) on phase 5's scene and pose, 4 samples, beside 5d's
           dense tiled sample, and the card against the CPU at 2000
           Gaussians with 5b's gates; (c) build_slab_accels on
           surface_scene(500k) in one slab, trace_spatial and
           visibility_spatial on 6b's chunks against trace_grid and
           visibility_grid on the same tables (SLAB_EXACT_ATOL); (d)
           render_dense_ray_sharded (bit-equal) and ring_topk_radiance
           (RING_RTOL / RING_ATOL) against render_radiance_dense on the
           headline cloud's first 50k Gaussians and 65536 rays, K=64, and
           fit_scene(mesh=) against fit_scene, 8 steps with deterministic
           kernels, equal losses; (e) (a)'s slab composite at K = 160
           (two launches of the top-K kernel) against the plain top-K on
           256 rays; (f) tools/scaling.run_ray_dp on the mesh at
           benchmarks/scaling.py's sizes (5000 Gaussians, 4096 rays, 3
           timed calls), bit-equal to render_radiance_dense and against
           the plain top-K on 256 rays, then the tool itself as a
           subprocess (a world of one rank on the card, the ring's "needs
           2 ranks" line); (g) tools/spatial_chip at
           benchmarks/spatial_chip.py's sizes (slab 0 of 8 of
           surface_scene(2M), 4096 rays dense, 65536 on its grid): the
           slab features against the plain top-K on 256 rays, the slab
           march against march_plain on 16384 rays with 6b's gates and
           the tool's own trace against a launch on those rays
           (SLAB_EXACT_ATOL). The group is destroyed at the end.
  phase 12 the downstream loop (pathtracer_gaussiansplatting_tpu_torch/
           tools/downstream_loop.py): (a) run_downstream at
           DOWNSTREAM.json's config (surface_scene(50k), 12 poses x 32 spp
           at 200x200 through tiled+grid at depth 4, 40000 torus rays, a
           fresh scene from points3d.ply, 900 fit_scene_tiled steps,
           PSNR and SSIM on the 3 held-out poses): its numbers beside the
           JAX package's TPU figures (not a gate), every number finite,
           the train loss down to DS_LOSS_FALL of its first, one fitted
           Gaussian a PLY row, the kernels' launches; one capture sample
           and one fit step profiled; on the first fit step's packets the
           forward and the backward kernels against their plain versions
           with phases 1 and 4a's gates; (b) the loop at DS_SMALL on the
           card and on the CPU: the captures held to 8b's gates (at depth
           4, DS_MIN_SHARE of the path-traced values), the test poses'
           PSNR and SSIM within DS_PSNR_ATOL and DS_SSIM_ATOL.
  phase 13 K5, the render RNG (csrc/threefry.cu, one launch a bounce for
           all its uniforms and one a jittered sample): its launches in
           each of phases 2-12, every one of them above 0 (5c, 5d, 6d, 6e
           and 11b exactly once a bounce and a jittered sample); then the
           kernel against its plain version (core/rng.uniforms_plain,
           jitter_plain) bit for bit at one 1080p depth-12 bounce
           (2,073,600 rays, 9 draws, 11 columns), one capture-pose bounce
           (640,000 rays, 8 draws) and the 1080p jitter, each timed by
           CUDA events (20 launches) and by the profiler's kernel record,
           beside the plain version and the bound. The profiles of the
           path-traced samples (5c, 6d, 6e, 10c, 11b, 12a) show K5 by
           name as "threefry", with its launches.
  phase 14 the sizes past the old caps, each on a hand kernel: (a) the
           top-K kernel (a warp a ray, every K) bit for bit against its
           plain version at K = 1, 32, 64, 128, 160, 256, 512 and 2048 on
           5a's chunks (primary, bounce and thin-far rays, primary rays by
           tied sort depths, bounce rays half active), and at K = N on the
           same three chunks of surface_scene(3000), timed at every K on
           the primary and bounce chunks beside the plain version and both
           bounds, its launches printed; (b) the march
           kernels' wide instantiation (Kc above 128, each cell's work
           bounded by its fill) at Kc = 144 and 256 on
           surface_scene(500k)'s grid, each grid's fill printed, with 6b's
           gates on its bounce and shadow chunks, the Kc=256 outputs
           bit-equal to Kc=144's (no cell overflows 144), timed beside the
           bound; (c) the tile kernels at
           tile sizes 8, 12 and 32 on the headline's packets: the forward
           against its plain version with phase 1's gates and, without the
           transmittance cutoff, bit for bit against the one-block kernel
           on the same pixels; the backward with 4a's gates; both timed
           beside their bounds; end to end, each with its launches counted
           from 0: (d) a headline frame at tile size 32 (phase 2's gates),
           and at phase 1's size the slice and three fit steps at tile
           size 32 on the card against the CPU (phases 1's and 4c's
           gates); (e) the capture pose at Kc = 256, 2 spp, with 6e's gates
           on the first 65536 rays of its first trace and shadow march and
           its frozen count; (f) cli render --backend dense --max-contribs
           256 on 5b's scene as a 3DGS checkpoint, the card against the CPU
           with 5b's depth-1 gates at phase 5's ambient, and with the
           gates of tests/torch_ambient_divergence.py (the JAX package
           against the port on the CPU) at ambient 0.6. With phase 10a's
           dense baseline and 11e, these runs are the new paths' main
           path: each new kernel's launches there must be above 0.

Everything the script prints goes to chiprun_out/chip_smoke/log.txt as
well as to stdout.

Every failure (a build error, a launch error, a tolerance miss, a
non-finite image, a kernel the main path never launched) raises and ends
the run with a non-zero exit before any result line is printed. Without
CUDA the script exits with code 2 at once. The last line printed is
{"ok": true, "device": {...}}; the line before it is the kernel table,
each kernel with its launches on the main path, its error against its
plain version, its time, its plain version's, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its float operations over
67 TFLOP/s (the H100 SXM's published HBM rate and float32 peak), from the
inputs of this run; K5's operations are INT32, over half that peak (the
card's issue rate, INT32_OPS_PER_S). For the tile kernels bound_ms keeps the yardstick
(FWD_PAIR_FLOPS, BWD_PAIR_FLOPS on every pair evaluated); phases 1, 3, 4a
and 7 print beside it the function's bound (the evaluation on every pair,
the rest on the pairs with alpha > 0 alone), and the kernel table carries
it as function_bound_ms wherever it is counted. A kernel whose launches
come from another run than the render and training paths names it in
launches_in.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# The tile kernels' bounds and the card's line: one count for this script
# and the bench (pathtracer_gaussiansplatting_tpu_torch/bench.py).
from pathtracer_gaussiansplatting_tpu_torch.bench import (  # noqa: E402
    FP32_FLOPS_PER_S, HBM_BYTES_PER_S, bound, card_line, chunk_schedule,
    tile_bounds,
)
# Launches of the hand kernels by key, read and reset by every phase.
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch  # noqa: E402
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
KERNEL_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                 "tile_composite_fwd.cu")
KERNEL_REPLACES = ("pathtracer_gaussiansplatting_tpu/kernels/"
                   "tile_composite.py:244")
BWD_KERNEL_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                     "tile_composite_bwd.cu")
BWD_KERNEL_REPLACES = ("pathtracer_gaussiansplatting_tpu/kernels/"
                       "tile_composite.py:281")
TOPK_SOURCE = "pathtracer_gaussiansplatting_tpu_torch/csrc/dense_topk.cu"
TOPK_REPLACES = "pathtracer_gaussiansplatting_tpu/render/reference.py:26"
VIS_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
              "dense_visibility.cu")
VIS_REPLACES = "pathtracer_gaussiansplatting_tpu/render/reference.py:161"
GRID_SOURCE = "pathtracer_gaussiansplatting_tpu_torch/csrc/grid_march.cu"
GRID_TRACE_REPLACES = ("pathtracer_gaussiansplatting_tpu/render/"
                       "grid_trace.py:1060")
GRID_VIS_REPLACES = ("pathtracer_gaussiansplatting_tpu/render/"
                     "grid_trace.py:1109")
VARIANT_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                  "tile_composite_variants.cu")
VARIANT_REPLACES = "benchmarks/variant_kernel.py:58"
COMPOSITE_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                    "dense_composite.cu")
COMPOSITE_REPLACES = ("pathtracer_gaussiansplatting_tpu/render/"
                      "reference.py:63")
GATHER_SOURCE = ("pathtracer_gaussiansplatting_tpu_torch/csrc/"
                 "packet_gather.cu")
GATHER_REPLACES = ("pathtracer_gaussiansplatting_tpu/kernels/"
                   "tile_composite.py:163")
# A training step's device split: the tile kernels and the packet gather's
# backward by name, and the rest of the gather's backward (its counts'
# zeros and the cumsum) by its autograd node's range.
TRAIN_PROFILE_NAMES = dict(tile_composite_bwd="tile_composite_bwd",
                           tile_composite_fwd="tile_composite_fwd",
                           gather_bwd="packet_indexing_backward")
TRAIN_OP_RANGES = dict(gather_glue="PacketGatherBackward")
K5_SOURCE = "pathtracer_gaussiansplatting_tpu_torch/csrc/threefry.cu"
K5_REPLACES = "pathtracer_gaussiansplatting_tpu/core/rng.py:47"
# K5's work a uniform: 78 INT32 operations (the two key adds; 20 rounds of
# add, rotate and xor; five injections of two adds; the counter's high
# word, the xor of the two output words, the shift and the or; the float
# subtract and the max), and the jitter's add and fmod 2 more. The H100
# SXM's integer rate: its issue limit, one warp instruction a clock from
# each of an SM's four schedulers, 128 lane operations a clock, which is
# the float32 peak (FP32_FLOPS_PER_S) with an FMA counted once. Integer
# adds and logic issue on the 64 INT32 lanes and, as IMAD, on the FMA
# lanes, so the mix is not held to the INT32 lanes alone: at 64 lanes an
# SM the bound was 0.1062 ms at 1080p, and K5 ran in 0.1045 on an H100.
K5_OPS, K5_JITTER_OPS = 78, 2
K5_PER_THREAD = 4  # csrc/threefry.cu's kPerThread
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 2
# Float operations (counted as the bench module counts the tile kernels')
# of the dense top-K and shadow visibility kernels per (ray, Gaussian) pair
# on the exact path kept by the cull, and of the cull test
# (dense_common.cuh: cull_keep) per pair tested: x 3, x.d 5, |x|^2 5, the
# Lagrange form 3, the radius 4, the compare 1.
DENSE_PAIR_FLOPS, DENSE_CULL_FLOPS = 60, 21
# The group test (dense_common.cuh: group_keep) per (ray, group of 32 rows),
# and per (ray, super-group of 32 groups) in the top-K kernel: x 3, x.d 5,
# |x|^2 5, the slackened Lagrange form, its division and root 8, |x| 1,
# the lower bound 5, the upper 2, the reach 5, the compares 3.
DENSE_GROUP_FLOPS = 37
# The grid march (csrc/grid_march.cu, grid_common.cuh), by code path: per
# ray (setup_ray); per probe (the loop test and cell_of); per probe of an
# empty block (its jump, besides the block exit); per probe of an occupied
# block (the sub-box slab test); per block exit (after a missed sub-box, an
# empty block's jump, or in-block steps that left the sub-box: the exit and
# its max); per in-block step entered (cell_of and two tests) and taken
# (the cell exit); per occupied slot of a composited cell (respond). The
# walk over a cell's live slots and the feature sums are not charged.
GRID_RAY_FLOPS, GRID_PROBE_FLOPS, GRID_JUMP_FLOPS = 61, 26, 2
GRID_SLAB_FLOPS, GRID_BLOCK_EXIT_FLOPS = 47, 27
GRID_CHECK_FLOPS, GRID_STEP_FLOPS, GRID_GAUSS_FLOPS = 27, 20, 66
GRID_MAX_STEPS = 192  # render/pipeline.make_trace_backend's default
# Grid kernel vs plain march on rays neither froze: the kernel cannot see
# the batch (exit fractions, capacity), so a ray may meet its kill test at
# another cell count: up to ~transmittance_min of its light.
GRID_TRANS_ATOL, GRID_RTOL, GRID_ATOL = 2e-4, 1e-3, 2e-4
# Least share of a chunk's rays within 1e-6 of the plain march: bounce rays
# meet the exit fractions, shadow segments (short, converging) hardly ever.
GRID_BOUNCE_MIN_SHARE, GRID_SHADOW_MIN_SHARE = 0.995, 0.9999
# On the default schedule's rounds (M, a_max) at capacity 1 without exit
# fractions nothing of the batch is in play, so the kernel must follow the
# plain march ray for ray: trans within GRID_EXACT_TRANS, sums within the
# rtol / atol that allow for summation order alone, the same frozen rays.
GRID_EXACT_TRANS, GRID_EXACT_RTOL, GRID_EXACT_ATOL = 1e-6, 1e-5, 1e-6
GRID_STATS_TOL = 1e-4  # grid stats against GRID_ACCURACY.json (same scene)
# dB: psnr_albedo within this of GRID_ACCURACY_CPU.json's, which is
# benchmarks/grid_accuracy.py run by the JAX package on the CPU in float32.
# GRID_ACCURACY.json's figure, taken on a TPU, is 2.4 dB lower (ROADMAP
# section 3).
GRID_PSNR_TOL = 0.3
GRID64_BUDGET = 6.0e9  # Kc=64's memory budget (benchmarks/grid_accuracy.py:95)
GRID_PROFILE_NAMES = dict(tile_composite_fwd="tile_composite_fwd_kernel",
                          grid_trace="grid_march_kernel<true",
                          grid_visibility="grid_march_kernel<false",
                          threefry="threefry_uniforms_kernel")
DENSE_PROFILE_NAMES = dict(dense_topk="dense_topk",
                           dense_visibility="dense_visibility",
                           threefry="threefry_uniforms_kernel")
# Phase 5e: the card's dense gradients against the CPU's, per leaf, over its
# largest CPU gradient (CUDA and the CPU round exp differently).
DENSE_GRAD_TOL = 1e-3
# Shadow visibility: the kernel multiplies in Morton order, torch.prod in
# index order and its own reduction order.
VIS_RTOL, VIS_ATOL = 1e-5, 1e-6
# Card vs CPU per path-traced sample: a pixel matches within the kernel
# tolerance; at depth 1 at least PT_MIN_SHARE of them must. Deeper, each
# bounce ray that differs in its last bit between card and CPU (sin, cos,
# exp and pow round differently) may flip a thin surfel at an alpha cutoff
# and send the path elsewhere (ROADMAP section 3), so at depth 4
# PT_DEEP_MIN_SHARE must (96.65% measured on the card, the JAX package
# against the port on the CPU 95.7%). At every depth the mean absolute
# difference stays under PT_MEAN_FRAC of the image mean.
PT_MIN_SHARE, PT_DEEP_MIN_SHARE, PT_MEAN_FRAC = 0.99, 0.93, 0.01
# 14f at a bright ambient: the closed room shades the sun, so the image is
# mostly the ambient term, which carries every float32 difference in a thin
# surfel's alpha into the pixel. There the JAX package and the port part
# on 8.3-11.8% of the pixels on the CPU (0.23-0.26% of the image mean;
# tests/torch_ambient_divergence.py, whose gates these are; ROADMAP
# section 3), the card and the CPU on 4.5%.
AMBIENT_BRIGHT, AMBIENT_MIN_SHARE, AMBIENT_MEAN_FRAC = 0.6, 0.85, 0.01
# Phase 10b, the bench's depth-12 workload (opaque_depth 4; glass-first
# paths bounce on) on the panel-lit scene and the grid backend, at depth
# 12 and cut at depth 4, each of PT12_KEYS: the gates of
# tests/torch_divergence.py, set from the JAX package against the port on
# the CPU at this setting. There, on keys 1-3, 92.19-92.77% of pixels are
# within the tolerance at depth 4 and 91.31-91.70% at depth 12, the mean
# absolute difference is 0.36-0.43% and 0.59-0.92% of the image mean
# (ROADMAP section 3). Depth 12 changes only the glass-first pixels over
# depth 4 (5.49-5.66%), so what bounces 5-12 add, E = I12 - I4, is held on
# its own: its mean on the card within PT12_EXTRA_REL of the CPU's (the
# port off the JAX package by 0.004-6.4%), the share of pixels it changes
# within PT12_CHANGED_DIFF of the CPU's.
PT12_MIN_SHARE, PT12_MEAN_FRAC = 0.88, 0.02
PT12_EXTRA_REL, PT12_CHANGED_DIFF = 0.25, 0.01
PT12_KEYS = (1, 2, 3)
PT_CHUNK = 65536  # render_pose's ray chunk (part of the random stream)
# The path-trace bench's camera (bench.py:124-128): eye and target.
PT_EYE, PT_TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
RTOL, ATOL = 1e-3, 3e-4  # the reference's kernel-vs-oracle tolerances
# Phase 7: the harness's full mode runs the forward's code, so it may take
# at most this many times the forward kernel's time (device times repeat
# within ~2% between runs).
FULL_TIME_RATIO = 1.05
# The reference's tolerance for its analytic backward against autodiff
# (tests/test_pallas_kernels.py, TestAnalyticBackward).
BWD_RTOL, BWD_ATOL = 2e-3, 2e-4
DIRS_MASS_RTOL = 1e-5  # d_dirs: allowance per unit L1 mass of its terms


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class Tee:
    """A text stream that writes to a stream and to a log file alike."""

    def __init__(self, stream, log_file):
        self.stream, self.log_file = stream, log_file

    def write(self, text: str) -> int:
        self.log_file.write(text)
        return self.stream.write(text)

    def flush(self) -> None:
        self.log_file.flush()
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def compare(got, want, name: str, mask=None, rtol=RTOL, atol=ATOL,
            extra=None) -> float:
    """Max abs error of got vs want; raises on a miss of atol + rtol |want|
    (+ extra, a tensor of per-entry allowances, where given)."""
    g, w = got.double(), want.double()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite values")
    bad = err > atol + rtol * w.abs() + (0.0 if extra is None else extra)
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
          f"rtol {rtol} / atol {atol}{'' if extra is None else ' + extra'} "
          f"(max abs err {float(err.max()):.3e})")
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


def ptxas_report(build_log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v output: its
    name (template arguments spelt out), registers, stack and spills; and
    any error line."""
    out, name, frame = [], "", ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([A-Za-z_]*kernel)(I(?:L[a-z]\d+E)+E)?",
                          m.group(1))
            name = m.group(1) if k is None else k.group(1)
            if k is not None and k.group(2):
                args = [dict(b0="false", b1="true").get(t + v, v) for t, v in
                        re.findall(r"L([a-z])(\d+)E", k.group(2))]
                name += "<" + ", ".join(args) + ">"
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {frame}")
        elif "error" in line:
            out.append(line.strip())
    return out


def card_state() -> str:
    """The card's SM and memory clocks, temperature, power draw and active
    clock-event reasons as nvidia-smi reads them; a driver that does not
    know the reasons' field gives the rest."""
    base = "clocks.sm,clocks.mem,temperature.gpu,power.draw"
    for fields in (base + ",clocks_event_reasons.active",
                   base + ",clocks_throttle_reasons.active", base):
        res = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        if res.returncode == 0:
            return res.stdout.strip()
    return "not read"


def dirs_term_mass(tc, packets, dirs, cot, settings):
    """Per pixel (T, P, 1): the L1 mass of the terms that d_dirs sums,
    sum_k |d_a| sum_r |q6_r| + |d_b| sum_r |Q(o-mu)_r|. For thin splats
    q6 ~ 1/sigma^2 reaches ~1e6 and the terms cancel, so float32 d_dirs
    carries errors of ~eps32 times this mass in any implementation."""
    geom, featsT = packets["geom"], packets["featsT"]
    t_total, p, _ = dirs.shape
    step = max(1, tc.PLAIN_CHUNK_ELEMS // (p * geom.shape[-1]))
    parts = []
    for s in range(0, t_total, step):
        g, c = geom[s:s + step], tuple(x[s:s + step] for x in cot)
        a, b = (x.requires_grad_() for x in tc._quadratic_ab(dirs[s:s + step],
                                                             g))
        with torch.enable_grad():
            outs = tc._composite_from_ab(a, b, g, featsT[s:s + step],
                                         settings)
            d_a, d_b = torch.autograd.grad(outs, (a, b), c)
        parts.append(
            torch.einsum("bpk,bk->bp", d_a.abs(), g[:, :6].abs().sum(1))
            + torch.einsum("bpk,bk->bp", d_b.abs(), g[:, 6:9].abs().sum(1)))
    return torch.cat(parts)[..., None]


def bound_text(bnd: dict, ms: float) -> str:
    """A tile kernel's time against both of its bounds, labelled."""
    return (f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} (the "
            f"yardstick: {bnd['bound_flops']:.3e} flops, "
            f"{bnd['bound_bytes']:.3e} bytes) = "
            f"{bnd['bound_ms'] / ms:.1%} of its rate; the function's bound "
            f"{bnd['function_bound_ms']:.4f} ms = "
            f"{bnd['function_bound_ms'] / ms:.1%}")


def bwd_check(tc, packets, dirs, settings, name: str, card: str,
              phase: str = "4a") -> dict:
    """The backward kernel, with and without d_dirs, against
    tile_composite_bwd_plain on a seeded cotangent (the depth cotangent
    masked where alpha_acc <= 1e-3): at transmittance_min=0 everywhere; at
    the given settings, exact zeros on the chunks the kernel skips and a
    match on tiles with none skipped. Both launches are held to the same
    gates, and d_geom and d_featsT must not depend on whether d_dirs was
    asked for. Returns the launch without d_dirs (training's)."""
    t_total, p, _ = dirs.shape
    k = packets["geom"].shape[-1]
    rng = np.random.default_rng(17)
    dev = dirs.device

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    alpha_acc = tc.tile_composite_plain(packets, dirs, settings)[1]
    cot = (normal(t_total, p, tc.FEATURE_DIM), normal(t_total, p),
           normal(t_total, p) * (alpha_acc > 1e-3))
    names = ("d_geom", "d_featsT", "d_dirs")
    # The plain version has no chunk skip, so one run serves both checks.
    want = tc.tile_composite_bwd_plain(packets, dirs, cot, settings)
    full = dataclasses.replace(settings, transmittance_min=0.0)
    no_skip, skip_from, kc = chunk_schedule(packets, dirs, settings)
    slot_chunk = torch.arange(k, device=dev) // kc            # (K,)
    dead = slot_chunk[None, :] >= skip_from[:, None]          # (T, K)
    n_dead = int(dead.sum())
    # d_dirs sums terms that cancel: beside the tolerance above, allow
    # DIRS_MASS_RTOL of their L1 mass (~84 float32 ulps of it).
    mass = dirs_term_mass(tc, packets, dirs, cot, full)
    err = dirs_err = dirs_rel = 0.0
    for want_dirs in (True, False):
        tag = f"{name}{'' if want_dirs else ' (no d_dirs)'}"
        got = tc.tile_composite_bwd(packets, dirs, cot, full, want_dirs)
        torch.cuda.synchronize()
        err = max([err] + [compare(g, w, f"{tag} {n}, transmittance_min=0",
                                   rtol=BWD_RTOL, atol=BWD_ATOL)
                           for g, w, n in zip(got[:2], want[:2], names)])
        if want_dirs:
            dirs_err = compare(got[2], want[2],
                               f"{tag} d_dirs, transmittance_min=0",
                               rtol=BWD_RTOL, atol=BWD_ATOL,
                               extra=DIRS_MASS_RTOL * mass.double())
            dirs_rel = float(((got[2] - want[2]).abs()
                              / mass.clamp_min(1e-30)).max())
            with_dirs = got
        else:
            check(got[2] is None, f"{tag}: d_dirs returned when not asked")
            check(all(torch.equal(g, w) for g, w in zip(got[:2],
                                                        with_dirs[:2])),
                  f"{tag}: d_geom / d_featsT differ from the launch with "
                  "d_dirs")

        got = tc.tile_composite_bwd(packets, dirs, cot, settings, want_dirs)
        torch.cuda.synchronize()
        for g, w, n in zip(got, want, names):
            if g is None:
                continue
            compare(g[no_skip], w[no_skip], f"{tag} {n}, tiles with no "
                    "skipped chunk", rtol=BWD_RTOL, atol=BWD_ATOL,
                    extra=DIRS_MASS_RTOL * mass[no_skip].double()
                    if n == "d_dirs" else None)
        for g, n in zip(got[:2], names):
            check(bool((g.masked_select(dead[:, None, :]) == 0).all()),
                  f"{tag} {n}: a slot of a skipped chunk is not exactly 0")
        if want_dirs:
            check(bool(torch.isfinite(got[2]).all()),
                  f"{tag} d_dirs not finite")

    ms = cuda_ms(lambda: tc.tile_composite_bwd(packets, dirs, cot, settings,
                                               False), 10)
    dirs_ms = cuda_ms(lambda: tc.tile_composite_bwd(packets, dirs, cot,
                                                    settings), 10)
    plain_ms = cuda_ms(
        lambda: tc.tile_composite_bwd_plain(packets, dirs, cot, settings), 2)
    bnd = tile_bounds(packets, dirs, settings)
    live, n_ws = bnd["warp_live"], bnd["warp_slots"]
    log(f"phase {phase} {name}: T={t_total}, K={k}: backward kernel vs "
        f"plain at transmittance_min=0, with and without d_dirs: d_geom, "
        f"d_featsT max abs err {err:.3e} (rtol {BWD_RTOL}, atol "
        f"{BWD_ATOL}), the same bits either way; d_dirs max abs err "
        f"{dirs_err:.3e}, max err / term mass {dirs_rel:.3e} (allowance "
        f"{DIRS_MASS_RTOL} of the mass beside rtol/atol, term mass up to "
        f"{float(mass.max()):.3e}); default settings: "
        f"{int(no_skip.sum())} tiles with no skipped chunk match, "
        f"{int((skip_from < k // kc).sum())} tiles skip chunks ({n_dead} "
        f"slots, all exactly 0, with and without d_dirs)")
    log(f"phase {phase} {name}: kernel {ms:.3f} ms without d_dirs "
        f"(training's), {dirs_ms:.3f} ms with d_dirs, plain {plain_ms:.3f} "
        f"ms (CUDA events; {card}); live (warp, slot) pairs {live} of {n_ws} "
        f"evaluated = {live / max(n_ws, 1):.4f}; (pixel, slot) pairs with "
        f"alpha > 0 {bnd['live_pairs']} of {bnd['pairs']} = "
        f"{bnd['live_pairs'] / max(bnd['pairs'], 1):.4f}")
    log(f"phase {phase} {name}: without d_dirs, "
        f"{bound_text(bnd['bwd'], ms)}")
    return dict(max_abs_err=max(err, dirs_err), ms=ms, dirs_ms=dirs_ms,
                plain_ms=plain_ms, live_share=live / max(n_ws, 1),
                bound=bnd["bwd"])


def gather_bound(idx, mask, n: int, cols: int) -> dict:
    """The packet gather backward's bound by bytes: the 4 bytes of each of
    a live slot's ``cols`` values read, d_table written once, and the
    integer passes (idx and mask read twice, a live slot's count, place and
    id, the counts' zeros and cumsum, the segment ends). Beside it, not a
    bound: the same with a 32-byte sector charged for every value, what the
    (T, rows, K) layout costs where no two reads share a sector. Flops: one
    add a live slot's value."""
    live, slots = int(mask.sum()), idx.numel()
    ints = 10 * slots + 16 * live + 20 * n
    flops = live * cols
    out = {}
    for key, per_value in (("bound", 4), ("sector", 32)):
        nbytes = live * cols * per_value + n * cols * 4 + ints
        out[key] = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) \
            * 1e3
        out[key + "_bytes"] = nbytes
    return dict(bound_ms=out["bound"], bound_by="bytes", bound_flops=flops,
                bound_bytes=out["bound_bytes"], sector_ms=out["sector"],
                sector_bytes=out["sector_bytes"], live=live, slots=slots)


def gather_bwd_check(tc, scene, cam, settings, cfg, packets, dirs,
                     card: str, phase: str = "4a") -> dict:
    """The packet gather's backward (csrc/packet_gather.cu) against its
    plain version, index_put_ with accumulate, at the given packets (their
    binning done again): bit-equal on cotangents from the tile backward and
    on seeded ones zero at masked slots, the same bits twice, zeros for
    Gaussians in no live slot. Timed beside the plain version (the library
    call) and its bound; the kernels' own time from one profiled call; and
    index_put_ alone on the same rows, on the live slots alone and with the
    masked slots' index spread over the Gaussians: the masked slots' pile
    on Gaussian 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        bin_gaussians, num_tiles, project_gaussians,
    )

    with torch.no_grad():
        idx, mask, _, _ = bin_gaussians(project_gaussians(scene, cam, cfg),
                                        *num_tiles(cam, cfg), cfg)
    dev = dirs.device
    n = scene.means.shape[0]
    t_total, p, _ = dirs.shape
    check(torch.equal(tc.gather_packets(torch.zeros((n, 1 + tc.ROW_OPAC
                                                     + tc.FEATURE_DIM),
                                                    device=dev), idx,
                                        mask)[2], packets["count"]),
          f"phase {phase}: the binning again gives other tile counts")
    rng = np.random.default_rng(19)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    cot = (normal(t_total, p, tc.FEATURE_DIM), normal(t_total, p),
           normal(t_total, p))
    d_geom, d_featsT, _ = tc.tile_composite_bwd(packets, dirs, cot, settings,
                                                False)
    dead = ~mask[:, None, :]
    check(bool((d_geom.masked_select(dead) == 0).all())
          and bool((d_featsT.masked_select(dead) == 0).all()),
          f"phase {phase}: the tile backward's gradient is not 0 at a "
          "masked slot")
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit[idx[mask].long()] = True
    gen = torch.Generator(device=dev).manual_seed(23)
    seeded = tuple(torch.randn(x.shape, generator=gen, device=dev)
                   * mask[:, None, :] for x in (d_geom, d_featsT))
    for tag, (dg, df) in (("the tile backward's cotangents",
                           (d_geom, d_featsT)), ("seeded cotangents", seeded)):
        want = tc.packet_gather_bwd_plain(dg, df, idx, mask, n)
        got = tc.packet_gather_bwd(dg, df, idx, mask, n)
        again = tc.packet_gather_bwd(dg, df, idx, mask, n)
        torch.cuda.synchronize()
        diff = got != want
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        check(not bool(diff.any()),
              f"phase {phase} packet gather backward, {tag}: "
              f"{int(diff.sum())} of {diff.numel()} values differ from the "
              f"plain version, max rel err {float(rel.max()):.3e}")
        check(torch.equal(got, again),
              f"phase {phase} packet gather backward, {tag}: two launches "
              "differ")
        check(bool((got[~hit] == 0).all()),
              f"phase {phase} packet gather backward, {tag}: a Gaussian in "
              "no live slot has a nonzero gradient")
    del got, again, want, rel, seeded
    ms = cuda_ms(lambda: tc.packet_gather_bwd(d_geom, d_featsT, idx, mask,
                                              n), 20)
    library_ms = cuda_ms(lambda: tc.packet_gather_bwd_plain(
        d_geom, d_featsT, idx, mask, n), 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tc.packet_gather_bwd(d_geom, d_featsT, idx, mask, n)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern = {}
    for e in rows:
        m = re.search(r"packet_indexing_backward\w*", e.key)
        if m:
            kern[m.group(0)] = kern.get(m.group(0), 0.0) \
                + e.self_device_time_total / 1e3
    kern_ms = sum(kern.values())
    all_ms = sum(e.self_device_time_total for e in rows) / 1e3
    cols = tc.TABLE_GEOM + tc.FEATURE_DIM
    d_rows = torch.cat([d_geom[:, :tc.TABLE_GEOM].transpose(1, 2),
                        d_featsT.transpose(1, 2)], -1).reshape(-1, cols)
    flat = idx.reshape(-1).long()
    live = mask.reshape(-1)
    spread = torch.where(live, flat,
                         torch.arange(len(flat), device=dev) % n)
    live_idx, live_rows = flat[live], d_rows[live]
    put = {name: cuda_ms(lambda i=i, r=r: d_rows.new_zeros((n, cols))
                         .index_put_((i,), r, accumulate=True), 3)
           for name, i, r in (("every slot", flat, d_rows),
                              ("live slots alone", live_idx, live_rows),
                              ("masked slots spread", spread, d_rows))}
    bnd = gather_bound(idx, mask, n, cols)
    zero_hits = int((flat[~live] == 0).sum())
    log(f"phase {phase} packet gather backward: T={t_total}, K={idx.shape[1]}"
        f", N={n}: bit-equal to the plain version on the tile backward's and "
        f"on seeded cotangents, the same bits twice, zeros for the "
        f"{int((~hit).sum())} Gaussians in no live slot; live slots "
        f"{bnd['live']} of {bnd['slots']} = {bnd['live'] / bnd['slots']:.4f}"
        f", masked slots on Gaussian 0: {zero_hits}")
    log(f"phase {phase} packet gather backward: {ms:.4f} ms (CUDA events), "
        f"its kernels {kern_ms:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(kern.items()))
        + f") of {all_ms:.4f} ms of device time in "
        f"one profiled call; the plain version (the library call) "
        f"{library_ms:.3f} ms; index_put_ alone: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in put.items())
        + f" ({card})")
    log(f"phase {phase} packet gather backward: bound {bnd['bound_ms']:.4f} "
        f"ms by bytes ({bnd['bound_bytes']:.4e} B, 4 a value) = "
        f"{bnd['bound_ms'] / ms:.1%} of its rate; a sector a value (no two "
        f"reads sharing one) {bnd['sector_ms']:.4f} ms "
        f"({bnd['sector_bytes']:.4e} B) = {bnd['sector_ms'] / ms:.1%}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=library_ms,
                library_ms=library_ms, kernels_ms=kern_ms, put_ms=put,
                bound=bnd)


def noised_start(scene, noise: float, seed: int = 5):
    """The scene with sh_coeffs + noise * N(0, 1) (numpy-seeded)."""
    z = np.random.default_rng(seed).normal(size=scene.sh_coeffs.shape)
    return scene.replace(sh_coeffs=scene.sh_coeffs + torch.from_numpy(
        (noise * z).astype(np.float32)).to(scene.sh_coeffs.device))


def fit_run(tc, scene, cams, settings, cfg, steps: int, lr: float,
            noise: float) -> dict:
    """fit_scene_tiled (every leaf trained) on the card from a noised start
    toward targets the port renders from the true scene; the launch counts
    after each step, the step times and the metrics."""
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        render_tiled_fused,
    )
    from pathtracer_gaussiansplatting_tpu_torch.utils import metrics

    with torch.no_grad():
        targets = [render_tiled_fused(scene, c, settings, cfg)["color"]
                   for c in cams]
        start = noised_start(scene, noise)
        psnr0 = float(metrics.psnr(render_tiled_fused(
            start, cams[0], settings, cfg)["color"], targets[0]))
    marks = []

    def progress(i, loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), *launch_counts(
            "tile_fwd", "tile_bwd", "packet_gather_bwd")))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches("tile_fwd", "tile_bwd", "packet_gather_bwd")
    t0 = time.perf_counter()
    _, losses, final = train.fit_scene_tiled(
        start, cams, targets, settings, steps=steps, lr=lr, config=cfg,
        progress=progress)
    torch.cuda.synchronize()
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip([(t0,)] + marks, marks)]
    return dict(losses=losses, psnr0=psnr0, final=final, step_ms=step_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                counts=[m[1:] for m in marks], targets=targets, start=start,
                steps=steps, lr=lr, noise=noise)


def check_fit_ran(tr: dict) -> None:
    """One forward, one backward and one packet gather backward launch per
    step, finite losses."""
    check(tr["counts"] == [(i + 1,) * 3 for i in range(tr["steps"])],
          f"training launches per step (fwd, bwd, gather bwd) "
          f"{tr['counts']}, not one each")
    check(bool(np.isfinite(tr["losses"]).all()),
          f"non-finite losses {tr['losses']}")


def check_learned(losses, psnr0: float, psnr1: float, n_poses: int,
                  name: str) -> None:
    """Each pose's last loss below its first, and the PSNR on pose 0 up."""
    for p in range(n_poses):
        check(losses[p::n_poses][-1] < losses[p],
              f"{name}: pose {p} loss did not fall: {losses[p::n_poses]}")
    check(psnr1 > psnr0,
          f"{name}: PSNR did not rise: {psnr0:.3f} -> {psnr1:.3f} dB")


def sh_run(scene, cams, settings, cfg, steps: int, lr: float,
           noise: float) -> dict:
    """make_tiled_train_step with Adam on sh_coeffs alone (the geometry
    held), from sh_coeffs + noise * N(0, 1)."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        render_tiled_fused,
    )
    from pathtracer_gaussiansplatting_tpu_torch.utils import metrics

    with torch.no_grad():
        targets = [render_tiled_fused(scene, c, settings, cfg)["color"]
                   for c in cams]
    params = SceneParams.from_scene(noised_start(scene, noise))
    opt = train.make_optimizer(lr)
    opt_state = opt([params.sh_coeffs])
    step = train.make_tiled_train_step(settings, opt, config=cfg)

    def psnr():
        with torch.no_grad():
            return float(metrics.psnr(render_tiled_fused(
                params.scene(), cams[0], settings, cfg)["color"], targets[0]))

    psnr0 = psnr()
    losses = [float(step(params, opt_state, cams[i % len(cams)],
                         targets[i % len(cams)])[2]) for i in range(steps)]
    return dict(losses=losses, psnr0=psnr0, psnr1=psnr())


def log_fit(tag: str, tr: dict, res: int, card: str) -> float:
    """Logs a fit_run; returns the median ms of its later pose-0 steps
    (steps 3, 5, ...: the two poses' steps differ in cost)."""
    med = statistics.median(tr["step_ms"][1:])
    pose0 = statistics.median(tr["step_ms"][2::2])
    pose1 = statistics.median(tr["step_ms"][1::2])
    log(f"{tag}: fit_scene_tiled, 1M Gaussians, {res}x{res}, K=256, "
        f"sh noise {tr['noise']}, {tr['steps']} steps, lr {tr['lr']}, every "
        f"leaf trained: losses "
        f"{', '.join(f'{x:.6f}' for x in tr['losses'])}; PSNR pose 0 "
        f"{tr['psnr0']:.3f} -> {tr['final']['psnr']:.3f} dB, SSIM "
        f"{tr['final']['ssim']:.4f}; launches (fwd, bwd, gather bwd) after "
        f"the last "
        f"step {tr['counts'][-1]} ({card})")
    log(f"{tag}: step ms {', '.join(f'{m:.2f}' for m in tr['step_ms'])} "
        f"(median of 2-{tr['steps']} {med:.2f}; pose 0 {pose0:.2f}, pose 1 "
        f"{pose1:.2f}); fwd+bwd {res * res / (med * 1e-3):.4e} rays/s; peak "
        f"memory {tr['peak_gib']:.2f} GiB ({card})")
    return pose0


def small_slice_check(small, cam_kw, cfg, settings, key, dev) -> float:
    """The slice end to end at a small size, 2 jittered samples through
    prepare_tiles and render_prepared: the card (kernel) against the CPU
    (plain) within the kernel tolerance; the max abs error."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        accumulate,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles, render_prepared,
    )

    imgs = []
    for device in (dev, torch.device("cpu")):
        c = Camera(**{**cam_kw, "c2w": cam_kw["c2w"].to(device)})
        pk = prepare_tiles(small.to(device), c, settings, cfg)
        acc = torch.zeros((c.height, c.width, 3), device=device)
        for f in range(2):
            jit = rng.subpixel_jitter(key, c.height, c.width, f, device=device)
            out = render_prepared(pk, c, settings, cfg, jitter=jit,
                                  outputs=("color",))
            acc = accumulate(acc, out["color"], f)
        imgs.append(acc.cpu())
    return compare(imgs[0], imgs[1],
                   f"small slice at tile size {cfg.tile_size}, card vs CPU")


def small_train_check(scene, cam_kw, cfg, settings, dev) -> dict:
    """Three fit steps of the small scene on the card and on the CPU at
    transmittance_min=0: step-0 scene gradients within 1e-3 of each leaf's
    max |g| (plus rtol 2e-3), losses within rtol 1e-3 (Adam's first step
    is ~lr sign(g), so a near-zero gradient that differs in sign between
    the two moves its parameter by 2 lr)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        SCENE_FIELDS,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        render_tiled_fused,
    )

    settings = dataclasses.replace(settings, transmittance_min=0.0)
    cpu = torch.device("cpu")
    cams = {d: [Camera(**{**cam_kw, "c2w": look_at(eye, (0.0, 0.0, 0.0),
                                                   device=d)})
                for eye in ((0.0, 0.5, 4.0), (2.5, 0.5, 2.5))]
            for d in (dev, cpu)}
    with torch.no_grad():
        targets = [render_tiled_fused(scene, c, settings, cfg)["color"]
                   for c in cams[cpu]]
    start = noised_start(scene, 0.15, seed=6)
    grads, losses = {}, {}
    for d in (dev, cpu):
        params = SceneParams.from_scene(start.to(d))
        opt = train.make_optimizer(2e-2)
        step = train.make_tiled_train_step(settings, opt, config=cfg)
        step(params, opt(params.parameters()), cams[d][0], targets[0].to(d))
        grads[d] = {f: getattr(params.grad_scene(), f).cpu()
                    for f in SCENE_FIELDS}
        losses[d] = train.fit_scene_tiled(
            start.to(d), cams[d], [t.to(d) for t in targets], settings,
            steps=3, lr=2e-2, config=cfg)[1]
    grad_err = 0.0
    for f in SCENE_FIELDS:
        scale = float(grads[cpu][f].abs().max())
        if scale > 0:
            grad_err = max(grad_err, compare(
                grads[dev][f], grads[cpu][f], f"small step-0 grad {f}",
                rtol=2e-3, atol=1e-3 * scale) / scale)
        else:
            check(bool((grads[dev][f] == 0).all()),
                  f"small step-0 grad {f}: nonzero on the card, 0 on the CPU")
    loss_err = compare(torch.tensor(losses[dev]), torch.tensor(losses[cpu]),
                       "small fit losses", rtol=1e-3, atol=0.0)
    return dict(grad=grad_err, loss=loss_err / max(losses[cpu]))


def pt_world(n: int, width: int, height: int, device):
    """The path-trace bench's scene (bench.py:124-128) with one point light
    inside the room: (scene, light, camera)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        make_punctual_lights,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    scene = surface_scene(n, seed=13, device=device)
    light = make_punctual_lights(position=[[0.6, 0.9, -0.4]],
                                 intensity=[4.0], color=[[1.0, 0.95, 0.85]],
                                 light_type=[0], device=device)
    cam = Camera(c2w=look_at(PT_EYE, PT_TARGET, device=device),
                 fov_y_deg=60.0, width=width, height=height)
    return scene, light, cam


def _topk_key(want, sort_depths):
    """The plain version's sort key per slot: t, or the slot's sort depth."""
    return want[1] if sort_depths is None \
        else sort_depths[want[0].long()]


def topk_check(dt, args, name: str, phase: str = "5a") -> float:
    """dense_topk on args (origins, dirs, DenseTable, K, settings[,
    sort_depths, active]) in one launch against dense_topk_plain on the
    same rays and the table's rows: idx equal wherever the key is valid and
    not tied, t and alpha bit-equal (the cull drops only pairs whose exact
    alpha is 0). Returns the max abs error of alpha (0)."""
    o, d, table, k, settings, *rest = args
    got = dt.dense_topk(*args)
    want = dt.dense_topk_plain(o, d, table.rows, k, settings, *rest)
    torch.cuda.synchronize()
    valid = want[2] > 0
    key = _topk_key(want, rest[0] if rest else None)
    eq = key[:, 1:] == key[:, :-1]
    tied = torch.zeros_like(valid)
    tied[:, 1:] |= eq
    tied[:, :-1] |= eq
    idx_bad = int((valid & ~tied & (got[0] != want[0])).sum())
    n_t = int((got[1] != want[1]).sum())
    n_a = int((got[2] != want[2]).sum())
    err_a = float((got[2] - want[2]).abs().max())
    log(f"phase {phase} {name}: dense_topk R={o.shape[0]}, "
        f"N={table.rows.shape[0]}, K={k}: {int(valid.sum())} valid slots, "
        f"{int((valid & tied).sum())} tied; idx mismatches (valid, untied) "
        f"{idx_bad}; t differs in {n_t} slots, alpha in {n_a} (max abs "
        f"{err_a:.3e})")
    check(idx_bad == 0 and n_t == 0 and n_a == 0,
          f"{phase} {name}: dense_topk not bit-equal to its plain version "
          f"({idx_bad} idx, {n_t} t, {n_a} alpha)")
    return err_a


def vis_check(dt, args, name: str, phase: str = "5a") -> float:
    """dense_visibility on args (origins, dirs, t_end, DenseTable,
    settings[, active]) in one launch against dense_visibility_plain on the
    same segments, within VIS_RTOL / VIS_ATOL."""
    o, d, t_end, table, settings, *rest = args
    got = dt.dense_visibility(*args)
    want = dt.dense_visibility_plain(o, d, t_end, table.rows, settings, *rest)
    torch.cuda.synchronize()
    err = compare(got, want, f"{phase} {name} vis", rtol=VIS_RTOL,
                  atol=VIS_ATOL)
    live = rest[0] if rest and rest[0] is not None \
        else torch.ones_like(want, dtype=torch.bool)
    log(f"phase {phase} {name}: dense_visibility R={o.shape[0]}: "
        f"{int(live.sum())} active, {int((got == want).sum())} bit-equal, "
        f"max abs err {err:.3e} (rtol {VIS_RTOL}, atol {VIS_ATOL}), mean "
        f"vis {float(want[live].mean()):.5f}")
    return err


def contributing_pairs(dt, o, d, rows, settings, active=None, t_end=None,
                       rays_per_pass: int = 1024) -> int:
    """(live ray, Gaussian) pairs whose exact alpha is > 0 (the plain
    math, for the trace or, given t_end, for shadow segments), counted in
    torch over ray chunks on the card."""
    from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops

    mean, m, opac = dt._unpack(rows)
    count = 0
    for s in range(0, o.shape[0], rays_per_pass):
        e = min(s + rays_per_pass, o.shape[0])
        ro, rd = o[s:e, None], d[s:e, None]
        if t_end is None:
            _, gval = gops.peak_response(ro, rd, mean, m, settings.t_min,
                                         settings.t_max)
            alpha = gops.alpha_from_response(
                opac, gval, settings.alpha_min, settings.alpha_max,
                settings.sigma_cut)
        else:
            alpha = gops.segment_transmittance_alpha(
                ro, rd, mean, m, opac, settings.t_min, t_end[s:e, None],
                settings.alpha_min, settings.alpha_max)
        live = alpha > 0
        if active is not None:
            live &= active[s:e, None]
        count += int(live.sum())
    return count


def dense_bound(dt, counts: dict, n_rays: int, n: int, k: int = 0) -> dict:
    """The bound by code path. The top-K kernel (k > 0; counts from
    cull_counts(supers=True)): the super-group test on every (live ray,
    super-group), the group test on the groups of the super-groups each ray
    reaches, the per-pair cull on the rows of the groups it reaches, the
    exact path's float operations on the pairs kept. The shadow kernel: the
    group test on every (live segment, group), the cull and the exact path
    likewise. Bytes: the rays, the DenseTable (sorted rows, order, group
    spheres, the top-K kernel's super-group spheres) and the outputs once.
    Beside it two figures that do not depend on the kernel's design: the
    function's bound (the rays, the (N, 16) table and the outputs once,
    the exact path on the pairs with alpha > 0 alone) and the all-pairs
    figure (every live pair charged the exact path, as an unculled kernel
    does)."""
    n_groups = -(-n // dt.GROUP_ROWS)
    groups = n_groups * dt.GROUP_COLS
    if k:   # rays in, the index-order rows' recount, (R, K) outputs
        ray_bytes = 4.0 * n_rays * (6 + k * 3)
        supers = -(-n_groups // dt.SUPER_GROUPS) * dt.GROUP_COLS
        n_bytes = ray_bytes + 4.0 * (n * (2 * dt.TABLE_COLS + 1) + groups
                                     + supers)
    else:   # rays, t_end and the vis out, the active bytes
        ray_bytes = 4.0 * n_rays * 8 + n_rays
        n_bytes = ray_bytes + 4.0 * (n * dt.TABLE_COLS + groups)
    flops = (counts.get("super_tests", 0) + counts["group_tests"]) \
        * DENSE_GROUP_FLOPS + counts["tested"] * DENSE_CULL_FLOPS \
        + counts["kept"] * DENSE_PAIR_FLOPS
    res = bound(n_bytes, flops)
    fn_bytes = ray_bytes + 4.0 * n * dt.TABLE_COLS
    res["function"] = bound(fn_bytes,
                            counts["contributing"] * DENSE_PAIR_FLOPS)
    res["function_bound_ms"] = res["function"]["bound_ms"]
    res["all_pairs_bound_ms"] = bound(
        n_bytes, counts["live_groups"] * dt.GROUP_ROWS
        * DENSE_PAIR_FLOPS)["bound_ms"]
    return res


def topk_counts_line(r: dict) -> str:
    """The top-K kernel's culls on a chunk, as 5a, 10d and 14a print them
    (``r``: cull_counts(supers=True) with "contributing")."""
    return (f"{r['super_tests']} super-group tests leave {r['group_tests']} "
            f"group tests ({r['group_tests'] / max(r['live_groups'], 1):.2%} "
            f"of one a (ray, group)); the cull tests {r['tested']} pairs and "
            f"keeps {r['kept']} ({r['kept'] / max(r['tested'], 1):.4%}), "
            f"{r['contributing']} have alpha > 0; the exact path's turns "
            f"{r['exact_turns']} ({r['exact_turns'] / max(r['live'], 1):.2f} "
            f"a ray, {r['kept'] / max(32 * r['exact_turns'], 1):.1%} of "
            f"their lanes busy)")


def topk_launch_bound(dt, args, phase: str, card: str, ms: float,
                      rays_per_pass: int = 512) -> dict:
    """The culls' counts and both bounds of one dense_topk launch on args
    (origins, dirs, DenseTable, K, settings[, sort_depths, active]),
    counted in torch on the card and printed beside its time ``ms``:
    bound_ms and function_bound_ms."""
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    o, d, table, k, st, *rest = args
    active = rest[1] if len(rest) > 1 else None
    cnt = tch.cull_counts(dt, o, d, table, st, active,
                          rays_per_pass=rays_per_pass, supers=True)
    cnt["contributing"] = contributing_pairs(
        dt, o, d, table.rows, st, active, rays_per_pass=rays_per_pass)
    bnd = dense_bound(dt, cnt, o.shape[0], table.rows.shape[0], k)
    log(f"phase {phase}: dense_topk (R={o.shape[0]}, "
        f"N={table.rows.shape[0]}, K={k}, {cnt['live']} rays live) "
        f"{ms:.3f} ms; " + topk_counts_line(cnt) + f"; bound by code path "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
        f"({bnd['bound_flops']:.4e} flops, {bnd['bound_bytes']:.4e} bytes) "
        f"= {bnd['bound_ms'] / ms:.1%} of its rate; the function's bound "
        f"{bnd['function_bound_ms']:.4f} ms = "
        f"{bnd['function_bound_ms'] / ms:.1%} ({card})")
    return dict(bound_ms=bnd["bound_ms"],
                function_bound_ms=bnd["function_bound_ms"])


def dense_kernel_checks(dt, scene, light, cam, settings, card) -> dict:
    """Phase 5a: both dense kernels against their plain versions on
    dense_chunks' chunks and on four chunks of primary rays in one launch,
    each kernel timed on each chunk, with the cull's counts and the bound
    recounted by code path."""
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    cull_counts = tch.cull_counts
    zero_launches("dense_topk")
    ch = tch.dense_chunks(dt, scene, light, cam, settings, PT_CHUNK)
    table, k, bo = ch["table"], ch["k"], ch["origins"]
    topk_chunks, vis_chunks = ch["topk"], ch["vis"]
    n = table.rows.shape[0]
    o, d = topk_chunks[0][1:]
    l_dir, t_end_e, act_e = vis_chunks[0][1:]
    err_a = max(topk_check(dt, (co, cd, table, k, settings), name)
                for name, co, cd in topk_chunks)
    err_v = max(vis_check(dt, (bo, cd, te, table, settings, act), name)
                for name, cd, te, act in vis_chunks)
    # Four chunks of primary rays in one launch: held to the plain version
    # as the chunks are, and timed (whether one chunk's wave of blocks
    # leaves the card idle).
    wide = (*ch["wide"], table, k, settings)
    err_a = max(err_a, topk_check(
        dt, wide, f"the first {4 * PT_CHUNK} primary rays in one launch"))
    log(f"phase 5a: dense_topk launched {launch.launches['dense_topk']} "
        f"times (the pose's primary trace in dense_chunks, then one a chunk "
        f"checked)")

    res = {}
    for name, co, cd in topk_chunks:
        cnt = cull_counts(dt, co, cd, table, settings, supers=True)
        cnt["contributing"] = contributing_pairs(dt, co, cd, table.rows,
                                                 settings)
        res[name] = dict(ms=cuda_ms(lambda: dt.dense_topk(
            co, cd, table, k, settings), 5), **cnt,
            **dense_bound(dt, cnt, PT_CHUNK, n, k))
    for name, cd, te, act in vis_chunks:
        cnt = cull_counts(dt, bo, cd, table, settings, act, te)
        cnt["contributing"] = contributing_pairs(dt, bo, cd, table.rows,
                                                 settings, act, te)
        res[name] = dict(ms=cuda_ms(lambda: dt.dense_visibility(
            bo, cd, te, table, settings, act), 5), **cnt,
            **dense_bound(dt, cnt, PT_CHUNK, n))
    for name, r in res.items():
        if "shadow" in name:
            counts = (
                f"dense_visibility {r['ms']:.3f} ms (CUDA events, 5 "
                f"launches); warps skip {1 - r['warp_group_share']:.4%} of "
                f"(warp, group) pairs; the cull tests {r['tested']} pairs "
                f"and keeps {r['kept']} "
                f"({r['kept'] / max(r['tested'], 1):.4%}), "
                f"{r['contributing']} have alpha > 0; some lane keeps "
                f"{r['warp'] / r['warps']:.4%} of (warp, row) pairs, the "
                f"warp's exact-path turns are {r['turns'] / r['warps']:.4%} "
                f"of them")
        else:
            counts = (f"dense_topk {r['ms']:.3f} ms (CUDA events, 5 "
                      f"launches); " + topk_counts_line(r))
        log(f"phase 5a {name}: {counts}; "
            f"bound by code path {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bound_flops']:.4e} flops, {r['bound_bytes']:.4e} bytes), "
            f"{r['bound_ms'] / r['ms']:.1%} of its rate; the function's "
            f"bound (the exact path on the pairs with alpha > 0 alone) "
            f"{r['function_bound_ms']:.4f} ms, "
            f"{r['function_bound_ms'] / r['ms']:.1%}; all-pairs bound "
            f"(every pair charged the exact path) "
            f"{r['all_pairs_bound_ms']:.4f} ms ({card})")
    wide_ms = cuda_ms(lambda: dt.dense_topk(*wide), 5)
    log(f"phase 5a: dense_topk on the pose's first {4 * PT_CHUNK} primary "
        f"rays {wide_ms:.3f} ms, {wide_ms / 4:.3f} ms per {PT_CHUNK} "
        f"(CUDA events, 5 launches; {card})")
    topk_plain_ms = cuda_ms(
        lambda: dt.dense_topk_plain(o, d, table.rows, k, settings), 1)
    vis_plain_ms = cuda_ms(lambda: dt.dense_visibility_plain(
        bo, l_dir, t_end_e, table.rows, settings, act_e), 1)
    pairs = {}
    for name, cd, te, act in vis_chunks:
        pairs[name] = pairs_check(dt, (bo, cd, te, table, settings, act),
                                  name, res[name], card)
    topk, vis = res["primary rays"], res["emissive shadow segments"]
    pairs_plain_ms = cuda_ms(lambda: dt.dense_visibility_pairs_plain(
        bo, l_dir, t_end_e, table.rows, settings, act_e), 1)
    log(f"phase 5a: dense_topk kernel {topk['ms']:.3f} ms, plain "
        f"{topk_plain_ms:.3f} ms; dense_visibility kernel {vis['ms']:.3f} "
        f"ms, plain {vis_plain_ms:.3f} ms (R={PT_CHUNK}, N={n}; CUDA events; "
        f"{card})")
    shapes = [dict(name=f"5a {name}, K={k}", ms=res[name]["ms"],
                   bound_ms=res[name]["bound_ms"],
                   function_bound_ms=res[name]["function_bound_ms"])
              for name, _, _ in topk_chunks[1:]]
    shapes.append(dict(name=f"5a the first {4 * PT_CHUNK} primary rays, "
                            f"K={k}", ms=wide_ms))
    return dict(topk=dict(topk, max_abs_err=err_a, plain_ms=topk_plain_ms),
                topk_shapes=shapes,
                vis=dict(vis, max_abs_err=err_v, plain_ms=vis_plain_ms),
                pairs=dict(pairs["emissive shadow segments"],
                           plain_ms=pairs_plain_ms))


def pairs_check(dt, args, name: str, res: dict, card: str) -> dict:
    """Phase 5a, the shadow kernel's listing modes (visibility_dense's
    gradient on the card): dense_visibility_pairs on args (origins, dirs,
    t_end, DenseTable, settings, active) gives vis bit-equal to the plain
    launch's and exactly the pairs with alpha > 0 of the plain version;
    timed beside the plain launch (``res``, its 5a result). Its bound by
    code path charges the plain launch's work (``res``) once for the
    counting launch and once more for the listing launch where there is a
    pair, with the counts, the offsets and the list; the function's bound
    is the plain launch's with the counts and the list written once."""
    o, d, t_end, table, settings, act = args
    got = dt.dense_visibility_pairs(*args)
    plain_launch = dt.dense_visibility(*args)
    want = dt.dense_visibility_pairs_plain(o, d, t_end, table.rows,
                                           settings, act)
    torch.cuda.synchronize()
    n = table.rows.shape[0]
    key_got = torch.sort(got[1] * n + got[2]).values
    key_want = torch.sort(want[1] * n + want[2]).values
    check(torch.equal(got[0], plain_launch),
          f"5a {name}: the counting launch's vis differs from the plain "
          "launch's")
    check(key_got.shape == key_want.shape and torch.equal(key_got, key_want),
          f"5a {name}: listed {key_got.numel()} pairs, the plain version "
          f"has {key_want.numel()} with alpha > 0 (or others)")
    ms = cuda_ms(lambda: dt.dense_visibility_pairs(*args), 5)
    r, m = o.shape[0], key_got.numel()
    passes = 2 if m else 1
    bnd = bound(passes * res["bound_bytes"] + 4.0 * r
                + (8.0 * r + 4.0 * m if m else 0.0),
                passes * res["bound_flops"])
    fn = res["function"]
    bnd["function_bound_ms"] = bound(fn["bound_bytes"] + 4.0 * (r + m),
                                     fn["bound_flops"])["bound_ms"]
    log(f"phase 5a {name}: dense_visibility_pairs: vis bit-equal to the "
        f"plain launch, the {m} pairs with alpha > 0 listed exactly; "
        f"{ms:.3f} ms for its {passes} launch(es) against {res['ms']:.3f} "
        f"ms for the plain launch; bound by code path ({passes} pass(es)) "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, the function's "
        f"{bnd['function_bound_ms']:.4f} ms (CUDA events; {card})")
    return dict(ms=ms, max_abs_err=float((got[0] - want[0]).abs().max()),
                **bnd)


def dense_grad_check(dev, card) -> dict:
    """Phase 5e: gradients of render_radiance_dense through the card's
    kernel (it selects, torch recomputes t and alpha) against the CPU's,
    at phase 1's small cloud (2000 Gaussians, sigma 0.17-0.45, so no pair
    sits at a cutoff), 64x48: every leaf within DENSE_GRAD_TOL of its
    largest CPU gradient, and the geometry's non-zero on the card."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref

    names = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs")
    base = random_cloud(2000, seed=7, spread=1.2, scale_range=(-1.8, -0.8),
                        device="cpu")
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (64 * 48, 3)).astype(np.float32))
    grads = []   # the card's, then the CPU's
    for device in (dev, torch.device("cpu")):
        scene = base.to(device).replace(**{
            k: getattr(base, k).to(device, copy=True).requires_grad_(True)
            for k in names})
        rays = generate_rays(Camera(
            c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=device),
            fov_y_deg=50.0, width=64, height=48))
        loss = (w.to(device) * ref.render_radiance_dense(scene, rays,
                                                         settings)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(
            loss, [getattr(scene, k) for k in names])])
    errs = []
    for k, g, c in zip(names, *grads):
        scale = float(c.abs().max())
        errs.append(float((g - c).abs().max()) / max(scale, 1e-30))
        check(float(g.abs().max()) > 0 and scale > 0,
              f"5e: zero gradient for {k}")
        check(errs[-1] <= DENSE_GRAD_TOL,
              f"5e: {k} gradient card vs CPU {errs[-1]:.3e} of its max")
    log("phase 5e: render_radiance_dense gradients (2000 Gaussians, 64x48) "
        "card vs CPU, max err over the leaf's max |g|: "
        + ", ".join(f"{k} {e:.3e}" for k, e in zip(names, errs))
        + f" (allowed {DENSE_GRAD_TOL}); every leaf non-zero on the card "
        f"({card})")
    return shadow_grad_check(base, dev, card)


def shadow_grad_check(base, dev, card) -> dict:
    """Phase 5e, shadows: gradients of visibility_dense on the card (the
    kernel's value, the listed pairs' alpha recomputed in torch) against
    the CPU's (autograd through the plain version), on 5e's cloud: 3072
    segments from a sphere of radius 2.4 around it toward its first 200
    Gaussians (the ones random_cloud makes emissive at emissive_frac 0.1),
    a quarter of the way (the cloud is opaque deeper in). Geometry and
    opacity within DENSE_GRAD_TOL of each leaf's largest CPU gradient and
    non-zero on the card, the value equal to the no-grad launch's; the
    pair-listing launches counted."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        dense_trace as dt,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref

    names = ("means", "log_scales", "quats", "opacity_logits")
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    rng = np.random.default_rng(11)
    n = 3072
    u = rng.normal(size=(n, 3))
    o = torch.from_numpy((2.4 * u / np.linalg.norm(u, axis=-1, keepdims=True))
                         .astype(np.float32))
    v = base.means[torch.arange(n) % 200] - o
    t_end = 0.25 * v.norm(dim=-1)
    d = v / v.norm(dim=-1, keepdim=True)
    w = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, n).astype(np.float32))
    grads, vis = [], []
    zero_launches("dense_visibility_pairs")
    for device in (dev, torch.device("cpu")):
        scene = base.to(device).replace(**{
            k: getattr(base, k).to(device, copy=True).requires_grad_(True)
            for k in names})
        args = (o.to(device), d.to(device), t_end.to(device), settings)
        vis.append(ref.visibility_dense(scene, *args))
        grads.append([g.cpu() for g in torch.autograd.grad(
            (w.to(device) * vis[-1]).sum(),
            [getattr(scene, k) for k in names])])
        if device == dev:
            launches = launch.launches["dense_visibility_pairs"]
            with torch.no_grad():
                check(torch.equal(vis[-1], ref.visibility_dense(scene,
                                                                *args)),
                      "5e: the grad path's vis differs from the no-grad "
                      "launch's")
    check(launches == 2, f"5e: {launches} pair-listing launches, not 2")
    vis_err = compare(vis[0].detach().cpu(), vis[1].detach(),
                      "5e shadow vis, card vs CPU", rtol=VIS_RTOL,
                      atol=VIS_ATOL)
    errs = []
    for k, g, c in zip(names, *grads):
        scale = float(c.abs().max())
        errs.append(float((g - c).abs().max()) / max(scale, 1e-30))
        check(float(g.abs().max()) > 0 and scale > 0,
              f"5e: zero shadow gradient for {k}")
        check(errs[-1] <= DENSE_GRAD_TOL,
              f"5e: {k} shadow gradient card vs CPU {errs[-1]:.3e} of its "
              "max")
    vv = vis[1].detach()
    log(f"phase 5e: visibility_dense gradients ({n} segments, mean vis "
        f"{float(vv.mean()):.4f}, {float(((vv > 0.05) & (vv < 0.95)).float().mean()):.1%}"
        f" in (0.05, 0.95)) card vs CPU, max err over the leaf's max |g|: "
        + ", ".join(f"{k} {e:.3e}" for k, e in zip(names, errs))
        + f" (allowed {DENSE_GRAD_TOL}); vis max abs err {vis_err:.3e}; "
        f"{launches} pair-listing launches ({card})")
    return dict(launches=launches, max_abs_err=vis_err)


def small_pt_check(dev, settings, backend: str = "dense",
                   phase: str = "5b") -> None:
    """Phase 5b (6f with the grid backend): one sample of pathtrace (all
    rays as one batch) and one of pathtrace_camera, on the card and on the
    CPU, 2000 Gaussians, 96x64, the same key; at depth 1 (emission and
    direct light) and at the full depth."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        generate_rays,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        pathtrace, pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )

    for depth, min_share in ((1, PT_MIN_SHARE),
                             (settings.max_depth, PT_DEEP_MIN_SHARE)):
        st = dataclasses.replace(settings, max_depth=depth)
        outs = []
        for device in (dev, torch.device("cpu")):
            scene, light, cam = pt_world(2000, 96, 64, device)
            key = rng.prng_key(13)
            jit = rng.subpixel_jitter(key, 64, 96, 0, device=device)
            be = make_trace_backend(scene, st, backend)
            outs.append((
                pathtrace(scene, generate_rays(cam), st, key,
                          punctual=light, backend=be).cpu(),
                pathtrace_camera(scene, cam, st, key, punctual=light,
                                 jitter=jit, backend=be).cpu()))
        for i, name in enumerate(("pathtrace", "pathtrace_camera")):
            pt_gates(phase, name, outs[0][i], outs[1][i], min_share, st,
                     f"{backend} backend, 2000 Gaussians, 96x64")


def pt_gates(phase: str, name: str, got, want, min_share: float, st,
             what: str, mean_frac: float = PT_MEAN_FRAC) -> None:
    """A path-traced sample on the card (got) against the CPU (want): at
    least min_share of the pixels within the kernel tolerance, the mean
    absolute difference within mean_frac of the image mean."""
    g, w = got.double(), want.double()
    ok = ((g - w).abs() <= ATOL + RTOL * w.abs()).all(-1)
    share = float(ok.double().mean())
    mean_abs = float((g - w).abs().mean())
    depth = st.max_depth
    log(f"phase {phase} {name} ({what}, depth {depth}, "
        f"rr_start {st.rr_start_depth}, opaque_depth "
        f"{st.opaque_depth}): card vs CPU {share:.4%} of pixels "
        f"within rtol {RTOL} / atol {ATOL} (need {min_share:.0%}); "
        f"mean abs diff {mean_abs:.3e} against an image mean of "
        f"{float(w.mean()):.5f} (allowed {mean_frac:.0%} of it); "
        f"max abs diff {float((g - w).abs().max()):.3e}")
    check(bool(torch.isfinite(g).all()),
          f"{phase} {name}: not finite")
    check(share >= min_share, f"{phase} {name}, depth {depth}: only "
          f"{share:.4%} of pixels match")
    check(mean_abs <= mean_frac * float(w.mean()),
          f"{phase} {name}, depth {depth}: mean abs diff "
          f"{mean_abs:.3e}")


class HostTimer:
    """Wraps a function of a module so that each call is timed on the host
    clock between two synchronizes (and, with ``keep``, its arguments kept
    in ``calls`` and its results in ``results``); restores it on exit."""

    def __init__(self, module, name: str, keep: bool = False):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.ms, self.calls, self.results = [], [], []

    def __enter__(self):
        def timed(*args, **kw):
            if self.keep:
                self.calls.append((args, kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*args, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if self.keep:
                self.results.append(out)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


class FirstCalls:
    """Wraps a function of a module so that it keeps the arguments of its
    first call for each value of ``kind(kw)`` in ``calls`` (tensors cloned);
    restores it on exit."""

    def __init__(self, module, name: str, kind=lambda kw: None):
        self.module, self.name, self.kind = module, name, kind
        self.orig = getattr(module, name)
        self.calls = {}

    def __enter__(self):
        def keep(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        def recorded(*args, **kw):
            k = self.kind(kw)
            if k not in self.calls:
                self.calls[k] = ([keep(a) for a in args],
                                 {n: keep(v) for n, v in kw.items()})
            return self.orig(*args, **kw)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


PT_OP_RANGES = dict(rng="ptgs.rng", bsdf_nee="ptgs.shade")


def profile_split(name: str, fn, wall_ms: float, card: str,
                  names=DENSE_PROFILE_NAMES,
                  op_ranges=PT_OP_RANGES) -> dict:
    """One run of fn under torch.profiler (the second of two): device time
    split into the hand-written kernels (``names``: label -> a substring of
    the kernel's name), the kernels of the ops inside host ranges
    (``op_ranges``: label -> a substring of the range's name; by default
    the random draws, ptgs.rng, and shading, ptgs.shade) and the rest,
    each part's launches beside its ms. The op table goes to OUT_DIR."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ptgs.")]

    def kern(sub=None):
        return sum(e.self_device_time_total for e in kernels
                   if sub is None or sub in e.key) / 1e3

    total = kern()
    # A kernel launched by an aten op is linked to it; an op counts toward
    # a range when its host interval lies inside one (nested or
    # overlapping ranges merged). The hand-written kernels, launched
    # through ctypes, are linked to no op and are counted by name.
    raw = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def merged(sub):
        spans = sorted((e.time_range.start, e.time_range.end) for e in raw
                       if sub in e.name)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    ranges = {label: merged(sub) for label, sub in op_ranges.items()}

    def inside(e, label):
        r = ranges[label]
        i = bisect.bisect_right(r, (e.time_range.start, math.inf))
        return i > 0 and e.time_range.end <= r[i - 1][1]

    split = {label: kern(sub) for label, sub in names.items()}
    counts = {label: sum(e.count for e in kernels if sub in e.key)
              for label, sub in names.items()}
    split.update({label: 0.0 for label in op_ranges})
    counts.update({label: 0 for label in op_ranges})
    for e in raw:
        # A named kernel counts by its name alone, wherever it launched.
        ks = [k for k in e.kernels
              if not any(sub in k.name for sub in names.values())]
        ms = sum(k.duration for k in ks) / 1e3
        for label in op_ranges:
            if ms and inside(e, label):
                split[label] += ms
                counts[label] += len(ks)
                break
    split["rest"] = total - sum(split.values())
    counts["rest"] = sum(e.count for e in kernels) - sum(counts.values())
    os.makedirs(OUT_DIR, exist_ok=True)
    table = os.path.join(OUT_DIR, f"profile_{name}.txt")
    with open(table, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total",
                              row_limit=50))
    log(f"profile {name}: device time {total:.3f} ms of {wall_ms:.3f} ms "
        f"wall = {total / wall_ms:.1%} busy, "
        f"{sum(e.count for e in kernels)} kernel launches; split (ms, "
        f"launches): "
        + ", ".join(f"{k} {v:.3f} ({counts[k]})" for k, v in split.items())
        + f"; table {os.path.relpath(table, ROOT)} ({card})")
    return split


def check_pt_image(img: np.ndarray, settings, name: str) -> float:
    check(bool(np.isfinite(img).all()), f"{name}: image not finite")
    check(float(img.min()) >= 0.0, f"{name}: negative radiance")
    check(float(img.max()) <= settings.firefly_clamp + 1e-5,
          f"{name}: radiance above the firefly clamp")
    mean = float(img.mean())
    check(0.05 < mean < 1.5, f"{name}: image mean {mean} outside (0.05, 1.5)")
    return mean


def flat_route(dt, scene, light, cam, settings, card, spp: int) -> dict:
    """Phase 5c: make_accumulating_renderer + render_pose, 65536-ray
    chunks, spp samples; each chunk-sample's pathtrace is timed, and every
    dense call must be served the backend's table."""
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg
    from pathtracer_gaussiansplatting_tpu_torch.render import pipeline

    w, h = cam.width, cam.height
    n_chunks = -(-w * h // PT_CHUNK)
    render_fn = capture.make_accumulating_renderer(scene, settings, light,
                                                   spp, backend="dense")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches("dense_topk", "dense_visibility", "threefry",
                  "dense_composite")
    pipeline.TABLE_MISSES = 0
    with HostTimer(capture, "pathtrace") as timer:
        img, total_ms = host_ms(lambda: capture.render_pose(
            render_fn, cam.c2w, w, h, cam.fov_y_deg, chunk=PT_CHUNK))
    launches = launch_counts("dense_topk", "dense_visibility")
    rng_launches, composite = launch_counts("threefry", "dense_composite")
    check(composite == launches[0], f"5c: dense_composite launched "
          f"{composite} times for {launches[0]} bounce traces")
    check(pipeline.TABLE_MISSES == 0, f"5c: {pipeline.TABLE_MISSES} dense "
          f"calls built their own table")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(timer.ms) == spp * n_chunks, "5c: pathtrace calls")
    sample_ms = [sum(timer.ms[c * spp + f] for c in range(n_chunks))
                 for f in range(spp)]
    med = statistics.median(sample_ms)
    check(launches == (spp * n_chunks * settings.max_depth,
                       2 * spp * n_chunks * settings.max_depth),
          f"5c: kernel launches (dense_topk, dense_visibility) {launches}")
    check(rng_launches == spp * n_chunks * settings.max_depth,
          f"5c: threefry_uniforms launched {rng_launches} times, not once a "
          f"bounce")
    img = img.cpu().numpy()
    mean = check_pt_image(img, settings, "5c")
    jpg = os.path.join(OUT_DIR, f"phase5c_surface_50k_800_{spp}spp.jpg")
    save_jpg(jpg, img)
    log(f"phase 5c: flat route, 50k surface Gaussians + point light, "
        f"{w}x{h}, depth 4, {spp} spp in {n_chunks} chunks of {PT_CHUNK}: "
        f"pose {total_ms:.1f} ms; sample ms "
        f"{', '.join(f'{m:.1f}' for m in sample_ms)} (median {med:.1f}); "
        f"{w * h * spp / (total_ms * 1e-3):.4e} path-traced rays/s; 512 spp "
        f"would take {512 * med / 6e4:.2f} min; launches per sample "
        f"dense_topk {launches[0] // spp}, dense_visibility "
        f"{launches[1] // spp}, dense_composite {composite // spp}, "
        f"threefry_uniforms {rng_launches // spp}; table cache misses 0; "
        f"peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    log(f"phase 5c: image finite, in [0, {settings.firefly_clamp}], mean "
        f"{mean:.5f}, max {img.max():.5f}; saved {os.path.relpath(jpg, ROOT)}")
    one = capture.make_accumulating_renderer(scene, settings, light, 1,
                                             backend="dense")
    split = profile_split("phase5c_sample", lambda: capture.render_pose(
        one, cam.c2w, w, h, cam.fov_y_deg, chunk=PT_CHUNK), med, card)
    return dict(launches=launches, rng=rng_launches, median_ms=med,
                split=split, composite=composite)


def composite_bound(dt, lists, n: int, degree: int) -> dict:
    """The composite's bound by bytes: every slot's alpha (4 B), idx and t
    of each filled slot (8 B), the feature table once, a ray's direction
    (12 B) and its 16 floats out. Flops: a filled slot's SH (6 a basis
    function), the weight, the normal's flip test and the 15 weighted sums
    (39), and 3 a slot for the transmittance scan."""
    idx, _, alpha = lists
    r, k = idx.shape
    filled = int((alpha > 0).sum())
    kb = (degree + 1) ** 2
    n_bytes = 4 * r * k + 8 * filled + 4 * n * dt.composite_cols(degree) \
        + 4 * r * (3 + dt.COMPOSITE_OUT)
    res = bound(n_bytes, filled * (6 * kb + 39) + 3 * r * k)
    res["filled"] = filled / (r * k)
    return res


def composite_checks(dt, dev, card) -> dict:
    """Phase 5f: dense_composite against dense_composite_plain on K1's
    lists of 5a's chunks of the 40k-Gaussian room (the dense capture
    cell's N, R and K), each timed (CUDA events) beside its bound; two
    launches give the same bits."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        Rays, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene, light, cam = pt_world(40_000, 800, 800, dev)
    ch = tch.dense_chunks(dt, scene, light, cam, settings, PT_CHUNK)
    degree = dt.composite_degree(scene, settings)
    table = dt.composite_table(scene, degree)
    shapes, err = [], 0.0
    for name, o, d in ch["topk"]:
        with torch.no_grad():
            lists = ref.dense_topk(scene, Rays(o, d), settings,
                                   table=ch["table"])
        want = dt.dense_composite_plain(*lists, d, table, degree)
        got = dt.dense_composite(*lists, d, table, degree)
        check(torch.equal(got, dt.dense_composite(*lists, d, table, degree)),
              f"5f {name}: two launches differ")
        e = float(((got - want).abs() / (1.0 + want.abs())).max())
        check(e < 1e-5, f"5f {name}: kernel vs plain {e:.3e}")
        err = max(err, e)
        ms = cuda_ms(lambda: dt.dense_composite(*lists, d, table, degree), 20)
        plain_ms = cuda_ms(lambda: dt.dense_composite_plain(
            *lists, d, table, degree), 3)
        bnd = composite_bound(dt, lists, scene.num_gaussians, degree)
        log(f"phase 5f {name} (R={o.shape[0]}, N={scene.num_gaussians}, "
            f"K={lists[0].shape[1]}, {bnd['filled']:.2%} of the slots "
            f"filled): dense_composite {ms:.4f} ms, plain {plain_ms:.3f} ms; "
            f"max err {e:.3e} (of 1 + |plain|); bound {bnd['bound_ms']:.4f} "
            f"ms by {bnd['bound_by']} ({bnd['bound_bytes']:.4e} bytes, "
            f"{bnd['bound_flops']:.4e} flops) = {bnd['bound_ms'] / ms:.1%} "
            f"of its rate ({card})")
        shapes.append(dict(name=f"5f {name}", ms=ms, plain_ms=plain_ms,
                           max_abs_err=e, bound=bnd))
    del scene
    first = shapes[0]
    return dict(first, max_abs_err=err, shapes=[
        dict(name=r["name"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound"]["bound_ms"]) for r in shapes])


def tiled_route(tc, dt, scene, light, cam, settings, card, spp: int) -> dict:
    """Phase 5d: make_tiled_pose_renderer with dense bounces, spp samples,
    the forward tile kernel once per sample, every dense call served the
    backend's table; bounces must add light over a depth-1 render
    (emission and direct light only). Then both dense kernels on the first
    sample's first bounce trace and first shadow march (the whole image in
    one launch) against their plain versions with 5a's gates, and timed
    there."""
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg
    from pathtracer_gaussiansplatting_tpu_torch.render import pipeline

    w, h = cam.width, cam.height
    render = capture.make_tiled_pose_renderer(scene, settings, light, spp,
                                              bounce_backend="dense")
    torch.cuda.synchronize()
    zero_launches("tile_fwd", "dense_topk", "dense_visibility", "threefry")
    pipeline.TABLE_MISSES = 0
    with HostTimer(capture, "prepare_tiles") as prep, \
            HostTimer(capture, "pathtrace_camera") as samples, \
            FirstCalls(dt, "dense_topk") as traces, \
            FirstCalls(dt, "dense_visibility") as marches:
        img = render(cam.c2w, w, h, cam.fov_y_deg)
        torch.cuda.synchronize()
    launches = launch_counts("tile_fwd", "dense_topk", "dense_visibility")
    rng_launches = launch.launches["threefry"]
    check(pipeline.TABLE_MISSES == 0, f"5d: {pipeline.TABLE_MISSES} dense "
          f"calls built their own table")
    check(rng_launches == spp * (settings.max_depth + 1),
          f"5d: threefry_uniforms launched {rng_launches} times, not once a "
          f"bounce and once a jittered sample")
    check(launches[0] == spp, f"5d: the forward tile kernel launched "
          f"{launches[0]} times for {spp} samples")
    check(launches[1:] == (spp * (settings.max_depth - 1),
                           2 * spp * settings.max_depth),
          f"5d: kernel launches (dense_topk, dense_visibility) {launches}")
    img = img.cpu().numpy()
    mean = check_pt_image(img, settings, "5d")
    direct = capture.make_tiled_pose_renderer(
        scene, dataclasses.replace(settings, max_depth=1), light, 1,
        bounce_backend="dense")(cam.c2w, w, h, cam.fov_y_deg).cpu().numpy()
    check(mean > float(direct.mean()),
          f"5d: depth 4 mean {mean} not above depth 1 {direct.mean()}")
    jpg = os.path.join(OUT_DIR, f"phase5d_surface_50k_800_{spp}spp.jpg")
    save_jpg(jpg, img)
    med = statistics.median(samples.ms)
    log(f"phase 5d: tiled route, {w}x{h}, depth 4, {spp} spp: prepare "
        f"{prep.ms[0]:.1f} ms; sample ms "
        f"{', '.join(f'{m:.1f}' for m in samples.ms)} (median {med:.1f}); "
        f"512 spp would take {(prep.ms[0] + 512 * med) / 6e4:.2f} min; "
        f"launches (tile fwd, dense_topk, dense_visibility) {launches}, "
        f"threefry_uniforms {rng_launches}; table cache misses 0 ({card})")
    log(f"phase 5d: image finite, mean {mean:.5f} against {direct.mean():.5f}"
        f" at depth 1 (bounces add {mean / direct.mean() - 1:.1%}); saved "
        f"{os.path.relpath(jpg, ROOT)}")
    (args, kw), (vargs, vkw) = traces.calls[None], marches.calls[None]
    check(not kw and not vkw, "5d: the dense kernels were called with "
          "keywords")
    err_a = topk_check(dt, args, "the first sample's first bounce trace",
                       "5d")
    topk_ms = cuda_ms(lambda: dt.dense_topk(*args), 3)
    err_v = vis_check(dt, vargs, "the first sample's first shadow march",
                      "5d")
    vis_ms = cuda_ms(lambda: dt.dense_visibility(*vargs), 3)
    log(f"phase 5d: on those launches (R={args[0].shape[0]}) dense_topk "
        f"{topk_ms:.3f} ms, dense_visibility {vis_ms:.3f} ms (CUDA events, 3 "
        f"launches; {card})")
    first = dict(name=f"5d the first bounce trace, K={args[3]}", ms=topk_ms,
                 **topk_launch_bound(dt, args, "5d", card, topk_ms))
    return dict(launches=launches, rng=rng_launches, median_ms=med,
                max_abs_err=(err_a, err_v), topk_first=first)


# ---- phase 6: the grid backend ------------------------------------------

def grid_stats_check(gt, grid_bin, accel, build_s: float, card: str) -> None:
    """6a: the 500k grid's stats against GRID_ACCURACY.json (kc32), and the
    host C++ binning against its numpy version on surface_scene(2000)."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    with open(os.path.join(ROOT, "GRID_ACCURACY.json")) as fh:
        ref = json.load(fh)["kc32"]
    st = accel.stats_dict
    diffs = {k: abs(float(st[k]) - float(ref[k]))
             for k in ("dropped_frac", "overflow_cell_frac", "clamped_frac")}
    log(f"phase 6a: build_grid_accel(surface_scene(500k), Kc=32, budget "
        f"2.5e9 B) in {build_s:.2f} s (host binning + tables on the card): "
        f"dims {st['dims']} (reference {tuple(ref['dims'])}), "
        + ", ".join(f"{k} {float(st[k]):.6f} (reference {float(ref[k]):.6f})"
                    for k in diffs)
        + f", {accel.packet.shape[0]} occupied cells, packet table "
        f"{accel.packet.numel() * 4 / 2**30:.2f} GiB ({card})")
    check(tuple(st["dims"]) == tuple(ref["dims"]), "6a: grid dims differ")
    check(max(diffs.values()) <= GRID_STATS_TOL,
          f"6a: grid stats off the reference by {diffs}")
    small = surface_scene(2000, seed=13, device="cpu")
    dims, _, exts, lo, hi, _ = gt.fit_grid(small)
    centers = small.means.numpy()
    prio = small.opacities.numpy()
    got = grid_bin.grid_bin_aniso(centers, exts, prio, dims, lo, hi, 32)
    want = grid_bin.grid_bin_aniso_plain(centers, exts, prio, dims, lo, hi,
                                         32)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                             want[1]),
          "6a: the C++ binning differs from its numpy version")
    log(f"phase 6a: C++ binning equals numpy on surface_scene(2000), dims "
        f"{dims}: {int(got[1].sum())} insertions, idx and cnt equal")


def grid_gates(name: str, got, want, feat: bool) -> dict:
    """The default schedule's gates on a march kernel's (trans, sums,
    frozen) against march_plain's on the same rays: the kernel freezes at
    most the plain march's rays; on rays neither froze, trans within
    GRID_TRANS_ATOL and the sums inside their allowance; a share of the rays
    within 1e-6 (GRID_BOUNCE_MIN_SHARE, GRID_SHADOW_MIN_SHARE). Returns the
    figures and a summary for the log."""
    (tk, ak, fk), (tp, ap, fp) = got, want
    n_fk, n_fp = int(fk.sum()), int(fp.sum())
    check(n_fk <= n_fp, f"{name}: the kernel froze {n_fk} rays, the plain "
          f"march {n_fp}")
    neither = ~fk & ~fp
    e_t = (tk - tp).abs().double()
    same = e_t <= 1e-6
    err_t = float(e_t[neither].max())
    check(err_t <= GRID_TRANS_ATOL, f"{name}: trans off by {err_t:.3e} on a "
          f"ray neither froze (allowed {GRID_TRANS_ATOL})")
    worst = err_a = 0.0
    if feat:
        e_a = (ak - ap).abs().double()
        same &= (e_a <= 1e-6 + 1e-6 * ap.abs()).all(-1)
        # A ray's sums move by at most ~transmittance_min x its remaining
        # contributions: allow GRID_ATOL per unit of each channel's
        # largest normalized value (feature, or depth for tsum).
        lit = neither & (1.0 - tp > 1e-3)
        scale = (ap[lit].abs() / (1.0 - tp[lit, None])).amax(0).clamp_min(1.0)
        allow = GRID_ATOL * scale.double() + GRID_RTOL * ap.abs().double()
        bad = (e_a > allow) & neither[:, None]
        err_a = float(e_a[neither].max())
        check(not bool(bad.any()), f"{name}: {int(bad.sum())} sums of rays "
              f"neither froze outside rtol {GRID_RTOL} / atol {GRID_ATOL} x "
              f"channel scale (max abs {err_a:.3e})")
        worst = float((e_a[neither] / allow[neither]).max())
    share = float(same.double().mean())
    min_share = GRID_BOUNCE_MIN_SHARE if feat else GRID_SHADOW_MIN_SHARE
    check(share >= min_share, f"{name}: only {share:.4%} of rays within "
          f"1e-6 of march_plain (need {min_share:.2%})")
    text = (f"{share:.4%} of rays within 1e-6 of march_plain (need "
            f"{min_share:.2%}); rays neither froze: max trans err "
            f"{err_t:.3e}"
            + (f", worst sum err {worst:.3f} of its allowance" if feat
               else "")
            + f"; frozen kernel {n_fk}, plain {n_fp}")
    return dict(share=share, frozen=(n_fk, n_fp),
                max_abs_err=max(err_t, err_a), text=text)


def plain_counts(stats: dict) -> str:
    """The plain march's work on a batch, as read by grid_bound."""
    visits = stats.get("slot_visits")
    return (f"{stats.get('probes', 0)} probes ("
            + ", ".join(f"{stats.get(k, 0)} {k}"
                        for k in ("probes_empty", "probes_missed",
                                  "block_exits"))
            + f"), {stats.get('step_checks', 0)} in-block steps entered, "
            f"{stats.get('steps', 0)} taken, "
            f"{int(stats['block_seen'].sum())} distinct block rows, "
            f"{0 if visits is None else int(visits.sum())} cells composited, "
            f"{0 if visits is None else int((visits > 0).sum())} distinct")


def grid_kernel_check(gt, accel, settings, name, o, d, kw, card,
                      phase: str = "6b") -> dict:
    """6b: the grid kernel against march_plain on one chunk, on the card:
    grid_gates, CUDA-event times, and the plain march's counts for the
    bound."""
    feat = "t_end" not in kw
    got = gt.march(accel, o, d, settings, GRID_MAX_STEPS,
                   with_features=feat, **kw)
    stats = {}
    want, plain_ms = host_ms(lambda: gt.march_plain(
        accel, o, d, settings, GRID_MAX_STEPS, with_features=feat,
        stats=stats, **kw))
    torch.cuda.synchronize()
    gates = grid_gates(f"{phase} {name}", got, want, feat)
    ms = cuda_ms(lambda: gt.march(accel, o, d, settings, GRID_MAX_STEPS,
                                  with_features=feat, **kw), 5)
    log(f"phase {phase} {name}: R={o.shape[0]}, {int(kw['active'].sum())} "
        f"active: {gates['text']}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms (plain: {plain_counts(stats)}) ({card})")
    return dict(gates, ms=ms, plain_ms=plain_ms, stats=stats,
                rays=o.shape[0], feat=feat,
                cols=accel.pkt_cols if feat else gt.GEOM_COLS)


def grid_exact_check(gt, accel, settings, name, o, d, kw, card,
                     phase: str = "6b", rays: int = 0) -> None:
    """6b, ray for ray: the grid kernel against march_plain on one chunk on
    the default schedule's rounds at capacity 1 without exit fractions.
    Every ray's trans within GRID_EXACT_TRANS, every sum within
    GRID_EXACT_RTOL / GRID_EXACT_ATOL, the same rays frozen. There no ray
    depends on the others, so ``rays`` > 0 checks the chunk's first rays
    alone."""
    if rays:
        o, d = o[:rays], d[:rays]
        kw = {key: v[:rays] if torch.is_tensor(v) else v
              for key, v in kw.items()}
    feat = "t_end" not in kw
    schedule = tuple((1.0, m, a_max) for _, m, a_max, *_ in
                     gt.DEFAULT_SCHEDULE)
    tk, ak, fk = gt.march(accel, o, d, settings, GRID_MAX_STEPS,
                          with_features=feat, schedule=schedule, **kw)
    tp, ap, fp = gt.march_plain(accel, o, d, settings, GRID_MAX_STEPS,
                                with_features=feat, schedule=schedule, **kw)
    torch.cuda.synchronize()
    err_t = float((tk - tp).abs().max())
    check(torch.equal(fk, fp), f"{phase} {name} (no exit fractions): frozen "
          f"rays differ (kernel {int(fk.sum())}, plain {int(fp.sum())})")
    check(err_t <= GRID_EXACT_TRANS, f"{phase} {name} (no exit fractions): "
          f"trans off by {err_t:.3e} (allowed {GRID_EXACT_TRANS})")
    err_a = compare(ak, ap, f"{phase} {name} (no exit fractions) sums",
                    rtol=GRID_EXACT_RTOL, atol=GRID_EXACT_ATOL) if feat \
        else 0.0
    log(f"phase {phase} {name}, Kc={accel.max_per_cell}, R={o.shape[0]}, "
        f"no exit fractions, "
        f"capacity 1: every ray's trans within {err_t:.3e} of march_plain"
        + (f", sums within {err_a:.3e} (rtol {GRID_EXACT_RTOL}, atol "
           f"{GRID_EXACT_ATOL})" if feat else "")
        + f"; frozen {int(fk.sum())} = {int(fp.sum())}, the same rays "
        f"({card})")


def grid_bound(gt, accel, res: dict) -> dict:
    """The grid kernel's bound on a batch from what the plain march did
    there: each probe, each in-block step and each occupied slot of a
    composited cell visit charged the float operations of its code path in
    the kernel (GRID_*_FLOPS); bytes: the rays and outputs once, each block
    row probed once (16 B) and, of each distinct cell composited, the
    columns of its occupied slots once."""
    st = res["stats"]
    kc = accel.max_per_cell
    occ = (accel.geom[:, gt.G_OPAC * kc:(gt.G_OPAC + 1) * kc] > 0).sum(1)
    # A key is missing where the march probed or composited nothing.
    visits = st.get("slot_visits", torch.zeros_like(occ))
    n = {k: st.get(k, 0) for k in ("probes", *gt.PROBE_STAT_KEYS)}
    flops = (res["rays"] * GRID_RAY_FLOPS + n["probes"] * GRID_PROBE_FLOPS
             + n["probes_empty"] * (GRID_JUMP_FLOPS + GRID_BLOCK_EXIT_FLOPS)
             + (n["probes"] - n["probes_empty"]) * GRID_SLAB_FLOPS
             + (n["probes_missed"] + n["block_exits"]) * GRID_BLOCK_EXIT_FLOPS
             + n["step_checks"] * GRID_CHECK_FLOPS
             + n["steps"] * GRID_STEP_FLOPS
             + int((visits * occ).sum()) * GRID_GAUSS_FLOPS)
    block_rows = int(st.get("block_seen", visits).sum())
    n_bytes = 4 * res["rays"] * (6 + 1 + 1 + (16 if res["feat"] else 1)) \
        + block_rows * 16 + int(occ[visits > 0].sum()) * res["cols"] * 4
    return bound(n_bytes, flops)


def grid_vs_dense(gt, metrics, scene, rays, settings, accel, dense) -> dict:
    """The grid (kernel) against the dense oracle on the primary
    interaction, as benchmarks/grid_accuracy.py compares them."""
    with torch.no_grad():
        grid = gt.trace_grid(scene, rays, settings, accel)
    hit = (dense["alpha_acc"] > 0.5) & (grid["alpha_acc"] > 0.5)
    return dict(
        psnr_albedo=float(metrics.psnr(grid["albedo"], dense["albedo"], 1.0)),
        psnr_alpha=float(metrics.psnr(grid["alpha_acc"], dense["alpha_acc"],
                                      1.0)),
        depth_err=float((grid["depth"] - dense["depth"]).abs()[hit].mean()),
        frozen=int(grid["frozen_alive"]))


def grid_accuracy(gt, ref, metrics, scene, accel, settings, card):
    """6c: the grid (kernel) against the dense backend (dense_topk kernel)
    on the primary interaction at 320x180, benchmarks/grid_accuracy.py's
    scene, camera and settings. Returns (rays, the dense oracle)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )

    with open(os.path.join(ROOT, "GRID_ACCURACY.json")) as fh:
        tpu = json.load(fh)["kc32"]
    with open(os.path.join(ROOT, "GRID_ACCURACY_CPU.json")) as fh:
        want = json.load(fh)["kc32"]
    cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5)),
                 fov_y_deg=60.0, width=320, height=180)
    rays = generate_rays(cam)
    with torch.no_grad():
        dense = ref.trace_dense(scene, rays, settings)
    r = grid_vs_dense(gt, metrics, scene, rays, settings, accel, dense)
    log(f"phase 6c: grid vs dense, 500k Gaussians, 320x180 primary "
        f"interaction: psnr_albedo {r['psnr_albedo']:.3f} dB (reference on "
        f"the CPU {want['psnr_albedo']:.3f}, on the TPU "
        f"{tpu['psnr_albedo']:.3f}), psnr_alpha {r['psnr_alpha']:.3f} "
        f"({want['psnr_alpha']:.3f}, {tpu['psnr_alpha']:.3f}), mean abs "
        f"depth err on hits {r['depth_err']:.5f} "
        f"({want['mean_abs_depth_err_hit']:.5f}, "
        f"{tpu['mean_abs_depth_err_hit']:.5f}), frozen_alive {r['frozen']} "
        f"({card})")
    check(abs(r["psnr_albedo"] - want["psnr_albedo"]) <= GRID_PSNR_TOL,
          f"6c: psnr_albedo {r['psnr_albedo']:.3f} more than {GRID_PSNR_TOL} "
          f"dB from {want['psnr_albedo']:.3f}")
    check(r["frozen"] == 0, f"6c: {r['frozen']} rays frozen")
    return rays, dense


def grid_bytes(accel) -> int:
    """Device bytes of a grid's tables."""
    return sum(x.numel() * x.element_size()
               for x in (accel.btab, accel.geom, accel.packet))


def grid_accuracy_kc64(gt, metrics, scene, settings, rays, dense, chunks,
                       kc32: list, accel32, card) -> None:
    """6c': the Kc=64 row of benchmarks/grid_accuracy.py (budget 6e9 B):
    the build timed, its stats against GRID_ACCURACY_CPU.json's kc64 row
    (as 6a holds Kc=32's), psnr_albedo against 6c's dense oracle within
    GRID_PSNR_TOL of that row's, nothing frozen; both march kernels on
    6b's bounce and shadow chunks with 6b's gates and timed beside their
    Kc=32 times; the grids' bytes."""
    with open(os.path.join(ROOT, "GRID_ACCURACY_CPU.json")) as fh:
        want = json.load(fh)["kc64"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accel = gt.build_grid_accel(scene, max_per_cell=64,
                                memory_budget_bytes=GRID64_BUDGET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = accel.stats_dict
    diffs = {k: abs(float(st[k]) - float(want[k]))
             for k in ("dropped_frac", "overflow_cell_frac", "clamped_frac")}
    log(f"phase 6c': build_grid_accel(surface_scene(500k), Kc=64, budget "
        f"{GRID64_BUDGET:.1e} B) in {build_s:.2f} s: dims {st['dims']} "
        f"(reference {tuple(want['dims'])}), "
        + ", ".join(f"{k} {float(st[k]):.6f} (reference {float(want[k]):.6f})"
                    for k in diffs)
        + f"; {accel.packet.shape[0]} occupied cells; tables "
        f"{grid_bytes(accel) / 2**30:.3f} GiB (Kc=32: "
        f"{grid_bytes(accel32) / 2**30:.3f} GiB) ({card})")
    check(tuple(st["dims"]) == tuple(want["dims"]), "6c': grid dims differ")
    check(max(diffs.values()) <= GRID_STATS_TOL,
          f"6c': grid stats off the reference by {diffs}")
    r = grid_vs_dense(gt, metrics, scene, rays, settings, accel, dense)
    log(f"phase 6c': grid (Kc=64) vs dense on 6c's rays: psnr_albedo "
        f"{r['psnr_albedo']:.3f} dB (the JAX package on the CPU "
        f"{want['psnr_albedo']:.3f}), psnr_alpha {r['psnr_alpha']:.3f} "
        f"({want['psnr_alpha']:.3f}), mean abs depth err on hits "
        f"{r['depth_err']:.5f} ({want['mean_abs_depth_err_hit']:.5f}), "
        f"frozen_alive {r['frozen']} ({card})")
    check(abs(r["psnr_albedo"] - want["psnr_albedo"]) <= GRID_PSNR_TOL,
          f"6c': psnr_albedo {r['psnr_albedo']:.3f} more than "
          f"{GRID_PSNR_TOL} dB from {want['psnr_albedo']:.3f}")
    check(r["frozen"] == 0, f"6c': {r['frozen']} rays frozen")
    for (name, o, d, kw), res32 in zip(chunks[:2], kc32):
        res = grid_kernel_check(gt, accel, settings, f"{name}, Kc=64", o, d,
                                kw, card)
        log(f"phase 6c': {'grid_trace' if res['feat'] else 'grid_visibility'}"
            f" on 6b's {name} chunk: Kc=64 {res['ms']:.3f} ms, Kc=32 "
            f"{res32['ms']:.3f} ms ({card})")


def grid_pathtrace(gm, scene, cam, settings, cfg, backend, key,
                   card) -> dict:
    """6d: bench.py's path-trace workload on the grid backend: one
    prepare_tiles, then pathtrace_camera at 1920x1080, depth 4, one warm
    and three timed samples; one more sample profiled."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.render import lights
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        accumulate, pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles,
    )

    w, h = cam.width, cam.height
    tables = lights.build_light_tables(scene, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packets, prep_ms = host_ms(lambda: prepare_tiles(scene, cam, settings,
                                                     cfg))
    zero_launches("grid_trace", "grid_visibility", "threefry")
    acc = torch.zeros((h * w, 3), device=cam.c2w.device)
    sample_ms, frozen = [], 0
    jitters, states = [], []
    for f in range(4):
        states.append(card_state())
        jit = rng.subpixel_jitter(key, h, w, f)   # no device: the card
        jitters.append(jit.device.type)
        (cur, aux), ms = host_ms(lambda: pathtrace_camera(
            scene, cam, settings, rng.frame_key(key, f), packets=packets,
            tables=tables, backend=backend, config=cfg, jitter=jit,
            return_aux=True))
        acc = accumulate(acc, cur, f)
        sample_ms.append(ms)
        frozen += int(aux["frozen_alive"])
    states.append(card_state())
    launches = launch_counts("grid_trace", "grid_visibility")
    rng_launches = launch.launches["threefry"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(jitters == ["cuda"] * 4, f"6d: jitter built on {jitters}")
    check(launches == (4 * (settings.max_depth - 1), 4 * settings.max_depth),
          f"6d: grid kernel launches (trace, visibility) {launches}")
    check(rng_launches == 4 * (settings.max_depth + 1),
          f"6d: threefry_uniforms launched {rng_launches} times, not once a "
          f"bounce and once a jittered sample")
    img = acc.reshape(h, w, 3).cpu().numpy()
    mean = check_pt_image(img, settings, "6d")
    med = statistics.median(sample_ms[1:])
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg

    jpg = os.path.join(OUT_DIR, "phase6d_surface_500k_1080p_grid_4spp.jpg")
    save_jpg(jpg, img)
    log(f"phase 6d: path trace, 500k surface Gaussians, {w}x{h}, depth 4, "
        f"grid bounces: prepare {prep_ms:.1f} ms; sample ms "
        f"{', '.join(f'{m:.1f}' for m in sample_ms)} (median of 2-4 "
        f"{med:.1f}); {w * h / (med * 1e-3):.4e} path-traced rays/s; "
        f"launches per sample grid_trace {launches[0] // 4}, grid_visibility "
        f"{launches[1] // 4}, threefry_uniforms {rng_launches // 4}; frozen "
        f"rays {frozen} in 4 samples; peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    log(f"phase 6d: image finite, mean {mean:.5f}; saved "
        f"{os.path.relpath(jpg, ROOT)}")
    log("phase 6d: the card (SM clock, memory clock, temperature, power "
        "draw, active clock-event reasons) before each sample and after the "
        "last: " + " | ".join(states))
    split = profile_split("phase6d_sample", lambda: pathtrace_camera(
        scene, cam, settings, rng.frame_key(key, 99), packets=packets,
        tables=tables, backend=backend, config=cfg,
        jitter=rng.subpixel_jitter(key, h, w, 99)), med, card,
        GRID_PROFILE_NAMES)
    return dict(launches=launches, rng=rng_launches, median_ms=med,
                split=split)


def grid_pose(gm, gt, capture, scene, settings, accel, card, spp: int,
              phase: str = "6e", profile: bool = True,
              plain_rays: int = 0) -> dict:
    """6e: bench.py's capture pose: make_tiled_pose_renderer with grid
    bounces and the shared grid at toroidal_c2w(123, 20, 2.5, 0.3),
    800x800, fov 45, spp samples, extrapolated to 512; then one sample
    profiled, and both march kernels timed on the first sample's first
    bounce trace and first shadow march beside their bound, and held to
    the plain march there (on its first plain_rays rays where given). Above
    gm.REG_KC slots a cell the wide instantiations' launches are counted."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        toroidal_c2w,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg

    render = capture.make_tiled_pose_renderer(scene, settings, None, spp,
                                              bounce_backend="grid",
                                              accel=accel)
    c2w = toroidal_c2w(123.0, 20.0, 2.5, 0.3)   # no device: the card
    check(c2w.device.type == "cuda", f"{phase}: pose built on {c2w.device}")
    wide = accel.max_per_cell > gm.REG_KC
    counters = (("grid_trace_wide", "grid_visibility_wide") if wide
                else ("grid_trace", "grid_visibility"))
    others = (("grid_trace", "grid_visibility") if wide
              else ("grid_trace_wide", "grid_visibility_wide"))
    torch.cuda.synchronize()
    zero_launches(*counters, *others, "threefry")
    stats = {}
    with HostTimer(capture, "prepare_tiles") as prep, \
            HostTimer(capture, "pathtrace_camera") as samples, \
            FirstCalls(capture, "pathtrace_camera") as sample_args, \
            FirstCalls(gm, "march_kernel",
                       lambda kw: kw.get("with_features", True)) as marches:
        img = render(c2w, 800, 800, 45.0, stats_out=stats)
        torch.cuda.synchronize()
    launches = launch_counts(*counters)
    other = sum(launch_counts(*others))
    rng_launches = launch.launches["threefry"]
    check(launches == (spp * (settings.max_depth - 1),
                       spp * settings.max_depth) and other == 0,
          f"{phase}: grid kernel launches (trace, visibility) {launches}, "
          f"{other} of the other instantiation")
    check(rng_launches == spp * (settings.max_depth + 1),
          f"{phase}: threefry_uniforms launched {rng_launches} times, not "
          f"once a bounce and once a jittered sample")
    img = img.cpu().numpy()
    check(bool(np.isfinite(img).all()) and float(img.min()) >= 0.0,
          f"{phase}: image not finite or negative")
    jpg = os.path.join(OUT_DIR, f"phase{phase}_capture_pose_800_{spp}spp_"
                                f"kc{accel.max_per_cell}.jpg")
    save_jpg(jpg, img)
    med = statistics.median(samples.ms)
    log(f"phase {phase}: capture pose toroidal_c2w(123, 20, 2.5, 0.3), "
        f"800x800, fov 45, grid bounces, Kc={accel.max_per_cell}, {spp} spp: "
        f"prepare {prep.ms[0]:.1f} ms; "
        f"sample ms {', '.join(f'{m:.1f}' for m in samples.ms)} (median "
        f"{med:.1f}); a 512-spp pose would take "
        f"{(prep.ms[0] + 512 * med) / 6e4:.2f} min; threefry_uniforms "
        f"{rng_launches // spp} launches a sample; frozen rays "
        f"{stats.get('frozen_alive', 0):.0f}; image mean {img.mean():.5f}; "
        f"saved {os.path.relpath(jpg, ROOT)} ({card})")
    args, kw = sample_args.calls[None]
    split = profile_split(f"phase{phase}_sample",
                          lambda: capture.pathtrace_camera(*args, **kw), med,
                          card, GRID_PROFILE_NAMES) if profile else {}
    for feat, name in ((True, "grid_trace"), (False, "grid_visibility")):
        (m_accel, o, d, m_settings, rounds), m_kw = marches.calls[feat]
        check(m_accel is accel and list(rounds) == gt.clip_schedule(
            gt.DEFAULT_SCHEDULE, GRID_MAX_STEPS), f"{phase}: {name} ran on "
            "another grid or schedule")
        got = gm.march_kernel(m_accel, o, d, m_settings, rounds, **m_kw)
        if plain_rays:   # the kernel's rays do not depend on their batch
            o, d = o[:plain_rays], d[:plain_rays]
            got = [None if x is None else x[:plain_rays] for x in got]
            m_kw = {key: v[:plain_rays] if torch.is_tensor(v) else v
                    for key, v in m_kw.items()}
        ms = cuda_ms(lambda: gm.march_kernel(m_accel, o, d, m_settings,
                                             rounds, **m_kw), 5)
        # The plain march over the same rays in 65536-ray chunks: its
        # outputs hold the kernel's to 6b's gates, its counts (probes
        # summed, block rows and cells distinct over all chunks) give the
        # bound.
        st, parts = {}, []
        t_end, active = m_kw.get("t_end"), m_kw.get("active")
        for s in range(0, o.shape[0], PT_CHUNK):
            sl = slice(s, s + PT_CHUNK)
            parts.append(gt.march_plain(
                accel, o[sl], d[sl], m_settings, GRID_MAX_STEPS,
                t_end=None if t_end is None else t_end[sl],
                with_features=feat,
                active=None if active is None else active[sl], stats=st))
        want = [None if p[0] is None else torch.cat(p) for p in zip(*parts)]
        gates = grid_gates(f"{phase} {name}", got, want, feat)
        bnd = grid_bound(gt, accel, dict(
            stats=st, rays=o.shape[0], feat=feat,
            cols=accel.pkt_cols if feat else gt.GEOM_COLS))
        n_active = o.shape[0] if active is None else int(active.sum())
        per_sample = f"; per sample {split[name]:.3f} ms" if split else ""
        log(f"phase {phase}: {name} on the first sample's first "
            f"{'bounce trace' if feat else 'shadow march'}: R={o.shape[0]}, "
            f"{n_active} active: {gates['text']}; kernel {ms:.3f} ms (CUDA "
            f"events); bound {bnd['bound_ms']:.4f} ms "
            f"by {bnd['bound_by']} ({bnd['bound_flops']:.4e} flops, "
            f"{bnd['bound_bytes']:.4e} bytes; plain: {plain_counts(st)}) = "
            f"{bnd['bound_ms'] / ms:.1%} of the bound's rate{per_sample} in "
            f"{launches[0 if feat else 1] // spp} launches a sample ({card})")
    return dict(launches=launches, rng=rng_launches, median_ms=med,
                frozen=stats.get("frozen_alive", 0))


# ---- phase 7: the ablation harness ----------------------------------------

def surface_1080p(dev, key):
    """Phase 3's input, the path-trace bench's primary stage:
    surface_scene(500k, seed 13) at 1920x1080, K=512, one prepare_tiles and
    the tile directions jittered by sample 0: (scene, camera, settings,
    binning config, packets, dirs)."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles,
    )

    scene = surface_scene(500_000, seed=13, device=dev)
    cam = Camera(c2w=look_at(PT_EYE, PT_TARGET, device=dev), fov_y_deg=60.0,
                 width=1920, height=1080)
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    cfg = BinningConfig()
    packets = prepare_tiles(scene, cam, settings, cfg)
    dirs, _ = _tile_dirs(cam, cfg, rng.subpixel_jitter(
        key, cam.height, cam.width, 0, device=dev))
    return scene, cam, settings, cfg, packets, dirs


def ablation_checks(tc, tv, inputs, name: str) -> dict:
    """Phase 7's gates at the headline packets: every mode's kernel against
    its plain version (the tensor-core modes finite, their error against
    full's plain math kept), full and hoist bit-equal to the forward
    kernel, onechunk and noif within the transmittance_min bound of full.
    Returns {mode: max abs err}."""
    geom, featsT, dirs, count, settings = inputs
    errs, outs = {}, {}
    for mode in tv.MODES:
        got = tv.tile_composite_variant(mode, *inputs)
        want = tv.tile_composite_variant_plain("full" if mode in
                                               tv.TENSOR_CORE else mode,
                                               *inputs)
        torch.cuda.synchronize()
        outs[mode] = got
        if mode in tv.TENSOR_CORE:
            check(bool(torch.isfinite(got).all()), f"7 {mode}: not finite")
            errs[mode] = float((got - want).abs().max())
            continue
        if mode == "noscan":  # depth ~1e10 where alpha_acc ~ 0: relative
            compare(got[..., -1], want[..., -1], "7 noscan depth", atol=0.0)
            got, want = got[..., :-1], want[..., :-1]
        errs[mode] = compare(got, want, f"7 {name} {mode}")
    full_equal_forward(tc, tv, inputs, name, outs)
    # Chunks full skips hold at most transmittance_min of each pixel's
    # light: features move by at most that times the largest feature.
    tmin = settings.transmittance_min
    fmax = float(featsT.abs().max())
    full = outs["full"]
    for mode in ("onechunk", "noif"):
        d = (outs[mode] - full).abs()
        check(float(d[..., :tc.FEATURE_DIM].max()) <= 1.01 * tmin * fmax
              + ATOL and float(d[..., tv.FP].max()) <= 1.01 * tmin + ATOL,
              f"7 {name} {mode}: beyond the transmittance_min bound of full")
    return errs


def full_equal_forward(tc, tv, inputs, name: str, outs=None) -> None:
    """Phase 7: full and hoist bit-equal to tile_composite_fwd (outs: the
    modes' outputs where already computed)."""
    geom, featsT, dirs, count, settings = inputs
    fwd = tc.tile_composite(dict(geom=geom, featsT=featsT, count=count),
                            dirs, settings)
    for mode in ("full", "hoist"):
        got = (outs or {}).get(mode)
        if got is None:
            got = tv.tile_composite_variant(mode, *inputs)
        check(torch.equal(got[..., :tc.FEATURE_DIM], fwd[0])
              and torch.equal(got[..., tv.FP], fwd[1])
              and torch.equal(got[..., tv.FP + 1], fwd[2]),
              f"7 {name}: {mode} is not bit-equal to tile_composite_fwd")


def ablation_times(tc, tv, inputs, name: str, card: str) -> dict:
    """Phase 7's timing run at one input: the forward kernel and full back
    to back (forward, full, full, forward, 20 launches each; full must take
    at most FULL_TIME_RATIO of the forward's time), then every mode, 20
    launches each: ms, share of full, and the saving against full in ms
    and as a share of full's distance to the function's bound; the forward
    last, as one more row."""
    geom, featsT, dirs, count, settings = inputs
    packets = dict(geom=geom, featsT=featsT, count=count)
    bnds = tile_bounds(packets, dirs, settings)
    fbound = bnds["fwd"]["function_bound_ms"]
    zero_launches("tile_variant")

    def fwd():
        tc.tile_composite(packets, dirs, settings)

    def full():
        tv.tile_composite_variant("full", *inputs)

    pair = [cuda_ms(fn, 20) for fn in (fwd, full, full, fwd)]
    fwd_ms, full_ms = (pair[0] + pair[3]) / 2, (pair[1] + pair[2]) / 2
    check(full_ms <= FULL_TIME_RATIO * fwd_ms,
          f"7 {name}: full {full_ms:.4f} ms is over {FULL_TIME_RATIO} x the "
          f"forward kernel's {fwd_ms:.4f} ms")
    rows = tv.run_harness(tv.MODES, inputs, 20)
    t_total, k = geom.shape[0], geom.shape[-1]
    log(f"phase 7 {name}: T={t_total}, K={k}: forward kernel {fwd_ms:.4f} "
        f"ms, full {full_ms:.4f} ms back to back (runs "
        + ", ".join(f"{m:.4f}" for m in pair) + f") = {full_ms / fwd_ms:.3f}"
        f" x (gate {FULL_TIME_RATIO}); the function's bound {fbound:.4f} ms"
        f"; {bnds['live_pairs'] / bnds['pairs']:.1%} of {bnds['pairs']} "
        f"evaluated pairs with alpha > 0; {card}")
    # The forward as one more row: it runs full's code but stores a row per
    # thread, so its saving against full is what that store costs it.
    rows.append(("forward", fwd_ms, None))
    base = rows[0][1]
    for mode, ms, err in rows:
        note = "" if err is None else f", max rel err vs full {err:.2e}"
        log(f"phase 7 {name} {mode:>9s}: {ms:8.4f} ms, {ms / base:7.1%} of "
            f"full, saves {base - ms:+.4f} ms = "
            f"{(base - ms) / (base - fbound):+7.1%} of full's distance to "
            f"the function's bound{note}")
    return dict(launches=launch.launches["tile_variant"], ms=base,
                fwd_ms=fwd_ms, full_ms=full_ms, bounds=bnds)


def ablation(tc, tv, dev, key, card) -> dict:
    """Phase 7: the ablation harness. At the headline packets (T=2500,
    K=256) every gate of ablation_checks; at phase 3's 1080p packets
    (T=8160, K=512) full and hoist bit-equal to the forward; at both the
    timing run of ablation_times."""
    head = tv.headline_inputs()
    errs = ablation_checks(tc, tv, head, "headline")
    plain_ms = cuda_ms(lambda: tv.tile_composite_variant_plain(
        "full", *head), 2)
    log("phase 7: kernels vs plain within rtol "
        f"{RTOL} / atol {ATOL}: "
        + ", ".join(f"{m} {e:.2e}" for m, e in errs.items()
                    if m not in tv.TENSOR_CORE)
        + "; max abs err vs full's plain math "
        + ", ".join(f"{m} {errs[m]:.3e}" for m in tv.TENSOR_CORE)
        + "; full and hoist bit-equal to tile_composite_fwd; onechunk and "
        f"noif within the transmittance_min bound; full's plain version "
        f"{plain_ms:.3f} ms")
    t_head = ablation_times(tc, tv, head, "headline", card)
    del head
    _, _, settings, _, packets, dirs = surface_1080p(dev, key)
    wide = (packets["geom"].contiguous(), packets["featsT"].contiguous(),
            dirs.contiguous(), packets["count"].contiguous(), settings)
    del packets
    full_equal_forward(tc, tv, wide, "1080p")
    log("phase 7 1080p: full and hoist bit-equal to tile_composite_fwd")
    t_wide = ablation_times(tc, tv, wide, "1080p", card)
    return dict(launches=t_head["launches"] + t_wide["launches"],
                ms=t_head["ms"], plain_ms=plain_ms,
                max_abs_err=max(e for m, e in errs.items()
                                if m not in tv.TENSOR_CORE),
                **t_head["bounds"]["fwd"])


# ---- phase 8: the dataset capture -----------------------------------------

# The downstream loop's torus, inside the room
# (benchmarks/downstream_loop.py:70); the reference's default 1M rays.
CAPTURE_TORUS = dict(major_radius=1.2, minor_radius=0.4, height=0.2)
# 8b, a small capture on the card against the CPU (surface_scene(2000),
# depth 1). Cameras: the same float32 pose math, within an ulp an entry.
CAP_MATRIX_ATOL = 1e-6
# The 8-bit sRGB image each JPG encodes: at least CAP_IMG_MIN_SHARE of its
# channels within CAP_IMG_ATOL levels (a thin surfel at an alpha cutoff
# moves a few pixels, ROADMAP section 3). The JPEG codec quantizes each 8x8
# block, so one level before it can move a block by a few: the decoded
# files are held to CAP_JPG_ATOL levels on the same share.
CAP_IMG_ATOL, CAP_IMG_MIN_SHARE = 2, 0.99
CAP_JPG_ATOL = 8
# Point cloud: row counts within CAP_PLY_COUNT_RTOL of each other (a ray's
# hit flag may flip at a thin surfel). Over the rays that hit on both
# (matched rows), at least CAP_ROW_MIN_SHARE have their position within
# CAP_PLY_EXTENT_TOL of the scene's extent and their color within
# CAP_PLY_COLOR_ATOL of 255 (a flipped hit lands elsewhere).
CAP_PLY_COUNT_RTOL = 0.005
CAP_PLY_EXTENT_TOL, CAP_PLY_COLOR_ATOL, CAP_ROW_MIN_SHARE = 1e-3, 2, 0.99
# 8c: if two uninterrupted renders of the pose differ on the card, the
# resumed one is held to the first within this.
CAP_RESUME_ATOL = 1e-6
# The reference's default dataset (its capture_scene_data's defaults).
REF_POSES, REF_SPP = 336, 512


def capture_run(capture, gm, gt, tc, dt, card) -> dict:
    """8a and 8d: capture_scene_data through "auto" on surface_scene(500k)
    (4 poses at 800x800, 16 spp, depth 4, 1M uniform torus rays,
    debug_checks), then capture_panorama (2 steps, 4 spp); the files
    checked, the kernels' launches counted, the times printed."""
    from PIL import Image

    from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
        load_point_cloud_ply,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
        load_transforms_json,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    n, poses, res, spp = 500_000, 4, 800, 16
    scene = surface_scene(n, seed=13)     # no device: the card
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    torus = TorusConfig(**CAPTURE_TORUS)   # the reference's 1M rays
    lines, stamps = [], []

    def progress(msg: str) -> None:
        stamps.append(time.perf_counter())
        lines.append(msg)
        if not msg.startswith("point cloud rays") \
                or msg.endswith(f" {torus.num_rays}/{torus.num_rays}"):
            log("phase 8a: " + msg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_capture_") as out:
        with HostTimer(gt, "build_grid_accel") as builds, \
                HostTimer(capture, "prepare_tiles") as prep, \
                HostTimer(capture, "pathtrace_camera") as samples, \
                FirstCalls(capture, "pathtrace_camera") as sample_args, \
                HostTimer(capture, "_trace_host") as traces, \
                HostTimer(capture, "save_point_cloud_ply") as ply:
            t0 = time.perf_counter()
            result = capture.capture_scene_data(
                scene, out, settings, torus=torus, accumulation_steps=spp,
                total_positions=poses, image_divisor=2, width=res,
                height=res, fov_y_deg=45.0, sampling_method="uniform",
                debug_checks=True, progress=progress)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        t1 = time.perf_counter()
        capture.capture_panorama(scene, out, settings, torus=torus, steps=2,
                                 accumulation_steps=4, width=res, height=res,
                                 progress=progress)
        torch.cuda.synchronize()
        pano_s = time.perf_counter() - t1
        launches = read_counts()

        # The dataset: layout, split, sizes, the point cloud.
        check(lines[0] == "capture backend: tiled+grid",
              f"8a: auto resolved to '{lines[0]}'")
        check(len(builds.ms) == 1,
              f"8a: build_grid_accel ran {len(builds.ms)} times")
        names = sorted(os.listdir(os.path.join(out, "train")))
        check(names == [f"r_{i}.jpg" for i in range(poses)],
              f"8a: train/ holds {names}")
        split = [len(load_transforms_json(os.path.join(
            out, f"transforms_{s}.json"))["frames"]) for s in ("train", "test")]
        check(split == [3, 1], f"8a: train/test frames {split}")
        for name in names:
            size = Image.open(os.path.join(out, "train", name)).size
            check(size == (res // 2, res // 2), f"8a: {name} is {size}")
        pano = sorted(os.listdir(os.path.join(out, "panorama")))
        check(pano == ["pano_0.jpg", "pano_1.jpg"], f"8a: panorama {pano}")
        with open(os.path.join(out, "points3d.ply")) as fh:
            header = [next(fh) for _ in range(12)]
        rows_in_header = int(header[2].split()[-1])
        cloud = load_point_cloud_ply(os.path.join(out, "points3d.ply"))
        n_points = result["num_points"]
        check(n_points == rows_in_header == len(cloud["positions"]) > 0,
              f"8a: num_points {n_points}, header {rows_in_header}, rows "
              f"{len(cloud['positions'])}")
        check(all(bool(np.isfinite(cloud[k]).all()) for k in cloud),
              "8a: point-cloud rows not finite")
        for prefix in ("binning truncation", "grid-accel truncation",
                       "marcher truncation"):
            check(any(ln.startswith(prefix) for ln in lines),
                  f"8a: no '{prefix}' report line")
        for rel in [f"train/{n}" for n in names] + ["panorama/pano_0.jpg"]:
            shutil.copy(os.path.join(out, rel), os.path.join(
                OUT_DIR, "phase8a_" + rel.replace("/", "_")))
    check(launches["fwd"] == poses * spp and launches["trace"] > 0
          and launches["vis"] > 0 and launches["topk"] == 0
          and launches["dense_vis"] == 0
          and launches["rng"] > poses * spp * (settings.max_depth + 1),
          f"8a: kernel launches {launches}")
    log(f"phase 8a: surface_scene({n}) + its emissive panel, auto -> "
        f"tiled+grid, {poses} poses {res}x{res} fov 45 / 2, {spp} spp, depth "
        f"{settings.max_depth}, torus R {torus.major_radius} r "
        f"{torus.minor_radius} h {torus.height}, {torus.num_rays} uniform "
        f"rays: layout, split 3/1, JPGs {res // 2}x{res // 2}, "
        f"{n_points} PLY rows (finite), one grid build, report lines, "
        f"panorama 2 frames: ok; launches {json.dumps(launches)} ({card})")

    # 8d: the times.
    med = statistics.median(samples.ms)
    per_pose = [statistics.median(samples.ms[i * spp:(i + 1) * spp])
                for i in range(poses)]
    pose_stamps = [t for t, ln in zip(stamps, lines)
                   if ln.startswith("captured position")]
    pose_s = [b - a for a, b in zip([t0] + pose_stamps[:-1], pose_stamps)]
    pc_stamps = [t for t, ln in zip(stamps, lines)
                 if ln.startswith("point cloud rays")]
    pc_s = pc_stamps[-1] - pose_stamps[-1]
    trace_ms = sum(traces.ms)
    build_s = builds.ms[0] / 1e3
    ply_s = ply.ms[0] / 1e3
    args, kw = sample_args.calls[None]
    split_ms = profile_split("phase8_sample", lambda: capture.pathtrace_camera(
        *args, **kw), med, card, GRID_PROFILE_NAMES)
    busy = sum(split_ms.values()) / med
    log(f"phase 8d: per pose: prepare ms "
        f"{', '.join(f'{m:.1f}' for m in prep.ms)}; sample ms median "
        f"{', '.join(f'{m:.1f}' for m in per_pose)} (all {med:.1f}); pose s "
        f"{', '.join(f'{s:.2f}' for s in pose_s)} (JPG written; the first "
        f"with the capture's set-up, the grid build included); one "
        f"profiled sample {busy:.1%} busy ({card})")
    log(f"phase 8d: point-cloud pass: {torus.num_rays} rays x {spp} spp in "
        f"{pc_s:.2f} s = {torus.num_rays * spp / pc_s:.4e} rays/s (the "
        f"flat renderer in 65536-ray chunks, then one trace a chunk); the "
        f"trace pass {trace_ms:.1f} ms in {len(traces.ms)} chunks ({card})")
    log(f"phase 8d: PLY write {ply_s:.2f} s for {n_points} rows; grid build "
        f"{build_s:.2f} s; total capture {total_s:.2f} s; panorama "
        f"{pano_s:.2f} s (2 frames, 4 spp, its own grid); peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    pose_512 = (statistics.median(prep.ms) + REF_SPP * med) / 1e3
    pc_512 = (pc_s - trace_ms / 1e3) * REF_SPP / spp + trace_ms / 1e3
    ref_s = build_s + REF_POSES * pose_512 + pc_512 + ply_s
    log(f"phase 8d: extrapolated, not measured: the reference's default "
        f"dataset ({REF_POSES} poses x {REF_SPP} spp, {torus.num_rays} "
        f"rays at {REF_SPP} spp) would take {ref_s / 3600:.2f} h: "
        f"{pose_512:.1f} s a pose, {pc_512 / 60:.1f} min for the point "
        f"cloud, from this run's medians ({card})")
    return dict(scene=scene, settings=settings, launches=launches)


def recorded_capture(capture, run, means: torch.Tensor) -> dict:
    """``run(out)`` captures a dataset into a temporary directory; returns
    run's result and seconds with what compare_captures reads: the
    transforms, the 8-bit images the JPGs encode, the decoded JPGs, the
    point cloud's per-ray arrays before the hit filter and the extent of
    the scene's ``means``."""
    from PIL import Image

    from pathtracer_gaussiansplatting_tpu_torch.data.images import (
        to_uint8_srgb,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
        load_transforms_json,
    )

    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_capture_") as out, \
            HostTimer(capture, "save_jpg", keep=True) as jpgs, \
            HostTimer(capture, "save_point_cloud_ply", keep=True) as ply:
        t0 = time.perf_counter()
        res = run(out)
        secs = time.perf_counter() - t0
        transforms = {s: load_transforms_json(os.path.join(
            out, f"transforms_{s}.json")) for s in ("train", "test")}
        decoded = [np.asarray(Image.open(args[0]), np.int32)
                   for args, _ in jpgs.calls]
    means = means.cpu().numpy()
    return dict(
        res=res, secs=secs, transforms=transforms,
        images=[to_uint8_srgb(args[1]).astype(np.int32)
                for args, _ in jpgs.calls],
        decoded=decoded, cloud=ply.calls[0][0][1:],
        extent=float((means.max(0) - means.min(0)).max()))


def small_capture(capture, device) -> dict:
    """8b's capture on one device: surface_scene(2000), tiled+grid, 4 poses
    at 96x64, 2 spp, depth 1, 4096 uniform torus rays, recorded by
    recorded_capture."""
    from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    scene = surface_scene(2000, seed=13, device=device)
    settings = RenderSettings(max_depth=1, ambient=(0.05, 0.05, 0.06, 1.0))
    run = recorded_capture(capture, lambda out: capture.capture_scene_data(
        scene, out, settings,
        torus=TorusConfig(num_rays=4096, **CAPTURE_TORUS),
        accumulation_steps=2, total_positions=4, width=96, height=64,
        backend="tiled+grid", progress=None), scene.means)
    return dict(run, num_points=run["res"]["num_points"])


def capture_card_vs_cpu(capture, dev, card) -> None:
    """8b: the same small capture on the card and on the CPU."""
    card_run, cpu_run = (small_capture(capture, d)
                         for d in (dev, torch.device("cpu")))
    compare_captures("8b", card_run, cpu_run, card,
                     "surface_scene(2000), tiled+grid, 4 poses 96x64, 2 spp, "
                     "depth 1, 4096 torus rays")


def compare_captures(tag: str, card_run: dict, cpu_run: dict, card: str,
                     what: str, min_share: float = CAP_IMG_MIN_SHARE) -> None:
    """Two captures of one scene, on the card and on the CPU (each a dict
    as small_capture returns), held to 8b's gates; ``min_share`` is the
    least share of the path-traced values (image channels, decoded JPGs,
    point colors) within their bounds."""
    for s in ("train", "test"):
        a, b = card_run["transforms"][s], cpu_run["transforms"][s]
        check(a["camera_angle_x"] == b["camera_angle_x"]
              and [f["file_path"] for f in a["frames"]]
              == [f["file_path"] for f in b["frames"]],
              f"{tag}: transforms_{s} differ")
        err = max((float(np.abs(f["transform_matrix"]
                                - g["transform_matrix"]).max())
                   for f, g in zip(a["frames"], b["frames"])), default=0.0)
        check(err <= CAP_MATRIX_ATOL, f"{tag}: transforms_{s} matrices {err}")
    img_share, jpg_share, jpg2_share = [], [], []
    for a, b, c, d in zip(card_run["images"], cpu_run["images"],
                          card_run["decoded"], cpu_run["decoded"]):
        img_share.append(float((np.abs(a - b) <= CAP_IMG_ATOL).mean()))
        jpg_share.append(float((np.abs(c - d) <= CAP_JPG_ATOL).mean()))
        jpg2_share.append(float((np.abs(c - d) <= CAP_IMG_ATOL).mean()))
    check(len(img_share) == 4 and min(img_share) >= min_share
          and min(jpg_share) >= min_share,
          f"{tag}: images {img_share}, decoded JPGs {jpg_share} (need "
          f"{min_share})")
    pos_a, _, col_a, flag_a = card_run["cloud"]
    pos_b, _, col_b, flag_b = cpu_run["cloud"]
    n_a, n_b = card_run["num_points"], cpu_run["num_points"]
    check(abs(n_a - n_b) <= CAP_PLY_COUNT_RTOL * max(n_a, n_b) and n_a > 0,
          f"{tag}: PLY rows {n_a} on the card, {n_b} on the CPU")
    both = (flag_a > 0) & (flag_b > 0)

    def u8(c):
        return (np.clip(c, 0.0, 1.0) * 255.0).astype(np.uint8).astype(int)

    pos_err = np.abs(pos_a[both] - pos_b[both]).max(-1)
    col_err = np.abs(u8(col_a[both]) - u8(col_b[both])).max(-1)
    pos_ok = float((pos_err <= CAP_PLY_EXTENT_TOL * card_run["extent"])
                   .mean())
    col_ok = float((col_err <= CAP_PLY_COLOR_ATOL).mean())
    check(pos_ok >= CAP_ROW_MIN_SHARE and col_ok >= min_share,
          f"{tag}: matched rows: positions {pos_ok:.4%}, colors {col_ok:.4%}")
    log(f"phase {tag}: capture on the card vs the CPU ({what}; "
        f"{card_run['secs']:.1f} s / {cpu_run['secs']:.1f} s): transforms "
        f"equal within {CAP_MATRIX_ATOL}; the encoded 8-bit images "
        f"{min(img_share):.4%} of channels within {CAP_IMG_ATOL}/255 (worst "
        f"pose), the decoded JPGs {min(jpg_share):.4%} within "
        f"{CAP_JPG_ATOL}/255 ({min(jpg2_share):.4%} within "
        f"{CAP_IMG_ATOL}/255); PLY rows {n_a} / {n_b}; of {int(both.sum())} "
        f"matched rows {pos_ok:.4%} with positions within "
        f"{CAP_PLY_EXTENT_TOL} x extent {card_run['extent']:.3f} (max "
        f"{pos_err.max():.3e}), {col_ok:.4%} with colors within "
        f"{CAP_PLY_COLOR_ATOL} (max {col_err.max()}); gates {min_share:.0%} "
        f"of channels and colors, {CAP_ROW_MIN_SHARE:.0%} of positions "
        f"({card})")


def first_difference(capture, gm, scene, settings, c2w, render,
                     res: int) -> str:
    """Where two runs of the same pose differ on the card: prepare_tiles,
    the tile kernel, the first bounce trace or shadow march, or the rest
    of a sample; the first of these whose outputs differ."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        render_prepared,
    )

    cam = Camera(c2w=c2w, fov_y_deg=45.0, width=res, height=res)
    cfg = capture.BinningConfig()
    p1, p2 = (capture.prepare_tiles(scene, cam, settings, cfg)
              for _ in range(2))
    for k in p1:
        if isinstance(p1[k], torch.Tensor) and not torch.equal(p1[k], p2[k]):
            return f"prepare_tiles ({k})"
    o1, o2 = (render_prepared(p1, cam, settings, cfg, outputs=(
        "tile_feats", "tile_alpha", "tile_depth")) for _ in range(2))
    for k in o1:
        if not torch.equal(o1[k], o2[k]):
            return f"the tile kernel ({k})"
    with FirstCalls(gm, "march_kernel",
                    lambda kw: kw.get("with_features", True)) as marches:
        render(c2w, res, res, 45.0)
    for feat, name in ((True, "grid_trace"), (False, "grid_visibility")):
        args, kw = marches.calls[feat]
        r1, r2 = (gm.march_kernel(*args, **kw) for _ in range(2))
        if any(a is not None and not torch.equal(a, b)
               for a, b in zip(r1, r2)):
            return f"the {name} kernel"
    return "a torch op of the sample outside the kernels"


def capture_resume(capture, gm, scene, settings, card) -> str:
    """8c: the capture's pose 0 at 800x800, 8 spp: checkpointed every 4
    samples, cut after the first segment and resumed, against the
    uninterrupted render."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        toroidal_c2w,
    )
    from pathtracer_gaussiansplatting_tpu_torch.utils.checkpoint import (
        load_render_state,
    )

    res = 800
    cap_rng = np.random.RandomState(capture.CAPTURE_SEED)
    alpha, beta = cap_rng.uniform(0.0, 360.0), cap_rng.uniform(-45.0, 45.0)
    c2w = toroidal_c2w(alpha, beta, CAPTURE_TORUS["major_radius"],
                       CAPTURE_TORUS["height"])
    render = capture.make_tiled_pose_renderer(scene, settings, None, 8,
                                              bounce_backend="grid")
    whole = render(c2w, res, res, 45.0)
    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_capture_") as out:
        state = os.path.join(out, ".pose_0.npz")
        cut = render(c2w, res, res, 45.0, state_path=state,
                     checkpoint_every=4, stop_after_segments=1)
        check(cut is None and load_render_state(state)["frames_done"] == 4,
              "8c: no state after the first segment")
        resumed = render(c2w, res, res, 45.0, state_path=state,
                         checkpoint_every=4)
        check(not os.path.exists(state), "8c: the state file was left")
    if torch.equal(resumed, whole):
        log(f"phase 8c: pose 0 (alpha {alpha:.1f}, beta {beta:.1f}), "
            f"{res}x{res}, 8 spp, checkpoint every 4, cut after 4 and resumed: "
            f"bit-equal to the uninterrupted render ({card})")
        return "bit-equal"
    again = render(c2w, res, res, 45.0)
    check(not torch.equal(again, whole), "8c: the resumed pose differs "
          "from the uninterrupted one, which repeats bit for bit")
    where = first_difference(capture, gm, scene, settings, c2w, render, res)
    err = float((resumed - whole).abs().max())
    rerun = float((again - whole).abs().max())
    check(err <= CAP_RESUME_ATOL, f"8c: resumed pose off by {err:.3e}")
    log(f"phase 8c: two uninterrupted renders of pose 0 differ by "
        f"{rerun:.3e} on the card, first in {where}; the resumed one is "
        f"within {err:.3e} of the first (allowed {CAP_RESUME_ATOL}) "
        f"({card})")
    return f"within {err:.3e} ({where})"


# ---- phase 9: the command line and its scene loaders ----------------------

# 9a's world: the 8a room as a 3DGS checkpoint, turned a quarter and moved
# by the config (a quarter turn keeps its box, so the grid fits as in 8a);
# a textured glTF cube with a spot light above the room's center; a small
# rtbox with one emissive panel below it; a sun. The 8a torus lies inside
# the room, so every pose looks at the center.
CLI_ROOM = dict(position=[0.1, 0.0, 0.05], rotation=[0.0, 90.0, 0.0])
CLI_CUBE = dict(position=[0.0, 0.35, 0.0], rotation=[20.0, 45.0, 0.0])
CLI_CUBE_HALF = 0.15
CLI_RTBOX = {
    "position": [0.0, -0.45, 0.0], "dimensions": [0.6, 0.5, 0.6],
    "panels": {
        "floor": {"material": {"base_color": [0.9, 0.9, 0.9]}},
        "back_wall": {"material": {"base_color": [0.2, 0.4, 0.8],
                                   "roughness": 0.5}},
        "left_wall": {"material": {"base_color": [0.8, 0.3, 0.1]}},
        "ceiling": {"material": {"base_color": [1.0, 0.95, 0.9]},
                    "light": {"intensity": 3.0}},
    },
}
CLI_RTBOX_PANEL_RES = 24  # models/scene.rtbox_scene's default
# The interact script of 9d: moves, looks, a torus resize, the point-cloud
# view and the toroidal camera; each input resets the accumulation.
CLI_INTERACT = ["w", "look 5 2", "step 4", "z", "step 2", "p", "step 1",
                "c", "step 2"]
CLI_INTERACT_FRAMES = ["frame 4 mode=camera cam=free",
                       "frame 2 mode=camera cam=free",
                       "frame 1 mode=pointcloud cam=free",
                       "frame 2 mode=pointcloud cam=toroidal"]
# 9c: the CLI's render on the card against the CPU, 8b's image gate.
CLI_RENDER_ATOL, CLI_RENDER_MIN_SHARE = CAP_IMG_ATOL, CAP_IMG_MIN_SHARE


def gltf_cube(path: str, half: float, spot: bool = True) -> None:
    """A cube mesh (24 vertices, each face its own UVs) with a 16x16
    base-color PNG as a data URI under KHR_texture_transform, and, with
    ``spot``, a KHR_lights_punctual spot light 1.2 above the origin
    pointing down."""
    import base64
    import io

    from PIL import Image

    pos, nrm, uv, idx = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u_ax, v_ax = [a for a in range(3) if a != axis]
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = n * half
                p[u_ax], p[v_ax] = du * half, dv * half
                pos.append(p)
                nrm.append(n)
                uv.append(((du + 1) / 2, (dv + 1) / 2))
            b = len(pos) - 4
            tri = [b, b + 1, b + 2, b, b + 2, b + 3]
            idx += tri if sign > 0 else [tri[0], tri[2], tri[1], tri[3],
                                         tri[5], tri[4]]
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    uv = np.asarray(uv, np.float32)
    idx = np.asarray(idx, np.uint32)
    blob = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    rgba = np.zeros((16, 16, 4), np.uint8)
    rgba[..., 3] = 255
    check_mask = (np.indices((16, 16)).sum(0) // 4) % 2 == 0
    rgba[check_mask, :3] = (230, 200, 40)
    rgba[~check_mask, :3] = (40, 120, 220)
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    offsets = np.cumsum([0, pos.nbytes, nrm.nbytes, uv.nbytes])
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1] if spot else [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0, "extensions": {
                "KHR_texture_transform": {"offset": [0.25, 0.0],
                                          "scale": [2.0, 2.0],
                                          "rotation": 0.3}}},
            "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
        "textures": [{"source": 0, "sampler": 0}],
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
        "images": [{"uri": "data:image/png;base64,"
                    + base64.b64encode(buf.getvalue()).decode()}],
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode(),
                     "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": int(o), "byteLength": int(n)}
            for o, n in zip(offsets, (pos.nbytes, nrm.nbytes, uv.nbytes,
                                      idx.nbytes))],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": len(pos),
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
    }
    if spot:
        s2 = float(np.sqrt(0.5))
        doc["nodes"].append({
            "translation": [0.0, 1.2, 0.0], "rotation": [-s2, 0.0, 0.0, s2],
            "extensions": {"KHR_lights_punctual": {"light": 0}}})
        doc["extensions"] = {"KHR_lights_punctual": {"lights": [{
            "type": "spot", "color": [1.0, 0.9, 0.75], "intensity": 4.0,
            "spot": {"innerConeAngle": 0.3, "outerConeAngle": 0.7}}]}}
    with open(path, "w") as fh:
        json.dump(doc, fh)


def cli_world(root: str, n: int, card: str) -> str:
    """9a's files in ``root``: the room's 3DGS checkpoint (written by the
    port's save_3dgs_ply), the glTF cube, rtbox.json and the scene config;
    returns the config's path."""
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import save_3dgs_ply
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    room = surface_scene(n, seed=13)       # no device: the card
    t0 = time.perf_counter()
    save_3dgs_ply(os.path.join(root, "room.ply"), room)
    write_s = time.perf_counter() - t0
    del room
    gltf_cube(os.path.join(root, "cube.gltf"), CLI_CUBE_HALF)
    with open(os.path.join(root, "rtbox.json"), "w") as fh:
        json.dump(CLI_RTBOX, fh)
    cfg = {
        "settings": {
            "use_rt_box": True, "rt_box_file": "rtbox.json",
            "ambient_light": [0.05, 0.05, 0.06, 1.0],
            "torus_settings": dict(CAPTURE_TORUS, num_rays=1_000_000),
            "sun": {"color": [1.0, 0.95, 0.9], "direction": [0.3, -1.0, 0.2],
                    "intensity": 1.5},
            "accumulation_steps": 16, "total_positions": 4,
            "image_divisor": 2, "width": 800, "height": 800, "fov": 45,
            "max_depth": 4, "sampling_method": "uniform", "backend": "auto",
        },
        "objects": [dict(model="room.ply", **CLI_ROOM),
                    dict(model="cube.gltf", **CLI_CUBE)],
    }
    path = os.path.join(root, "scene.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh, indent=1)
    log(f"phase 9a: wrote {path}: room.ply = surface_scene({n}) through "
        f"save_3dgs_ply in {write_s:.2f} s ({os.path.getsize(os.path.join(root, 'room.ply')) / 2**20:.1f} MiB), "
        f"at {CLI_ROOM}; cube.gltf (textured, KHR_texture_transform, a "
        f"spot light) at {CLI_CUBE}; rtbox.json (4 panels, the ceiling "
        f"emissive); a sun ({card})")
    return path


class Loaders:
    """Times the scene loaders the command line reaches (the config, the
    scene's assembly and, inside it, the 3DGS reader, the glTF loader and
    the rtbox) and keeps their results."""

    def __init__(self, cli):
        from pathtracer_gaussiansplatting_tpu_torch.data import gltf, ply
        from pathtracer_gaussiansplatting_tpu_torch.models import scene

        self.timers = dict(
            config=HostTimer(cli, "load_scene_config"),
            assembly=HostTimer(cli, "load_scene_from_config", keep=True),
            ply=HostTimer(ply, "load_3dgs_ply"),
            gltf=HostTimer(gltf, "load_gltf_scene", keep=True),
            rtbox=HostTimer(scene, "rtbox_scene", keep=True))

    def __enter__(self):
        for t in self.timers.values():
            t.__enter__()
        return self

    def __exit__(self, *exc):
        for t in self.timers.values():
            t.__exit__(*exc)
        return False

    def text(self) -> str:
        t = self.timers
        return (f"config {sum(t['config'].ms):.1f} ms, scene assembly "
                f"{sum(t['assembly'].ms) / 1e3:.2f} s (3DGS load "
                f"{sum(t['ply'].ms) / 1e3:.2f} s, glTF surfelize and bake "
                f"{sum(t['gltf'].ms) / 1e3:.3f} s, rtbox "
                f"{sum(t['rtbox'].ms) / 1e3:.3f} s)")


# The short names of the launch tallies that phases print and sum, by
# their key in launch.launches.
COUNT_NAMES = dict(
    fwd="tile_fwd", bwd="tile_bwd", fwd_any="tile_fwd_cluster",
    bwd_any="tile_bwd_cluster", fwd_group="tile_fwd_group_loop",
    bwd_group="tile_bwd_group_loop", gather_bwd="packet_gather_bwd",
    trace="grid_trace", vis="grid_visibility", trace_wide="grid_trace_wide",
    vis_wide="grid_visibility_wide", topk="dense_topk",
    dense_vis="dense_visibility", rng="threefry")


def reset_counts() -> None:
    """Zeroes every hand kernel's launch count."""
    launch.launches.clear()


def read_counts() -> dict:
    """The launch counts under their short names (COUNT_NAMES)."""
    return {name: launch.launches[key] for name, key in COUNT_NAMES.items()}


def zero_launches(*keys) -> None:
    """Zeroes the launch counts of ``keys`` alone."""
    for key in keys:
        launch.launches[key] = 0


def launch_counts(*keys) -> tuple:
    """The launch counts of ``keys``."""
    return tuple(launch.launches[key] for key in keys)


def run_cli(cli, argv) -> list:
    """cli.main(argv) in this process; returns the lines it printed (and
    prints them)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        cli.main(argv)
    return buf.getvalue().splitlines()


def objects_seen(ref, scene, settings, frames, parts, res: int = 64) -> dict:
    """For each object (name -> its Gaussians' index range in the assembled
    scene), the poses whose primary rays (res x res, fov 45) hit it: a ray
    with alpha above the hit threshold whose hit lies inside the object's
    box, grown by 2 cm."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays,
    )

    seen = {name: [] for name in parts}
    boxes = {name: (scene.means[a:b].amin(0) - 0.02,
                    scene.means[a:b].amax(0) + 0.02)
             for name, (a, b) in parts.items()}
    with torch.no_grad():
        for i, frame in enumerate(frames):
            c2w = torch.tensor(np.asarray(frame["transform_matrix"],
                                          np.float32), device=scene.means.device)
            rays = generate_rays(Camera(c2w=c2w, fov_y_deg=45.0, width=res,
                                        height=res))
            inter = ref.trace_dense(scene, rays, settings)
            hit = inter["alpha_acc"] > settings.hit_opacity_threshold
            for name, (lo, hi) in boxes.items():
                inside = ((inter["position"] >= lo) & (inter["position"] <= hi)
                          ).all(-1) & hit
                if int(inside.sum()) > 0:
                    seen[name].append((i, int(inside.sum())))
    return seen


def cli_capture(cli, capture, gm, gt, tc, dt, ref, cfg_path: str, out: str,
                n_room: int, card: str) -> dict:
    """9a: ``capture-dataset --scene <config> --output <dir>`` through
    cli.main, on the card by default; its loaders, the capture and the
    files checked, the kernels' launches counted, the times printed."""
    from PIL import Image

    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
        load_point_cloud_ply,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
        load_transforms_json,
    )

    with open(cfg_path) as fh:
        cfg = json.load(fh)["settings"]
    poses, spp, res = (cfg["total_positions"], cfg["accumulation_steps"],
                       cfg["width"])
    n_rays = cfg["torus_settings"]["num_rays"]
    lines, stamps = [], []
    real_capture = cli.capture_scene_data

    def capture_with_progress(*args, **kw):
        def progress(msg: str) -> None:
            stamps.append(time.perf_counter())
            lines.append(msg)
            if not msg.startswith("point cloud rays") \
                    or msg.endswith(f" {n_rays}/{n_rays}"):
                log("phase 9a: " + msg)

        return real_capture(*args, progress=progress, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cli.capture_scene_data = capture_with_progress
    try:
        with Loaders(cli) as loaders, \
                HostTimer(gt, "build_grid_accel") as builds, \
                HostTimer(capture, "prepare_tiles") as prep, \
                HostTimer(capture, "pathtrace_camera") as samples, \
                FirstCalls(capture, "pathtrace_camera") as sample_args, \
                HostTimer(capture, "_trace_host") as traces, \
                HostTimer(capture, "save_point_cloud_ply") as ply:
            t0 = time.perf_counter()
            # --spp as the config's accumulation_steps: the command's
            # default (32) overrides the config's, as the reference's does.
            printed = run_cli(cli, ["capture-dataset", "--scene", cfg_path,
                                    "--output", out, "--spp", str(spp)])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
    finally:
        cli.capture_scene_data = real_capture
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    scene, punctual = loaders.timers["assembly"].results[0]
    n_gltf = loaders.timers["gltf"].results[0][0].num_gaussians
    n_rtbox = loaders.timers["rtbox"].results[0].num_gaussians

    # The scene: every object, the lights (the glTF's spot, then the sun).
    check(scene.means.device.type == "cuda", f"9a: scene on {scene.means.device}")
    check(scene.num_gaussians == n_room + n_gltf + n_rtbox
          and n_gltf > 0 and n_rtbox == 4 * CLI_RTBOX_PANEL_RES ** 2,
          f"9a: {scene.num_gaussians} Gaussians, glTF {n_gltf}, rtbox "
          f"{n_rtbox}")
    check(punctual is not None
          and punctual.light_type.tolist() == [2, 1],
          f"9a: lights {None if punctual is None else punctual.light_type}")
    # The capture: the route, one grid, the kernels, the files.
    check(lines[0] == "capture backend: tiled+grid",
          f"9a: auto resolved to '{lines[0]}'")
    check(len(builds.ms) == 1,
          f"9a: build_grid_accel ran {len(builds.ms)} times")
    check(launches["fwd"] == poses * spp and launches["trace"] > 0
          and launches["vis"] > 0 and launches["topk"] == 0
          and launches["dense_vis"] == 0 and launches["rng"] > poses * spp,
          f"9a: kernel launches {launches}")
    names = sorted(os.listdir(os.path.join(out, "train")))
    check(names == [f"r_{i}.jpg" for i in range(poses)],
          f"9a: train/ holds {names}")
    transforms = {s: load_transforms_json(os.path.join(
        out, f"transforms_{s}.json")) for s in ("train", "test")}
    split = [len(transforms[s]["frames"]) for s in ("train", "test")]
    check(split == [3, 1], f"9a: train/test frames {split}")
    for name in names:
        size = Image.open(os.path.join(out, "train", name)).size
        check(size == (res // 2, res // 2), f"9a: {name} is {size}")
    with open(os.path.join(out, "points3d.ply")) as fh:
        header = [next(fh) for _ in range(12)]
    rows_in_header = int(header[2].split()[-1])
    cloud = load_point_cloud_ply(os.path.join(out, "points3d.ply"))
    n_points = rows_in_header
    check(rows_in_header == len(cloud["positions"]) > 0,
          f"9a: header {rows_in_header}, rows {len(cloud['positions'])}")
    check(all(bool(np.isfinite(cloud[k]).all()) for k in cloud),
          "9a: point-cloud rows not finite")
    for prefix in ("binning truncation", "grid-accel truncation",
                   "marcher truncation"):
        check(any(ln.startswith(prefix) for ln in lines),
              f"9a: no '{prefix}' report line")
    want = json.dumps(dict(points=n_points, train=3, test=1))
    check(printed[-1] == want, f"9a: printed '{printed[-1]}', not '{want}'")
    for name in names:
        shutil.copy(os.path.join(out, "train", name),
                    os.path.join(OUT_DIR, "phase9a_train_" + name))
    log(f"phase 9a: capture-dataset --scene scene.json: {scene.num_gaussians} "
        f"Gaussians (room {n_room} + glTF {n_gltf} + rtbox {n_rtbox}), lights "
        f"spot + sun, auto -> tiled+grid, {poses} poses {res}x{res} fov 45 / "
        f"2, {spp} spp, depth 4, {n_points} PLY rows (finite), one grid "
        f"build, report lines, printed {printed[-1]}: ok; launches "
        f"{json.dumps(launches)} ({card})")

    # Each object in at least one pose image.
    settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    frames = sorted(transforms["train"]["frames"] + transforms["test"]["frames"],
                    key=lambda f: int(f["file_path"].rsplit("_", 1)[1]))
    parts = dict(room=(0, n_room), gltf_cube=(n_room, n_room + n_gltf),
                 rtbox=(n_room + n_gltf, scene.num_gaussians))
    seen = objects_seen(ref, scene, settings, frames, parts)
    check(all(seen.values()), f"9a: objects not seen in any pose: {seen}")
    log(f"phase 9a: each object is hit by the primary rays of a pose "
        f"(64x64 through the dense trace; pose, rays): {json.dumps(seen)}")

    # The times.
    med = statistics.median(samples.ms)
    per_pose = [statistics.median(samples.ms[i * spp:(i + 1) * spp])
                for i in range(poses)]
    pose_stamps = [t for t, ln in zip(stamps, lines)
                   if ln.startswith("captured position")]
    pose_s = [b - a for a, b in zip(pose_stamps[:-1], pose_stamps[1:])]
    pc_stamps = [t for t, ln in zip(stamps, lines)
                 if ln.startswith("point cloud rays")]
    pc_s = pc_stamps[-1] - pose_stamps[-1]
    ply_s = ply.ms[0] / 1e3
    args, kw = sample_args.calls[None]
    split_ms = profile_split("phase9a_sample", lambda: capture.pathtrace_camera(
        *args, **kw), med, card, GRID_PROFILE_NAMES)
    busy = sum(split_ms.values()) / med
    log(f"phase 9a: loaders: {loaders.text()} ({card})")
    log(f"phase 9a: per pose: prepare ms "
        f"{', '.join(f'{m:.1f}' for m in prep.ms)}; sample ms median "
        f"{', '.join(f'{m:.1f}' for m in per_pose)} (all {med:.1f}); pose s "
        f"(poses 2-4) {', '.join(f'{x:.2f}' for x in pose_s)}; one profiled "
        f"sample {busy:.1%} busy; grid build {builds.ms[0] / 1e3:.2f} s "
        f"({card})")
    log(f"phase 9a: point-cloud pass {pc_s:.2f} s ({n_rays * spp / pc_s:.4e}"
        f" rays/s; its trace {sum(traces.ms):.1f} ms in {len(traces.ms)} "
        f"chunks); PLY write {ply_s:.2f} s for {n_points} rows; total "
        f"{total_s:.2f} s (the command, loaders included); peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    return dict(launches=launches, n=scene.num_gaussians, total_s=total_s)


def cli_subprocess(cfg_path: str, out: str, card: str) -> None:
    """9b: ``python -m pathtracer_gaussiansplatting_tpu_torch.cli render
    --scene <9a's config> --spp 4`` as a user types it, without --device."""
    from PIL import Image

    png = os.path.join(out, "render_9b.png")
    cmd = [sys.executable, "-m", "pathtracer_gaussiansplatting_tpu_torch.cli",
           "render", "--scene", cfg_path, "--spp", "4", "--output", png]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    for line in (res.stdout + res.stderr).splitlines()[-20:]:
        log("  9b| " + line)
    check(res.returncode == 0, f"9b: the command exited {res.returncode}")
    img = np.asarray(Image.open(png), np.float32)
    check(img.shape == (800, 800, 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, f"9b: PNG {img.shape}, mean "
          f"{img.mean()}")
    shutil.copy(png, os.path.join(OUT_DIR, "phase9b_render.png"))
    log(f"phase 9b: {' '.join(cmd[1:3])} render --scene scene.json --spp 4 "
        f"(no --device): exit 0 in {wall:.1f} s of wall (a new process: "
        f"imports, the kernels' library loaded, the scene loaded, the grid "
        f"built, 4 samples at 800x800); PNG 800x800, mean "
        f"{img.mean():.2f}/255 ({card})")


def small_cli_world(root: str) -> str:
    """9c's config: tests/test_utils_cli.py's debug cube (size 8 on the
    torus axis, depth 1), a small 3DGS checkpoint (sigma 0.2-0.5) above it
    and a small textured glTF cube beside that, sky behind it."""
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import save_3dgs_ply
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )

    save_3dgs_ply(os.path.join(root, "cloud.ply"), random_cloud(
        60, seed=9, spread=1.0, scale_range=(-1.6, -0.7), device="cpu"))
    gltf_cube(os.path.join(root, "cube.gltf"), 0.5, spot=False)
    path = os.path.join(root, "small.json")
    with open(path, "w") as fh:
        json.dump({
            "settings": {
                "ambient_light": [0.1, 0.1, 0.15, 1.0],
                "torus_settings": {"major_radius": 16.0, "height": 8.0,
                                   "num_rays": 300},
                "accumulation_steps": 2, "total_positions": 2,
                "width": 16, "height": 16, "max_depth": 1},
            "objects": [
                {"model": "builtin:debug_cube?size=8", "position": [0, 8, 0]},
                {"model": "cloud.ply", "position": [0, 13.5, 0]},
                {"model": "cube.gltf", "position": [6, 13.5, -1]}]}, fh)
    return path


def cli_card_vs_cpu(cli, capture, root: str, dev, card) -> None:
    """9c: the small config's capture-dataset (4 poses at 96x64, 2 spp,
    4096 sensor rays) and render (96x64, 2 spp) through cli.main with
    --device cuda and --device cpu, held to 8b's gates."""
    from PIL import Image

    from pathtracer_gaussiansplatting_tpu_torch.data.images import (
        to_uint8_srgb,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
        load_transforms_json,
    )

    root = os.path.join(root, "small")
    os.makedirs(root)
    cfg = small_cli_world(root)
    runs, renders = [], []
    for device in (dev, torch.device("cpu")):
        d = str(device.type)
        out = os.path.join(root, f"ds_{d}")
        with Loaders(cli) as loaders, \
                HostTimer(capture, "save_jpg", keep=True) as jpgs, \
                HostTimer(capture, "save_point_cloud_ply", keep=True) as ply:
            t0 = time.perf_counter()
            printed = run_cli(cli, [
                "capture-dataset", "--scene", cfg, "--output", out,
                "--positions", "4", "--width", "96", "--height", "64",
                "--spp", "2", "--num-rays", "4096", "--device", d])
            secs = time.perf_counter() - t0
            transforms = {s: load_transforms_json(os.path.join(
                out, f"transforms_{s}.json")) for s in ("train", "test")}
            decoded = [np.asarray(Image.open(a[0]), np.int32)
                       for a, _ in jpgs.calls]
        scene = loaders.timers["assembly"].results[0][0]
        check(scene.means.device.type == device.type,
              f"9c: --device {d} loaded the scene on {scene.means.device}")
        means = scene.means.cpu().numpy()
        runs.append(dict(
            secs=secs, num_points=json.loads(printed[-1])["points"],
            transforms=transforms,
            images=[to_uint8_srgb(a[1]).astype(np.int32)
                    for a, _ in jpgs.calls],
            decoded=decoded, cloud=ply.calls[0][0][1:],
            extent=float((means.max(0) - means.min(0)).max())))
        png = os.path.join(root, f"render_{d}.png")
        run_cli(cli, ["render", "--scene", cfg, "--output", png, "--spp",
                      "2", "--width", "96", "--height", "64", "--device", d])
        renders.append(np.asarray(Image.open(png), np.int32))
    compare_captures("9c", runs[0], runs[1], card,
                     "the CLI on tests/test_utils_cli.py's debug cube + a "
                     "3DGS checkpoint + a glTF cube, 4 poses 96x64, 2 spp, "
                     "depth 1, 4096 torus rays")
    share = float((np.abs(renders[0] - renders[1]) <= CLI_RENDER_ATOL).mean())
    check(share >= CLI_RENDER_MIN_SHARE,
          f"9c: render on the card vs the CPU: {share:.4%} of channels within "
          f"{CLI_RENDER_ATOL}/255")
    log(f"phase 9c: render (96x64, 2 spp) on the card vs the CPU: "
        f"{share:.4%} of channels within {CLI_RENDER_ATOL}/255 ({card})")


def cli_commands(cli, gm, gt, tc, dt, cfg_path: str, root: str,
                 card: str) -> dict:
    """9d: render, panorama, fit, view-pointcloud (world and torus) and
    interact on 9a's config, at the command line's sizes; returns the
    kernels' launches summed over them."""
    from PIL import Image

    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import load_3dgs_ply
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
    from pathtracer_gaussiansplatting_tpu_torch.render import session

    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    def image(path):
        img = np.asarray(Image.open(path), np.float32)
        check(bool(np.isfinite(img).all()) and float(img.max()) > 0,
              f"9d: {path} empty or not finite")
        return img

    # render, 800x800, 16 spp.
    reset_counts()
    png = os.path.join(root, "render_9d.png")
    with Loaders(cli) as loaders:
        t0 = time.perf_counter()
        run_cli(cli, ["render", "--scene", cfg_path, "--spp", "16",
                      "--output", png])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c = read_counts()
    add(c)
    check(c["fwd"] == 16 and c["trace"] > 0 and c["vis"] > 0
          and c["topk"] == 0 and c["rng"] > 16, f"9d render: launches {c}")
    img = image(png)
    check(img.shape == (800, 800, 3), f"9d render: {img.shape}")
    shutil.copy(png, os.path.join(OUT_DIR, "phase9d_render.png"))
    log(f"phase 9d: render --spp 16 (800x800, tiled+grid): {wall:.2f} s "
        f"({loaders.text()}); launches {json.dumps(c)} ({card})")

    # panorama, 2 steps x 4 spp.
    reset_counts()
    pano = os.path.join(root, "pano")
    t0 = time.perf_counter()
    run_cli(cli, ["panorama", "--scene", cfg_path, "--steps", "2", "--spp",
                  "4", "--output", pano])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    add(c)
    names = sorted(os.listdir(os.path.join(pano, "panorama")))
    check(names == ["pano_0.jpg", "pano_1.jpg"] and c["trace"] > 0,
          f"9d panorama: {names}, launches {c}")
    for name in names:
        image(os.path.join(pano, "panorama", name))
    log(f"phase 9d: panorama --steps 2 --spp 4 (800x800, the flat renderer "
        f"on the grid): {wall:.2f} s; launches {json.dumps(c)} ({card})")

    # fit with the command's defaults: 64x64, 500 Gaussians, 200 steps.
    reset_counts()
    fitted = os.path.join(root, "fitted.ply")
    with HostTimer(cli, "fit_scene") as fit, \
            HostTimer(dt, "dense_topk", keep=True) as k1:
        t0 = time.perf_counter()
        printed = run_cli(cli, ["fit", "--scene", cfg_path, "--output",
                                fitted])
        wall = time.perf_counter() - t0
    c = read_counts()
    add(c)
    rows = [getattr(a[2], "sorted_rows", a[2]).shape[0] for a, _ in k1.calls]
    m = re.search(r"loss (\S+) -> (\S+) over 200 steps", "\n".join(printed))
    check(m is not None and float(m.group(2)) < float(m.group(1)),
          f"9d fit: printed {printed}")
    check(max(rows) > 500_000 and c["topk"] == len(rows) == 201,
          f"9d fit: dense_topk launches {c['topk']}, table rows "
          f"{sorted(set(rows))}")
    back = load_3dgs_ply(fitted)
    check(back.num_gaussians == 500 and all(
        bool(torch.isfinite(getattr(back, f)).all()) for f in
        ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs")),
          "9d fit: fitted.ply does not load back")
    step_ms = fit.ms[0] / 200
    del k1
    # One more step of the same shapes (the fitted scene, the command's
    # 64x64 rays) under the profiler.
    params = SceneParams.from_scene(back)
    opt = train.make_optimizer(5e-3)
    opt_state = opt(params.parameters())
    step = train.make_train_step(RenderSettings(
        max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0)), opt)
    rays = generate_rays(Camera(
        c2w=look_at((0, 0.5, 4.0), (0, 0, 0)), fov_y_deg=45.0, width=64,
        height=64))
    target = torch.zeros((64 * 64, 3), device=rays.origins.device)
    profile_once("phase9d_fit_step", lambda: step(params, opt_state, rays,
                                                  target), step_ms, card)
    del params, opt_state
    log(f"phase 9d: fit (64x64, 500 Gaussians, 200 steps, lr 5e-3): "
        f"{printed[0]}; the target through dense_topk over {max(rows)} "
        f"Gaussians; {step_ms:.2f} ms a step (fit_scene's wall / 200, "
        f"dense_topk launched {c['topk']} times); command {wall:.1f} s; "
        f"fitted.ply loads back ({card})")

    # view-pointcloud on 9a's point cloud, both placements.
    ply_path = os.path.join(root, "dataset", "points3d.ply")
    for mode in ("world", "torus"):
        png = os.path.join(root, f"pc_{mode}.png")
        t0 = time.perf_counter()
        run_cli(cli, ["view-pointcloud", "--scene", cfg_path, "--ply",
                      ply_path, "--mode", mode, "--output", png])
        wall = time.perf_counter() - t0
        img = image(png)
        shutil.copy(png, os.path.join(OUT_DIR, f"phase9d_pointcloud_{mode}.png"))
        log(f"phase 9d: view-pointcloud --mode {mode} (800x800): "
            f"{wall:.2f} s (the ascii PLY's rows read in Python, then one "
            f"z-buffered scatter); {float((img.max(-1) > 0).mean()):.2%} of "
            f"pixels lit ({card})")

    # interact with a command file.
    reset_counts()
    cmds = os.path.join(root, "interact.txt")
    saved = os.path.join(root, "interact.png")
    with open(cmds, "w") as fh:
        fh.write("\n".join(CLI_INTERACT + [f"save {saved}"]) + "\n")
    steps = []
    real_step = session.InteractiveSession.step

    def counted_step(self):
        before = read_counts()
        out = real_step(self)
        after = read_counts()
        steps.append((self.render_mode, self.frame,
                      {k: after[k] - before[k] for k in after}))
        return out

    session.InteractiveSession.step = counted_step
    try:
        with HostTimer(gt, "build_grid_accel") as builds:
            t0 = time.perf_counter()
            printed = run_cli(cli, ["interact", "--scene", cfg_path,
                                    "--commands", cmds])
            wall = time.perf_counter() - t0
    finally:
        session.InteractiveSession.step = real_step
    c = read_counts()
    add(c)
    frames = [ln for ln in printed if ln.startswith("frame")]
    check(frames == CLI_INTERACT_FRAMES, f"9d interact: printed {frames}")
    camera_steps = [d for mode, _, d in steps if mode == "camera"]
    check(len(camera_steps) == 6 and all(
        d["fwd"] == 1 and d["trace"] > 0 and d["vis"] > 0
        for d in camera_steps) and len(builds.ms) == 1,
          f"9d interact: per-step launches {steps}, grid builds "
          f"{len(builds.ms)}")
    img = np.asarray(Image.open(saved), np.float32)
    check(img.shape == (240, 320, 3) and bool(np.isfinite(img).all()),
          f"9d interact: saved {img.shape}")
    shutil.copy(saved, os.path.join(OUT_DIR, "phase9d_interact.png"))
    log(f"phase 9d: interact ({'; '.join(CLI_INTERACT)}; save): printed "
        f"{frames}; every input reset the accumulation; each of the 6 "
        f"camera-mode steps launched the tile kernel once and K3/K4; one "
        f"grid build; {wall:.1f} s; launches {json.dumps(c)} ({card})")
    return total


# ---- phase 10: the bench --------------------------------------------------

# mfu and fwd_bound_share are shares of a peak; the host clock's noise
# may carry them a little past it, no further.
BENCH_SHARE_MAX = 1.05


def bench_launches(c) -> dict:
    """The kernel launches a bench run at BenchConfig c makes at least:
    the headline's warm-up and timed samples, the training steps (one
    forward and one backward each), the depth-4 and depth-12 samples (a
    bounce trace at each depth but the last, a shadow march at each), the
    poses' samples, the dense baseline's calls; K5 once a bounce of each
    path-traced sample."""
    from pathtracer_gaussiansplatting_tpu_torch import bench

    w = bench.WARMUPS
    pt4 = c.pt_iters + w + (bench.POSE_ITERS + w) * c.pose_spp
    pt12 = bench.PT12_ITERS + w
    return {"fwd": (c.iters + w) + (c.few + w) + pt4 + pt12,
            "bwd": c.few + w, "topk": c.few + w,
            "trace": pt4 * (c.pt_depth - 1) + pt12 * (bench.PT12_DEPTH - 1),
            "vis": pt4 * c.pt_depth + pt12 * bench.PT12_DEPTH,
            "rng": pt4 * c.pt_depth + pt12 * bench.PT12_DEPTH}


def bench_run(cli, tc, gm, dt, card) -> dict:
    """10a: cli.main(["bench"]) at the bench's defaults; its line and its
    kernels' launches checked."""
    from pathtracer_gaussiansplatting_tpu_torch import bench

    env = sorted(k for k in os.environ if k.startswith("GSPT_BENCH_"))
    check(not env, f"10a: {env} set; the bench runs at its defaults here")
    c = bench.BenchConfig()
    reset_counts()
    t0 = time.perf_counter()
    lines = run_cli(cli, ["bench"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    res = json.loads(lines[-1])
    want_keys = [bench.REPLACED_KEYS.get(k, k) for k in
                 bench.reference_bench(os.path.join(ROOT, "bench.py"))[0]]
    check(sorted(res) == sorted(want_keys), f"10a: keys {sorted(res)}, not "
          f"{sorted(want_keys)}")
    for k, v in res.items():
        if isinstance(v, (int, float)):
            check(math.isfinite(v) and v > 0, f"10a: {k} = {v}")
    want_value = c.spp * c.res * c.res / (
        (res["binning_ms_per_pose"] + c.spp * res["sample_ms"]) * 1e-3)
    check(abs(res["value"] - want_value) <= 0.5 + 1e-9 * want_value,
          f"10a: value {res['value']}, recomputed {want_value}")
    for k in ("mfu", "fwd_bound_share"):
        check(res[k] <= BENCH_SHARE_MAX, f"10a: {k} = {res[k]}")
    check(res["device"] == card, f"10a: device {res['device']!r}")
    want = bench_launches(c)
    for k, n in want.items():
        check(counts[k] >= n, f"10a: {k} launched {counts[k]} times, fewer "
              f"than the {n} the bench implies")
    log(f"phase 10a: cli bench in {wall:.1f} s of wall time: value "
        f"{res['value']:.4e} rays/s, binning {res['binning_ms_per_pose']:.3f}"
        f" ms, sample {res['sample_ms']:.4f} ms, fwd+bwd "
        f"{res['fwd_bwd_rays_per_s']:.4e} rays/s, pathtrace "
        f"{res['pathtrace_sample_ms']:.1f} ms, pathtrace12 "
        f"{res['pathtrace12_sample_ms']:.1f} ms, pose {res['pose_s']:.2f} s "
        f"at 512 spp, dense baseline {res['dense_baseline_rays_per_s_scaled']}"
        f" rays/s scaled, vs_baseline {res['vs_baseline']:.1f}, mfu "
        f"{res['mfu']:.4f}, fwd_bound_share {res['fwd_bound_share']:.4f}; "
        f"launches {json.dumps(counts)} (at least {json.dumps(want)}) "
        f"({card})")
    return dict(launches=counts, result=res, wall_s=wall)


def pt12_card_vs_cpu(dev, card) -> None:
    """10b: the bench's depth-12 workload, pathtrace_camera at max_depth
    12, opaque_depth 4 on the grid backend, on surface_scene(2000) lit by
    its panel (the glass sphere in view), 96x64, and the same sample cut at
    depth 4: for each of PT12_KEYS one sample of each on the card and on
    the CPU with the same key. Both depths within the depth-12 gates; what
    bounces 5-12 add, E = I12 - I4 (a bounce's draws depend on the key and
    the depth alone), within PT12_EXTRA_REL and PT12_CHANGED_DIFF."""
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.grid_trace import (
        build_grid_accel,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )

    depths = (bench.PT12_OPAQUE_DEPTH, bench.PT12_DEPTH)
    worlds = {}
    for device in (dev, torch.device("cpu")):
        scene = surface_scene(2000, seed=13, device=device)
        cam = Camera(c2w=look_at(PT_EYE, PT_TARGET, device=device),
                     fov_y_deg=60.0, width=96, height=64)
        worlds[device.type] = scene, cam, build_grid_accel(scene)
    secs = {}
    for k in PT12_KEYS:
        key = rng.fold_in(rng.prng_key(13), k)
        imgs = {}
        for depth in depths:
            st = RenderSettings(max_depth=depth,
                                opaque_depth=bench.PT12_OPAQUE_DEPTH,
                                ambient=bench.PT_AMBIENT)
            for where, (scene, cam, accel) in worlds.items():
                t0 = time.perf_counter()
                with torch.no_grad():
                    imgs[depth, where] = pathtrace_camera(
                        scene, cam, st, key,
                        backend=make_trace_backend(scene, st, "grid",
                                                   accel=accel)).cpu()
                secs.setdefault((depth, where), []).append(
                    time.perf_counter() - t0)
            pt_gates(f"10b key {k}", "pathtrace_camera", imgs[depth, "cuda"],
                     imgs[depth, "cpu"], PT12_MIN_SHARE, st,
                     "grid backend, 2000 Gaussians, 96x64", PT12_MEAN_FRAC)
        lo, hi = depths
        changed = {w: float((imgs[hi, w] != imgs[lo, w]).any(-1).double()
                            .mean()) for w in worlds}
        e_mean = {w: float((imgs[hi, w].double() - imgs[lo, w]).mean())
                  for w in worlds}
        rel = abs(e_mean["cuda"] / e_mean["cpu"] - 1.0)
        frac = e_mean["cpu"] / float(imgs[hi, "cpu"].double().mean())
        log(f"phase 10b key {k}: depth {hi} changes {changed['cuda']:.4%} of "
            f"pixels over depth {lo} on the card, {changed['cpu']:.4%} on "
            f"the CPU (allowed {PT12_CHANGED_DIFF:.0%} apart); what bounces "
            f"{lo + 1}-{hi} add, E = I{hi} - I{lo}, has a mean of "
            f"{e_mean['cuda']:.4e} on the card, {e_mean['cpu']:.4e} on the "
            f"CPU ({frac:.3%} of the image mean): off by {rel:.3%} "
            f"(allowed {PT12_EXTRA_REL:.0%})")
        check(changed["cpu"] > 0.0 and frac > 0.0,
              f"10b key {k}: depth {hi} adds nothing over depth {lo}")
        check(abs(changed["cuda"] - changed["cpu"]) <= PT12_CHANGED_DIFF,
              f"10b key {k}: depth {hi} changes {changed['cuda']:.4%} of "
              f"pixels on the card, {changed['cpu']:.4%} on the CPU")
        check(rel <= PT12_EXTRA_REL, f"10b key {k}: E's mean off by "
              f"{rel:.3%}")
    log("phase 10b: a sample (s) " + ", ".join(
        f"depth {d} on the {'card' if w == 'cuda' else 'CPU'} "
        + "/".join(f"{x:.2f}" for x in v) for (d, w), v in secs.items())
        + f" ({card})")


def pt12_profile(gm, card) -> dict:
    """10c: one of the bench's depth-12 samples at 1920x1080 (the surface
    scene, 500k Gaussians, grid bounces) timed after a warm-up and then
    profiled: the march kernels' share once most rays are dead (a launch
    at every depth, each on every ray with its active mask)."""
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.lights import (
        build_light_tables,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles,
    )

    st = RenderSettings(max_depth=bench.PT12_DEPTH,
                        opaque_depth=bench.PT12_OPAQUE_DEPTH,
                        ambient=bench.PT_AMBIENT)
    scene = surface_scene(500_000, seed=13)
    cam = Camera(c2w=look_at(PT_EYE, PT_TARGET), fov_y_deg=60.0,
                 width=1920, height=1080)
    backend = make_trace_backend(scene, st, "grid")
    cfg = BinningConfig()
    packets = prepare_tiles(scene, cam, st, cfg)
    tables = build_light_tables(scene)
    key = rng.prng_key(13)

    def sample(i):
        with torch.no_grad():
            return pathtrace_camera(scene, cam, st, rng.fold_in(key, i),
                                    packets=packets, tables=tables,
                                    backend=backend, config=cfg)

    host_ms(lambda: sample(0))
    zero_launches("grid_trace", "grid_visibility")
    img, ms = host_ms(lambda: sample(1))
    launches = launch_counts("grid_trace", "grid_visibility")
    check(launches == (st.max_depth - 1, st.max_depth),
          f"10c: grid kernel launches (trace, visibility) {launches}")
    check_pt_image(img.cpu().numpy(), st, "10c")
    log(f"phase 10c: depth-12 sample, 500k surface Gaussians, 1920x1080, "
        f"grid bounces: {ms:.1f} ms; launches per sample grid_trace "
        f"{launches[0]}, grid_visibility {launches[1]} ({card})")
    split = profile_split("phase10c_pt12_sample", lambda: sample(2), ms,
                          card, GRID_PROFILE_NAMES)
    log(f"phase 10c: per launch grid_trace "
        f"{split['grid_trace'] / launches[0]:.3f} ms, grid_visibility "
        f"{split['grid_visibility'] / launches[1]:.3f} ms ({card})")
    return dict(ms=ms, split=split)


class GcClock:
    """Counts Python's garbage collections by generation and the host time
    they take, while it is entered."""

    def __enter__(self):
        self.count, self.ms, self._t0 = [0, 0, 0], 0.0, None
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count[info["generation"]] += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3


def headline_split(tc, card, repeats: int = 5) -> dict:
    """10e: the bench's headline sample (render_prepared at its defaults,
    no jitter) timed as the bench times sample_ms (bench._timed, host
    clock between fences), ``repeats`` times with Python's garbage
    collector on and ``repeats`` times with it off, with the collections
    that ran in the windows and their host time; the card's span a sample
    by CUDA events; one sample profiled (the forward kernel's device
    time, every kernel's, the launches). How much of sample_ms is the
    card's work, and how much the host's."""
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles, render_prepared,
    )

    c = bench.BenchConfig()
    scene, cam, st, cfg = bench.headline(c, torch.device("cuda", 0))
    pk = prepare_tiles(scene, cam, st, cfg)

    def sample(i=0):
        return render_prepared(pk, cam, st, cfg,
                               outputs=("color", "alpha_acc"))

    host = {}
    for on in (True, False):
        if not on:
            gc.disable()
        try:
            with GcClock() as clock:
                ms = [bench._timed(sample, c.iters)[1] * 1e3
                      for _ in range(repeats)]
        finally:
            gc.enable()
        host[on] = dict(ms=ms, collections=clock.count, gc_ms=clock.ms)
    event_ms = cuda_ms(sample, c.iters)
    objects = len(gc.get_objects())
    wall = float(np.median(host[True]["ms"]))
    split = profile_split("phase10e_headline_sample", sample, wall, card,
                          dict(tile_composite_fwd="tile_composite_fwd_"
                               "kernel"), op_ranges={})
    busy = sum(split.values())
    log(f"phase 10e: headline sample (bench defaults, {c.iters} samples a "
        f"window, host clock as sample_ms): gc on "
        + ", ".join(f"{x:.4f}" for x in host[True]["ms"])
        + f" ms ({host[True]['collections']} collections by generation, "
        f"{host[True]['gc_ms']:.2f} ms in them over {repeats} windows); gc "
        f"off " + ", ".join(f"{x:.4f}" for x in host[False]["ms"])
        + f" ms; {objects} Python objects tracked; the card's span "
        f"{event_ms:.4f} ms a sample (CUDA events, {c.iters} back to back); "
        f"device busy {busy:.4f} ms a sample, the forward kernel "
        f"{split['tile_composite_fwd']:.4f} ms ({card})")
    return dict(host=host, event_ms=event_ms, busy_ms=busy, split=split)


def dense_baseline_split(dt, card) -> dict:
    """10d: the bench's dense baseline, render_radiance_dense on the first
    50k Gaussians of the headline cloud, 64x32 rays, the list capped at
    bench.DENSE_MAX_K (the root bench's 256): one call's wall time and the
    table's build; the top-K kernel on those rays held to its plain
    version (bit-equal) and timed beside the plain version, the culls'
    counts and its bound by code path."""
    from pathtracer_gaussiansplatting_tpu_torch import bench
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
        render_radiance_dense,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    n = 50_000
    cloud = random_cloud(1_000_000, seed=13, spread=1.5)
    base = GaussianScene(**{f.name: getattr(cloud, f.name)[:n]
                            for f in dataclasses.fields(GaussianScene)})
    rays = generate_rays(Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0)),
                                fov_y_deg=50.0, width=64, height=32))
    st = RenderSettings(max_contribs=bench.DENSE_MAX_K,
                        background=(0.1, 0.2, 0.3))
    k = min(st.max_contribs, n)
    host_ms(lambda: render_radiance_dense(base, rays, st))
    _, call_ms = host_ms(lambda: render_radiance_dense(base, rays, st))
    table, table_ms = host_ms(
        lambda: dt.dense_table(dt.gaussian_table(base, st)))
    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    err = topk_check(dt, (o, d, table, k, st), "the dense baseline's rays",
                     "10d")
    ms = cuda_ms(lambda: dt.dense_topk(o, d, table, k, st), 3)
    plain_ms = cuda_ms(lambda: dt.dense_topk_plain(o, d, table.rows, k, st),
                       1)
    cnt = tch.cull_counts(dt, o, d, table, st, supers=True)
    cnt["contributing"] = contributing_pairs(dt, o, d, table.rows, st)
    bnd = dense_bound(dt, cnt, o.shape[0], n, k)
    log(f"phase 10d: dense baseline (N={n}, R={o.shape[0]}, K={k}): one "
        f"render_radiance_dense {call_ms:.1f} ms of wall time, the table's "
        f"build {table_ms:.2f} ms, dense_topk {ms:.3f} ms (CUDA events, 3 "
        f"launches), plain {plain_ms:.1f} ms; " + topk_counts_line(cnt)
        + f" ({cnt['contributing'] / o.shape[0]:.0f} with alpha > 0 a ray); "
        f"bound by code path {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, "
        f"{bnd['bound_ms'] / ms:.1%} of its rate; the function's bound "
        f"{bnd['function_bound_ms']:.4f} ms ({card})")
    return dict(bnd, name="the bench's dense baseline", k=k, ms=ms,
                plain_ms=plain_ms, max_abs_err=err)


# ---- phase 11: the (rays, gauss) mesh and the spatial slab ring -----------

# 11a: BASELINE config #5's slab at full size, a 64x64 tile of a 4K frame
# (tests/test_spatial.py:283's smoke at the size it names).
SPATIAL_N, SPATIAL_TILE, SPATIAL_K = 2_000_000, 64, 64
SPATIAL_FRAME = (3840, 2160)
SPATIAL_SUBSET = 256  # rays held to the plain version
SPATIAL_K_LIST = 160  # 11e's K: lists above 128
# 11b: phase 5's scene and pose; 11c: phase 6's scene and 6b's chunks;
# 11d: the headline cloud's first SHARD_N Gaussians and SHARD_RAYS rays of
# its camera.
BACKEND_N, BACKEND_RES, BACKEND_SPP = 50_000, 800, 4
SLAB_GRID_N, SLAB_GRID_FRAME, SLAB_CHUNK = 500_000, (1920, 1080), 65536
SHARD_CLOUD, SHARD_N, SHARD_RAYS, SHARD_RES = 1_000_000, 50_000, 65536, 800
# The ring's composite on the card against the same composite over the
# plain top-K (which the kernel equals bit for bit), and ring_topk_radiance
# against render_radiance_dense: the same pairs summed in the same order,
# up to the merge's gathers.
RING_RTOL, RING_ATOL = 1e-5, 1e-6
# 11c: at S = 1 each fold is 0 + 1 x (or 1 + 1 (x - 1) for the
# transmittance), so the ring equals the single-device march within this.
SLAB_EXACT_ATOL = 1e-6
FIT_STEPS_11 = 8
# 11f: benchmarks/scaling.py's main defaults (n_gauss, rays_per_device,
# iters). 11g runs tools/spatial_chip at its defaults, which are
# benchmarks/spatial_chip.py's, and holds its march on the first
# SPATIAL_CHIP_GRID_SUBSET rays to march_plain.
SCALE_N, SCALE_RAYS, SCALE_ITERS = 5000, 4096, 3
SPATIAL_CHIP_GRID_SUBSET = 16384
# Losses of fit_scene(mesh=) against fit_scene at world size 1, both with
# deterministic kernels: the all-reduce over one rank changes nothing.
FIT_LOSS_RTOL = 1e-6


class PlainTopK:
    """Swaps dense_trace.dense_topk for its plain version (on the same
    tensors, on the card) while in use: the plain composite of a path."""

    def __init__(self, dt):
        self.dt, self.orig = dt, dt.dense_topk

    def __enter__(self):
        dt = self.dt

        def plain(origins, dirs, table, k, settings, sort_depths=None,
                  active=None):
            rows = table.rows if isinstance(table, dt.DenseTable) else table
            return dt.dense_topk_plain(origins, dirs, rows, k, settings,
                                       sort_depths, active)

        dt.dense_topk = plain
        return self

    def __exit__(self, *exc):
        self.dt.dense_topk = self.orig
        return False


def mesh_setup(card):
    """Phase 11's process group and meshes: initialize_multihost() with no
    rendezvous (a world of one on a file store, NCCL for CUDA tensors and
    gloo for CPU ones), the (1, 1) mesh on the card and one on the CPU;
    one all-reduce over each axis group on each."""
    import torch.distributed as dist

    from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm

    rank = pm.initialize_multihost()
    backend = dist.get_backend()
    check(rank == 0 and dist.get_world_size() == 1 and "nccl" in backend,
          f"11: rank {rank}, world {dist.get_world_size()}, backend "
          f"{backend}")
    mesh, mesh_cpu = pm.make_mesh((1, 1)), pm.make_mesh((1, 1), device="cpu")
    for m, dev in ((mesh, "cuda"), (mesh_cpu, "cpu")):
        for axis in (pm.RAY_AXIS, pm.GAUSS_AXIS):
            x = torch.arange(4.0, device=dev)
            dist.all_reduce(x, group=m.get_group(axis))
            check(torch.equal(x.cpu(), torch.arange(4.0)),
                  f"11: all_reduce over {axis} on {dev}")
    log(f"phase 11: initialize_multihost -> rank {rank} of "
        f"{dist.get_world_size()}, backend '{backend}'; meshes {mesh} and "
        f"{mesh_cpu}; an all_reduce over each axis group on CUDA (NCCL) and "
        f"CPU (gloo) tensors ({card})")
    return mesh, mesh_cpu


def spatial_2m(dt, mesh, dev, card) -> dict:
    """11a: render_spatial on a 64x64 tile of a 4K frame over
    random_cloud(2M, seed 13, spread 2) in one slab, K=64: forward, then
    forward and backward to opacity_logits; the ring's composite on the
    card against the plain top-K's on SPATIAL_SUBSET rays."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        Rays, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial

    t0 = time.perf_counter()
    scene = random_cloud(SPATIAL_N, seed=13, spread=2.0, device=dev)
    slabbed, _ = spatial.partition_slabs(scene, 1)
    del scene
    block = pm.shard_scene(slabbed, mesh)
    w, h = SPATIAL_FRAME
    cam = Camera(c2w=look_at((0.0, 0.5, 6.0), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=w, height=h)
    full = generate_rays(cam)
    rows = torch.arange(h // 2 - SPATIAL_TILE // 2,
                        h // 2 + SPATIAL_TILE // 2, device=full.origins.device)
    cols = torch.arange(w // 2 - SPATIAL_TILE // 2,
                        w // 2 + SPATIAL_TILE // 2, device=rows.device)
    sel = (rows[:, None] * w + cols[None]).reshape(-1)
    rays = pm.shard_rays(Rays(full.origins[sel].contiguous(),
                              full.directions[sel].contiguous()), mesh,
                         spatial.spatial_sharding(mesh))
    del full
    settings = RenderSettings(max_contribs=SPATIAL_K)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_launches("dense_topk")
    with torch.no_grad(), HostTimer(dt, "dense_topk", keep=True) as k1:
        out, fwd_ms = host_ms(lambda: spatial.render_spatial(
            block, rays, settings, mesh))
    fwd_launches = launch.launches["dense_topk"]
    logits = block.opacity_logits.clone().requires_grad_(True)

    def fwd_bwd():
        img = spatial.render_spatial(block.replace(opacity_logits=logits),
                                     rays, settings, mesh)
        torch.mean(img ** 2).backward()
        return img

    img, grad_ms = host_ms(fwd_bwd)
    launches = launch.launches["dense_topk"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(fwd_launches == 2 and launches == 4,
          f"11a: dense_topk launched {fwd_launches} / {launches} times, not "
          f"2 a call (forward and reverse keys)")
    check(tuple(out.shape) == (SPATIAL_TILE ** 2, 3)
          and bool(torch.isfinite(out).all()), "11a: radiance not finite")
    compare(img.detach(), out, "11a forward under grad (t and alpha "
            "recomputed in torch) vs the kernel's", rtol=RING_RTOL,
            atol=RING_ATOL)
    g = logits.grad
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
          "11a: opacity gradient not finite or all zero")
    sub = Rays(rays.origins[:SPATIAL_SUBSET], rays.directions[:SPATIAL_SUBSET])
    with torch.no_grad():
        got = spatial.render_spatial(block, sub, settings, mesh)
        with PlainTopK(dt):
            want = spatial.render_spatial(block, sub, settings, mesh)
    err = compare(got, want, "11a render_spatial vs plain top-K",
                  rtol=RING_RTOL, atol=RING_ATOL)
    log(f"phase 11a: render_spatial, random_cloud({SPATIAL_N}) in 1 slab, a "
        f"{SPATIAL_TILE}x{SPATIAL_TILE} tile of {w}x{h} "
        f"({SPATIAL_TILE ** 2} rays), K={SPATIAL_K}: forward {fwd_ms:.1f} ms "
        f"(dense_topk {k1.ms[0]:.1f} ms with the forward key, no ray "
        f"active, and {k1.ms[1]:.1f} ms with the reverse key), forward + "
        f"backward to opacity_logits {grad_ms:.1f} ms (host clock, "
        f"synchronized); dense_topk launches {launches} (2 a call); peak "
        f"memory {peak:.2f} GiB; setup {setup_s:.1f} s; radiance mean "
        f"{float(out.mean()):.5f}, |grad| max {float(g.abs().max()):.3e}, "
        f"{int((g != 0).sum())} Gaussians with a gradient ({card})")
    log(f"phase 11a: card vs plain top-K on {SPATIAL_SUBSET} rays: max abs "
        f"err {err:.3e} (rtol {RING_RTOL}, atol {RING_ATOL})")
    # The reverse-key launch alone: bit-equal to the plain top-K on all its
    # rays, timed, and its culls counted.
    rargs, rkw = k1.calls[1]
    check(not rkw, "11a: dense_topk was called with keywords")
    with torch.no_grad():
        rev_err = topk_check(dt, tuple(rargs), "the reverse-key launch",
                             "11a")
        rev_ms = cuda_ms(lambda: dt.dense_topk(*rargs), 3)
        rev = dict(name=f"11a the reverse-key launch, K={rargs[3]}",
                   ms=rev_ms, max_abs_err=rev_err,
                   **topk_launch_bound(dt, tuple(rargs), "11a", card,
                                       rev_ms, rays_per_pass=16))
    # 11e: the slab composite at K = SPATIAL_K_LIST (the JAX package's
    # tests/test_spatial.py:324's max_contribs) against the plain top-K on
    # the same rays.
    settings_l = RenderSettings(max_contribs=SPATIAL_K_LIST)
    zero_launches("dense_topk")
    with torch.no_grad():
        got, ms_l = host_ms(lambda: spatial.render_spatial(
            block, sub, settings_l, mesh))
        launches_l = launch.launches["dense_topk"]
        with PlainTopK(dt):
            want = spatial.render_spatial(block, sub, settings_l, mesh)
    check(launches_l == 2,
          f"11e: dense_topk launched {launches_l} times, not 2")
    err_l = compare(got, want, f"11e render_spatial at K={SPATIAL_K_LIST} "
                    "vs plain top-K", rtol=RING_RTOL, atol=RING_ATOL)
    log(f"phase 11e: render_spatial at K={SPATIAL_K_LIST} on "
        f"{SPATIAL_SUBSET} rays of the same slab: {ms_l:.1f} ms (host clock, "
        f"synchronized), dense_topk's launches {launches_l}; card "
        f"vs plain top-K max abs err {err_l:.3e} (rtol {RING_RTOL}, atol "
        f"{RING_ATOL}) ({card})")
    return dict(launches=launches, launches_l=launches_l, rev=rev,
                fwd_ms=fwd_ms, grad_ms=grad_ms, peak_gib=peak)


def spatial_backend_route(tc, dt, mesh, settings, dev, card,
                          dense_ms: float) -> dict:
    """11b: pathtrace_camera through make_trace_backend(slabbed, settings,
    "spatial", accel=mesh) on phase 5's scene (surface_scene(50k) and its
    point light, 800x800, depth 4), spp samples, beside phase 5d's dense
    tiled sample."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        accumulate, pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles,
    )

    spp = BACKEND_SPP
    scene, light, cam = pt_world(BACKEND_N, BACKEND_RES, BACKEND_RES, dev)
    slabbed, _ = spatial.partition_slabs(scene, 1)
    del scene
    backend = make_trace_backend(slabbed, settings, "spatial", accel=mesh)
    cfg = BinningConfig()
    key = rng.prng_key(13)
    packets = prepare_tiles(slabbed, cam, settings, cfg)
    acc = torch.zeros((cam.height * cam.width, 3), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches("tile_fwd", "dense_topk", "dense_visibility", "threefry")
    host, events = [], []
    for f in range(spp):
        jit = rng.subpixel_jitter(key, cam.height, cam.width, f, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        img = pathtrace_camera(slabbed, cam, settings, rng.frame_key(key, f),
                               packets=packets, punctual=light,
                               backend=backend, config=cfg, jitter=jit)
        acc = accumulate(acc, img, f)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    launches = launch_counts("tile_fwd", "dense_topk", "dense_visibility",
                             "threefry")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per = tuple(x / spp for x in launches)
    want = (1, 2 * (settings.max_depth - 1), 2 * settings.max_depth,
            settings.max_depth + 1)
    check(per == want, f"11b: launches per sample (tile fwd, dense_topk, "
          f"dense_visibility, threefry_uniforms) {per}, not {want}")
    out = acc.reshape(cam.height, cam.width, 3).cpu().numpy()
    mean = check_pt_image(out, settings, "11b")
    from pathtracer_gaussiansplatting_tpu_torch.data.images import save_jpg

    jpg = os.path.join(OUT_DIR, f"phase11b_spatial_50k_800_{spp}spp.jpg")
    save_jpg(jpg, out)
    med_h, med_e = statistics.median(host[1:]), statistics.median(events[1:])
    log(f"phase 11b: pathtrace_camera, spatial backend (1 slab, (1, 1) "
        f"mesh), surface_scene(50k) + point light, 800x800, depth 4, {spp} "
        f"spp: sample ms (host clock) {', '.join(f'{m:.1f}' for m in host)}"
        f", median of the rest {med_h:.1f}; CUDA events "
        f"{', '.join(f'{m:.1f}' for m in events)}, median {med_e:.1f}; "
        f"phase 5d's dense tiled sample {dense_ms:.1f} ms; launches per "
        f"sample (tile fwd, dense_topk, dense_visibility, threefry_uniforms) "
        f"{per}; peak memory "
        f"{peak:.2f} GiB ({card})")
    log(f"phase 11b: image finite, mean {mean:.5f}; saved "
        f"{os.path.relpath(jpg, ROOT)}")
    # One more sample through each backend on the same scene and pose,
    # profiled: where the spatial backend's time goes beside the dense one.
    dense = make_trace_backend(slabbed, settings, "dense")
    jit = rng.subpixel_jitter(key, cam.height, cam.width, 99, device=dev)
    names = dict(DENSE_PROFILE_NAMES,
                 tile_composite_fwd="tile_composite_fwd_kernel")
    for tag, be, wall in (("spatial", backend, med_h),
                          ("dense", dense, dense_ms)):
        profile_split(f"phase11b_{tag}_sample", lambda: pathtrace_camera(
            slabbed, cam, settings, rng.frame_key(key, 99), packets=packets,
            punctual=light, backend=be, config=cfg, jitter=jit), wall, card,
            names=names)
    return dict(launches=launches, host_ms=med_h, event_ms=med_e,
                peak_gib=peak)


def spatial_card_vs_cpu(mesh, mesh_cpu, settings, dev, card) -> None:
    """11b's gate: one sample of pathtrace_camera through the spatial
    backend on the card and on the CPU, 2000 Gaussians, 96x64, the same
    key, at depth 1 and at the full depth, with 5b's gates."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        pathtrace_camera,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )

    for depth, min_share in ((1, PT_MIN_SHARE),
                             (settings.max_depth, PT_DEEP_MIN_SHARE)):
        st = dataclasses.replace(settings, max_depth=depth)
        outs = []
        for device, m in ((dev, mesh), (torch.device("cpu"), mesh_cpu)):
            scene, light, cam = pt_world(2000, 96, 64, device)
            slabbed, _ = spatial.partition_slabs(scene, 1)
            key = rng.prng_key(13)
            jit = rng.subpixel_jitter(key, 64, 96, 0, device=device)
            be = make_trace_backend(slabbed, st, "spatial", accel=m)
            outs.append(pathtrace_camera(slabbed, cam, st, key,
                                         punctual=light, jitter=jit,
                                         backend=be).cpu())
        pt_gates("11b", "pathtrace_camera", outs[0], outs[1], min_share, st,
                 "spatial backend, 2000 Gaussians, 96x64")


def grid_slab_checks(gm, gt, mesh, settings, dev, card) -> dict:
    """11c: surface_scene(500k) in one slab, build_slab_accels(Kc=32);
    trace_spatial and visibility_spatial on the grid slab against
    trace_grid and visibility_grid on an accel of the same dims and
    bounds, on 6b's bounce chunk and shadow chunk (65536 rays each)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
    from pathtracer_gaussiansplatting_tpu_torch.tools.chunks import (
        march_chunks,
    )

    scene = surface_scene(SLAB_GRID_N, seed=13, device=dev)
    slabbed, _ = spatial.partition_slabs(scene, 1)
    del scene
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, meta = spatial.build_slab_accels(slabbed, 1, max_per_cell=32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    local = pm.shard_scene(tables, mesh)
    one = gt.GridAccel(btab=tables["btab"][0], geom=tables["geom"][0],
                       packet=tables["packet"][0], lo=tables["lo"][0],
                       hi=tables["hi"][0], dims=meta.dims,
                       fill=tables["fill"][0], jump_unit=meta.jump_unit)
    ref_accel = gt.build_grid_accel(
        slabbed, dims=meta.dims, max_per_cell=32,
        bounds=(tables["lo"][0].cpu().numpy(), tables["hi"][0].cpu().numpy()))
    check(all(torch.equal(getattr(ref_accel, k), getattr(one, k))
              for k in ("btab", "geom", "packet", "fill", "lo", "hi")),
          "11c: the slab's tables differ from build_grid_accel's on the same "
          "dims and bounds")
    cam = Camera(c2w=look_at(PT_EYE, PT_TARGET, device=dev), fov_y_deg=60.0,
                 width=SLAB_GRID_FRAME[0], height=SLAB_GRID_FRAME[1])
    chunks = march_chunks(slabbed, cam, settings, BinningConfig(),
                          n=SLAB_CHUNK)
    (_, bo, bd, _), (_, so, sd, skw) = chunks[0], chunks[1]
    rays = Rays(bo, bd)
    steps = GRID_MAX_STEPS
    zero_launches("grid_trace", "grid_visibility")
    got = spatial.trace_spatial(slabbed, rays, settings, mesh,
                                slab_accel=local, accel_meta=meta,
                                max_steps=steps)
    vis, frozen_v = spatial.visibility_spatial(
        slabbed, so, sd, skw["t_end"], settings, mesh, slab_accel=local,
        accel_meta=meta, max_steps=steps, return_frozen=True)
    launches = launch_counts("grid_trace", "grid_visibility")
    check(launches == (1, 1), f"11c: march launches {launches}, not (1, 1)")
    want = gt.trace_grid(slabbed, rays, settings, ref_accel, max_steps=steps)
    want_v, frozen_w = gt.visibility_grid(slabbed, ref_accel, so, sd,
                                          skw["t_end"], settings,
                                          max_steps=steps, return_frozen=True)
    errs = {}
    for k, w in want.items():
        if k == "frozen_alive":
            check(int(got[k]) == int(w), f"11c: frozen {int(got[k])} != "
                  f"{int(w)}")
        elif k == "hit":
            check(torch.equal(got[k], w), "11c: hit differs")
        else:
            errs[k] = compare(got[k], w, f"11c trace_spatial {k}", rtol=0.0,
                              atol=SLAB_EXACT_ATOL)
    errs["vis"] = compare(vis, want_v, "11c visibility_spatial", rtol=0.0,
                          atol=SLAB_EXACT_ATOL)
    check(int(frozen_v) == int(frozen_w), "11c: shadow frozen counts differ")
    trace_ms = cuda_ms(lambda: spatial.trace_spatial(
        slabbed, rays, settings, mesh, slab_accel=local, accel_meta=meta,
        max_steps=steps), 3)
    grid_ms = cuda_ms(lambda: gt.trace_grid(slabbed, rays, settings,
                                            ref_accel, max_steps=steps), 3)
    vis_ms = cuda_ms(lambda: spatial.visibility_spatial(
        slabbed, so, sd, skw["t_end"], settings, mesh, slab_accel=local,
        accel_meta=meta, max_steps=steps), 3)
    gvis_ms = cuda_ms(lambda: gt.visibility_grid(
        slabbed, ref_accel, so, sd, skw["t_end"], settings,
        max_steps=steps), 3)
    log(f"phase 11c: build_slab_accels(surface_scene(500k), 1 slab, Kc=32) "
        f"{build_s:.2f} s, dims {meta.dims}, stats {dict(meta.stats)}; "
        f"tables equal build_grid_accel's on the same dims and bounds")
    trace_err = max(v for k, v in errs.items() if k != "vis")
    log(f"phase 11c: on 6b's chunks ({bo.shape[0]} bounce rays, "
        f"{so.shape[0]} shadow segments), max_steps {steps}: trace_spatial "
        f"vs trace_grid max abs err {trace_err:.3e}, visibility_spatial vs visibility_grid {errs['vis']:.3e} "
        f"(atol {SLAB_EXACT_ATOL}); frozen {int(got['frozen_alive'])} / "
        f"{int(frozen_v)}, equal; ms (CUDA events, 3 calls): trace_spatial "
        f"{trace_ms:.3f} (trace_grid {grid_ms:.3f}), visibility_spatial "
        f"{vis_ms:.3f} (visibility_grid {gvis_ms:.3f}); launches (grid "
        f"trace, grid visibility) {launches} ({card})")
    return dict(launches=launches)


def sharded_renderers(dt, mesh, dev, card) -> dict:
    """11d: render_dense_ray_sharded and ring_topk_radiance on the
    headline cloud's first 50k Gaussians, 65536 rays of the headline
    camera, K=64, against render_radiance_dense; then fit_scene(mesh=)
    against fit_scene for FIT_STEPS_11 steps."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
    from pathtracer_gaussiansplatting_tpu_torch.parallel import shard, train
    from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
        render_radiance_dense,
    )

    cloud = random_cloud(SHARD_CLOUD, seed=13, spread=1.5, device=dev)
    scene = GaussianScene(**{f: getattr(cloud, f)[:SHARD_N].contiguous()
                             for f in SCENE_FIELDS})
    del cloud
    full = generate_rays(Camera(c2w=look_at((0.0, 0.5, 4.0), (0, 0, 0),
                                            device=dev),
                                fov_y_deg=50.0, width=SHARD_RES,
                                height=SHARD_RES))
    n_full = SHARD_RES * SHARD_RES
    sel = torch.arange(0, n_full, n_full // SHARD_RAYS,
                       device=dev)[:SHARD_RAYS]
    rays = Rays(full.origins[sel].contiguous(),
                full.directions[sel].contiguous())
    settings = RenderSettings(max_contribs=64, background=(0.1, 0.2, 0.3))
    block = pm.shard_scene(pm.pad_to_multiple(scene, 1), mesh)
    rays_block = pm.shard_rays(rays, mesh)
    with torch.no_grad():
        want = render_radiance_dense(scene, rays, settings)
        zero_launches("dense_topk")
        dense = shard.render_dense_ray_sharded(scene, rays, settings, mesh)
        ring = shard.ring_topk_radiance(block, rays_block, settings, mesh)
        launches = launch.launches["dense_topk"]
    check(launches == 2, f"11d: dense_topk launches {launches}, not 2")
    check(torch.equal(pm.gather_rays(dense, mesh), want),
          "11d: render_dense_ray_sharded not bit-equal to "
          "render_radiance_dense")
    err = compare(pm.gather_rays(ring, mesh), want,
                  "11d ring_topk_radiance", rtol=RING_RTOL, atol=RING_ATOL)
    with torch.no_grad():
        dense_ms = cuda_ms(lambda: shard.render_dense_ray_sharded(
            scene, rays, settings, mesh), 3)
        ring_ms = cuda_ms(lambda: shard.ring_topk_radiance(
            block, rays_block, settings, mesh), 3)
        plain_ms = cuda_ms(lambda: render_radiance_dense(scene, rays,
                                                         settings), 3)
    start = scene.replace(sh_coeffs=scene.sh_coeffs + 0.1 * torch.randn(
        scene.sh_coeffs.shape, generator=torch.Generator().manual_seed(5)
    ).to(scene.sh_coeffs.device))
    # The dense gradient's index_put_ accumulates with atomics, in an
    # order that varies run to run, and Adam turns an ulp into a step of lr
    # wherever a gradient entry is near 0; deterministic kernels make two
    # runs of one fit equal, so the mesh's own effect shows.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_launches("dense_topk")
        (_, mesh_losses), mesh_ms = host_ms(lambda: train.fit_scene(
            start, rays, want, settings, steps=FIT_STEPS_11, lr=5e-3,
            mesh=mesh))
        fit_launches = launch.launches["dense_topk"]
        (_, losses), one_ms = host_ms(lambda: train.fit_scene(
            start, rays, want, settings, steps=FIT_STEPS_11, lr=5e-3))
    finally:
        torch.use_deterministic_algorithms(was)
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses))
    check(rel <= FIT_LOSS_RTOL, f"11d: fit_scene(mesh=) losses "
          f"{mesh_losses} vs {losses}")
    log(f"phase 11d: {SHARD_N} Gaussians of the headline cloud, "
        f"{rays.num_rays} "
        f"rays, K=64: render_dense_ray_sharded bit-equal to "
        f"render_radiance_dense; ring_topk_radiance max abs err {err:.3e} "
        f"(rtol {RING_RTOL}, atol {RING_ATOL}); ms (CUDA events, 3 calls): "
        f"dense sharded {dense_ms:.3f}, ring {ring_ms:.3f}, "
        f"render_radiance_dense {plain_ms:.3f} ({card})")
    log(f"phase 11d: fit_scene(mesh=(1, 1)) {FIT_STEPS_11} steps, losses "
        f"{', '.join(f'{x:.6f}' for x in mesh_losses)}; without the mesh "
        f"max rel diff {rel:.3e} (allowed {FIT_LOSS_RTOL}); step ms "
        f"{mesh_ms / FIT_STEPS_11:.1f} with the mesh, "
        f"{one_ms / FIT_STEPS_11:.1f} without (host clock); dense_topk "
        f"launches {fit_launches} ({card})")
    return dict(launches=launches + fit_launches)


def scaling_checks(dt, mesh, dev, card) -> dict:
    """11f: tools/scaling.run_ray_dp on phase 11's (1, 1) mesh at the
    reference's sizes, bit-equal to render_radiance_dense (11d's gate) and
    against the plain top-K on SPATIAL_SUBSET rays; then ``python -m
    ...tools.scaling`` as a user runs it (a world of one rank a card)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays
    from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
        render_radiance_dense,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools import scaling

    scene = scaling.scaling_scene(SCALE_N, dev)
    rays = scaling.scaling_rays(SCALE_RAYS, 1, dev)
    settings = scaling.SETTINGS
    zero_launches("dense_topk")
    res = scaling.run_ray_dp(mesh, scene, rays, settings, SCALE_ITERS)
    launches = launch.launches["dense_topk"]
    check(launches == SCALE_ITERS + 1, f"11f: dense_topk launched "
          f"{launches} times, not {SCALE_ITERS + 1} (a warm-up and "
          f"{SCALE_ITERS} timed calls)")
    sub = Rays(rays.origins[:SPATIAL_SUBSET], rays.directions[:SPATIAL_SUBSET])
    with torch.no_grad():
        want = render_radiance_dense(scene, rays, settings)
        with PlainTopK(dt):
            plain = render_radiance_dense(scene, sub, settings)
    check(torch.equal(res["image"], want), "11f: run_ray_dp not bit-equal "
          "to render_radiance_dense")
    err = compare(res["image"][:SPATIAL_SUBSET], plain,
                  "11f run_ray_dp vs plain top-K", rtol=RING_RTOL,
                  atol=RING_ATOL)
    log(f"phase 11f: tools/scaling.run_ray_dp on the (1, 1) mesh, "
        f"random_cloud({SCALE_N}, seed 13, spread 1.2), {SCALE_RAYS} rays, "
        f"K=32: {res['seconds'] * 1e3:.3f} ms a call (host clock between "
        f"fences, {SCALE_ITERS} calls after a warm-up), "
        f"{res['rays_per_s']:.0f} rays/s; bit-equal to "
        f"render_radiance_dense; vs plain top-K on {SPATIAL_SUBSET} rays max "
        f"abs err {err:.3e} (rtol {RING_RTOL}, atol {RING_ATOL}); dense_topk "
        f"launches {launches} ({card})")
    cmd = [sys.executable, "-m",
           "pathtracer_gaussiansplatting_tpu_torch.tools.scaling"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines()[-20:]:
        log("  11f| " + line)
    check(proc.returncode == 0, f"11f: the tool exited {proc.returncode}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    ran = {ln["devices"]: ln for ln in lines
           if ln.get("mode") == "ray-dp" and "rays_per_s" in ln}
    ring = [ln for ln in lines if ln.get("mode") == "gauss-ring"]
    n_cards = torch.cuda.device_count()
    check(set(ran) == {nd for nd in scaling.WORLD_SIZES if nd <= n_cards}
          and all(ln["rays_per_s"] > 0 for ln in ran.values()),
          f"11f: the tool's ray-dp lines {lines}")
    check(len(ring) == 1 and (
        ring[0].get("functional_ok") is True if n_cards >= 2 else
        "needs 2 ranks" in ring[0].get("skipped", "")),
        f"11f: the tool's ring line {ring}")
    check("efficiencies" in lines[-1], "11f: no summary line")
    log(f"phase 11f: python {' '.join(cmd[1:])} (no --device): exit 0 in "
        f"{wall:.1f} s of wall (a new process and one spawned rank); "
        f"ray-dp at nd=1 {ran[1]['rays_per_s']} rays/s; the ring: "
        f"{json.dumps(ring[0])} ({card})")
    return dict(launches=launches, rays_per_s=res["rays_per_s"],
                tool_rays_per_s=ran[1]["rays_per_s"])


def spatial_chip_checks(dt, gm, gt, dev, card) -> dict:
    """11g: tools/spatial_chip at benchmarks/spatial_chip.py's sizes: the
    dense slab step's features against the plain top-K on SPATIAL_SUBSET
    rays (11a's gate), the grid slab's march on its first
    SPATIAL_CHIP_GRID_SUBSET rays against march_plain (6b's gates) and
    the tool's own trace there against a launch on those rays alone
    (11c's SLAB_EXACT_ATOL: a ray's march depends on no other ray)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays
    from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
    from pathtracer_gaussiansplatting_tpu_torch.tools import spatial_chip

    n_slabs = spatial_chip.SLABS
    t0 = time.perf_counter()
    step = spatial_chip.slab_step(n_slabs=n_slabs, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_launches("dense_topk", "grid_trace")
    res = spatial_chip.measure(step, n_slabs)
    launches = launch_counts("dense_topk", "grid_trace")
    calls = spatial_chip.ITERS + 1
    check(launches == (2 * calls, calls), f"11g: launches (dense_topk, "
          f"grid_trace) {launches}, not {(2 * calls, calls)}")
    n = SPATIAL_SUBSET
    with torch.no_grad(), PlainTopK(dt):
        feats, trans = spatial._slab_interaction_feats(
            step.block, step.origins[:n], step.dirs[:n], step.axis,
            step.settings, step.table)
    err_f = compare(step.feats[:n], feats, "11g slab features vs plain "
                    "top-K", rtol=RING_RTOL, atol=RING_ATOL)
    err_t = compare(step.trans[:n], trans, "11g slab trans vs plain top-K",
                    rtol=RING_RTOL, atol=RING_ATOL)
    g = SPATIAL_CHIP_GRID_SUBSET
    og, dg = step.origins_grid[:g], step.dirs_grid[:g]
    steps = 128  # trace_grid's default, the tool's
    with torch.no_grad():
        got = gt.march(step.accel, og, dg, step.settings, steps)
        want = gt.march_plain(step.accel, og, dg, step.settings, steps)
        torch.cuda.synchronize()
        gates = grid_gates("11g slab march", got, want, True)
        mine = gt.interaction_from_sums(got[0], got[1], og, dg,
                                        step.settings)
    exact = max(compare(step.trace[k][:g], v, f"11g the tool's trace {k} "
                        "vs a launch on its first rays", rtol=0.0,
                        atol=SLAB_EXACT_ATOL)
                for k, v in mine.items() if k != "hit")
    check(torch.equal(step.trace["hit"][:g], mine["hit"]),
          "11g: hit differs")
    out = {k: v for k, v in res.items() if k != "step"}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "spatial_chip.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    log(f"phase 11g: {json.dumps(out)}")
    log(f"phase 11g: tools/spatial_chip, slab 0 of {n_slabs} of "
        f"surface_scene({spatial_chip.N}) ({step.block.num_gaussians} "
        f"Gaussians; set-up "
        f"{setup_s:.1f} s, the grids' build included): table build "
        f"{res['table_build_ms']:.3f} ms, slab step "
        f"{res['slab_compute_ms']:.3f} ms ({step.origins.shape[0]} rays), "
        f"grid slab march {res['grid_slab']['slab_march_ms']:.3f} ms "
        f"({step.origins_grid.shape[0]} rays), host clock after a warm-up; "
        f"features / trans vs plain top-K on {n} rays max abs err "
        f"{err_f:.3e} / {err_t:.3e} (rtol {RING_RTOL}, atol {RING_ATOL}); "
        f"march vs march_plain on {g} rays: {gates['text']}; the tool's "
        f"trace vs a launch on those rays {exact:.3e} (atol "
        f"{SLAB_EXACT_ATOL}); launches (dense_topk, grid_trace) {launches}; "
        f"comm projected at the assumed {spatial_chip.LINK_GBPS:.0f} GB/s "
        f"(not measured) ({card})")
    return dict(launches=launches, result=out)


def phase11(tc, dt, gm, gt, pt_settings, dense_ms, dev, card) -> dict:
    """Phase 11: the mesh, the slab ring and the sharded renderers on a
    world of one (NCCL); returns the path's launches by kernel."""
    import torch.distributed as dist

    t11 = time.perf_counter()
    mesh, mesh_cpu = mesh_setup(card)
    try:
        a = spatial_2m(dt, mesh, dev, card)
        b = spatial_backend_route(tc, dt, mesh, pt_settings, dev, card,
                                  dense_ms)
        spatial_card_vs_cpu(mesh, mesh_cpu, dataclasses.replace(
            pt_settings, rr_start_depth=2, opaque_depth=3), dev, card)
        c = grid_slab_checks(gm, gt, mesh, pt_settings, dev, card)
        d = sharded_renderers(dt, mesh, dev, card)
        t_fg = time.perf_counter()
        f = scaling_checks(dt, mesh, dev, card)
        t_g = time.perf_counter()
        g = spatial_chip_checks(dt, gm, gt, dev, card)
        log(f"phase 11f: {t_g - t_fg:.1f} s; 11g: "
            f"{time.perf_counter() - t_g:.1f} s ({card})")
    finally:
        dist.destroy_process_group()
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    return dict(fwd=b["launches"][0],
                topk=a["launches"] + a["launches_l"] + b["launches"][1]
                + d["launches"] + f["launches"] + g["launches"][0],
                dense_vis=b["launches"][2],
                trace=c["launches"][0] + g["launches"][1],
                vis=c["launches"][1], rng=b["launches"][3],
                topk_rev=a["rev"])


# ---- phase 12: the downstream loop -----------------------------------------

# DOWNSTREAM.json's config: the JAX package's run of
# benchmarks/downstream_loop.py (on "TPU v5 lite0") with its GSPT_DS_*
# variables set to these sizes.
DS_CONFIG = dict(n_gt=50_000, poses=12, spp=32, res=200, n_pc_rays=40_000,
                 fit_steps=900)
# 12b: the loop cut to a size whose CPU side stays under a minute, on the
# card and on the CPU in this process (at 64x64 the CPU side took 76.7 s
# on the H100's host; surface_scene(5000) at 64x64 and 4 spp took 392 s
# on an 8-core CPU).
DS_SMALL = dict(n_gt=2000, poses=4, spp=2, res=48, n_pc_rays=2000,
                fit_steps=60)
# 12b: the capture runs at depth 4, where 8b's share (depth 1) does not
# hold: a flipped thin surfel sends a bounce path elsewhere (ROADMAP
# section 3). At 64x64 the card's 8-bit images had 98.14-99.43% of their
# channels within CAP_IMG_ATOL of the CPU's, the decoded JPGs
# 98.03-99.45% within CAP_JPG_ATOL. The images, JPGs and point colors
# take the path tracer's depth-4 share; every other gate is 8b's.
DS_MIN_SHARE = PT_DEEP_MIN_SHARE
# 12a: the train loss's last value (step 900, pose 8 of 9) at most this
# share of its first (step 1, pose 0). The port's loop on the CPU, 60
# steps at 64x64, fell from 0.0911 to 0.0121 (0.133) at surface_scene(2000)
# and from 0.0549 to 0.0116 (0.211) at surface_scene(5000); the poses'
# losses differ by up to ~2x, which the bound leaves room for.
DS_LOSS_FALL = 0.25
# 12b: test PSNR and SSIM, the card's loop against the CPU's. The JAX
# package's loop against the port's on the CPU
# (tests/test_torch_downstream.py, LOOP_PSNR_ATOL / LOOP_SSIM_ATOL) came
# within 0.0187 dB and 0.0027 at that test's size; these are its bounds.
# The card against the CPU measured 0.0209 dB / 0.00056 at 64x64 and
# 0.0076 dB / 0.00124 at 48x48.
DS_PSNR_ATOL, DS_SSIM_ATOL = 0.1, 0.01


def downstream_run(ds, capture, train, tc, gm, gt, dt, dev, card) -> dict:
    """12a: the loop at DOWNSTREAM.json's config on the card, through
    tools/downstream_loop.run_downstream: its numbers beside the JAX
    package's TPU figures (not a gate), one capture sample and one fit
    step profiled, and on the first fit step's packets the forward and
    the backward kernels against their plain versions (phases 1 and 4a's
    tolerances). Returns the launches by kernel and the kernels' errors."""
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
        load_point_cloud_ply,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles,
    )

    with open(os.path.join(ROOT, "DOWNSTREAM.json")) as fh:
        tpu = json.load(fh)
    c = DS_CONFIG

    def progress(msg: str) -> None:
        if "point cloud rays" not in msg and "captured position" not in msg:
            log("phase 12a: " + msg)

    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_downstream_") as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with HostTimer(capture, "pathtrace_camera") as samples, \
                FirstCalls(capture, "pathtrace_camera") as sample_args:
            t0 = time.perf_counter()
            res = ds.run_downstream(out, device=dev, progress=progress, **c)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        pc = load_point_cloud_ply(os.path.join(out, "points3d.ply"))
        cams, imgs = ds.load_split(out, "train", dev)
    fitted = res.pop("fitted")
    rows = len(pc["positions"])
    n_test = len(res["test_psnr"])
    log(f"phase 12a: the downstream loop at DOWNSTREAM.json's config "
        f"(surface_scene({c['n_gt']}), {c['poses']} poses x {c['spp']} spp "
        f"at {c['res']}x{c['res']}, {c['n_pc_rays']} point-cloud rays, "
        f"{c['fit_steps']} fit steps): capture {res['capture_s']:.2f} s, fit "
        f"{res['fit_s']:.2f} s (median step {res['fit_step_ms']:.3f} ms over "
        f"steps 2-{c['fit_steps']}), the loop {wall_s:.2f} s, peak memory "
        f"{peak_gib:.2f} GiB ({card})")
    log(f"phase 12a: test PSNR "
        + ", ".join(f"{x:.3f}" for x in res["test_psnr"])
        + f" dB (mean {res['test_psnr_mean']:.3f}), SSIM "
        + ", ".join(f"{x:.4f}" for x in res["test_ssim"])
        + f" (mean {res['test_ssim_mean']:.4f}); train loss "
        f"{res['train_loss_first']:.6f} -> {res['train_loss_last']:.6f}; "
        f"train pose 0 PSNR {res['train_pose0_psnr']:.3f} dB, SSIM "
        f"{res['train_pose0_ssim']:.4f}; {rows} PLY rows, "
        f"{fitted.num_gaussians} fitted Gaussians; capture samples "
        f"{len(samples.ms)}, median {statistics.median(samples.ms):.2f} ms "
        f"({card})")
    log(f"phase 12a: beside it, the JAX package on \"{tpu['device']}\" "
        f"(DOWNSTREAM.json, the same config; not a gate): capture "
        f"{tpu['capture_s']} s, fit {tpu['fit_s']} s, test PSNR mean "
        f"{tpu['test_psnr_mean']:.3f} dB, SSIM mean "
        f"{tpu['test_ssim_mean']:.4f}, train loss "
        f"{tpu['train_loss_first']:.6f} -> {tpu['train_loss_last']:.6f}, "
        f"{tpu['config']['fitted_gaussians']} fitted Gaussians")
    log(f"phase 12a: launches {json.dumps(launches)} ({card})")
    check(tpu["config"]["poses"] == c["poses"]
          and tpu["config"]["fit_steps"] == c["fit_steps"],
          f"12a: DOWNSTREAM.json's config {tpu['config']} is not {c}")
    numbers = [res[k] for k in (
        "capture_s", "fit_s", "fit_step_ms", "train_loss_first",
        "train_loss_last", "train_pose0_psnr", "train_pose0_ssim",
        "test_psnr_mean", "test_ssim_mean")] + res["test_psnr"] \
        + res["test_ssim"] + [peak_gib]
    check(all(math.isfinite(x) for x in numbers), f"12a: {res}")
    check(res["train_loss_last"] <= DS_LOSS_FALL * res["train_loss_first"],
          f"12a: the train loss fell from {res['train_loss_first']} to "
          f"{res['train_loss_last']}, not below {DS_LOSS_FALL} of it")
    check(res["config"]["fitted_gaussians"] == fitted.num_gaussians == rows
          and 0 < rows <= c["n_pc_rays"],
          f"12a: {rows} PLY rows, {fitted.num_gaussians} fitted Gaussians")
    check(n_test == len(range(0, c["poses"], 4)),
          f"12a: {n_test} test poses")
    samples_n = c["poses"] * c["spp"]
    check(launches["fwd"] == samples_n + c["fit_steps"] + 1 + n_test
          and launches["bwd"] == c["fit_steps"] and launches["trace"] > 0
          and launches["vis"] > 0 and launches["topk"] == 0
          and launches["dense_vis"] == 0 and launches["rng"] > samples_n,
          f"12a: launches {launches}: the forward once a capture sample, a "
          f"fit step, the fit's last render and a test render; the backward "
          f"once a fit step; threefry_uniforms once a bounce and a jittered "
          f"sample")

    # Both tile kernels against their plain versions on the first fit
    # step's packets: sh_degree 1, isotropic splats from the point cloud.
    cfg = BinningConfig()
    init = ds.init_from_point_cloud(pc, dev)
    with torch.no_grad():
        packets = prepare_tiles(init, cams[0], ds.FIT_SETTINGS, cfg)
    dirs, _ = _tile_dirs(cams[0], cfg)
    got = tc.tile_composite(packets, dirs, ds.FIT_SETTINGS)
    want = tc.tile_composite_plain(packets, dirs, ds.FIT_SETTINGS)
    torch.cuda.synchronize()
    fwd_err = max(compare(got[0], want[0], "12a out"),
                  compare(got[1], want[1], "12a alpha_acc"),
                  compare(got[2], want[2], "12a depth", mask=want[1] > 1e-3))
    fwd_ms = cuda_ms(lambda: tc.tile_composite(packets, dirs,
                                               ds.FIT_SETTINGS), 20)
    plain_ms = cuda_ms(lambda: tc.tile_composite_plain(packets, dirs,
                                                       ds.FIT_SETTINGS), 3)
    log(f"phase 12a: the first fit step's packets geom "
        f"{tuple(packets['geom'].shape)}: forward kernel vs plain max abs "
        f"err {fwd_err:.3e} (rtol {RTOL}, atol {ATOL}); kernel {fwd_ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms ({card})")
    bwd = bwd_check(tc, packets, dirs, ds.FIT_SETTINGS, "first fit step",
                    card, phase="12a")

    # One capture sample and one fit step profiled.
    args, kw = sample_args.calls[None]
    split = profile_split("phase12_capture_sample",
                          lambda: capture.pathtrace_camera(*args, **kw),
                          statistics.median(samples.ms), card,
                          GRID_PROFILE_NAMES)
    log(f"phase 12a: one capture sample {sum(split.values()):.3f} ms of "
        f"device time over {statistics.median(samples.ms):.3f} ms of wall "
        f"(median) = {sum(split.values()) / statistics.median(samples.ms):.1%}"
        f" busy ({card})")
    params = SceneParams.from_scene(init)
    opt = train.make_optimizer(ds.FIT_LR)
    opt_state = opt(params.parameters())
    step = train.make_tiled_train_step(ds.FIT_SETTINGS, opt, config=cfg)
    split = profile_split(
        "phase12_fit_step", lambda: step(params, opt_state, cams[0],
                                         imgs[0]),
        res["fit_step_ms"], card, names=TRAIN_PROFILE_NAMES,
        op_ranges=TRAIN_OP_RANGES)
    log(f"phase 12a: one fit step {sum(split.values()):.3f} ms of device "
        f"time over {res['fit_step_ms']:.3f} ms (the median step) = "
        f"{sum(split.values()) / res['fit_step_ms']:.1%} busy: the backward "
        f"kernel {split['tile_composite_bwd']:.3f} ms, the packet gather's "
        f"backward {split['gather_bwd']:.3f} ms (its kernels; the zeros and "
        f"cumsum {split['gather_glue']:.3f} ms), the rest "
        f"{split['rest'] + split['tile_composite_fwd']:.3f} ms ({card})")
    return dict(launches, fwd_err=fwd_err, bwd_err=bwd["max_abs_err"])


def downstream_small(ds, capture, device) -> dict:
    """12b's loop on one device, recorded by recorded_capture."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    run = recorded_capture(capture, lambda out: ds.run_downstream(
        out, device=device, progress=None, **DS_SMALL), surface_scene(
            DS_SMALL["n_gt"], seed=13, device="cpu").means)
    return dict(run, num_points=run["res"]["config"]["fitted_gaussians"])


def downstream_card_vs_cpu(ds, capture, dev, card) -> None:
    """12b: the loop at DS_SMALL on the card and on the CPU: the captures
    held to 8b's gates (DS_MIN_SHARE of the path-traced values), the test
    poses' PSNR and SSIM within DS_PSNR_ATOL and DS_SSIM_ATOL."""
    card_run, cpu_run = (downstream_small(ds, capture, d)
                         for d in (dev, torch.device("cpu")))
    c = DS_SMALL
    compare_captures("12b", card_run, cpu_run, card,
                     f"the downstream loop's capture, surface_scene("
                     f"{c['n_gt']}), {c['poses']} poses {c['res']}x"
                     f"{c['res']}, {c['spp']} spp, depth 4, {c['n_pc_rays']} "
                     f"torus rays", min_share=DS_MIN_SHARE)
    a, b = card_run["res"], cpu_run["res"]
    d_psnr = max(abs(x - y) for x, y in zip(a["test_psnr"], b["test_psnr"]))
    d_ssim = max(abs(x - y) for x, y in zip(a["test_ssim"], b["test_ssim"]))
    log(f"phase 12b: the loop's fit ({c['fit_steps']} steps) card vs CPU: "
        f"train loss {a['train_loss_first']:.6f} -> "
        f"{a['train_loss_last']:.6f} / {b['train_loss_first']:.6f} -> "
        f"{b['train_loss_last']:.6f}; test PSNR "
        + ", ".join(f"{x:.4f} / {y:.4f}" for x, y in zip(a["test_psnr"],
                                                        b["test_psnr"]))
        + " dB, SSIM "
        + ", ".join(f"{x:.5f} / {y:.5f}" for x, y in zip(a["test_ssim"],
                                                        b["test_ssim"]))
        + f": within {d_psnr:.4f} dB (gate {DS_PSNR_ATOL}) and {d_ssim:.5f} "
        f"(gate {DS_SSIM_ATOL}) ({card})")
    check(d_psnr <= DS_PSNR_ATOL and d_ssim <= DS_SSIM_ATOL,
          f"12b: test PSNR {d_psnr} dB / SSIM {d_ssim} apart")


# ---- phase 13: K5, the render RNG ----------------------------------------

def sass_mix(lib, name: str) -> dict:
    """Kernel ``name``'s SASS in the built library ``lib``, counted by
    opcode (cuobjdump from nvcc's toolkit); empty where there is none."""
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = name in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def threefry_checks(rng, k5, key, card) -> list:
    """Phase 13: K5 against its plain version (core/rng.uniforms_plain,
    jitter_plain) on the card at the main path's shapes, bit for bit: one
    1080p depth-12 bounce (9 draws, 11 columns), one capture-pose bounce
    (640000 rays, 8 draws) and the 1080p jitter. Each timed by CUDA events
    over 20 launches of the wrapper with the keys folded once, and by the
    profiler's record of the kernel, beside the plain version and the
    bound (elements x K5_OPS at INT32_OPS_PER_S, or their 4-byte stores at
    HBM_BYTES_PER_S)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        bounce_dims,
    )

    dev = torch.device("cuda", 0)
    bkey = rng.fold_in(rng.frame_key(key, 0), 1)
    cases = []
    # 10c's bounce 5 draws every dimension, roulette's too; 6e's bounce 1
    # all but roulette.
    for name, r, dims, n_draws in (
            ("1080p depth-12 bounce", 1920 * 1080,
             bounce_dims(RenderSettings(max_depth=12), 5), 9),
            ("capture-pose bounce", 800 * 800,
             bounce_dims(RenderSettings(max_depth=4), 1), 8)):
        check(len(dims) == n_draws, f"13 {name}: draws {dims}")
        draws = [(rng.dim_key(bkey, d), n) for d, n in dims.values()]
        words = [tuple(int(v) for v in k.tolist()) for k, _ in draws]
        nums = [n for _, n in draws]
        cases.append(dict(
            name=name, r=r, draws=len(draws), cols=sum(nums), ops=K5_OPS,
            path=lambda r=r, dims=dims: list(rng.bounce_uniforms(
                bkey, r, dims, dev).values()),
            raw=lambda r=r, words=words, nums=nums: k5.threefry_uniforms(
                words, nums, r, dev),
            plain=lambda r=r, draws=draws: rng.uniforms_plain(draws, r,
                                                              dev)))
    jkey, r2 = rng.dim_key(rng.frame_key(key, 5), 0), rng.r2_host(5)
    jwords = [tuple(int(v) for v in jkey.tolist())]
    cases.append(dict(
        name="1080p jitter", r=1920 * 1080, draws=1, cols=2,
        ops=K5_OPS + K5_JITTER_OPS,
        path=lambda: [rng.subpixel_jitter(key, 1080, 1920, 5, device=dev)],
        raw=lambda: k5.threefry_uniforms(jwords, [2], 1920 * 1080, dev, r2),
        plain=lambda: [rng.jitter_plain(jkey, 1080, 1920, r2, dev)]))
    out = []
    for c in cases:
        before = launch.launches["threefry"]
        got = c["path"]()
        launched = launch.launches["threefry"] - before
        want = c["plain"]()
        raw = c["raw"]()
        torch.cuda.synchronize()
        check(launched == 1, f"13 {c['name']}: {launched} K5 launches")
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.is_contiguous()
                  and torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"13 {c['name']}: K5 differs from its plain version")
        flat = torch.cat([w.reshape(-1) for w in want])
        check(torch.equal(raw.view(torch.int32), flat.view(torch.int32)),
              f"13 {c['name']}: the packed buffer differs from the plain "
              f"draws")
        del got, want, raw, flat
        ms = cuda_ms(c["raw"], 20)
        path_ms = cuda_ms(c["path"], 20)
        plain_ms = cuda_ms(c["plain"], 3)
        # The first trace of a session may miss kernel records: the second
        # of two is kept, as in profile_once.
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    c["raw"]()
                torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "threefry_uniforms" in e.key]
        n_prof = sum(e.count for e in rows)
        prof_ms = sum(e.self_device_time_total for e in rows) / 1e3 \
            / max(n_prof, 1)
        elems = c["r"] * c["cols"]
        b, o = 4.0 * elems / HBM_BYTES_PER_S, c["ops"] * elems / INT32_OPS_PER_S
        bnd = dict(bound_ms=max(b, o) * 1e3,
                   bound_by="bytes" if b >= o else "operations",
                   bound_bytes=4.0 * elems, bound_flops=float(c["ops"] * elems))
        log(f"phase 13: K5 {c['name']}: R={c['r']}, {c['draws']} draws, "
            f"{c['cols']} columns, {elems} uniforms, bit-equal to the plain "
            f"version (one launch); kernel {ms:.4f} ms (CUDA events, 20 "
            f"launches of the wrapper; through the path's call "
            f"{path_ms:.4f} ms; the profiler's kernel record "
            f"{prof_ms:.4f} ms over {n_prof} launches), plain "
            f"{plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']} ({bnd['bound_flops']:.4e} INT32 operations, "
            f"{bnd['bound_bytes']:.4e} bytes) = {bnd['bound_ms'] / ms:.1%} "
            f"of the bound's rate ({card})")
        out.append(dict(name=c["name"], ms=ms, plain_ms=plain_ms,
                        profiled_ms=prof_ms, max_abs_err=0.0, bound=bnd))
    return out


# ---- phase 14: every K, Kc and tile size on a hand kernel ------------------

# 14a: the top-K kernel at these K on 5a's chunks, and at K = N on the same
# chunks of surface_scene(TOPK_N_SMALL); timed at every K on the primary and
# bounce chunks.
TOPK_KS = (1, 32, 64, 128, 160, 256, 512, 2048)
TOPK_N_SMALL = 3000
# 14b: the march kernels' wide instantiation at these Kc on 6b's chunks,
# with a memory budget for the tables (Kc = 256 builds ~11 GiB at 500k);
# ray for ray (grid_exact_check) on each chunk's first WIDE_EXACT_RAYS:
# the plain march without exit fractions took ~60 s on the whole bounce
# chunk at Kc = 256.
WIDE_KCS = (144, 256)
WIDE_BUDGET = 16e9
# A trace's cells of at most 32 and 64 slots take its one- and two-slot
# register walks (csrc/grid_march.cu, kWideWalk).
WIDE_REG_FILLS = (32, 64)
WIDE_EXACT_RAYS = 16384
# 14c: tile sizes beside 16: P = 64 (the one-block kernels), 144, 576 and
# 1024 (the cluster kernels, G = 1, 3, 4) and 2304 pixels a tile (the
# group-loop kernels).
TILE_SIZES = (8, 12, 24, 32, 48)
# 14e: the capture pose at the widest Kc, its first trace and shadow march
# held to the plain march on their first WIDE_POSE_RAYS rays.
WIDE_POSE_SPP, WIDE_POSE_RAYS = 2, 16384
# 14d: the fit at tile size 32 held to the CPU step by step. Three
# free-running Adam steps amplify gradient signs flipped below 1e-6 of a
# leaf's scale (Adam moves such a parameter by about lr either way): on the
# CPU alone, noise of 1e-7 of the largest packet gradient moved the third
# loss of 4c's fit by up to 1.3% at tile size 16 and 32, and the card's
# free-running third loss at tile size 32 differed by 2.8% while its step-0
# gradients matched as at 16. So each step's loss and gradients are taken
# on the card from the CPU's parameters, with 4c's tolerances.
FIT_STEPS_14 = 3


def topk_equal(got, want, name: str) -> None:
    """Every output of the top-K kernel bit-equal to its plain version's."""
    bad = [int((g != w).sum()) for g, w in zip(got, want)]
    check(bad == [0, 0, 0], f"{name}: dense_topk not bit-equal to its plain "
          f"version ({bad[0]} idx, {bad[1]} t, {bad[2]} alpha slots differ)")


def topk_ks(dt, dev, card) -> dict:
    """14a: the top-K kernel against dense_topk_plain, every output bit for
    bit, at each K of TOPK_KS on 5a's chunks: primary, bounce and thin-far
    rays, the primary rays ordered by tied sort depths, the bounce rays
    under a 50% active mask. Each K is held to the first K columns of the
    plain version at the largest (a stable sort's first K are its K
    smallest). Timed at each K on the primary and bounce chunks beside the
    plain version and both bounds; then K = N on the primary, bounce and
    thin-far chunks of surface_scene(TOPK_N_SMALL). The kernel's launches
    are printed for each chunk."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools import chunks as tch

    st = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene, light, cam = pt_world(50_000, 800, 800, dev)
    ch = tch.dense_chunks(dt, scene, light, cam, st, PT_CHUNK)
    table, n = ch["table"], scene.num_gaussians
    (_, po, pd), (_, bo, bd), _ = ch["topk"]
    tied = torch.round(scene.means[:, 2] * 4.0) / 4.0
    half = torch.from_numpy(np.random.default_rng(16).uniform(
        size=PT_CHUNK) < 0.5).to(dev)
    chunks = [(name, o, d, None, None) for name, o, d in ch["topk"]] + [
        ("primary rays, tied sort depths", po, pd, tied, None),
        ("bounce rays, half active", bo, bd, None, half)]
    timed = ("primary rays", "bounce rays")
    k_max = max(TOPK_KS)
    res = {}
    for name, o, d, sd, act in chunks:
        t0 = time.perf_counter()
        want = dt.dense_topk_plain(o, d, table.rows, k_max, st, sd, act)
        zero_launches("dense_topk")
        for k in TOPK_KS:
            got = dt.dense_topk(o, d, table, k, st, sd, act)
            torch.cuda.synchronize()
            topk_equal(got, tuple(x[:, :k] for x in want),
                       f"14a {name}, K={k}")
        kept = (want[2] > 0).sum(-1)
        log(f"phase 14a {name}: dense_topk at K = "
            f"{', '.join(map(str, TOPK_KS))} bit-equal to the plain version "
            f"(R={o.shape[0]}, N={n}; {launch.launches['dense_topk']} "
            f"launches: one a K, and K=2048's lists in global memory, a "
            f"chunk of rays a launch); contributions a ray: mean "
            f"{float(kept.float().mean()):.1f}"
            f", max {int(kept.max())}, {int((kept > 64).sum())} rays above "
            f"K=64; {time.perf_counter() - t0:.1f} s")
        if name not in timed:
            continue
        t0 = time.perf_counter()
        cnt = tch.cull_counts(dt, o, d, table, st, supers=True)
        cnt["contributing"] = contributing_pairs(dt, o, d, table.rows, st)
        log(f"phase 14a {name}: " + topk_counts_line(cnt) + f"; counted in "
            f"{time.perf_counter() - t0:.1f} s")
        # The plain version's time hardly depends on K (its sort over N
        # does not): taken once, at K = 256.
        _, plain_ms = host_ms(
            lambda: dt.dense_topk_plain(o, d, table.rows, 256, st))
        for k in TOPK_KS:
            ms = cuda_ms(lambda: dt.dense_topk(o, d, table, k, st), 3)
            bnd = dense_bound(dt, cnt, o.shape[0], n, k)
            res[(name, k)] = dict(bnd, ms=ms, plain_ms=plain_ms,
                                  max_abs_err=0.0)
            log(f"phase 14a {name}, K={k}: dense_topk {ms:.3f} ms (CUDA "
                f"events, 3 launches), plain {plain_ms:.1f} ms (host clock, "
                f"at K=256); bound by "
                f"code path {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
                f"({bnd['bound_flops']:.4e} flops, {bnd['bound_bytes']:.4e} "
                f"bytes) = {bnd['bound_ms'] / ms:.1%} of its rate; the "
                f"function's bound {bnd['function_bound_ms']:.4f} ms = "
                f"{bnd['function_bound_ms'] / ms:.1%} ({card})")
    del ch, table, scene, chunks, want
    # K = N: the lists in global memory, every contribution of a ray kept.
    small, light, cam = pt_world(TOPK_N_SMALL, 800, 800, dev)
    ch = tch.dense_chunks(dt, small, light, cam, st, PT_CHUNK)
    for name, ro, rd in ch["topk"]:
        before = launch.launches["dense_topk"]
        got = dt.dense_topk(ro, rd, ch["table"], TOPK_N_SMALL, st)
        launches = launch.launches["dense_topk"] - before
        want = dt.dense_topk_plain(ro, rd, ch["table"].rows, TOPK_N_SMALL, st)
        torch.cuda.synchronize()
        topk_equal(got, want, f"14a {name}, K=N={TOPK_N_SMALL}")
        ms = cuda_ms(lambda: dt.dense_topk(ro, rd, ch["table"], TOPK_N_SMALL,
                                           st), 3)
        log(f"phase 14a {name} of surface_scene({TOPK_N_SMALL}), K=N: "
            f"dense_topk bit-equal to the plain version; {ms:.3f} ms (CUDA "
            f"events, 3 calls, {launches} launches a call: the lists in "
            f"global memory, a chunk of rays a launch); most contributions a "
            f"ray {int((want[2] > 0).sum(-1).max())} ({card})")
    return res


def grid_wide_checks(gm, gt, capture, dev, card) -> dict:
    """14b: the march kernels' wide instantiation at each Kc of WIDE_KCS on
    surface_scene(500k)'s grid, each grid's fill (the slots its cells
    hold, which bound their work) printed: 6b's gates on its bounce and
    shadow chunks (the default schedule, and ray for ray on its rounds
    without exit fractions), timed beside the bound, and the outputs at
    each Kc bit-equal to the first Kc's, whose grid overflows no cell (the
    wider grids add only zero slots); then 14e, the capture pose
    at the largest Kc (WIDE_POSE_SPP samples, the main path of the wide
    instantiations) with 6e's gates on its first trace and shadow march
    and its frozen count."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools.chunks import (
        march_chunks,
    )

    scene = surface_scene(500_000, seed=13, device=dev)
    cam = Camera(c2w=look_at(PT_EYE, PT_TARGET, device=dev), fov_y_deg=60.0,
                 width=1920, height=1080)
    st = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    chunks = march_chunks(scene, cam, st, BinningConfig())[:2]
    res, first = {}, {}
    for kc in WIDE_KCS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accel = gt.build_grid_accel(scene, max_per_cell=kc,
                                    memory_budget_bytes=WIDE_BUDGET)
        torch.cuda.synchronize()
        fill = accel.fill
        log(f"phase 14b: build_grid_accel(surface_scene(500k), Kc={kc}) "
            f"{time.perf_counter() - t0:.2f} s, tables "
            f"{grid_bytes(accel) / 2 ** 30:.3f} GiB, stats "
            f"{json.dumps(accel.stats_dict)}; fill mean "
            f"{float(fill.float().mean()):.3f}, max {accel.max_fill}; of "
            f"the {fill.shape[0]} cells "
            + ", ".join(f"{float((fill <= n).float().mean()):.1%} at most "
                        f"{n}" for n in WIDE_REG_FILLS)
            + f" (a trace's register walks) ({card})")
        if kc == WIDE_KCS[0]:
            check(accel.stats_dict["overflow_cell_frac"] == 0.0,
                  f"14b: Kc={kc} overflows cells of surface_scene(500k)")
        for name, o, d, kw in chunks:
            feat = "t_end" not in kw
            out = gt.march(accel, o, d, st, GRID_MAX_STEPS,
                           with_features=feat, **kw)
            if kc == WIDE_KCS[0]:
                first[name] = out
            else:
                check(all(torch.equal(a, b) for a, b in
                          zip(out, first[name]) if a is not None),
                      f"14b {name}: Kc={kc} outputs differ from "
                      f"Kc={WIDE_KCS[0]}'s")
                log(f"phase 14b {name}: Kc={kc} trans, sums and frozen "
                    f"bit-equal to Kc={WIDE_KCS[0]}'s")
            t0 = time.perf_counter()
            r = grid_kernel_check(gt, accel, st, f"{name}, Kc={kc}", o, d,
                                  kw, card, phase="14b")
            grid_exact_check(gt, accel, st, name, o, d, kw, card,
                             phase="14b", rays=WIDE_EXACT_RAYS)
            bnd = grid_bound(gt, accel, r)
            res[(r["feat"], kc)] = dict(r, **bnd)
            log(f"phase 14b {name}, Kc={kc}: kernel {r['ms']:.3f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
                f"({bnd['bound_flops']:.4e} flops, {bnd['bound_bytes']:.4e} "
                f"bytes) = {bnd['bound_ms'] / r['ms']:.1%} of its rate; "
                f"checks {time.perf_counter() - t0:.1f} s ({card})")
        if kc == max(WIDE_KCS):
            pose = grid_pose(gm, gt, capture, scene, st, accel, card,
                             spp=WIDE_POSE_SPP, phase="14e", profile=False,
                             plain_rays=WIDE_POSE_RAYS)
        del accel
    return dict(marches=res, pose=pose)


def tile_size_checks(tc, gm, dt, scene, cam, key, card) -> dict:
    """14c: the tile kernels at each tile size of TILE_SIZES on the
    headline's packets (800x800, K=256, jittered): the forward against its
    plain version with phase 1's gates, and at transmittance_min=0 (no
    chunk skip that depends on how the pixels are grouped) bit-equal to
    the one-block kernel on the same pixels cut into its tiles
    (as_block_tiles); the backward with 4a's gates (bwd_check); both timed
    beside their bounds. Prints each size's kernel path (any_p_plan), a
    cluster's CTAs and cudaOccupancyMaxActiveClusters, and the launches by
    path, each of which must be the planned one's; at a group-loop size,
    also whether clusters of 16 CTAs (non-portable) would schedule."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        _tile_dirs, prepare_tiles,
    )

    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    full = dataclasses.replace(settings, transmittance_min=0.0)
    dev = scene.means.device
    res = {}
    for ts in TILE_SIZES:
        t0 = time.perf_counter()
        cfg = BinningConfig(max_per_tile=256, tile_size=ts)
        prepared = prepare_tiles(scene, cam, settings, cfg)
        packets = {k: prepared[k] for k in ("geom", "featsT", "count")}
        dirs, _ = _tile_dirs(cam, cfg, rng.subpixel_jitter(
            key, cam.height, cam.width, 0, device=dev))
        p = dirs.shape[1]
        path, n_ctas, threads = tc.any_p_plan(p)
        plan = f"{path} kernels"
        if path == "cluster":
            occ = {kern: tc.cluster_occupancy(kern, p, 256, dev)
                   for kern in ("fwd", "bwd", "bwd_dirs")}
            plan += (f", clusters of G={n_ctas} CTAs of {threads} threads; "
                     f"cudaOccupancyMaxActiveClusters (CTA dynamic shared "
                     f"memory B): " + ", ".join(
                         f"{kern} {n} ({smem})"
                         for kern, (n, smem) in occ.items()))
        elif path == "group_loop":
            occ = {kern: tc.cluster_occupancy(kern, 2048, 256, dev, g=16)
                   for kern in ("fwd", "bwd", "bwd_dirs")}
            plan += (", one block of 256 threads a tile; clusters of 16 "
                     "CTAs (non-portable, the limit that would take 4096 "
                     "pixels) would schedule as: " + ", ".join(
                         f"{kern} {n} ({smem} B)"
                         for kern, (n, smem) in occ.items()))
        log(f"phase 14c tile size {ts} (T={dirs.shape[0]}, P={p}): {plan}")
        before = read_counts()
        got = tc.tile_composite(packets, dirs, settings)
        want = tc.tile_composite_plain(packets, dirs, settings)
        torch.cuda.synchronize()
        err = max(compare(got[0], want[0], f"14c tile {ts} out"),
                  compare(got[1], want[1], f"14c tile {ts} alpha_acc"),
                  compare(got[2], want[2], f"14c tile {ts} depth",
                          mask=want[1] > 1e-3))
        got = tc.tile_composite(packets, dirs, full)
        bpk, bdirs, p = tc.as_block_tiles(packets, dirs)
        ref = tc.tile_composite(bpk, bdirs, full)
        torch.cuda.synchronize()
        bits = [bool(torch.equal(g, r.reshape(g.shape[0], -1,
                                              *r.shape[2:])[:, :p]))
                for g, r in zip(got, ref)]
        check(all(bits), f"14c tile {ts}: the forward at transmittance_min=0 "
              f"not bit-equal to the one-block kernel on the same pixels "
              f"(out, alpha_acc, depth: {bits})")
        ms = cuda_ms(lambda: tc.tile_composite(packets, dirs, settings), 20)
        plain_ms = cuda_ms(
            lambda: tc.tile_composite_plain(packets, dirs, settings), 3)
        bnds = tile_bounds(packets, dirs, settings)
        log(f"phase 14c tile size {ts} (T={dirs.shape[0]}, P={p}, K=256; "
            f"the {path} kernels): forward vs plain max abs err {err:.3e} "
            f"(rtol {RTOL}, atol {ATOL}); at transmittance_min=0 bit-equal "
            f"to the one-block kernel on the same pixels; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms (CUDA events; {card}); "
            f"{bnds['pairs']} pixel-slot pairs, {bnds['live_pairs']} with "
            f"alpha > 0; {bound_text(bnds['fwd'], ms)}")
        bwd = bwd_check(tc, packets, dirs, settings, f"tile size {ts}", card,
                        phase="14c")
        after = read_counts()
        launched = {name: after[name] - before[name] for name in after
                    if after[name] != before[name]}
        planned = dict(one_block=("fwd", "bwd"),
                       cluster=("fwd_any", "bwd_any"),
                       group_loop=("fwd_group", "bwd_group"))[path]
        # The forward's one-block launches also serve as_block_tiles.
        others = {"bwd", "fwd_any", "bwd_any", "fwd_group",
                  "bwd_group"} - set(planned)
        check(all(launched.get(name, 0) > 0 for name in planned)
              and not any(launched.get(name, 0) for name in others),
              f"14c tile size {ts}: the {path} kernels were planned, the "
              f"launches were {launched}")
        res[ts] = dict(fwd=dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                bound=bnds["fwd"]), bwd=bwd, path=path,
                       launches=launched)
        log(f"phase 14c tile size {ts}: launches {json.dumps(launched)}; "
            f"{time.perf_counter() - t0:.1f} s")
    return res


def tile32_paths(tc, gm, dt, scene, cam, small, small_cam, key, dev,
                 card) -> dict:
    """14d: the tile path at tile size 32 (P = 1024, the cluster kernels) end
    to end: a headline frame (prepare_tiles and one jittered
    render_prepared of the 1M cloud at 800x800, K=256; phase 2's gates);
    at phase 1's small size the slice (2 samples) and three fit steps, the
    card against the CPU (phase 1's gates; 4c's tolerances at each step,
    stepwise_train_check). Returns the launches of this path by kernel."""
    from pathtracer_gaussiansplatting_tpu_torch.core import rng
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        prepare_tiles, render_prepared,
    )

    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    cfg = BinningConfig(max_per_tile=256, tile_size=32)
    reset_counts()
    packets, prep_ms = host_ms(lambda: prepare_tiles(scene, cam, settings,
                                                     cfg))
    out, ms = host_ms(lambda: render_prepared(
        packets, cam, settings, cfg, outputs=("color",),
        jitter=rng.subpixel_jitter(key, cam.height, cam.width, 0,
                                   device=dev)))
    frame = read_counts()
    img = out["color"].cpu().numpy()
    check(frame["fwd_any"] == 1 and frame["fwd"] == 0,
          f"14d: the headline frame at tile size 32 launched {frame}")
    check(img.shape == (cam.height, cam.width, 3)
          and bool(np.isfinite(img).all()) and 0.0 < float(img.mean()) < 2.0,
          f"14d: the headline frame at tile size 32: shape {img.shape}, "
          f"mean {img.mean()}")
    small_cfg = BinningConfig(max_per_tile=512, tile_size=32)
    reset_counts()
    slice_err = small_slice_check(small, small_cam, small_cfg, settings, key,
                                  dev)
    fit = stepwise_train_check(small, small_cam, small_cfg, settings, dev)
    small_counts = read_counts()
    check(small_counts["fwd_any"] > 0 and small_counts["bwd_any"] > 0
          and small_counts["fwd"] == 0,
          f"14d: the small slice and fit at tile size 32 launched "
          f"{small_counts}")
    log(f"phase 14d: tile size 32: the headline frame (1M Gaussians, "
        f"800x800, K=256, T={packets['count'].shape[0]}) prepare "
        f"{prep_ms:.1f} ms, one sample {ms:.2f} ms (host clock, first "
        f"call), image mean {img.mean():.5f}, finite; the small slice "
        f"(2000 Gaussians, 96x64, K=512, 2 spp) card vs CPU max abs err "
        f"{slice_err:.3e}; the small fit card vs CPU, step by step from the "
        f"same parameters ({FIT_STEPS_14} steps): gradients max err "
        f"{fit['grad']:.3e} of the leaf's max |g|, losses max rel err "
        f"{fit['loss']:.3e}; cluster kernel launches: forward "
        f"{frame['fwd_any'] + small_counts['fwd_any']}, backward "
        f"{small_counts['bwd_any']} ({card})")
    return dict(fwd_any=frame["fwd_any"] + small_counts["fwd_any"],
                bwd_any=small_counts["bwd_any"])


def stepwise_train_check(scene, cam_kw, cfg, settings, dev,
                         steps: int = FIT_STEPS_14) -> dict:
    """FIT_STEPS_14 steps of 4c's fit (the small scene from the same noised
    start, two poses in turn, Adam at lr 2e-2, transmittance_min=0) on the
    CPU, and before each the card's make_tiled_train_step from the CPU's
    parameters of that step: each step's loss within rtol 1e-3 and each
    leaf's gradient within 1e-3 of the CPU's largest |g| (plus rtol 2e-3),
    4c's tolerances (see FIT_STEPS_14)."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        SCENE_FIELDS,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
    from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
        render_tiled_fused,
    )

    settings = dataclasses.replace(settings, transmittance_min=0.0)
    cpu = torch.device("cpu")
    cams = {d: [Camera(**{**cam_kw, "c2w": look_at(eye, (0.0, 0.0, 0.0),
                                                   device=d)})
                for eye in ((0.0, 0.5, 4.0), (2.5, 0.5, 2.5))]
            for d in (dev, cpu)}
    with torch.no_grad():
        targets = [render_tiled_fused(scene, c, settings, cfg)["color"]
                   for c in cams[cpu]]
    params = SceneParams.from_scene(noised_start(scene, 0.15, seed=6))
    opt = train.make_optimizer(2e-2)
    opt_state = opt(params.parameters())
    step = train.make_tiled_train_step(settings, opt, config=cfg)
    grad_err = loss_err = 0.0
    for i in range(steps):
        p = i % 2
        card = SceneParams.from_scene(params.scene().to(dev))
        _, _, card_loss = step(card, opt(card.parameters()), cams[dev][p],
                               targets[p].to(dev))
        card_grads = {f: getattr(card.grad_scene(), f).cpu()
                      for f in SCENE_FIELDS}
        params, opt_state, loss = step(params, opt_state, cams[cpu][p],
                                       targets[p])
        grads = params.grad_scene()
        loss_err = max(loss_err, compare(
            card_loss.cpu()[None], loss[None], f"14d fit step {i} loss",
            rtol=1e-3, atol=0.0) / float(loss))
        for f in SCENE_FIELDS:
            want = getattr(grads, f)
            scale = float(want.abs().max())
            if scale > 0:
                grad_err = max(grad_err, compare(
                    card_grads[f], want, f"14d fit step {i} grad {f}",
                    rtol=2e-3, atol=1e-3 * scale) / scale)
            else:
                check(bool((card_grads[f] == 0).all()), f"14d fit step {i} "
                      f"grad {f}: nonzero on the card, 0 on the CPU")
    return dict(grad=grad_err, loss=loss_err)


def cli_dense_k256(cli, dt, dev, card) -> int:
    """14f: ``cli render --backend dense --max-contribs 256`` on 5b's scene
    (surface_scene(2000, seed 13) as a 3DGS checkpoint, a sun, phase 8's
    torus; 96x64, 2 spp, depth 1) with --device cuda and --device cpu: the
    float images handed to save_png held to 5b's depth-1 gates at phase
    5's ambient, and to AMBIENT_MIN_SHARE / AMBIENT_MEAN_FRAC at
    AMBIENT_BRIGHT. Returns the top-K kernel's launches on the card's
    runs."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import save_3dgs_ply
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )

    card_launches = 0
    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_k256_") as root:
        save_3dgs_ply(os.path.join(root, "room.ply"),
                      surface_scene(2000, seed=13, device="cpu"))
        # The checkpoint drops the panel's emission, and the room's walls
        # shade the sun: 5b's gates hold the port at phase 5's ambient;
        # under a bright one the thin surfels' alpha rounding reaches the
        # pixels through the ambient term, in the JAX package as in the
        # port, and the gates measured there hold it.
        for ambient, min_share, mean_frac in (
                ((0.05, 0.05, 0.06, 1.0), PT_MIN_SHARE, PT_MEAN_FRAC),
                ((AMBIENT_BRIGHT,) * 3 + (1.0,), AMBIENT_MIN_SHARE,
                 AMBIENT_MEAN_FRAC)):
            cfg = os.path.join(root, f"scene_{ambient[0]}.json")
            with open(cfg, "w") as fh:
                json.dump({"settings": {
                    "ambient_light": list(ambient),
                    "torus_settings": dict(CAPTURE_TORUS, num_rays=4096),
                    "sun": {"color": [1.0, 0.95, 0.9],
                            "direction": [0.3, -1.0, 0.2],
                            "intensity": 1.5},
                    "width": 96, "height": 64, "fov": 60, "max_depth": 1},
                    "objects": [{"model": "room.ply"}]}, fh)
            imgs, launches = [], {}
            for device in (dev, torch.device("cpu")):
                zero_launches("dense_topk")
                with HostTimer(cli, "save_png", keep=True) as png:
                    run_cli(cli, ["render", "--scene", cfg, "--output",
                                  os.path.join(root, f"{device.type}.png"),
                                  "--backend", "dense", "--max-contribs",
                                  "256", "--spp", "2", "--device",
                                  device.type])
                launches[device.type] = launch.launches["dense_topk"]
                imgs.append(torch.from_numpy(np.asarray(png.calls[0][0][1],
                                                        np.float32)))
            check(launches["cuda"] > 0 and launches["cpu"] == 0,
                  f"14f: dense_topk launches by device {launches}")
            log(f"phase 14f at ambient {ambient[0]}: dense_topk launched "
                f"{launches['cuda']} times on the card's render")
            card_launches += launches["cuda"]
            pt_gates("14f", f"cli render --backend dense --max-contribs 256 "
                     f"at ambient {ambient[0]}", imgs[0], imgs[1], min_share,
                     RenderSettings(max_depth=1),
                     "5b's scene as a 3DGS checkpoint with a sun, 96x64, 2 "
                     "spp", mean_frac)
    return card_launches


def phase14(cli, tc, gm, gt, dt, capture, small, small_cam, key, dev,
            card) -> dict:
    """Phase 14: the sizes above the old caps; returns the figures for the
    kernel table."""
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        random_cloud,
    )

    t14 = time.perf_counter()
    marks = [("start", t14)]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    topk = topk_ks(dt, dev, card)
    mark("14a")
    grid = grid_wide_checks(gm, gt, capture, dev, card)
    mark("14b, 14e")
    scene = random_cloud(1_000_000, seed=13, spread=1.5, device=dev)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=800, height=800)
    tiles = tile_size_checks(tc, gm, dt, scene, cam, key, card)
    mark("14c")
    paths = tile32_paths(tc, gm, dt, scene, cam, small, small_cam, key, dev,
                         card)
    mark("14d")
    del scene
    cli_launches = cli_dense_k256(cli, dt, dev, card)
    mark("14f")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s ("
        + ", ".join(f"{n} {t - marks[i][1]:.1f} s"
                    for i, (n, t) in enumerate(marks[1:])) + ")")
    return dict(topk=topk, grid=grid, tiles=tiles, paths=paths,
                cli_launches=cli_launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    # Everything printed goes to the log file too, so the whole run is
    # kept where a caller keeps only the end of the output.
    os.makedirs(OUT_DIR, exist_ok=True)
    log_file = open(os.path.join(OUT_DIR, "log.txt"), "w")
    sys.stdout = Tee(sys.stdout, log_file)
    sys.stderr = Tee(sys.stderr, log_file)
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
        threefry as k5,
    )
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        tile_composite as tc,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams, random_cloud, surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
        BinningConfig,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel import train
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
    ptxas = ptxas_report(build.build_log())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as fh:
        fh.write("\n".join(ptxas) + "\n")
    for line in ptxas:
        log("  ptxas: " + line)

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
    bnds = tile_bounds(packets, dirs_t, settings)
    fwd_bound = bnds["fwd"]
    log(f"phase 1: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(CUDA events; {card}); {bnds['pairs']} pixel-slot pairs, "
        f"{bnds['live_pairs']} with alpha > 0; "
        f"{bound_text(fwd_bound, kernel_ms)}")

    # The slice end to end at a small size: card (kernel) vs CPU (plain).
    # Splats large against the camera distance keep q = c - b^2/a well
    # conditioned, so no pair sits within rounding of an alpha cutoff
    # (CPU and CUDA round exp differently).
    small = random_cloud(2000, seed=7, spread=1.2, scale_range=(-1.8, -0.8),
                         device="cpu")
    small_cam = dict(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                                 device="cpu"),
                     fov_y_deg=50.0, width=96, height=64)
    small_cfg = BinningConfig(max_per_tile=512)
    small_err = small_slice_check(small, small_cam, small_cfg, settings, key,
                                  dev)
    log(f"phase 1: small slice (2000 Gaussians, 96x64, K=512, 2 spp) card "
        f"vs CPU max abs err {small_err:.3e}")

    # ---- phase 2: the headline slice ---------------------------------
    del packets, got, want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches("tile_fwd", "threefry")
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
    launches_p2, rng_p2 = launch_counts("tile_fwd", "threefry")
    check(launches_p2 == n_samples,
          f"phase 2 launched the kernel {launches_p2} times, not {n_samples}")
    check(rng_p2 == n_samples, f"phase 2 launched threefry_uniforms {rng_p2} "
          f"times, not once a jittered sample")
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
        f"{med:.2f} ms; tile_fwd {launches_p2}, threefry_uniforms {rng_p2}; "
        f"({card})")
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

    # ---- phase 3: the primary stage at the path-trace bench's size ----
    pt_scene, pt_cam, pt_settings, pt_cfg, pt_packets, pt_dirs = \
        surface_1080p(dev, key)
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
    pt_bnds = tile_bounds(pt_packets, pt_dirs, pt_settings)
    log(f"phase 3: kernel vs plain at T={pt_dirs.shape[0]}, K=512: max abs "
        f"err {pt_err:.3e}; kernel {pt_kernel_ms:.3f} ms, plain "
        f"{pt_plain_ms:.3f} ms (CUDA events; {card}); {pt_bnds['pairs']} "
        f"pixel-slot pairs, {pt_bnds['live_pairs']} with alpha > 0; "
        f"{bound_text(pt_bnds['fwd'], pt_kernel_ms)}")
    del got, want

    zero_launches("tile_fwd", "threefry")
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
    launches_p3, rng_p3 = launch_counts("tile_fwd", "threefry")
    check(launches_p3 == 4,
          f"phase 3 launched the kernel {launches_p3} times, not 4")
    check(rng_p3 == 4, f"phase 3 launched threefry_uniforms {rng_p3} times, "
          f"not once a jittered sample")
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
        f" ms (median {statistics.median(pt_ms[1:]):.2f}); tile_fwd "
        f"{launches_p3}, threefry_uniforms {rng_p3}; ({card})")
    log(f"phase 3: binning stats {json.dumps(pt_stats)}; mean tile count "
        f"{float(pt_packets['count'].mean()):.1f} of 512")
    log(f"phase 3: image finite, mean {pt_img.mean():.5f}; saved "
        f"{os.path.relpath(jpg, ROOT)}")
    profile_once("phase3_sample", lambda: accumulate(
        pt_acc, render_prepared(
            pt_packets, pt_cam, pt_settings, pt_cfg, outputs=("color",),
            jitter=rng.subpixel_jitter(key, 1080, 1920, 99, device=dev)
        )["color"], 99), statistics.median(pt_ms[1:]), card)

    # ---- phase 4: training -------------------------------------------
    # (a) the backward kernel against its plain version at both sizes.
    bwd = bwd_check(tc, packets, dirs_t, settings, "headline", card)
    bwd_pt = bwd_check(tc, pt_packets, pt_dirs, pt_settings, "1080p", card)
    gather = gather_bwd_check(tc, scene, cam, settings, cfg, packets, dirs_t,
                              card)
    del packets, pt_packets, pt_dirs, pt_scene

    # (b) training at full width: 1M Gaussians, 800x800, K=256, two poses.
    train_steps = 8
    cams = [cam, Camera(c2w=look_at((2.5, 0.5, 2.5), (0.0, 0.0, 0.0),
                                    device=dev),
                        fov_y_deg=50.0, width=res, height=res)]
    # fit_scene_tiled as the reference's fit test runs it (every leaf,
    # sh_coeffs + 0.15 noise, lr 2e-2): the main path and its timing.
    tr = fit_run(tc, scene, cams, settings, cfg, train_steps, 2e-2, 0.15)
    pose0_ms = log_fit("phase 4b", tr, res, card)
    check_fit_ran(tr)
    launches_p4 = tr["counts"][-1]
    params = SceneParams.from_scene(tr["start"])
    opt = train.make_optimizer(2e-2)
    opt_state = opt(params.parameters())
    step = train.make_tiled_train_step(settings, opt, config=cfg)
    # The step's device split: the backward kernel, the packet gather's
    # backward (its kernels, and its zeros and cumsum) and the rest.
    profile_split("phase4_train_step", lambda: step(
        params, opt_state, cams[0], tr["targets"][0]), pose0_ms, card,
        names=TRAIN_PROFILE_NAMES, op_ranges=TRAIN_OP_RANGES)
    del params, opt_state, tr
    # On this cloud a step of Adam on every leaf raises the loss: it moves
    # each mean by ~lr, which reorders the depth-sorted composite. The
    # colors alone, with the geometry held, must learn at full width.
    sh = sh_run(scene, cams, settings, cfg, train_steps, 2e-2, 1.0)
    log(f"phase 4b: make_tiled_train_step, Adam on sh_coeffs alone, sh "
        f"noise 1.0, lr 2e-2, {train_steps} steps: losses "
        f"{', '.join(f'{x:.6f}' for x in sh['losses'])}; PSNR pose 0 "
        f"{sh['psnr0']:.3f} -> {sh['psnr1']:.3f} dB ({card})")
    check_learned(sh["losses"], sh["psnr0"], sh["psnr1"], 2,
                  "full-width color fit")
    del scene

    # (c) the step on the card against the CPU at phase 1's small size,
    # with no chunk skip (transmittance_min=0).
    small_fit = small_train_check(small, small_cam, small_cfg, settings, dev)
    log(f"phase 4c: small fit (2000 Gaussians, 96x64, K=512) card vs CPU: "
        f"step-0 gradients max err {small_fit['grad']:.3e} of the leaf's "
        f"max |g|, 3 losses max rel err {small_fit['loss']:.3e}")

    # ---- phase 5: path tracing on the dense backend ------------------
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        dense_trace as dt,
    )

    pt_settings = RenderSettings(max_depth=4, ambient=(0.05, 0.05, 0.06, 1.0))
    scene5, light5, cam5 = pt_world(50_000, 800, 800, dev)
    dense = dense_kernel_checks(dt, scene5, light5, cam5, pt_settings, card)
    flat = flat_route(dt, scene5, light5, cam5, pt_settings, card, spp=8)
    comp = composite_checks(dt, dev, card)
    tiled = tiled_route(tc, dt, scene5, light5, cam5, pt_settings, card,
                        spp=4)
    del scene5
    small_pt_check(dev, dataclasses.replace(pt_settings, rr_start_depth=2,
                                            opaque_depth=3))
    shadow = dense_grad_check(dev, card)

    # ---- phase 6: the grid backend at 500k Gaussians ------------------
    from pathtracer_gaussiansplatting_tpu_torch.csrc import grid_bin
    from pathtracer_gaussiansplatting_tpu_torch.data import capture
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        grid_march as gm,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as gt
    from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref
    from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
        make_trace_backend,
    )
    from pathtracer_gaussiansplatting_tpu_torch.tools.chunks import (
        march_chunks,
    )
    from pathtracer_gaussiansplatting_tpu_torch.utils import metrics

    # Built without a device argument: the port's entry points default to
    # the card.
    g_scene = surface_scene(500_000, seed=13)
    g_cam = Camera(c2w=look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5)),
                   fov_y_deg=60.0, width=1920, height=1080)
    check(g_scene.means.device.type == "cuda"
          and g_cam.c2w.device.type == "cuda",
          f"6: scene on {g_scene.means.device}, camera on {g_cam.c2w.device}")
    g_cfg = BinningConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accel = gt.build_grid_accel(g_scene, max_per_cell=32,
                                memory_budget_bytes=2.5e9)
    torch.cuda.synchronize()
    grid_stats_check(gt, grid_bin, accel, time.perf_counter() - t0, card)
    chunks = march_chunks(g_scene, g_cam, pt_settings, g_cfg)
    g_res = [grid_kernel_check(gt, accel, pt_settings, name, o, d, kw, card)
             for name, o, d, kw in chunks]
    trace_b = grid_bound(gt, accel, g_res[0])
    vis_b = grid_bound(gt, accel, g_res[1])
    for name, o, d, kw in chunks[:2]:
        grid_exact_check(gt, accel, pt_settings, name, o, d, kw, card)
    # A lane's share of a cell changes with Kc: the ray-for-ray check again
    # at Kc=64 (two slots a lane of a trace, four of a shadow segment) on a
    # smaller scene's grid.
    s50 = surface_scene(50_000, seed=13)
    accel64 = gt.build_grid_accel(s50, max_per_cell=64)
    for name, o, d, kw in march_chunks(s50, g_cam, pt_settings,
                                       g_cfg)[:2]:
        grid_exact_check(gt, accel64, pt_settings,
                         f"{name}, surface_scene(50k)", o, d, kw, card)
    del s50, accel64
    acc_rays, acc_dense = grid_accuracy(gt, ref, metrics, g_scene, accel,
                                        pt_settings, card)
    grid_accuracy_kc64(gt, metrics, g_scene, pt_settings, acc_rays,
                       acc_dense, chunks, g_res, accel, card)
    del chunks, acc_rays, acc_dense
    backend = make_trace_backend(g_scene, pt_settings, "grid", accel=accel)
    g_pt = grid_pathtrace(gm, g_scene, g_cam, pt_settings, g_cfg, backend,
                          key, card)
    g_pose = grid_pose(gm, gt, capture, g_scene, pt_settings, accel, card,
                       spp=8)
    del g_scene, accel, backend
    small_pt_check(dev, dataclasses.replace(pt_settings, rr_start_depth=2,
                                            opaque_depth=3),
                   backend="grid", phase="6f")

    # ---- phase 7: the ablation harness -------------------------------
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        tile_composite_variants as tv,
    )

    abl = ablation(tc, tv, dev, key, card)

    # ---- phase 8: the dataset capture --------------------------------
    cap = capture_run(capture, gm, gt, tc, dt, card)
    capture_resume(capture, gm, cap["scene"], cap["settings"], card)
    del cap["scene"]
    capture_card_vs_cpu(capture, dev, card)
    cap_launches = cap["launches"]

    # ---- phase 9: the command line and its scene loaders --------------
    from pathtracer_gaussiansplatting_tpu_torch import cli

    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix=".chip_smoke_cli_") as root9:
        cfg9 = cli_world(root9, 500_000, card)
        cli9 = cli_capture(cli, capture, gm, gt, tc, dt, ref, cfg9,
                           os.path.join(root9, "dataset"), 500_000,
                           card)["launches"]
        cli_subprocess(cfg9, root9, card)
        cli_card_vs_cpu(cli, capture, root9, dev, card)
        cmd9 = cli_commands(cli, gm, gt, tc, dt, cfg9, root9, card)
    p9 = {k: cli9[k] + cmd9[k] for k in cli9}

    # ---- phase 10: the bench ------------------------------------------
    t10 = time.perf_counter()
    p10 = bench_run(cli, tc, gm, dt, card)["launches"]
    pt12_card_vs_cpu(dev, card)
    pt12_profile(gm, card)
    base10 = dense_baseline_split(dt, card)
    headline_split(tc, card)
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # ---- phase 11: the mesh and the spatial slab ring -----------------
    p11 = phase11(tc, dt, gm, gt, pt_settings, tiled["median_ms"], dev, card)

    # ---- phase 12: the downstream loop ---------------------------------
    from pathtracer_gaussiansplatting_tpu_torch.tools import (
        downstream_loop as ds,
    )

    t12 = time.perf_counter()
    p12 = downstream_run(ds, capture, train, tc, gm, gt, dt, dev, card)
    downstream_card_vs_cpu(ds, capture, dev, card)
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # ---- phase 13: K5, the render RNG ----------------------------------
    # Every phase from 2 to 12 drew its uniforms and jitter through K5.
    rng_by_phase = {
        "2": rng_p2, "3": rng_p3, "5c": flat["rng"], "5d": tiled["rng"],
        "6d": g_pt["rng"], "6e": g_pose["rng"], "8a": cap_launches["rng"],
        "9": p9["rng"], "10a": p10["rng"], "11b": p11["rng"],
        "12a": p12["rng"]}
    log(f"phase 13: threefry_uniforms launches on the main path by phase "
        f"{json.dumps(rng_by_phase)} ({card})")
    check(all(n > 0 for n in rng_by_phase.values()),
          f"threefry_uniforms was not launched in every phase: "
          f"{rng_by_phase}")
    k5_res = threefry_checks(rng, k5, key, card)
    mix = sass_mix(lib, "threefry_uniforms_kernel")
    log(f"phase 13: K5's SASS (cuobjdump; {K5_PER_THREAD} uniforms a "
        f"thread, unrolled): {sum(mix.values())} instructions; by opcode "
        f"{json.dumps(mix)}")

    # ---- phase 14: every K, Kc and tile size on a hand kernel ----------
    p14 = phase14(cli, tc, gm, gt, dt, capture, small, small_cam, key, dev,
                  card)

    check("jax" not in sys.modules, "jax was imported")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, res, bnd, **extra):
        fn = "" if "function_bound_ms" not in bnd else (
            f"; the function's bound {bnd['function_bound_ms']:.4f} ms = "
            f"{bnd['function_bound_ms'] / res['ms']:.1%}")
        all_pairs = "" if "all_pairs_bound_ms" not in bnd else (
            f"; all-pairs bound (every pair charged the exact path) "
            f"{bnd['all_pairs_bound_ms']:.4f} ms")
        log(f"bound {name}: {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
            f"({bnd['bound_flops']:.4e} flops, {bnd['bound_bytes']:.4e} "
            f"bytes); kernel {res['ms']:.4f} ms = "
            f"{bnd['bound_ms'] / res['ms']:.1%} of the bound's rate"
            + fn + all_pairs)
        fn_key = {} if "function_bound_ms" not in bnd else dict(
            function_bound_ms=bnd["function_bound_ms"])
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=res["max_abs_err"], ms=res["ms"],
                    plain_ms=res["plain_ms"], bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"],
                    library_ms=extra.pop("library_ms", None), **fn_key,
                    **extra)

    marches = p14["grid"]["marches"]
    trace_w, vis_w = marches[(True, 256)], marches[(False, 256)]
    tile32 = p14["tiles"][32]
    group_loop = {k: sum(r["launches"].get(k, 0) for r in p14["tiles"].values())
                  for k in ("fwd_group", "bwd_group")}

    def wide_shapes(feat):
        return [dict(name=f"Kc={kc}", ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"])
                for (f, kc), r in marches.items() if f == feat]

    def tile_shapes(which):
        return [dict(name=f"tile size {ts} ({r['path']})", ms=r[which]["ms"],
                     plain_ms=r[which]["plain_ms"],
                     bound_ms=r[which]["bound"]["bound_ms"])
                for ts, r in p14["tiles"].items()
                if not tc.one_block(ts * ts)]

    topk = dict(dense["topk"], max_abs_err=max(
        dense["topk"]["max_abs_err"], tiled["max_abs_err"][0],
        p11["topk_rev"]["max_abs_err"]))

    def topk_shapes():
        keys = ("name", "ms", "plain_ms", "bound_ms", "function_bound_ms")
        return [{k: r[k] for k in keys if k in r} for r in (
            dense["topk_shapes"] + [tiled["topk_first"], p11["topk_rev"]]
            + [dict(r, name=f"14a {name}, K={k}")
               for (name, k), r in p14["topk"].items()]
            + [dict(base10, name=f"10d {base10['name']}, K={base10['k']}")])]
    vis = dict(dense["vis"], max_abs_err=max(
        dense["vis"]["max_abs_err"], tiled["max_abs_err"][1]))
    log(json.dumps({"kernels": [
        entry("tile_composite_fwd", KERNEL_SOURCE, KERNEL_REPLACES,
              launches_p2 + launches_p3 + launches_p4[0]
              + tiled["launches"][0] + cap_launches["fwd"] + p9["fwd"]
              + p10["fwd"] + p11["fwd"] + p12["fwd"],
              dict(max_abs_err=max(max_abs_err, p12["fwd_err"]),
                   ms=kernel_ms, plain_ms=plain_ms),
              fwd_bound),
        entry("tile_composite_bwd", BWD_KERNEL_SOURCE, BWD_KERNEL_REPLACES,
              launches_p4[1] + p10["bwd"] + p12["bwd"],
              dict(max_abs_err=max(bwd["max_abs_err"],
                                   bwd_pt["max_abs_err"], p12["bwd_err"]),
                   ms=bwd["ms"], plain_ms=bwd["plain_ms"]), bwd["bound"]),
        entry("packet_gather_bwd", GATHER_SOURCE, GATHER_REPLACES,
              launches_p4[2] + p10["gather_bwd"] + p12["gather_bwd"],
              gather, gather["bound"],
              library_ms=gather["library_ms"],
              library_call="index_put_ with accumulate (autograd's "
              "transpose of the gather)"),
        # Times and bounds at 5a's primary chunk at K = 64; the other
        # shapes beside them.
        entry("dense_topk", TOPK_SOURCE, TOPK_REPLACES,
              flat["launches"][0] + tiled["launches"][1] + p9["topk"]
              + p10["topk"] + p11["topk"] + p14["cli_launches"], topk, topk,
              shapes=topk_shapes()),
        # Times and bound at 5f's primary chunk; the other chunks beside.
        entry("dense_composite", COMPOSITE_SOURCE, COMPOSITE_REPLACES,
              flat["composite"], comp, comp["bound"], shapes=comp["shapes"],
              library_call="none: the gathers, SH, cumprod and einsums of "
              "the plain version are ~90 launches"),
        entry("dense_visibility", VIS_SOURCE, VIS_REPLACES,
              flat["launches"][1] + tiled["launches"][2] + p9["dense_vis"]
              + p11["dense_vis"], vis, vis),
        # The listing modes serve visibility_dense's gradient (5e), which
        # no rendering path asks for: their launches are 5e's.
        entry("dense_visibility_pairs", VIS_SOURCE, VIS_REPLACES,
              shadow["launches"], dict(dense["pairs"], max_abs_err=max(
                  dense["pairs"]["max_abs_err"], shadow["max_abs_err"])),
              dense["pairs"], launches_in="phase 5e: visibility_dense's "
              "gradient on the card (0 on the render paths)"),
        entry("grid_trace", GRID_SOURCE, GRID_TRACE_REPLACES,
              g_pt["launches"][0] + g_pose["launches"][0]
              + cap_launches["trace"] + p9["trace"] + p10["trace"]
              + p11["trace"] + p12["trace"],
              dict(g_res[0], max_abs_err=max(g_res[0]["max_abs_err"],
                                             g_res[2]["max_abs_err"])),
              trace_b),
        entry("grid_visibility", GRID_SOURCE, GRID_VIS_REPLACES,
              g_pt["launches"][1] + g_pose["launches"][1]
              + cap_launches["vis"] + p9["vis"] + p10["vis"] + p11["vis"]
              + p12["vis"],
              g_res[1],
              vis_b),
        entry("tile_composite_variants", VARIANT_SOURCE, VARIANT_REPLACES,
              abl["launches"], abl, abl, launches_in="phase 7: the "
              "harness's timing runs at both inputs (0 on the render, "
              "training and capture paths)"),
        # Times and bound at the 1080p depth-12 bounce; the other shapes
        # of phase 13 beside them.
        entry("threefry_uniforms", K5_SOURCE, K5_REPLACES,
              sum(rng_by_phase.values()), k5_res[0], k5_res[0]["bound"],
              shapes=[dict(name=r["name"], ms=r["ms"],
                           plain_ms=r["plain_ms"],
                           bound_ms=r["bound"]["bound_ms"])
                      for r in k5_res]),
        # Phase 14's new paths: times at 6b's chunks at Kc = 256, at the
        # headline at tile size 32; the other shapes beside them.
        entry("grid_trace_wide", GRID_SOURCE, GRID_TRACE_REPLACES,
              p14["grid"]["pose"]["launches"][0], trace_w, trace_w,
              shapes=wide_shapes(True)),
        entry("grid_visibility_wide", GRID_SOURCE, GRID_VIS_REPLACES,
              p14["grid"]["pose"]["launches"][1], vis_w, vis_w,
              shapes=wide_shapes(False)),
        # The cluster kernels (P up to 2048): times at tile size 32; the
        # group-loop kernels' launches (14c, above 2048 pixels) beside them.
        entry("tile_composite_fwd_any", KERNEL_SOURCE, KERNEL_REPLACES,
              p14["paths"]["fwd_any"], tile32["fwd"], tile32["fwd"]["bound"],
              shapes=tile_shapes("fwd"),
              group_loop_launches=group_loop["fwd_group"],
              group_loop_launches_in="phase 14c at tile size 48"),
        entry("tile_composite_bwd_any", BWD_KERNEL_SOURCE,
              BWD_KERNEL_REPLACES, p14["paths"]["bwd_any"], tile32["bwd"],
              tile32["bwd"]["bound"], shapes=tile_shapes("bwd"),
              group_loop_launches=group_loop["bwd_group"],
              group_loop_launches_in="phase 14c at tile size 48"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
