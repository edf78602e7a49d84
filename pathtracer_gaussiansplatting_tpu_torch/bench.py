"""Benchmark harness of the PyTorch port: the workloads of the root
``bench.py`` on the port's own modules, printed as one JSON line.

    python -m pathtracer_gaussiansplatting_tpu_torch.bench
    python -m pathtracer_gaussiansplatting_tpu_torch.cli bench [--device cpu]

Headline: amortized primary rays/s of the fused tile renderer at 1M
Gaussians, 800x800, K=256, over 512 samples a pose (one ``prepare_tiles``
a pose, then ``render_prepared`` a sample). Beside it: a training step
(forward and backward with a fresh binning), ``pathtrace_camera`` on the
500k-Gaussian surface scene at 1080p, depth 4 and depth 12 with
opaque_depth 4 on the grid backend, one capture pose through
``make_tiled_pose_renderer`` scaled to 512 spp, and the dense O(R·N)
renderer at 50k Gaussians scaled by N (``vs_baseline``), its list a ray
capped at the top-K kernel's 128 where the root bench keeps 256.

The sizes are :class:`BenchConfig`'s, read by ``main`` from the root
bench's ``GSPT_BENCH_*`` variables (N, RES, ITERS, K, SPP, PT_N, PT_W,
PT_H, PT_DEPTH, PT12_W, PT12_H, POSE_SPP). ``GSPT_BENCH_PT12_CHUNKS`` is
not read: the reference splits a depth-12 sample into ray chunks only to
stay under a TPU dispatch watchdog, and the port runs each sample as one
``pathtrace_camera`` call. A stage that fails raises: no key is left at
a failure marker.

Every timed section runs on the host clock between two ``fence``s, after
a warm-up. The roofline keys are the forward tile kernel's, in H100
terms, from this run's own packets: its function bound (the evaluation on
every pair the kernel evaluates, the composite step on those with alpha
> 0, ``tile_bytes``) over ``sample_ms``.

The bound's counts (``bound``, ``tile_pairs``, ``tile_bytes``,
``chunk_schedule``, ``live_share``, ``tile_bounds``) are shared with the
root ``chip_smoke.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from pathtracer_gaussiansplatting_tpu_torch.core import rng  # noqa: E402
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (  # noqa: E402
    Camera, generate_rays, look_at, toroidal_c2w,
)
from pathtracer_gaussiansplatting_tpu_torch.core.device import (  # noqa: E402
    resolve_device,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (  # noqa: E402
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.data.capture import (  # noqa: E402
    make_tiled_pose_renderer,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import (  # noqa: E402
    tile_composite as tc,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (  # noqa: E402
    random_cloud, surface_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (  # noqa: E402
    BinningConfig,
)
from pathtracer_gaussiansplatting_tpu_torch.render.grid_trace import (  # noqa: E402
    build_grid_accel,
)
from pathtracer_gaussiansplatting_tpu_torch.render.lights import (  # noqa: E402
    build_light_tables,
)
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (  # noqa: E402
    pathtrace_camera,
)
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (  # noqa: E402
    make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.render.reference import (  # noqa: E402
    render_radiance_dense,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (  # noqa: E402
    _tile_dirs, prepare_tiles, render_prepared, render_tiled_fused,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.profiling import (  # noqa: E402
    fence,
)

# The H100 SXM's published HBM rate and float32 (non-tensor) peak.
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12
# Float operations per unit of work, counted from the kernels' sources (a
# division, an exp, a floor, a min or max or a compare counts one; integer
# work is not counted): forward tile composite per (pixel, slot) pair
# (eval_geom 33, composite_step 33); backward ~230 (counted for its first
# design: three evaluations, the VJP chain, the per-slot sums; kept as the
# yardstick while the design changes).
FWD_PAIR_FLOPS, BWD_PAIR_FLOPS = 66, 230
# The tile kernels' bound by the function's own work, which no design can
# avoid (printed beside the yardsticks above, which bound_ms keeps): the
# evaluation (33) on every pair the kernels evaluate; the forward's
# composite step (33) only on the pairs with alpha > 0; the backward's
# work on those pairs: the forward step again for T and w (3), g_out .
# feats (28), d_w (2), the suffix sum (2), d_alpha (5), the alpha_max test
# (1), d_q (4), d_t (1), the two t clip tests (2), 1/a (1), d_t2 (4), d_a
# (6), d_b (4), and its share of the slot's 25 sums as FMAs (49). A pair
# clamped at alpha_max is charged the whole chain.
PAIR_EVAL_FLOPS, PAIR_COMPOSITE_FLOPS, BWD_LIVE_PAIR_FLOPS = 33, 33, 112

# The samples a pose renders in the reference's capture: pose_s is scaled
# to it. The pose's field of view (bench.py:279).
POSE_SPP_FULL, POSE_FOV = 512, 45.0
# The depth-12 workload (raygen_camera.rgen:47-64): glass-first paths
# alone run past opaque_depth.
PT12_DEPTH, PT12_OPAQUE_DEPTH = 12, 4
PT_AMBIENT = (0.05, 0.05, 0.06, 1.0)
# The dense baseline's list a ray: the root bench's min(K, 256)
# (bench.py:195).
DENSE_MAX_K = 256
# Timed calls: one warm-up before each timed section; the depth-12 samples
# and the capture poses timed (bench.py:250, 280). The other sections'
# counts follow BenchConfig.iters (BenchConfig.few, BenchConfig.pt_iters).
WARMUPS, PT12_ITERS, POSE_ITERS = 1, 2, 1
# The root bench.py's key with no meaning on the card, and the port's key
# in its place.
REPLACED_KEYS = dict(vpu_tslots_per_s="fwd_bound_share")


# ---- bounds: the least time the card could take for a kernel's work ----

def bound(n_bytes: float, flops: float) -> dict:
    """bound_ms = max(bytes / HBM rate, flops / float32 peak) and which of
    the two it is (the H100 SXM's published peaks)."""
    b, f = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(bound_ms=max(b, f) * 1e3,
                bound_by="bytes" if b >= f else "operations",
                bound_bytes=float(n_bytes), bound_flops=float(flops))


def chunk_schedule(packets, dirs, settings):
    """Which chunks the kernels skip on transmittance, from the plain
    forward's T at each chunk entry, with a 10% margin around
    transmittance_min: (tiles where every chunk under count surely ran,
    first chunk surely skipped per tile (n_chunks for none), kc). A tile
    whose T sits within the margin is in neither set."""
    count, geom, featsT = packets["count"], packets["geom"], packets["featsT"]
    k = geom.shape[-1]
    kc = tc.chunk_size(k)
    tmin = settings.transmittance_min
    no_skip = count > 0
    skip_from = torch.full_like(count, k // kc, dtype=torch.long)
    for ci in range(1, k // kc):
        s = ci * kc
        head = dict(geom=geom[..., :s].contiguous(),
                    featsT=featsT[..., :s].contiguous())
        tmax = (1.0 - tc.tile_composite_plain(head, dirs, settings)[1]
                ).amax(-1)
        live = no_skip & (count > s)
        skip_from[live & (tmax <= 0.9 * tmin)] = ci
        no_skip &= ~(live & ~(tmax > 1.1 * tmin))
    return no_skip, skip_from, kc


def tile_pairs(packets, dirs, settings) -> int:
    """(pixel, slot) pairs the forward kernel evaluates on these packets:
    slots under count in the chunks it runs (chunk_schedule's skips; a tile
    within its margin counts every chunk)."""
    _, skip_from, kc = chunk_schedule(packets, dirs, settings)
    count = torch.ceil(packets["count"]).long()
    k = packets["geom"].shape[-1]
    starts = torch.arange(0, k, kc, device=count.device)
    slots = torch.clamp(count[:, None] - starts[None], 0, kc)
    slots = torch.where(starts[None] // kc < skip_from[:, None], slots, 0)
    return int(slots.sum()) * dirs.shape[1]


def tile_bytes(packets, dirs, backward: bool = False) -> float:
    """Bytes the tile kernels must move: count, dirs, the 11 geometry rows
    used and the features read once, the outputs written once (and for the
    backward the cotangent in, the three gradients out)."""
    t_total, p, _ = dirs.shape
    k = packets["geom"].shape[-1]
    f = packets["featsT"].shape[1]
    n = t_total * (1 + p * 3 + 11 * k + f * k) + t_total * p * (f + 2)
    if backward:
        n += t_total * (p * 3 + 16 * k + f * k)
    return 4.0 * n


def live_share(packets, dirs, settings):
    """(live, evaluated, live pairs): the (warp, slot) pairs that the
    kernels evaluate (slots under count in the chunks they run,
    chunk_schedule's skips), those of them where any of the warp's 32
    pixels has alpha > 0, and the (pixel, slot) pairs evaluated with alpha
    > 0, counted in torch from the plain version's alpha. The backward's
    phase 2 works on the live (warp, slot)s alone, and the forward's
    composite step runs only there. The any-P kernels' lanes past P repeat
    pixel P - 1: in the warps that hold a pixel for the cluster kernels
    (a warp with none skips the slots), in every warp of the last group
    for the group-loop kernels."""
    geom = packets["geom"]
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    path, _, block = tc.any_p_plan(p)
    unit = block if path == "group_loop" else 32
    lanes = -(-p // unit) * unit
    _, skip_from, kc = chunk_schedule(packets, dirs, settings)
    slot = torch.arange(k, device=dirs.device)
    run = (slot[None] < torch.ceil(packets["count"]).long()[:, None]) \
        & (slot[None] // kc < skip_from[:, None])               # (T, K)
    step = max(1, tc.PLAIN_CHUNK_ELEMS // (p * k))
    live = live_pairs = 0
    for s in range(0, t_total, step):
        g = geom[s:s + step]
        _, alpha = tc._t_alpha(*tc._quadratic_ab(dirs[s:s + step], g), g,
                               settings)
        pair_live = (alpha > 0) & run[s:s + step, None]
        live_pairs += int(pair_live.sum())
        lane_live = torch.cat([pair_live, pair_live[:, -1:].expand(
            -1, lanes - p, -1)], 1)
        live += int(lane_live.reshape(g.shape[0], lanes // 32, 32, k).any(2)
                    .sum())
    return live, int(run.sum()) * (lanes // 32), live_pairs


def tile_bounds(packets, dirs, settings) -> dict:
    """Both tile kernels' bounds on these packets: the yardsticks that
    bound_ms reports (FWD_PAIR_FLOPS, BWD_PAIR_FLOPS on every pair
    evaluated) and the function's (PAIR_EVAL_FLOPS on every pair evaluated,
    the rest on the pairs with alpha > 0 alone), with tile_bytes; and the
    live shares."""
    pairs = tile_pairs(packets, dirs, settings)
    live, n_ws, live_pairs = live_share(packets, dirs, settings)
    fwd_bytes = tile_bytes(packets, dirs)
    bwd_bytes = tile_bytes(packets, dirs, backward=True)
    fwd = bound(fwd_bytes, pairs * FWD_PAIR_FLOPS)
    bwd = bound(bwd_bytes, pairs * BWD_PAIR_FLOPS)
    fwd["function_bound_ms"] = bound(
        fwd_bytes, pairs * PAIR_EVAL_FLOPS
        + live_pairs * PAIR_COMPOSITE_FLOPS)["bound_ms"]
    bwd["function_bound_ms"] = bound(
        bwd_bytes, pairs * PAIR_EVAL_FLOPS
        + live_pairs * BWD_LIVE_PAIR_FLOPS)["bound_ms"]
    return dict(fwd=fwd, bwd=bwd, pairs=pairs, live_pairs=live_pairs,
                warp_live=live, warp_slots=n_ws)


def card_line(index: int = 0) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    res = subprocess.run(["nvidia-smi", "-i", str(index),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip()


# ---- the bench --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """The bench's sizes; the defaults are the root bench.py's. Each field
    but the pose's size has a ``GSPT_BENCH_<FIELD>`` variable (see
    :meth:`from_env`)."""

    n: int = 1_000_000          # headline Gaussians
    res: int = 800              # headline width and height
    iters: int = 10             # headline samples timed
    k: int = 256                # headline max_per_tile
    spp: int = 512              # samples a pose the headline amortizes over
    pt_n: int = 500_000         # surface-scene Gaussians
    pt_w: int = 1920
    pt_h: int = 1080
    pt_depth: int = 4
    pt12_w: int = 1920          # from_env: GSPT_BENCH_PT_W when unset
    pt12_h: int = 1080
    pose_spp: int = 16          # real samples of the capture pose
    pose_width: int = 800       # bench.py:276-279, no variable
    pose_height: int = 800

    ENV_FIELDS = ("n", "res", "iters", "k", "spp", "pt_n", "pt_w", "pt_h",
                  "pt_depth", "pt12_w", "pt12_h", "pose_spp")

    @classmethod
    def from_env(cls, environ=None) -> "BenchConfig":
        """The config with each ``GSPT_BENCH_<FIELD>`` variable that is
        set; PT12_W and PT12_H fall back to PT_W and PT_H, as in the root
        bench.py."""
        environ = os.environ if environ is None else environ
        kw = {f: int(environ[f"GSPT_BENCH_{f.upper()}"])
              for f in cls.ENV_FIELDS if f"GSPT_BENCH_{f.upper()}" in environ}
        kw.setdefault("pt12_w", kw.get("pt_w", cls.pt_w))
        kw.setdefault("pt12_h", kw.get("pt_h", cls.pt_h))
        return cls(**kw)

    @property
    def few(self) -> int:
        """Timed binnings, training steps and dense baseline calls."""
        return max(2, self.iters // 3)

    @property
    def pt_iters(self) -> int:
        """Timed depth-4 path-trace samples."""
        return max(1, self.iters // 5)


def reference_bench(path: str):
    """(the result keys, {GSPT_BENCH_* variable: its default's expression})
    of the root bench.py at ``path``, read from its source (not imported:
    it imports the JAX package)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    keys, env = None, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [getattr(t, "id", None) for t in node.targets] \
                == ["result"]:
            keys = [k.value for k in node.value.keys]
        if isinstance(node, ast.Call) and ast.unparse(node.func) \
                == "os.environ.get" and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value.startswith("GSPT_BENCH_"):
            env[node.args[0].value] = node.args[1]
    if keys is None:
        raise RuntimeError(f"{path} assigns no result dict")
    return keys, env


def headline(config: BenchConfig, device):
    """The headline's world on ``device``: (scene, camera, settings,
    binning config). A sample is ``render_prepared(prepare_tiles(...), cam,
    settings, cfg, outputs=("color", "alpha_acc"))``, with no jitter
    (bench.py:78)."""
    scene = random_cloud(config.n, seed=13, spread=1.5, device=device)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                             device=device),
                 fov_y_deg=50.0, width=config.res, height=config.res)
    return (scene, cam, RenderSettings(background=(0.1, 0.2, 0.3)),
            BinningConfig(max_per_tile=config.k))


def _timed(fn, iters: int):
    """(the last result, mean seconds a call) of fn(1) .. fn(iters) on the
    host clock, after the WARMUPS warm-up fn(0); fenced before the clock
    starts, so that no earlier work bleeds in, and before it stops."""
    for _ in range(WARMUPS):
        fence(fn(0))
    t0 = time.perf_counter()
    for i in range(1, iters + 1):
        out = fn(i)
    fence(out)
    return out, (time.perf_counter() - t0) / iters


def run(config: BenchConfig, device=None) -> dict:
    """Runs every workload at ``config``'s sizes on ``device`` (None: the
    CUDA card; raises without one) and returns the result line's dict.
    Turns TF32 off for the whole process, as the plain versions need."""
    c = config
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rays_per_frame = c.res * c.res

    # ---- headline: per-pose binning, then per-sample forward -------------
    scene, cam, settings, cfg = headline(c, dev)
    pk, dt_prep = _timed(lambda i: prepare_tiles(scene, cam, settings, cfg),
                         c.few)
    _, dt_samp = _timed(lambda i: render_prepared(
        pk, cam, settings, cfg, outputs=("color", "alpha_acc")), c.iters)
    rays_amortized = c.spp * rays_per_frame / (dt_prep + c.spp * dt_samp)

    # ---- forward and backward, a fresh binning each step -------------------
    means = scene.means.detach().clone().requires_grad_(True)

    def fwd_bwd(i):
        o = render_tiled_fused(scene.replace(means=means), cam, settings, cfg)
        loss = torch.mean(o["color"] ** 2)
        return loss.detach(), torch.autograd.grad(loss, means)[0]

    _, dt_fb = _timed(fwd_bwd, c.few)
    del means

    # ---- path tracing: the surface scene on the grid backend ---------------
    pt_scene = surface_scene(c.pt_n, seed=13, device=dev)
    pt_c2w = look_at((0.0, 0.2, 1.7), (0.0, -0.4, -0.5), device=dev)
    pt_cam = Camera(c2w=pt_c2w, fov_y_deg=60.0, width=c.pt_w, height=c.pt_h)
    pt_settings = RenderSettings(max_depth=c.pt_depth, ambient=PT_AMBIENT)
    pt_accel = build_grid_accel(pt_scene)
    pt_tables = build_light_tables(pt_scene)
    pt_cfg = BinningConfig()
    key = rng.prng_key(13)

    def camera_samples(cam_, settings_):
        backend = make_trace_backend(pt_scene, settings_, "grid",
                                     accel=pt_accel)
        packets = prepare_tiles(pt_scene, cam_, settings_, pt_cfg)
        fence(packets)
        return lambda i: pathtrace_camera(
            pt_scene, cam_, settings_, rng.fold_in(key, i), packets=packets,
            tables=pt_tables, backend=backend, config=pt_cfg)

    with torch.no_grad():
        _, dt_pt = _timed(camera_samples(pt_cam, pt_settings),
                          c.pt_iters)
        pt12_settings = RenderSettings(max_depth=PT12_DEPTH,
                                       opaque_depth=PT12_OPAQUE_DEPTH,
                                       ambient=PT_AMBIENT)
        pt12_cam = Camera(c2w=pt_c2w, fov_y_deg=60.0, width=c.pt12_w,
                          height=c.pt12_h)
        _, dt_pt12 = _timed(camera_samples(pt12_cam, pt12_settings),
                            PT12_ITERS)

        # ---- one capture pose, scaled to 512 spp ---------------------------
        pose_render = make_tiled_pose_renderer(
            pt_scene, pt_settings, None, spp=c.pose_spp,
            bounce_backend="grid", accel=pt_accel)
        c2w_pose = toroidal_c2w(123.0, 20.0, 2.5, 0.3, device=dev)
        _, dt_pose = _timed(lambda i: pose_render(
            c2w_pose, c.pose_width, c.pose_height, POSE_FOV), POSE_ITERS)
    pose_s_512 = dt_pose * POSE_SPP_FULL / c.pose_spp
    del pt_scene, pt_accel, pose_render

    # ---- the dense O(R·N) baseline at a feasible N, scaled by N ------------
    n_base = min(c.n, 50_000)
    base_scene = GaussianScene(**{
        f.name: getattr(scene, f.name)[:n_base]
        for f in dataclasses.fields(GaussianScene)})
    sub = generate_rays(Camera(c2w=cam.c2w, fov_y_deg=cam.fov_y_deg,
                               width=64, height=32))
    dense_settings = RenderSettings(max_contribs=min(c.k, DENSE_MAX_K),
                                    background=settings.background)
    _, dt_dense = _timed(lambda i: render_radiance_dense(
        base_scene, sub, dense_settings), c.few)
    rays_dense_at_n = (sub.num_rays / dt_dense) * (n_base / c.n)

    # ---- the forward's function bound on the headline packets --------------
    # Counted after every timed section: live_share walks every pair.
    dirs, _ = _tile_dirs(cam, cfg)
    with torch.no_grad():
        pairs = tile_pairs(pk, dirs, settings)
        live_pairs = live_share(pk, dirs, settings)[2]
    flops = pairs * PAIR_EVAL_FLOPS + live_pairs * PAIR_COMPOSITE_FLOPS
    n_bytes = tile_bytes(pk, dirs)
    fwd_bound = bound(n_bytes, flops)
    achieved_flops = flops / dt_samp

    return {
        "metric": f"amortized primary rays/s/chip, CUDA tile renderer, "
                  f"{c.n} gaussians, {c.res}x{c.res}, K={c.k}, "
                  f"{c.spp}spp/pose",
        "value": round(rays_amortized),
        "unit": "rays/s",
        "vs_baseline": rays_amortized / rays_dense_at_n,
        "per_sample_rays_per_s": round(rays_per_frame / dt_samp),
        "fwd_bwd_rays_per_s": round(rays_per_frame / dt_fb),
        "binning_ms_per_pose": dt_prep * 1e3,
        "sample_ms": dt_samp * 1e3,
        "pathtraced_rays_per_s": round(c.pt_w * c.pt_h / dt_pt),
        "pathtrace_sample_ms": dt_pt * 1e3,
        "pathtrace_config": f"{c.pt_n} gaussians, {c.pt_w}x{c.pt_h}, "
                            f"depth {c.pt_depth}, grid backend",
        "pathtrace12_sample_ms": dt_pt12 * 1e3,
        "pathtrace12_config": f"{c.pt12_w}x{c.pt12_h}, max_depth "
                              f"{PT12_DEPTH}, opaque_depth "
                              f"{PT12_OPAQUE_DEPTH} (raygen_camera.rgen:"
                              "47-64 adaptive; glass sphere in scene), one "
                              "pathtrace_camera call a sample (no ray "
                              f"chunks), mean of {PT12_ITERS} samples after "
                              f"{WARMUPS} warm-up",
        "pose_s": pose_s_512,
        "pose_config": f"{c.pose_width}x{c.pose_height} fov {POSE_FOV} "
                       f"depth-{c.pt_depth} capture pose, {POSE_SPP_FULL} "
                       f"spp (measured {c.pose_spp} real spp through "
                       "make_tiled_pose_renderer, grid bounces, one warm "
                       "pose then one timed, scaled linearly)",
        "mfu": achieved_flops / FP32_FLOPS_PER_S,
        "achieved_tflops": achieved_flops / 1e12,
        "hbm_gbps": n_bytes / dt_samp / 1e9,
        "fwd_bound_share": fwd_bound["bound_ms"] / (dt_samp * 1e3),
        "roofline_note": f"the forward tile kernel's function bound over "
                         f"sample_ms: {PAIR_EVAL_FLOPS} flops on each of "
                         f"{pairs} (pixel, slot) pairs evaluated, "
                         f"{PAIR_COMPOSITE_FLOPS} more on the {live_pairs} "
                         f"with alpha > 0, {n_bytes:.4e} bytes; mfu against "
                         "the H100's 67 TFLOP/s float32 non-tensor peak, "
                         "fwd_bound_share = max(flops / 67e12, bytes / "
                         f"3.35e12) / sample_ms, bound by "
                         f"{fwd_bound['bound_by']}; sample_ms also holds "
                         "the ray directions and the untile, and at "
                         f"{c.iters} samples of about a millisecond it moves "
                         "with the host's launch time; vs_baseline and "
                         "dense_baseline_rays_per_s_scaled divide by "
                         "render_radiance_dense at a list of "
                         f"{dense_settings.max_contribs} a ray (the top-K "
                         "kernel's cap; the root bench keeps "
                         f"{min(c.k, 256)}), whose top-K kernel runs its "
                         "worst case on these few rays (ROADMAP section 2), "
                         "so they are not comparable with the root "
                         "bench's",
        "dense_baseline_rays_per_s_scaled": round(rays_dense_at_n),
        "device": card_line(dev.index or 0) if dev.type == "cuda"
        else str(dev),
    }


def main(device=None) -> None:
    """Runs the bench at the sizes the environment sets and prints its
    JSON line."""
    print(json.dumps(run(BenchConfig.from_env(), device=device)))


if __name__ == "__main__":
    main()
