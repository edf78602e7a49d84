"""Dataset capture: pose renderers, ``capture_scene_data`` and
``capture_panorama``.

Counterpart of ``pathtracer_gaussiansplatting_tpu/data/capture.py``:

  * ``total_positions`` random toroidal poses (``RandomState(13)``: alpha
    ~ U[0, 360), beta ~ U[min_beta, max_beta]), each accumulated over
    ``accumulation_steps`` path-traced samples, box-downscaled by
    ``image_divisor`` and written as ``train/r_i.jpg``; every 4th frame's
    camera goes to the test split, every image under ``train/``;
  * ``transforms_train.json`` and ``transforms_test.json``;
  * a pass of torus-sensor rays, whose accumulated radiance and first hit
    (position, normal, alpha above the hit threshold) become
    ``points3d.ply``.

Each pose accumulates its samples in a plain host loop; sample f is keyed
on the absolute frame index (``rng.frame_key(base, f)``), so the result is
a pure fold over f and a pose checkpointed mid-way resumes to the same
bits. The reference's dispatch watchdog (segments timed to stay under a
TPU worker's limit) has no counterpart: segments exist only to
checkpoint. Where the route marches the grid, one GridAccel serves the
pose renderer, the flat renderer and the point-cloud trace.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core import rng as rng_mod
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays, toroidal_c2w,
)
from pathtracer_gaussiansplatting_tpu_torch.core.torus import (
    TorusConfig, torus_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    PUNCTUAL_FIELDS, GaussianScene, PunctualLights, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.data.images import (
    box_downscale, save_jpg,
)
from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
    save_point_cloud_ply,
)
from pathtracer_gaussiansplatting_tpu_torch.data.transforms import (
    save_transforms_json,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.render import lights as lights_mod
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
    accumulate, pathtrace, pathtrace_camera,
)
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    AUTO_DENSE_LIMIT, make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import prepare_tiles
from pathtracer_gaussiansplatting_tpu_torch.sampling.strategies import (
    SamplingMethod, generate_samples,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.checkpoint import (
    CaptureProgress, load_render_state, save_render_state,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.debug import scan_finite
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger

CAPTURE_SEED = 13  # the reference engine's mt19937(13)


def resolve_backend(backend: str, num_gaussians: int) -> str:
    """'auto' -> 'tiled+grid' above AUTO_DENSE_LIMIT Gaussians, else
    'dense'; any other name is returned as it is."""
    if backend != "auto":
        return backend
    return "tiled+grid" if num_gaussians > AUTO_DENSE_LIMIT else "dense"


def make_accumulating_renderer(scene: GaussianScene,
                               settings: RenderSettings,
                               punctual: Optional[PunctualLights], spp: int,
                               key: Optional[torch.Tensor] = None,
                               backend: str = "auto", **backend_kw):
    """render(origins, directions) -> (R, 3) radiance accumulated over spp
    path-traced samples, acc += (cur - acc) / (f + 1), through the trace
    backend named ``backend`` (render/pipeline.py; ``backend_kw`` such as
    ``accel=`` go to ``make_trace_backend``)."""
    tables = lights_mod.build_light_tables(scene, punctual)
    base_key = rng_mod.prng_key(CAPTURE_SEED) if key is None else key
    trace_backend = make_trace_backend(scene, settings, backend,
                                       **backend_kw)

    def render(origins: torch.Tensor, directions: torch.Tensor):
        rays = Rays(origins, directions)
        acc = torch.zeros((origins.shape[0], 3), dtype=torch.float32,
                          device=origins.device)
        for f in range(spp):
            cur = pathtrace(scene, rays, settings,
                            rng_mod.frame_key(base_key, f), tables=tables,
                            punctual=punctual, backend=trace_backend)
            acc = acc + (cur - acc) / torch.tensor(f + 1.0)
        return acc

    return render


def render_pose(render_fn, c2w: torch.Tensor, width: int, height: int,
                fov_y_deg: float, chunk: int = 65536) -> torch.Tensor:
    """Render one camera pose in row-major ray chunks of ``chunk`` rays
    (the chunk fixes each ray's random numbers, as in the reference);
    returns (H, W, 3) linear radiance on the device of ``c2w``."""
    rays = generate_rays(Camera(c2w=c2w, fov_y_deg=fov_y_deg, width=width,
                                height=height))
    n = rays.num_rays
    outs = [render_fn(rays.origins[s:s + chunk].contiguous(),
                      rays.directions[s:s + chunk].contiguous())
            for s in range(0, n, chunk)]
    return torch.cat(outs, dim=0).reshape(height, width, 3)


def _resume_state(state_path, fingerprint, device):
    """The mid-pose state at ``state_path`` to resume from, or None: none
    there, or written under another capture fingerprint (discarded with a
    warning; the pose starts over and the file is overwritten)."""
    if not (state_path and os.path.exists(state_path)):
        return None
    state = load_render_state(state_path, device)
    old = state["extra"].get("fingerprint")
    if fingerprint is not None and old is not None and old != fingerprint:
        get_logger().warning(
            "mid-pose state %s was written under a different configuration "
            "(fingerprint %s != %s) — discarding it; the pose starts over",
            state_path, old, fingerprint)
        return None
    return state


def make_tiled_pose_renderer(scene: GaussianScene, settings: RenderSettings,
                             punctual: Optional[PunctualLights], spp: int,
                             key: Optional[torch.Tensor] = None,
                             bounce_backend: str = "auto",
                             binning_config: Optional[BinningConfig] = None,
                             **backend_kw):
    """Pose renderer with the fused tile pass for the primary hit.

    Returns render(c2w, width, height, fov_y_deg, stats_out=None,
    state_path=None, checkpoint_every=0, stop_after_segments=None,
    fingerprint=None) -> (H, W, 3): per pose one ``prepare_tiles``, then
    spp samples of ``pathtrace_camera`` with fresh subpixel jitter, whose
    bounces use the backend named ``bounce_backend`` (``backend_kw`` such
    as ``accel=`` go to ``make_trace_backend``, so one grid serves every
    pose), accumulated. ``stats_out`` (a dict) gathers the binning stats
    and the backend's frozen rays, summed over poses, and, for the grid
    backend, the grid's truncation stats as ``grid_<key>`` (set, not
    summed: one grid serves every pose).

    With ``state_path`` and ``checkpoint_every`` > 0 the accumulation and
    the count of finished samples are saved after every
    ``checkpoint_every`` samples (the JAX package's file, with
    ``fingerprint`` in its extra), and a pose whose state file exists
    resumes from it, unless the file carries another fingerprint. The
    file is removed when the pose is done. ``stop_after_segments``
    simulates a crash: render returns None after that many segments.
    """
    config = binning_config or BinningConfig()
    tables = lights_mod.build_light_tables(scene, punctual)
    base_key = rng_mod.prng_key(CAPTURE_SEED) if key is None else key
    trace_backend = make_trace_backend(scene, settings, bounce_backend,
                                       **backend_kw)

    def render(c2w: torch.Tensor, width: int, height: int, fov_y_deg: float,
               stats_out: Optional[dict] = None, state_path=None,
               checkpoint_every: int = 0,
               stop_after_segments: Optional[int] = None,
               fingerprint: Optional[str] = None):
        cam = Camera(c2w=c2w, fov_y_deg=fov_y_deg, width=width,
                     height=height)
        packets = prepare_tiles(scene, cam, settings, config)
        if stats_out is not None:
            for k, v in packets.items():
                if k.startswith("stat_"):
                    stats_out[k[5:]] = stats_out.get(k[5:], 0.0) + float(v)
            if trace_backend.accel is not None:
                for k, v in trace_backend.accel.stats_dict.items():
                    if isinstance(v, (int, float)):
                        stats_out["grid_" + k] = float(v)
        acc = torch.zeros((height * width, 3), dtype=torch.float32,
                          device=c2w.device)
        f0 = 0
        state = _resume_state(state_path, fingerprint, c2w.device)
        if state is not None:
            acc, f0 = state["accumulation"], state["frames_done"]
        seg = checkpoint_every if (state_path and checkpoint_every) else spp
        done_segments = 0
        while f0 < spp:
            frozen = 0
            for f in range(f0, min(f0 + seg, spp)):
                jitter = rng_mod.subpixel_jitter(base_key, height, width, f,
                                                 device=c2w.device)
                cur, aux = pathtrace_camera(
                    scene, cam, settings, rng_mod.frame_key(base_key, f),
                    packets=packets, tables=tables, punctual=punctual,
                    backend=trace_backend, config=config, jitter=jitter,
                    return_aux=True)
                acc = accumulate(acc, cur, f)
                frozen = frozen + aux["frozen_alive"]
            f0 = min(f0 + seg, spp)
            if stats_out is not None:
                stats_out["frozen_alive"] = (
                    stats_out.get("frozen_alive", 0.0) + float(frozen))
            if state_path and f0 < spp:
                save_render_state(state_path, acc, f0, base_key,
                                  extra=dict(fingerprint=fingerprint)
                                  if fingerprint is not None else None)
            done_segments += 1
            if stop_after_segments and done_segments >= stop_after_segments \
                    and f0 < spp:
                return None
        if state_path and os.path.exists(state_path):
            os.remove(state_path)
        return acc.reshape(height, width, 3)

    return render


def _shading_and_lights(scene: GaussianScene, settings: RenderSettings,
                        punctual: Optional[PunctualLights]) -> str:
    """Digests of every render setting and of the lights (the punctual
    lights and the scene's emission), for the capture's fingerprint."""
    lights = hashlib.sha256()
    arrays = [] if punctual is None else [getattr(punctual, f)
                                          for f in PUNCTUAL_FIELDS]
    for a in arrays + [scene.emission]:
        lights.update(a.detach().cpu().numpy().tobytes())
    shading = hashlib.sha256(repr(dataclasses.astuple(settings)).encode())
    return (f"settings={shading.hexdigest()[:16]};"
            f"lights={lights.hexdigest()[:16]}")


def _report_truncation(bin_stats: dict, progress) -> None:
    """The capture's truncation lines: binning over every pose, the grid's,
    and the marcher's frozen rays (no silent caps)."""
    progress("binning truncation over capture: "
             f"cap_dropped_tiles={bin_stats.get('cap_dropped_tiles', 0):.3g} "
             f"(gaussians affected {bin_stats.get('cap_truncated', 0):.3g}), "
             f"tile_dropped={bin_stats.get('tile_dropped', 0):.3g} "
             f"over {bin_stats.get('tile_overflow', 0):.3g} overflowing tiles")
    if any(k.startswith("grid_") for k in bin_stats):
        progress("grid-accel truncation (bounce backend): "
                 f"clamped_frac={bin_stats.get('grid_clamped_frac', 0):.3g} "
                 f"dropped_frac={bin_stats.get('grid_dropped_frac', 0):.3g} "
                 f"overflow_cell_frac="
                 f"{bin_stats.get('grid_overflow_cell_frac', 0):.3g}")
    progress("marcher truncation over capture: frozen_alive="
             f"{bin_stats.get('frozen_alive', 0.0):.3g} rays "
             "(mid-march frozen, partial accumulation; "
             "grid_trace.march schedule)")


def _trace_host(trace_backend, scene, settings, origins, directions) -> dict:
    """The backend's interaction for the rays, as host numpy arrays."""
    inter = trace_backend.trace(scene, Rays(origins, directions), settings)
    return {k: v.cpu().numpy() for k, v in inter.items()}


@torch.no_grad()
def capture_scene_data(scene: GaussianScene, out_dir: str,
                       settings: RenderSettings,
                       torus: TorusConfig = TorusConfig(),
                       punctual: Optional[PunctualLights] = None,
                       accumulation_steps: int = 512,
                       total_positions: int = 336,
                       min_beta: float = -45.0, max_beta: float = 45.0,
                       image_divisor: int = 2,
                       width: int = 800, height: int = 800,
                       fov_y_deg: float = 45.0,
                       capture_images: bool = True,
                       capture_pointcloud: bool = True,
                       sampling_method: str = "uniform",
                       num_rays: Optional[int] = None,
                       chunk: int = 65536,
                       resume: bool = True,
                       spp_checkpoint: int = 128,
                       backend: str = "auto",
                       debug_checks: bool = False,
                       progress: Optional[Callable[[str], None]] = print):
    """Full dataset capture (images, transforms, point cloud) on the
    scene's device.

    With ``resume`` (the default), poses recorded in
    ``<out_dir>/.progress.json`` under the same fingerprint are skipped
    after a restart, and a pose cut short resumes from its
    ``.pose_<i>.npz`` (the tiled route saves one every ``spp_checkpoint``
    samples); the pose stream is a pure function of the seed, so skipping
    keeps the result. ``debug_checks`` scans every image and every
    point-cloud chunk for NaN and Inf (``utils/debug.scan_finite``).

    Returns dict with 'train_frames', 'test_frames', 'num_points' and
    'camera_angle_x'.
    """
    device = scene.means.device
    cap_rng = np.random.RandomState(CAPTURE_SEED)
    # 'tiled...' renders the poses with the fused tile pass for the primary
    # hit (the production path at large N); anything else path-traces
    # flat ray chunks end to end.
    backend = resolve_backend(backend, scene.num_gaussians)
    if progress:
        progress(f"capture backend: {backend}")
    tiled_images = backend.startswith("tiled")
    bounce_backend = backend.split("+", 1)[1] if "+" in backend else "auto"
    flat_backend = bounce_backend if tiled_images else backend
    # One trace backend for the point-cloud trace; its grid (None for the
    # dense backend) serves both renderers too, so the grid is built once.
    trace_backend = make_trace_backend(scene, settings, flat_backend)
    if tiled_images:
        pose_render = make_tiled_pose_renderer(
            scene, settings, punctual, accumulation_steps,
            bounce_backend=bounce_backend, accel=trace_backend.accel)
    render_fn = make_accumulating_renderer(scene, settings, punctual,
                                           accumulation_steps,
                                           backend=flat_backend,
                                           accel=trace_backend.accel)
    train_frames, test_frames = [], []
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    # Everything that changes pose geometry or image content: a journal or
    # a mid-pose state under another configuration is not resumed.
    fingerprint = (
        f"seed={CAPTURE_SEED};torus={torus.major_radius},{torus.height};"
        f"beta={min_beta},{max_beta};res={width}x{height}/{image_divisor};"
        f"fov={fov_y_deg};spp={accumulation_steps};"
        f"poses={total_positions};backend={backend};"
        f"scene_n={scene.num_gaussians};"
        f"depth={settings.max_depth};"
        + _shading_and_lights(scene, settings, punctual))
    journal = CaptureProgress(os.path.join(out_dir, ".progress.json"),
                              fingerprint=fingerprint) if resume else None

    fov_x = None
    bin_stats = {}
    if capture_images:
        for i in range(total_positions):
            alpha = cap_rng.uniform(0.0, 360.0)
            beta = cap_rng.uniform(min_beta, max_beta)
            c2w = toroidal_c2w(alpha, beta, torus.major_radius, torus.height,
                               device=device)
            rel = f"./train/r_{i}"
            img_path = os.path.join(out_dir, "train", f"r_{i}.jpg")
            if not (journal and journal.is_done(i)
                    and os.path.exists(img_path)):
                if tiled_images:
                    img = pose_render(
                        c2w, width, height, fov_y_deg, stats_out=bin_stats,
                        state_path=os.path.join(out_dir, f".pose_{i}.npz"),
                        checkpoint_every=spp_checkpoint,
                        fingerprint=fingerprint)
                else:
                    img = render_pose(render_fn, c2w, width, height,
                                      fov_y_deg, chunk)
                if debug_checks:
                    scan_finite(img, f"capture pose {i} image")
                img = box_downscale(img.cpu().numpy(), image_divisor)
                save_jpg(img_path, np.clip(img, 0.0, 1.0))
                if journal:
                    journal.mark(i)
            frame = dict(file_path=rel, transform_matrix=c2w.cpu().numpy())
            # every 4th frame to the test split, as the reference engine
            (test_frames if i % 4 == 0 else train_frames).append(frame)
            if progress:
                progress(f"captured position {i + 1}/{total_positions} "
                         f"(alpha={alpha:.1f}, beta={beta:.1f})")
        if bin_stats and progress:
            _report_truncation(bin_stats, progress)
        fov_x = Camera(c2w=torch.eye(4), fov_y_deg=fov_y_deg, width=width,
                       height=height).fov_x_rad
        save_transforms_json(os.path.join(out_dir, "transforms_train.json"),
                             fov_x, train_frames)
        save_transforms_json(os.path.join(out_dir, "transforms_test.json"),
                             fov_x, test_frames)

    num_points = 0
    if capture_pointcloud:
        n_rays = num_rays if num_rays is not None else torus.num_rays
        method = SamplingMethod(sampling_method)
        if method in (SamplingMethod.IMP_COL, SamplingMethod.IMP_HIT):
            # Importance feedback: bootstrap with a uniform pass, then
            # rebuild the (u, v) set from its colors or hit ratio.
            uv0 = generate_samples(SamplingMethod.UNIFORM, n_rays)
            boot = torus_rays(uv0, torus, device)
            boot_cols, boot_flags = [], []
            for s in range(0, n_rays, chunk):
                inter = _trace_host(trace_backend, scene, settings,
                                    boot.origins[s:s + chunk],
                                    boot.directions[s:s + chunk])
                alpha = np.maximum(inter["alpha_acc"], 1e-8)
                boot_cols.append(inter["albedo"] / alpha[:, None])
                boot_flags.append(alpha > settings.hit_opacity_threshold)
            uv = generate_samples(
                method, n_rays, prev_uv=uv0,
                prev_colors=np.concatenate(boot_cols),
                prev_flags=np.concatenate(boot_flags).astype(np.float32))
            if progress:
                progress(f"importance resample ({method.value}) from "
                         f"{n_rays} bootstrap rays")
        else:
            uv = generate_samples(method, n_rays)
        rays = torus_rays(uv, torus, device)
        positions, normals, colors, flags = [], [], [], []
        for s in range(0, n_rays, chunk):
            e = min(s + chunk, n_rays)
            o, d = rays.origins[s:e], rays.directions[s:e]
            color = render_fn(o, d).cpu().numpy()
            inter = _trace_host(trace_backend, scene, settings, o, d)
            if debug_checks:
                scan_finite(dict(color=color, **inter),
                            f"point-cloud interaction rays {s}:{e}")
            positions.append(inter["position"])
            normals.append(inter["normal"])
            colors.append(color)
            flags.append(inter["alpha_acc"] > settings.hit_opacity_threshold)
            if progress:
                progress(f"point cloud rays {e}/{n_rays}")
        num_points = save_point_cloud_ply(
            os.path.join(out_dir, "points3d.ply"),
            np.concatenate(positions), np.concatenate(normals),
            np.clip(np.concatenate(colors), 0.0, 1.0),
            np.concatenate(flags).astype(np.float32))
    return dict(train_frames=train_frames, test_frames=test_frames,
                num_points=num_points, camera_angle_x=fov_x)


@torch.no_grad()
def capture_panorama(scene: GaussianScene, out_dir: str,
                     settings: RenderSettings,
                     torus: TorusConfig = TorusConfig(),
                     punctual: Optional[PunctualLights] = None,
                     beta: float = 0.0, steps: int = 360,
                     accumulation_steps: int = 64,
                     width: int = 800, height: int = 800,
                     fov_y_deg: float = 45.0, chunk: int = 65536,
                     backend: str = "auto",
                     progress: Optional[Callable[[str], None]] = print):
    """360-degree toroidal sweep at a fixed beta: one accumulated frame per
    step through the flat renderer, saved as ``panorama/pano_i.jpg``."""
    backend = resolve_backend(backend, scene.num_gaussians)
    flat_backend = backend.split("+", 1)[1] if "+" in backend else backend
    render_fn = make_accumulating_renderer(scene, settings, punctual,
                                           accumulation_steps,
                                           backend=flat_backend)
    pano_dir = os.path.join(out_dir, "panorama")
    os.makedirs(pano_dir, exist_ok=True)
    for i in range(steps):
        alpha = 360.0 * i / steps
        c2w = toroidal_c2w(alpha, beta, torus.major_radius, torus.height,
                           device=scene.means.device)
        img = render_pose(render_fn, c2w, width, height, fov_y_deg, chunk)
        save_jpg(os.path.join(pano_dir, f"pano_{i}.jpg"),
                 np.clip(img.cpu().numpy(), 0.0, 1.0))
        if progress:
            progress(f"panorama {i + 1}/{steps}")
