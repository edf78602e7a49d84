"""Pose renderers for dataset capture: flat ray chunks and the tile path.

Counterpart of ``pathtracer_gaussiansplatting_tpu/data/capture.py``
(``CAPTURE_SEED``, ``resolve_backend``, ``make_accumulating_renderer``,
``render_pose``, ``make_tiled_pose_renderer``). Each pose accumulates spp
path-traced samples in a plain host loop; sample f is keyed on the frame
index (``rng.frame_key(base, f)``), so the result is a pure fold over f.
The dataset capture itself (``capture_scene_data``, ``capture_panorama``,
the writers) and mid-pose checkpoints come with the capture slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core import rng as rng_mod
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, PunctualLights, Rays, RenderSettings,
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


def make_tiled_pose_renderer(scene: GaussianScene, settings: RenderSettings,
                             punctual: Optional[PunctualLights], spp: int,
                             key: Optional[torch.Tensor] = None,
                             bounce_backend: str = "auto",
                             binning_config: Optional[BinningConfig] = None,
                             **backend_kw):
    """Pose renderer with the fused tile pass for the primary hit.

    Returns render(c2w, width, height, fov_y_deg, stats_out=None) ->
    (H, W, 3): per pose one ``prepare_tiles``, then spp samples of
    ``pathtrace_camera`` with fresh subpixel jitter, whose bounces use the
    backend named ``bounce_backend`` (``backend_kw`` such as ``accel=`` go
    to ``make_trace_backend``, so one grid serves every pose), accumulated.
    ``stats_out`` (a dict) gathers the binning stats and the backend's
    frozen shadow rays, summed over poses, and, for the grid backend, the
    grid's truncation stats as ``grid_<key>`` (set, not summed: one grid
    serves every pose).
    """
    config = binning_config or BinningConfig()
    tables = lights_mod.build_light_tables(scene, punctual)
    base_key = rng_mod.prng_key(CAPTURE_SEED) if key is None else key
    trace_backend = make_trace_backend(scene, settings, bounce_backend,
                                       **backend_kw)

    def render(c2w: torch.Tensor, width: int, height: int, fov_y_deg: float,
               stats_out: Optional[dict] = None, state_path=None,
               checkpoint_every: int = 0):
        if state_path is not None or checkpoint_every:
            raise NotImplementedError(
                "mid-pose checkpoints (state_path, checkpoint_every) come "
                "with the capture slice of the port")
        cam = Camera(c2w=c2w, fov_y_deg=fov_y_deg, width=width,
                     height=height)
        packets = prepare_tiles(scene, cam, settings, config)
        acc = torch.zeros((height * width, 3), dtype=torch.float32,
                          device=c2w.device)
        frozen = 0
        for f in range(spp):
            jitter = rng_mod.subpixel_jitter(base_key, height, width, f,
                                             device=c2w.device)
            cur, aux = pathtrace_camera(
                scene, cam, settings, rng_mod.frame_key(base_key, f),
                packets=packets, tables=tables, punctual=punctual,
                backend=trace_backend, config=config, jitter=jitter,
                return_aux=True)
            acc = accumulate(acc, cur, f)
            frozen = frozen + aux["frozen_alive"]
        if stats_out is not None:
            for k, v in packets.items():
                if k.startswith("stat_"):
                    stats_out[k[5:]] = stats_out.get(k[5:], 0.0) + float(v)
            stats_out["frozen_alive"] = (stats_out.get("frozen_alive", 0.0)
                                         + float(frozen))
            if trace_backend.accel is not None:
                for k, v in trace_backend.accel.stats_dict.items():
                    if isinstance(v, (int, float)):
                        stats_out["grid_" + k] = float(v)
        return acc.reshape(height, width, 3)

    return render
