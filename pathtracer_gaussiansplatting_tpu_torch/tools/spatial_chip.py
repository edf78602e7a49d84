"""The per-device cost of one step of the spatial slab ring.

Counterpart of ``benchmarks/spatial_chip.py``. It measures, on one
device, the two figures that set the ring's scaling, and projects the
rest:

  * the dense slab step: ``parallel.spatial._slab_interaction_feats`` (the
    per-step body of the ring's trace) on the first of S slabs of
    ``surface_scene(N)`` against an R-ray chunk (two launches of the
    top-K kernel on the card). The slab's table (``spatial._slab_table``)
    is built once, as a ring call builds it, and its build is timed on
    its own (``table_build_ms``); every time is the host clock over calls
    ended by a synchronize, after a warm-up call;
  * the grid slab: the same slab's grid (``spatial.build_slab_accels``)
    marched by ``render.grid_trace.trace_grid`` (the march kernel on the
    card) with R_grid rays;
  * the ring's carry, 284 bytes a ray a step (the rays 6 floats, the
    chunk id 1, four accumulators of 15 features and a transmittance),
    against an assumed link rate: :data:`LINK_GBPS`, per direction. No
    ring across cards is measured.

Projected scaling efficiency: t_compute / max(t_compute, t_comm) where the
ring overlaps its shift with the next slab's compute, t_compute /
(t_compute + t_comm) where it does not.

The sizes are the reference's variables with its defaults:
``GSPT_SPATIAL_N`` (2_000_000), ``GSPT_SPATIAL_SLABS`` (8),
``GSPT_SPATIAL_RAYS`` (4096) and ``GSPT_SPATIAL_RAYS_GRID`` (65536); rays
come from ``np.random.default_rng(0)`` as there. The result is printed as
one line and written to ``spatial_chip.json`` in ``GSPT_SPATIAL_DIR``,
which defaults to ``chiprun_out/spatial_chip/`` in the repository. Run
on the CUDA card:

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.spatial_chip

or on the CPU at a small size (``--device cpu``; each kernel's plain
version), for example ``GSPT_SPATIAL_N=4000 GSPT_SPATIAL_SLABS=4
GSPT_SPATIAL_RAYS=64 GSPT_SPATIAL_RAYS_GRID=256``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import surface_scene
from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as gt
from pathtracer_gaussiansplatting_tpu_torch.tools.downstream_loop import (
    device_line,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(ROOT, "chiprun_out", "spatial_chip")
# An assumption, not a measurement: NVLink 4 on the H100 SXM5 gives 900
# GB/s bidirectional (NVIDIA's H100 datasheet), 450 GB/s each way.
LINK_GBPS = 450.0
LINK_SOURCE = ("assumed: NVLink 4 on H100 SXM5, 900 GB/s bidirectional in "
               "NVIDIA's H100 datasheet, so 450 GB/s per direction; not "
               "measured")
FEAT_DIM = 15
# Bytes a ray a ring step: rays (6), chunk id (1), four (feats + trans)
# accumulators.
CARRY_BYTES = 4 * (6 + 1 + 4 * (FEAT_DIM + 1))
ITERS = 3
# The reference's GSPT_SPATIAL_* defaults: N, SLABS, RAYS, RAYS_GRID.
N, SLABS, RAYS, RAYS_GRID = 2_000_000, 8, 4096, 65536


@dataclasses.dataclass
class SlabStep:
    """The measured slab, its inputs and the last outputs of each step."""

    block: GaussianScene           # slab 0
    axis: torch.Tensor             # the slab axis (3,)
    origins: torch.Tensor          # the dense step's rays (R, 3)
    dirs: torch.Tensor
    origins_grid: torch.Tensor     # the grid step's rays (R_grid, 3)
    dirs_grid: torch.Tensor
    settings: RenderSettings
    table: object                  # the slab's dense table
    accel: gt.GridAccel            # slab 0's grid
    feats: torch.Tensor = None     # (R, 15), the last dense step's
    trans: torch.Tensor = None     # (R,)
    trace: dict = None             # the last grid step's trace_grid


def _rays(rng: np.random.Generator, r: int, device):
    o = rng.uniform(-1.2, 1.2, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device):
    """(the last result, seconds a call): one warm-up call, then ITERS
    calls ended by a synchronize."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) / ITERS


def slab_step(n: int = N, n_slabs: int = SLABS, rays: int = RAYS,
              rays_grid: int = RAYS_GRID, device=None) -> SlabStep:
    """Slab 0 of ``partition_slabs(surface_scene(n), n_slabs)`` on
    ``device`` (None: the CUDA card), its grid from ``build_slab_accels``,
    and the two ray sets; the dense table not built yet."""
    device = resolve_device(device)
    scene = surface_scene(n, seed=13, device=device)
    slabbed, axis = spatial.partition_slabs(scene, n_slabs)
    del scene
    nb = slabbed.num_gaussians // n_slabs
    block = GaussianScene(**{f: getattr(slabbed, f)[:nb].contiguous()
                             for f in SCENE_FIELDS})
    rng = np.random.default_rng(0)
    o, d = _rays(rng, rays, device)
    og, dg = _rays(rng, rays_grid, device)
    tables, meta = spatial.build_slab_accels(slabbed, n_slabs)
    accel = gt.GridAccel(
        btab=tables["btab"][0], geom=tables["geom"][0],
        packet=tables["packet"][0], lo=tables["lo"][0], hi=tables["hi"][0],
        dims=meta.dims, fill=tables["fill"][0], jump_unit=meta.jump_unit)
    return SlabStep(block=block, axis=torch.from_numpy(axis).to(device),
                    origins=o, dirs=d, origins_grid=og, dirs_grid=dg,
                    settings=RenderSettings(), table=None, accel=accel)


@torch.no_grad()
def measure(step: SlabStep, n_slabs: int) -> dict:
    """Time the table build, the dense slab step and the grid slab march
    on ``step``, each after a warm-up call (keeping their last outputs in
    it), and project the ring: the reference's result dict
    (benchmarks/spatial_chip.py:114-138; times unrounded), its link keys
    as ``comm_ms_at_link`` beside ``link_GBps`` and ``link_source``, with
    ``table_build_ms`` and ``device``."""
    device = step.origins.device
    step.table, table_s = _timed(
        lambda: spatial._slab_table(step.block, step.settings), device)
    (step.feats, step.trans), dt = _timed(
        lambda: spatial._slab_interaction_feats(
            step.block, step.origins, step.dirs, step.axis, step.settings,
            step.table), device)
    rays_g = Rays(step.origins_grid, step.dirs_grid)
    step.trace, dt_g_total = _timed(
        lambda: gt.trace_grid(step.block, rays_g, step.settings, step.accel),
        device)

    r, r_g = step.origins.shape[0], step.origins_grid.shape[0]
    nb = step.block.num_gaussians
    dt_g = dt_g_total / r_g * r        # per r-ray chunk
    link = LINK_GBPS * 1e9
    comm_bytes_step = r * CARRY_BYTES
    t_comm = comm_bytes_step / link
    t_comm_g = r_g * CARRY_BYTES / link
    return dict(
        metric="spatial-ring per-chip slab step",
        slab_gaussians=nb, rays_per_chip=r, n_slabs=n_slabs,
        slab_compute_ms=dt * 1e3,
        pairs_per_step=r * nb,
        carry_bytes_per_ray_step=CARRY_BYTES,
        comm_bytes_per_step=comm_bytes_step,
        link_GBps=LINK_GBPS, link_source=LINK_SOURCE,
        comm_ms_at_link=t_comm * 1e3,
        projected_scaling_eff_overlapped=dt / max(dt, t_comm),
        projected_scaling_eff_serial=dt / (dt + t_comm),
        spatial_rays_per_s=round(r / (n_slabs * max(dt, t_comm))),
        grid_slab=dict(
            rays_per_chip=r_g,
            slab_march_ms=dt_g_total * 1e3,
            comm_ms_at_link=t_comm_g * 1e3,
            projected_scaling_eff_overlapped=dt_g_total / max(dt_g_total,
                                                              t_comm_g),
            projected_scaling_eff_serial=dt_g_total / (dt_g_total
                                                       + t_comm_g),
            spatial_rays_per_s=round(r_g / (n_slabs * max(dt_g_total,
                                                          t_comm_g))),
            vs_dense_slab_speedup=dt / dt_g,
            note="grid accel per slab (build_slab_accels) on one device; "
                 "the comm figures are projected at the assumed link rate "
                 "(link_GBps, link_source): no ring across cards is "
                 "measured",
        ),
        table_build_ms=table_s * 1e3,
        device=device_line(device),
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    env = os.environ.get
    n_slabs = int(env("GSPT_SPATIAL_SLABS", SLABS))
    step = slab_step(n=int(env("GSPT_SPATIAL_N", N)), n_slabs=n_slabs,
                     rays=int(env("GSPT_SPATIAL_RAYS", RAYS)),
                     rays_grid=int(env("GSPT_SPATIAL_RAYS_GRID", RAYS_GRID)),
                     device=args.device)
    result = measure(step, n_slabs)
    print(json.dumps(result), flush=True)
    out_dir = env("GSPT_SPATIAL_DIR", DEFAULT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "spatial_chip.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return result


if __name__ == "__main__":
    main()
