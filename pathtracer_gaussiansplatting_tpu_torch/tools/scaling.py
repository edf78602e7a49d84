"""Ray-parallel weak scaling over worlds of 1, 2, 4 and 8 ranks, and the
Gaussian ring at two ranks.

Counterpart of ``benchmarks/scaling.py``:

  * the ray-parallel renderer (the scene replicated, the rays split over
    the ranks: ``parallel.shard.render_dense_ray_sharded``) on a (nd, 1)
    mesh, ``rays_per_device`` x nd rays, is the scaling measurement;
  * the Gaussian ring (``parallel.shard.ring_topk_radiance``) is run
    once at two ranks, on a (1, 2) mesh, as a functional check.

``parallel.mesh.make_mesh`` spans every rank of the process group, so
each nd runs in a world of its own: nd processes spawned together, each
joining one group on a file store, torn down when the world ends. On the
CPU (``--device cpu``) the ranks are host processes on gloo, one torch
thread each, and nd takes the values up to ``--ranks``; the figures then
measure the host. On the CUDA card (the default) there is one rank a card
on NCCL, which never puts two ranks on one card, so nd goes up to the
number of cards. An nd or a ring that cannot be had gets a line that says
why; nothing moves to another device.

The sizes are the reference's ``GSPT_SCALE_*`` variables with its
defaults: ``N`` 5000 Gaussians (``random_cloud(N, seed=13,
spread=1.2)``), ``RAYS`` 4096 a rank, ``ITERS`` 3 timed calls after one
warm-up. Output: one JSON line a world size, the ring's line, and the
efficiency summary, with the reference's keys. Run on the card:

    python -m pathtracer_gaussiansplatting_tpu_torch.tools.scaling

or on the CPU: ``... tools.scaling --device cpu --ranks 4``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
    Camera, generate_rays, look_at,
)
from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import random_cloud
from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
from pathtracer_gaussiansplatting_tpu_torch.parallel.shard import (
    render_dense_ray_sharded, ring_topk_radiance,
)

WORLD_SIZES = (1, 2, 4, 8)
RING_RANKS = 2
# The script's settings and scene (benchmarks/scaling.py:53-54).
SETTINGS = RenderSettings(max_contribs=32)
CLOUD = dict(seed=13, spread=1.2)
SPAWN_TIMEOUT_S = 300.0  # a world's deadline


def scaling_scene(n_gauss: int, device=None) -> GaussianScene:
    return random_cloud(n_gauss, device=device, **CLOUD)


def scaling_rays(rays_per_device: int, nd: int, device=None) -> Rays:
    """Exactly rays_per_device x nd rays (the script's camera, :56-60), so
    that they split evenly over the ray axis."""
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0),
                             device=device),
                 fov_y_deg=50.0, width=rays_per_device, height=nd)
    return generate_rays(cam)


def _fence(device: torch.device) -> None:
    """Wait for the card's queued work, then for every rank (a gloo
    all-reduce on a CPU tensor: a barrier on either kind of group)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.all_reduce(torch.zeros(1))


@torch.no_grad()
def run_ray_dp(mesh, scene: GaussianScene, rays: Rays,
               settings: RenderSettings, iters: int) -> dict:
    """The ray-parallel render on ``mesh`` (every rank of the group calls
    it with the whole scene and rays): one warm-up call, then ``iters``
    timed calls between fences. Returns the gathered (R, 3) image of the
    last call (``image``), the seconds a call (``seconds``), rays/s and
    rays/s a rank of the ray axis."""
    device = pm.mesh_device(mesh)
    out = render_dense_ray_sharded(scene, rays, settings, mesh)
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = render_dense_ray_sharded(scene, rays, settings, mesh)
    _fence(device)
    seconds = (time.perf_counter() - t0) / iters
    nd = pm.axis_size(mesh, pm.RAY_AXIS)
    rps = rays.num_rays / seconds
    return dict(image=pm.gather_rays(out, mesh), seconds=seconds,
                rays_per_s=rps, rays_per_s_per_device=rps / nd)


@torch.no_grad()
def run_ring(mesh, scene: GaussianScene, rays: Rays,
             settings: RenderSettings) -> dict:
    """``ring_topk_radiance`` on a (1, G) mesh: the scene padded to a
    multiple of G and split over the gauss axis, the rays on every rank.
    Returns the gathered image and whether it is finite."""
    g = pm.axis_size(mesh, pm.GAUSS_AXIS)
    block = pm.shard_scene(pm.pad_to_multiple(scene, g), mesh)
    out = ring_topk_radiance(block, pm.shard_rays(rays, mesh), settings, mesh)
    image = pm.gather_rays(out, mesh)
    return dict(image=image, functional_ok=bool(torch.isfinite(image).all()))


def _rank_main(rank: int, world: int, device: str, n_gauss: int,
               rays_per_device: int, iters: int, with_ring: bool,
               io_dir: str) -> None:
    """One rank of a world: join the group, run ray-dp on (world, 1) and,
    with ``with_ring``, the ring on (1, world); rank 0 writes the results
    to ``io_dir``. ``device`` is "cpu" or "cuda"."""
    dev_arg = "cpu" if device == "cpu" else None
    if device == "cpu":
        torch.set_num_threads(1)
    pm.initialize_multihost(
        init_method="file://" + os.path.join(io_dir, "store"),
        num_processes=world, process_id=rank, device=dev_arg)
    try:
        dev = resolve_device(dev_arg)
        scene = scaling_scene(n_gauss, dev)
        dp = run_ray_dp(pm.make_mesh((world, 1), device=dev_arg), scene,
                        scaling_rays(rays_per_device, world, dev), SETTINGS,
                        iters)
        out = dict(image=dp.pop("image").cpu().numpy(),
                   timing=np.asarray(json.dumps(dp)))
        if with_ring:
            ring = run_ring(pm.make_mesh((1, world), device=dev_arg), scene,
                            scaling_rays(rays_per_device, 1, dev), SETTINGS)
            out.update(ring_image=ring["image"].cpu().numpy(),
                       ring_ok=np.asarray(ring["functional_ok"]))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(io_dir, "outputs.npz"), **out)


def spawn_world(world: int, device: str, n_gauss: int, rays_per_device: int,
                iters: int, with_ring: bool) -> dict:
    """Run one world of ``world`` spawned ranks; returns rank 0's outputs
    (the ray-dp image and timing, and the ring's where asked). Raises if a
    rank fails or the deadline passes (the ranks are then killed)."""
    with tempfile.TemporaryDirectory(prefix="gspt_scaling_") as io_dir:
        ctx = mp.start_processes(
            _rank_main, args=(world, device, n_gauss, rays_per_device, iters,
                              with_ring, io_dir),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"scaling: {world} ranks still running "
                                       f"after {SPAWN_TIMEOUT_S:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        with np.load(os.path.join(io_dir, "outputs.npz")) as f:
            out = dict(f)
    out["timing"] = json.loads(str(out["timing"]))
    return out


def _summary_text(device: str, max_ranks: int) -> str:
    where = ("ranks are host processes on gloo, one torch thread each, so "
             "the figures measure the host" if device == "cpu" else
             "one rank a CUDA card on NCCL" if max_ranks > 1 else
             "one CUDA card, a world of one, so nothing scales")
    return f"weak-scaling efficiency vs 1 device ({where})"


def run_scaling(n_gauss: int = 5000, rays_per_device: int = 4096,
                iters: int = 3, ranks: Optional[int] = None,
                device=None) -> dict:
    """The scaling run on ``device`` (None: the CUDA card, one rank a card
    up to every card; "cpu": gloo ranks up to ``ranks``, default 4).
    Returns the output lines (``lines``), the ray-dp images by world size
    (``images``, numpy) and the ring's image (``ring_image``) where the
    ring ran."""
    kind = resolve_device(device).type
    if kind == "cuda":
        max_ranks = torch.cuda.device_count()
        why = (f"this machine has {max_ranks} CUDA card(s), and NCCL puts no "
               "two ranks on one card")
    else:
        max_ranks = 4 if ranks is None else ranks
        why = f"this run has {max_ranks} (--ranks)"
    lines, images, ring_image = [], {}, None
    say = lines.append
    results = []
    for nd in WORLD_SIZES:
        if nd > max_ranks:
            say(dict(mode="ray-dp", devices=nd,
                     skipped=f"needs {nd} ranks; {why}"))
            continue
        out = spawn_world(nd, kind, n_gauss, rays_per_device, iters,
                          nd == RING_RANKS)
        images[nd] = out["image"]
        t = out["timing"]
        results.append(dict(mode="ray-dp", devices=nd,
                            rays_per_s=round(t["rays_per_s"]),
                            rays_per_s_per_device=round(
                                t["rays_per_s_per_device"])))
        say(results[-1])
        if "ring_image" in out:
            ring_image = out["ring_image"]
            say(dict(mode="gauss-ring", devices=RING_RANKS,
                     functional_ok=bool(out["ring_ok"])))
    if ring_image is None:
        say(dict(mode="gauss-ring", devices=RING_RANKS,
                 skipped=f"needs {RING_RANKS} ranks; {why}"))
    base = results[0]["rays_per_s_per_device"]
    say(dict(summary=_summary_text(kind, max_ranks),
             efficiencies={r["devices"]: r["rays_per_s_per_device"] / base
                           for r in results}))
    return dict(lines=lines, images=images, ring_image=ring_image)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device type (default: the CUDA card)")
    parser.add_argument("--ranks", type=int, default=None,
                        help="the most ranks on the CPU (default 4); on "
                        "the card, one rank a card")
    args = parser.parse_args(argv)
    env = os.environ.get
    result = run_scaling(
        n_gauss=int(env("GSPT_SCALE_N", 5000)),
        rays_per_device=int(env("GSPT_SCALE_RAYS", 4096)),
        iters=int(env("GSPT_SCALE_ITERS", 3)), ranks=args.ranks,
        device=args.device)
    for line in result["lines"]:
        print(json.dumps(line), flush=True)
    return result


if __name__ == "__main__":
    main()
