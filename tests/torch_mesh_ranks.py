"""Spawned gloo ranks for the port's mesh tests (no JAX in here).

A test module's fixture writes its inputs as numpy arrays, then
:func:`spawn` starts ``world`` processes that join one gloo group on a
file store (``parallel.mesh.initialize_multihost(init_method="file://...")``),
run one of this module's rank programs over every case, and leave the
gathered results, as numpy arrays, in ``outputs.npz``; the tests compare
those with the JAX package. Each rank runs torch on one thread, tears its
group down in ``finally``, and the spawn as a whole has a deadline: a hung
rank fails the fixture instead of hanging the suite.
"""
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pathtracer_gaussiansplatting_tpu_torch.core import rng
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, Rays, RenderSettings, scene_from_numpy,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import SceneParams
from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
from pathtracer_gaussiansplatting_tpu_torch.parallel import shard, spatial
from pathtracer_gaussiansplatting_tpu_torch.parallel import train
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import pathtrace
from pathtracer_gaussiansplatting_tpu_torch.render.pipeline import (
    make_trace_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger

CPU = "cpu"
WORLD = 4
SPAWN_TIMEOUT_S = 240.0


def save_inputs(io_dir, **arrays):
    np.savez(os.path.join(io_dir, "inputs.npz"), **arrays)


def scene_arrays(prefix: str, scene) -> dict:
    """A JAX scene's fields as inputs under ``prefix/``."""
    return {f"{prefix}/{f}": np.asarray(getattr(scene, f))
            for f in SCENE_FIELDS}


def spawn(program: str, io_dir, world: int = WORLD,
          timeout: float = SPAWN_TIMEOUT_S) -> dict:
    """Run ``program`` (a rank program of this module, by name) on
    ``world`` spawned gloo ranks; returns rank 0's outputs. Raises if a
    rank fails or the deadline passes (the ranks are then killed)."""
    ctx = mp.start_processes(_rank_main, args=(world, program, str(io_dir)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{program}: ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    with np.load(os.path.join(io_dir, "outputs.npz")) as f:
        return dict(f)


def _rank_main(rank: int, world: int, program: str, io_dir: str):
    torch.set_num_threads(1)
    pm.initialize_multihost(
        init_method="file://" + os.path.join(io_dir, "store"),
        num_processes=world, process_id=rank, device=CPU)
    with np.load(os.path.join(io_dir, "inputs.npz")) as f:
        inputs = dict(f)
    out = {}
    try:
        globals()[program](inputs, out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        # Single-process parts: the default world-size-1 rendezvous.
        globals()[program + "_world1"](inputs, out)
        np.savez(os.path.join(io_dir, "outputs.npz"), **out)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _scene(inputs, prefix):
    return scene_from_numpy({f: inputs[f"{prefix}/{f}"]
                             for f in SCENE_FIELDS}, CPU)


def _rays(inputs, prefix="rays"):
    return Rays(torch.from_numpy(inputs[prefix + "_o"]),
                torch.from_numpy(inputs[prefix + "_d"]))


def _grad_of(x: torch.Tensor):
    """``x`` as a leaf that requires grad."""
    return x.detach().clone().requires_grad_(True)


def _share(out: torch.Tensor, total: int) -> torch.Tensor:
    """This rank's share of mean(out ** 2) over ``total`` elements."""
    return torch.sum(out ** 2) / total


# ---- parallel/mesh.py, shard.py, train.py --------------------------------

PAR_SETTINGS = dict(max_contribs=32, background=(0.1, 0.2, 0.3))
TRAIN_LR, FIT_STEPS, FIT_LR = 2e-2, 3, 5e-2


def parallel_cases(inputs, out):
    scene, rays = _scene(inputs, "scene"), _rays(inputs)
    settings = RenderSettings(**PAR_SETTINGS)
    total = rays.num_rays * 3
    try:
        pm.make_mesh((3, 1), device=CPU)
        out["bad_shape"] = np.asarray("no error")
    except ValueError as e:
        out["bad_shape"] = np.asarray(str(e))

    mesh = pm.make_mesh((4, 1), device=CPU)
    means = _grad_of(scene.means)
    img = shard.render_dense_ray_sharded(scene.replace(means=means), rays,
                                         settings, mesh)
    _share(img, total).backward()
    out["dense"] = _np(pm.gather_rays(img.detach(), mesh))
    out["dense_grad"] = _np(means.grad)

    for shape in ((2, 2), (1, 4)):
        mesh = pm.make_mesh(shape, device=CPU)
        block = pm.shard_scene(pm.pad_to_multiple(scene, shape[1]), mesh)
        means = _grad_of(block.means)
        img = shard.ring_topk_radiance(block.replace(means=means),
                                       pm.shard_rays(rays, mesh), settings,
                                       mesh)
        _share(img, total).backward()
        tag = f"ring_{shape[0]}x{shape[1]}"
        out[tag] = _np(pm.gather_rays(img.detach(), mesh))
        out[tag + "_grad"] = _np(pm.gather_rays(means.grad, mesh,
                                                pm.gauss_sharding(mesh)))

    mesh = pm.make_mesh((4, 1), device=CPU)
    tscene = _scene(inputs, "train")
    target = torch.from_numpy(inputs["target"])
    params = SceneParams.from_scene(tscene)
    opt = train.make_optimizer(TRAIN_LR)
    opt_state = opt(params.parameters())
    step = train.make_train_step(settings, opt, mesh=mesh)
    params, opt_state, loss = step(params, opt_state,
                                   pm.shard_rays(rays, mesh),
                                   pm.shard_rays(target, mesh))
    out["train_loss"] = _np(loss)
    for f, p in params.named_parameters():
        out[f"train_grad/{f}"] = _np(torch.zeros_like(p) if p.grad is None
                                     else p.grad)
        out[f"train_scene/{f}"] = _np(p)
    _, losses = train.fit_scene(tscene, rays, target, settings,
                                steps=FIT_STEPS, lr=FIT_LR, mesh=mesh)
    out["fit_losses"] = np.asarray(losses)


def parallel_cases_world1(inputs, out):
    """initialize_multihost with no rendezvous: a world of one."""
    rank = pm.initialize_multihost(device=CPU)
    try:
        out["world1"] = np.asarray([rank, dist.get_world_size(),
                                    pm.make_mesh(device=CPU).size()])
    finally:
        dist.destroy_process_group()


# ---- parallel/spatial.py and the "spatial" backend ------------------------

def _spatial_run(scene, rays, settings, shape, n_slabs=None):
    """(mesh, this rank's slab, its rays) of ``scene`` on a mesh."""
    mesh = pm.make_mesh(shape, device=CPU)
    slabbed, _ = spatial.partition_slabs(scene, n_slabs or shape[1])
    layout = spatial.spatial_sharding(mesh)
    return mesh, slabbed, pm.shard_scene(slabbed, mesh), \
        pm.shard_rays(rays, mesh, layout)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def spatial_cases(inputs, out):
    scene, mixed = _scene(inputs, "scene"), _rays(inputs, "mixed")
    n = scene.num_gaussians
    settings = RenderSettings(max_contribs=n, background=(0.1, 0.2, 0.3))
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh, _, block, rays = _spatial_run(scene, mixed, settings, shape)
        with torch.no_grad():
            img = spatial.render_spatial(block, rays, settings, mesh)
        out[f"render_{shape[0]}x{shape[1]}"] = _np(pm.gather_rays(
            img, mesh, spatial.spatial_sharding(mesh)))

    # render_spatial's gradients to the means at (2, 2).
    gscene, grays = _scene(inputs, "grad"), _rays(inputs, "grad")
    gsettings = RenderSettings(max_contribs=96, background=(0.1, 0.2, 0.3))
    mesh, _, block, rays = _spatial_run(gscene, grays, gsettings, (2, 2))
    means = _grad_of(block.means)
    img = spatial.render_spatial(block.replace(means=means), rays, gsettings,
                                 mesh)
    _share(img, grays.num_rays * 3).backward()
    layout = spatial.spatial_sharding(mesh)
    out["grad_render"] = _np(pm.gather_rays(img.detach(), mesh, layout))
    out["grad_means"] = _np(pm.gather_rays(means.grad, mesh,
                                           pm.gauss_sharding(mesh)))

    # trace and visibility, dense slabs and grid slabs, at (1, 4).
    tscene, trays = _scene(inputs, "trace"), _rays(inputs, "trace")
    tsettings = RenderSettings(max_contribs=tscene.num_gaussians)
    mesh, slabbed, block, rays = _spatial_run(tscene, trays, tsettings,
                                              (1, 4))
    layout = spatial.spatial_sharding(mesh)
    t_end = pm.shard_rays(torch.from_numpy(inputs["t_end"]), mesh, layout)
    with torch.no_grad():
        inter = spatial.trace_spatial(block, rays, tsettings, mesh)
        vis = spatial.visibility_spatial(block, rays.origins, rays.directions,
                                         t_end, tsettings, mesh)
    for k, v in inter.items():
        out[f"trace/{k}"] = _np(pm.gather_rays(v, mesh, layout))
    out["vis"] = _np(pm.gather_rays(vis, mesh, layout))

    cscene, crays = _scene(inputs, "grid"), _rays(inputs, "grid")
    csettings = RenderSettings(max_contribs=cscene.num_gaussians)
    mesh, slabbed, block, rays = _spatial_run(cscene, crays, csettings,
                                              (1, 4))
    tables, meta = spatial.build_slab_accels(slabbed, 4, max_per_cell=64,
                                             radius_percentile=100.0)
    local = pm.shard_scene(tables, mesh)
    t_end = pm.shard_rays(torch.from_numpy(inputs["grid_t_end"]), mesh,
                          layout)
    records = _Records()
    get_logger().addHandler(records)
    try:
        with torch.no_grad():
            dense = spatial.trace_spatial(block, rays, csettings, mesh)
            grid = spatial.trace_spatial(block, rays, csettings, mesh,
                                         slab_accel=local, accel_meta=meta,
                                         max_steps=256)
            gvis, gfrozen = spatial.visibility_spatial(
                block, rays.origins, rays.directions, t_end, csettings,
                mesh, slab_accel=local, accel_meta=meta, max_steps=256,
                return_frozen=True)
            quiet = len(records.messages)
            short = spatial.trace_spatial(
                block, rays, csettings, mesh, slab_accel=local,
                accel_meta=meta, max_steps=inputs["short_steps"].item())
    finally:
        get_logger().removeHandler(records)
    for tag, res in (("dense", dense), ("grid", grid), ("short", short)):
        for k in ("trans", "albedo", "depth", "alpha_acc", "normal"):
            out[f"{tag}/{k}"] = _np(pm.gather_rays(res[k], mesh, layout))
    for tag, count in (("grid", grid["frozen_alive"]), ("gvis", gfrozen),
                       ("short", short["frozen_alive"])):
        total = count.reshape(1).clone()
        dist.all_reduce(total)
        out[f"frozen/{tag}"] = _np(total)
    out["gvis"] = _np(pm.gather_rays(gvis, mesh, layout))
    out["warnings_quiet"] = np.asarray(quiet)
    out["warnings"] = np.asarray(records.messages[quiet:])

    # The grid slabs need one slab a rank.
    tables8, meta8 = spatial.build_slab_accels(
        spatial.partition_slabs(cscene, 8)[0], 8, max_per_cell=64,
        radius_percentile=100.0)
    try:
        spatial.trace_spatial(block, rays, csettings, mesh,
                              slab_accel=pm.shard_scene(tables8, mesh),
                              accel_meta=meta8)
        out["guard"] = np.asarray("no error")
    except ValueError as e:
        out["guard"] = np.asarray(str(e))

    # The bounce loop through the "spatial" backend at (2, 2).
    pscene, prays = _scene(inputs, "pt"), _rays(inputs, "pt")
    psettings = RenderSettings(max_depth=2, max_contribs=pscene.num_gaussians,
                               ambient=(0.05, 0.05, 0.08, 1.0))
    mesh = pm.make_mesh((2, 2), device=CPU)
    slabbed, _ = spatial.partition_slabs(pscene, 2)
    backend = make_trace_backend(slabbed, psettings, "spatial", accel=mesh)
    out["pathtrace"] = _np(pathtrace(slabbed, prays, psettings,
                                     rng.prng_key(3), backend=backend))


def spatial_cases_world1(inputs, out):
    """render_spatial's gradients with the whole scene in one slab, on a
    world of one: the oracle of the (2, 2) ring's."""
    pm.initialize_multihost(device=CPU)
    try:
        gscene, grays = _scene(inputs, "grad"), _rays(inputs, "grad")
        gsettings = RenderSettings(max_contribs=96,
                                   background=(0.1, 0.2, 0.3))
        mesh, _, block, rays = _spatial_run(gscene, grays, gsettings, (1, 1))
        means = _grad_of(block.means)
        img = spatial.render_spatial(block.replace(means=means), rays,
                                     gsettings, mesh)
        _share(img, grays.num_rays * 3).backward()
        out["grad_render_1"] = _np(img)
        out["grad_means_1"] = _np(means.grad)
    finally:
        dist.destroy_process_group()
