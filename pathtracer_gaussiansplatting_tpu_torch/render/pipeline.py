"""Trace backends for the path tracer.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/pipeline.py``
(``AUTO_DENSE_LIMIT``, ``make_trace_backend``, ``_spatial_trace``,
``_spatial_vis``). A backend is a :class:`TraceBackend`: an explicit pair
of calls the bounce loop makes, in place of the reference's signature
inspection of bare callables. Three backends: "dense", "grid" ("auto"
takes grid above ``AUTO_DENSE_LIMIT`` Gaussians) and "spatial", the slab
ring of ``parallel/spatial.py`` over a (rays, gauss) mesh. While a
``torch.profiler`` records, the dense backend's shadow rays (K2 and its
glue) are the range ``ptgs.dense_vis``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
from pathtracer_gaussiansplatting_tpu_torch.parallel import spatial
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref
from pathtracer_gaussiansplatting_tpu_torch.utils.profiling import span

AUTO_DENSE_LIMIT = 50_000
# Dense backend calls its table cache could not serve (each then builds
# the table itself); read by chip_smoke.py.
TABLE_MISSES = 0


@dataclasses.dataclass(frozen=True)
class TraceBackend:
    """What the bounce loop calls to trace.

    trace(scene, rays, settings, active=None) -> interaction dict (the
      keys of ``reference.trace_dense``); ``active`` (R,) bool marks the
      rays still alive, and a masked ray composites nothing.
    visibility(origins, dirs, t_end, active=None) -> (vis (R,), frozen):
      soft-shadow transmittance, 1 where ``active`` is false, and the
      number of shadow rays the backend stopped short (always 0 for the
      exact dense backend).
    name: "dense", "grid" or "spatial"; accel: the grid backend's
      GridAccel (None for the others), whose ``stats`` report the
      binning's truncation.
    """

    trace: Callable
    visibility: Callable
    name: str = "dense"
    accel: Optional[grid_trace.GridAccel] = None


def _geometry_versions(scene: GaussianScene) -> tuple:
    return tuple(x._version for x in (scene.means, scene.log_scales,
                                      scene.quats, scene.opacity_logits))


def _scene_versions(scene: GaussianScene) -> tuple:
    return tuple(getattr(scene, f)._version for f in SCENE_FIELDS)


class _DenseTableCache:
    """The dense kernels' table (``dense_trace.dense_table`` of
    ``gaussian_table``) and the composite kernel's feature table
    (``dense_trace.composite_table``), built once for the backend's scene
    and settings. ``get`` hands the first out only for that scene object,
    its geometry unchanged in place since, and the same sigma_cut and
    alpha_min, and not where autograd wants the geometry (the cached table
    carries no gradient); ``features`` hands the second out only for that
    scene object, no leaf changed in place since (SH, emission and
    materials included), and the same SH degree. Else each returns None,
    counted in ``TABLE_MISSES``, and the call builds its own."""

    def __init__(self, scene: GaussianScene, settings: RenderSettings):
        self.scene, self.versions = scene, _geometry_versions(scene)
        self.key = (settings.sigma_cut, settings.alpha_min)
        self.all_versions = _scene_versions(scene)
        self.degree = dense_trace.composite_degree(scene, settings)
        with torch.no_grad():
            self.table = dense_trace.dense_table(
                dense_trace.gaussian_table(scene, settings))
        self.feature_table = dense_trace.composite_table(scene, self.degree)

    def get(self, scene: GaussianScene, settings: RenderSettings):
        global TABLE_MISSES
        fresh = (scene is self.scene
                 and (settings.sigma_cut, settings.alpha_min) == self.key
                 and _geometry_versions(scene) == self.versions)
        if fresh and not ref._geometry_needs_grad(scene):
            return self.table
        TABLE_MISSES += 1
        return None

    def features(self, scene: GaussianScene, settings: RenderSettings):
        global TABLE_MISSES
        if (scene is self.scene and _scene_versions(scene) == self.all_versions
                and dense_trace.composite_degree(scene, settings)
                == self.degree):
            return self.feature_table
        TABLE_MISSES += 1
        return None


def _dense_trace(cache: _DenseTableCache, scene: GaussianScene, rays,
                 settings: RenderSettings, active=None):
    features = cache.features(scene, settings) \
        if ref.composite_on_card(scene, rays) else None
    return ref.trace_dense(scene, rays, settings, active=active,
                           table=cache.get(scene, settings),
                           features=features)


def _dense_vis(cache: _DenseTableCache, scene: GaussianScene,
               settings: RenderSettings, origins, dirs, t_end, active=None):
    with span("ptgs.dense_vis"):
        return ref.visibility_dense(scene, origins, dirs, t_end, settings,
                                    active, cache.get(scene, settings)), 0


def _grid_trace(accel, max_steps: int, scene: GaussianScene, rays,
                settings: RenderSettings, active=None):
    return grid_trace.trace_grid(scene, rays, settings, accel,
                                 max_steps=max_steps, active=active)


def _grid_vis(accel, max_steps: int, settings: RenderSettings, origins,
              dirs, t_end, active=None):
    return grid_trace.visibility_grid(None, accel, origins, dirs, t_end,
                                      settings, max_steps=max_steps,
                                      active=active, return_frozen=True)


def _spatial_trace(mesh, block: GaussianScene, scene: GaussianScene, rays,
                   settings: RenderSettings, active=None):
    """The whole batch's interaction through the slab ring: this rank's
    block of the batch (padded to split evenly) goes round the ring, and
    the blocks are gathered back. ``active`` is ignored, as in the
    reference: the slab composite is dense per slab."""
    del scene, active
    n = rays.num_rays
    padded = _pad_rays(mesh, rays.origins, rays.directions)
    layout = spatial.spatial_sharding(mesh)
    inter = spatial.trace_spatial(
        block, mesh_mod.shard_rays(Rays(*padded), mesh, layout), settings,
        mesh)
    return {k: v[:n] for k, v in
            mesh_mod.gather_rays(inter, mesh, layout).items()}


def _spatial_vis(mesh, block: GaussianScene, settings: RenderSettings,
                 origins, dirs, t_end, active=None):
    """The whole batch's shadow transmittance through the slab ring (as
    :func:`_spatial_trace`); 1 where ``active`` is false, and a frozen
    count of 0: the dense slabs are exact."""
    n = origins.shape[0]
    layout = spatial.spatial_sharding(mesh)
    o, d, t = (mesh_mod.shard_rays(x, mesh, layout)
               for x in _pad_rays(mesh, origins, dirs, t_end))
    vis = mesh_mod.gather_rays(spatial.visibility_spatial(
        block, o, d, t, settings, mesh), mesh, layout)[:n]
    if active is not None:
        vis = torch.where(active, vis, 1.0)
    return vis, 0


def _pad_rays(mesh, *arrays):
    """The per-ray arrays padded to a multiple of the mesh's ranks with
    copies of their first row (cut off again after the gather)."""
    pad = -arrays[0].shape[0] % mesh.size()
    return tuple(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                 for x in arrays)


def make_trace_backend(scene: GaussianScene, settings: RenderSettings,
                       backend: str = "auto",
                       grid_dims: Optional[Tuple[int, int, int]] = None,
                       max_per_cell: int = 32, max_steps: int = 192,
                       accel=None) -> TraceBackend:
    """The TraceBackend named ``backend`` for ``scene``: "dense", "grid",
    "auto" (dense up to AUTO_DENSE_LIMIT Gaussians, else grid) or
    "spatial".

    The dense backend builds the dense kernels' table once here (it
    serves calls with this scene and settings). The grid backend builds
    its GridAccel once here (``grid_dims=None`` auto-fits the grid,
    ``max_per_cell`` Gaussians a cell) unless ``accel`` gives one, and
    marches at most ``max_steps`` occupied cells a ray; the defaults are
    the reference's.

    "spatial" takes the mesh in the ``accel`` slot (``parallel.mesh
    .make_mesh``) and ``scene`` as ``parallel.spatial.partition_slabs``
    returns it, whole, on every rank; it keeps the rank's slab
    (``mesh.shard_scene``). Its calls take and return the whole batch on
    every rank, as the reference's global arrays: each rank traces its
    block of the batch (``spatial.spatial_sharding``) around the ring and
    the blocks are gathered back, so the bounce loop runs unchanged and
    draws the same random numbers for every ray.
    """
    if backend == "auto":
        backend = "dense" if scene.num_gaussians <= AUTO_DENSE_LIMIT \
            else "grid"
    if backend == "dense":
        cache = _DenseTableCache(scene, settings)
        return TraceBackend(
            trace=functools.partial(_dense_trace, cache),
            visibility=functools.partial(_dense_vis, cache, scene, settings))
    if backend == "grid":
        if accel is None:
            accel = grid_trace.build_grid_accel(scene, dims=grid_dims,
                                                max_per_cell=max_per_cell)
        return TraceBackend(
            trace=functools.partial(_grid_trace, accel, max_steps),
            visibility=functools.partial(_grid_vis, accel, max_steps,
                                         settings),
            name="grid", accel=accel)
    if backend == "spatial":
        mesh = accel  # the mesh rides the accel slot
        if mesh is None:
            raise ValueError("backend='spatial' needs accel=<mesh>")
        block = mesh_mod.shard_scene(scene, mesh)
        return TraceBackend(
            trace=functools.partial(_spatial_trace, mesh, block),
            visibility=functools.partial(_spatial_vis, mesh, block,
                                         settings),
            name="spatial")
    raise ValueError(f"unknown backend '{backend}'")
