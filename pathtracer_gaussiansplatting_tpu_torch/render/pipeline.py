"""Trace backends for the path tracer.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/pipeline.py``
(``AUTO_DENSE_LIMIT``, ``make_trace_backend``). A backend is a
:class:`TraceBackend`: an explicit pair of calls the bounce loop makes, in
place of the reference's signature inspection of bare callables. The port
has the dense backend and the grid backend ("auto" takes grid above
``AUTO_DENSE_LIMIT`` Gaussians); "spatial" comes with a later slice and
raises until then.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref

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
    name: "dense" or "grid"; accel: the grid backend's GridAccel (None
      for dense), whose ``stats`` report the binning's truncation.
    """

    trace: Callable
    visibility: Callable
    name: str = "dense"
    accel: Optional[grid_trace.GridAccel] = None


def _geometry_versions(scene: GaussianScene) -> tuple:
    return tuple(x._version for x in (scene.means, scene.log_scales,
                                      scene.quats, scene.opacity_logits))


class _DenseTableCache:
    """The dense kernels' table (``dense_trace.dense_table`` of
    ``gaussian_table``), built once for the backend's scene and settings.
    ``get`` hands it out only for that scene object, unchanged in place
    since, and the same sigma_cut and alpha_min, and not where autograd
    wants the geometry (the cached table carries no gradient); else None,
    counted in ``TABLE_MISSES``, and the call builds its own."""

    def __init__(self, scene: GaussianScene, settings: RenderSettings):
        self.scene, self.versions = scene, _geometry_versions(scene)
        self.key = (settings.sigma_cut, settings.alpha_min)
        with torch.no_grad():
            self.table = dense_trace.dense_table(
                dense_trace.gaussian_table(scene, settings))

    def get(self, scene: GaussianScene, settings: RenderSettings):
        global TABLE_MISSES
        fresh = (scene is self.scene
                 and (settings.sigma_cut, settings.alpha_min) == self.key
                 and _geometry_versions(scene) == self.versions)
        if fresh and not ref._geometry_needs_grad(scene):
            return self.table
        TABLE_MISSES += 1
        return None


def _dense_trace(cache: _DenseTableCache, scene: GaussianScene, rays,
                 settings: RenderSettings, active=None):
    return ref.trace_dense(scene, rays, settings, active=active,
                           table=cache.get(scene, settings))


def _dense_vis(cache: _DenseTableCache, scene: GaussianScene,
               settings: RenderSettings, origins, dirs, t_end, active=None):
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


def make_trace_backend(scene: GaussianScene, settings: RenderSettings,
                       backend: str = "auto",
                       grid_dims: Optional[Tuple[int, int, int]] = None,
                       max_per_cell: int = 32, max_steps: int = 192,
                       accel: Optional[grid_trace.GridAccel] = None
                       ) -> TraceBackend:
    """The TraceBackend named ``backend`` for ``scene``: "dense", "grid",
    or "auto" (dense up to AUTO_DENSE_LIMIT Gaussians, else grid).

    The dense backend builds the dense kernels' table once here (it
    serves calls with this scene and settings). The grid backend builds
    its GridAccel once here (``grid_dims=None`` auto-fits the grid,
    ``max_per_cell`` Gaussians a cell) unless ``accel`` gives one, and
    marches at most ``max_steps`` occupied cells a ray; the defaults are
    the reference's.
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
        raise NotImplementedError(
            "backend 'spatial' is not ported yet: it waits for the "
            "multi-GPU slab ring (slice F)")
    raise ValueError(f"unknown backend '{backend}'")
