"""Trace backends for the path tracer.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/pipeline.py``
(``AUTO_DENSE_LIMIT``, ``make_trace_backend``). A backend is a
:class:`TraceBackend`: an explicit pair of calls the bounce loop makes, in
place of the reference's signature inspection of bare callables. The port
has the dense backend; "grid" (and "auto" above ``AUTO_DENSE_LIMIT``
Gaussians) and "spatial" come with later slices and raise until then.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref

AUTO_DENSE_LIMIT = 50_000


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
    """

    trace: Callable
    visibility: Callable


def _dense_vis(scene: GaussianScene, settings: RenderSettings, origins,
               dirs, t_end, active=None):
    return ref.visibility_dense(scene, origins, dirs, t_end, settings,
                                active), 0


def make_trace_backend(scene: GaussianScene, settings: RenderSettings,
                       backend: str = "auto") -> TraceBackend:
    """The TraceBackend named ``backend`` for ``scene``: "dense", or
    "auto" (dense up to AUTO_DENSE_LIMIT Gaussians)."""
    if backend == "auto":
        backend = "dense" if scene.num_gaussians <= AUTO_DENSE_LIMIT \
            else "grid"
    if backend == "dense":
        return TraceBackend(
            trace=ref.trace_dense,
            visibility=functools.partial(_dense_vis, scene, settings))
    if backend == "grid":
        raise NotImplementedError(
            f"backend 'grid' (what 'auto' takes above {AUTO_DENSE_LIMIT} "
            f"Gaussians; this scene has {scene.num_gaussians}) is not "
            "ported yet: the grid marcher is slice C of the port")
    if backend == "spatial":
        raise NotImplementedError(
            "backend 'spatial' is not ported yet: it waits for the grid "
            "marcher (slice C) and the multi-GPU slab ring (slice F)")
    raise ValueError(f"unknown backend '{backend}'")
