"""Grid march kernel wrapper: ``csrc/grid_march.cu`` on CUDA tensors.

Counterpart of the march of
``pathtracer_gaussiansplatting_tpu/render/grid_trace.py`` (``trace_grid``
:1060 and ``visibility_grid`` :1109, plain XLA there, not Pallas).
:func:`march_kernel` launches ``ptgs_grid_trace`` (features into the 15
sums of ``render.grid_trace.ACC_KEYS``, counted in ``launch.launches``
under "grid_trace") or ``ptgs_grid_visibility`` (geometry only, shadow
segments, under "grid_visibility"); above ``REG_KC`` slots a cell the
kernel's wide instantiation runs instead, under "grid_trace_wide" and
"grid_visibility_wide". It bounds each cell's work by the slots the cell
holds (``GridAccel.fill``): a feature trace's cell of at most 64 slots on
the register walk, a fuller one in shared memory sized by the table's
largest fill, a segment's cell in passes of its lanes. The dispatch, and
the plain march that CPU tensors run, are ``render.grid_trace.march``
and ``march_plain``; this module imports nothing of ``render``.

The kernel runs L lanes per ray (a warp for a trace, half a warp for a
shadow segment) through the same per-round state machine as the plain
march: every lane walks the ray's traversal, and a cell's Kc Gaussians are
spread across the lanes (lane l takes slots l, l + L, ...), with the cell
transmittance and the weights taken in a serial march's operand order;
each lane keeps partial feature sums, added once per ray.
It leaves out the batch-level schedule, by choice: the exit fractions and
the compaction capacity (properties of the whole batch, a TPU scheduling
device) do not apply, so a ray the plain march pauses early gets its kill
checks at other cell counts (a difference of at most transmittance_min
times its remaining contributions), and a ray the plain march freezes for
capacity is finished. Its frozen count is at most the plain march's; on a
schedule without exit fractions, at capacity 1, it follows the plain march
ray for ray (ROADMAP section 3).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch

N_SUMS = 15         # the per-ray sums of a feature trace
MAX_ROUNDS = 8      # rounds the kernel's schedule holds
REG_KC = 128        # max_per_cell up to which a lane's slots are registers


def march_kernel(accel, origins: torch.Tensor, dirs: torch.Tensor,
                 settings: RenderSettings, rounds,
                 t_end: Optional[torch.Tensor] = None,
                 with_features: bool = True,
                 active: Optional[torch.Tensor] = None):
    """Launch the march kernel on CUDA tensors: (trans (R,), sums (R, 15)
    or None, frozen (R,) bool). ``accel`` is a ``render.grid_trace.
    GridAccel``; ``rounds`` the clipped schedule's (frac, M, a_max, a_exit)
    entries, of which the kernel reads M and a_max (see the module
    docstring). CPU tensors raise: they go to the plain march."""
    tensors = dict(origins=origins, dirs=dirs, btab=accel.btab,
                   geom=accel.geom, packet=accel.packet, fill=accel.fill,
                   lo=accel.lo, hi=accel.hi)
    if t_end is not None:
        tensors["t_end"] = t_end
    if active is not None:
        tensors["active"] = active
    if launch.on_cpu("grid_march", tensors):
        raise ValueError("grid_march: CPU tensors run the plain march, "
                         "render.grid_trace.march_plain")
    # Rays may arrive as expanded views (one camera origin for all).
    origins, dirs = origins.contiguous(), dirs.contiguous()
    t_end = None if t_end is None else t_end.contiguous()
    tensors.update(origins=origins, dirs=dirs)
    if t_end is not None:
        tensors["t_end"] = t_end
    r = origins.shape[0]
    # The cell tables' shapes follow the accel; the rays' and fill's are set.
    launch.check("grid_march", tensors, dict(
        {key: x.shape for key, x in tensors.items()}, origins=(r, 3),
        dirs=(r, 3), t_end=(r,), active=(r,), fill=accel.geom.shape[:1]),
        dtypes=dict(active=torch.bool, btab=torch.int32, fill=torch.int32))
    kc = accel.max_per_cell
    # The wide instantiation's shared region: slots of the fullest cell.
    wide_slots = accel.max_fill if kc > REG_KC else 0
    if len(rounds) > MAX_ROUNDS:
        raise ValueError(f"grid_march: {len(rounds)} rounds, at most "
                         f"{MAX_ROUNDS}")
    sched = (ctypes.c_int * (2 * MAX_ROUNDS))(
        *[v for _, m, a_max, _ in rounds for v in (m, a_max)])
    dev = origins.device
    trans = torch.empty((r,), dtype=torch.float32, device=dev)
    acc = torch.empty((r, N_SUMS), dtype=torch.float32,
                      device=dev) if with_features else None
    frozen = torch.empty((r,), dtype=torch.bool, device=dev)
    if r == 0:
        return trans, acc, frozen
    table = accel.packet if with_features else accel.geom
    cols = table.shape[1] // kc
    kernel = "grid_trace" if with_features else "grid_visibility"
    gx, gy, gz = accel.dims
    launch.launch(
        "grid_march", f"ptgs_{kernel}", origins.data_ptr(), dirs.data_ptr(),
        launch.ptr(t_end), launch.ptr(active), accel.btab.data_ptr(),
        table.data_ptr(), accel.fill.data_ptr(), accel.lo.data_ptr(),
        accel.hi.data_ptr(), ctypes.addressof(sched), trans.data_ptr(),
        launch.ptr(acc), frozen.data_ptr(), r, len(rounds), gx, gy, gz, kc,
        cols, wide_slots, settings.t_min, settings.t_max, settings.alpha_min,
        settings.alpha_max,
        math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut),
        settings.transmittance_min, accel.jump_unit, device=dev,
        count=kernel + ("_wide" if kc > REG_KC else ""))
    return trans, acc, frozen
