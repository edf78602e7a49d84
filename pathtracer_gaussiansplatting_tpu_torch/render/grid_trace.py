"""Uniform-grid ray marching: the scalable trace backend for bounce and
shadow rays.

Counterpart of ``pathtracer_gaussiansplatting_tpu/render/grid_trace.py``:
the layout constants, ``GridAccel``, ``_geometry_table``, ``_packet_table``,
``_aniso_extents``, ``fit_grid``, ``_block_jump_table``,
``build_grid_accel``, the march (``_ray_setup``, ``_ordered_weights``,
``_phase_a``, ``_phase_b``, ``_march_round``, ``_sort_key``, ``_march``),
``trace_grid`` and ``visibility_grid``.

The grid is built once per scene: the host bins every Gaussian's 3-sigma
box into cells (``csrc/grid_bin.cpp``, g++), and the tables go to the
scene's device. A (B, 4) int32 block table over 4x4x4-cell blocks carries
each block's 64-bit occupancy mask, the slot of its first occupied cell
and the tight box of its set cells, or, for an empty block, a safe
euclidean jump; a flat (S, cols * Kc) float32 table per occupied cell
carries the Kc Gaussians of the cell, column-major (column c at
[c * Kc, (c + 1) * Kc)), its first ``fill`` slots filled and the rest zero.

``march_plain`` is the reference's march in plain torch, round by round:
phase A walks the block table and records each ray's next <= M occupied
cells, phase B composites them in slot groups of 8 (slab-owned peaks,
within-cell (t, slot) order) and kills a ray once its transmittance is at
or below ``transmittance_min``; batches above ``compact_min`` rays sort
the survivors between rounds and resume only the first ``cap``, and rays
still alive when the schedule ends are frozen and counted. It keeps every
piece that decides a result (the schedule, the batch-level exit fractions,
the compaction capacity, the slot groups) and drops what only bounded TPU
memory or dispatch (the sub-batch unroll, the phase-B byte budget and its
environment knobs); phase B is chunked over rays only to bound memory,
which changes no value. It is what the CPU tests hold to the JAX package.

``trace_grid`` and ``visibility_grid`` go through :func:`march`: CUDA
tensors launch the hand-written kernel (``kernels/grid_march``, a warp or
half of one per ray, without the batch-level exit fractions and
compaction), CPU tensors run ``march_plain``. Inference only: nothing here
is differentiable, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import grid_march, launch
from pathtracer_gaussiansplatting_tpu_torch.ops.gaussians import surfel_normal
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import rotmat_cols
from pathtracer_gaussiansplatting_tpu_torch.ops.safe_math import (
    safe_normalize,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger

# Geometry-only table columns (shadow marches).
G_OPAC = 9              # [q00, q11, q22, q01, q02, q12, mean (3), opacity]
GEOM_COLS = 12          # 2 pad columns
# Fused packet columns (interaction traces):
#   [q6(0:6), mean(6:9), opac(9), dc(10:13), emi(13:16), met(16),
#    rough(17), cc(18), ccr(19), trn(20), axis(21:24)]
# deg-1 scenes append [by(24:27), bz(27:30), bx(30:33)] + 7 pad -> 40.
PKT_COLS_DEG0 = 24
PKT_COLS_DEG1 = 40
P_DC, P_EMI, P_MET, P_ROUGH = 10, 13, 16, 17
P_CC, P_CCR, P_TRN, P_AXIS, P_BY = 18, 19, 20, 21, 24

# Fixed-point unit of the empty-block jump distance, in fractions of the
# smallest cell edge.
JUMP_FP = 4.0

# The 15 per-ray sums an interaction trace accumulates.
ACC_KEYS = ("col_r", "col_g", "col_b", "emi_r", "emi_g", "emi_b",
            "met", "rough", "cc", "ccr", "trn", "nx", "ny", "nz", "tsum")
assert len(ACC_KEYS) == grid_march.N_SUMS

# Round schedule: (capacity fraction of R, slots M, phase-A iteration
# budget, A exit fraction, B exit fraction). Round 0 runs full width; later
# rounds resume the survivors at a shrinking capacity. The exit fraction
# stops phase A once that share of the batch is still probing (stragglers
# pause and resume in the next round); the last round runs to completion.
DEFAULT_SCHEDULE = ((1.0, 8, 64, 0.05, 0.10),
                    (0.25, 16, 96, 0.02, 0.05),
                    (0.0625, 32, 160, 0.005, 0.01),
                    (0.015625, 64, 320, 0.0, 0.0))
COMPACT_MIN_RAYS = 32768  # at or below: one batch, no sorting
SLOT_GROUP = 8            # phase B kills saturated rays after each group
PLAIN_CHUNK_ELEMS = 1 << 24  # (ray, slot, Kc, Kc) elements per phase-B chunk
# march_plain's probe counts by what a ray-at-a-time march does for them:
# probes of an empty block, probes whose occupied block's sub-box the ray
# misses, probes that step through the sub-box and then leave it (a block
# exit), and the in-block steps entered and taken (a step ends the walk at
# the first that changes nothing).
PROBE_STAT_KEYS = ("probes_empty", "probes_missed", "block_exits",
                   "step_checks", "steps")

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridAccel:
    """Uniform-grid acceleration structure (tensors on the scene's device).

    ``btab`` (B, 4) int32 block rows [info, base, mask_lo, mask_hi]: info >= 0
    marks an occupied block (mask = 64-bit cell occupancy, base = slot of
    its first occupied cell, info packs the tight box of the set cells as
    six 2-bit fields [xmin, xmax, ymin, ymax, zmin, zmax]); info < 0 encodes
    an empty block's safe euclidean jump as -(1 + round(jump / jump_unit)).
    ``geom`` (S, 12 Kc) and ``packet`` (S, cols Kc) float32, column c at
    [c Kc, (c + 1) Kc). ``fill`` (S,) int32: each row's filled slots,
    min(count, Kc); the binning fills a cell's slots as a prefix, so every
    slot at or past ``fill`` is zero in both tables (the march kernels
    bound a cell's work by it; the plain march does not read it).
    ``stats`` records binning truncation.
    """

    btab: torch.Tensor
    geom: torch.Tensor
    packet: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    dims: Tuple[int, int, int]
    fill: torch.Tensor
    jump_unit: float = 1.0
    stats: tuple = ()

    @property
    def max_per_cell(self) -> int:
        return self.geom.shape[1] // GEOM_COLS

    @functools.cached_property
    def max_fill(self) -> int:
        """The largest fill of the table (read from the device once)."""
        return int(self.fill.max())

    @property
    def pkt_cols(self) -> int:
        return self.packet.shape[1] // self.max_per_cell

    @property
    def block_dims(self) -> Tuple[int, int, int]:
        return tuple(-(-d // 4) for d in self.dims)

    @property
    def stats_dict(self) -> dict:
        return dict(self.stats)


def _geometry_table(scene: GaussianScene) -> torch.Tensor:
    """(N, 12) geometry rows: Q = R diag(exp(-2 log_s)) R^T upper triangle,
    mean, opacity."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_cols(scene.quats)
    d0 = torch.exp(-2.0 * scene.log_scales[:, 0])
    d1 = torch.exp(-2.0 * scene.log_scales[:, 1])
    d2 = torch.exp(-2.0 * scene.log_scales[:, 2])
    cols = [
        r00 * r00 * d0 + r01 * r01 * d1 + r02 * r02 * d2,   # q00
        r10 * r10 * d0 + r11 * r11 * d1 + r12 * r12 * d2,   # q11
        r20 * r20 * d0 + r21 * r21 * d1 + r22 * r22 * d2,   # q22
        r00 * r10 * d0 + r01 * r11 * d1 + r02 * r12 * d2,   # q01
        r00 * r20 * d0 + r01 * r21 * d1 + r02 * r22 * d2,   # q02
        r10 * r20 * d0 + r11 * r21 * d1 + r12 * r22 * d2,   # q12
        scene.means[:, 0], scene.means[:, 1], scene.means[:, 2],
        scene.opacities,
    ]
    table = torch.stack(cols, dim=-1)
    return torch.nn.functional.pad(table, (0, GEOM_COLS - table.shape[-1]))


def _packet_table(scene: GaussianScene, geom: torch.Tensor) -> torch.Tensor:
    """(N, 24 or 40) fused geometry + feature rows (SH of degree <= 1,
    PBR scalars, surfel axis); see the layout constants."""
    sh = scene.sh_coeffs
    cols = [geom[:, :10], sh[:, 0, :] * sh_mod.SH_C0, scene.emission,
            scene.metallic[:, None], scene.roughness[:, None],
            scene.clearcoat[:, None], scene.clearcoat_roughness[:, None],
            scene.transmission[:, None],
            surfel_normal(scene.log_scales, scene.quats)]
    width = PKT_COLS_DEG0
    if sh.shape[1] >= 4:
        cols += [-sh_mod.SH_C1 * sh[:, 1, :], sh_mod.SH_C1 * sh[:, 2, :],
                 -sh_mod.SH_C1 * sh[:, 3, :]]
        width = PKT_COLS_DEG1
    table = torch.cat(cols, dim=-1)
    return torch.nn.functional.pad(table, (0, width - table.shape[-1]))


def _aniso_extents(scene: GaussianScene, sigma: float) -> np.ndarray:
    """(N, 3) per-world-axis half-extents of each Gaussian's sigma-sigma
    box: h_i = sigma * sqrt(sum_j R_ij^2 s_j^2) (numpy, on the host)."""
    cols = [c.detach().cpu().numpy().astype(np.float32)
            for c in rotmat_cols(scene.quats)]
    r = np.stack(cols, -1).reshape(-1, 3, 3)        # (N, 3, 3) rows=world
    s2 = np.exp(2.0 * scene.log_scales.detach().cpu().numpy()
                .astype(np.float32))
    return sigma * np.sqrt(np.einsum("nij,nj->ni", r * r, s2))


def fit_grid(scene: GaussianScene, sigma: float = 3.0,
             radius_percentile: float = 99.0, cell_scale: float = 1.5,
             max_dims: int = 192, min_dims: int = 4):
    """Grid bounds, dims and extent clamp from scene statistics: the cell
    edge is ``cell_scale`` x the median max-axis sigma, the extent clamp
    the ``radius_percentile`` of the max-axis half-extent. Returns (dims,
    cap, clamped extents, lo, hi, number clamped)."""
    centers = scene.means.detach().cpu().numpy().astype(np.float32)
    exts = _aniso_extents(scene, sigma)
    h_max = exts.max(-1)
    cap = float(np.percentile(h_max, radius_percentile))
    scale = np.minimum(1.0, cap / np.maximum(h_max, 1e-12))
    exts_eff = exts * scale[:, None]
    lo = (centers - exts_eff).min(0)
    hi = (centers + exts_eff).max(0)
    span = np.maximum(hi - lo, 1e-6)
    cell = max(cell_scale * float(np.median(h_max)) / sigma,
               float(span.max()) / max_dims)
    dims = np.clip(np.ceil(span / cell), min_dims, max_dims).astype(int)
    n_clamped = int((h_max > cap).sum())
    return (tuple(int(d) for d in dims), cap, exts_eff, lo, hi, n_clamped)


def _block_jump_table(occ_blocks: np.ndarray, bdims, block_size,
                      jump_unit: float) -> np.ndarray:
    """Fixed-point safe jump distance per empty block (0 for occupied):
    euclidean distance between block centers (per-axis sampling) minus one
    block diagonal."""
    bx, by, bz = bdims
    occ3 = occ_blocks.reshape(bz, by, bx)
    diag = float(np.linalg.norm(block_size))
    dist = distance_transform_edt(
        ~occ3, sampling=(block_size[2], block_size[1], block_size[0]))
    jump = np.maximum(dist - diag, 0.0)
    q = np.round(jump / jump_unit).astype(np.int64)
    return np.minimum(q, 2 ** 30).astype(np.int32).reshape(-1)


def build_grid_accel(scene: GaussianScene, dims=None, max_per_cell: int = 32,
                     sigma: float = 3.0, radius_percentile: float = 99.0,
                     memory_budget_bytes: float = 2.5e9,
                     bounds=None) -> GridAccel:
    """Bin the scene on the host (``csrc/grid_bin.cpp``) and build the
    tables on the scene's device.

    ``dims=None`` auto-fits dims and the extent clamp (:func:`fit_grid`)
    and re-bins coarser (up to 3 times, x0.7) while the occupied cells'
    rows would exceed ``memory_budget_bytes``. Truncation is measured and
    stored in ``stats``: the share of extent-clamped Gaussians, of
    insertions dropped by the per-cell capacity (lowest opacity evicted
    first) and of overflowing cells.
    """
    from pathtracer_gaussiansplatting_tpu_torch.csrc.grid_bin import (
        grid_bin_aniso,
    )

    if max_per_cell % 16:
        raise ValueError("max_per_cell must be a multiple of 16, got "
                         f"{max_per_cell}")
    dev = scene.means.device
    centers = scene.means.detach().cpu().numpy().astype(np.float32)
    auto = dims is None
    if auto:
        dims, cap, exts_eff, lo, hi, n_clamped = fit_grid(
            scene, sigma=sigma, radius_percentile=radius_percentile)
    else:
        dims = tuple(int(d) for d in dims)
        exts = _aniso_extents(scene, sigma)
        h_max = exts.max(-1)
        cap = float(np.percentile(h_max, radius_percentile))
        scale = np.minimum(1.0, cap / np.maximum(h_max, 1e-12))
        exts_eff = exts * scale[:, None]
        if bounds is not None:
            lo = np.asarray(bounds[0], np.float32)
            hi = np.asarray(bounds[1], np.float32)
        else:
            lo = (centers - exts_eff).min(0)
            hi = (centers + exts_eff).max(0)
        n_clamped = int((h_max > cap).sum())
    n = scene.num_gaussians
    deg1 = scene.sh_coeffs.shape[1] >= 4
    pkt_cols = PKT_COLS_DEG1 if deg1 else PKT_COLS_DEG0
    priority = scene.opacities.detach().cpu().numpy().astype(np.float32)
    row_bytes = max_per_cell * (GEOM_COLS + pkt_cols) * 4
    for _ in range(4):
        idx, cnt = grid_bin_aniso(centers, exts_eff, priority, dims, lo=lo,
                                  hi=hi, max_per_cell=max_per_cell)
        n_occ = int((cnt > 0).sum())
        if n_occ * row_bytes <= memory_budget_bytes or not auto \
                or max(dims) <= 8:
            break
        dims = tuple(max(4, int(d * 0.7)) for d in dims)
    dropped = int(np.maximum(cnt - max_per_cell, 0).sum())
    total = int(cnt.sum())
    occupied = np.nonzero(cnt > 0)[0]
    stats = dict(
        clamped_frac=n_clamped / max(n, 1),
        dropped_frac=dropped / max(total, 1),
        overflow_cell_frac=float((cnt > max_per_cell).sum()
                                 / max(len(occupied), 1)),
        occupied_frac=len(occupied) / max(len(cnt), 1),
        mean_occupancy=float(cnt[occupied].mean()) if len(occupied)
        else 0.0,
        dims=dims, max_per_cell=max_per_cell, extent_cap=float(cap),
    )
    if stats["clamped_frac"] > 0.05 or stats["dropped_frac"] > 0.05:
        get_logger().warning(
            "grid_accel truncation: %.1f%% extents clamped (cap %.3g), "
            "%.1f%% insertions dropped (%.1f%% of occupied cells "
            "overflow Kc=%d) — raise max_per_cell or radius_percentile "
            "if fringe coverage matters",
            100 * stats["clamped_frac"], cap,
            100 * stats["dropped_frac"],
            100 * stats["overflow_cell_frac"], max_per_cell)

    # Block table: occupancy masks, slot bases, euclidean jumps. Occupied
    # cells are ordered (block, in-block rank), so a block's slots are
    # consecutive and slot = base + popcount(mask below rank).
    gx, gy, gz = dims
    bdims = tuple(-(-d // 4) for d in dims)
    bx_, by_, bz_ = bdims
    span = np.maximum(np.asarray(hi) - np.asarray(lo), 1e-12)
    cell_size = span / np.asarray(dims, np.float64)
    cz, cyx = np.divmod(occupied, gx * gy)
    cy, cx = np.divmod(cyx, gx)
    blin = ((cz >> 2) * by_ + (cy >> 2)) * bx_ + (cx >> 2)
    rank = (cx & 3) + 4 * (cy & 3) + 16 * (cz & 3)
    order = np.argsort(blin * 64 + rank, kind="stable")
    occupied = occupied[order]
    blin, rank = blin[order], rank[order]

    n_blocks = bx_ * by_ * bz_
    mask64 = np.zeros(n_blocks, np.uint64)
    np.bitwise_or.at(mask64, blin, np.uint64(1) << rank.astype(np.uint64))
    occ_blocks = mask64 != 0
    base = np.zeros(n_blocks, np.int64)
    first = np.unique(blin, return_index=True)
    base[first[0]] = first[1]
    bmin = np.full((n_blocks, 3), 3, np.int64)
    bmax = np.zeros((n_blocks, 3), np.int64)
    inblock = np.stack([cx & 3, cy & 3, cz & 3], axis=-1)
    np.minimum.at(bmin, blin, inblock[order])
    np.maximum.at(bmax, blin, inblock[order])
    box = (bmin[:, 0] | (bmax[:, 0] << 2) | (bmin[:, 1] << 4)
           | (bmax[:, 1] << 6) | (bmin[:, 2] << 8) | (bmax[:, 2] << 10))
    jump_unit = float(cell_size.min()) / JUMP_FP
    jump_q = _block_jump_table(occ_blocks, bdims,
                               np.asarray(cell_size * 4.0, np.float64),
                               jump_unit)
    info = np.where(occ_blocks, box, -(1 + jump_q.astype(np.int64)))
    btab = np.stack([
        info.astype(np.int32),
        base.astype(np.int32),
        (mask64 & np.uint64(_M32)).astype(np.uint32).view(np.int32),
        (mask64 >> np.uint64(32)).astype(np.uint32).view(np.int32),
    ], axis=-1)

    idx_s = idx[occupied] if len(occupied) else np.full(
        (1, max_per_cell), -1, np.int32)
    idx_s = torch.from_numpy(np.ascontiguousarray(idx_s)).to(dev).long()
    valid = idx_s >= 0
    safe = torch.clamp_min(idx_s, 0)

    def flat(table):
        rows = table[safe]                               # (S, Kc, cols)
        rows = torch.where(valid[..., None], rows, 0.0)
        return rows.transpose(1, 2).reshape(idx_s.shape[0], -1) \
            .float().contiguous()

    with torch.no_grad():
        geom_rows = _geometry_table(scene)
        geom = flat(geom_rows)
        packet = flat(_packet_table(scene, geom_rows))
    return GridAccel(
        btab=torch.from_numpy(btab).to(dev),
        geom=geom, packet=packet,
        lo=torch.from_numpy(np.asarray(lo, np.float32)).to(dev),
        hi=torch.from_numpy(np.asarray(hi, np.float32)).to(dev),
        dims=tuple(int(d) for d in dims),
        fill=valid.sum(1, dtype=torch.int32), jump_unit=jump_unit,
        stats=tuple(sorted(stats.items())))


def clip_schedule(schedule, max_steps: int):
    """The rounds (frac, M, a_max, a_exit) that fit ``max_steps`` occupied
    cells per ray; the last round runs phase A to completion."""
    rounds, budget = [], max_steps
    for entry in schedule:
        frac, m, a_max = entry[:3]
        a_exit = entry[3] if len(entry) > 4 else 0.0
        if budget <= 0:
            break
        m = min(m, budget)
        budget -= m
        rounds.append((frac, m, a_max, a_exit))
    if rounds:
        rounds[-1] = rounds[-1][:3] + (0.0,)
    return rounds


def _ray_setup(origins, dirs, accel: GridAccel, t_min: float) -> dict:
    """Per-ray grid quantities the march recomputes from t."""
    dims_f = torch.tensor(accel.dims, dtype=torch.float32,
                          device=origins.device)
    ext = torch.clamp_min(accel.hi - accel.lo, 1e-12)
    cell_size = ext / dims_f
    tiny = torch.where(dirs >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(dirs.abs() < 1e-12, tiny, dirs)
    t0 = (accel.lo[None] - origins) * inv_d
    t1 = (accel.hi[None] - origins) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), -1)
    t_far = torch.amin(torch.maximum(t0, t1), -1)
    t_entry = torch.clamp_min(t_near, t_min)
    return dict(cell_size=cell_size, inv_d=inv_d, t_entry=t_entry,
                t_far=t_far, inside=t_far > t_entry,
                min_delta=torch.amin(torch.abs(cell_size[None] * inv_d), -1),
                step_pos=(dirs >= 0).float(), dims_f=dims_f)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of uint32 values held in int64."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _phase_a(accel: GridAccel, origins, dirs, setup, t, alive, t_far,
             m_slots: int, a_max: int, exit_frac: float, stats=None):
    """Probe-only traversal: record each ray's next <= m_slots occupied
    cells (slot, entry t, exit t), at most a_max block probes, stopping once
    no more than ``exit_frac`` of the batch is still probing. Returns
    (slots, t_ent, t_exd (R, M), count (R,), t (R,), paused (R,))."""
    r, dev = origins.shape[0], origins.device
    bdims = accel.block_dims
    cell_size, inv_d = setup["cell_size"], setup["inv_d"]
    step_pos, dims_f = setup["step_pos"], setup["dims_f"]
    eps = 1e-3 * setup["min_delta"]
    probe = 0.25 * eps
    lo = accel.lo[None]
    n_blocks = accel.btab.shape[0]
    block_edge = cell_size * 4.0
    btab = accel.btab.long()
    miota = torch.arange(m_slots, device=dev)

    def cell_of(t_):
        p = origins + (t_ + probe)[:, None] * dirs
        cell = torch.floor((p - lo) / cell_size[None])
        return torch.minimum(torch.clamp_min(cell, 0.0), dims_f - 1.0)

    def exit_of(cell, size):
        bnd = lo + (cell + step_pos) * size[None]
        return torch.amin((bnd - origins) * inv_d, -1)

    t_ = torch.where(alive, t, t_far)     # dead rays never probe
    count = torch.zeros(r, dtype=torch.long, device=dev)
    slots = torch.zeros((r, m_slots), dtype=torch.long, device=dev)
    t_ent = torch.zeros((r, m_slots), dtype=torch.float32, device=dev)
    t_exd = torch.zeros_like(t_ent)
    floor = int(r * exit_frac)
    for _ in range(a_max):
        probing = (t_ < t_far) & (count < m_slots)
        n_probing = int(probing.sum())
        if n_probing <= floor:
            break
        cell = cell_of(t_)
        icell = cell.long()
        bx, by, bz = icell[:, 0] >> 2, icell[:, 1] >> 2, icell[:, 2] >> 2
        blin = torch.clamp((bz * bdims[1] + by) * bdims[0] + bx, 0,
                           n_blocks - 1)
        if stats is not None:
            stats["probes"] = stats.get("probes", 0) + n_probing
            stats.setdefault("block_seen", torch.zeros(
                n_blocks, dtype=torch.bool, device=dev))[blin[probing]] = True
        row = btab[torch.where(probing, blin, 0)]
        info, base = row[:, 0], row[:, 1]
        mlo, mhi = row[:, 2] & _M32, row[:, 3] & _M32
        occ_block = info >= 0

        # Empty block: euclidean jump, at least to the block exit.
        t_bex = torch.maximum(exit_of(torch.floor(cell / 4.0), block_edge),
                              t_ + eps)
        jump_w = (-(info + 1)).float() * accel.jump_unit
        t_jump = torch.maximum(t_bex, t_ + jump_w)

        # Occupied block: slab-test the tight box of its set cells.
        b = torch.clamp_min(info, 0)
        bmin = torch.stack([b & 3, (b >> 4) & 3, (b >> 8) & 3], -1).float()
        bmax = torch.stack([(b >> 2) & 3, (b >> 6) & 3, (b >> 10) & 3],
                           -1).float()
        borig_w = lo + torch.stack([bx, by, bz], -1).float() \
            * block_edge[None]
        box_lo = borig_w + bmin * cell_size[None]
        box_hi = borig_w + (bmax + 1.0) * cell_size[None]
        tb0 = (box_lo - origins) * inv_d
        tb1 = (box_hi - origins) * inv_d
        t_in = torch.amax(torch.minimum(tb0, tb1), -1)
        t_out = torch.amin(torch.maximum(tb0, tb1), -1)
        enter = torch.maximum(t_, t_in)
        box_hit = occ_block & (t_out > enter)

        # Up to 4 in-block cell steps from this one row. ``going``: the steps
        # a ray-at-a-time march runs, which end at the first that changes
        # nothing (counted for the stats).
        tk = torch.where(box_hit, enter, t_)
        going = probing & box_hit
        n_checks = n_steps = 0
        for _ in range(4):
            cellk = cell_of(tk)
            ik = cellk.long()
            same_block = ((ik[:, 0] >> 2) == bx) & ((ik[:, 1] >> 2) == by) \
                & ((ik[:, 2] >> 2) == bz)
            stepk = probing & box_hit & same_block & (tk < t_far) \
                & (tk < t_out)
            rank = (ik[:, 0] & 3) + 4 * (ik[:, 1] & 3) + 16 * (ik[:, 2] & 3)
            hi_word = rank >= 32
            sh = torch.where(hi_word, rank - 32, rank)
            word = torch.where(hi_word, mhi, mlo)
            bit = ((word >> sh) & 1).bool()
            below = (1 << sh) - 1
            below_lo = torch.where(hi_word, mlo, mlo & below)
            below_hi = torch.where(hi_word, mhi & below, 0)
            slot = base + _popcount32(below_lo) + _popcount32(below_hi)
            tex = torch.maximum(exit_of(cellk, cell_size), tk + eps)
            take = stepk & bit & (count < m_slots)
            put = take[:, None] & (count[:, None] == miota[None])
            slots = torch.where(put, slot[:, None], slots)
            t_ent = torch.where(put, tk[:, None], t_ent)
            t_exd = torch.where(put, tex[:, None], t_exd)
            count = count + take.long()
            tk = torch.where(stepk & (~bit | take), tex, tk)
            if stats is not None:
                n_checks = n_checks + going.sum()
                going = going & stepk
                n_steps = n_steps + going.sum()
                going = going & (~bit | take)

        # Past the sub-box (or never in it): on to the block exit.
        t_occ = torch.where(box_hit & (tk < t_out), tk,
                            torch.maximum(t_bex, tk))
        if stats is not None:
            counts = torch.stack([
                (probing & ~occ_block).sum(),
                (probing & occ_block & ~box_hit).sum(),
                (probing & box_hit & ~(tk < t_out)).sum(),
                n_checks, n_steps]).tolist()
            for name, n in zip(PROBE_STAT_KEYS, counts):
                stats[name] = stats.get(name, 0) + n
        t_ = torch.where(probing, torch.where(occ_block, t_occ, t_jump), t_)
    paused = (t_ < t_far) & alive
    return slots, t_ent, t_exd, count, torch.where(alive, t_, t), paused


def _ordered_weights(t_peak, alpha):
    """Within-cell front-to-back weights without a sort: excl_i = prod over
    j with (t_j, j) < (t_i, i) of (1 - alpha_j), features kept in slot
    order. (V, Kc) -> (V, Kc)."""
    kc = alpha.shape[-1]
    before = t_peak[:, None, :] < t_peak[:, :, None]        # [v, i, j]
    iota = torch.arange(kc, device=alpha.device)
    tie = (t_peak[:, None, :] == t_peak[:, :, None]) \
        & (iota[None, None, :] < iota[None, :, None])
    fac = torch.where(before | tie, 1.0 - alpha[:, None, :], 1.0)
    return torch.prod(fac, dim=-1)


def _phase_b_chunk(accel: GridAccel, origins, dirs, settings, slots, t_ent,
                   t_exd, count, trans, alive, with_features, t_cap):
    """Phase B of one slot group for a chunk of rays: (trans after the
    group (R,), the group's 15 sums (R, 15) or None)."""
    r, m_slots = slots.shape
    kc = accel.max_per_cell
    cut = math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)
    table = accel.packet if with_features else accel.geom
    miota = torch.arange(m_slots, device=slots.device)
    valid_m = alive[:, None] & (miota[None] < count[:, None])   # (R, M)
    g = table[torch.where(valid_m, slots, 0).reshape(-1)]     # (V, C Kc)

    def gc(c):
        return g[:, c * kc:(c + 1) * kc]

    def rep(x):
        return x[:, None].expand(r, m_slots).reshape(-1, 1)

    dx, dy, dz = rep(dirs[:, 0]), rep(dirs[:, 1]), rep(dirs[:, 2])
    ox, oy, oz = rep(origins[:, 0]), rep(origins[:, 1]), rep(origins[:, 2])
    t0 = t_ent.reshape(-1, 1)
    t1 = t_exd.reshape(-1, 1)
    ogx, ogy, ogz = ox - gc(6), oy - gc(7), oz - gc(8)
    q00, q11, q22, q01, q02, q12 = (gc(c) for c in range(6))
    a_q = (dx * dx * q00 + dy * dy * q11 + dz * dz * q22
           + 2.0 * (dx * dy * q01 + dx * dz * q02 + dy * dz * q12))
    a_q = torch.clamp_min(a_q, 1e-12)
    wx = q00 * ogx + q01 * ogy + q02 * ogz
    wy = q01 * ogx + q11 * ogy + q12 * ogz
    wz = q02 * ogx + q12 * ogy + q22 * ogz
    b_q = dx * wx + dy * wy + dz * wz
    c_q = wx * ogx + wy * ogy + wz * ogz
    peak = -b_q / a_q
    t_peak = torch.clamp(peak, settings.t_min, settings.t_max)
    if t_cap is not None:
        # Shadow segments respond at the peak clamped into what is left of
        # the segment (segment_transmittance_alpha semantics).
        t_resp = torch.minimum(torch.maximum(
            peak, torch.clamp_min(t0, settings.t_min)), rep(t_cap))
    else:
        t_resp = t_peak
    qv = (a_q * t_resp + 2.0 * b_q) * t_resp + c_q
    gval = torch.exp(-0.5 * torch.clamp_min(qv, 0.0))
    opac = gc(G_OPAC)
    a0 = opac * gval
    live = a0 >= settings.alpha_min
    if t_cap is None:
        live = live & (gval >= cut)
    alpha = torch.where(live, torch.clamp_max(a0, settings.alpha_max), 0.0)
    # Exactly one slab owns each peak: [t0, t1) half-open.
    in_slab = (t_peak >= t0) & (t_peak < t1)
    valid = (opac > 0.0) & valid_m.reshape(-1, 1) & in_slab
    alpha = torch.where(valid, alpha, 0.0)
    cell_trans = torch.prod(1.0 - alpha, dim=-1).reshape(r, m_slots)

    # T_m = trans * prod_{j<m} ct_j, chained in slot order.
    excl = [torch.ones_like(trans)]
    for m in range(1, m_slots):
        excl.append(excl[-1] * cell_trans[:, m - 1])
    t_entry = trans[:, None] * torch.stack(excl, -1)             # (R, M)
    trans_new = t_entry[:, -1] * cell_trans[:, -1]
    if not with_features:
        return trans_new, None

    w = t_entry.reshape(-1, 1) * _ordered_weights(t_peak, alpha) * alpha
    ax, ay, az = gc(P_AXIS), gc(P_AXIS + 1), gc(P_AXIS + 2)
    sgn = torch.where(ax * dx + ay * dy + az * dz > 0, -1.0, 1.0)
    deg1 = accel.pkt_cols >= PKT_COLS_DEG1

    def tot(wcol):                                       # (V, Kc) -> (R,)
        return torch.sum(torch.sum(wcol, -1).reshape(r, m_slots), -1)

    sums = []
    for ch in range(3):
        col = gc(P_DC + ch) + 0.5
        if deg1:
            col = (col + dy * gc(P_BY + ch) + dz * gc(P_BY + 3 + ch)
                   + dx * gc(P_BY + 6 + ch))
        sums.append(tot(w * torch.clamp_min(col, 0.0)))
    sums += [tot(w * gc(P_EMI + ch)) for ch in range(3)]
    sums += [tot(w * gc(c)) for c in (P_MET, P_ROUGH, P_CC, P_CCR, P_TRN)]
    sums += [tot(w * ax * sgn), tot(w * ay * sgn), tot(w * az * sgn),
             tot(w * t_peak)]
    return trans_new, torch.stack(sums, -1)


def _phase_b(accel, origins, dirs, settings, slots, t_ent, t_exd, count,
             trans, acc, alive, with_features, t_cap):
    """Composite one slot group of recorded cells front to back, in chunks
    of rays that bound the (ray, slot, Kc, Kc) temporaries; returns
    (trans, acc, alive) with rays at or below transmittance_min killed."""
    r, m_slots = slots.shape
    kc = accel.max_per_cell
    per_ray = m_slots * kc * max(kc, accel.pkt_cols)
    step = max(1, PLAIN_CHUNK_ELEMS // per_ray)
    trans_parts, acc_parts = [], []
    for s in range(0, r, step):
        sl = slice(s, s + step)
        tr, upd = _phase_b_chunk(
            accel, origins[sl], dirs[sl], settings, slots[sl], t_ent[sl],
            t_exd[sl], count[sl], trans[sl], alive[sl], with_features,
            None if t_cap is None else t_cap[sl])
        trans_parts.append(tr)
        acc_parts.append(upd)
    trans = torch.cat(trans_parts)
    if with_features:
        acc = acc + torch.cat(acc_parts)
    return trans, acc, alive & (trans > settings.transmittance_min)


def _march_round(accel, origins, dirs, settings, setup, t, trans, acc,
                 alive, t_far, with_features, m_slots, a_max, t_cap,
                 a_exit, stats=None):
    """One round: phase A, then phase B in slot groups of SLOT_GROUP. A
    ray survives iff it paused in phase A (slots full or traversal
    unfinished) and phase B left it above transmittance_min. Returns
    (t, trans, acc, alive)."""
    if not bool(alive.any()):
        return t, trans, acc, alive
    slots, t_ent, t_exd, count, t_new, paused = _phase_a(
        accel, origins, dirs, setup, t, alive, t_far, m_slots, a_max,
        a_exit, stats)
    alive_b = alive
    for g0 in range(0, m_slots, SLOT_GROUP):
        g1 = min(g0 + SLOT_GROUP, m_slots)
        ct_g = torch.clamp(count - g0, 0, g1 - g0)
        # A group no live ray reached is an exact no-op (alive implies
        # trans > transmittance_min, so the kill test changes nothing).
        if not bool((alive_b & (ct_g > 0)).any()):
            continue
        if stats is not None:
            used = alive_b[:, None] & (torch.arange(
                g1 - g0, device=ct_g.device)[None] < ct_g[:, None])
            visits = stats.setdefault("slot_visits", torch.zeros(
                accel.geom.shape[0], dtype=torch.long, device=ct_g.device))
            visits.index_add_(0, slots[:, g0:g1][used],
                              torch.ones_like(slots[:, g0:g1][used]))
        trans, acc, alive_b = _phase_b(
            accel, origins, dirs, settings, slots[:, g0:g1],
            t_ent[:, g0:g1], t_exd[:, g0:g1], ct_g, trans, acc, alive_b,
            with_features, t_cap)
    return t_new, trans, acc, paused & alive_b


def _interleave_bits(v):
    """Spread the low 10 bits of v to every 3rd bit position (uint32 in
    int64)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _sort_key(origins, dirs, t, alive, accel: GridAccel):
    """Dead last, then morton of the current position and the direction
    octant (uint32 in int64)."""
    p = origins + t[:, None] * dirs
    ext = torch.clamp_min(accel.hi - accel.lo, 1e-12)
    q = torch.clamp((p - accel.lo[None]) / ext[None] * 127.0, 0.0, 127.0)
    qi = q.long()
    morton = (_interleave_bits(qi[:, 0]) | (_interleave_bits(qi[:, 1]) << 1)
              | (_interleave_bits(qi[:, 2]) << 2))
    octant = ((dirs[:, 0] >= 0).long() | ((dirs[:, 1] >= 0).long() << 1)
              | ((dirs[:, 2] >= 0).long() << 2))
    key = ((morton << 3) | octant) & _M32
    return torch.where(alive, key, _M32)


@torch.no_grad()
def march_plain(accel: GridAccel, origins, dirs, settings: RenderSettings,
                max_steps: int, t_end=None, with_features: bool = True,
                active=None, schedule=DEFAULT_SCHEDULE,
                compact_min: int = COMPACT_MIN_RAYS, stats=None):
    """The reference's grid march in plain torch.

    Returns (trans (R,), acc (R, 15) in ``ACC_KEYS`` order or None, frozen
    (R,) bool: rays still alive when the schedule ended, whose sums are
    partial). ``active`` (R,) pre-kills rays; ``t_end`` makes the march a
    shadow segment; ``max_steps`` bounds the occupied cells composited per
    ray (the schedule is clipped to it). ``stats`` (a dict), when given,
    gathers the block probes ("probes", and by kind ``PROBE_STAT_KEYS``),
    which block rows were probed ("block_seen", (B,) bool) and how often
    each cell was composited ("slot_visits", (S,) int64).
    """
    r, dev = origins.shape[0], origins.device
    rounds = clip_schedule(schedule, max_steps)
    setup = _ray_setup(origins, dirs, accel, settings.t_min)
    t_far = setup["t_far"] if t_end is None \
        else torch.minimum(setup["t_far"], t_end)
    alive0 = setup["inside"] if active is None else setup["inside"] & active
    n_acc = len(ACC_KEYS)

    def zeros_acc(n):
        return torch.zeros((n, n_acc), dtype=torch.float32, device=dev) \
            if with_features else None

    trans = torch.ones(r, dtype=torch.float32, device=dev)
    if r <= compact_min:
        # Small batches: one batch, no sorting; the sums carry over rounds.
        t, acc, alive = setup["t_entry"], zeros_acc(r), alive0
        for _, m, a_max, a_exit in rounds:
            t, trans, acc, alive = _march_round(
                accel, origins, dirs, settings, setup, t, trans, acc, alive,
                t_far, with_features, m, a_max, t_end, a_exit, stats)
        return trans, acc, alive

    # Round 0 at full width, presorted (dead last) when a mask was given.
    perm = None
    if active is not None:
        perm = torch.argsort(_sort_key(origins, dirs, setup["t_entry"],
                                       alive0, accel), stable=True)
        origins, dirs = origins[perm], dirs[perm]
        t_end = None if t_end is None else t_end[perm]
        alive_s = alive0[perm]
        setup = _ray_setup(origins, dirs, accel, settings.t_min)
        t_far = setup["t_far"] if t_end is None \
            else torch.minimum(setup["t_far"], t_end)
        alive0 = setup["inside"] & alive_s
    _, m, a_max, a_exit = rounds[0]
    t, trans, acc, alive = _march_round(
        accel, origins, dirs, settings, setup, setup["t_entry"], trans,
        zeros_acc(r), alive0, t_far, with_features, m, a_max, t_end, a_exit,
        stats)

    # Later rounds: the first ``cap`` rays by sort key (survivors first),
    # each round's sums added to the total.
    for frac, m, a_max, a_exit in rounds[1:]:
        cap = max(-(-int(r * frac) // 256) * 256, 4096)
        if cap >= r:
            t, trans, upd, alive = _march_round(
                accel, origins, dirs, settings, setup, t, trans,
                zeros_acc(r), alive, t_far, with_features, m, a_max, t_end,
                a_exit, stats)
            if with_features:
                acc = acc + upd
            continue
        sel = torch.argsort(_sort_key(origins, dirs, t, alive, accel),
                            stable=True)[:cap]
        o_c, d_c = origins[sel], dirs[sel]
        tc_c = None if t_end is None else t_end[sel]
        setup_c = _ray_setup(o_c, d_c, accel, settings.t_min)
        t_far_c = setup_c["t_far"] if tc_c is None \
            else torch.minimum(setup_c["t_far"], tc_c)
        t_c, trans_c, upd, alive_c = _march_round(
            accel, o_c, d_c, settings, setup_c, t[sel], trans[sel],
            zeros_acc(cap), alive[sel], t_far_c, with_features, m, a_max,
            tc_c, a_exit, stats)
        t, trans, alive = t.clone(), trans.clone(), alive.clone()
        t[sel], trans[sel], alive[sel] = t_c, trans_c, alive_c
        if with_features:
            acc = acc.index_add(0, sel, upd)

    if perm is not None:
        inv = torch.argsort(perm)
        trans, alive = trans[inv], alive[inv]
        acc = None if acc is None else acc[inv]
    return trans, acc, alive


def march(accel: GridAccel, origins, dirs, settings: RenderSettings,
          max_steps: int, t_end=None, with_features: bool = True,
          active=None, schedule=DEFAULT_SCHEDULE,
          compact_min: int = COMPACT_MIN_RAYS):
    """March rays through the grid: (trans (R,), sums (R, 15) in
    ``ACC_KEYS`` order or None, frozen (R,) bool).

    CPU tensors run :func:`march_plain`. CUDA tensors launch the kernel
    over the schedule's rounds clipped to ``max_steps``; it has no
    batch-level exit fractions or compaction, so on the card ``schedule``
    must be the default one (whose batch-level parts the kernel leaves out,
    ROADMAP section 3) or have no exit fractions, and ``compact_min`` must
    be the default.
    """
    tensors = dict(origins=origins, dirs=dirs, btab=accel.btab)
    if t_end is not None:
        tensors["t_end"] = t_end
    if active is not None:
        tensors["active"] = active
    if launch.on_cpu("grid march", tensors):
        return march_plain(accel, origins, dirs, settings, max_steps,
                           t_end=t_end, with_features=with_features,
                           active=active, schedule=schedule,
                           compact_min=compact_min)
    rounds = clip_schedule(schedule, max_steps)
    exits = any(len(e) > 3 and (e[3] or e[4]) for e in schedule)
    if compact_min != COMPACT_MIN_RAYS or (
            exits and tuple(schedule) != DEFAULT_SCHEDULE):
        raise ValueError(
            "grid march: the kernel has no batch-level exit fractions or "
            "compaction; on CUDA tensors pass the default schedule or one "
            "without exit fractions, and the default compact_min")
    return grid_march.march_kernel(accel, origins, dirs, settings, rounds,
                                   t_end=t_end, with_features=with_features,
                                   active=active)


def interaction_from_sums(trans, acc, origins, dirs,
                          settings: RenderSettings) -> dict:
    """The trace_dense-style interaction of a march's transmittance and
    15 sums (``ACC_KEYS`` order)."""
    alpha_acc = 1.0 - trans
    denom = torch.clamp_min(alpha_acc, 1e-8)
    depth = acc[:, 14] / denom
    return dict(
        radiance_emitted=acc[:, 3:6],
        albedo=acc[:, 0:3],
        normal=safe_normalize(acc[:, 11:14]),
        position=origins + depth[:, None] * dirs,
        depth=depth,
        metallic=acc[:, 6] / denom,
        roughness=acc[:, 7] / denom,
        clearcoat=acc[:, 8] / denom,
        cc_roughness=acc[:, 9] / denom,
        transmission=acc[:, 10] / denom,
        alpha_acc=alpha_acc,
        trans=trans,
        hit=alpha_acc > settings.hit_opacity_threshold,
    )


@torch.no_grad()
def trace_grid(scene: GaussianScene, rays: Rays, settings: RenderSettings,
               accel: GridAccel, max_steps: int = 128, active=None,
               compact_min: int = COMPACT_MIN_RAYS,
               schedule=DEFAULT_SCHEDULE) -> dict:
    """Aggregate surface interaction through the grid (trace_dense's keys
    plus ``frozen_alive``, a 0-dim tensor: rays still alive when the march
    ended, whose accumulation is partial).

    ``scene`` is accepted for parity with trace_dense; the march reads only
    ``accel`` (bounce color is SH truncated to degree <= 1). The march is
    :func:`march`: the kernel on CUDA rays, :func:`march_plain` on CPU
    rays.
    """
    del scene
    trans, acc, frozen = march(
        accel, rays.origins, rays.directions, settings, max_steps,
        with_features=True, active=active, schedule=schedule,
        compact_min=compact_min)
    out = interaction_from_sums(trans, acc, rays.origins, rays.directions,
                                settings)
    out["frozen_alive"] = frozen.sum()
    return out


@torch.no_grad()
def visibility_grid(scene: GaussianScene, accel: GridAccel, origins,
                    directions, t_end, settings: RenderSettings,
                    max_steps: int = 128, active=None,
                    compact_min: int = COMPACT_MIN_RAYS,
                    schedule=DEFAULT_SCHEDULE,
                    return_frozen: bool = False):
    """Shadow-ray transmittance (R,) of the segments [t_min, t_end] through
    the grid; rays masked off by ``active`` return 1. With
    ``return_frozen`` also the frozen count (see :func:`trace_grid`)."""
    del scene
    trans, _, frozen = march(
        accel, origins, directions, settings, max_steps, t_end=t_end,
        with_features=False, active=active, schedule=schedule,
        compact_min=compact_min)
    if return_frozen:
        return trans, frozen.sum()
    return trans
