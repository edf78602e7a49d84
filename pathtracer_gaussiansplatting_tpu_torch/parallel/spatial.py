"""Spatially partitioned rendering: resident Gaussian slabs and a ray ring.

Counterpart of ``pathtracer_gaussiansplatting_tpu/parallel/spatial.py``
(``SlabAccelMeta``, ``partition_slabs``, ``_slab_composite``, ``_over``,
``build_slab_accels``, ``_ring_composite``, ``render_spatial``,
``_slab_interaction_feats``, ``_grid_slab_trace_fn``,
``_grid_slab_vis_fn``, ``trace_spatial``, ``visibility_spatial``,
``spatial_sharding``), on the mesh of :mod:`.mesh` (its docstring states
the block convention and the gradient rules).

Each rank of the gauss axis owns one contiguous depth slab of space; its
Gaussians never move. The rays travel instead: a ray chunk and its
running (C, T) composite move one rank along the gauss ring a step
(``shard.ring_shift``, differentiable), as ring attention moves its
carry.

  * 'over' on (C, T) pairs, over(x, y) = (Cx + Tx Cy, Tx Ty), is
    associative but not commutative. The chunk that starts on slab c
    visits c..S-1 (segment A), then wraps to 0..c-1 (segment B); each
    segment folds in visit order, and front to back a forward ray sees B
    over A. A ray against the slab axis sees the slabs back to front, so
    each segment also folds the other way and the ray's direction picks
    the pair.
  * Within a slab, contributions composite in the order of their means'
    projection on the slab axis (signed per ray), the key the partition
    sorts by: the top-K kernel runs twice, with ``sort_depths = proj``
    for the forward rays and ``-proj`` for the others, and each ray takes
    its own list.
  * On the grid slabs the per-slab march is ``render.grid_trace.march``:
    the kernel on CUDA tensors, the plain march with the reference's
    ``compact_min = 1 << 40`` on CPU tensors. The rays each slab's march
    leaves frozen ride the ring with the chunk and come back as
    ``frozen_alive``, with a warning on the ``gspt`` logger where any did
    (the JAX package drops the count).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.safe_math import (
    safe_normalize,
)
from pathtracer_gaussiansplatting_tpu_torch.parallel.mesh import (
    GAUSS_AXIS, RAY_AXIS, Layout, axis_size, pad_to_multiple,
    replicated_input,
)
from pathtracer_gaussiansplatting_tpu_torch.parallel.shard import ring_shift
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as gt
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger

# The 15 channels of a slab's interaction features, in
# _slab_interaction_feats' order (the grid march's sums reordered).
SLAB_FEATURES = ("col_r", "col_g", "col_b", "emi_r", "emi_g", "emi_b",
                 "met", "rough", "nx", "ny", "nz", "cc", "ccr", "trn",
                 "tsum")
_GRID_COLUMNS = [gt.ACC_KEYS.index(k) for k in SLAB_FEATURES]
# The reference marches each slab as one batch, never compacted.
PLAIN_COMPACT_MIN = 1 << 40


@dataclasses.dataclass(frozen=True)
class SlabAccelMeta:
    """What every slab's grid shares: dims, jump unit, binning stats."""

    dims: Tuple[int, int, int]
    jump_unit: float
    stats: tuple = ()

    @property
    def stats_dict(self) -> dict:
        return dict(self.stats)


def spatial_sharding(mesh: DeviceMesh) -> Layout:
    """The layout of ray arrays that the slab ring consumes: split over
    both axes, block r * G + g at mesh position (r, g)."""
    return (RAY_AXIS, GAUSS_AXIS)


def _unit_axis(axis) -> torch.Tensor:
    a = torch.as_tensor(axis, dtype=torch.float32)
    return a / torch.clamp_min(torch.linalg.norm(a), 1e-12)


def partition_slabs(scene: GaussianScene, n_slabs: int,
                    axis=(0.0, 0.0, 1.0)) -> Tuple[GaussianScene, np.ndarray]:
    """Sort Gaussians into ``n_slabs`` contiguous equal-count depth slabs.

    Returns (the sorted scene padded to a multiple of ``n_slabs``, the
    unit axis as float32 (3,)). ``mesh.shard_scene`` of it gives rank g
    slab g. The order is a stable argsort on the host of the means'
    projection on the axis; padding Gaussians are fully transparent and
    land in the last slab.
    """
    axis = np.asarray(axis, np.float32)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    t = scene.means.detach().cpu().numpy() @ axis
    order = torch.from_numpy(np.argsort(t, kind="stable")).to(
        scene.means.device)
    sorted_scene = GaussianScene(**{f: getattr(scene, f)[order]
                                    for f in SCENE_FIELDS})
    return pad_to_multiple(sorted_scene, n_slabs), axis


def _slab_topk(block: GaussianScene, origins, dirs, axis,
               settings: RenderSettings, table):
    """Each ray's K nearest contributors of the slab by the signed
    projection key: (idx (R, K) int64, t, alpha (R, K), fwd (R,))."""
    proj = block.means @ axis
    fwd = torch.sum(dirs * axis[None], dim=-1) >= 0.0
    rays = Rays(origins, dirs)
    idx_f, t_f, a_f = ref.dense_topk(block, rays, settings, sort_depths=proj,
                                     active=fwd, table=table)
    idx_b, t_b, a_b = ref.dense_topk(block, rays, settings,
                                     sort_depths=-proj, active=~fwd,
                                     table=table)
    f = fwd[:, None]
    return (torch.where(f, idx_f, idx_b).long(), torch.where(f, t_f, t_b),
            torch.where(f, a_f, a_b), fwd)


def _slab_table(block: GaussianScene, settings: RenderSettings):
    """The dense kernels' table of a slab, built once for a ring call."""
    table = dense_trace.gaussian_table(block, settings)
    if block.means.device.type == "cpu":
        return table
    return dense_trace.dense_table(table)


def _slab_composite(block: GaussianScene, origins, dirs, axis,
                    settings: RenderSettings, table=None):
    """Per-slab composite of a ray chunk's radiance: (feats (R, 3), trans
    (R,), fwd (R,)); SH color + emission, ordered by the mean's projection
    on the slab axis (so slab by slab equals one globally ordered pass)."""
    idx, _, alpha, fwd = _slab_topk(block, origins, dirs, axis, settings,
                                    table)
    d = dirs[:, None, :].expand(-1, idx.shape[1], 3)
    color = sh_mod.eval_sh(block.sh_coeffs[idx], d, settings.sh_degree) \
        + block.emission[idx]
    weights, trans = composite_weights(alpha)
    return torch.einsum("rk,rkc->rc", weights, color), trans, fwd


def _over(c_front, t_front, c_back, t_back):
    """'over' composition: the front segment seen before the back one."""
    return c_front + t_front[:, None] * c_back, t_front * t_back


def build_slab_accels(scene_slabbed: GaussianScene, n_slabs: int,
                      max_per_cell: int = 32, dims=None,
                      radius_percentile: float = 99.0):
    """One grid accel per slab on a shared cell geometry (the real
    splats' bounds and one dims), stacked along a leading slab axis.

    Returns (tables, meta): tables {btab (S, B, 4) int32, geom (S, Smax,
    12 Kc), packet (S, Smax, cols Kc), fill (S, Smax) int32, lo, hi (S,
    3)} on the scene's device, rows past a slab's own zero (their fill
    0); meta a :class:`SlabAccelMeta`.
    ``mesh.shard_scene(tables, mesh)`` gives rank g slab g's tables.
    """
    n = scene_slabbed.num_gaussians
    per = n // n_slabs
    means = scene_slabbed.means.detach().cpu().numpy()
    real = scene_slabbed.opacities.detach().cpu().numpy() > 0
    exts = gt._aniso_extents(scene_slabbed, 3.0)
    lo_g = (means[real] - exts[real]).min(0)
    hi_g = (means[real] + exts[real]).max(0)
    if dims is None:
        keep = torch.from_numpy(real).to(scene_slabbed.means.device)
        dims = gt.fit_grid(
            GaussianScene(**{f: getattr(scene_slabbed, f)[keep]
                             for f in SCENE_FIELDS}),
            radius_percentile=radius_percentile)[0]
    accels = [gt.build_grid_accel(
        GaussianScene(**{f: getattr(scene_slabbed, f)[s * per:(s + 1) * per]
                         for f in SCENE_FIELDS}),
        dims=dims, max_per_cell=max_per_cell,
        radius_percentile=radius_percentile, bounds=(lo_g, hi_g))
        for s in range(n_slabs)]
    s_max = max(a.geom.shape[0] for a in accels)

    def stack_rows(key):
        def pad(x):   # the rows (the leading axis) to s_max, with zeros
            return torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 1) + (0, s_max - x.shape[0]))
        return torch.stack([pad(getattr(a, key)) for a in accels])

    stats = dict(
        dropped_frac=float(np.mean([a.stats_dict["dropped_frac"]
                                    for a in accels])),
        clamped_frac=float(np.mean([a.stats_dict["clamped_frac"]
                                    for a in accels])),
        max_per_cell=max_per_cell)
    tables = dict(btab=torch.stack([a.btab for a in accels]),
                  geom=stack_rows("geom"), packet=stack_rows("packet"),
                  fill=stack_rows("fill"),
                  lo=torch.stack([a.lo for a in accels]),
                  hi=torch.stack([a.hi for a in accels]))
    meta = SlabAccelMeta(dims=tuple(int(d) for d in dims),
                         jump_unit=float(accels[0].jump_unit),
                         stats=tuple(sorted(stats.items())))
    return tables, meta


def _ring_composite(block, origins, dirs, extra, mesh: DeviceMesh, axis_v,
                    slab_fn, feat_dim: int):
    """The slab-carry ring: fold slab_fn's (feats, trans) around the ring.

    ``slab_fn(block, origins, dirs, extra) -> (feats (r, feat_dim), trans
    (r,), frozen (r,) or None)``; ``extra`` (r,) or None rides with the
    rays (a shadow ray's t_end). Runs S steps: each folds the A/B segment
    accumulators forward (acc over new) and reverse (new over acc), then
    moves the chunk (its rays, extra, accumulators and frozen counts) one
    rank along the gauss ring in one message. The chunk on rank g after
    ``step`` moves is chunk (g - step) mod S. Returns (feats (r,
    feat_dim), trans (r,), frozen (r,)) of this rank's own chunk,
    composited front to back per ray direction.
    """
    s_ring = axis_size(mesh, GAUSS_AXIS)
    me = mesh.get_local_rank(GAUSS_AXIS)
    r, dev = origins.shape[0], origins.device
    zero = torch.zeros((r, feat_dim), device=dev)
    one = torch.ones((r,), device=dev)
    # A = pre-wrap visits, B = post-wrap; f folds behind (acc over new), b
    # in front (new over acc).
    carry = dict(o=origins, d=dirs, cAf=zero, tAf=one, cAb=zero, tAb=one,
                 cBf=zero, tBf=one, cBb=zero, tBb=one,
                 frozen=torch.zeros((r,), device=dev))
    if extra is not None:
        carry["extra"] = extra
    for step in range(s_ring):
        feats, trans, frozen = slab_fn(block, carry["o"], carry["d"],
                                       carry.get("extra"))
        if frozen is not None:
            carry["frozen"] = carry["frozen"] + frozen.float()
        wrapped = step >= s_ring - (me - step) % s_ring
        for seg, sel in (("A", 0.0 if wrapped else 1.0),
                         ("B", 1.0 if wrapped else 0.0)):
            cf, tf, cb, tb = (carry[k + seg + w] for k, w in
                              (("c", "f"), ("t", "f"), ("c", "b"), ("t", "b")))
            nf_c, nf_t = _over(cf, tf, feats, trans)     # acc over new
            nb_c, nb_t = _over(feats, trans, cb, tb)     # new over acc
            carry.update({f"c{seg}f": cf + sel * (nf_c - cf),
                          f"t{seg}f": tf + sel * (nf_t - tf),
                          f"c{seg}b": cb + sel * (nb_c - cb),
                          f"t{seg}b": tb + sel * (nb_t - tb)})
        if s_ring > 1:
            cols = [v.reshape(r, -1) for v in carry.values()]
            moved = torch.split(ring_shift(torch.cat(cols, dim=1), mesh),
                                [c.shape[1] for c in cols], dim=1)
            carry = {k: m.reshape(v.shape)
                     for (k, v), m in zip(carry.items(), moved)}
    # After S moves the chunk is home. Front to back: forward rays see
    # slabs 0..c-1 (B) then c..S-1 (A), B over A; reverse rays see A
    # reversed, then B reversed.
    fwd = torch.sum(dirs * axis_v[None], dim=-1) >= 0.0
    c_f, t_f = _over(carry["cBf"], carry["tBf"], carry["cAf"], carry["tAf"])
    c_b, t_b = _over(carry["cAb"], carry["tAb"], carry["cBb"], carry["tBb"])
    return (torch.where(fwd[:, None], c_f, c_b), torch.where(fwd, t_f, t_b),
            carry["frozen"])


def render_spatial(scene_slabbed: GaussianScene, rays: Rays,
                   settings: RenderSettings, mesh: DeviceMesh,
                   axis=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Radiance over spatially partitioned Gaussians via the carry ring.

    ``scene_slabbed``: this rank's slab, ``mesh.shard_scene`` of
    :func:`partition_slabs`' scene; ``rays``: this rank's block under
    :func:`spatial_sharding` (``mesh.shard_rays``); the ray count must
    split evenly. Returns the rank's (r, 3) block of radiance, background
    composited. Differentiable in the slab's leaves.
    """
    axis_v = _unit_axis(axis).to(rays.origins.device)
    block = replicated_input(scene_slabbed, mesh, (RAY_AXIS,))
    table = _slab_table(block, settings)

    def slab_fn(blk, o, d, extra):
        feats, trans, _ = _slab_composite(blk, o, d, axis_v, settings, table)
        return feats, trans, None

    color, trans, _ = _ring_composite(block, rays.origins, rays.directions,
                                      None, mesh, axis_v, slab_fn, 3)
    bg = torch.tensor(settings.background, dtype=torch.float32,
                      device=color.device)
    return color + trans[:, None] * bg


def _slab_interaction_feats(block: GaussianScene, origins, dirs, axis,
                            settings: RenderSettings, table=None):
    """Per-slab composite of the whole interaction feature stack, (feats
    (R, 15), trans (R,)) in :data:`SLAB_FEATURES` order: albedo (3),
    emission (3), metallic, roughness, normal (3), clearcoat,
    cc_roughness, transmission, depth; the caller reconstructs the
    position from the depth."""
    idx, t, alpha, _ = _slab_topk(block, origins, dirs, axis, settings,
                                  table)
    weights, trans = composite_weights(alpha)
    d_rk = dirs[:, None, :].expand(-1, idx.shape[1], 3)
    color = sh_mod.eval_sh(block.sh_coeffs[idx], d_rk, settings.sh_degree)
    normal = gops.surfel_normal(block.log_scales[idx], block.quats[idx],
                                view_dir=d_rk)
    rows = torch.cat([
        color, block.emission[idx], block.metallic[idx][..., None],
        block.roughness[idx][..., None], normal,
        block.clearcoat[idx][..., None],
        block.clearcoat_roughness[idx][..., None],
        block.transmission[idx][..., None], t[..., None]], dim=-1)
    return torch.einsum("rk,rkf->rf", weights, rows), trans


def _slab_grid(tables: dict, meta: SlabAccelMeta,
               mesh: DeviceMesh) -> gt.GridAccel:
    """The GridAccel of this rank's slab tables. A rank marches exactly
    one slab, so the slab count must equal the gauss-axis size (the JAX
    package reads the first slab of a rank's shard and drops the rest)."""
    n_local = tables["btab"].shape[0]
    if n_local != 1:
        raise ValueError(
            f"grid slabs: this rank holds {n_local} slabs' tables; build "
            f"n_slabs = gauss-axis size ({axis_size(mesh, GAUSS_AXIS)}) "
            f"slabs and pass mesh.shard_scene(tables, mesh)")
    return gt.GridAccel(btab=tables["btab"][0], geom=tables["geom"][0],
                        packet=tables["packet"][0], lo=tables["lo"][0],
                        hi=tables["hi"][0], dims=meta.dims,
                        fill=tables["fill"][0], jump_unit=meta.jump_unit)


def _march_kw(origins) -> dict:
    """The reference's compact_min for the plain march; the kernel takes
    its default (it has no compaction)."""
    return dict(compact_min=PLAIN_COMPACT_MIN) \
        if origins.device.type == "cpu" else {}


def _grid_slab_trace_fn(accel: gt.GridAccel, settings: RenderSettings,
                        max_steps: int):
    """A slab's interaction through the grid march, in
    _slab_interaction_feats' channel order (bounce color is the march's
    degree <= 1 SH), with the march's frozen rays."""
    def slab_fn(_, origins, dirs, extra):
        trans, acc, frozen = gt.march(accel, origins, dirs, settings,
                                      max_steps, with_features=True,
                                      **_march_kw(origins))
        return acc[:, _GRID_COLUMNS], trans, frozen

    return slab_fn


def _grid_slab_vis_fn(accel: gt.GridAccel, settings: RenderSettings,
                      max_steps: int):
    def slab_fn(_, origins, dirs, t_end):
        trans, _, frozen = gt.march(accel, origins, dirs, settings,
                                    max_steps, t_end=t_end,
                                    with_features=False,
                                    **_march_kw(origins))
        return torch.zeros((origins.shape[0], 0), device=origins.device), \
            trans, frozen

    return slab_fn


def _warn_frozen(frozen: torch.Tensor, what: str, max_steps: int):
    n = int(frozen.sum())
    if n > 0:
        get_logger().warning(
            "%s truncation: %d ray-slab marches still alive after "
            "max_steps=%d occupied cells — their accumulation is partial; "
            "raise max_steps if the far field matters", what, n, max_steps)
    return torch.tensor(n, dtype=torch.int64, device=frozen.device)


def trace_spatial(scene_slabbed: GaussianScene, rays: Rays,
                  settings: RenderSettings, mesh: DeviceMesh,
                  axis=(0.0, 0.0, 1.0), slab_accel: Optional[dict] = None,
                  accel_meta: Optional[SlabAccelMeta] = None,
                  max_steps: int = 128) -> dict:
    """``trace_dense``-compatible aggregate interaction over partitioned
    slabs, for this rank's block of rays (layout as :func:`render_spatial`).

    With ``slab_accel`` (this rank's block of :func:`build_slab_accels`'
    tables) and ``accel_meta``, each slab's interaction runs through the
    grid march in place of the dense top-K composite, and the result
    carries ``frozen_alive``: the rank's rays' marches (one a slab) still
    alive after ``max_steps`` occupied cells, summed over the ring. The
    dense path is differentiable in the slab's leaves; the grid path is
    not.
    """
    axis_v = _unit_axis(axis).to(rays.origins.device)
    frozen_alive = None
    if slab_accel is not None:
        accel = _slab_grid(slab_accel, accel_meta, mesh)
        with torch.no_grad():
            feats, trans, frozen = _ring_composite(
                None, rays.origins, rays.directions, None, mesh, axis_v,
                _grid_slab_trace_fn(accel, settings, max_steps), 15)
        frozen_alive = _warn_frozen(frozen, "grid slab trace", max_steps)
    else:
        block = replicated_input(scene_slabbed, mesh, (RAY_AXIS,))
        table = _slab_table(block, settings)

        def slab_fn(blk, o, d, extra):
            feats, trans = _slab_interaction_feats(blk, o, d, axis_v,
                                                   settings, table)
            return feats, trans, None

        feats, trans, _ = _ring_composite(block, rays.origins,
                                          rays.directions, None, mesh,
                                          axis_v, slab_fn, 15)
    alpha_acc = 1.0 - trans
    denom = torch.clamp_min(alpha_acc, 1e-8)
    depth = feats[:, 14] / denom
    out = dict(
        albedo=feats[:, 0:3],
        radiance_emitted=feats[:, 3:6],
        metallic=feats[:, 6] / denom,
        roughness=feats[:, 7] / denom,
        normal=safe_normalize(feats[:, 8:11]),
        clearcoat=feats[:, 11] / denom,
        cc_roughness=feats[:, 12] / denom,
        transmission=feats[:, 13] / denom,
        depth=depth,
        position=rays.origins + depth[:, None] * rays.directions,
        alpha_acc=alpha_acc,
        trans=trans,
        hit=alpha_acc > settings.hit_opacity_threshold,
    )
    if frozen_alive is not None:
        out["frozen_alive"] = frozen_alive
    return out


def visibility_spatial(scene_slabbed: GaussianScene, origins, directions,
                       t_end, settings: RenderSettings, mesh: DeviceMesh,
                       axis=(0.0, 0.0, 1.0),
                       slab_accel: Optional[dict] = None,
                       accel_meta: Optional[SlabAccelMeta] = None,
                       max_steps: int = 128, return_frozen: bool = False):
    """Shadow transmittance (r,) over partitioned slabs for this rank's
    block of segments (layout as :func:`render_spatial`).

    The slabs' segment transmittances multiply in any order, but riding
    the same ring keeps the data movement the trace's. ``slab_accel``
    switches each slab's segment march to the grid (see
    :func:`trace_spatial`); ``return_frozen`` also returns the frozen
    count (0 on the dense slabs, which are exact).
    """
    axis_v = _unit_axis(axis).to(origins.device)
    if slab_accel is not None:
        accel = _slab_grid(slab_accel, accel_meta, mesh)
        with torch.no_grad():
            _, trans, frozen = _ring_composite(
                None, origins, directions, t_end, mesh, axis_v,
                _grid_slab_vis_fn(accel, settings, max_steps), 0)
        count = _warn_frozen(frozen, "grid slab visibility", max_steps)
        return (trans, count) if return_frozen else trans
    block = replicated_input(scene_slabbed, mesh, (RAY_AXIS,))
    table = _slab_table(block, settings)

    def slab_fn(blk, o, d, extra):
        vis = ref.visibility_dense(blk, o, d, extra, settings, table=table)
        return torch.zeros((o.shape[0], 0), device=o.device), vis, None

    _, trans, _ = _ring_composite(block, origins, directions, t_end, mesh,
                                  axis_v, slab_fn, 0)
    return (trans, 0) if return_frozen else trans
