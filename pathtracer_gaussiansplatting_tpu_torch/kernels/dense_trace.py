"""Dense ray-Gaussian trace and shadow visibility: kernel wrappers and
plain versions.

Counterpart of the (R, N) stages of
``pathtracer_gaussiansplatting_tpu/render/reference.py``: ``dense_topk``
(its ``dense_topk``: every Gaussian against every ray, the K nearest
contributors kept) and ``dense_visibility`` (its ``visibility_dense`` with
the active mask of ``render/pipeline.py:_dense_vis``). Both evaluate the
Gaussians from one (N, 16) table, :func:`gaussian_table`.

For CUDA tensors they launch the CUDA kernels ``csrc/dense_topk.cu``
(counted in ``launch.launches`` under "dense_topk": a warp a ray, its list
in shared or global memory, for every K) and ``csrc/dense_visibility.cu``
(under "dense_visibility"); for CPU tensors they run ``dense_topk_plain``
and ``dense_visibility_plain``, the unculled math.
``dense_visibility_pairs`` (the shadow product with the list of its pairs
with alpha > 0, for its gradient) launches the visibility kernel in its
two listing modes (under "dense_visibility_pairs"), or runs
``dense_visibility_pairs_plain``. There is no fallback from the card to
the plain versions: a CUDA input either launches the kernel or raises.

The kernels skip a pair whose mean lies farther from the ray's line than
the Gaussian can reach (:func:`dense_cull_keep` is the same predicate in
torch, for the tests; ``csrc/dense_common.cuh`` derives its radii), and a
whole group of 32 rows that the ray (the top-K kernel) or none of the
warp's segments (the shadow kernel) can reach (:func:`dense_group_keep`):
the kernels read the rows in Morton order of the means, with each group's
bounding sphere (:class:`DenseTable`). The top-K kernel first skips each
super-group of 32 groups the ray cannot reach (:func:`dense_super_keep`).
A culled pair has alpha = 0 in the exact math as well, so the top-K kernel
stays bit-equal to ``dense_topk_plain`` (equal keys go by index, as the
plain version's stable sort has them) and a culled shadow factor is
exactly 1.

``dense_composite`` composites the top-K lists with the Gaussians' shading
features from a per-Gaussian table (:func:`composite_table`): on CUDA
tensors the kernel ``csrc/dense_composite.cu`` (counted under
"dense_composite": a warp a ray, only the filled entries read), on CPU
tensors ``dense_composite_plain``, the gathers, SH, normal flip, cumprod
and weighted sums of ``render/reference.trace_dense`` in torch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)

# mean (3), M = diag(1/s) R^T row-major (9), opacity, and the cull radii:
# R0 of the trace, R1, R0 of a shadow segment. 64 bytes a row.
TABLE_COLS = 16
COL_R0_TRACE, COL_R1, COL_R0_SHADOW = 13, 14, 15
# The top-K kernel (a warp a ray) keeps a ray's list sorted in shared
# memory up to LIST_SHARED_MAX_K, and past that in a global scratch of at
# most LIST_SCRATCH_BYTES a launch (the rays go in chunks).
LIST_SHARED_MAX_K = 1024
LIST_SCRATCH_BYTES = 1 << 30

# Rows a group sphere bounds (a warp's cull step, csrc/dense_common.cuh),
# and its columns: center (3), radius, the group's largest R0 of the trace,
# R1 and R0 of a shadow segment, 0. A super-group sphere bounds
# SUPER_GROUPS consecutive groups' spheres, in the same columns.
GROUP_ROWS, GROUP_COLS, SUPER_GROUPS = 32, 8, 32

# dense_composite's outputs a ray: the transmittance, then the weighted
# sums of SH colour (3), emission (3), the viewer-facing normal (3), t and
# the five materials (metallic, roughness, clearcoat, its roughness,
# transmission).
COMPOSITE_OUT = 16
PLAIN_CHUNK_ELEMS = 1 << 24  # (rays, N) pairs per plain-version chunk

# The cull's margins (csrc/dense_common.cuh derives them): the relative
# slack of both sides, the absolute slack in q for expf and the cutoffs'
# rounding, and float32's unit roundoff.
CULL_DELTA, CULL_Q_ABS, _EPS = 0.01, 1e-5, 2.0 ** -24


def cull_radii(log_scales: torch.Tensor, opacities: torch.Tensor,
               settings: RenderSettings):
    """(R0 of the trace, R1, R0 of a shadow segment), each (N,) float32:
    a pair is culled where |x × d|^2 > |d|^2 (R0 + R1 (|x|^2 + tau^2
    |d|^2)), x = o - mean. R0 = sigma_max^2 (q_lim + CULL_Q_ABS), with
    q_lim = min(sigma_cut^2, 2 ln(opac / alpha_min)) for the trace and
    2 ln(opac / alpha_min) for a segment; -inf (always culled) where opac
    lies below alpha_min by more than the slack. Computed in float64 from
    the float32 inverse scales that M is built from."""
    inv_s = torch.exp(-log_scales).double()
    s_max = 1.0 / inv_s.min(dim=-1).values
    rho = s_max * inv_s.max(dim=-1).values
    grow = (1.0 + CULL_DELTA) * (1.0 + 32.0 * _EPS * rho)
    ln_term = 2.0 * torch.log(opacities.double() / settings.alpha_min)

    def r0(q_raw):
        r = s_max * s_max * (torch.clamp_min(q_raw, 0.0) + CULL_Q_ABS) * grow
        return torch.where(q_raw < -CULL_Q_ABS, -math.inf, r).float()

    per_x2 = 56.0 * _EPS + 108.0 * _EPS * _EPS * (1.0 + rho) ** 2 / CULL_DELTA
    r1 = (rho * rho * per_x2 * (1.0 + 1e-4) + 16.0 * _EPS) * grow
    return (r0(torch.clamp_max(ln_term, settings.sigma_cut ** 2)), r1.float(),
            r0(ln_term))


def gaussian_table(scene: GaussianScene,
                   settings: RenderSettings) -> torch.Tensor:
    """The (N, 16) float32 table both kernels read: mean, the canonical
    transform M = diag(1/s) R^T row-major, opacity, and the cull radii of
    :func:`cull_radii` for ``settings``' sigma_cut and alpha_min. A table
    serves only the scene (and the sigma_cut and alpha_min) it was built
    from. The plain versions differentiate through its first 13 columns;
    the kernels' outputs carry no gradient."""
    m = gops.canonical_transforms(scene.log_scales, scene.quats)
    opac = scene.opacities
    with torch.no_grad():
        radii = cull_radii(scene.log_scales, opac, settings)
    return torch.cat([scene.means, m.reshape(-1, 9), opac[:, None],
                      *(x[:, None] for x in radii)], dim=-1).contiguous()


@dataclasses.dataclass(frozen=True)
class DenseTable:
    """A :func:`gaussian_table` as the kernels read it (:func:`dense_table`).

    rows (N, 16): the table in index order (the plain versions' and the
    top-K kernel's final t and alpha); sorted_rows (N, 16): the rows in
    Morton order of the means, which the kernels stage; order (N,) int32:
    each sorted row's index; groups (ceil(N / 32), 8): each 32 rows of
    sorted_rows as a sphere around all their means (center, radius) and
    their largest R0 of the trace, R1 and R0 of a shadow segment; supers
    (ceil(groups / 32), 8): each 32 groups as a sphere around all their
    spheres and their largest radii, in the same columns (the top-K
    kernel tests these first); cull (5, N): the top-K kernel's per-pair
    cull operands of sorted_rows, a column each (mean x, y, z, R0 of the
    trace, R1), so that a warp's 32 rows are five 128-byte reads.
    """

    rows: torch.Tensor
    sorted_rows: torch.Tensor
    order: torch.Tensor
    groups: torch.Tensor
    supers: torch.Tensor
    cull: torch.Tensor


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """10-bit integers with two zero bits after each bit (a Morton axis)."""
    v = v & 0x3FF
    for shift, mask in ((16, 0x30000FF), (8, 0x300F00F), (4, 0x30C30C3),
                        (2, 0x9249249)):
        v = (v | (v << shift)) & mask
    return v


def morton_order(means: torch.Tensor) -> torch.Tensor:
    """(N,) int64: the permutation that sorts (N, 3) ``means`` by the
    30-bit Morton code of their place in the means' bounding box, equal
    codes by index."""
    with torch.no_grad():
        mean = means.double()
        lo, hi = mean.amin(0), mean.amax(0)
        q = torch.clamp(((mean - lo) / torch.clamp_min(hi - lo, 1e-30)
                         * 1023.0).long(), 0, 1023)
        code = _spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1) \
            | (_spread_bits(q[:, 2]) << 2)
        return torch.argsort(code, stable=True)


def dense_table(table: torch.Tensor) -> DenseTable:
    """The :class:`DenseTable` the kernels read, of a (N, 16)
    :func:`gaussian_table`: its rows in :func:`morton_order` of their
    means (:func:`table_in_order`)."""
    return table_in_order(table, morton_order(table[:, :3]))


def _in_blocks(x: torch.Tensor, size: int) -> torch.Tensor:
    """(ceil(n / size), size, ...) float64: x's rows in consecutive blocks,
    the last padded with its last row."""
    n = x.shape[0]
    blocks = -(-n // size)
    return torch.cat([x, x[-1:].expand(blocks * size - n, *x.shape[1:])]
                     ).reshape(blocks, size, *x.shape[1:]).double()


def _center(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, 3) float64: the center of each box [lo, hi], rounded to
    float32."""
    return ((lo + hi) / 2).float().double()


def _spheres(center: torch.Tensor, reach: torch.Tensor,
             radii: torch.Tensor) -> torch.Tensor:
    """(B, 8) float32 spheres of B blocks of S members: the center (B, 3);
    the radius, the members' largest reach (B, S) beyond it (float64,
    rounded outward); the members' largest radii (B, S, 3); 0."""
    radius = reach.amax(1) * (1.0 + 1e-6)
    return torch.cat([center, radius[:, None], radii.amax(1),
                      torch.zeros_like(radius[:, None])], dim=-1).float()


def table_in_order(table: torch.Tensor, order: torch.Tensor) -> DenseTable:
    """The :class:`DenseTable` of a (N, 16) :func:`gaussian_table` with its
    rows staged in ``order`` (a permutation of N), each 32-row group's
    sphere around its means and each 32-group super-group's sphere around
    its groups' spheres, computed in float64 and rounded outward."""
    with torch.no_grad():
        sorted_rows = table.detach()[order].contiguous()
        rows = _in_blocks(sorted_rows, GROUP_ROWS)
        m = rows[..., :3]
        center = _center(m.amin(1), m.amax(1))
        groups = _spheres(center, (m - center[:, None]).norm(dim=-1),
                          rows[..., COL_R0_TRACE:]).contiguous()
        sph = _in_blocks(groups, SUPER_GROUPS)
        c, r = sph[..., :3], sph[..., 3]
        center = _center((c - r[..., None]).amin(1),
                         (c + r[..., None]).amax(1))
        supers = _spheres(center, (c - center[:, None]).norm(dim=-1) + r,
                          sph[..., 4:7]).contiguous()
        cull = sorted_rows[:, [0, 1, 2, COL_R0_TRACE, COL_R1]].t()
        return DenseTable(rows=table, sorted_rows=sorted_rows,
                          order=order.to(torch.int32), groups=groups,
                          supers=supers, cull=cull.contiguous())


def _unpack(table: torch.Tensor):
    """(mean (1, N, 3), M (1, N, 3, 3), opacity (1, N)) of the table."""
    return (table[None, :, 0:3], table[None, :, 3:12].reshape(1, -1, 3, 3),
            table[None, :, 12])


def _ray_chunks(n_rays: int, n_gauss: int):
    step = max(1, PLAIN_CHUNK_ELEMS // max(n_gauss, 1))
    return [(s, min(s + step, n_rays)) for s in range(0, n_rays, step)]


def _gval_cut(settings: RenderSettings) -> float:
    return math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)


def dense_topk_plain(origins: torch.Tensor, dirs: torch.Tensor,
                     table: torch.Tensor, k: int, settings: RenderSettings,
                     sort_depths: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the top-K trace, in chunks of about
    ``PLAIN_CHUNK_ELEMS`` (ray, Gaussian) pairs; a chunk's rays are
    independent, so chunking changes no bit.

    Returns idx (R, K) int32, t (R, K) and alpha (R, K) float32 in
    ascending key order (t, or ``sort_depths``), equal keys in index
    order; slots past the contributors hold idx 0, t = t_max, alpha 0, as
    do all slots of a ray that ``active`` masks out.
    """
    mean, m, opac = _unpack(table)
    parts = []
    for s, e in _ray_chunks(origins.shape[0], table.shape[0]):
        t, gval = gops.peak_response(origins[s:e, None], dirs[s:e, None],
                                     mean, m, settings.t_min, settings.t_max)
        alpha = gops.alpha_from_response(opac, gval, settings.alpha_min,
                                         settings.alpha_max,
                                         settings.sigma_cut)
        key = t if sort_depths is None else sort_depths[None].expand_as(t)
        key = torch.where(alpha > 0.0, key, math.inf)
        # A stable sort keeps equal keys in index order, as lax.top_k does
        # (torch.topk makes no such promise).
        skey, order = torch.sort(key, dim=1, stable=True)
        skey, order = skey[:, :k], order[:, :k]
        valid = torch.isfinite(skey)
        if active is not None:
            valid = valid & active[s:e, None]
        parts.append((
            torch.where(valid, order, 0).to(torch.int32),
            torch.where(valid, torch.gather(t, 1, order), settings.t_max),
            torch.where(valid, torch.gather(alpha, 1, order), 0.0)))
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def dense_visibility_plain(origins: torch.Tensor, dirs: torch.Tensor,
                           t_end: torch.Tensor, table: torch.Tensor,
                           settings: RenderSettings,
                           active: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the shadow visibility: (R,)
    prod_i (1 - alpha_i) over the segments [t_min, t_end], 1 where
    ``active`` masks the ray out; in chunks of rays as
    :func:`dense_topk_plain`."""
    mean, m, opac = _unpack(table)
    parts = []
    for s, e in _ray_chunks(origins.shape[0], table.shape[0]):
        alpha = gops.segment_transmittance_alpha(
            origins[s:e, None], dirs[s:e, None], mean, m, opac,
            settings.t_min, t_end[s:e, None], settings.alpha_min,
            settings.alpha_max)
        parts.append(torch.prod(1.0 - alpha, dim=-1))
    vis = torch.cat(parts, dim=0)
    if active is not None:
        vis = torch.where(active, vis, 1.0)
    return vis


def dense_visibility_pairs_plain(origins: torch.Tensor, dirs: torch.Tensor,
                                 t_end: torch.Tensor, table: torch.Tensor,
                                 settings: RenderSettings,
                                 active: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`dense_visibility_pairs`: (vis (R,)
    as :func:`dense_visibility_plain`, seg (M,) int64, gid (M,) int64),
    the (segment, Gaussian) pairs with alpha > 0 in index order."""
    mean, m, opac = _unpack(table)
    vis, segs, gids = [], [], []
    for s, e in _ray_chunks(origins.shape[0], table.shape[0]):
        alpha = gops.segment_transmittance_alpha(
            origins[s:e, None], dirs[s:e, None], mean, m, opac,
            settings.t_min, t_end[s:e, None], settings.alpha_min,
            settings.alpha_max)
        if active is not None:
            alpha = torch.where(active[s:e, None], alpha, 0.0)
        vis.append(torch.prod(1.0 - alpha, dim=-1))
        seg, gid = torch.nonzero(alpha > 0.0, as_tuple=True)
        segs.append(seg + s)
        gids.append(gid)
    return torch.cat(vis), torch.cat(segs), torch.cat(gids)


def _ray_terms(dirs: torch.Tensor, settings: RenderSettings,
               t_end: Optional[torch.Tensor]):
    """(|d|^2, tau^2 |d|^2), each (R, 1): tau = t_min, or for a segment
    that ends before t_min, |t_end| (csrc/dense_common.cuh)."""
    d0, d1, d2 = (dirs[:, i:i + 1] for i in range(3))
    dd = d0 * d0 + d1 * d1 + d2 * d2
    if t_end is None:
        tau = torch.full_like(dd, settings.t_min)
    else:
        te = t_end[:, None]
        tau = torch.where(te >= settings.t_min, settings.t_min,
                          torch.clamp_min(te.abs(), settings.t_min))
    return dd, tau * tau * dd


def _line_terms(origins: torch.Tensor, dirs: torch.Tensor,
                points: torch.Tensor):
    """(x.d, |x|^2), each (R, P), x = o - point."""
    x = origins[:, None, :] - points[None]
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    d0, d1, d2 = (dirs[:, i:i + 1] for i in range(3))
    return x0 * d0 + x1 * d1 + x2 * d2, x0 * x0 + x1 * x1 + x2 * x2


def dense_cull_keep(origins: torch.Tensor, dirs: torch.Tensor,
                    table: torch.Tensor, settings: RenderSettings,
                    t_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, N) bool: the pairs that the kernels' cull keeps (evaluate
    exactly), for the trace or, given ``t_end`` (R,), for shadow segments.
    The predicate of ``csrc/dense_common.cuh:cull_keep`` in torch, for the
    tests and for counting the kernels' work; the card's FMA contraction
    may round it differently, which the radii allow for. Unchunked."""
    dd, tt = _ray_terms(dirs, settings, t_end)
    xd, xx = _line_terms(origins, dirs, table[:, 0:3])
    r0 = table[None, :, COL_R0_TRACE if t_end is None else COL_R0_SHADOW]
    r1 = table[None, :, COL_R1]
    return ~(xx * dd - xd * xd > dd * (r0 + r1 * (xx + tt)))


def _sphere_keep(origins: torch.Tensor, dirs: torch.Tensor,
                 spheres: torch.Tensor, settings: RenderSettings,
                 t_end: Optional[torch.Tensor]) -> torch.Tensor:
    """(R, B) bool: ``csrc/dense_common.cuh:group_keep`` in torch on B
    (B, 8) spheres (a DenseTable's groups or supers)."""
    dd, tt = _ray_terms(dirs, settings, t_end)
    xd, xx = _line_terms(origins, dirs, spheres[:, 0:3])
    rad = spheres[None, :, 3]
    r0 = spheres[None, :, 4 if t_end is None else 6]
    dist = torch.sqrt(torch.clamp_min(xx * dd - xd * xd - 1e-5 * xx * dd, 0.0)
                      / dd)
    length = torch.sqrt(xx)
    lo = dist * (1.0 - 1e-6) - rad * (1.0 + 1e-6) - 1e-6 * length
    far = length * (1.0 + 1e-5) + rad
    return ~((lo > 0.0)
             & (lo * lo > (r0 + spheres[None, :, 5] * (far * far + tt))
                * 1.001))


def dense_group_keep(origins: torch.Tensor, dirs: torch.Tensor,
                     table: DenseTable, settings: RenderSettings,
                     t_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, groups) bool: the 32-row groups of ``table.sorted_rows`` that
    each ray may reach (``csrc/dense_common.cuh:group_keep`` in torch);
    for the trace or, given ``t_end``, for shadow segments."""
    return _sphere_keep(origins, dirs, table.groups, settings, t_end)


def dense_super_keep(origins: torch.Tensor, dirs: torch.Tensor,
                     table: DenseTable, settings: RenderSettings
                     ) -> torch.Tensor:
    """(R, supers) bool: the super-groups of 32 groups that each ray may
    reach, the top-K kernel's first test (the same predicate on
    ``table.supers``). A super-group's sphere holds its groups' spheres,
    so every mean of its rows, and its radii are their largest: a
    super-group this test drops holds no pair the per-pair cull would keep
    in exact arithmetic, as for a group."""
    return _sphere_keep(origins, dirs, table.supers, settings, None)


def _dense(name: str, table, tensors: dict):
    """(the table's rows, its DenseTable on the card or None on the CPU);
    a bare (N, 16) table is staged here, on every call."""
    rows = table.rows if isinstance(table, DenseTable) else table
    if launch.on_cpu(name, dict(tensors, table=rows)):
        return rows, None
    return rows, table if isinstance(table, DenseTable) else dense_table(rows)


def _check_table(name: str, dtab: DenseTable, tensors: dict,
                 expect: dict) -> None:
    """Checks the kernel's inputs and the DenseTable's tensors."""
    n = dtab.rows.shape[0]
    n_groups = -(-n // GROUP_ROWS)
    tensors = dict(tensors, rows=dtab.rows, sorted_rows=dtab.sorted_rows,
                   order=dtab.order, groups=dtab.groups, supers=dtab.supers,
                   cull=dtab.cull)
    # The kernels stage the sorted rows with 16-byte copies.
    launch.check(name, tensors, dict(
        expect, rows=(n, TABLE_COLS), sorted_rows=(n, TABLE_COLS),
        order=(n,), groups=(n_groups, GROUP_COLS),
        supers=(-(-n_groups // SUPER_GROUPS), GROUP_COLS), cull=(5, n)),
        dtypes=dict(active=torch.bool, order=torch.int32),
        aligned=("sorted_rows",))


Table = Union[torch.Tensor, DenseTable]


def dense_topk(origins: torch.Tensor, dirs: torch.Tensor, table: Table,
               k: int, settings: RenderSettings,
               sort_depths: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None):
    """The K nearest contributing Gaussians of every ray (see
    :func:`dense_topk_plain` for the outputs). CPU tensors run the plain
    version; CUDA tensors launch ``csrc/dense_topk.cu``, bit-equal to it
    at every K: one launch, or one a chunk of rays where the lists go to
    global memory (K above ``LIST_SHARED_MAX_K``).

    Args: origins, dirs (R, 3); table: the (N, 16) :func:`gaussian_table`
    for this scene and ``settings``, or its :func:`dense_table` (built once
    for the card); 1 <= k <= N; sort_depths (N,) to order by in place of
    t; active (R,) bool.
    """
    tensors = dict(origins=origins, dirs=dirs)
    if sort_depths is not None:
        tensors["sort_depths"] = sort_depths
    if active is not None:
        tensors["active"] = active
    rows, dtab = _dense("dense_topk", table, tensors)
    if dtab is None:
        return dense_topk_plain(origins, dirs, rows, k, settings,
                                sort_depths, active)
    r, n = origins.shape[0], rows.shape[0]
    _check_table("dense_topk", dtab, tensors, dict(
        origins=(r, 3), dirs=(r, 3), sort_depths=(n,), active=(r,)))
    if not 1 <= k <= n:
        raise ValueError(f"dense_topk: K={k} must lie in [1, N={n}]")
    dev = origins.device
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    t = torch.empty((r, k), dtype=torch.float32, device=dev)
    alpha = torch.empty((r, k), dtype=torch.float32, device=dev)
    if r == 0:
        return idx, t, alpha
    # The kernel reads the sort depths in the staged (sorted) order.
    sd = None if sort_depths is None \
        else sort_depths.index_select(0, dtab.order)
    table_args = (rows.data_ptr(), dtab.sorted_rows.data_ptr(),
                  dtab.order.data_ptr(), dtab.groups.data_ptr(),
                  dtab.supers.data_ptr(), dtab.cull.data_ptr(), launch.ptr(sd))
    params = (settings.t_min, settings.t_max, settings.alpha_min,
              settings.alpha_max, _gval_cut(settings))
    # Lists past LIST_SHARED_MAX_K live in a (rays, 2K) int64 scratch, a
    # chunk of rays a launch.
    step, lists = r, None
    if k > LIST_SHARED_MAX_K:
        step = max(1, min(r, LIST_SCRATCH_BYTES // (16 * k)))
        lists = torch.empty((step, 2 * k), dtype=torch.int64, device=dev)
    for s in range(0, r, step):
        e = min(s + step, r)
        launch.launch(
            "dense_topk", "ptgs_dense_topk", origins[s:e].data_ptr(),
            dirs[s:e].data_ptr(), *table_args,
            launch.ptr(None if active is None else active[s:e]),
            launch.ptr(lists), idx[s:e].data_ptr(), t[s:e].data_ptr(),
            alpha[s:e].data_ptr(), e - s, n, k, *params, device=dev,
            count="dense_topk")
    return idx, t, alpha


def dense_visibility(origins: torch.Tensor, dirs: torch.Tensor,
                     t_end: torch.Tensor, table: Table,
                     settings: RenderSettings,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shadow visibility (R,) of the segments [t_min, t_end] (see
    :func:`dense_visibility_plain`; ``table`` as for :func:`dense_topk`).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/dense_visibility.cu``."""
    tensors = dict(origins=origins, dirs=dirs, t_end=t_end)
    if active is not None:
        tensors["active"] = active
    rows, dtab = _dense("dense_visibility", table, tensors)
    if dtab is None:
        return dense_visibility_plain(origins, dirs, t_end, rows, settings,
                                      active)
    r, n = origins.shape[0], rows.shape[0]
    _check_table("dense_visibility", dtab, tensors, dict(
        origins=(r, 3), dirs=(r, 3), t_end=(r,), active=(r,)))
    vis = torch.empty((r,), dtype=torch.float32, device=origins.device)
    if r == 0 or n == 0:
        return vis.fill_(1.0)
    launch.launch("dense_visibility", "ptgs_dense_visibility",
                  origins.data_ptr(), dirs.data_ptr(), t_end.data_ptr(),
                  dtab.sorted_rows.data_ptr(), dtab.groups.data_ptr(),
                  launch.ptr(active), vis.data_ptr(), r, n, settings.t_min,
                  settings.alpha_min, settings.alpha_max,
                  device=origins.device, count="dense_visibility")
    return vis


def dense_visibility_pairs(origins: torch.Tensor, dirs: torch.Tensor,
                           t_end: torch.Tensor, table: Table,
                           settings: RenderSettings,
                           active: Optional[torch.Tensor] = None):
    """The shadow visibility with its pairs: (vis (R,), seg (M,) int64,
    gid (M,) int64), vis as :func:`dense_visibility` gives it and the
    (segment, Gaussian) pairs with alpha > 0, grouped by segment (each
    segment's in the order the kernel met them). CPU tensors run
    :func:`dense_visibility_pairs_plain`; CUDA tensors launch
    ``csrc/dense_visibility.cu`` twice: its counting mode (vis and each
    segment's count), then, at the counts' prefix sum, its listing mode.
    Every pair is listed: the list is sized from the counts."""
    tensors = dict(origins=origins, dirs=dirs, t_end=t_end)
    if active is not None:
        tensors["active"] = active
    rows, dtab = _dense("dense_visibility_pairs", table, tensors)
    if dtab is None:
        return dense_visibility_pairs_plain(origins, dirs, t_end, rows,
                                            settings, active)
    r, n = origins.shape[0], rows.shape[0]
    _check_table("dense_visibility_pairs", dtab, tensors, dict(
        origins=(r, 3), dirs=(r, 3), t_end=(r,), active=(r,)))
    dev = origins.device
    vis = torch.ones((r,), dtype=torch.float32, device=dev)
    counts = torch.zeros((r,), dtype=torch.int32, device=dev)
    if r == 0 or n == 0:
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        return vis, empty, empty
    args = (settings.t_min, settings.alpha_min, settings.alpha_max)
    launch.launch("dense_visibility_pairs", "ptgs_dense_visibility_count",
                  origins.data_ptr(), dirs.data_ptr(), t_end.data_ptr(),
                  dtab.sorted_rows.data_ptr(), dtab.groups.data_ptr(),
                  launch.ptr(active), vis.data_ptr(), counts.data_ptr(), r, n,
                  *args, device=dev, count="dense_visibility_pairs")
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    offsets = (ends - counts).contiguous()
    gid = torch.empty((int(ends[-1]),), dtype=torch.int32, device=dev)
    if gid.numel():
        launch.launch("dense_visibility_pairs", "ptgs_dense_visibility_pairs",
                      origins.data_ptr(), dirs.data_ptr(), t_end.data_ptr(),
                      dtab.sorted_rows.data_ptr(), dtab.groups.data_ptr(),
                      dtab.order.data_ptr(), launch.ptr(active),
                      offsets.data_ptr(), gid.data_ptr(), r, n, *args,
                      device=dev, count="dense_visibility_pairs")
    seg = torch.repeat_interleave(
        torch.arange(r, device=dev), counts.long(), output_size=gid.numel())
    return vis, seg, gid.long()


def composite_cols(degree: int) -> int:
    """Columns of a :func:`composite_table` row at SH degree ``degree``:
    3 (degree + 1)^2 SH coefficients, emission (3), five materials and the
    normal (3), padded to a multiple of 4 (16 bytes)."""
    return -(-(3 * (degree + 1) ** 2 + 11) // 4) * 4


def composite_degree(scene: GaussianScene, settings: RenderSettings) -> int:
    """The SH degree the trace evaluates: ``settings.sh_degree``, else the
    one the scene's coefficients imply (as ``core/sh.eval_sh``)."""
    return scene.sh_degree if settings.sh_degree is None \
        else settings.sh_degree


def composite_table(scene: GaussianScene, degree: int) -> torch.Tensor:
    """The (N, :func:`composite_cols`) float32 feature table that
    :func:`dense_composite` reads, a row a Gaussian: its first
    (degree + 1)^2 SH coefficients (coefficient-major), emission, metallic,
    roughness, clearcoat, clearcoat roughness, transmission and the
    unflipped shortest-axis normal (``ops/gaussians.surfel_normal``), then
    zeros. Carries no gradient; serves only the scene it was built from."""
    kb = (degree + 1) ** 2
    n = scene.num_gaussians
    with torch.no_grad():
        parts = [scene.sh_coeffs[:, :kb].reshape(n, 3 * kb), scene.emission,
                 *(x[:, None] for x in (
                     scene.metallic, scene.roughness, scene.clearcoat,
                     scene.clearcoat_roughness, scene.transmission)),
                 gops.surfel_normal(scene.log_scales, scene.quats)]
        used = sum(p.shape[1] for p in parts)
        parts.append(scene.means.new_zeros((n, composite_cols(degree) - used)))
        return torch.cat(parts, dim=-1).contiguous()


def dense_composite_plain(idx: torch.Tensor, t: torch.Tensor,
                          alpha: torch.Tensor, dirs: torch.Tensor,
                          table: torch.Tensor, degree: int) -> torch.Tensor:
    """Plain PyTorch version of the composite: (R, COMPOSITE_OUT) float32,
    the transmittance prod (1 - alpha) and the sums over the K slots of w
    times the slot's SH colour (``core/sh.eval_sh`` at ``dirs``), emission,
    normal flipped to face the viewer, t and materials, with w the
    front-to-back weights of ``ops/composite.composite_weights``: the
    operations of ``render/reference.trace_dense`` on the table's rows."""
    kb = (degree + 1) ** 2
    r, k = idx.shape
    rows = table[idx.long()]
    d = dirs[:, None, :]
    color = sh_mod.eval_sh(rows[..., :3 * kb].reshape(r, k, kb, 3),
                           d.expand(r, k, 3), degree)
    n = rows[..., 3 * kb + 8:3 * kb + 11]
    # surfel_normal's flip test, summed in one fixed order (the kernel's).
    flip = (n[..., 0:1] * d[..., 0:1] + n[..., 1:2] * d[..., 1:2]
            + n[..., 2:3] * d[..., 2:3]) > 0
    feats = torch.cat([color, rows[..., 3 * kb:3 * kb + 3],
                       torch.where(flip, -n, n), t[..., None],
                       rows[..., 3 * kb + 3:3 * kb + 8]], dim=-1)
    weights, trans = composite_weights(alpha)
    return torch.cat([trans[:, None],
                      torch.einsum("rk,rkf->rf", weights, feats)], dim=-1)


def dense_composite(idx: torch.Tensor, t: torch.Tensor, alpha: torch.Tensor,
                    dirs: torch.Tensor, table: torch.Tensor,
                    degree: int) -> torch.Tensor:
    """The composite of the top-K lists idx (R, K) int32, t and alpha (R, K)
    (``dense_topk``'s) with the feature table (N, cols) of
    :func:`composite_table` at SH degree ``degree`` (0-3), for directions
    dirs (R, 3): (R, COMPOSITE_OUT) as :func:`dense_composite_plain`. CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/dense_composite.cu`` (one launch; the same outputs up to the
    order of the sums, and the same bits launch to launch)."""
    tensors = dict(t=t, alpha=alpha, dirs=dirs, table=table, idx=idx)
    if launch.on_cpu("dense_composite", tensors):
        return dense_composite_plain(idx, t, alpha, dirs, table, degree)
    r, k = idx.shape
    if not 0 <= degree <= 3:
        raise ValueError(f"dense_composite: SH degree {degree} not in 0-3")
    launch.check("dense_composite", tensors, dict(
        t=(r, k), alpha=(r, k), dirs=(r, 3),
        table=(table.shape[0], composite_cols(degree)), idx=(r, k)),
        dtypes=dict(idx=torch.int32), aligned=("table",))
    out = torch.empty((r, COMPOSITE_OUT), dtype=torch.float32,
                      device=idx.device)
    if r == 0:
        return out
    launch.launch("dense_composite", "ptgs_dense_composite", idx.data_ptr(),
                  t.data_ptr(), alpha.data_ptr(), dirs.data_ptr(),
                  table.data_ptr(), r, k, degree, out.data_ptr(),
                  device=idx.device, count="dense_composite")
    return out
