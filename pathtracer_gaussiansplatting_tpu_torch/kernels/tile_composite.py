"""Fused per-tile ray-Gaussian compositing: packets, kernel wrapper, plain
version.

Counterpart of ``pathtracer_gaussiansplatting_tpu/kernels/tile_composite.py``:
``build_tile_packets`` (its ``build_tile_packets``), ``tile_composite`` (its
``tile_composite``: ``_fwd_kernel`` with ``_bwd_kernel`` as the custom VJP,
here the ``TileComposite`` autograd Function), ``tile_composite_plain`` (its
``_composite_math`` / ``_tile_composite_xla``) and
``tile_composite_bwd_plain`` (its ``jax.vjp`` of ``_tile_composite_xla``).
For a tile of P pixels and K depth-sorted Gaussian slots,

    a = d^T Q d,  b = d^T Q (o - mu),  c = (o - mu)^T Q (o - mu)
    t = clip(-b / a, t_min, t_max),  alpha = opac * exp(-q(t) / 2)

with Q the world-space inverse covariance, composited front to back into
(out (T, P, F), alpha_acc (T, P), depth (T, P)).

For CUDA tensors ``tile_composite`` launches the CUDA kernel
``csrc/tile_composite_fwd.cu`` and its backward launches
``csrc/tile_composite_bwd.cu``, the kernel that :func:`any_p_plan` picks
for the tile's P pixels: a block a tile, a thread a pixel, where P is a
multiple of 32 up to 256 (tiles of 16x16 or 8x8; counted in
``launch.launches`` under "tile_fwd" and "tile_bwd"); for any other P up to
2048 (tiles up to 45x45) a thread-block cluster a tile, a CTA a group of
256 pixels ("tile_fwd_cluster", "tile_bwd_cluster"); above that a block a
tile that takes its pixels in groups of 256 ("tile_fwd_group_loop",
"tile_bwd_group_loop"). For CPU tensors they run ``tile_composite_plain``
and ``tile_composite_bwd_plain``.
There is no fallback from the card to the plain versions or from one
kernel to another: a CUDA input either launches the planned kernel or
raises, a cluster the card cannot schedule included.

The packet gather is the autograd Function ``PacketGather``: its forward
is the plain gather (the same PyTorch operations on every device), its
backward on CUDA tensors the deterministic segment sum of
``csrc/packet_gather.cu`` (:func:`packet_gather_bwd`, counted under
"packet_gather_bwd") and on CPU tensors
:func:`packet_gather_bwd_plain`, autograd's own transpose of the gather.
"""
from __future__ import annotations

import ctypes
import math

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import rotmat_cols
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling

# Geometry packet rows (geom (T, 16, K)): Q upper triangle
# [q00, q11, q22, 2q01, 2q02, 2q12], Q (o - mu), c, opacity (0 where masked);
# rows 11-15 are zero.
ROW_C = 9
ROW_OPAC = 10
GEOM_ROWS = 16
TABLE_GEOM = ROW_OPAC + 1  # the gathered table's geometry columns
FEATURE_DIM = 14  # the packet features of render.tiled._packet_features

BLOCK_PIXELS = 256  # a block's threads: one tile of up to 16x16 pixels
MAX_CLUSTER_CTAS = 8  # the portable cluster size: tiles of up to 2048 pixels
PLAIN_CHUNK_ELEMS = 1 << 24  # (tiles, P, K) elements per plain-version chunk


def build_tile_packets(scene: GaussianScene, feats_all: torch.Tensor,
                       origin: torch.Tensor, tile_idx: torch.Tensor,
                       tile_mask: torch.Tensor):
    """Gather per-tile Gaussian packets for the compositor.

    Args:
      scene: the full scene; feats_all: (N, F) per-Gaussian features;
      origin: (3,) camera position; tile_idx / tile_mask: (T, K) binning
      tables.

    Returns dict: geom (T, 16, K), featsT (T, F, K) and count (T,) float32,
    1 + the index of the tile's last valid slot; geom and featsT are
    differentiable through :class:`PacketGather`.
    """
    geom, featsT, count = PacketGather.apply(
        packet_table(scene, feats_all, origin), tile_idx, tile_mask)
    return dict(geom=geom, featsT=featsT, count=count)


def packet_table(scene: GaussianScene, feats_all: torch.Tensor,
                 origin: torch.Tensor) -> torch.Tensor:
    """The (N, 11 + F) table the packets gather from: each Gaussian's
    geometry rows (geom's rows 0-10) seen from ``origin``, then its
    features."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotmat_cols(scene.quats)
    d0 = torch.exp(-2.0 * scene.log_scales[:, 0])
    d1 = torch.exp(-2.0 * scene.log_scales[:, 1])
    d2 = torch.exp(-2.0 * scene.log_scales[:, 2])
    q00 = r00 * r00 * d0 + r01 * r01 * d1 + r02 * r02 * d2
    q11 = r10 * r10 * d0 + r11 * r11 * d1 + r12 * r12 * d2
    q22 = r20 * r20 * d0 + r21 * r21 * d1 + r22 * r22 * d2
    q01 = r00 * r10 * d0 + r01 * r11 * d1 + r02 * r12 * d2
    q02 = r00 * r20 * d0 + r01 * r21 * d1 + r02 * r22 * d2
    q12 = r10 * r20 * d0 + r11 * r21 * d1 + r12 * r22 * d2
    ogx = origin[0] - scene.means[:, 0]
    ogy = origin[1] - scene.means[:, 1]
    ogz = origin[2] - scene.means[:, 2]
    wb0 = q00 * ogx + q01 * ogy + q02 * ogz
    wb1 = q01 * ogx + q11 * ogy + q12 * ogz
    wb2 = q02 * ogx + q12 * ogy + q22 * ogz
    c_all = wb0 * ogx + wb1 * ogy + wb2 * ogz

    # One (N, 11 + F) table, for one row gather.
    cols = [q00, q11, q22, 2.0 * q01, 2.0 * q02, 2.0 * q12,
            wb0, wb1, wb2, c_all, scene.opacities]
    return torch.cat([torch.stack(cols, dim=-1), feats_all], dim=-1)


def gather_packets(table: torch.Tensor, tile_idx: torch.Tensor,
                   tile_mask: torch.Tensor):
    """The packet gather from the table (N, 11 + F): (geom (T, 16, K),
    featsT (T, F, K), count (T,)), the opacity row 0 at masked slots."""
    rows = table[tile_idx.long()]                          # (T, K, 11 + F)
    t_total, k = tile_idx.shape
    geom = rows.new_zeros((t_total, GEOM_ROWS, k))
    geom[:, :ROW_OPAC] = rows[..., :ROW_OPAC].transpose(1, 2)
    geom[:, ROW_OPAC] = torch.where(tile_mask, rows[..., ROW_OPAC],
                                    torch.zeros_like(rows[..., ROW_OPAC]))
    featsT = rows[..., ROW_OPAC + 1:].transpose(1, 2).contiguous()
    slot1 = torch.arange(1, k + 1, dtype=torch.float32,
                         device=tile_idx.device)
    count = torch.amax(torch.where(tile_mask, slot1, torch.zeros_like(slot1)),
                       dim=-1)
    return geom, featsT, count


def packet_gather_bwd_plain(d_geom: torch.Tensor, d_featsT: torch.Tensor,
                            tile_idx: torch.Tensor, tile_mask: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Plain version of the gather's backward, autograd's transpose of
    :func:`gather_packets`: the rows' gradient (T, K, 11 + F), its opacity
    column 0 at masked slots, added into zeros (N, 11 + F) by index_put_
    with accumulate (PyTorch's indexing backward)."""
    d_opac = torch.where(tile_mask, d_geom[:, ROW_OPAC],
                         torch.zeros_like(d_geom[:, ROW_OPAC]))
    d_rows = torch.cat([d_geom[:, :ROW_OPAC].transpose(1, 2),
                        d_opac[..., None], d_featsT.transpose(1, 2)], dim=-1)
    return d_rows.new_zeros((n, d_rows.shape[-1])).index_put_(
        (tile_idx.long(),), d_rows, accumulate=True)


def packet_gather_bwd(d_geom: torch.Tensor, d_featsT: torch.Tensor,
                      tile_idx: torch.Tensor, tile_mask: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The gradient of the table (N, 11 + F) from d_geom (T, 16, K) and
    d_featsT (T, F, K): row g, column c < 11, the sum of d_geom[t, c, k]
    and column 11 + j of d_featsT[t, j, k] over the live slots (t, k)
    (tile_mask true) with tile_idx g, in ascending slot order from 0; a
    Gaussian in no live slot gets zeros. Masked slots are never read. On
    cotangents that are zero at masked slots (the tile backward's: their
    opacity is 0) this equals :func:`packet_gather_bwd_plain` bit for bit.

    CPU tensors go through :func:`packet_gather_bwd_plain`; CUDA tensors
    launch ``csrc/packet_gather.cu``'s three kernels with a cumsum between
    (one count under "packet_gather_bwd") or raise. While a profiler
    records, counts ``packet_slots`` (T x K) and ``packet_slots_live``.
    """
    t_total, k = tile_idx.shape
    profiling.count("packet_slots", t_total * k)
    profiling.count("packet_slots_live", tile_mask)
    tensors = dict(d_geom=d_geom, d_featsT=d_featsT, tile_idx=tile_idx,
                   tile_mask=tile_mask)
    if launch.on_cpu("packet_gather_bwd", tensors):
        return packet_gather_bwd_plain(d_geom, d_featsT, tile_idx, tile_mask,
                                       n)
    f = d_featsT.shape[1] if d_featsT.dim() == 3 else -1
    launch.check("packet_gather_bwd", tensors, dict(
        d_geom=(t_total, GEOM_ROWS, k), d_featsT=(t_total, f, k),
        tile_idx=(t_total, k), tile_mask=(t_total, k)),
        dtypes=dict(tile_idx=torch.int32, tile_mask=torch.bool))
    if TABLE_GEOM + f > 32 or t_total * k >= 2**31 or not 0 < n < 2**31:
        raise ValueError(f"packet_gather_bwd: 11 + F = {TABLE_GEOM + f} "
                         f"columns (at most 32 for a warp's lanes), "
                         f"T x K = {t_total * k} slots and N = {n} "
                         "Gaussians (each below 2^31, N above 0)")
    dev = d_geom.device
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    seg = torch.empty((t_total * k,), dtype=torch.int32, device=dev)
    d_table = torch.empty((n, TABLE_GEOM + f), dtype=torch.float32,
                          device=dev)
    launch.launch("packet_gather_bwd", "ptgs_packet_gather_count",
                  tile_idx.data_ptr(), tile_mask.data_ptr(), t_total * k, n,
                  cnt.data_ptr(), device=dev, count=None)
    ends = torch.cumsum(cnt, 0, dtype=torch.int32)
    launch.launch("packet_gather_bwd", "ptgs_packet_gather_reduce",
                  tile_idx.data_ptr(), tile_mask.data_ptr(), t_total * k, n,
                  k, f, ends.data_ptr(), cnt.data_ptr(), seg.data_ptr(),
                  d_geom.data_ptr(), d_featsT.data_ptr(), d_table.data_ptr(),
                  device=dev, count="packet_gather_bwd")
    return d_table


class PacketGather(torch.autograd.Function):
    """The packet gather (:func:`gather_packets`) with a backward that
    reads only the live slots (:func:`packet_gather_bwd`). Saves tile_idx
    and tile_mask, no gathered rows; count is not differentiable.

    The invariant the backward rests on: the cotangents of geom and featsT
    are zero at masked slots. The forward fills a masked slot with the
    geometry and features of the Gaussian its tile_idx names (the
    binning's 0) and only its opacity with 0, so the tile backward gives
    such a slot zero gradients. On CUDA tensors the backward never reads a
    masked slot; on CPU tensors autograd's transpose adds it in. For any
    consumer whose cotangents are not zero there, the two devices give
    different gradients: such a consumer zeroes them first."""

    @staticmethod
    def forward(ctx, table, tile_idx, tile_mask):
        geom, featsT, count = gather_packets(table, tile_idx, tile_mask)
        ctx.mark_non_differentiable(count)
        ctx.n = table.shape[0]
        ctx.save_for_backward(tile_idx, tile_mask)
        return geom, featsT, count

    @staticmethod
    def backward(ctx, d_geom, d_featsT, d_count):
        tile_idx, tile_mask = ctx.saved_tensors
        d_table = packet_gather_bwd(d_geom.contiguous(),
                                    d_featsT.contiguous(), tile_idx,
                                    tile_mask, ctx.n)
        return d_table, None, None


def chunk_size(k: int) -> int:
    """K-chunk size: 128 slots when K divides evenly, else one chunk."""
    return 128 if k % 128 == 0 else k


def cumprod_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along the last axis by Hillis-Steele doubling (the
    reference's expansion, kept for identical rounding)."""
    k = x.shape[-1]
    ones = torch.ones_like(x[..., :1])
    y = torch.cat([ones, x[..., :-1]], dim=-1)
    shift = 1
    while shift < k:
        y = y * torch.cat([ones.expand(*x.shape[:-1], shift), y[..., :-shift]],
                          dim=-1)
        shift *= 2
    return y


def _quadratic_ab(dirs: torch.Tensor, geom: torch.Tensor):
    """a = d^T Q d (before its clamp) and b = d^T Q (o - mu), (B, P, K),
    for dirs (B, P, 3) and geom (B, 16, K)."""
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]  # (B, P, 1)
    g = geom[:, :, None, :]                                  # (B, 16, 1, K)
    a = (dx * dx * g[:, 0] + dy * dy * g[:, 1] + dz * dz * g[:, 2]
         + dx * dy * g[:, 3] + dx * dz * g[:, 4] + dy * dz * g[:, 5])
    b = dx * g[:, 6] + dy * g[:, 7] + dz * g[:, 8]
    return a, b


def _t_alpha(a: torch.Tensor, b: torch.Tensor, geom: torch.Tensor,
             settings: RenderSettings):
    """(t, alpha) (B, P, K) of every (pixel, slot) pair from the quadratic
    forms (:func:`_quadratic_ab`), with the cutoffs and clamp."""
    g = geom[:, :, None, :]
    a = torch.clamp_min(a, 1e-12)
    t = torch.clamp(-b / a, settings.t_min, settings.t_max)
    qv = (a * t + 2.0 * b) * t + g[:, ROW_C]
    gval = torch.exp(-0.5 * torch.clamp_min(qv, 0.0))
    alpha0 = g[:, ROW_OPAC] * gval
    cut = math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)
    live = (gval >= cut) & (alpha0 >= settings.alpha_min)
    alpha = torch.where(live, torch.clamp_max(alpha0, settings.alpha_max),
                        torch.zeros_like(alpha0))
    return t, alpha


def _composite_from_ab(a: torch.Tensor, b: torch.Tensor, geom: torch.Tensor,
                       featsT: torch.Tensor, settings: RenderSettings):
    """Full-K composite (no chunking, no early exit) of a batch of tiles
    from their quadratic forms (:func:`_quadratic_ab`)."""
    t, alpha = _t_alpha(a, b, geom, settings)
    om = 1.0 - alpha
    excl = cumprod_excl(om)
    w = excl * alpha
    out = torch.matmul(w, featsT.transpose(1, 2))               # (B, P, F)
    alpha_acc = 1.0 - excl[..., -1] * om[..., -1]
    depth = torch.sum(w * t, dim=-1) / torch.clamp_min(alpha_acc, 1e-8)
    return out, alpha_acc, depth


def _composite_math(dirs: torch.Tensor, geom: torch.Tensor,
                    featsT: torch.Tensor, settings: RenderSettings):
    """Full-K composite (no chunking, no early exit) of a batch of tiles:
    dirs (B, P, 3), geom (B, 16, K), featsT (B, F, K)."""
    return _composite_from_ab(*_quadratic_ab(dirs, geom), geom, featsT,
                              settings)


def tile_composite_plain(packets, dirs: torch.Tensor,
                         settings: RenderSettings):
    """Plain PyTorch version of the fused composite, the reference's
    ``_tile_composite_xla`` semantics (full K, no chunk skipping), batched
    over tiles in chunks of about ``PLAIN_CHUNK_ELEMS`` (tiles, P, K)
    elements to bound its temporaries.

    Returns (out (T, P, F), alpha_acc (T, P), depth (T, P)).
    """
    geom, featsT = packets["geom"], packets["featsT"]
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    step = max(1, PLAIN_CHUNK_ELEMS // max(p * k, 1))
    parts = [_composite_math(dirs[s:s + step], geom[s:s + step],
                             featsT[s:s + step], settings)
             for s in range(0, t_total, step)]
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def tile_composite_bwd_plain(packets, dirs: torch.Tensor, cot,
                             settings: RenderSettings,
                             want_dirs: bool = True):
    """Plain PyTorch version of the backward: the VJP of
    :func:`tile_composite_plain` (full K, no chunk skipping), by autograd
    through :func:`_composite_math` recomputed chunk by chunk of tiles (the
    same ``PLAIN_CHUNK_ELEMS`` bound; tiles are independent).

    Args:
      packets: geom (T, 16, K), featsT (T, F, K); dirs: (T, P, 3);
      cot: cotangents (g_out (T, P, F), g_alpha (T, P), g_depth (T, P));
      want_dirs: False drops d_dirs (None in its place).

    Returns (d_geom (T, 16, K), d_featsT (T, F, K), d_dirs (T, P, 3)).
    """
    geom, featsT = packets["geom"], packets["featsT"]
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    step = max(1, PLAIN_CHUNK_ELEMS // max(p * k, 1))
    parts = []
    for s in range(0, t_total, step):
        ins = tuple(x[s:s + step].detach().requires_grad_()
                    for x in (geom, featsT, dirs))
        with torch.enable_grad():
            outs = _composite_math(ins[2], ins[0], ins[1], settings)
            parts.append(torch.autograd.grad(
                outs, ins, tuple(c[s:s + step] for c in cot)))
    d_geom, d_featsT, d_dirs = (torch.cat(x, dim=0) for x in zip(*parts))
    return d_geom, d_featsT, d_dirs if want_dirs else None


_PATH_CODES = {"one_block": 0, "cluster": 1, "group_loop": 2}
_CLUSTERS = {}  # (kernel, device, P, K, G) -> (max clusters, smem bytes)


def any_p_plan(p: int):
    """(path, G, threads): which kernel takes a tile of P pixels, with its
    CTAs a tile and threads a CTA. "one_block": P a multiple of 32 up to
    BLOCK_PIXELS, a block of P threads. "cluster": any other P up to
    MAX_CLUSTER_CTAS * BLOCK_PIXELS, a cluster of G = ceil(P / 256) CTAs,
    each of min(P, 256) threads rounded up to a warp. "group_loop": above,
    one block of 256 threads walking the tile's pixels in groups. The
    kernels' entry points hold their arguments to the same rule
    (``any_p_plan`` in ``csrc/tile_composite_common.cuh``)."""
    if p % 32 == 0 and p <= BLOCK_PIXELS:
        return "one_block", 1, p
    if p <= MAX_CLUSTER_CTAS * BLOCK_PIXELS:
        return ("cluster", -(-p // BLOCK_PIXELS),
                min(BLOCK_PIXELS, -(-p // 32) * 32))
    return "group_loop", 1, BLOCK_PIXELS


def one_block(p: int) -> bool:
    """Whether a tile of P pixels takes the kernels' thread-a-pixel block
    rather than an any-P kernel."""
    return any_p_plan(p)[0] == "one_block"


def cluster_occupancy(kernel: str, p: int, k: int, device, g: int = 0):
    """(clusters, smem bytes): cudaOccupancyMaxActiveClusters of the
    cluster kernel ``kernel`` ("fwd", "bwd" or "bwd_dirs") for tiles of P
    pixels and K slots on ``device`` (a CUDA device), and a CTA's dynamic
    shared memory; with g > 0, for clusters of g CTAs instead of
    any_p_plan(P)'s (above 8 the card's non-portable sizes). Cached by its
    arguments."""
    dev = torch.device(device)
    key = (kernel, dev.index, p, k, g)
    if key not in _CLUSTERS:
        n, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            if kernel == "fwd":
                err = launch.function("ptgs_tile_composite_fwd_clusters")(
                    p, g, ctypes.addressof(n))
            else:
                err = launch.function("ptgs_tile_composite_bwd_clusters")(
                    p, k, int(kernel == "bwd_dirs"), g, ctypes.addressof(n),
                    ctypes.addressof(smem))
        if err != 0:
            raise RuntimeError(f"cluster_occupancy({kernel}, P={p}, K={k}, "
                               f"g={g}): CUDA error {err}")
        _CLUSTERS[key] = (n.value, smem.value)
    return _CLUSTERS[key]


def _plan_args(name: str, kernel: str, p: int, k: int, device):
    """(path, (path code, G, threads)): the plan and its arguments for the
    entry points; for a cluster, raises unless the card can hold one (no
    other kernel takes the tile instead)."""
    path, g, threads = any_p_plan(p)
    if path == "cluster":
        n, smem = cluster_occupancy(kernel, p, k, device)
        if n == 0:
            raise RuntimeError(
                f"{name}: the card cannot schedule a cluster of {g} CTAs of "
                f"{threads} threads with {smem} B of dynamic shared memory "
                f"each (P={p}, K={k}; cudaOccupancyMaxActiveClusters = 0)")
    return path, (_PATH_CODES[path], g, threads)


def as_block_tiles(packets, dirs: torch.Tensor):
    """The same pixels as tiles of the one-block kernels' size, for holding
    the any-P kernels to them: each tile's P pixels padded with copies of
    its last one to a multiple of 32 (of 256 above 256) and cut into
    sub-tiles of up to 256, each with the tile's packets. Returns (packets,
    dirs (T * S, Q, 3), P), the first P pixels of each tile's S sub-tiles
    in order being the tile's."""
    t_total, p, _ = dirs.shape
    q = -(-p // 32) * 32 if p <= BLOCK_PIXELS else BLOCK_PIXELS
    padded = -(-p // q) * q
    dirs = torch.cat([dirs, dirs[:, -1:].expand(-1, padded - p, -1)], 1)
    s = padded // q
    return ({key: v.repeat_interleave(s, 0) for key, v in packets.items()},
            dirs.reshape(t_total * s, q, 3).contiguous(), p)


def kernel_settings(settings: RenderSettings):
    cut = math.exp(-0.5 * settings.sigma_cut * settings.sigma_cut)
    return (settings.t_min, settings.t_max, settings.alpha_min,
            settings.alpha_max, cut, settings.transmittance_min)


def _fwd(geom, featsT, dirs, count, settings: RenderSettings):
    """Forward dispatch: the plain version on the CPU, the kernel on the
    card."""
    tensors = dict(dirs=dirs, geom=geom, featsT=featsT, count=count)
    if launch.on_cpu("tile_composite", tensors):
        return tile_composite_plain(dict(geom=geom, featsT=featsT), dirs,
                                    settings)
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    launch.check("tile_composite", tensors, dict(
        dirs=(t_total, p, 3), geom=(t_total, GEOM_ROWS, k),
        featsT=(t_total, FEATURE_DIM, k), count=(t_total,)))
    dev = dirs.device
    out = torch.empty((t_total, p, FEATURE_DIM), dtype=torch.float32,
                      device=dev)
    alpha_acc = torch.empty((t_total, p), dtype=torch.float32, device=dev)
    depth = torch.empty((t_total, p), dtype=torch.float32, device=dev)
    if t_total == 0:
        return out, alpha_acc, depth
    path, plan = _plan_args("tile_composite", "fwd", p, k, dev)
    launch.launch("tile_composite", "ptgs_tile_composite_fwd",
                  count.data_ptr(), dirs.data_ptr(), geom.data_ptr(),
                  featsT.data_ptr(), out.data_ptr(), alpha_acc.data_ptr(),
                  depth.data_ptr(), t_total, p, k, FEATURE_DIM,
                  chunk_size(k), *plan, *kernel_settings(settings),
                  device=dev, count="tile_fwd" if path == "one_block"
                  else f"tile_fwd_{path}")
    return out, alpha_acc, depth


def tile_composite_bwd(packets, dirs: torch.Tensor, cot,
                       settings: RenderSettings, want_dirs: bool = True):
    """Analytic VJP of :func:`tile_composite`.

    Args:
      packets: geom (T, 16, K), featsT (T, F, K), count (T,);
      dirs: (T, P, 3); cot: (g_out (T, P, F), g_alpha (T, P),
        g_depth (T, P)); want_dirs: False skips d_dirs (None in its place;
        the kernel then leaves out its double-precision sums, and d_geom
        and d_featsT come out the same).

    Returns (d_geom, d_featsT, d_dirs). CPU tensors go through
    :func:`tile_composite_bwd_plain` (full K); CUDA tensors launch the
    kernel, which follows the forward kernel's chunk schedule: slots of the
    chunks it skipped get exactly zero.
    """
    geom, featsT, count = packets["geom"], packets["featsT"], packets["count"]
    g_out, g_alpha, g_depth = cot
    tensors = dict(dirs=dirs, geom=geom, featsT=featsT, count=count,
                   g_out=g_out, g_alpha=g_alpha, g_depth=g_depth)
    if launch.on_cpu("tile_composite_bwd", tensors):
        return tile_composite_bwd_plain(packets, dirs, cot, settings,
                                        want_dirs)
    t_total, p, _ = dirs.shape
    k = geom.shape[-1]
    launch.check("tile_composite_bwd", tensors, dict(
        dirs=(t_total, p, 3), geom=(t_total, GEOM_ROWS, k),
        featsT=(t_total, FEATURE_DIM, k), count=(t_total,),
        g_out=(t_total, p, FEATURE_DIM), g_alpha=(t_total, p),
        g_depth=(t_total, p)))
    dev = dirs.device
    d_geom = torch.zeros_like(geom)
    d_featsT = torch.zeros_like(featsT)
    d_dirs = torch.empty_like(dirs) if want_dirs else None
    if t_total == 0:
        return d_geom, d_featsT, d_dirs
    path, plan = _plan_args("tile_composite_bwd",
                            "bwd_dirs" if want_dirs else "bwd", p, k, dev)
    # The group-loop kernel keeps each pixel's forward state between chunks
    # and phases: T, depth sum and the two cotangent sums, in double.
    scratch = None if path != "group_loop" else torch.empty(
        (t_total, p, 4), dtype=torch.float64, device=dev)
    launch.launch("tile_composite_bwd", "ptgs_tile_composite_bwd",
                  count.data_ptr(), dirs.data_ptr(), geom.data_ptr(),
                  featsT.data_ptr(), g_out.data_ptr(), g_alpha.data_ptr(),
                  g_depth.data_ptr(), launch.ptr(d_dirs), d_geom.data_ptr(),
                  d_featsT.data_ptr(), launch.ptr(scratch), t_total, p, k,
                  FEATURE_DIM, chunk_size(k), int(want_dirs), *plan,
                  *kernel_settings(settings), device=dev,
                  count="tile_bwd" if path == "one_block"
                  else f"tile_bwd_{path}")
    return d_geom, d_featsT, d_dirs


class TileComposite(torch.autograd.Function):
    """The fused composite with its analytic backward (the JAX package's
    ``_packed_composite`` custom VJP). Saves only its inputs, as the JAX
    residual does; the backward recomputes the forward chunk by chunk. It
    computes d_dirs only where dirs requires grad (training's directions,
    built from the camera, do not), and returns None for it otherwise."""

    @staticmethod
    def forward(ctx, geom, featsT, dirs, count, settings):
        ctx.settings = settings
        ctx.save_for_backward(geom, featsT, dirs, count)
        return _fwd(geom, featsT, dirs, count, settings)

    @staticmethod
    def backward(ctx, g_out, g_alpha, g_depth):
        geom, featsT, dirs, count = ctx.saved_tensors
        d_geom, d_featsT, d_dirs = tile_composite_bwd(
            dict(geom=geom, featsT=featsT, count=count), dirs,
            (g_out.contiguous(), g_alpha.contiguous(), g_depth.contiguous()),
            ctx.settings, want_dirs=ctx.needs_input_grad[2])
        return d_geom, d_featsT, d_dirs, None, None


def tile_composite(packets, dirs: torch.Tensor, settings: RenderSettings):
    """Fused tile compositing, differentiable in geom, featsT and dirs.

    Args:
      packets: dict from :func:`build_tile_packets`: geom (T, 16, K),
        featsT (T, F, K), count (T,).
      dirs: (T, P, 3) per-tile pixel ray directions.

    Returns (out (T, P, F), alpha_acc (T, P), depth (T, P)). CPU tensors go
    through the plain versions; CUDA tensors launch the kernels.
    """
    return TileComposite.apply(packets["geom"], packets["featsT"], dirs,
                               packets["count"], settings)
