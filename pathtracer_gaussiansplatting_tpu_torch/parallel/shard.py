"""Sharded renderers: ray-parallel, and the Gaussian-sharded ring top-K.

Counterpart of ``pathtracer_gaussiansplatting_tpu/parallel/shard.py``
(``render_dense_ray_sharded``, ``_block_candidates``, ``_merge_topk``,
``ring_topk_radiance``), on the mesh of :mod:`.mesh` (its docstring states
the block convention and the gradient rules).

  * **Ray sharding**: each rank renders its block of rays through
    ``render_radiance_dense`` with the whole scene.
  * **Gaussian-sharded ring**: each rank holds one block of the scene;
    the blocks travel around the gauss axis (:func:`ring_shift`), and
    every ray keeps its K nearest contributions by depth, merged block by
    block: a streaming top-K, associative and order-free, so the
    composite equals the replicated renderer's.

A block's candidates: on CPU tensors every (ray, Gaussian) pair, as the
JAX package evaluates them; on CUDA tensors the block's own K nearest
from the top-K kernel (``render.reference.dense_topk``, k = K), so the
merge is the top-K of 2K entries, the running state and the block's. Both
keep the same K where no two depths are equal (a test holds them equal).
The ring's gradient returns by the reverse shift.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pathtracer_gaussiansplatting_tpu_torch.core import sh as sh_mod
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as gops
from pathtracer_gaussiansplatting_tpu_torch.ops.composite import (
    composite_weights,
)
from pathtracer_gaussiansplatting_tpu_torch.parallel.mesh import (
    GAUSS_AXIS, RAY_AXIS, axis_size, replicate_scene,
    replicated_input, replicated_output, shard_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.render import reference as ref


class _RingShift(torch.autograd.Function):
    """Send to the next rank of the ring, receive from the previous one;
    the backward shifts the other way."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return None, _shift(g, ctx.group, -1)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + step) % size), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % size), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_shift(x: torch.Tensor, mesh: DeviceMesh,
               axis: str = GAUSS_AXIS) -> torch.Tensor:
    """``x`` moved one rank along ``axis``: rank g sends to (g + 1) % G and
    receives from (g - 1) % G in one ``batch_isend_irecv`` (JAX's
    ``ppermute`` with perm [(j, j + 1)]). Differentiable: the gradient
    comes back by the reverse shift. With one rank on the axis it returns
    ``x`` and makes no call."""
    if axis_size(mesh, axis) == 1:
        return x
    return _RingShift.apply(mesh.get_group(axis), x)


def pack_scene(scene: GaussianScene) -> torch.Tensor:
    """(N, C) float32: every field of the scene side by side, so that a
    block travels the ring in one message."""
    n = scene.num_gaussians
    return torch.cat([getattr(scene, f).reshape(n, -1) for f in SCENE_FIELDS],
                     dim=1)


def unpack_scene(packed: torch.Tensor, like: GaussianScene) -> GaussianScene:
    """The GaussianScene of :func:`pack_scene`'s rows, with ``like``'s
    field shapes."""
    out, col = {}, 0
    for f in SCENE_FIELDS:
        shape = tuple(getattr(like, f).shape[1:])
        width = math.prod(shape)
        out[f] = packed[:, col:col + width].reshape((-1,) + shape)
        col += width
    return GaussianScene(**out)


def render_dense_ray_sharded(scene: GaussianScene, rays: Rays,
                             settings: RenderSettings, mesh: DeviceMesh):
    """Ray-parallel rendering: the whole ``scene`` and ``rays`` on every
    rank; each rank renders its block of rays (:func:`.mesh.shard_rays`)
    with the whole scene and returns its (R / rays-size, 3) block. The
    scene's gradients are summed over every rank."""
    scene = replicated_input(replicate_scene(scene, mesh), mesh,
                             (RAY_AXIS, GAUSS_AXIS))
    out = ref.render_radiance_dense(scene, shard_rays(rays, mesh), settings)
    return replicated_output(out, mesh, (GAUSS_AXIS,))


def _block_candidates(block: GaussianScene, origins, dirs,
                      settings: RenderSettings, every_pair: bool = True):
    """Per-ray contributions of one scene block: (t, alpha, rgb), (R, M)
    each and (R, M, 3). ``every_pair``: every Gaussian of the block (M =
    Nb), the JAX package's candidates; else the block's K nearest by t
    from ``reference.dense_topk`` (the top-K kernel on the card; M =
    min(max_contribs, Nb)), invalid slots t_max and alpha 0."""
    if every_pair:
        m = gops.canonical_transforms(block.log_scales, block.quats)
        o, d = origins[:, None, :], dirs[:, None, :]
        t_peak, gval = gops.peak_response(o, d, block.means[None], m[None],
                                          settings.t_min, settings.t_max)
        alpha = gops.alpha_from_response(
            block.opacities[None], gval, settings.alpha_min,
            settings.alpha_max, settings.sigma_cut)
        color = sh_mod.eval_sh(block.sh_coeffs[None],
                               d.expand(-1, block.num_gaussians, 3),
                               settings.sh_degree) + block.emission[None]
        return t_peak, alpha, color
    idx, t, alpha = ref.dense_topk(block, Rays(origins, dirs), settings)
    idx = idx.long()
    color = sh_mod.eval_sh(block.sh_coeffs[idx],
                           dirs[:, None, :].expand(-1, idx.shape[1], 3),
                           settings.sh_degree) + block.emission[idx]
    return t, alpha, color


def _merge_topk(state, cand, k: int):
    """Merge candidate contributions into the running per-ray top-K by
    depth: state and cand are (t, alpha, rgb) with K resp. M entries per
    ray; invalid entries carry alpha 0. Entries with alpha 0 sort last;
    equal depths keep the state's first, then index order, as
    ``lax.top_k`` does."""
    t = torch.cat([state[0], cand[0]], dim=1)
    alpha = torch.cat([state[1], cand[1]], dim=1)
    rgb = torch.cat([state[2], cand[2]], dim=1)
    key = torch.where(alpha > 0.0, t, math.inf)
    skey, idx = torch.sort(key, dim=1, stable=True)
    skey, idx = skey[:, :k], idx[:, :k]
    t_m = torch.gather(t, 1, idx)
    a_m = torch.where(torch.isfinite(skey), torch.gather(alpha, 1, idx), 0.0)
    c_m = torch.gather(rgb, 1, idx[..., None].expand(-1, -1, 3))
    return t_m, a_m, c_m


def ring_topk_radiance(scene_sharded: GaussianScene, rays: Rays,
                       settings: RenderSettings, mesh: DeviceMesh):
    """Radiance with the scene split over the gauss axis.

    ``scene_sharded``: this rank's block, :func:`.mesh.shard_scene` of the
    scene padded to a multiple of the gauss size
    (:func:`.mesh.pad_to_multiple`); ``rays``: this rank's block under
    :func:`.mesh.ray_sharding` (:func:`.mesh.shard_rays`). Returns the
    rank's (R / rays-size, 3) block of radiance, which every rank of a ray
    row holds alike. The block's gradients are the global gradient's
    block: the ring brings them home and the rays axis sums them.
    """
    g_size = axis_size(mesh, GAUSS_AXIS)
    k = settings.max_contribs
    origins, dirs = rays.origins, rays.directions
    r, dev = origins.shape[0], origins.device
    block = replicated_input(scene_sharded, mesh, (RAY_AXIS,))
    state = (torch.full((r, k), settings.t_max, device=dev),
             torch.zeros((r, k), device=dev),
             torch.zeros((r, k, 3), device=dev))
    packed = None
    for i in range(g_size):
        cand = _block_candidates(block, origins, dirs, settings,
                                 every_pair=dev.type == "cpu")
        state = _merge_topk(state, cand, k)
        if i + 1 < g_size:  # the last rotation would only bring it home
            packed = ring_shift(pack_scene(block) if packed is None
                                else packed, mesh)
            block = unpack_scene(packed, block)
    _, a_m, c_m = state
    weights, trans = composite_weights(a_m)
    bg = torch.tensor(settings.background, dtype=torch.float32, device=dev)
    out = torch.einsum("rk,rkc->rc", weights, c_m) + trans[:, None] * bg
    return replicated_output(out, mesh, (GAUSS_AXIS,))

