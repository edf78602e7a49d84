"""The (rays, gauss) process mesh on ``torch.distributed``.

Counterpart of ``pathtracer_gaussiansplatting_tpu/parallel/mesh.py``
(``RAY_AXIS``, ``GAUSS_AXIS``, ``initialize_multihost``, ``make_mesh``,
``ray_sharding``, ``gauss_sharding``, ``shard_rays``,
``replicate_scene``, ``shard_scene``, ``pad_to_multiple``). Parallelism
is two-axis, as there:

  * ``rays`` (data parallel): ray batches split across ranks;
  * ``gauss``: the Gaussians split across ranks, streamed around a ring
    (parallel/shard.py) or kept as resident depth slabs while the rays
    travel (parallel/spatial.py).

A mesh is a ``torch.distributed`` ``DeviceMesh`` of shape (rays, gauss)
with one process group per axis. The rank at mesh position (r, g) is
``r * G + g``, as the JAX mesh reshapes its device list. Collectives run
on NCCL for CUDA tensors and on gloo for CPU tensors.

**One convention for the whole package.** In JAX a sharded array is
global. Here each rank holds its own block:

  * a *layout* names the mesh axes that split an array's leading axis,
    major first, as the first entry of a JAX ``PartitionSpec`` does:
    ``ray_sharding(mesh)`` is ``(RAY_AXIS,)``, ``gauss_sharding(mesh)``
    ``(GAUSS_AXIS,)`` and ``spatial.spatial_sharding(mesh)`` ``(RAY_AXIS,
    GAUSS_AXIS)``. Under ``(RAY_AXIS,
    GAUSS_AXIS)`` block ``r * G + g`` lies at mesh position (r, g), so
    chunk c of a ray row starts on gauss rank c; under ``(RAY_AXIS,)``
    block r lies on every rank of ray row r;
  * ``shard_rays``, ``shard_scene`` and ``replicate_scene`` take the whole
    array (the same on every rank) and return the rank's block on the
    mesh's device; every renderer takes blocks where its JAX caller would
    have placed the array, and returns the rank's block of its output;
  * :func:`gather_rays` assembles the whole array from the blocks, so a
    gathered output compares element by element with the JAX package's.

Gradients follow JAX's rules for shard_map's transpose. The gradient a
rank holds for its block of an input that several ranks hold (the scene
replicated over the rays axis) is summed over those ranks in the backward
(:func:`replicated_input`), and the cotangent of an output that several
ranks hold is split among them (:func:`replicated_output`). So when every
rank backpropagates its block's share of the global loss, each rank's
gradient is the global gradient's block.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, GaussianScene, Rays,
)

RAY_AXIS = "rays"
GAUSS_AXIS = "gauss"

Layout = Tuple[str, ...]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         init_method: Optional[str] = None,
                         device=None) -> int:
    """Start this process's ``torch.distributed`` group; returns its rank.

    Call once on every process before :func:`make_mesh`. The rendezvous is
    ``init_method`` when given, else ``tcp://<coordinator_address>``
    ("host:port"), else a launcher's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` with ``WORLD_SIZE`` and ``RANK``, as torchrun sets
    them). ``num_processes`` and ``process_id`` override ``WORLD_SIZE``
    and ``RANK``. A single process with none of these gets a world-size-1
    group on a file store in a fresh temporary directory, so the same
    entry point runs everywhere. On the CUDA card (``device=None``; each
    process takes the card ``LOCAL_RANK`` names, else its rank modulo the
    cards) the group runs NCCL for CUDA tensors and gloo for CPU tensors;
    with ``device="cpu"``, gloo alone. Where a group exists already,
    returns its rank and changes nothing.
    """
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    env = os.environ
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None:
        if world != 1:
            raise ValueError(
                f"initialize_multihost: {world} processes need a rendezvous: "
                "pass init_method or coordinator_address, or set MASTER_ADDR "
                "and MASTER_PORT")
        store_dir = tempfile.mkdtemp(prefix="gspt_store_")
        atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
        init_method = "file://" + os.path.join(store_dir, "store")
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("cpu:gloo,cuda:nccl" if dev.type == "cuda"
                            else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank)
    return rank


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> DeviceMesh:
    """A (rays, gauss) DeviceMesh over every rank of the group.

    Default: all ranks on the ray axis (gauss axis 1, the Gaussians
    replicated). ``device`` None means the CUDA card; pass "cpu" for a
    gloo group.
    """
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} != {world} ranks")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=(RAY_AXIS, GAUSS_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def ray_sharding(mesh: DeviceMesh) -> Layout:
    """The leading (ray) axis split over the mesh's ray axis."""
    return (RAY_AXIS,)


def gauss_sharding(mesh: DeviceMesh) -> Layout:
    """The leading (Gaussian) axis split over the gauss axis."""
    return (GAUSS_AXIS,)


def _block_of(mesh: DeviceMesh, layout: Layout, coord: Sequence[int]):
    """(block index, block count) at mesh position ``coord``."""
    idx, count = 0, 1
    for ax in layout:
        size = axis_size(mesh, ax)
        idx = idx * size + coord[mesh.mesh_dim_names.index(ax)]
        count *= size
    return idx, count


def _take_block(x: torch.Tensor, mesh: DeviceMesh, layout: Layout):
    coord = [mesh.get_local_rank(ax) for ax in mesh.mesh_dim_names]
    idx, count = _block_of(mesh, layout, coord)
    n = x.shape[0]
    if n % count:
        raise ValueError(f"leading axis {n} does not split into {count} "
                         f"equal blocks over {layout}")
    per = n // count
    return x[idx * per:(idx + 1) * per].to(mesh_device(mesh))


def _map(fn, x):
    """``fn`` over the tensors of a Rays, a GaussianScene, a dict of
    tensors or a tensor."""
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    if isinstance(x, Rays):
        return Rays(fn(x.origins), fn(x.directions))
    if isinstance(x, GaussianScene):
        return GaussianScene(**{f: fn(getattr(x, f)) for f in SCENE_FIELDS})
    return fn(x)


def shard_rays(rays, mesh: DeviceMesh, layout: Optional[Layout] = None):
    """This rank's block of a Rays batch (or a per-ray tensor), split by
    ``layout`` (default :func:`ray_sharding`)."""
    layout = ray_sharding(mesh) if layout is None else layout
    return _map(lambda x: _take_block(x, mesh, layout), rays)


def replicate_scene(scene: GaussianScene, mesh: DeviceMesh) -> GaussianScene:
    """The whole scene on this rank's device."""
    return _map(lambda x: x.to(mesh_device(mesh)), scene)


def shard_scene(scene, mesh: DeviceMesh):
    """This rank's block of every Gaussian-axis array over the gauss axis
    (pad first so N divides the axis size: :func:`pad_to_multiple`): of a
    GaussianScene, or of a dict of arrays with a leading slab axis
    (``spatial.build_slab_accels``' tables)."""
    return _map(lambda x: _take_block(x, mesh, gauss_sharding(mesh)), scene)


def gather_rays(x, mesh: DeviceMesh, layout: Optional[Layout] = None):
    """The whole array of the blocks that ranks hold under ``layout``
    (default :func:`ray_sharding`): an all-gather over every rank, the
    blocks in order. ``x`` is a tensor or a dict of per-ray tensors (bool
    ones included); every rank must call it."""
    layout = ray_sharding(mesh) if layout is None else layout
    if isinstance(x, dict):
        return {k: gather_rays(v, mesh, layout) for k, v in x.items()}
    world = dist.get_world_size()
    g_size = axis_size(mesh, GAUSS_AXIS)
    first = {}
    for rank in range(world):
        idx, _ = _block_of(mesh, layout, (rank // g_size, rank % g_size))
        first.setdefault(idx, rank)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src.contiguous())
    out = torch.cat([parts[first[i]] for i in range(len(first))])
    return out.to(torch.bool) if x.dtype == torch.bool else out


class _SumOverGroup(torch.autograd.Function):
    """Identity whose backward sums each gradient over ``group``."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for need, g in zip(ctx.needs_input_grad[1:], grads):
            if need:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g if need else None)
        return (None, *out)


class _SplitCotangent(torch.autograd.Function):
    """Identity whose backward divides the cotangent by ``count``."""

    @staticmethod
    def forward(ctx, count, x):
        ctx.count = count
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.count


def replicated_input(scene: GaussianScene, mesh: DeviceMesh,
                     axes: Layout) -> GaussianScene:
    """``scene`` as an input that every rank along ``axes`` holds alike:
    the same values, and in the backward each leaf's gradient is summed
    over those ranks (JAX's psum for a shard_map input not split over
    them). The all-reduce runs wherever a leaf requires grad, also on one
    rank; under no_grad nothing changes."""
    if not torch.is_grad_enabled() or not axes:
        return scene
    fields = [f for f in SCENE_FIELDS if getattr(scene, f).requires_grad]
    if not fields:
        return scene
    group = mesh.get_group(axes[0]) if len(axes) == 1 else dist.group.WORLD
    outs = _SumOverGroup.apply(group, *(getattr(scene, f) for f in fields))
    return scene.replace(**dict(zip(fields, outs)))


def replicated_output(x: torch.Tensor, mesh: DeviceMesh,
                      axes: Layout) -> torch.Tensor:
    """``x`` as an output that every rank along ``axes`` holds alike: its
    cotangent is divided by their number (JAX's rule for a shard_map
    output not split over them), so that backpropagating each rank's copy
    counts it once."""
    count = 1
    for ax in axes:
        count *= axis_size(mesh, ax)
    if count == 1 or not x.requires_grad:
        return x
    return _SplitCotangent.apply(count, x)


def all_reduce_mean(x: torch.Tensor, mesh: DeviceMesh, axis: str):
    """``x`` averaged over the ranks along ``axis``, in place."""
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x.div_(axis_size(mesh, axis))


def pad_to_multiple(scene: GaussianScene, multiple: int) -> GaussianScene:
    """Pad a GaussianScene with fully transparent Gaussians so that its
    count divides by ``multiple`` (sharding needs equal blocks): means
    1e6 (far from everything), log_scales -10, quats (1, 0, 0, 0),
    opacity_logits -30 (opacity sigmoid(-30) ~ 0, never contributing),
    roughness 1, the rest 0: the JAX package's fill values. It pads
    clearcoat, clearcoat_roughness and transmission as well (with 0), which
    the JAX package leaves at N rows."""
    n = scene.num_gaussians
    pad = (-n) % multiple
    if pad == 0:
        return scene
    fill = dict(means=1e6, log_scales=-10.0, opacity_logits=-30.0,
                roughness=1.0)

    def pad_arr(f):
        x = getattr(scene, f)
        block = torch.full((pad,) + tuple(x.shape[1:]), fill.get(f, 0.0),
                           dtype=x.dtype, device=x.device)
        if f == "quats":
            block[:, 0] = 1.0
        return torch.cat([x, block])

    return GaussianScene(**{f: pad_arr(f) for f in SCENE_FIELDS})
