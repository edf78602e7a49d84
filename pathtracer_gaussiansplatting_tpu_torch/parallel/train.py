"""Training: differentiable rendering and Adam on every scene leaf.

Counterpart of ``pathtracer_gaussiansplatting_tpu/parallel/train.py``
(``l1_loss``, ``l2_loss``, ``make_optimizer``, ``make_train_step``,
``make_tiled_train_step``, ``fit_scene``, ``fit_scene_tiled``). The
dense step renders rays through ``render/reference.render_radiance_dense``
(the top-K kernel gives the indices, ``selected_peaks`` recomputes t and
alpha in torch, so the gradient reaches the geometry); the tiled step
bins the scene afresh, composites every tile through the fused kernel and
back through its analytic backward (kernels/tile_composite.py). Either
takes one Adam step on every scene leaf; a leaf with no gradient is not
moved, as optax moves it by zero.

With ``mesh=`` (a ``parallel.mesh.make_mesh``), the dense step is data
parallel over the mesh's rays axis, as the reference's GSPMD step is:
every rank holds the whole scene and its block of the rays and targets,
and after the backward each gradient is all-reduced over the rays axis
and divided by its size. The reference's loss is a mean over all R rays
and the blocks are equal, so this is its gradient; the step's loss is
averaged the same way.

The JAX step is a pure function of (scene, opt_state); here the scene is a
:class:`~pathtracer_gaussiansplatting_tpu_torch.models.scene.SceneParams`
and the optimizer state a ``torch.optim.Adam`` over its parameters, both
updated in place and returned.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    GaussianScene, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import SceneParams
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu_torch.parallel.mesh import (
    RAY_AXIS, all_reduce_mean, replicate_scene, shard_rays,
)
from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
    render_radiance_dense,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
    prepare_tiles, render_prepared, render_tiled_fused,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import metrics


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def make_optimizer(lr: float = 1e-3) -> Callable:
    """Adam with ``optax.adam``'s defaults, as a factory:
    ``make_optimizer(lr)(params.parameters())`` is the optimizer state."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def make_train_step(settings: RenderSettings, optimizer: Callable,
                    render_fn: Optional[Callable] = None,
                    loss_fn: Callable = l2_loss, mesh=None):
    """Train step on a batch of rays: step(params, opt_state, rays,
    target) -> (params, opt_state, loss).

    ``render_fn(scene, rays)`` renders (R, 3) radiance (default: the dense
    renderer with ``settings``); ``optimizer`` is what
    :func:`make_optimizer` returns, ``params`` a SceneParams and
    ``opt_state`` the optimizer built over its parameters, both updated in
    place. With ``mesh``, ``params`` is the whole scene on every rank,
    ``rays`` and ``target`` the rank's block under
    ``mesh.ray_sharding`` (``mesh.shard_rays``), ``render_fn`` renders the
    block with the whole scene, and the gradients and the loss are
    averaged over the rays axis (``mesh.all_reduce_mean``), so that every
    rank takes the same step.
    """
    del optimizer  # opt_state carries it
    if render_fn is None:
        render_fn = functools.partial(render_radiance_dense,
                                      settings=settings)

    def step(params: SceneParams, opt_state, rays: Rays, target):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(render_fn(params.scene(), rays), target)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            for p in params.parameters():
                if p.grad is not None:
                    all_reduce_mean(p.grad, mesh, RAY_AXIS)
            all_reduce_mean(loss, mesh, RAY_AXIS)
        opt_state.step()
        return params, opt_state, loss

    return step


def make_tiled_train_step(settings: RenderSettings, optimizer: Callable,
                          config: Optional[BinningConfig] = None,
                          loss_fn: Callable = l2_loss):
    """Train step rendering full camera frames through the fused tile
    pipeline (fresh binning every step, forward + analytic backward).

    ``optimizer`` is what :func:`make_optimizer` returns. Returns
    step(params, opt_state, camera, target_hw3) -> (params, opt_state,
    loss): ``params`` a SceneParams, ``opt_state`` the optimizer built over
    its parameters. The step's gradients stay in ``params`` until the next
    step.
    """
    del optimizer  # opt_state carries it
    config = config or BinningConfig()

    def step(params: SceneParams, opt_state, camera, target):
        opt_state.zero_grad(set_to_none=True)
        scene = params.scene()
        packets = prepare_tiles(scene, camera, settings, config)
        out = render_prepared(packets, camera, settings, config,
                              outputs=("color",))
        loss = loss_fn(out["color"], target)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


def fit_scene_tiled(scene: GaussianScene, cameras, targets,
                    settings: RenderSettings, steps: int = 200,
                    lr: float = 5e-3, config: Optional[BinningConfig] = None,
                    progress: Optional[Callable] = None):
    """Fit a scene to (camera, image) pairs with the tiled pipeline.

    ``cameras``: list of Camera (same intrinsics); ``targets``: matching
    list of (H, W, 3) images. Cycles through poses per step. Returns
    (scene, losses, final metrics dict with psnr/ssim on pose 0).
    """
    config = config or BinningConfig()
    params = SceneParams.from_scene(scene)
    opt = make_optimizer(lr)
    opt_state = opt(params.parameters())
    step = make_tiled_train_step(settings, opt, config=config)
    dev = params.means.device
    targets = [torch.as_tensor(t, dtype=torch.float32, device=dev).detach()
               for t in targets]
    losses = []
    for i in range(steps):
        p = i % len(cameras)
        params, opt_state, loss = step(params, opt_state, cameras[p],
                                       targets[p])
        losses.append(float(loss))
        if progress:
            progress(i, losses[-1])
    fitted = GaussianScene(**{f: x.detach()
                              for f, x in params.named_parameters()})
    with torch.no_grad():
        out = render_tiled_fused(fitted, cameras[0], settings, config)
    final = dict(psnr=float(metrics.psnr(out["color"], targets[0])),
                 ssim=float(metrics.ssim(out["color"], targets[0])))
    return fitted, losses, final


def fit_scene(scene: GaussianScene, rays: Rays, target,
              settings: RenderSettings, steps: int = 100, lr: float = 5e-3,
              mesh=None, render_fn: Optional[Callable] = None,
              progress: Optional[Callable] = None):
    """Optimize a scene against target pixels (R, 3) along ``rays``.
    Returns (scene, losses). With ``mesh``, ``scene``, ``rays`` and
    ``target`` are the whole arrays on every rank: the scene is replicated,
    the rays and target split over the rays axis (see
    :func:`make_train_step`), and every rank returns the same scene."""
    if mesh is not None:
        scene = replicate_scene(scene, mesh)
        rays = shard_rays(rays, mesh)
        target = shard_rays(torch.as_tensor(target, dtype=torch.float32),
                            mesh)
    params = SceneParams.from_scene(scene)
    opt = make_optimizer(lr)
    opt_state = opt(params.parameters())
    step = make_train_step(settings, opt, render_fn=render_fn, mesh=mesh)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=params.means.device).detach()
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, rays, target)
        losses.append(float(loss))
        if progress:
            progress(i, losses[-1])
    return GaussianScene(**{f: x.detach()
                            for f, x in params.named_parameters()}), losses
