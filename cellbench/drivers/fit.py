"""Fit traffic: fitting Gaussians to images. Each call is one step of the
port's tiled train step (``parallel/train.make_tiled_train_step`` with
``make_optimizer``): a fresh binning, the tile forward, the analytic
backward and Adam on every leaf, the loss read back as
``fit_scene_tiled`` reads it. The step cycles over ``views`` cameras on a
ring around the scene; the seed makes the scene, the targets and the order
of the views, so every seed trains on the same set of poses. The window
runs fits of ``fit_steps`` steps one after another, each from the scene
with a fresh optimizer: over a long window Adam grows and moves the
Gaussians, and the work a step does would drift with the number of steps
a run reached.

The targets are the reference's renders of the same scene with its colours
perturbed from the seed: the gradients are real, and the geometry stays
near its start, so the work a step does stays steady over the window.

Set-up runs the first ``check_steps`` steps through the window's own call
on distinct views and keeps what the comparison needs: each step's loss,
the first gradient as Adam holds it after one step, and each leaf's change
after the last of them.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from cellbench import scenes
from cellbench.metrics import _tilecount
from cellbench.reference import plain_precision
from cellbench.reference import tiles as ref_tiles
from cellbench.reference import train as ref_train
from cellbench.reference import types as ref_types

BETA1 = 0.9   # make_optimizer's first moment: exp_avg = (1 - BETA1) g


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        views = traffic["views"]
        elev = traffic["elevations_deg"]
        ring = [(360.0 * k / views, elev[k % len(elev)])
                for k in range(views)]
        order = np.random.default_rng(seed).permutation(views)
        self.views = [ring[i] for i in order]
        self.n_calls = 0
        self.losses = []
        self._bounds = None

    def eye(self, i: int) -> tuple:
        a, e = (math.radians(x) for x in self.views[i % len(self.views)])
        d = self.traffic["distance"]
        return (d * math.cos(a) * math.cos(e), d * math.sin(e),
                d * math.sin(a) * math.cos(e))

    def ref_camera(self, i: int):
        c = self.cfg
        return ref_tiles.Camera(
            ref_tiles.look_at(self.eye(i), (0.0, 0.0, 0.0), self.device),
            c["fov_y_deg"], c["width"], c["height"])

    def ref_settings(self):
        return ref_types.RenderSettings(background=tuple(
            self.traffic["background"]))

    def ref_config(self):
        return ref_tiles.BinningConfig(
            max_per_tile=self.traffic["max_per_tile"])

    def setup(self) -> float:
        """The program's set-up; returns the seconds the reference spent
        rendering the targets (the cell's inputs, no set-up of the
        program's)."""
        from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
            Camera, look_at,
        )
        from pathtracer_gaussiansplatting_tpu_torch.core.types import (
            GaussianScene, RenderSettings,
        )
        from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
            SceneParams,
        )
        from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
            BinningConfig,
        )
        from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (
            make_optimizer, make_tiled_train_step,
        )
        c, t = self.cfg, self.traffic
        self.raw = scenes.make(c, self.seed, self.device)
        gen = scenes.generator(self.seed + 1, self.device)
        noise = t["target_colour_noise"]
        shown = dict(self.raw, sh_coeffs=self.raw["sh_coeffs"] + noise * (
            2.0 * torch.rand(self.raw["sh_coeffs"].shape, generator=gen,
                             device=self.device) - 1.0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        plain_precision()
        self.targets = ref_train.render_targets(
            shown, [self.ref_camera(i) for i in range(len(self.views))],
            self.ref_settings(), self.ref_config())
        del shown
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        reference_s = time.perf_counter() - t0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        self.fresh = lambda: SceneParams.from_scene(GaussianScene(**self.raw))
        self.new_opt = make_optimizer(t["lr"])
        self.step = make_tiled_train_step(
            RenderSettings(background=tuple(t["background"])),
            make_optimizer(t["lr"]),
            BinningConfig(max_per_tile=t["max_per_tile"]))
        self.cams = [Camera(c2w=look_at(self.eye(i), (0.0, 0.0, 0.0),
                                        device=self.device),
                            fov_y_deg=c["fov_y_deg"], width=c["width"],
                            height=c["height"])
                     for i in range(len(self.views))]
        # The first steps, through the window's call, for the comparison.
        self.call()
        self.grad1 = {f: float(torch.linalg.vector_norm(
            self.opt.state[p]["exp_avg"] / (1.0 - BETA1)))
            if p in self.opt.state else 0.0
            for f, p in self.params.named_parameters()}
        for _ in range(t["check_steps"] - 1):
            self.call()
        self.change = {f: float(torch.linalg.vector_norm(
            p.detach() - self.raw[f]))
            for f, p in self.params.named_parameters()}
        self.first_losses = list(self.losses)
        return reference_s

    def call(self) -> dict:
        """One training step, the first of a new fit every ``fit_steps``;
        returns its units of work."""
        if self.n_calls % self.traffic["fit_steps"] == 0:
            self.params = self.fresh()
            self.opt = self.new_opt(self.params.parameters())
        i = self.n_calls % len(self.views)
        self.params, self.opt, loss = self.step(self.params, self.opt,
                                                self.cams[i],
                                                self.targets[i])
        self.losses.append(float(loss))
        self.n_calls += 1
        c = self.cfg
        return dict(train_rays=c["width"] * c["height"], steps=1, calls=1)

    def trace_extras(self, n_calls: int) -> list:
        """[(leaves, reference camera)] of the next ``n_calls`` steps, the
        leaves as they are now, kept on the host (the inputs of the
        kernels' operation counts, :meth:`tile_bounds`)."""
        self._bounds = None
        leaves = {f: p.detach().cpu()
                  for f, p in self.params.named_parameters()}
        return [(leaves, self.ref_camera(self.n_calls + j))
                for j in range(n_calls)]

    def tile_bounds(self, views) -> dict:
        """The tile kernels' least seconds a step, averaged over ``views``
        (``_tilecount``: counted from the step's inputs); computed once."""
        if self._bounds is None:
            self._bounds = {}
            for leaves, cam in views:
                scene = ref_types.GaussianScene(**{
                    f: v.to(self.device) for f, v in leaves.items()})
                b = _tilecount.step_bounds(scene, cam, self.ref_settings(),
                                           self.ref_config())
                for k, v in b.items():
                    self._bounds[k] = self._bounds.get(k, 0.0) \
                        + v / len(views)
        return self._bounds

    def release(self) -> None:
        del self.params, self.opt, self.step, self.cams, self.fresh
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, stand_in: str = "") -> dict:
        """The numbers of the first steps against the reference's.
        ``stand_in`` puts the reference in the program's place: "lowp" in
        bfloat16 (the control), "half" with half the image rows left out
        of the loss (a planted fault)."""
        if stand_in not in ("", "lowp", "half"):
            raise ValueError(f"no stand-in {stand_in!r}")
        t = self.traffic
        n = t["check_steps"]
        cams = [self.ref_camera(i) for i in range(n)]
        plain_precision()

        def run(**kw):
            return ref_train.fit_steps(self.raw, cams, self.targets[:n],
                                       self.ref_settings(),
                                       self.ref_config(), t["lr"],
                                       n, **kw)

        ref = run()
        ref_grad = {f: float(torch.linalg.vector_norm(g))
                    for f, g in ref["grad1"].items()}
        ref_change = {f: float(torch.linalg.vector_norm(
            p - self.raw[f])) for f, p in ref["params"].items()}
        if stand_in:
            rows = None
            if stand_in == "half":
                rows = torch.arange(self.cfg["height"],
                                    device=self.device) % 2 == 0
            alt = run(lowp=stand_in == "lowp", loss_rows=rows)
            losses = alt["losses"]
            grad = {f: float(torch.linalg.vector_norm(g))
                    for f, g in alt["grad1"].items()}
            change = {f: float(torch.linalg.vector_norm(p - self.raw[f]))
                      for f, p in alt["params"].items()}
        else:
            losses, grad, change = self.first_losses, self.grad1, self.change
        return compare_steps(losses, grad, change, ref["losses"],
                                  ref_grad, ref_change)



def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each kept leaf's gap between the program's and the reference's norm,
    over the larger of that leaf's reference norm and the median leaf's."""
    med = float(np.median([ref[f] for f in keep]))
    return [abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30) for f in keep]


def compare_steps(losses, grad, change, ref_losses, ref_grad,
                  ref_change) -> dict:
    """loss_gap: the relative gap of the first step's loss; grad_gap: the
    worst leaf's gap (:func:`leaf_gaps`) of the first gradient; change_gap:
    the median leaf's gap of the leaves' change after the last step. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they get gradient only from rounding, as a colour-only
    loss gives the material leaves).

    The later steps' losses and the worst leaf's change are not compared
    (``loss_gap_steps``, ``change_gap_worst``: the look): Adam moves every
    element whose first gradient is rounding noise (under ~1e-10 here) by
    the full learning rate, in a direction the rounding picks, and on some
    seeds one such move flips a Gaussian across a tile's K cut, moving the
    next step's loss by up to ~1%; the reference does the same when its
    inputs are nudged by one part in 1e7.
    """
    moved = [f for f, v in ref_grad.items() if v > 0.0]
    med = float(np.median([ref_grad[f] for f in moved]))
    keep = [f for f in moved if ref_grad[f] >= 1e-3 * med]
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(losses, ref_losses)]
    change = leaf_gaps(change, ref_change, keep)
    return dict(loss_gap=steps[0],
                grad_gap=max(leaf_gaps(grad, ref_grad, keep)),
                change_gap=float(np.median(change)),
                loss_gap_steps=max(steps), change_gap_worst=max(change))
