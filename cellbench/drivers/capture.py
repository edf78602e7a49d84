"""Capture traffic: the dataset capture's pose loop. Each call renders one
torus pose through the port's tiled pose renderer on the grid backend
(``data/capture.make_tiled_pose_renderer``) and brings the image back to
the host, as the capture does before it writes the pose's JPG.

The window renders the capture's own poses in the capture's own order
(``RandomState(13)``: alpha ~ U[0, 360), beta ~ U[min, max], the first
``poses`` of them, from the first again if a window outlasts them), as
every capture does; the seed makes the scene. So every seed renders the
same poses: a pose's work varies by some tens of percent with what it
sees, and a seed that chose the poses would choose the work.
"""
from __future__ import annotations

import numpy as np
import torch

from cellbench import scenes
from cellbench.compare import image_numbers
from cellbench.reference import capture as ref_capture
from cellbench.reference import grid as ref_grid
from cellbench.reference import plain_precision
from cellbench.reference import tiles as ref_tiles
from cellbench.reference import types as ref_types

POSE_SEED = 13  # data/capture.py's CAPTURE_SEED: the capture's pose stream


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        rs = np.random.RandomState(POSE_SEED)
        lo, hi = config["beta_range"]
        self.poses = [(float(rs.uniform(0.0, 360.0)),
                       float(rs.uniform(lo, hi)))
                      for _ in range(traffic["poses"])]
        self.images = []      # (pose, host image) of every call, in order
        self.n_calls = 0

    def settings_kw(self) -> dict:
        c = self.cfg
        return dict(max_depth=c["max_depth"], ambient=tuple(c["ambient"]))

    def setup(self) -> None:
        from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
            toroidal_c2w,
        )
        from pathtracer_gaussiansplatting_tpu_torch.core.types import (
            GaussianScene, RenderSettings,
        )
        from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
            make_tiled_pose_renderer,
        )
        from pathtracer_gaussiansplatting_tpu_torch.render.grid_trace import (
            build_grid_accel,
        )
        c = self.cfg
        self.raw = scenes.make(c, self.seed, self.device)
        scene = GaussianScene(**self.raw)
        accel = build_grid_accel(scene, max_per_cell=c["grid_max_per_cell"])
        self.render = make_tiled_pose_renderer(
            scene, RenderSettings(**self.settings_kw()), None, spp=c["spp"],
            bounce_backend="grid", accel=accel)
        torus = c["torus"]
        self.c2w = [toroidal_c2w(a, b, torus["major_radius"],
                                 torus["height"], device=self.device)
                    for a, b in self.poses]
        self._render(len(self.poses) - 1)   # the warm-up: the window's shapes
        self.images.clear()
        return 0.0

    def _render(self, i: int):
        c = self.cfg
        img = self.render(self.c2w[i], c["width"], c["height"],
                          c["fov_y_deg"])
        self.images.append((i, img.cpu()))

    def call(self) -> dict:
        """One pose; returns its units of work."""
        self._render(self.n_calls % len(self.poses))
        self.n_calls += 1
        c = self.cfg
        return dict(camera_rays=c["width"] * c["height"] * c["spp"],
                    samples=c["spp"], calls=1)

    def trace_extras(self, n_calls: int) -> None:
        return None

    def release(self) -> None:
        del self.render, self.c2w
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, stand_in: str = "") -> dict:
        """The numbers of the sampled pixels of sampled poses of the
        window against the reference. ``stand_in="lowp"`` judges the
        reference in bfloat16 put in the program's place instead (the
        control)."""
        if stand_in not in ("", "lowp"):
            raise ValueError(f"no stand-in {stand_in!r}")
        c, t = self.cfg, self.traffic
        rng = np.random.default_rng([self.seed, 1])
        n = len(self.images)
        others = rng.permutation(n - 1)[:t["check_poses"] - 1].tolist()
        picks = sorted(set(others) | {n - 1})
        s = t["check_pixels"]
        cams, pixels, prog = [], [], []
        torus = c["torus"]
        for k in picks:
            pose_i, img = self.images[k]
            a, b = self.poses[pose_i]
            cams.append(ref_tiles.Camera(
                ref_tiles.toroidal_c2w(a, b, torus["major_radius"],
                                       torus["height"], self.device),
                c["fov_y_deg"], c["width"], c["height"]))
            flat = rng.choice(c["width"] * c["height"], size=s,
                              replace=False)
            py = torch.as_tensor(flat // c["width"], device=self.device)
            px = torch.as_tensor(flat % c["width"], device=self.device)
            pixels.append((py, px))
            prog.append(img.reshape(-1, 3)[torch.as_tensor(flat)])
        plain_precision()
        scene = ref_types.GaussianScene(**self.raw)
        settings = ref_types.RenderSettings(**self.settings_kw())

        def reference(lowp):
            accel = ref_grid.build_grid_accel(
                scene, max_per_cell=c["grid_max_per_cell"], lowp=lowp)
            return torch.stack(ref_capture.render_pixels(
                scene, accel, cams, pixels, settings,
                ref_tiles.BinningConfig(), [c["spp"]] * len(cams),
                ref_capture.capture_keys(c["spp"]), lowp=lowp)).cpu()

        prog = reference(True) if stand_in == "lowp" else torch.stack(prog)
        return image_numbers(prog, reference(False))


