"""Flat capture traffic: the dataset capture's pose loop on a non-tiled
route, the capture's branch for every scene the route "auto" leaves off
the tile pass. Each call renders one torus pose through the port's flat
renderer (``data/capture.make_accumulating_renderer`` on the trace
backend the configuration's ``route`` names, driven by ``render_pose`` in
row-major chunks of the traffic's ``chunk`` rays) and brings the image
back to the host, as the capture does before it writes the pose's JPG.

The poses are the capture's own, in its order, as in the tiled capture
traffic (``drivers/capture.py``); the seed makes the scene. The traced
poses take the traffic's ``trace_spp`` samples each, not the window's: a
sample does the same work either way, and a whole pose (some 30,000
launches a sample) is more than the profiler records without dropping
records, which the span readers' stream-order join cannot survive.

The check traces the sampled pixels' rays of the window's poses again
through the plain dense reference (``reference/dense.py``): a ray's
random numbers follow its frame and its index within its chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from cellbench import scenes
from cellbench.compare import image_numbers
from cellbench.reference import capture as ref_capture
from cellbench.reference import dense as ref_dense
from cellbench.reference import plain_precision
from cellbench.reference import tiles as ref_tiles
from cellbench.reference import types as ref_types

POSE_SEED = 13  # data/capture.py's CAPTURE_SEED: the capture's pose stream


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        if config["route"] != "dense":
            raise ValueError(f"the flat capture's reference traces the "
                             f"dense route, not {config['route']!r}")
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        rs = np.random.RandomState(POSE_SEED)
        lo, hi = config["beta_range"]
        self.poses = [(float(rs.uniform(0.0, 360.0)),
                       float(rs.uniform(lo, hi)))
                      for _ in range(traffic["poses"])]
        self.images = []      # (pose, host image) of every window call
        self.n_calls = 0
        self.tracing = False

    def settings_kw(self) -> dict:
        c = self.cfg
        return dict(max_depth=c["max_depth"], ambient=tuple(c["ambient"]),
                    max_contribs=c["max_contribs"])

    def setup(self) -> float:
        from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
            toroidal_c2w,
        )
        from pathtracer_gaussiansplatting_tpu_torch.core.types import (
            GaussianScene, RenderSettings,
        )
        from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
            make_accumulating_renderer, render_pose,
        )
        c = self.cfg
        self.raw = scenes.make(c, self.seed, self.device)
        scene = GaussianScene(**self.raw)
        self.render_fns = {spp: make_accumulating_renderer(
            scene, RenderSettings(**self.settings_kw()), None, spp=spp,
            backend=c["route"])
            for spp in (c["spp"], self.traffic["trace_spp"])}
        self.render_pose = render_pose
        torus = c["torus"]
        self.c2w = [toroidal_c2w(a, b, torus["major_radius"],
                                 torus["height"], device=self.device)
                    for a, b in self.poses]
        # The warm-up: the window's shapes (a traced pose's are the same).
        self._render(len(self.poses) - 1, c["spp"])
        self.images.clear()
        return 0.0

    def _render(self, i: int, spp: int):
        c = self.cfg
        img = self.render_pose(self.render_fns[spp], self.c2w[i],
                               c["width"], c["height"], c["fov_y_deg"],
                               chunk=self.traffic["chunk"]).cpu()
        if not self.tracing:
            self.images.append((i, img))

    def call(self) -> dict:
        """One pose; returns its units of work."""
        c = self.cfg
        spp = self.traffic["trace_spp"] if self.tracing else c["spp"]
        self._render(self.n_calls % len(self.poses), spp)
        self.n_calls += 1
        return dict(camera_rays=c["width"] * c["height"] * spp,
                    samples=spp, calls=1)

    def trace_extras(self, n_calls: int) -> None:
        """From here on the calls are the traced poses."""
        self.tracing = True
        return None

    def release(self) -> None:
        del self.render_fns, self.c2w
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
            return torch.stack(ref_dense.render_pixels(
                scene, cams, pixels, settings, c["spp"],
                ref_capture.capture_keys(c["spp"]), t["chunk"],
                lowp=lowp)).cpu()

        prog = reference(True) if stand_in == "lowp" else torch.stack(prog)
        return image_numbers(prog, reference(False))
