"""Interact traffic: the interactive view. Each call is one frame of the
port's ``render/session.InteractiveSession`` in toroidal camera mode: one
path-traced sample of the current pose folded into the accumulation, the
image back on the host. Before every ``look_every``-th frame a
``look(dx, dy)`` event moves the camera, which resets the accumulation and
the pose's tile packets, so the frame after a move also bins the scene.
The events are one fixed stream (``MOVE_SEED``: dx, dy ~ U[-look_px,
look_px]), the same for every seed, as a pose's work varies with what it
sees; the seed makes the scene and the pixels checked.

The driver follows the camera itself from the events, by the session's
documented cursor rule (toroidal alpha += 0.2 dx mod 360, beta += 0.2 dy
within +-89 degrees, from alpha = beta = 0) and its accumulation rule (a
move resets the sample count), and takes the fov from the configuration:
nothing of the camera is read from the program. Each frame keeps
``check_pixels`` of its pixels (drawn from the seed) with that pose and
sample count for the comparison.
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

SESSION_SEED = 13  # InteractiveSession's default key, PRNGKey(13)
MOVE_SEED = 7      # the one stream of look events, whatever the seed
DEG_PER_PX = 0.2   # the session's toroidal cursor rule
BETA_MAX = 89.0


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.rng = np.random.default_rng([seed, 2])
        self.moves = np.random.default_rng(MOVE_SEED)
        self.n_calls = 0
        self.alpha = self.beta = 0.0   # the pose, followed from the events
        self.samples = 0               # samples accumulated at the pose
        self.kept = []   # (alpha, beta, samples, flat pixels, values)

    def settings_kw(self) -> dict:
        c = self.cfg
        return dict(max_depth=c["max_depth"], ambient=tuple(c["ambient"]))

    def setup(self) -> float:
        from pathtracer_gaussiansplatting_tpu_torch.core.torus import (
            TorusConfig,
        )
        from pathtracer_gaussiansplatting_tpu_torch.core.types import (
            GaussianScene, RenderSettings,
        )
        from pathtracer_gaussiansplatting_tpu_torch.render.session import (
            InteractiveSession,
        )
        c, t = self.cfg, self.traffic
        self.raw = scenes.make(c, self.seed, self.device)
        torus = c["torus"]
        self.session = InteractiveSession(
            GaussianScene(**self.raw), RenderSettings(**self.settings_kw()),
            width=t["width"], height=t["height"],
            torus=TorusConfig(major_radius=torus["major_radius"],
                              minor_radius=torus["minor_radius"],
                              height=torus["height"]),
            seed=SESSION_SEED)
        self.session.key("c")           # toroidal camera mode
        # The warm-up: a moved frame (binning and a sample) and an
        # accumulating one, at the window's own shapes.
        self.call()
        self.call()
        self.kept.clear()
        return 0.0

    def call(self) -> dict:
        """One frame, after its event if it has one."""
        t = self.traffic
        if self.n_calls % t["look_every"] == 0:
            dx, dy = (float(v) for v in
                      self.moves.uniform(-t["look_px"], t["look_px"], 2))
            self.session.look(dx, dy)
            self.alpha = float(np.mod(self.alpha + DEG_PER_PX * dx, 360.0))
            self.beta = float(np.clip(self.beta + DEG_PER_PX * dy,
                                      -BETA_MAX, BETA_MAX))
            self.samples = 0
        img = self.session.step()
        self.samples += 1
        flat = self.rng.choice(t["width"] * t["height"],
                               size=t["check_pixels"], replace=False)
        self.kept.append((self.alpha, self.beta, self.samples, flat,
                          img.reshape(-1, 3)[flat].copy()))
        self.n_calls += 1
        return dict(frames=1, samples=1, calls=1)

    def trace_extras(self, n_calls: int) -> None:
        return None

    def release(self) -> None:
        del self.session
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, stand_in: str = "") -> dict:
        """The numbers of the kept pixels of the last frame and of
        frames drawn from the seed against the reference. ``stand_in=
        "lowp"`` judges the reference in bfloat16 instead (the control)."""
        if stand_in not in ("", "lowp"):
            raise ValueError(f"no stand-in {stand_in!r}")
        c, t = self.cfg, self.traffic
        rng = np.random.default_rng([self.seed, 3])
        n = len(self.kept)
        others = rng.permutation(n - 1)[:t["check_frames"] - 1].tolist()
        picks = sorted(set(others) | {n - 1})
        torus = c["torus"]
        cams, pixels, spps, prog = [], [], [], []
        for k in picks:
            a, b, samples, flat, values = self.kept[k]
            cams.append(ref_tiles.Camera(
                ref_tiles.toroidal_c2w(a, b, torus["major_radius"],
                                       torus["height"], self.device),
                c["fov_y_deg"], t["width"], t["height"]))
            pixels.append((torch.as_tensor(flat // t["width"],
                                           device=self.device),
                           torch.as_tensor(flat % t["width"],
                                           device=self.device)))
            spps.append(samples)
            prog.append(torch.as_tensor(values))
        plain_precision()
        scene = ref_types.GaussianScene(**self.raw)
        settings = ref_types.RenderSettings(**self.settings_kw())
        keys = ref_capture.session_keys(SESSION_SEED, max(spps))

        def reference(lowp):
            accel = ref_grid.build_grid_accel(
                scene, max_per_cell=c["grid_max_per_cell"], lowp=lowp)
            return torch.cat(ref_capture.render_pixels(
                scene, accel, cams, pixels, settings,
                ref_tiles.BinningConfig(), spps, keys, jitter=False,
                lowp=lowp)).cpu()

        prog = reference(True) if stand_in == "lowp" else torch.cat(prog)
        return image_numbers(prog, reference(False))

