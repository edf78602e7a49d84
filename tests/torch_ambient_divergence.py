"""The JAX package against the port on the CPU at chip_smoke.py phase 14f's
setting under a bright ambient: ``cli render --backend dense
--max-contribs 256`` through both command lines on surface_scene(2000,
seed 13) saved as a 3DGS checkpoint (the format drops the panel's
emission and the point light) with a sun, 96x64, 2 spp, depth 1, at each
ambient level and pose (the torus angle alpha, in degrees) asked for.

Per run it prints the share of pixels within the kernel tolerance (rtol
1e-3 / atol 3e-4) and the mean absolute difference against the image
mean, for the float images the two commands hand to ``save_png``. The
closed room shades the sun, so the image is mostly the ambient term, and
every float32 difference in a thin surfel's alpha (the quadratic's
cancellation, ROADMAP section 3) reaches the pixel scaled by the ambient:
the mean difference grows with it, the share within a fixed atol falls.
The gates below, which tests/test_torch_ambient.py holds the port to and
chip_smoke.py phase 14f the card, are set from these numbers.

    JAX_PLATFORMS=cpu python tests/torch_ambient_divergence.py \
        [ambients [alphas]]

(about 15 s a run; defaults: ambient 0.05, 0.2 and 0.6 at alpha 0, then
0.6 at alphas 90, 180 and 270).
"""
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pathtracer_gaussiansplatting_tpu import cli as jcli  # noqa: E402
from pathtracer_gaussiansplatting_tpu.data import images as jimages  # noqa: E402,E501
from pathtracer_gaussiansplatting_tpu_torch import cli as tcli  # noqa: E402
from pathtracer_gaussiansplatting_tpu_torch.data.ply import (  # noqa: E402
    save_3dgs_ply,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (  # noqa: E402
    surface_scene,
)

from torch_parity import ATOL, RTOL, share_outside  # noqa: E402

# chip_smoke.py's CAPTURE_TORUS (phase 8's torus) and 14f's sun.
TORUS = dict(major_radius=1.2, minor_radius=0.4, height=0.2, num_rays=4096)
SUN = {"color": [1.0, 0.95, 0.9], "direction": [0.3, -1.0, 0.2],
       "intensity": 1.5}
BRIGHT = 0.6
# At ambient BRIGHT: the share of pixels within RTOL / ATOL and the mean
# absolute difference over the image mean (alphas 0, 90, 180, 270:
# 88.23-91.67% and 0.229-0.263%; at alpha 0, ambient 0.05 99.90% and
# 0.246%, ambient 0.2 97.40% and 0.252%). The card against the CPU held
# 95.5% at alpha 0 (ROADMAP section 3).
MIN_SHARE, MAX_MEAN_FRAC = 0.85, 0.01


def write_world(root: str, ambient: float) -> str:
    """The checkpoint and the config of 14f at this ambient level (its RGB
    all equal) under root; returns the config's path."""
    ply = os.path.join(root, "room.ply")
    if not os.path.exists(ply):
        save_3dgs_ply(ply, surface_scene(2000, seed=13, device="cpu"))
    cfg = os.path.join(root, f"scene_{ambient}.json")
    with open(cfg, "w") as fh:
        json.dump({"settings": {
            "ambient_light": [ambient, ambient, ambient, 1.0],
            "torus_settings": TORUS, "sun": SUN,
            "width": 96, "height": 64, "fov": 60, "max_depth": 1},
            "objects": [{"model": "room.ply"}]}, fh)
    return cfg


def render_both(cfg: str, root: str, alpha: float = 0.0):
    """(port image, JAX image): the float images each command line hands
    to save_png, (64, 96, 3) float64 each."""
    got = {}
    argv = ["render", "--scene", cfg, "--backend", "dense",
            "--max-contribs", "256", "--spp", "2", "--alpha", str(alpha)]
    for tag, main, mod, extra in (("j", jcli.main, jimages, []),
                                  ("t", tcli.main, tcli,
                                   ["--device", "cpu"])):
        saved = mod.save_png

        def grab(path, img, tag=tag):
            got[tag] = np.asarray(img, np.float64)

        mod.save_png = grab
        try:
            main(argv + ["--output", os.path.join(root, f"{tag}.png")]
                 + extra)
        finally:
            mod.save_png = saved
    return got["t"], got["j"]


def compare(got, want) -> dict:
    """The share of pixels within RTOL / ATOL, the mean absolute difference
    over the image mean, the largest absolute difference."""
    diff = np.abs(got - want)
    return dict(within=1.0 - share_outside(got, want, RTOL, ATOL),
                mean_frac=float(diff.mean()) / float(want.mean()),
                max_abs=float(diff.max()), mean=float(want.mean()))


def main(runs) -> None:
    with tempfile.TemporaryDirectory() as root:
        for ambient, alpha in runs:
            c = compare(*render_both(write_world(root, ambient), root,
                                     alpha))
            print(f"ambient {ambient}, alpha {alpha}: {c['within']:.4%} of "
                  f"pixels within rtol {RTOL} / atol {ATOL}; mean abs diff "
                  f"{c['mean_frac']:.3%} of the image mean {c['mean']:.5f}; "
                  f"max abs diff {c['max_abs']:.3e}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(6)
    if len(sys.argv) > 1:
        ambients = [float(a) for a in sys.argv[1].split(",")]
        alphas = [float(a) for a in sys.argv[2].split(",")] \
            if len(sys.argv) > 2 else [0.0]
        main([(a, b) for a in ambients for b in alphas])
    else:
        main([(0.05, 0.0), (0.2, 0.0), (BRIGHT, 0.0), (BRIGHT, 90.0),
              (BRIGHT, 180.0), (BRIGHT, 270.0)])
