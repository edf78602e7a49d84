"""The JAX package against the port on the CPU at chip_smoke.py phase 10b's
setting: the bench's depth-12 workload (pathtrace_camera, max_depth 12,
opaque_depth 4, the grid backend) on surface_scene(2000, seed 13) lit by
its panel, 96x64, one sample a key (fold_in(PRNGKey(13), key)), and the
same sample cut at depth 4.

A bounce's random draws depend on the key and the depth alone, so with one
key the depth-4 image is the depth-12 image without what bounces 5-12 add:
E = I12 - I4, which only glass-first paths carry (past opaque_depth the
others end). Per key it prints, at both depths, the share of pixels within
the kernel tolerance and the mean absolute difference against the image
mean (how far two float32 implementations of the reference's math drift
apart: the thin surfels' cutoff flips, compounded by every bounce; ROADMAP
section 3); the share of pixels that depth 12 changes over depth 4; and E's
mean in each package against the image mean. The gates below, which
tests/test_torch_grid_pathtrace.py::test_bench_depth12_matches holds the
port to and chip_smoke.py phase 10b the card, are set from these numbers.

    JAX_PLATFORMS=cpu python tests/torch_divergence.py [keys]

(about 3 minutes for keys 1-3, most of it the JAX package's compile).
"""
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pathtracer_gaussiansplatting_tpu.core.camera import (  # noqa: E402
    Camera as JCamera, look_at as j_look_at,
)
from pathtracer_gaussiansplatting_tpu.core.types import (  # noqa: E402
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (  # noqa: E402
    surface_scene as j_surface_scene,
)
from pathtracer_gaussiansplatting_tpu.render import (  # noqa: E402
    pathtrace as jpt, pipeline as jpipe,
)
from pathtracer_gaussiansplatting_tpu_torch.core import rng  # noqa: E402
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (  # noqa: E402
    Camera, look_at,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (  # noqa: E402
    RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.render import (  # noqa: E402
    pathtrace as tpt, pipeline as tpipe,
)

from torch_parity import ATOL, RTOL, share_outside, to_torch_scene  # noqa: E402,E501

EYE, TARGET = (0.0, 0.2, 1.7), (0.0, -0.4, -0.5)
DEPTHS = (4, 12)
# At both depths: the share of pixels within RTOL / ATOL, and the mean
# absolute difference over the image mean (keys 1-3: 92.19-92.77% and
# 0.36-0.43% at depth 4, 91.31-91.70% and 0.59-0.92% at depth 12).
MIN_SHARE, MAX_MEAN_FRAC = 0.88, 0.02
# Depth 12 changes 5.49-5.66% of the pixels over depth 4, so a fault past
# opaque_depth moves the share above by at most that much; E's mean is
# 4.06-5.18% of the image mean and the port's sits 0.004-6.4% off the JAX
# package's. So E's mean is held within EXTRA_REL of the reference's, and
# the share of pixels depth 12 changes within CHANGED_DIFF (0-0.016
# points measured).
EXTRA_REL, CHANGED_DIFF = 0.25, 0.01


def images(keys, depths=DEPTHS) -> dict:
    """{(depth, key): (port image, JAX image)}, (64 * 96, 3) float32 each."""
    js = j_surface_scene(2000, seed=13)
    ts = to_torch_scene(js)
    jcam = JCamera(c2w=j_look_at(EYE, TARGET), fov_y_deg=60.0, width=96,
                   height=64)
    cam = Camera(c2w=look_at(EYE, TARGET, device="cpu"), fov_y_deg=60.0,
                 width=96, height=64)
    out = {}
    for depth in depths:
        kw = dict(max_depth=depth, opaque_depth=4,
                  ambient=(0.05, 0.05, 0.06, 1.0))
        jset, tset = JRenderSettings(**kw), RenderSettings(**kw)
        trace_fn, vis_fn = jpipe.make_trace_backend(js, jset, "grid")
        backend = tpipe.make_trace_backend(ts, tset, "grid")
        for k in keys:
            want = np.asarray(jpt.pathtrace_camera(
                js, jcam, jset,
                jax.random.fold_in(jax.random.PRNGKey(13), k),
                trace_fn=trace_fn, visibility_fn=vis_fn))
            with torch.no_grad():
                got = tpt.pathtrace_camera(
                    ts, cam, tset, rng.fold_in(rng.prng_key(13), k),
                    backend=backend).numpy()
            out[depth, k] = got, want
    return out


def compare(got, want) -> dict:
    """The share of pixels within RTOL / ATOL, the mean absolute difference
    over the image mean, the largest absolute difference."""
    diff = np.abs(got.astype(np.float64) - want)
    return dict(within=1.0 - share_outside(got, want, RTOL, ATOL),
                mean_frac=float(diff.mean()) / float(want.mean()),
                max_abs=float(diff.max()))


def extra(got12, got4, want12, want4) -> dict:
    """What bounces 5-12 add, E = I12 - I4, in each package: the share of
    pixels it changes (the port's; the JAX package's), its mean over the
    depth-12 image mean (the port's; the JAX package's), and the port's
    mean against the JAX package's, |mean E_port / mean E_jax - 1|."""
    e_got = got12.astype(np.float64) - got4
    e_want = want12.astype(np.float64) - want4
    return dict(
        changed=float((got12 != got4).any(-1).mean()),
        changed_ref=float((want12 != want4).any(-1).mean()),
        frac=float(e_got.mean()) / float(want12.mean()),
        frac_ref=float(e_want.mean()) / float(want12.mean()),
        rel=abs(float(e_got.mean()) / float(e_want.mean()) - 1.0))


def main(keys=(1, 2, 3)) -> None:
    imgs = images(keys)
    for k in keys:
        for depth in DEPTHS:
            c = compare(*imgs[depth, k])
            print(f"depth {depth}, key {k}: {c['within']:.4%} of pixels "
                  f"within rtol {RTOL} / atol {ATOL}; mean abs diff "
                  f"{c['mean_frac']:.3%} of the image mean "
                  f"{float(imgs[depth, k][1].mean()):.5f}; max abs diff "
                  f"{c['max_abs']:.3e}", flush=True)
        e = extra(imgs[12, k][0], imgs[4, k][0], imgs[12, k][1],
                  imgs[4, k][1])
        print(f"key {k}: depth 12 changes {e['changed']:.4%} of pixels over "
              f"depth 4 ({e['changed_ref']:.4%} in the JAX package); what "
              f"bounces 5-12 add, E = I12 - I4, is {e['frac']:.4%} of the "
              f"depth-12 image mean ({e['frac_ref']:.4%}); mean E, port "
              f"over JAX, off by {e['rel']:.3%}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(6)
    main(tuple(int(k) for k in sys.argv[1].split(","))
         if len(sys.argv) > 1 else (1, 2, 3))
