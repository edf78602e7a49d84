"""The port's point-cloud rasterizer and interactive session vs the JAX
package (CPU): the packed z-test on random points in both placements, the
reference's rasterizer cases, and a scripted key sequence through both
sessions (camera and point-cloud views, accumulation resets, the torus
resize, importance feedback)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import Camera as JCamera
from pathtracer_gaussiansplatting_tpu.core.camera import look_at as j_look_at
from pathtracer_gaussiansplatting_tpu.core.torus import (
    TorusConfig as JTorusConfig,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.render import points as jpoints
from pathtracer_gaussiansplatting_tpu.render.session import (
    InteractiveSession as JSession,
)
from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera, look_at
from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.render import points as tpoints
from pathtracer_gaussiansplatting_tpu_torch.render.session import (
    InteractiveSession,
)

from torch_parity import (
    ATOL, CPU, RTOL, TORCH_THREADS, np_of, share_outside, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

# Point images: the projection's floor can land on the other side of a
# pixel edge where XLA and torch round x or y an ulp apart, and the
# quantized depth can tie the other way: at least POINTS_MIN_EQUAL of the
# pixels equal.
POINTS_MIN_EQUAL = 0.999
# Session images: the path tracer's tolerances (tests/torch_parity.py) on
# at least SESSION_MIN_SHARE of the pixels.
SESSION_MIN_SHARE = 0.99


def both_cameras(eye, target, fov, width, height):
    return (JCamera(c2w=j_look_at(eye, target), fov_y_deg=fov, width=width,
                    height=height),
            Camera(c2w=look_at(eye, target, device=CPU), fov_y_deg=fov,
                   width=width, height=height))


def equal_share(got, want) -> float:
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape
    return float((g == w).all(-1).mean())


@pytest.mark.parametrize("n,point_size", [(5000, 2), (20000, 1), (3000, 3)])
def test_rasterize_points_matches(n, point_size):
    rng = np.random.default_rng(n)
    pts = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    pts[: n // 50, 2] = 6.0                      # behind the camera
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    jcam, tcam = both_cameras((0.3, 0.5, 5.0), (0, 0, 0), 45.0, 96, 64)
    want = jpoints.rasterize_points(jnp.asarray(pts), jnp.asarray(cols),
                                    jnp.asarray(valid), jcam,
                                    background=(0.1, 0.2, 0.3),
                                    point_size=point_size)
    got = tpoints.rasterize_points(torch.from_numpy(pts),
                                   torch.from_numpy(cols),
                                   torch.from_numpy(valid), tcam,
                                   background=(0.1, 0.2, 0.3),
                                   point_size=point_size)
    share = equal_share(got, want)
    print(f"rasterize n={n}: {share:.4%} of pixels equal")
    assert share >= POINTS_MIN_EQUAL


@pytest.mark.parametrize("mode", ["world", "torus"])
def test_render_point_cloud_matches(mode):
    rng = np.random.default_rng(13)
    n = 4096
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    pos = rng.normal(0, 1, (n, 3)).astype(np.float32)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    flags = (rng.uniform(size=n) > 0.3).astype(np.float32)
    kw = dict(major_radius=4.0, minor_radius=0.5, height=0.0, num_rays=n)
    jcam, tcam = both_cameras((0.0, 12.0, 0.1), (0, 0, 0), 60.0, 64, 64)
    want = jpoints.render_point_cloud(pos, col, flags, jcam, mode=mode,
                                      uv=uv, torus=JTorusConfig(**kw))
    got = tpoints.render_point_cloud(pos, col, flags, tcam, mode=mode,
                                     uv=uv, torus=TorusConfig(**kw))
    assert float(np_of(got).sum()) > 0
    assert equal_share(got, want) >= POINTS_MIN_EQUAL


def test_rasterizer_cases():
    """tests/test_points.py's cases on the port: a point lands in the
    center as a 2x2 splat, the nearer point wins, invalid points and
    points behind the camera are dropped, a bad mode raises."""
    cam = Camera(c2w=look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), device=CPU),
                 fov_y_deg=45.0, width=64, height=64)

    def ras(pts, cols, valid):
        return np_of(tpoints.rasterize_points(
            torch.tensor(pts, dtype=torch.float32),
            torch.tensor(cols, dtype=torch.float32),
            torch.tensor(valid), cam))

    img = ras([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [True])
    assert img[32, 32, 0] == pytest.approx(1.0)
    assert img.sum() == pytest.approx(4.0)
    img = ras([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0]],
              [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], [True, True])
    assert img[32, 32, 1] == 1.0 and img[32, 32, 0] == 0.0
    assert ras([[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0]], [False]).sum() == 0.0
    assert ras([[0.0, 0.0, 10.0]], [[1.0, 1.0, 1.0]], [True]).sum() == 0.0
    for kw in (dict(mode="nope"), dict(mode="torus")):
        with pytest.raises(ValueError):
            tpoints.render_point_cloud(np.zeros((1, 3)), np.ones((1, 3)),
                                       np.ones((1,)), cam, **kw)


# A scripted session: (command, argument) pairs; "step" compares the two
# sessions' images and their frame counters.
SCRIPT = [("step", None), ("step", None), ("key", "w"), ("step", None),
          ("look", (15.0, -5.0)), ("step", None), ("key", "c"),
          ("step", None), ("look", (90.0, 10.0)), ("step", None),
          ("step", None), ("key", "z"), ("step", None), ("key", "3"),
          ("key", "p"), ("step", None), ("step", None), ("key", "7"),
          ("step", None), ("step", None), ("key", "u"), ("step", None),
          ("key", "p"), ("key", "r"), ("key", "c"), ("step", None)]


def test_session_script_matches():
    js = j_random_cloud(200, seed=5, spread=1.0, scale_range=(-1.6, -0.7),
                        emissive_frac=0.1)
    kw = dict(major_radius=1.5, minor_radius=0.3, height=0.0, num_rays=1024)
    settings = dict(max_depth=2, ambient=(0.05, 0.05, 0.05, 1.0))
    jsess = JSession(js, JRenderSettings(**settings), width=32, height=24,
                     torus=JTorusConfig(**kw), backend="dense")
    tsess = InteractiveSession(to_torch_scene(js), RenderSettings(**settings),
                               width=32, height=24, torus=TorusConfig(**kw),
                               backend="dense")
    frames = []
    for cmd, arg in SCRIPT:
        for sess in (jsess, tsess):
            if cmd == "key":
                sess.key(arg)
            elif cmd == "look":
                sess.look(*arg)
        if cmd == "step":
            want, got = jsess.step(), tsess.step()
            assert isinstance(got, np.ndarray) and got.shape == (24, 32, 3)
            share = share_outside(got, want, RTOL, ATOL)
            assert np.isfinite(got).all()
            assert 1 - share >= SESSION_MIN_SHARE, (len(frames), share)
            frames.append(tsess.frame)
        assert (tsess.frame, tsess.render_mode, tsess.camera_mode,
                tsess.sampling.value) == (jsess.frame, jsess.render_mode,
                                    jsess.camera_mode, jsess.sampling.value)
        assert tsess.torus.major_radius == jsess.torus.major_radius
        if cmd in ("key", "look") and arg not in ("3", "7"):
            assert tsess.frame == 0      # every view change resets
    # accumulation counts up between inputs and restarts after each
    assert frames == [1, 2, 1, 1, 1, 1, 2, 1, 1, 2, 3, 4, 1, 1]
    np.testing.assert_array_equal(tsess.free_cam.position,
                                  jsess.free_cam.position)
