"""The port's capture building blocks vs the JAX package (CPU): the torus
sensor, the Morton codes and the seven sampling strategies, the PLY rows
(the host library's C++ against the plain Python loop), the PLY and
transforms files, the render-state and scene checkpoints, the capture
journal, scan_finite's message and the debug cube."""
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import torus as jtorus
from pathtracer_gaussiansplatting_tpu.csrc import build as jbuild
from pathtracer_gaussiansplatting_tpu.data import ply as jply
from pathtracer_gaussiansplatting_tpu.data import transforms as jtf
from pathtracer_gaussiansplatting_tpu.models import scene as jscene
from pathtracer_gaussiansplatting_tpu.ops import morton as jmorton
from pathtracer_gaussiansplatting_tpu.sampling import strategies as jss
from pathtracer_gaussiansplatting_tpu.utils import checkpoint as jckpt
from pathtracer_gaussiansplatting_tpu.utils.debug import (
    scan_finite as j_scan_finite,
)
from pathtracer_gaussiansplatting_tpu_torch.core import rng as trng
from pathtracer_gaussiansplatting_tpu_torch.core import torus as ttorus
from pathtracer_gaussiansplatting_tpu_torch.core.types import SCENE_FIELDS
from pathtracer_gaussiansplatting_tpu_torch.csrc import ply_rows
from pathtracer_gaussiansplatting_tpu_torch.data import ply as tply
from pathtracer_gaussiansplatting_tpu_torch.data import transforms as ttf
from pathtracer_gaussiansplatting_tpu_torch.models import scene as tscene
from pathtracer_gaussiansplatting_tpu_torch.ops import morton as tmorton
from pathtracer_gaussiansplatting_tpu_torch.sampling import strategies as tss
from pathtracer_gaussiansplatting_tpu_torch.utils import checkpoint as tckpt
from pathtracer_gaussiansplatting_tpu_torch.utils.debug import scan_finite

from torch_parity import (
    CPU, TORCH_THREADS, gspt_log, np_of, to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

# Torus points and normals: float32 sin and cos of the same angles, which
# XLA and torch round alike but for an ulp here and there.
TORUS_ATOL = 1e-6
TORI = [jtorus.TorusConfig(), jtorus.TorusConfig(major_radius=1.2,
                                                 minor_radius=0.4,
                                                 height=0.2)]


def t_config(cfg):
    return ttorus.TorusConfig(**{k: getattr(cfg, k) for k in (
        "major_radius", "minor_radius", "height", "num_rays",
        "major_segments", "minor_segments", "origin_offset")})


@pytest.mark.parametrize("cfg", TORI, ids=["default", "downstream"])
def test_torus_rays_match(cfg, rng):
    uv = rng.uniform(size=(4096, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [0.25, 0], [0, 0.5], [1, 1]]
    j_pos, j_nrm = jtorus.torus_point_normal(jnp.asarray(uv), cfg)
    pos, nrm = ttorus.torus_point_normal(uv, t_config(cfg), device=CPU)
    np.testing.assert_allclose(np_of(pos), np_of(j_pos), rtol=0,
                               atol=TORUS_ATOL * cfg.major_radius)
    np.testing.assert_allclose(np_of(nrm), np_of(j_nrm), rtol=0,
                               atol=TORUS_ATOL)
    j_rays = jtorus.torus_rays(jnp.asarray(uv), cfg)
    rays = ttorus.torus_rays(torch.from_numpy(uv), t_config(cfg))
    assert rays.origins.device.type == "cpu"   # a CPU tensor stays there
    np.testing.assert_allclose(np_of(rays.origins), np_of(j_rays.origins),
                               rtol=0, atol=TORUS_ATOL * cfg.major_radius)
    np.testing.assert_allclose(np_of(rays.directions),
                               np_of(j_rays.directions), rtol=0,
                               atol=TORUS_ATOL)


def test_torus_mesh_matches():
    cfg = jtorus.TorusConfig(major_segments=40, minor_segments=12)
    jv, jn, jf = jtorus.torus_mesh(cfg)
    v, n, f = ttorus.torus_mesh(t_config(cfg))
    assert f.dtype == np.int32 and isinstance(v, np.ndarray)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=TORUS_ATOL * 16)
    np.testing.assert_allclose(n, jn, rtol=0, atol=TORUS_ATOL)


def test_torus_rays_default_to_the_card():
    """Without a device or a tensor, the sensor builds on the CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttorus.torus_rays(np.zeros((2, 2), np.float32), ttorus.TorusConfig())


def test_morton_codes_equal(rng):
    uv = rng.uniform(size=(5000, 2)).astype(np.float32)
    np.testing.assert_array_equal(tmorton.morton2d(uv[:, 0], uv[:, 1]),
                                  jmorton.morton2d(uv[:, 0], uv[:, 1]))
    np.testing.assert_array_equal(tmorton.morton_sort_2d(uv),
                                  jmorton.morton_sort_2d(uv))
    pts = rng.normal(size=(5000, 3))
    np.testing.assert_array_equal(tmorton.morton3d(*(pts.T * 0.2 + 0.5)),
                                  jmorton.morton3d(*(pts.T * 0.2 + 0.5)))
    np.testing.assert_array_equal(tmorton.morton_order_points(pts),
                                  jmorton.morton_order_points(pts))


@pytest.fixture(scope="module")
def prev_pass():
    """A previous pass's (uv, colors, flags), as the importance strategies
    take them."""
    r = np.random.default_rng(5)
    uv = jss.generate_samples(jss.SamplingMethod.UNIFORM, 3000)
    colors = r.uniform(0, 1, (3000, 3)).astype(np.float32)
    flags = (r.uniform(size=3000) > 0.6).astype(np.float32)
    return uv, colors, flags


@pytest.mark.parametrize("method", [m.value for m in jss.SamplingMethod])
@pytest.mark.parametrize("n", [1000, 2047])
def test_sampling_bit_equal(method, n, prev_pass):
    """Every strategy gives the JAX package's bits, the importance ones from
    the same previous pass."""
    uv, colors, flags = prev_pass
    want = jss.generate_samples(jss.SamplingMethod(method), n, prev_uv=uv,
                                prev_colors=colors, prev_flags=flags)
    got = tss.generate_samples(tss.SamplingMethod(method), n, prev_uv=uv,
                               prev_colors=colors, prev_flags=flags)
    assert got.dtype == want.dtype and got.shape == (n, 2)
    np.testing.assert_array_equal(got, want)


def test_importance_without_previous_pass_is_random():
    for m in ("imp_col", "imp_hit"):
        np.testing.assert_array_equal(tss.generate_samples(m, 500),
                                      jss.generate_samples(m, 500))


def ply_inputs(n, seed=3):
    r = np.random.default_rng(seed)
    pos = (r.normal(size=(n, 3)) * 10.0 ** r.integers(-6, 6, (n, 1))
           ).astype(np.float32)
    pos[:3] = [[0.0, -0.0, 1.0], [1e-30, -3.4e38, 123456.7],
               [np.inf, -np.inf, 0.5]]
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    rgb = r.integers(0, 256, (n, 3)).astype(np.uint8)
    return pos, nrm, rgb


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000])
def test_ply_rows_cpp_byte_equal(n):
    """The host library's row formatter gives the plain loop's bytes (and
    the JAX package's), at every size the buffer bound must hold."""
    pos, nrm, rgb = ply_inputs(max(n, 3))
    pos, nrm, rgb = pos[:n], nrm[:n], rgb[:n]
    got = ply_rows.format_ply_rows(pos, nrm, rgb)
    assert got == ply_rows.format_ply_rows_plain(pos, nrm, rgb)
    assert got == jbuild.format_ply_rows(pos, nrm, rgb)
    assert got.count("\n") == n


def test_point_cloud_ply_matches(tmp_path):
    pos, nrm, _ = ply_inputs(500)
    pos = pos[3:]
    nrm = nrm[3:]
    colors = np.random.default_rng(4).uniform(-0.2, 1.2, (497, 3))
    flags = np.random.default_rng(5).uniform(-1, 1, 497).astype(np.float32)
    n = tply.save_point_cloud_ply(str(tmp_path / "t.ply"),
                                  torch.from_numpy(pos), nrm, colors, flags)
    jn = jply.save_point_cloud_ply(str(tmp_path / "j.ply"), pos, nrm, colors,
                                   flags)
    assert n == jn == int((flags > 0).sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tply.load_point_cloud_ply(str(tmp_path / "t.ply"))
    jback = jply.load_point_cloud_ply(str(tmp_path / "t.ply"))
    for k in ("positions", "normals", "colors"):
        np.testing.assert_array_equal(back[k], jback[k])
    # %g keeps six significant digits
    np.testing.assert_allclose(back["positions"], pos[flags > 0], rtol=5e-6)
    with open(tmp_path / "t.ply", "rb") as f:
        assert tply._parse_ply_header(f) == ("ascii", [
            "x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
            ["float"] * 6 + ["uchar"] * 3, n)


def test_transforms_roundtrip_matches(tmp_path):
    r = np.random.default_rng(6)
    frames = [dict(file_path=f"./train/r_{i}",
                   transform_matrix=r.normal(size=(4, 4)).astype(np.float32))
              for i in range(5)]
    ttf.save_transforms_json(str(tmp_path / "t.json"), 0.6911112, frames)
    jtf.save_transforms_json(str(tmp_path / "j.json"), 0.6911112, frames)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    back = ttf.load_transforms_json(str(tmp_path / "t.json"))
    jback = jtf.load_transforms_json(str(tmp_path / "t.json"))
    assert back["camera_angle_x"] == jback["camera_angle_x"] == 0.6911112
    for a, b, fr in zip(back["frames"], jback["frames"], frames):
        assert a["file_path"] == b["file_path"] == fr["file_path"]
        np.testing.assert_array_equal(a["transform_matrix"],
                                      fr["transform_matrix"])


def test_render_state_across_packages(tmp_path):
    """Either package reads the other's mid-pose state; the key comes back
    as the port's (2,) int64 key."""
    acc = np.random.default_rng(7).uniform(size=(64, 3)).astype(np.float32)
    jax_key = jax.random.PRNGKey(13)
    jckpt.save_render_state(str(tmp_path / "j.npz"), jnp.asarray(acc), 4,
                            jax_key, extra=dict(a=1))
    state = tckpt.load_render_state(str(tmp_path / "j.npz"), device=CPU)
    np.testing.assert_array_equal(np_of(state["accumulation"]), acc)
    assert state["frames_done"] == 4 and state["extra"] == dict(a=1)
    assert state["base_key"].dtype == torch.int64
    assert state["base_key"].tolist() == trng.prng_key(13).tolist()
    tckpt.save_render_state(str(tmp_path / "t.npz"), torch.from_numpy(acc),
                            4, trng.prng_key(13), extra=dict(a=1))
    jstate = jckpt.load_render_state(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(jstate["accumulation"]), acc)
    np.testing.assert_array_equal(np.asarray(jstate["base_key"]),
                                  np.asarray(jax_key))
    assert jstate["frames_done"] == 4 and jstate["extra"] == dict(a=1)


def test_scene_checkpoint_across_packages(tmp_path):
    js = jscene.random_cloud(50, seed=3, sh_degree=1)
    jckpt.save_scene(str(tmp_path / "j.npz"), js)
    ts = tckpt.load_scene(str(tmp_path / "j.npz"), device=CPU)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    tckpt.save_scene(str(tmp_path / "t.npz"), ts)
    back = jckpt.load_scene(str(tmp_path / "t.npz"))
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(js, f)))
    # a file from before the material channels loads with their defaults
    with np.load(str(tmp_path / "t.npz")) as z:
        old = {k: z[k] for k in z.files if k not in (
            "clearcoat", "clearcoat_roughness", "transmission")}
    np.savez(str(tmp_path / "old.npz"), **old)
    ts_old = tckpt.load_scene(str(tmp_path / "old.npz"), device=CPU)
    js_old = jckpt.load_scene(str(tmp_path / "old.npz"))
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(ts_old, f)),
                                      np.asarray(getattr(js_old, f)))


def test_capture_journal_fingerprint(tmp_path, caplog):
    path = str(tmp_path / ".progress.json")
    journal = tckpt.CaptureProgress(path, fingerprint="a")
    journal.mark(2)
    journal.mark(0)
    assert json.loads((tmp_path / ".progress.json").read_text()) == dict(
        done=[0, 2], fingerprint="a")
    assert jckpt.CaptureProgress(path, fingerprint="a").done == {0, 2}
    assert tckpt.CaptureProgress(path, fingerprint="a").is_done(2)
    with gspt_log(caplog):
        other = tckpt.CaptureProgress(path, fingerprint="b")
    assert other.done == set() and not other.is_done(2)
    assert "different configuration" in caplog.text


NT = collections.namedtuple("NT", "a b")
NAN = float("nan")
TREES = [
    lambda x: x(np.array([NAN, 1.0])),
    lambda x: {"b": x(np.array([np.inf, 1.0])),
               "a": (x(np.array([NAN])), [x(np.zeros(2)),
                                          x(np.array([NAN, NAN]))])},
    lambda x: NT(x(np.array([[NAN, 0.0], [0.0, -np.inf]], np.float32)), 3),
    lambda x: {"x": None, "y": x(np.array([1, 2])), "z": 2.5, "w": NAN,
               "v": x(np.array([True]))},
]


@pytest.mark.parametrize("tree", range(len(TREES)))
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_scan_finite_message(tree, kind):
    """The same message as the JAX package's, for tensors and arrays."""
    make = TREES[tree]
    with pytest.raises(FloatingPointError) as want:
        j_scan_finite(make(np.asarray), "ctx")
    conv = np.asarray if kind == "numpy" else torch.as_tensor
    with pytest.raises(FloatingPointError) as got:
        scan_finite(make(conv), "ctx")
    assert str(got.value) == str(want.value)
    scan_finite({"a": torch.ones(3), "b": np.zeros(2), "c": torch.arange(3)})


def test_debug_cube_matches():
    js = jscene.debug_cube_scene(center=(0.0, 8.0, 0.0), size=8.0, res=4)
    ts = tscene.debug_cube_scene(center=(0.0, 8.0, 0.0), size=8.0, res=4,
                                 device=CPU)
    assert ts.num_gaussians == js.num_gaussians == 6 * 16
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(np_of(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_concat_scenes_pads_sh():
    a = tscene.random_cloud(4, sh_degree=0, device=CPU)
    b = tscene.random_cloud(6, sh_degree=2, device=CPU)
    c = tscene.concat_scenes([a, b])
    assert c.sh_coeffs.shape == (10, 9, 3)
    want = jscene.concat_scenes([jscene.random_cloud(4, sh_degree=0),
                                 jscene.random_cloud(6, sh_degree=2)])
    ref = to_torch_scene(want)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(c, f)),
                                      np_of(getattr(ref, f)))
