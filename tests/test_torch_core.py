"""PyTorch port vs the JAX package: settings, math leaves, camera, RNG,
scene builders, accumulation and images (CPU)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import camera as jcam
from pathtracer_gaussiansplatting_tpu.core import rng as jrng
from pathtracer_gaussiansplatting_tpu.core import sh as jsh
from pathtracer_gaussiansplatting_tpu.core import types as jtypes
from pathtracer_gaussiansplatting_tpu.data import images as jimages
from pathtracer_gaussiansplatting_tpu.models import scene as jscene
from pathtracer_gaussiansplatting_tpu.ops import binning as jbinning
from pathtracer_gaussiansplatting_tpu.ops import composite as jcomposite
from pathtracer_gaussiansplatting_tpu.ops import gaussians as jgauss
from pathtracer_gaussiansplatting_tpu.ops import quaternions as jquat
from pathtracer_gaussiansplatting_tpu.render.pathtrace import (
    accumulate as j_accumulate,
)
from pathtracer_gaussiansplatting_tpu_torch.core import camera as tcam
from pathtracer_gaussiansplatting_tpu_torch.core import rng as trng
from pathtracer_gaussiansplatting_tpu_torch.core import sh as tsh
from pathtracer_gaussiansplatting_tpu_torch.core import types as ttypes
from pathtracer_gaussiansplatting_tpu_torch.data import images as timages
from pathtracer_gaussiansplatting_tpu_torch.models import scene as tscene
from pathtracer_gaussiansplatting_tpu_torch.ops import binning as tbinning
from pathtracer_gaussiansplatting_tpu_torch.ops import composite as tcomposite
from pathtracer_gaussiansplatting_tpu_torch.ops import gaussians as tgauss
from pathtracer_gaussiansplatting_tpu_torch.ops import quaternions as tquat
from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import accumulate

from torch_parity import (
    CPU, TORCH_THREADS, assert_close, cameras, dataclass_defaults, np_of,
    to_torch_scene,
)

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("pair", [
    (jtypes.RenderSettings, ttypes.RenderSettings),
    (jbinning.BinningConfig, tbinning.BinningConfig),
], ids=["RenderSettings", "BinningConfig"])
def test_config_defaults_match(pair):
    jcls, tcls = pair
    assert dataclass_defaults(tcls) == dataclass_defaults(jcls)
    assert tcls() == tcls(**dataclass_defaults(jcls))


def test_quaternions_match(rng):
    q = _quats(rng) * rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
    qt = torch.from_numpy(q)
    assert_close(tquat.normalize(qt), jquat.normalize(jnp.asarray(q)),
                 0, 1e-6)
    rot = tquat.quat_to_rotmat(qt)
    assert_close(rot, jquat.quat_to_rotmat(jnp.asarray(q)), 0, 1e-6)
    for got, want in zip(tquat.rotmat_cols(qt),
                         jquat.rotmat_cols(jnp.asarray(q))):
        assert_close(got, want, 0, 1e-6)
    assert_close(tquat.rotmat_to_quat(rot),
                 jquat.rotmat_to_quat(jnp.asarray(np_of(rot))), 0, 1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(rng, degree):
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(50, k, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tsh.eval_sh(torch.from_numpy(coeffs), torch.from_numpy(d))
    assert_close(got, jsh.eval_sh(jnp.asarray(coeffs), jnp.asarray(d)),
                 0, 1e-6)
    assert tsh.SH_C0 == jsh.SH_C0


def test_gaussian_ops_match(rng):
    q = _quats(rng)
    ls = rng.uniform(-3, -1, (64, 3)).astype(np.float32)
    ls[:8, 1] = ls[:8, 0]          # ties: argmin keeps the first index
    ls[8:16, 2] = ls[8:16, 1]
    ls[16:20] = ls[16:20, :1]
    view = rng.normal(size=(64, 3)).astype(np.float32)
    qt, lst = torch.from_numpy(q), torch.from_numpy(ls)
    # M = diag(1/s) R^T: R's entries agree to 1e-6, scaled by up to 1/s.
    assert_close(tgauss.canonical_transforms(lst, qt),
                 jgauss.canonical_transforms(jnp.asarray(ls), jnp.asarray(q)),
                 0, 1e-6 * float(np.exp(-ls).max()))
    for vd in (None, view):
        got = tgauss.surfel_normal(
            lst, qt, None if vd is None else torch.from_numpy(vd))
        want = jgauss.surfel_normal(
            jnp.asarray(ls), jnp.asarray(q),
            None if vd is None else jnp.asarray(vd))
        assert_close(got, want, 0, 1e-6)
    opac = rng.uniform(0, 1, 500).astype(np.float32)
    gval = rng.uniform(0, 1, 500).astype(np.float32)
    gval[:50] = np.exp(-4.5) * rng.uniform(0.9, 1.1, 50)  # near sigma_cut
    assert_close(tgauss.alpha_from_response(torch.from_numpy(opac),
                                            torch.from_numpy(gval)),
                 jgauss.alpha_from_response(jnp.asarray(opac),
                                            jnp.asarray(gval)), 0, 1e-7)


def test_composite_weights_match(rng):
    alphas = rng.uniform(0, 0.999, (16, 40)).astype(np.float32)
    alphas[:, ::3] = 0.0
    got_w, got_t = tcomposite.composite_weights(torch.from_numpy(alphas))
    want_w, want_t = jcomposite.composite_weights(jnp.asarray(alphas))
    assert_close(got_w, want_w, 1e-5, 1e-7)
    assert_close(got_t, want_t, 1e-5, 1e-7)


@pytest.mark.parametrize("jittered", [False, True], ids=["centers", "jitter"])
def test_generate_rays_match(rng, jittered):
    jc, tc = cameras(eye=(0.3, 0.5, 4.0), target=(0.1, 0.0, -0.2), fov=55.0)
    assert_close(tc.c2w, jc.c2w, 0, 1e-6)
    jit = rng.uniform(0, 1, (48, 64, 2)).astype(np.float32) if jittered \
        else None
    got = tcam.generate_rays(tc,
                             None if jit is None else torch.from_numpy(jit))
    want = jcam.generate_rays(jc, None if jit is None else jnp.asarray(jit))
    assert_close(got.directions, want.directions, 0, 1e-6)
    assert_close(got.origins, want.origins, 0, 1e-6)
    assert_close(tcam.view_matrix(tc), jcam.view_matrix(jc), 0, 1e-6)
    assert tc.fov_x_rad == jc.fov_x_rad


@pytest.mark.parametrize("angles", [(0.0, 0.0), (30.0, 45.0), (200.0, 120.0),
                                    (-75.0, 400.0)])
def test_toroidal_c2w_matches(angles):
    got = tcam.toroidal_c2w(angles[0], angles[1], 3.0, 0.5, device=CPU)
    want = jcam.toroidal_c2w(angles[0], angles[1], 3.0, 0.5)
    assert_close(got, want, 0, 1e-6)


@pytest.mark.parametrize("frame", [0, 1, 7, 511])
def test_rng_bit_exact(frame):
    key = jax.random.PRNGKey(13)
    tkey = trng.prng_key(13)
    assert np.array_equal(np_of(tkey), np.asarray(key).astype(np.int64))
    assert np.array_equal(np_of(trng.frame_key(tkey, frame)),
                          np.asarray(jrng.frame_key(key, frame)))
    got = np_of(trng.subpixel_jitter(tkey, 48, 64, frame, device=CPU))
    want = np.asarray(jrng.subpixel_jitter(key, 48, 64, frame))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(np_of(trng.r2_sequence(frame, CPU)).view(np.uint32),
                          np.asarray(jrng.r2_sequence(frame)).view(np.uint32))


@pytest.mark.parametrize("builder", ["random_cloud", "surface_scene"])
def test_scene_builders_match(builder):
    if builder == "random_cloud":
        want = jscene.random_cloud(700, seed=3, spread=1.3, sh_degree=1,
                                   emissive_frac=0.1)
        got = tscene.random_cloud(700, seed=3, spread=1.3, sh_degree=1,
                                  emissive_frac=0.1, device=CPU)
    else:
        want = jscene.surface_scene(900, seed=13)
        got = tscene.surface_scene(900, seed=13, device=CPU)
    for f in ttypes.SCENE_FIELDS:
        assert_close(getattr(got, f), getattr(want, f), 0, 1e-6, err_msg=f)
    assert got.num_gaussians == want.num_gaussians
    assert got.sh_degree == want.sh_degree
    assert_close(got.opacities, want.opacities, 0, 1e-6)


def test_make_scene_and_scene_from_numpy(rng):
    n = 20
    args = dict(means=rng.normal(size=(n, 3)),
                log_scales=rng.normal(size=(n, 3)), quats=_quats(rng, n),
                opacity_logits=rng.normal(size=n),
                colors=rng.uniform(size=(n, 3)))
    want = jtypes.make_scene(**args)
    got = ttypes.make_scene(**args, device=CPU)
    for f in ttypes.SCENE_FIELDS:
        assert_close(getattr(got, f), getattr(want, f), 0, 1e-6, err_msg=f)
    moved = to_torch_scene(want)
    assert all(torch.equal(getattr(moved, f), getattr(got, f))
               for f in ("means", "quats", "roughness"))
    assert moved.to("cpu").replace(metallic=moved.roughness).metallic is \
        moved.roughness


def test_accumulate_matches(rng):
    prev = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    cur = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    for frame in (0, 1, 6, 511):
        got = accumulate(torch.from_numpy(prev), torch.from_numpy(cur), frame)
        want = j_accumulate(jnp.asarray(prev), jnp.asarray(cur), frame)
        assert np.array_equal(np_of(got), np.asarray(want))


def test_image_helpers_match(rng, tmp_path):
    img = rng.uniform(-0.2, 1.3, (12, 10, 3))
    assert np.array_equal(timages.linear_to_srgb(img),
                          jimages.linear_to_srgb(img))
    assert np.array_equal(timages.box_downscale(img, 4),
                          jimages.box_downscale(img, 4))
    timages.save_png(str(tmp_path / "a.png"), img)
    jimages.save_png(str(tmp_path / "b.png"), img)
    assert ((tmp_path / "a.png").read_bytes()
            == (tmp_path / "b.png").read_bytes())


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import pathtracer_gaussiansplatting_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 20, mods\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


_SCENE_ARGS = dict(means=[[0.0, 0.0, 0.0]], log_scales=[[0.0, 0.0, 0.0]],
                   quats=[[1.0, 0.0, 0.0, 0.0]], opacity_logits=[0.0])
_LIGHT_LEAVES = {f: np.zeros((1, 3) if f in ("position", "direction",
                                             "color") else (1,))
                 for f in ttypes.PUNCTUAL_FIELDS}
CONSTRUCTORS = {
    "make_scene": lambda **kw: ttypes.make_scene(**_SCENE_ARGS, **kw),
    "scene_from_numpy": lambda **kw: ttypes.scene_from_numpy(
        {f: np.zeros((1, 1, 3)) if f == "sh_coeffs" else np.zeros(
            (1, 3) if f in ("means", "log_scales", "emission") else
            (1, 4) if f == "quats" else (1,)) for f in ttypes.SCENE_FIELDS},
        **kw),
    "make_punctual_lights": lambda **kw: ttypes.make_punctual_lights(
        position=[[0.0, 1.0, 0.0]], **kw),
    "punctual_from_numpy": lambda **kw: ttypes.punctual_from_numpy(
        _LIGHT_LEAVES, **kw),
    "surface_scene": lambda **kw: tscene.surface_scene(50, **kw),
    "random_cloud": lambda **kw: tscene.random_cloud(50, **kw),
    "look_at": lambda **kw: tcam.look_at((0, 0, 4), (0, 0, 0), **kw),
    "toroidal_c2w": lambda **kw: tcam.toroidal_c2w(10.0, 20.0, 2.5, 0.3,
                                                   **kw),
    "uniform": lambda **kw: trng.uniform(trng.prng_key(1), (4,), **kw),
    "r2_sequence": lambda **kw: trng.r2_sequence(3, **kw),
    "ray_uniform": lambda **kw: trng.ray_uniform(trng.prng_key(1), 4, 7,
                                                 **kw),
    "subpixel_jitter": lambda **kw: trng.subpixel_jitter(trng.prng_key(1),
                                                         4, 6, 0, **kw),
    "bounce_uniforms": lambda **kw: trng.bounce_uniforms(
        trng.prng_key(1), 4, dict(sel=(7, 1), disk=(8, 2)), **kw),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(monkeypatch, name):
    """Without a device a constructor builds on the CUDA card; where there
    is none it raises and names device="cpu", and never falls back to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CONSTRUCTORS[name]()
    out = CONSTRUCTORS[name](device=CPU)
    leaves = [out] if isinstance(out, torch.Tensor) else list(
        out.values()) if isinstance(out, dict) else [
        getattr(out, f.name) for f in dataclasses.fields(out)]
    assert all(x.device.type == "cpu" for x in leaves)
