"""The port's render RNG against the JAX package: a bounce's uniforms in
one draw (``core.rng.bounce_uniforms``) and the jitter with host R2
offsets, bit for bit on the CPU; the K5 kernel (``csrc/threefry.cu``)
against its plain version on the card."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import rng as jrng
from pathtracer_gaussiansplatting_tpu_torch.core import rng as trng
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import threefry as k5

from torch_parity import CPU, TORCH_THREADS, np_of

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# render/pathtrace._bounce_uniforms' draws: {name: (dimension, num)}.
NEE = dict(strat=(10, 1), sel=(7, 1), disk=(8, 2))
SCATTER = dict(lobe=(13, 1), dir=(14, 2), cc=(12, 1), glass=(15, 1),
               reflect=(11, 1))
DIM_SETS = {"8 dims": {**NEE, **SCATTER},
            "9 dims with rr": {**NEE, **SCATTER, "rr": (20, 1)},
            "last bounce": NEE}


def _keys(bounce: int):
    """The JAX package's and the port's key of one bounce of frame 5."""
    jkey = jax.random.fold_in(jrng.frame_key(jax.random.PRNGKey(13), 5),
                              bounce)
    tkey = trng.fold_in(trng.frame_key(trng.prng_key(13), 5), bounce)
    assert np.array_equal(np_of(tkey), np.asarray(jkey).astype(np.int64))
    return jkey, tkey


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    assert x.dtype == np.float32
    return x.view(np.uint32)


@pytest.mark.parametrize("r", [1, 7, 4099])
@pytest.mark.parametrize("dims", list(DIM_SETS))
def test_bounce_uniforms_match_jax(dims, r):
    jkey, tkey = _keys(2)
    before = launch.launches["threefry"]
    got = trng.bounce_uniforms(tkey, r, DIM_SETS[dims], device=CPU)
    assert launch.launches["threefry"] == before
    assert list(got) == list(DIM_SETS[dims])
    for name, (dim, num) in DIM_SETS[dims].items():
        want = jrng.ray_uniform(jkey, r, dim, num)
        assert got[name].shape == (r, num) and got[name].is_contiguous()
        assert np.array_equal(_bits(np_of(got[name])), _bits(want)), name


@pytest.mark.parametrize("frame", [0, 1, 99, 511])
def test_jitter_host_r2_matches_jax(frame):
    key, tkey = jax.random.PRNGKey(13), trng.prng_key(13)
    r2 = trng.r2_host(frame)
    assert np.array_equal(np.asarray(r2, np.float32).view(np.uint32),
                          _bits(jrng.r2_sequence(frame)))
    jitter_key = trng.dim_key(trng.frame_key(tkey, frame), 0)
    want = _bits(jrng.subpixel_jitter(key, 24, 40, frame))
    plain = trng.jitter_plain(jitter_key, 24, 40, r2, CPU)
    assert np.array_equal(_bits(np_of(plain)), want)
    assert np.array_equal(
        _bits(np_of(trng.subpixel_jitter(tkey, 24, 40, frame, device=CPU))),
        want)


def test_cpu_draws_launch_nothing_and_need_no_nvcc():
    """On CPU tensors every draw runs the plain version: the kernel count
    stays 0 and nothing is built, in a process without nvcc."""
    code = (
        "import sys\n"
        "from pathtracer_gaussiansplatting_tpu_torch.core import rng\n"
        "from pathtracer_gaussiansplatting_tpu_torch.csrc import build\n"
        "from pathtracer_gaussiansplatting_tpu_torch.kernels import "
        "launch\n"
        "key = rng.prng_key(3)\n"
        "rng.bounce_uniforms(key, 5, dict(a=(10, 1), b=(8, 2)), 'cpu')\n"
        "rng.ray_uniform(key, 5, 7, device='cpu')\n"
        "rng.uniform(key, (2, 3), device='cpu')\n"
        "rng.subpixel_jitter(key, 4, 6, 1, device='cpu')\n"
        "assert launch.launches['threefry'] == 0 and build._LIB is None\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc")))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_kernel_refuses_bad_tables():
    keys = [(1, 2)] * (k5.MAX_DIMS + 1)
    with pytest.raises(ValueError, match="1 to 16 draws"):
        k5.threefry_uniforms(keys, [1] * len(keys), 8, "cpu")
    with pytest.raises(ValueError, match="1 to 16 draws"):
        k5.threefry_uniforms([], [], 8, "cpu")
    with pytest.raises(ValueError, match="jitter is one draw"):
        k5.threefry_uniforms([(1, 2)], [1], 8, "cpu", r2=(0.5, 0.25))
    # A CPU device goes to the plain version, never to the kernel.
    with pytest.raises(ValueError, match="plain version"):
        k5.threefry_uniforms([(1, 2)], [1], 8, "cpu")
    assert launch.launches["threefry"] == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card K5 equals its plain version bit for bit: each dim set
    at a few sizes (one launch each, every draw a contiguous view), the
    jitter mode, and a path-traced sample makes one launch a bounce."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    from pathtracer_gaussiansplatting_tpu_torch.core.camera import (
        Camera, generate_rays, look_at,
    )
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        RenderSettings,
    )
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        surface_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.render.pathtrace import (
        pathtrace,
    )

    dev = torch.device("cuda", 0)
    _, key = _keys(1)
    for dims in DIM_SETS.values():
        for r in (1, 7, 1023, 1025, 300_001):
            before = launch.launches["threefry"]
            got = trng.bounce_uniforms(key, r, dims, device=dev)
            torch.cuda.synchronize()
            assert launch.launches["threefry"] == before + 1
            want = trng.uniforms_plain(
                [(trng.dim_key(key, d), n) for d, n in dims.values()], r, dev)
            for (name, g), w in zip(got.items(), want):
                assert g.is_contiguous() and g.shape == w.shape, name
                assert torch.equal(g.view(torch.int32),
                                   w.view(torch.int32)), (name, r)
    for frame in (0, 1, 99, 511):
        got = trng.subpixel_jitter(key, 67, 129, frame, device=dev)
        want = trng.jitter_plain(trng.dim_key(trng.frame_key(key, frame), 0),
                                 67, 129, trng.r2_host(frame), dev)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    scene = surface_scene(2000, seed=13, device=dev)
    rays = generate_rays(Camera(c2w=look_at((0, 0.2, 1.7), (0, -0.4, -0.5),
                                            device=dev),
                                fov_y_deg=60.0, width=32, height=24))
    settings = RenderSettings(max_depth=3)
    before = launch.launches["threefry"]
    out = pathtrace(scene, rays, settings, trng.frame_key(key, 0))
    torch.cuda.synchronize()
    assert launch.launches["threefry"] == before + settings.max_depth
    assert bool(torch.isfinite(out).all())
