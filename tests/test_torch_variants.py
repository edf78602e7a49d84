"""The ablation harness's plain versions against the JAX package's
``_variant_kernel`` (benchmarks/variant_kernel.py, its Pallas kernel run
in interpret mode on the CPU), mode by mode."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import Camera, look_at
from pathtracer_gaussiansplatting_tpu.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu.kernels import tile_composite as jtc
from pathtracer_gaussiansplatting_tpu.models.scene import random_cloud
from pathtracer_gaussiansplatting_tpu.ops.binning import BinningConfig
from pathtracer_gaussiansplatting_tpu.render.tiled import (
    _tile_dirs, prepare_tiles,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    RenderSettings as TRenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import (
    tile_composite_variants as tv,
)

from torch_parity import TORCH_THREADS, np_of

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 3e-4  # the forward kernel's tolerance against its oracle


@pytest.fixture(scope="module")
def vk():
    """benchmarks/variant_kernel.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "variant_kernel",
        os.path.join(ROOT, "benchmarks", "variant_kernel.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inputs():
    """One 64x48 pose of random_cloud(3000, seed 13, spread 1.5), K=256:
    the JAX packets (features padded as variant_kernel.main pads them) and
    their torch copies."""
    scene = random_cloud(3000, seed=13, spread=1.5)
    cam = Camera(c2w=look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0)),
                 fov_y_deg=50.0, width=64, height=48)
    settings = RenderSettings(background=(0.1, 0.2, 0.3))
    cfg = BinningConfig(max_per_tile=256)
    pk = prepare_tiles(scene, cam, settings, cfg)
    featsT, _, _ = jtc._pack_inputs(pk)
    dirs, _ = _tile_dirs(cam, cfg)
    torch_in = tuple(torch.from_numpy(np.array(x)) for x in (
        pk["geom"], pk["featsT"], dirs, pk["count"]))
    return dict(jax=(pk["geom"], featsT, dirs, pk["count"], settings),
                torch=torch_in + (TRenderSettings(background=(0.1, 0.2,
                                                              0.3)),))


def _run_jax(monkeypatch, vk, mode, args):
    monkeypatch.setattr(vk.pl, "pallas_call",
                        functools.partial(vk.pl.pallas_call, interpret=True))
    jitted, *jargs = vk.run_variant(mode, *args)
    return np.asarray(jitted(*jargs))[:args[0].shape[0]]


@pytest.mark.parametrize("mode", tv.MODES)
def test_variant_plain_matches_reference(monkeypatch, vk, inputs, mode):
    """Each mode's plain version against the reference's kernel in that
    mode. The tensor-core modes re-round full's math, so their plain
    version is full's, held to the reference's full (its mxu3 splits into
    bf16 and misses full by ~2e-3 on the CPU)."""
    got = np_of(tv.tile_composite_variant_plain(mode, *inputs["torch"]))
    ref_mode = "full" if mode in tv.TENSOR_CORE else mode
    want = _run_jax(monkeypatch, vk, ref_mode, inputs["jax"])
    assert got.shape == want.shape == (12, 256, tv.out_channels(mode))
    if mode in tv.TENSOR_CORE:
        full = np_of(tv.tile_composite_variant_plain("full",
                                                     *inputs["torch"]))
        assert np.array_equal(got, full)
    if mode == "noscan":
        # Its transmittance ignores all but each chunk's last slot, so
        # alpha_acc stays ~0 and the depth channel reaches ~6e9: relative.
        np.testing.assert_allclose(got[..., -1], want[..., -1], rtol=RTOL)
        got, want = got[..., :-1], want[..., :-1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if mode != "nodiv":  # t = 1 puts every peak far off: all zeros
        assert np.abs(want).max() > 0  # the mode composites something


def test_variant_dispatch_on_cpu(inputs):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; an unknown mode raises."""
    before = launch.launches["tile_variant"]
    got = tv.tile_composite_variant("floor", *inputs["torch"])
    assert launch.launches["tile_variant"] == before
    assert torch.equal(got, tv.tile_composite_variant_plain(
        "floor", *inputs["torch"]))
    with pytest.raises(ValueError, match="unknown mode"):
        tv.tile_composite_variant_plain("nope", *inputs["torch"])
    assert len(tv.MODES) == 19


@pytest.mark.cuda
def test_variant_kernels_match_plain_on_card():
    """Every mode's kernel against its plain version on the card (the
    tensor-core modes against full's math, finite only: their rounding is
    what they measure); full and hoist bit-equal to the forward kernel.
    Two inputs: 64 tiles at K=256, and 49 tiles of a sparser cloud at
    K=512 (four chunks; counts 99-512, so most tiles end in a short stage,
    and skel32's last block holds one tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built for sm_90a)")
    from pathtracer_gaussiansplatting_tpu_torch.kernels import (
        tile_composite as tc,
    )

    for n, res, k in ((20_000, 128, 256), (2_000, 112, 512)):
        inputs = tv.headline_inputs(n, res, k, device="cuda")
        geom, featsT, dirs, count, settings = inputs
        if k == 512:
            assert geom.shape[0] % 4 != 0
            assert bool(((torch.ceil(count) % 32 != 0) & (count > 0)).any())
        fwd = tc.tile_composite(dict(geom=geom, featsT=featsT, count=count),
                                dirs, settings)
        for mode in tv.MODES:
            got = tv.tile_composite_variant(mode, *inputs)
            torch.cuda.synchronize()
            if mode in tv.TENSOR_CORE:
                assert bool(torch.isfinite(got).all())
                continue
            want = tv.tile_composite_variant_plain(mode, *inputs)
            if mode == "noscan":
                torch.testing.assert_close(got[..., -1], want[..., -1],
                                           rtol=RTOL, atol=0.0)
                got, want = got[..., :-1], want[..., :-1]
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            if mode in ("full", "hoist"):
                assert torch.equal(got[..., :14], fwd[0])
                assert torch.equal(got[..., tv.FP], fwd[1])
                assert torch.equal(got[..., tv.FP + 1], fwd[2])
