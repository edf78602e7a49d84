"""Helpers for the port's parity tests: move the JAX package's scenes and
cameras into the PyTorch port and compare results as numpy arrays."""
import contextlib
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import Camera as JCamera
from pathtracer_gaussiansplatting_tpu.core.camera import look_at as j_look_at
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.ops import binning as jb
from pathtracer_gaussiansplatting_tpu.render import tiled as jtiled
from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera, look_at
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    PUNCTUAL_FIELDS, SCENE_FIELDS, GaussianScene, PunctualLights,
    punctual_from_numpy, scene_from_numpy,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.logging import get_logger

# tier-1 runs several pytest workers; keep each one's torch pool small
TORCH_THREADS = 2
# The port's constructors build on the CUDA card unless told otherwise; the
# CPU tests say so explicitly.
CPU = "cpu"
# Path-traced images, port against reference: a pixel matches within the
# reference's kernel tolerance. A sample's path makes discrete choices
# (lobe, glass, strategy, roulette, a Gaussian at an alpha cutoff) on values
# that the packages round differently by an ulp, so a small share of pixels
# may take the other branch (ROADMAP section 3, cutoff flips). On the
# well-conditioned scenes of tests/test_torch_pathtrace.py (sigma 0.2-0.5)
# none did when the tests were written; the bounds leave room for a few.
RTOL, ATOL = 1e-3, 3e-4
MAX_SHARE = 0.01        # pixels outside RTOL / ATOL
MAX_MEAN_ABS = 2e-4     # mean |port - reference| over the image


def np_of(x) -> np.ndarray:
    """numpy view of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch_scene(scene, device=CPU) -> GaussianScene:
    """The port's GaussianScene with the JAX scene's exact parameters."""
    return scene_from_numpy({f: np.asarray(getattr(scene, f))
                             for f in SCENE_FIELDS}, device)


def cameras(eye=(0.0, 0.5, 4.0), target=(0.0, 0.0, 0.0), fov=50.0,
            width=64, height=48):
    """The same pinhole camera in both packages: (jax_camera, camera)."""
    return (JCamera(c2w=j_look_at(eye, target), fov_y_deg=fov, width=width,
                    height=height),
            Camera(c2w=look_at(eye, target, device=CPU), fov_y_deg=fov,
                   width=width, height=height))


def to_torch_lights(lights, device=CPU) -> PunctualLights:
    """The port's PunctualLights with the JAX lights' exact values."""
    return punctual_from_numpy({f: np.asarray(getattr(lights, f))
                                for f in PUNCTUAL_FIELDS}, device)


def to_torch_tables(tables, device=CPU):
    """The JAX LightTables as the port's, value for value."""
    from pathtracer_gaussiansplatting_tpu_torch.render.lights import (
        LightTables,
    )

    return LightTables(**{
        f.name: torch.from_numpy(np.array(getattr(tables, f.name))).to(device)
        for f in dataclasses.fields(LightTables)})


def to_torch_key(key) -> torch.Tensor:
    """A jax.random key as the port's (2,) int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def share_outside(got, want, rtol, atol) -> float:
    """Share of pixels (rows of the last axis) of two images where any
    channel misses atol + rtol |want|."""
    g, w = np_of(got), np_of(want)
    bad = np.abs(g - w) > atol + rtol * np.abs(w)
    return float(bad.reshape(-1, bad.shape[-1]).any(-1).mean())


def to_torch_packets(packets) -> dict:
    """JAX packets (geom, featsT, count) as CPU tensors."""
    return {k: torch.from_numpy(np.array(packets[k]))
            for k in ("geom", "featsT", "count")}


def pose_packets(n, spread, k, seed=21, eye=(0.0, 0.5, 4.0),
                 scale_range=(-2.5, -1.0), tile_size=16):
    """JAX packets and jittered tile dirs of one small 64x48 pose, and their
    torch copies: (packets, dirs, torch packets, torch dirs)."""
    scene = j_random_cloud(n, seed=seed, spread=spread,
                           scale_range=scale_range)
    jcam, _ = cameras(eye=eye)
    cfg = jb.BinningConfig(max_per_tile=k, tile_size=tile_size)
    settings = JRenderSettings(background=(0.1, 0.2, 0.3))
    packets = jtiled.prepare_tiles(scene, jcam, settings, cfg)
    jit = np.random.default_rng(seed).uniform(0, 1, (48, 64, 2))
    dirs, _ = jtiled._tile_dirs(jcam, cfg, jnp.asarray(jit, jnp.float32))
    return (packets, dirs, to_torch_packets(packets),
            torch.from_numpy(np.array(dirs)))


def assert_close(got, want, rtol, atol, err_msg=""):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def dataclass_defaults(cls) -> dict:
    return {f.name: f.default for f in dataclasses.fields(cls)}


def assert_image_close(got, want, name):
    share = share_outside(got, want, RTOL, ATOL)
    mean_abs = float(np.abs(np_of(got) - np_of(want)).mean())
    print(f"{name}: {share:.4%} of pixels outside rtol {RTOL} / atol {ATOL}"
          f", mean abs diff {mean_abs:.3e}")
    assert np_of(got).shape == np_of(want).shape
    assert np.isfinite(np_of(got)).all()
    assert share <= MAX_SHARE and mean_abs <= MAX_MEAN_ABS, (share, mean_abs)


@contextlib.contextmanager
def gspt_log(caplog, level=logging.WARNING):
    """Gathers the ``gspt`` logger's records at ``level`` into caplog. The
    logger does not propagate to the root logger, where caplog listens
    (utils/logging.get_logger), so caplog's handler joins it here."""
    logger = get_logger()
    with caplog.at_level(level, logger=logger.name):
        logger.addHandler(caplog.handler)
        try:
            yield
        finally:
            logger.removeHandler(caplog.handler)


def assert_fill_counts_rows(geom, packet, fill, kc: int,
                            opac_col: int) -> None:
    """A grid table's ``fill`` (S,) int32 is each row's filled slots: the
    slots below it hold a Gaussian (opacity > 0), every slot at or past it
    is zero in both the geometry and the packet table (rows flat, column
    c at [c Kc, (c + 1) Kc))."""
    assert fill.dtype == torch.int32 and fill.shape == geom.shape[:1]
    past = torch.arange(kc)[None, :] >= fill[:, None].long()   # (S, Kc)
    for table in (geom, packet):
        cols = table.reshape(table.shape[0], -1, kc)
        assert not bool(((cols != 0).any(1) & past).any())
    opac = geom.reshape(geom.shape[0], -1, kc)[:, opac_col]
    assert bool(((opac > 0) | past).all())
