"""The port's dataset capture vs the JAX package (CPU): the miniature
capture and the importance-feedback capture of tests/test_data_io.py run
through both packages, the panorama, the mid-pose checkpoints (crash and
resume, a JAX-written state, fingerprints), the resume journal, and the
grid that one capture builds once."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracer_gaussiansplatting_tpu.core.camera import (
    toroidal_c2w as j_toroidal_c2w,
)
from pathtracer_gaussiansplatting_tpu.core.torus import (
    TorusConfig as JTorusConfig,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.data import capture as jcap
from pathtracer_gaussiansplatting_tpu.models.scene import (
    debug_cube_scene as j_debug_cube_scene,
)
from pathtracer_gaussiansplatting_tpu.render import pipeline as jpipe
from pathtracer_gaussiansplatting_tpu_torch.core.camera import toroidal_c2w
from pathtracer_gaussiansplatting_tpu_torch.core.torus import TorusConfig
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    RenderSettings, make_punctual_lights,
)
from pathtracer_gaussiansplatting_tpu_torch.data import capture as tcap
from pathtracer_gaussiansplatting_tpu_torch.data.images import to_uint8_srgb
from pathtracer_gaussiansplatting_tpu_torch.data.ply import (
    load_point_cloud_ply,
)
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt
from pathtracer_gaussiansplatting_tpu_torch.render import pipeline as tpipe
from pathtracer_gaussiansplatting_tpu_torch.utils.checkpoint import (
    load_render_state, save_render_state,
)

from torch_parity import (
    CPU, TORCH_THREADS, assert_image_close, gspt_log, to_torch_scene,
)
from utils import random_scene

torch.set_num_threads(TORCH_THREADS)

# Dataset files, port against reference. Camera matrices: the same float32
# pose math, within an ulp or two of the entries (|x| <= ~16).
MATRIX_ATOL = 1e-6
# Images: the 8-bit sRGB image each JPG encodes (after the box downscale)
# agrees within IMG_ATOL levels on at least IMG_MIN_SHARE of its channels
# (1 level at most when written). The JPEG codec then quantizes each 8x8
# block's DCT coefficients, so one level before it can move a whole block
# by a few (5 at most when written): the decoded files agree within
# JPG_ATOL levels.
IMG_ATOL, IMG_MIN_SHARE = 2, 0.99
JPG_ATOL = 8
# PLY rows: the header and the row count are equal and colors (0-255,
# truncated) within PLY_COLOR_ATOL. Positions and normals are first hits
# of torus rays on the cube's thin surfels (normal sigma 0.04 against a
# tangent sigma of 1.6), often at grazing angles, where the packages'
# ulp-level differences move the hit: positions within PLY_EXTENT_TOL of
# the scene's extent, normals within PLY_NORMAL_ATOL. The JAX package does
# not hold its own rows to %g's six digits either: its capture with
# jax.disable_jit() differs from the jitted one by up to 5.5e-3 in a
# position and 2.3e-3 in a normal (XLA contracts multiply-adds into FMAs
# under jit, ROADMAP section 3), as much as the port differs from it.
PLY_COLOR_ATOL = 1
PLY_EXTENT_TOL, PLY_NORMAL_ATOL = 1e-3, 1e-2
KW = dict(max_depth=1, max_contribs=32, ambient=(0.1, 0.1, 0.1, 1.0))


@pytest.fixture(scope="module")
def cube():
    """tests/test_data_io.py's capture scene in both packages: the debug
    cube on the torus axis, where the cameras and the inward sensor rays
    both see it."""
    js = j_debug_cube_scene(center=(0.0, 8.0, 0.0), size=8.0, res=4)
    return js, to_torch_scene(js)


def file_layout(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def ply_parts(path):
    head = open(path).read().split("end_header\n")[0]
    return head, load_point_cloud_ply(path)


def record_images(monkeypatch, module) -> dict:
    """Record, by file name, the 8-bit sRGB image each ``save_jpg`` call of
    a capture module encodes."""
    seen = {}
    real = module.save_jpg

    def recording(path, img, *a, **kw):
        seen[os.path.basename(path)] = to_uint8_srgb(img).astype(np.int32)
        return real(path, img, *a, **kw)

    monkeypatch.setattr(module, "save_jpg", recording)
    return seen


def assert_images_close(name, got_img, want_img, got_path, want_path):
    share = float((np.abs(got_img - want_img) <= IMG_ATOL).mean())
    got = np.asarray(Image.open(got_path), np.int32)
    want = np.asarray(Image.open(want_path), np.int32)
    jpg_err = int(np.abs(got - want).max())
    print(f"{name}: {share:.4%} of channels within {IMG_ATOL}/255; decoded "
          f"JPGs within {jpg_err}/255")
    assert got_img.shape == want_img.shape and got.shape == want.shape
    assert share >= IMG_MIN_SHARE and jpg_err <= JPG_ATOL, (share, jpg_err)


def assert_captures_match(tdir, jdir, tout, jout, t_imgs, j_imgs, extent):
    """Same files; transforms equal (matrices within MATRIX_ATOL); images
    and PLY rows within the tolerances above."""
    assert file_layout(tdir) == file_layout(jdir)
    assert tout["num_points"] == jout["num_points"]
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        if not os.path.exists(os.path.join(jdir, name)):
            continue
        got = json.load(open(os.path.join(tdir, name)))
        want = json.load(open(os.path.join(jdir, name)))
        assert got["camera_angle_x"] == want["camera_angle_x"]
        assert [f["file_path"] for f in got["frames"]] \
            == [f["file_path"] for f in want["frames"]]
        for a, b in zip(got["frames"], want["frames"]):
            np.testing.assert_allclose(a["transform_matrix"],
                                       b["transform_matrix"], rtol=0,
                                       atol=MATRIX_ATOL)
    assert sorted(t_imgs) == sorted(j_imgs)
    for name in j_imgs:
        assert_images_close(name, t_imgs[name], j_imgs[name],
                            os.path.join(tdir, "train", name),
                            os.path.join(jdir, "train", name))
    ply = os.path.join(jdir, "points3d.ply")
    if os.path.exists(ply):
        head, want = ply_parts(ply)
        t_head, got = ply_parts(os.path.join(tdir, "points3d.ply"))
        assert t_head == head
        assert len(got["positions"]) == len(want["positions"]) \
            == jout["num_points"]
        pos_err = np.abs(got["positions"] - want["positions"]).max()
        nrm_err = np.abs(got["normals"] - want["normals"]).max()
        print(f"PLY: {len(got['positions'])} rows, positions within "
              f"{pos_err:.3e}, normals within {nrm_err:.3e}")
        assert pos_err <= PLY_EXTENT_TOL * extent, pos_err
        assert nrm_err <= PLY_NORMAL_ATOL, nrm_err
        np.testing.assert_allclose(got["colors"] * 255, want["colors"] * 255,
                                   rtol=0, atol=PLY_COLOR_ATOL)


def test_miniature_capture_matches(cube, tmp_path, monkeypatch):
    """tests/test_data_io.py's miniature capture (4 poses, 2 spp, 16x16, 500
    torus rays, depth 1) through both packages."""
    js, ts = cube
    j_imgs = record_images(monkeypatch, jcap)
    t_imgs = record_images(monkeypatch, tcap)
    kw = dict(accumulation_steps=2, total_positions=4, image_divisor=2,
              width=16, height=16, progress=None, chunk=512)
    jout = jcap.capture_scene_data(js, str(tmp_path / "j"),
                                   JRenderSettings(**KW),
                                   torus=JTorusConfig(num_rays=500), **kw)
    tout = tcap.capture_scene_data(ts, str(tmp_path / "t"),
                                   RenderSettings(**KW),
                                   torus=TorusConfig(num_rays=500),
                                   debug_checks=True, **kw)
    assert os.path.exists(tmp_path / "t" / "train" / "r_3.jpg")
    assert len(tout["train_frames"]) == 3 and len(tout["test_frames"]) == 1
    assert Image.open(tmp_path / "t" / "train" / "r_0.jpg").size == (8, 8)
    assert tout["camera_angle_x"] == jout["camera_angle_x"]
    assert tout["num_points"] > 0 and len(t_imgs) == 4
    assert_captures_match(str(tmp_path / "t"), str(tmp_path / "j"), tout,
                          jout, t_imgs, j_imgs, extent=8.0)


def test_importance_capture_matches(cube, tmp_path):
    """tests/test_data_io.py's imp_hit capture: the bootstrap pass, the
    resample from its hit ratio and the point cloud, in both packages; the
    resampled rays land at least as many hits as uniform ones."""
    js, ts = cube
    kw = dict(accumulation_steps=1, total_positions=0, capture_images=False,
              progress=None, chunk=512)
    jout = jcap.capture_scene_data(js, str(tmp_path / "j"),
                                   JRenderSettings(**KW),
                                   torus=JTorusConfig(num_rays=400),
                                   sampling_method="imp_hit", **kw)
    tout = tcap.capture_scene_data(ts, str(tmp_path / "t"),
                                   RenderSettings(**KW),
                                   torus=TorusConfig(num_rays=400),
                                   sampling_method="imp_hit", **kw)
    assert_captures_match(str(tmp_path / "t"), str(tmp_path / "j"), tout,
                          jout, {}, {}, extent=8.0)
    uniform = tcap.capture_scene_data(ts, str(tmp_path / "u"),
                                      RenderSettings(**KW),
                                      torus=TorusConfig(num_rays=400), **kw)
    assert tout["num_points"] >= uniform["num_points"] > 0


def test_panorama_matches(cube, tmp_path, monkeypatch):
    js, ts = cube
    j_imgs = record_images(monkeypatch, jcap)
    t_imgs = record_images(monkeypatch, tcap)
    kw = dict(steps=2, accumulation_steps=2, width=16, height=16, chunk=128,
              progress=None)
    jcap.capture_panorama(js, str(tmp_path / "j"), JRenderSettings(**KW),
                          **kw)
    tcap.capture_panorama(ts, str(tmp_path / "t"), RenderSettings(**KW),
                          **kw)
    assert file_layout(tmp_path / "t") == ["panorama/pano_0.jpg",
                                           "panorama/pano_1.jpg"]
    for name in ("pano_0.jpg", "pano_1.jpg"):
        assert_images_close(name, t_imgs[name], j_imgs[name],
                            str(tmp_path / "t" / "panorama" / name),
                            str(tmp_path / "j" / "panorama" / name))


def test_capture_journal_skips_and_fingerprints(cube, tmp_path, monkeypatch,
                                                caplog):
    """A rerun skips the poses its journal holds; a change the reference's
    fingerprint leaves out (shading, lights) re-captures them."""
    _, ts = cube
    calls = []
    real = tcap.render_pose

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tcap, "render_pose", counted)
    kw = dict(accumulation_steps=1, total_positions=2, width=8, height=8,
              capture_pointcloud=False, progress=None, chunk=64)
    out = str(tmp_path / "ds")
    tcap.capture_scene_data(ts, out, RenderSettings(**KW), **kw)
    assert len(calls) == 2
    tcap.capture_scene_data(ts, out, RenderSettings(**KW), **kw)
    assert len(calls) == 2
    with gspt_log(caplog):
        tcap.capture_scene_data(
            ts, out, RenderSettings(**dict(KW, ambient=(0.2, 0.1, 0.1, 1.0))),
            **kw)
    assert len(calls) == 4 and "different configuration" in caplog.text
    light = make_punctual_lights(position=[[0.0, 8.0, 0.0]], device=CPU)
    tcap.capture_scene_data(
        ts, out, RenderSettings(**dict(KW, ambient=(0.2, 0.1, 0.1, 1.0))),
        punctual=light, **kw)
    assert len(calls) == 6


@pytest.fixture(scope="module")
def cloud():
    """tests/test_utils_cli.py's mid-pose checkpoint scene."""
    js = random_scene(150, np.random.default_rng(3), spread=1.0)
    return js, to_torch_scene(js)


def test_interrupt_and_resume_bit_identical(cloud, tmp_path):
    """tests/test_utils_cli.py's TestMidPoseCheckpoint on the port: a pose
    cut after its first 2-sample segment resumes to the uninterrupted
    image bit for bit, and the state file is removed."""
    _, ts = cloud
    render = tcap.make_tiled_pose_renderer(ts, RenderSettings(max_depth=1),
                                           None, spp=6)
    c2w = toroidal_c2w(30.0, 10.0, 4.0, 0.5, device=CPU)
    ref_img = render(c2w, 16, 16, 45.0)
    state = str(tmp_path / "pose.npz")
    out = render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2,
                 stop_after_segments=1)
    assert out is None and os.path.exists(state)
    assert load_render_state(state, device=CPU)["frames_done"] == 2
    resumed = render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2)
    assert not os.path.exists(state)
    assert torch.equal(resumed, ref_img)
    # Checkpoints every 4 of 6 samples: the same bits again.
    assert torch.equal(render(c2w, 16, 16, 45.0, state_path=state,
                              checkpoint_every=4), ref_img)


def test_resume_from_jax_state(cloud, tmp_path):
    """A .pose_0.npz the JAX package's renderer wrote after 2 of 6 samples
    resumes in the port to the port's uninterrupted image, within the
    tiled route's tolerance (tests/test_torch_pathtrace.py)."""
    js, ts = cloud
    state = str(tmp_path / ".pose_0.npz")
    jrender = jcap.make_tiled_pose_renderer(js, JRenderSettings(max_depth=1),
                                            None, spp=6)
    assert jrender(j_toroidal_c2w(30.0, 10.0, 4.0, 0.5), 16, 16, 45.0,
                   state_path=state, checkpoint_every=2,
                   stop_after_segments=1) is None
    render = tcap.make_tiled_pose_renderer(ts, RenderSettings(max_depth=1),
                                           None, spp=6)
    c2w = toroidal_c2w(30.0, 10.0, 4.0, 0.5, device=CPU)
    want = render(c2w, 16, 16, 45.0)
    got = render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2,
                 fingerprint="any")
    assert not os.path.exists(state)
    assert_image_close(got, want, "resumed from the JAX package's state")


def test_state_with_other_fingerprint_is_discarded(cloud, tmp_path, caplog):
    """A mid-pose state written under another capture fingerprint is not
    loaded: the pose starts over (here from a poisoned buffer that would
    show)."""
    _, ts = cloud
    render = tcap.make_tiled_pose_renderer(ts, RenderSettings(max_depth=1),
                                           None, spp=4)
    c2w = toroidal_c2w(30.0, 10.0, 4.0, 0.5, device=CPU)
    want = render(c2w, 16, 16, 45.0)
    state = str(tmp_path / ".pose_0.npz")

    def poison():
        save_render_state(state, torch.full((256, 3), 100.0), 2,
                          torch.tensor([0, 13]), extra=dict(fingerprint="a"))

    poison()
    with gspt_log(caplog):
        got = render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2,
                     fingerprint="b")
    assert "different configuration" in caplog.text
    assert torch.equal(got, want) and not os.path.exists(state)
    poison()
    loaded = render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2,
                    fingerprint="a")
    assert float(loaded.mean()) > 10.0   # the same fingerprint resumes
    # The renderer's own checkpoints carry the fingerprint.
    render(c2w, 16, 16, 45.0, state_path=state, checkpoint_every=2,
           stop_after_segments=1, fingerprint="c")
    assert load_render_state(state, device=CPU)["extra"] == dict(
        fingerprint="c")


def test_capture_builds_one_grid(cloud, tmp_path, monkeypatch):
    """On the tiled+grid route one GridAccel serves the pose renderer, the
    flat renderer and the point-cloud trace: build_grid_accel runs once a
    capture (the reference builds it three times)."""
    _, ts = cloud
    calls, accels = [], []
    real = tgt.build_grid_accel

    def spy(*a, **kw):
        calls.append(kw)
        accels.append(real(*a, **kw))
        return accels[-1]

    monkeypatch.setattr(tgt, "build_grid_accel", spy)
    lines = []
    out = tcap.capture_scene_data(
        ts, str(tmp_path / "ds"), RenderSettings(max_depth=1),
        torus=TorusConfig(major_radius=4.0, height=0.5, num_rays=256),
        accumulation_steps=1, total_positions=2, width=16, height=16,
        backend="tiled+grid", progress=lines.append, chunk=128)
    assert len(calls) == 1
    assert lines[0] == "capture backend: tiled+grid"
    assert any(ln.startswith("grid-accel truncation") for ln in lines)
    assert any(ln.startswith("marcher truncation") for ln in lines)
    assert out["num_points"] > 0 and len(out["test_frames"]) == 1


@pytest.mark.parametrize("n", [10, tpipe.AUTO_DENSE_LIMIT,
                               tpipe.AUTO_DENSE_LIMIT + 1])
def test_auto_resolves_like_the_reference(n):
    assert tpipe.AUTO_DENSE_LIMIT == jpipe.AUTO_DENSE_LIMIT
    want = "dense" if n <= tpipe.AUTO_DENSE_LIMIT else "tiled+grid"
    assert tcap.resolve_backend("auto", n) == jcap.resolve_backend(
        "auto", n) == want
    assert tcap.resolve_backend("tiled+dense", n) == "tiled+dense"


def test_pose_stream_and_split_match_reference(cube, tmp_path):
    """Nine 4x4 poses without a point cloud: the test split takes poses 0,
    4 and 8, and the cameras equal the JAX package's."""
    js, ts = cube
    kw = dict(accumulation_steps=1, total_positions=9, width=4, height=4,
              capture_pointcloud=False, progress=None)
    tout = tcap.capture_scene_data(ts, str(tmp_path / "t"),
                                   RenderSettings(**KW), **kw)
    jout = jcap.capture_scene_data(js, str(tmp_path / "j"),
                                   JRenderSettings(**KW), **kw)
    assert [f["file_path"] for f in tout["test_frames"]] == [
        "./train/r_0", "./train/r_4", "./train/r_8"]
    for split in ("train_frames", "test_frames"):
        assert len(tout[split]) == len(jout[split])
        for a, b in zip(tout[split], jout[split]):
            assert a["file_path"] == b["file_path"]
            np.testing.assert_allclose(a["transform_matrix"],
                                       np.asarray(b["transform_matrix"]),
                                       rtol=0, atol=MATRIX_ATOL)
