"""The port's command line vs the JAX package's (CPU): each of the six
subcommands run in-process through both ``cli.main``s on the debug-cube
config of tests/test_utils_cli.py, with a small glTF quad and a small 3DGS
checkpoint added, at tests/test_torch_capture.py's gates; and the port's
default device."""
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracer_gaussiansplatting_tpu import cli as jcli
from pathtracer_gaussiansplatting_tpu.data import capture as jcap
from pathtracer_gaussiansplatting_tpu.data import ply as jply
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu_torch import cli as tcli
from pathtracer_gaussiansplatting_tpu_torch.core.types import SCENE_FIELDS
from pathtracer_gaussiansplatting_tpu_torch.data import capture as tcap
from pathtracer_gaussiansplatting_tpu_torch.data import ply as tply

import torch_gltf_fixtures as fx
from test_torch_capture import (
    IMG_ATOL, IMG_MIN_SHARE, assert_captures_match, record_images,
)
from test_torch_points_session import POINTS_MIN_EQUAL
from test_torch_train_dense import LEAF_ATOL_LR, LEAF_RTOL, LOSS_RTOL
from torch_parity import CPU, TORCH_THREADS, np_of

torch.set_num_threads(TORCH_THREADS)

# The printed losses carry 5 decimals: compared within LOSS_RTOL of the
# value plus half a unit of the last printed digit.
PRINTED_LOSS_ATOL = 5e-6
FIT_LR = 5e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_utils_cli.py's config (the emissive debug cube, size 8,
    on the torus axis; 2 poses, 2 spp, 16x16, 300 sensor rays, depth 1),
    plus a 3DGS checkpoint (sigma 0.2-0.5) above the cube and a textured
    glTF quad beside that, turned to face the poses at alpha 0, with the
    sky behind it (the quad's surfels are thin: in front of the emissive
    cube, a path's discrete choices flip on a few % of the pixels at
    16x16, the cutoff flips of ROADMAP section 3)."""
    root = tmp_path_factory.mktemp("cli")
    jply.save_3dgs_ply(str(root / "cloud.ply"), j_random_cloud(
        60, seed=9, spread=1.0, scale_range=(-1.6, -0.7)))
    fx.textured_quad_gltf(root, {"pbrMetallicRoughness": {
        "baseColorTexture": {"index": 0}, "metallicFactor": 0.0}},
        [fx.png_data_uri(fx.checker_rgba())], name="quad.gltf")
    (root / "scene.json").write_text(json.dumps({
        "settings": {
            "ambient_light": [0.1, 0.1, 0.15, 1.0],
            "torus_settings": {"major_radius": 16.0, "height": 8.0,
                               "num_rays": 300},
            "accumulation_steps": 2, "total_positions": 2,
            "width": 16, "height": 16, "max_depth": 1,
        },
        "objects": [
            {"model": "builtin:debug_cube?size=8", "position": [0, 8, 0]},
            {"model": "cloud.ply", "position": [0, 13.5, 0]},
            {"model": "quad.gltf", "position": [6, 13, -1],
             "scale": [2, 2, 2], "rotation": [0, 90, 0]},
        ],
    }))
    return root


def run(capsys, argv, tmp_path):
    """(JAX stdout, port stdout) of argv through both command lines; the
    port's with --device cpu. In argv, {out} becomes a per-package path
    (tmp_path / "j" or "t") and {tag} the package's letter."""
    outs = []
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", CPU])):
        main([a.format(out=str(tmp_path / tag), tag=tag) for a in argv]
             + extra)
        outs.append(capsys.readouterr().out)
    return outs


def png(path) -> np.ndarray:
    return np.asarray(Image.open(path), np.int32)


def assert_png_close(got_path, want_path):
    got, want = png(got_path), png(want_path)
    assert got.shape == want.shape
    share = float((np.abs(got - want) <= IMG_ATOL).mean())
    print(f"{os.path.basename(got_path)}: {share:.4%} of channels within "
          f"{IMG_ATOL}/255")
    assert share >= IMG_MIN_SHARE


def test_render_matches(world, tmp_path, capsys):
    jout, tout = run(capsys, [
        "render", "--scene", str(world / "scene.json"), "--output",
        "{out}.png", "--spp", "2", "--width", "16", "--height", "16",
        "--chunk", "256"], tmp_path)
    assert tout.replace("/t.png", "/j.png") == jout
    assert png(tmp_path / "t.png").shape == (16, 16, 3)
    assert_png_close(tmp_path / "t.png", tmp_path / "j.png")


def test_render_tiled_matches(world, tmp_path, capsys):
    """The tiled route (--backend tiled+grid): the tile pass for the
    primary hit, the grid for the bounce."""
    run(capsys, ["render", "--scene", str(world / "scene.json"),
                 "--output", "{out}.png", "--spp", "2", "--width", "32",
                 "--height", "32", "--backend", "tiled+grid"], tmp_path)
    assert_png_close(tmp_path / "t.png", tmp_path / "j.png")


def test_capture_dataset_matches(world, tmp_path, capsys, monkeypatch):
    j_imgs = record_images(monkeypatch, jcap)
    t_imgs = record_images(monkeypatch, tcap)
    jout, tout = run(capsys, [
        "capture-dataset", "--scene", str(world / "scene.json"),
        "--output", "{out}", "--spp", "2", "--chunk", "256"], tmp_path)
    # the last printed line: the reference's {"points", "train", "test"}
    assert tout.splitlines()[-1] == jout.splitlines()[-1]
    stats = json.loads(tout.splitlines()[-1])
    assert stats["train"] == 1 and stats["test"] == 1 and stats["points"] > 0
    tstats, jstats = (dict(num_points=stats["points"]),) * 2
    assert_captures_match(str(tmp_path / "t"), str(tmp_path / "j"), tstats,
                          jstats, t_imgs, j_imgs, extent=8.0)


def test_panorama_matches(world, tmp_path, capsys, monkeypatch):
    j_imgs = record_images(monkeypatch, jcap)
    t_imgs = record_images(monkeypatch, tcap)
    jout, tout = run(capsys, [
        "panorama", "--scene", str(world / "scene.json"), "--output",
        "{out}", "--steps", "2", "--spp", "2", "--width", "16", "--height",
        "16", "--chunk", "256", "--beta", "10"], tmp_path)
    assert tout == jout
    assert sorted(t_imgs) == sorted(j_imgs) == ["pano_0.jpg", "pano_1.jpg"]
    for name in j_imgs:
        share = float((np.abs(t_imgs[name] - j_imgs[name])
                       <= IMG_ATOL).mean())
        assert share >= IMG_MIN_SHARE, (name, share)


def test_fit_matches(world, tmp_path, capsys):
    """fit: the dense target over the scene, a random start, Adam on every
    leaf; the printed losses and the written checkpoints."""
    jout, tout = run(capsys, [
        "fit", "--scene", str(world / "scene.json"), "--output",
        "{out}.ply", "--steps", "8", "--width", "24", "--height", "24",
        "--init-gaussians", "120", "--lr", str(FIT_LR)], tmp_path)
    pattern = r"loss (\S+) -> (\S+) over 8 steps"
    got = [float(x) for x in re.search(pattern, tout).groups()]
    want = [float(x) for x in re.search(pattern, jout).groups()]
    assert got[1] < got[0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                               atol=PRINTED_LOSS_ATOL)
    assert tout.splitlines()[-1] == f"wrote {tmp_path / 't.ply'}"
    fitted = tply.load_3dgs_ply(str(tmp_path / "t.ply"), device=CPU)
    ref = tply.load_3dgs_ply(str(tmp_path / "j.ply"), device=CPU)
    assert fitted.num_gaussians == 120
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(np_of(getattr(fitted, f)),
                                   np_of(getattr(ref, f)), rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL_LR * FIT_LR, err_msg=f)


@pytest.mark.parametrize("mode", ["world", "torus"])
def test_view_pointcloud_matches(world, tmp_path, capsys, mode):
    """Both command lines view the same captured points3d.ply (the JAX
    package's capture of the config)."""
    jcli.main(["capture-dataset", "--scene", str(world / "scene.json"),
               "--output", str(tmp_path / "ds"), "--spp", "1", "--chunk",
               "256"])
    capsys.readouterr()
    jout, tout = run(capsys, [
        "view-pointcloud", "--scene", str(world / "scene.json"), "--ply",
        str(tmp_path / "ds" / "points3d.ply"), "--output", "{out}.png",
        "--mode", mode, "--width", "48", "--height", "32", "--sampling",
        "uniform"], tmp_path)
    assert tout.replace("/t.png", "/j.png") == jout
    got, want = png(tmp_path / "t.png"), png(tmp_path / "j.png")
    assert got.shape == want.shape == (32, 48, 3) and got.sum() > 0
    assert float((got == want).all(-1).mean()) >= POINTS_MIN_EQUAL


def test_interact_matches(world, tmp_path, capsys):
    """A command file through both sessions: moves, looks, steps, a torus
    resize, the point-cloud view (65536 sensor rays: the session's torus
    is the default one), the toroidal camera and saves."""
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("step 2\nsave {out}_a.png\nw\nlook 5 2\nstep 2\nz\n"
                    "step 1\np\nstep 1\np\nc\nstep 2\nsave {out}_b.png\n"
                    "quit\nstep 5\n")
    for tag in "jt":
        (tmp_path / f"cmds_{tag}.txt").write_text(
            cmds.read_text().format(out=str(tmp_path / tag)))
    jout, tout = run(capsys, [
        "interact", "--scene", str(world / "scene.json"), "--commands",
        str(tmp_path / "cmds_{tag}.txt"), "--width", "24", "--height", "16", "--output", "{out}_c.png"],
        tmp_path)
    assert tout.replace(str(tmp_path / "t"), "X") \
        == jout.replace(str(tmp_path / "j"), "X")
    assert "frame 2 mode=camera cam=free" in tout
    assert "frame 1 mode=pointcloud cam=free" in tout
    assert "frame 2 mode=camera cam=toroidal" in tout
    for name in ("a", "b", "c"):
        assert_png_close(tmp_path / f"t_{name}.png",
                         tmp_path / f"j_{name}.png")


def test_default_device_is_the_card(world, tmp_path):
    """Without --device the port runs on the CUDA card, and where there is
    none it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["render", "--scene", str(world / "scene.json"),
                   "--output", str(tmp_path / "x.png"), "--spp", "1"])
    assert not (tmp_path / "x.png").exists()
