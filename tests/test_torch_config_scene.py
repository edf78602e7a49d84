"""The port's scene loaders vs the JAX package (CPU): the scene config and
rtbox files, transform_scene, rtbox_scene, load_scene_from_config on a
config that mixes a builtin scene, a 3DGS checkpoint, a glTF file, an
rtbox and a sun, the 3DGS checkpoint reader and writer, and the free and
orthographic cameras."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core import camera as jcam
from pathtracer_gaussiansplatting_tpu.data import ply as jply
from pathtracer_gaussiansplatting_tpu.models import scene as jscene
from pathtracer_gaussiansplatting_tpu.ops.quaternions import (
    quat_to_rotmat as j_quat_to_rotmat,
)
from pathtracer_gaussiansplatting_tpu.utils import config as jconfig
from pathtracer_gaussiansplatting_tpu_torch.core import camera as tcam
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    PUNCTUAL_FIELDS, SCENE_FIELDS,
)
from pathtracer_gaussiansplatting_tpu_torch.data import ply as tply
from pathtracer_gaussiansplatting_tpu_torch.models import scene as tscene
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import (
    quat_to_rotmat,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import config as tconfig

import torch_gltf_fixtures as fx
from torch_parity import CPU, TORCH_THREADS, np_of, to_torch_scene

torch.set_num_threads(TORCH_THREADS)

# Transformed scenes: the same float32 products and sums, which XLA and
# torch may round (or fuse) an ulp apart at |x| <= ~4: means, log-scales and
# the other fields within SCENE_ATOL + SCENE_RTOL |x| (a few ulps; an
# anisotropic scale of 4 carries the frames' ulp into the log-scales).
SCENE_ATOL = SCENE_RTOL = 1e-6
# Rotations. Both packages take the new quaternion with the reference's
# branch-free Shepperd formula (ops/quaternions.py:69-75 of the JAX
# package): a component near 0 is the square root of a difference of
# near-equal float32 sums, so it carries an absolute error up to ~sqrt(eps)
# and its copysign may flip. An ulp of difference in the input frames then
# moves a rotation entry by up to ~1e-3 (ROADMAP section 3): the JAX
# package's own result lies up to 8.2e-4 off the float64 transform on 200k
# random Gaussians. So transform_scene is held to the float64 transform:
# the port's rotation matrices no further from it than ROT_VS_REF x the
# JAX package's largest miss plus SCENE_ATOL. Where the float64 transform is
# not at hand (whole configs), the two packages' rotation matrices agree
# within ROT_ATOL.
ROT_VS_REF = 1.5
ROT_ATOL = 2e-3


def exact_rotations(quats, rot_deg) -> np.ndarray:
    """(N, 3, 3) float64 rotation matrices of R(rot_deg) times the
    quaternions' (the transform taken exactly from the float32 inputs)."""
    from scipy.spatial.transform import Rotation

    q = np.asarray(quats, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    frames = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    r = Rotation.from_euler("xyz", rot_deg, degrees=True).as_matrix()
    return r.astype(np.float32).astype(np.float64) @ frames


CONFIG = {
    "settings": {
        "use_rt_box": True, "rt_box_file": "rtbox.json",
        "render_torus": True, "render_pointcloud": True,
        "ambient_light": [0.1, 0.2, 0.3, 1.0],
        "torus_settings": {"major_radius": 1.2, "minor_radius": 0.4,
                           "height": 0.2, "major_segments": 64,
                           "num_rays": 4096},
        "sun": {"color": [1.0, 0.9, 0.8], "direction": [0.2, -1.0, 0.1],
                "intensity": 2.5},
        "use_lod": True, "lod_factor": 0.5,
        "accumulation_steps": 8, "total_positions": 5, "min_beta": -30,
        "max_beta": 20, "image_divisor": 4, "capture_images": False,
        "capture_pointcloud": True, "width": 96, "height": 64, "fov": 50,
        "max_depth": 3, "sampling_method": "halton", "backend": "dense",
    },
    "objects": [
        {"model": "builtin:random_cloud?n=300&seed=5&sh_degree=1",
         "position": [0.2, -0.1, 0.3], "scale": 0.5,
         "rotation": [10, 20, 30]},
        {"model": "cloud.ply", "position": [-0.5, 0.0, 0.0],
         "scale": [1.0, 2.0, 0.5], "rotation": [0, 45, 0]},
        {"model": "quad.gltf", "position": [0.0, 1.0, 0.0],
         "rotation": [90, 0, 0]},
        {"model": "builtin:debug_cube?size=0.5"},
    ],
}
RTBOX = {
    "position": [0.0, 0.5, 0.0], "dimensions": [4.0, 3.0, 4.0],
    "panels": {
        "floor": {"material": {"base_color": [0.8, 0.8, 0.8],
                               "roughness": 0.7}},
        "ceiling": {"material": {"base_color": [1.0, 1.0, 0.9]},
                    "light": {"intensity": 12.0}},
        "left_wall": {"material": {"base_color": [0.8, 0.1, 0.1],
                                   "metallic": 0.2}},
        "no_such_panel": {"material": {}},
    },
}


def write_world(tmp_path):
    """The config above, its rtbox, the 3DGS checkpoint (written by the
    JAX package) and the glTF quad, in tmp_path; returns the config path
    behind a main_scene.json indirection."""
    (tmp_path / "scene.json").write_text(json.dumps(CONFIG))
    (tmp_path / "rtbox.json").write_text(json.dumps(RTBOX))
    (tmp_path / "main_scene.json").write_text(
        json.dumps({"scene": "scene.json"}))
    jply.save_3dgs_ply(str(tmp_path / "cloud.ply"), jscene.random_cloud(
        400, seed=3, spread=0.5, sh_degree=2))
    fx.quad_gltf(tmp_path)
    return str(tmp_path / "main_scene.json")


def as_dict(cfg) -> dict:
    """A config dataclass as plain values (the two packages' TorusConfig
    types differ)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def rotations(scene) -> np.ndarray:
    if isinstance(scene.quats, torch.Tensor):
        return np_of(quat_to_rotmat(scene.quats)).astype(np.float64)
    return np.asarray(j_quat_to_rotmat(scene.quats), np.float64)


def assert_scene_close(got, want, rot_atol=ROT_ATOL):
    for f in SCENE_FIELDS:
        g, w = np_of(getattr(got, f)), np_of(getattr(want, f))
        assert g.shape == w.shape, f
        if f == "quats":
            np.testing.assert_allclose(rotations(got), rotations(want),
                                       rtol=0, atol=rot_atol, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=SCENE_RTOL,
                                       atol=SCENE_ATOL, err_msg=f)


def assert_lights_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in PUNCTUAL_FIELDS:
        g, w = np_of(getattr(got, f)), np_of(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_scene_config_fields_equal(tmp_path):
    path = write_world(tmp_path)
    got, want = tconfig.load_scene_config(path), jconfig.load_scene_config(
        path)
    assert as_dict(got) == as_dict(want)
    assert got.torus.num_rays == 4096 and got.sun.intensity == 2.5
    assert got.objects[0].scale == (0.5, 0.5, 0.5)
    assert tconfig.load_rtbox_config(str(tmp_path / "rtbox.json")) \
        == jconfig.load_rtbox_config(str(tmp_path / "rtbox.json"))


def test_scene_config_defaults_equal(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"settings": {}, "objects": []}))
    assert as_dict(tconfig.load_scene_config(str(path))) \
        == as_dict(jconfig.load_scene_config(str(path)))
    assert as_dict(tconfig.SceneConfig()) == as_dict(jconfig.SceneConfig())
    (tmp_path / "box.json").write_text("{}")
    assert tconfig.load_rtbox_config(str(tmp_path / "box.json")) \
        == jconfig.load_rtbox_config(str(tmp_path / "box.json"))


TRANSFORMS = [
    ((0, 0, 0), (1, 1, 1), (0, 0, 0)),
    ((0.5, -1.0, 2.0), (1, 1, 1), (0, 90, 0)),
    ((0.0, 0.0, 0.0), (2.0, 2.0, 2.0), (30, 45, 60)),
    ((1.0, 0.5, -0.5), (1.0, 3.0, 0.5), (-20, 10, 170)),
    ((0.1, 0.2, 0.3), (0.25, 0.25, 4.0), (90, 90, 90)),
]


@pytest.mark.parametrize("pos,scale,rot", TRANSFORMS,
                         ids=[f"t{i}" for i in range(len(TRANSFORMS))])
def test_transform_scene_matches(pos, scale, rot):
    js = jscene.random_cloud(500, seed=11, spread=1.5, sh_degree=1)
    got = tscene.transform_scene(to_torch_scene(js), pos, scale, rot)
    want = jscene.transform_scene(js, pos, scale, rot)
    assert_scene_close(got, want)
    if len(set(scale)) == 1:   # a uniform scale keeps the rotation exact
        exact = exact_rotations(js.quats, rot)
        ref_miss = np.abs(rotations(want) - exact).max()
        port_miss = np.abs(rotations(got) - exact).max()
        print(f"rotation vs float64: JAX package {ref_miss:.3e}, port "
              f"{port_miss:.3e}")
        assert port_miss <= ROT_VS_REF * ref_miss + SCENE_ATOL


def test_rtbox_scene_matches(tmp_path):
    (tmp_path / "rtbox.json").write_text(json.dumps(RTBOX))
    box = jconfig.load_rtbox_config(str(tmp_path / "rtbox.json"))
    for res in (24, 5):
        got = tscene.rtbox_scene(box, res=res, device=CPU)
        assert got.num_gaussians == 3 * res * res
        assert_scene_close(got, jscene.rtbox_scene(box, res=res))


def test_load_scene_from_config_matches(tmp_path):
    """A builtin cloud, a JAX-written 3DGS checkpoint, a glTF quad with a
    point light and a debug cube, each transformed, plus an rtbox with an
    emissive panel and a sun: the scene within SCENE_ATOL, the lights (the
    glTF's point light, then the sun) exactly."""
    path = write_world(tmp_path)
    base = str(tmp_path)
    want, wlights = jscene.load_scene_from_config(
        jconfig.load_scene_config(path), base)
    got, glights = tscene.load_scene_from_config(
        tconfig.load_scene_config(path), base, device=CPU)
    assert got.means.device.type == "cpu"
    assert_scene_close(got, want)
    assert_lights_equal(glights, wlights)
    assert glights.num_lights == 2
    assert np_of(glights.light_type).tolist() == [0, 1]


def test_load_scene_from_config_errors(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"objects": [{"model": "builtin:teapot"}]}))
    with pytest.raises(ValueError, match="unknown builtin scene 'teapot'"):
        tscene.load_scene_from_config(tconfig.load_scene_config(str(path)),
                                      device=CPU)
    path.write_text(json.dumps({"objects": []}))
    with pytest.raises(ValueError, match="no objects"):
        tscene.load_scene_from_config(tconfig.load_scene_config(str(path)),
                                      device=CPU)


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_3dgs_ply_files_byte_equal(tmp_path, sh_degree):
    """The port's writer gives the JAX package's bytes for the same scene,
    and a JAX-written file loads bit-equal (every field, the defaults of
    the fields the format lacks included), also with fewer SH bands."""
    js = jscene.random_cloud(257, seed=sh_degree, spread=2.0,
                             sh_degree=sh_degree, emissive_frac=0.1)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_3dgs_ply(jpath, js)
    tply.save_3dgs_ply(tpath, to_torch_scene(js))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for max_deg in (None, 0, 1):
        want = jply.load_3dgs_ply(jpath, max_sh_degree=max_deg)
        got = tply.load_3dgs_ply(jpath, max_sh_degree=max_deg, device=CPU)
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(np_of(getattr(got, f)),
                                          np_of(getattr(want, f)),
                                          err_msg=f)


def test_3dgs_ply_ascii_loads_equal(tmp_path):
    """An ascii 3DGS file (the reader's other branch)."""
    rng = np.random.default_rng(4)
    names = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "f_rest_0",
             "f_rest_1", "f_rest_2", "opacity", "scale_0", "scale_1",
             "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    rows = rng.normal(size=(6, len(names))).astype(np.float32)
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 6\n"
                    + "".join(f"property float {n}\n" for n in names)
                    + "end_header\n"
                    + "".join(" ".join(f"{v:.7g}" for v in r) + "\n"
                              for r in rows))
    want = jply.load_3dgs_ply(str(path))
    got = tply.load_3dgs_ply(str(path), device=CPU)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(got, f)),
                                      np_of(getattr(want, f)), err_msg=f)


def test_free_camera_matches():
    """A sequence of moves, looks, speed and fov changes and a reset: the
    same pose, and the same c2w within an ulp or two, in both packages."""
    j, t = jcam.FreeCamera(), tcam.FreeCamera()
    ops = [("move", (0.1,), dict(forward=1)), ("rotate", (30.0, -12.0), {}),
           ("move", (0.2,), dict(strafe=-1, ascend=1)),
           ("adjust_speed", (1.7,), {}), ("adjust_fov", (-20.0,), {}),
           ("rotate", (900.0, 2000.0), {}), ("move", (0.05,),
                                             dict(forward=-1))]
    for name, args, kw in ops:
        getattr(j, name)(*args, **kw)
        getattr(t, name)(*args, **kw)
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.yaw_deg, t.pitch_deg, t.speed, t.fov_y_deg) \
            == (j.yaw_deg, j.pitch_deg, j.speed, j.fov_y_deg)
        np.testing.assert_allclose(
            np_of(t.camera(32, 24, device=CPU).c2w),
            np.asarray(j.camera(32, 24).c2w), rtol=0, atol=SCENE_ATOL)
    t.reset()
    j.reset()
    np.testing.assert_array_equal(t.position, j.position)
    assert t.pitch_deg == j.pitch_deg == 0.0


def test_orthographic_rays_match():
    args = ((0.1, 0.2, 3.0), (0.1, -0.2, -1.0), (0.0, 1.0, 0.0), 1.5, 24,
            16)
    got = tcam.orthographic_rays(*args, device=CPU)
    want = jcam.orthographic_rays(*args)
    np.testing.assert_allclose(np_of(got.origins), np.asarray(want.origins),
                               rtol=0, atol=SCENE_ATOL)
    np.testing.assert_allclose(np_of(got.directions),
                               np.asarray(want.directions), rtol=0,
                               atol=SCENE_ATOL)


def test_3dgs_ply_loads_on_the_card_by_default(tmp_path):
    """Without a device the reader builds on the CUDA card; where there is
    none it raises instead of loading onto the CPU."""
    path = str(tmp_path / "c.ply")
    jply.save_3dgs_ply(path, jscene.random_cloud(8, seed=1))
    if torch.cuda.is_available():
        assert tply.load_3dgs_ply(path).means.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tply.load_3dgs_ply(path)
