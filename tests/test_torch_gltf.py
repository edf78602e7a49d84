"""The port's glTF loader vs the JAX package (CPU), on the glTF fixtures of
tests/test_gltf.py, test_textures.py, test_skinning.py and
test_materials.py (rebuilt in tests/torch_gltf_fixtures.py): the parse
(world-space vertices, skinning, animation frame 0, materials, lights),
the surfels and every baked material channel, and the scene and lights
load_gltf_scene returns."""
import base64
import json
import struct

import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.data import gltf as jgltf
from pathtracer_gaussiansplatting_tpu.data import textures as jtx
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    PUNCTUAL_FIELDS, SCENE_FIELDS,
)
from pathtracer_gaussiansplatting_tpu_torch.data import gltf as tgltf
from pathtracer_gaussiansplatting_tpu_torch.data import textures as ttx

import torch_gltf_fixtures as fx
from torch_parity import CPU, TORCH_THREADS, np_of

torch.set_num_threads(TORCH_THREADS)

# Surfel means, scales and baked materials are host numpy in both packages:
# bit-equal. Quaternions come from the frames through each package's
# rotmat_to_quat (float32 sqrt and a norm, which XLA and torch may round an
# ulp apart): within QUAT_ATOL, up to sign (q and -q are one rotation).
QUAT_ATOL = 1e-6
# The scene's SH band is (color - 0.5) / SH_C0, taken in float32 by each
# package's make_scene: within SH_ATOL.
SH_ATOL = 1e-6


def glb_of(tmp_path, gltf_path) -> str:
    """The .gltf repacked as a .glb with its buffer as the BIN chunk."""
    doc = json.loads(open(gltf_path).read())
    blob = base64.b64decode(doc["buffers"][0].pop("uri").split(",", 1)[1])
    j = json.dumps(doc).encode()
    j += b" " * ((4 - len(j) % 4) % 4)
    b = blob + b"\x00" * ((4 - len(blob) % 4) % 4)
    path = tmp_path / "quad.glb"
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(j) + 8
                            + len(b)))
        f.write(struct.pack("<II", len(j), 0x4E4F534A) + j)
        f.write(struct.pack("<II", len(b), 0x004E4942) + b)
    return str(path)


def base_color(ext=None):
    info = {"index": 0}
    if ext:
        info["extensions"] = {"KHR_texture_transform": ext}
    return {"pbrMetallicRoughness": {"baseColorTexture": info,
                                     "metallicFactor": 0.0,
                                     "roughnessFactor": 1.0}}


def mr_rgba():
    rgba = np.zeros((4, 4, 4), np.uint8)
    rgba[..., 1] = np.arange(16).reshape(4, 4) * 16   # G = roughness
    rgba[..., 2] = 255 - np.arange(16).reshape(4, 4)  # B = metallic
    rgba[..., 3] = 255
    return rgba


def normal_rgba():
    v = np.uint8(np.round((1 / np.sqrt(2) * 0.5 + 0.5) * 255))
    rgba = np.zeros((4, 4, 4), np.uint8)
    rgba[..., 0] = v
    rgba[..., 1] = 128
    rgba[..., 2] = v
    rgba[..., 3] = 255
    return rgba


def lod_rgba(n=64):
    rgba = np.zeros((n, n, 4), np.uint8)
    rgba[(np.indices((n, n)).sum(0) % 2) == 0, :3] = 255
    rgba[..., 3] = 255
    return rgba


def _skin(tmp_path, joints, weights, anim=None):
    return fx.write(tmp_path, "skin.gltf", fx.skinned_quad(
        joints, np.asarray(weights, np.float32), anim))


SPOT = [{"type": "spot", "color": [1.0, 0.9, 0.8], "intensity": 30.0,
         "range": 5.0, "spot": {"innerConeAngle": 0.2,
                                "outerConeAngle": 0.6}}]

# name -> (make(tmp_path) -> path, load_gltf_scene keywords)
CASES = {
    "quad_light": (lambda p: fx.quad_gltf(p, translation=(5, 0, 0),
                                          emissive=(0.5, 0.2, 0.0)), {}),
    "glb": (lambda p: glb_of(p, fx.quad_gltf(p, with_light=False)), {}),
    "base_color": (lambda p: fx.textured_quad_gltf(
        p, base_color(), [fx.png_data_uri(fx.checker_rgba())]),
        dict(surfels_per_unit_area=400)),
    "metal_rough": (lambda p: fx.textured_quad_gltf(p, {
        "pbrMetallicRoughness": {"metallicRoughnessTexture": {"index": 0},
                                 "metallicFactor": 1.0,
                                 "roughnessFactor": 0.9}},
        [fx.png_data_uri(mr_rgba())]), dict(surfels_per_unit_area=100)),
    "alpha_mask": (lambda p: fx.textured_quad_gltf(p, {
        "alphaMode": "MASK", "alphaCutoff": 0.7,
        "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
        [fx.png_data_uri(fx.checker_rgba())]),
        dict(surfels_per_unit_area=800)),
    "alpha_blend": (lambda p: fx.textured_quad_gltf(p, {
        "alphaMode": "BLEND",
        "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
        [fx.png_data_uri(fx.checker_rgba())]),
        dict(surfels_per_unit_area=100, opacity_logit=5.0)),
    "normal_map": (lambda p: fx.textured_quad_gltf(p, {
        "normalTexture": {"index": 0, "scale": 0.8},
        "pbrMetallicRoughness": {}}, [fx.png_data_uri(normal_rgba())]),
        dict(surfels_per_unit_area=100)),
    "normal_map_tangents": (lambda p: fx.textured_quad_gltf(p, {
        "normalTexture": {"index": 0}, "pbrMetallicRoughness": {}},
        [fx.png_data_uri(normal_rgba())], tangents=True),
        dict(surfels_per_unit_area=100)),
    "transform_emissive_occlusion": (lambda p: fx.textured_quad_gltf(p, {
        **base_color({"offset": [0.5, 0.1], "scale": [2.0, 1.5],
                      "rotation": 0.3}),
        "emissiveFactor": [1.0, 0.5, 0.25],
        "emissiveTexture": {"index": 0},
        "occlusionTexture": {"index": 1, "strength": 0.5}},
        [fx.png_data_uri(fx.checker_rgba()), fx.png_data_uri(mr_rgba())],
        samplers=[{"wrapS": 33648, "wrapT": 33071}]),
        dict(surfels_per_unit_area=300)),
    "lod": (lambda p: fx.textured_quad_gltf(
        p, base_color(), [fx.png_data_uri(lod_rgba())]),
        dict(surfels_per_unit_area=8, use_lod=True, lod_factor=1.0)),
    "spec_gloss": (lambda p: fx.textured_quad_gltf(p, {
        "extensions": {"KHR_materials_pbrSpecularGlossiness": {
            "diffuseFactor": [0.5, 0.2, 0.1, 1.0],
            "specularFactor": [0.5, 0.04, 0.04],
            "glossinessFactor": 0.75,
            "diffuseTexture": {"index": 0},
            "specularGlossinessTexture": {"index": 1}}}},
        [fx.png_data_uri(fx.checker_rgba()), fx.png_data_uri(mr_rgba())]),
        dict(surfels_per_unit_area=100)),
    "clearcoat_transmission": (lambda p: fx.textured_quad_gltf(p, {
        "pbrMetallicRoughness": {},
        "extensions": {
            "KHR_materials_clearcoat": {
                "clearcoatFactor": 0.7, "clearcoatRoughnessFactor": 0.2,
                "clearcoatTexture": {"index": 0},
                "clearcoatRoughnessTexture": {"index": 0}},
            "KHR_materials_transmission": {"transmissionFactor": 0.9},
            "KHR_materials_emissive_strength": {"emissiveStrength": 3.0}},
        "emissiveFactor": [0.2, 0.2, 0.2]},
        [fx.png_data_uri(mr_rgba())]), dict(surfels_per_unit_area=50)),
    "spot_light": (lambda p: fx.textured_quad_gltf(
        p, base_color({"offset": [0.25, 0.0]}),
        [fx.png_data_uri(fx.checker_rgba())], lights=SPOT), {}),
    "skin_single": (lambda p: _skin(p, [(2, 0, 0), (0, 0, 0)],
                                    [[1, 0]] * 4), {}),
    "skin_blend": (lambda p: _skin(p, [(0, 0, 0), (1, 0, 0)],
                                   [[0.5, 0.5]] * 4), {}),
    "skin_animation": (lambda p: _skin(
        p, [(2, 0, 0), (0, 0, 0)], [[1, 0]] * 4,
        anim={1: {"translation": [[0, 0, 5], [0, 0, 9]]},
              2: {"rotation": [[0, 0, 0.38268343, 0.9238795],
                               [0, 0, 0, 1]]}}), {}),
}


def assert_same(got, want, where=""):
    """Recursive exact equality of parse outputs (dicts, lists, arrays,
    scalars)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert np.asarray(got).dtype == np.asarray(want).dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def assert_quats(got, want, where=""):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, where
    err = np.minimum(np.abs(got - want).max(-1),
                     np.abs(got + want).max(-1))
    assert err.max(initial=0.0) <= QUAT_ATOL, (where, err.max())


def parse_both(path):
    jp, tp = jgltf.parse_gltf(path), tgltf.parse_gltf(path)
    assert_same(tp["primitives"], jp["primitives"], "primitives")
    assert_same(tp["lights"], jp["lights"], "lights")
    return jp, tp


@pytest.mark.parametrize("case", list(CASES))
def test_gltf_loader_matches(case, tmp_path):
    make, kw = CASES[case]
    path = make(tmp_path)
    jp, tp = parse_both(path)
    for i, (jprim, tprim) in enumerate(zip(jp["primitives"],
                                           tp["primitives"])):
        args = (jprim["positions"], jprim["indices"], jprim.get("normals"))
        skw = dict(surfels_per_unit_area=kw.get("surfels_per_unit_area",
                                                200.0))
        js = jgltf.surfelize_mesh(*args, **skw)
        ts = tgltf.surfelize_mesh(*args, **skw)
        assert_quats(ts["quats"], js["quats"], f"prim {i} surfels")
        assert_same({k: v for k, v in ts.items() if k != "quats"},
                    {k: v for k, v in js.items() if k != "quats"},
                    f"prim {i} surfels")
        bkw = {k: kw[k] for k in ("use_lod", "lod_factor") if k in kw}
        jb = jgltf.bake_surfel_materials(jprim, js, jp["texture_env"], **bkw)
        tb = tgltf.bake_surfel_materials(tprim, ts, tp["texture_env"], **bkw)
        assert_quats(tb.pop("quats"), jb.pop("quats"), f"prim {i} baked")
        assert_same(tb, jb, f"prim {i} baked")
    jscene, jlights = jgltf.load_gltf_scene(path, **kw)
    tscene, tlights = tgltf.load_gltf_scene(path, device=CPU, **kw)
    for f in SCENE_FIELDS:
        got, want = np_of(getattr(tscene, f)), np_of(getattr(jscene, f))
        assert got.shape == want.shape, f
        if f == "quats":
            assert_quats(got, want, "scene")
        elif f == "sh_coeffs":
            np.testing.assert_allclose(got, want, rtol=0, atol=SH_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tlights is None) == (jlights is None)
    if jlights is not None:
        for f in PUNCTUAL_FIELDS:
            got, want = np_of(getattr(tlights, f)), np_of(getattr(jlights,
                                                                  f))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)


def test_texture_primitives_match(rng):
    """The texture stack's numpy functions, bit for bit: bilinear taps
    under each wrap mode, the mip chain of an odd-sized image, the sRGB
    decode and the texture transform."""
    img = rng.uniform(size=(5, 7, 4)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (512, 2)).astype(np.float32)
    for mode in (33071, 33648, 10497):
        np.testing.assert_array_equal(
            ttx.sample_bilinear(img, uv, mode, mode),
            jtx.sample_bilinear(img, uv, mode, mode))
    for a, b in zip(ttx.build_mips(img), jtx.build_mips(img)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttx.srgb_to_linear(img),
                                  jtx.srgb_to_linear(img))
    tf = {"offset": [0.1, -0.2], "scale": [2.0, 0.5], "rotation": 0.7}
    np.testing.assert_array_equal(ttx.apply_texture_transform(uv, tf),
                                  jtx.apply_texture_transform(uv, tf))


def test_no_geometry_raises(tmp_path):
    doc = {"asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
           "nodes": [{}]}
    path = fx.write(tmp_path, "empty.gltf", doc)
    for load in (jgltf.load_gltf_scene,
                 lambda p: tgltf.load_gltf_scene(p, device=CPU)):
        with pytest.raises(ValueError, match="no geometry"):
            load(path)
