"""glTF files written in code for the port's loader tests: the fixtures of
tests/test_gltf.py, test_textures.py, test_skinning.py and
test_materials.py, rebuilt here, and a textured quad with a spot light."""
import base64
import io
import json
import os

import numpy as np


def b64(blob: bytes, mime: str = "application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(blob).decode()


def png_data_uri(rgba: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgba.astype(np.uint8), "RGBA").save(buf, format="PNG")
    return b64(buf.getvalue(), "image/png")


def write(tmp_path, name: str, doc: dict) -> str:
    path = os.path.join(str(tmp_path), name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def quad_gltf(tmp_path, translation=(0, 0, 0), with_light=True,
              emissive=(0, 0, 0), material=None, name="quad.gltf"):
    """tests/test_gltf.py's unit XY quad (2 triangles, no normals or UVs)
    with a red material (or ``material``) and a point light on a child
    node 2 above it."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                         np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    pos_bytes = positions.tobytes()
    blob = pos_bytes + indices.tobytes() + b"\x00\x00"
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"mesh": 0, "translation": list(translation),
             "children": [1] if with_light else []},
        ] + ([{"extensions": {"KHR_lights_punctual": {"light": 0}},
               "translation": [0, 2, 0]}] if with_light else []),
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
        "materials": [material or {
            "pbrMetallicRoughness": {"baseColorFactor": [1, 0, 0, 1],
                                     "metallicFactor": 0.25,
                                     "roughnessFactor": 0.5},
            "emissiveFactor": list(emissive)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)},
            {"buffer": 0, "byteOffset": len(pos_bytes), "byteLength": 12},
        ],
        "buffers": [{"uri": b64(blob), "byteLength": len(blob)}],
    }
    if with_light:
        doc["extensions"] = {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 1, 0.9], "intensity": 20.0}]}}
    return write(tmp_path, name, doc)


def textured_quad_gltf(tmp_path, material: dict, images: list,
                       samplers=None, uv=((0, 0), (1, 0), (1, 1), (0, 1)),
                       tangents=False, lights=None, name="tquad.gltf"):
    """tests/test_textures.py's unit XY quad with normals, UVs (and, with
    ``tangents``, a TANGENT attribute) and the given material and images;
    ``lights`` (KHR_lights_punctual dicts) hang on a second root node 1
    above the quad, turned to shine along -y."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.asarray(uv, np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    tan = np.tile(np.array([[1, 0, 0, -1]], np.float32), (4, 1))
    blob = pos.tobytes() + nrm.tobytes() + uvs.tobytes() + idx.tobytes()
    attrs = {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 48},
        {"buffer": 0, "byteOffset": 48, "byteLength": 48},
        {"buffer": 0, "byteOffset": 96, "byteLength": 32},
        {"buffer": 0, "byteOffset": 128, "byteLength": 24},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
        {"bufferView": 3, "componentType": 5125, "count": 6,
         "type": "SCALAR"},
    ]
    if tangents:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": 64})
        accessors.append({"bufferView": 4, "componentType": 5126,
                          "count": 4, "type": "VEC4"})
        attrs["TANGENT"] = 4
        blob += tan.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0] + ([1] if lights else [])}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": attrs, "indices": 3, "material": 0}]}],
        "materials": [material],
        "textures": [{"source": i, "sampler": 0} for i in range(len(images))],
        "samplers": samplers or [{"wrapS": 10497, "wrapT": 10497}],
        "images": [{"uri": u} for u in images],
        "buffers": [{"uri": b64(blob), "byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    if lights:
        s = float(np.sqrt(0.5))
        doc["nodes"].append({
            "translation": [0.5, 1.0, 0.5], "rotation": [-s, 0.0, 0.0, s],
            "extensions": {"KHR_lights_punctual": {"light": 0}}})
        doc["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
    return write(tmp_path, name, doc)


def checker_rgba(n: int = 8) -> np.ndarray:
    """An n x n RGBA texture: left half red, right half blue, a green
    diagonal, alpha from 128 to 255 along v."""
    rgba = np.zeros((n, n, 4), np.uint8)
    rgba[:, : n // 2] = [255, 0, 0, 255]
    rgba[:, n // 2:] = [0, 0, 255, 255]
    rgba[np.arange(n), np.arange(n), 1] = 255
    rgba[..., 3] = np.linspace(128, 255, n).astype(np.uint8)[:, None]
    return rgba


def skinned_quad(joint_translations, weights_rows, anim=None):
    """tests/test_skinning.py's unit quad skinned to two joints; ``anim``
    node -> {path: values} becomes a two-keyframe animation."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    joints = np.zeros((4, 4), np.uint8)
    joints[:, 1] = 1
    w4 = np.zeros((4, 4), np.float32)
    w4[:, :2] = weights_rows
    ibm = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    blob = pos.tobytes() + joints.tobytes() + w4.tobytes() + idx.tobytes() \
        + ibm.transpose(0, 2, 1).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [
            {"mesh": 0, "skin": 0},
            {"translation": list(map(float, joint_translations[0]))},
            {"translation": list(map(float, joint_translations[1]))},
        ],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": 4}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "JOINTS_0": 1, "WEIGHTS_0": 2},
            "indices": 3}]}],
        "buffers": [{"uri": b64(blob), "byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 16},
            {"buffer": 0, "byteOffset": 64, "byteLength": 64},
            {"buffer": 0, "byteOffset": 128, "byteLength": 24},
            {"buffer": 0, "byteOffset": 152, "byteLength": 128},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 4,
             "type": "VEC4"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC4"},
            {"bufferView": 3, "componentType": 5125, "count": 6,
             "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5126, "count": 2,
             "type": "MAT4"},
        ],
    }
    if anim:
        ablob = np.array([0.0, 1.0], np.float32).tobytes()
        doc["bufferViews"].append({"buffer": 1, "byteOffset": 0,
                                   "byteLength": 8})
        doc["accessors"].append({"bufferView": 5, "componentType": 5126,
                                 "count": 2, "type": "SCALAR"})
        channels, samplers = [], []
        for node, paths in anim.items():
            for path_, vals in paths.items():
                vals = np.asarray(vals, np.float32)
                doc["bufferViews"].append({
                    "buffer": 1, "byteOffset": len(ablob),
                    "byteLength": vals.nbytes})
                ablob += vals.tobytes()
                doc["accessors"].append({
                    "bufferView": len(doc["bufferViews"]) - 1,
                    "componentType": 5126, "count": len(vals),
                    "type": "VEC4" if path_ == "rotation" else "VEC3"})
                samplers.append({"input": 5,
                                 "output": len(doc["accessors"]) - 1,
                                 "interpolation": "LINEAR"})
                channels.append({"sampler": len(samplers) - 1,
                                 "target": {"node": node, "path": path_}})
        doc["buffers"].append({"uri": b64(ablob), "byteLength": len(ablob)})
        doc["animations"] = [{"channels": channels, "samplers": samplers}]
    return doc
