"""glTF 2.0 ingest: parse triangle meshes and surfelize them into Gaussians.

The port's copy of ``pathtracer_gaussiansplatting_tpu/data/gltf.py``
(``parse_gltf``, skinning and animation frame 0, ``surfelize_mesh``,
``bake_surfel_materials``, ``load_gltf_scene``): .gltf/.glb parsing,
node-hierarchy world transforms, pbrMetallicRoughness materials, emissive
factors and KHR_lights_punctual. Each mesh surface becomes flat Gaussian
surfels (area-weighted barycentric sampling from ``default_rng(seed)``, one
surfel per sample, flattened along the face normal).

Every material texture channel is baked at surfelization
(``data/textures.py``): sampled bilinearly at each surfel's interpolated UV
with KHR_texture_transform, sRGB or UNORM per channel, alphaMode MASK and
BLEND gating the surfel's opacity, and an optional mip level from the
surfel's footprint. Skinning and animation frame 0 are applied to the
vertices before surfelization; specular-glossiness converts to
metallic-roughness at bake time; clearcoat and transmission become the
scene's per-surfel fields.

All of it is host numpy, as in the JAX package, so surfel means, scales
and baked materials are the JAX package's bits; the frames become
quaternions through the port's ``ops/quaternions.rotmat_to_quat``, and
``load_gltf_scene`` returns the port's GaussianScene and PunctualLights on
the requested device.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    make_punctual_lights, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.data.textures import (
    TextureSampler, apply_texture_transform,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import (
    rotmat_to_quat,
)

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _frames_to_quats(frames: np.ndarray) -> np.ndarray:
    """(S, 4) float32 quaternions of (S, 3, 3) frames (columns the axes),
    taken in float32 as the JAX package takes them."""
    return rotmat_to_quat(torch.from_numpy(
        np.ascontiguousarray(frames, np.float32))).numpy()


def _load_glb(path: str) -> Tuple[dict, bytes]:
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67, "not a GLB file"
        json_len, json_type = struct.unpack("<II", f.read(8))
        assert json_type == 0x4E4F534A
        gltf = json.loads(f.read(json_len))
        binary = b""
        header = f.read(8)
        if len(header) == 8:
            bin_len, bin_type = struct.unpack("<II", header)
            assert bin_type == 0x004E4942
            binary = f.read(bin_len)
    return gltf, binary


def _load_buffers(gltf: dict, base_dir: str, glb_bin: bytes) -> List[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    data = buffers[view["buffer"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
    itemsize = ncomp * np.dtype(dtype).itemsize
    if stride == itemsize:
        arr = np.frombuffer(data, dtype, count * ncomp, offset)
        return arr.reshape(count, ncomp).copy()
    rows = np.empty((count, ncomp), dtype)
    for i in range(count):
        rows[i] = np.frombuffer(data, dtype, ncomp, offset + i * stride)
    return rows


def _node_matrix(node: dict, override: Optional[dict] = None) -> np.ndarray:
    """Node-local transform; ``override`` replaces TRS components with
    animation frame-0 values (the reference bakes frame 0,
    gameobject.cpp:64-159; glTF forbids animating 'matrix' nodes)."""
    override = override or {}
    if "matrix" in node and not override:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    scale = override.get("scale", node.get("scale"))
    if scale is not None:
        m[:3, :3] = np.diag(scale)
    rotation = override.get("rotation", node.get("rotation"))
    if rotation is not None:  # xyzw in glTF
        x, y, z, w = rotation
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    translation = override.get("translation", node.get("translation"))
    if translation is not None:
        m[:3, 3] = translation
    return m


def _animation_frame0(gltf: dict, buffers: List[bytes]) -> Dict[int, dict]:
    """Per-node TRS overrides from the first keyframe of every animation
    channel (Gameobject bakes animation frame 0 into world transforms,
    gameobject.cpp:64-159)."""
    overrides: Dict[int, dict] = {}
    for anim in gltf.get("animations", []):
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            node, path_ = tgt.get("node"), tgt.get("path")
            if node is None or path_ not in ("translation", "rotation",
                                             "scale"):
                continue
            sampler = anim["samplers"][ch["sampler"]]
            vals = _read_accessor(gltf, buffers, sampler["output"])
            if sampler.get("interpolation") == "CUBICSPLINE":
                vals = vals[1::3]  # keyframe values between tangent pairs
            overrides.setdefault(node, {})[path_] =                 vals[0].astype(np.float64)
    return overrides


def _global_node_transforms(gltf: dict, buffers: List[bytes]
                            ) -> List[np.ndarray]:
    """World transform of EVERY node (joints included), with animation
    frame-0 overrides applied (computeGlobalNodeTransforms analog)."""
    nodes = gltf.get("nodes", [])
    overrides = _animation_frame0(gltf, buffers)
    parent = [-1] * len(nodes)
    for i, node in enumerate(nodes):
        for c in node.get("children", []):
            parent[c] = i
    globals_ = [None] * len(nodes)

    def compute(i):
        if globals_[i] is not None:
            return globals_[i]
        local = _node_matrix(nodes[i], overrides.get(i))
        if parent[i] >= 0:
            globals_[i] = compute(parent[i]) @ local
        else:
            globals_[i] = local
        return globals_[i]

    for i in range(len(nodes)):
        compute(i)
    return globals_


def _skin_vertices(gltf: dict, buffers: List[bytes], prim: dict,
                   skin_index: int, globals_: List[np.ndarray],
                   pos: np.ndarray, nrm: Optional[np.ndarray]):
    """Linear-blend skinning baked to world space (gameobject.cpp:562-795):
    world_v = sum_j w_j (G_joint_j @ IBM_j) @ v_mesh. Returns (pos, nrm)."""
    skin = gltf["skins"][skin_index]
    joints = skin["joints"]
    if "inverseBindMatrices" in skin:
        ibm = _read_accessor(gltf, buffers, skin["inverseBindMatrices"])
        ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1).astype(np.float64)
    else:
        ibm = np.tile(np.eye(4), (len(joints), 1, 1))
    jmats = np.stack([globals_[j] for j in joints]) @ ibm   # (J,4,4)
    jidx = _read_accessor(gltf, buffers,
                          prim["attributes"]["JOINTS_0"]).astype(np.int64)
    wacc = gltf["accessors"][prim["attributes"]["WEIGHTS_0"]]
    wts = _read_accessor(gltf, buffers, prim["attributes"]["WEIGHTS_0"])
    if wacc["componentType"] == 5121:
        wts = wts / 255.0
    elif wacc["componentType"] == 5123:
        wts = wts / 65535.0
    wts = wts / np.maximum(wts.sum(-1, keepdims=True), 1e-12)
    blended = np.einsum("vj,vjab->vab", wts, jmats[jidx])   # (V,4,4)
    pos_w = np.einsum("vab,vb->va", blended[:, :3, :3], pos)         + blended[:, :3, 3]
    nrm_w = None
    if nrm is not None:
        # normals via inverse-transpose of each vertex's blended linear part
        inv_t = np.linalg.inv(blended[:, :3, :3]).transpose(0, 2, 1)
        nrm_w = np.einsum("vab,vb->va", inv_t, nrm)
    return pos_w, nrm_w


def parse_gltf(path: str) -> dict:
    """Parse a .gltf/.glb into world-space primitives + lights.

    Returns dict:
      primitives: [{positions (V,3), normals (V,3)|None, indices (F,3),
                    base_color (4,), metallic, roughness, emissive (3,)}]
      lights: [{type, color, intensity, position, direction, range,
                inner_cone_cos, outer_cone_cos}]  (KHR_lights_punctual)
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        gltf, glb_bin = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_bin = b""
    buffers = _load_buffers(gltf, base_dir, glb_bin)

    materials = gltf.get("materials", [])
    khr_lights = gltf.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])
    primitives = []
    lights = []

    def tex_ref(owner, key, srgb):
        """Texture reference dict from a textureInfo field (index, UV set,
        KHR_texture_transform, scale/strength), or None."""
        info = owner.get(key)
        if info is None:
            return None
        return dict(
            index=info["index"], texcoord=info.get("texCoord", 0),
            transform=info.get("extensions", {}).get(
                "KHR_texture_transform"),
            scale=float(info.get("scale", 1.0)),        # normalTexture
            strength=float(info.get("strength", 1.0)),  # occlusionTexture
            srgb=srgb)

    def material_of(prim):
        mi = prim.get("material")
        mat = materials[mi] if mi is not None else {}
        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        base = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        metallic = float(pbr.get("metallicFactor", 1.0))
        roughness = float(pbr.get("roughnessFactor", 1.0))
        textures = dict(
            base_color=tex_ref(pbr, "baseColorTexture", True),
            metallic_roughness=tex_ref(pbr, "metallicRoughnessTexture",
                                       False),
            normal=tex_ref(mat, "normalTexture", False),
            occlusion=tex_ref(mat, "occlusionTexture", False),
            emissive=tex_ref(mat, "emissiveTexture", True),
        )

        # KHR_materials_pbrSpecularGlossiness (the reference shades this
        # workflow natively, closesthit.rchit:396-410: F0=specularFactor,
        # roughness=sqrt(1-glossiness), metallic=0; per-Gaussian SoA carries
        # scalar metal-rough channels, so we apply the standard SG->MR
        # conversion: metallic from specular brightness, diffuse as albedo).
        sg = ext.get("KHR_materials_pbrSpecularGlossiness")
        sg_info = None
        if sg is not None:
            textures["sg_diffuse"] = tex_ref(sg, "diffuseTexture", True)
            textures["sg_spec_gloss"] = tex_ref(
                sg, "specularGlossinessTexture", True)
            sg_info = dict(
                diffuse=np.asarray(sg.get("diffuseFactor", [1, 1, 1, 1]),
                                   np.float32),
                specular=np.asarray(sg.get("specularFactor", [1, 1, 1]),
                                    np.float32),
                glossiness=float(sg.get("glossinessFactor", 1.0)))
        if sg is not None:
            diffuse = np.asarray(sg.get("diffuseFactor", [1, 1, 1, 1]),
                                 np.float32)
            spec = np.asarray(sg.get("specularFactor", [1, 1, 1]), np.float32)
            gloss = float(sg.get("glossinessFactor", 1.0))
            metallic = float(np.clip((spec.max() - 0.04) / (1.0 - 0.04),
                                     0.0, 1.0))
            base = np.append(
                diffuse[:3] * (1.0 - metallic)
                + spec * metallic, diffuse[3]).astype(np.float32)
            roughness = float(np.sqrt(max(1.0 - gloss, 0.04)))

        emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = ext.get(
            "KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        cc = ext.get("KHR_materials_clearcoat", {})
        tr = ext.get("KHR_materials_transmission", {})
        textures["clearcoat"] = tex_ref(cc, "clearcoatTexture", False)
        textures["clearcoat_roughness"] = tex_ref(
            cc, "clearcoatRoughnessTexture", False)
        return dict(
            base_color=base,
            metallic=metallic,
            roughness=roughness,
            emissive=emissive * strength,
            clearcoat=float(cc.get("clearcoatFactor", 0.0)),
            clearcoat_roughness=float(
                cc.get("clearcoatRoughnessFactor", 0.0)),
            transmission=float(tr.get("transmissionFactor", 0.0)),
            alpha_mode=mat.get("alphaMode", "OPAQUE"),
            alpha_cutoff=float(mat.get("alphaCutoff", 0.5)),
            sg=sg_info,
            textures=textures,
        )

    globals_ = _global_node_transforms(gltf, buffers)

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = globals_[node_idx]   # includes animation frame-0 overrides
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if "POSITION" not in prim.get("attributes", {}):
                    continue
                pos = _read_accessor(gltf, buffers,
                                     prim["attributes"]["POSITION"]
                                     ).astype(np.float64)
                normals = None
                if "NORMAL" in prim["attributes"]:
                    normals = _read_accessor(
                        gltf, buffers,
                        prim["attributes"]["NORMAL"]).astype(np.float64)
                if "skin" in node and "JOINTS_0" in prim["attributes"]:
                    # Skinned mesh: joint matrices replace the node's world
                    # transform entirely (glTF LBS; gameobject.cpp:562-795).
                    pos, normals = _skin_vertices(
                        gltf, buffers, prim, node["skin"], globals_,
                        pos, normals)
                else:
                    pos = pos @ world[:3, :3].T + world[:3, 3]
                    if normals is not None:
                        nmat = np.linalg.inv(world[:3, :3]).T
                        normals = normals @ nmat.T
                if "indices" in prim:
                    idx = _read_accessor(gltf, buffers, prim["indices"])
                    faces = idx.reshape(-1, 3).astype(np.int64)
                else:
                    faces = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
                uvs = {}
                for set_id in (0, 1):
                    attr = f"TEXCOORD_{set_id}"
                    if attr in prim["attributes"]:
                        uv = _read_accessor(gltf, buffers,
                                            prim["attributes"][attr])
                        acc = gltf["accessors"][prim["attributes"][attr]]
                        if acc["componentType"] == 5121:     # u8 normalized
                            uv = uv / 255.0
                        elif acc["componentType"] == 5123:   # u16 normalized
                            uv = uv / 65535.0
                        uvs[set_id] = uv.astype(np.float32)
                tangents = None
                if "TANGENT" in prim["attributes"]:
                    tan = _read_accessor(gltf, buffers,
                                         prim["attributes"]["TANGENT"])
                    txyz = tan[:, :3].astype(np.float64) @ world[:3, :3].T
                    tangents = np.concatenate(
                        [txyz, tan[:, 3:4]], axis=-1).astype(np.float32)
                primitives.append(dict(
                    positions=pos.astype(np.float32),
                    normals=None if normals is None
                    else normals.astype(np.float32),
                    indices=faces, uvs=uvs, tangents=tangents,
                    **material_of(prim)))
        light_ref = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_ref is not None and light_ref < len(khr_lights):
            l = khr_lights[light_ref]
            ltype = {"directional": 1, "point": 0, "spot": 2}.get(
                l.get("type", "point"), 0)
            direction = world[:3, :3] @ np.array([0.0, 0.0, -1.0])
            spot = l.get("spot", {})
            lights.append(dict(
                type=ltype,
                color=np.asarray(l.get("color", [1, 1, 1]), np.float32),
                intensity=float(l.get("intensity", 1.0)),
                position=world[:3, 3].astype(np.float32),
                direction=(direction / max(np.linalg.norm(direction), 1e-9)
                           ).astype(np.float32),
                range=float(l.get("range", 0.0)),
                inner_cone_cos=float(np.cos(spot.get("innerConeAngle", 0.0))),
                outer_cone_cos=float(np.cos(
                    spot.get("outerConeAngle", np.pi / 4))),
            ))
        for child in node.get("children", []):
            walk(child, world)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    for root in scenes[scene_idx].get("nodes", []):
        walk(root, np.eye(4))
    return dict(primitives=primitives, lights=lights,
                texture_env=dict(gltf=gltf, buffers=buffers,
                                 base_dir=base_dir, cache={}))


def surfelize_mesh(positions, faces, normals=None,
                   surfels_per_unit_area: float = 200.0,
                   min_surfels_per_face: int = 0,
                   thickness_ratio: float = 0.1,
                   seed: int = 13):
    """Sample a triangle mesh into flat Gaussian surfels.

    Area-weighted barycentric sampling; each surfel is a disk Gaussian whose
    tangent sigmas cover its share of the face area and whose normal sigma is
    ``thickness_ratio`` of that.

    Returns dict: means (S,3), log_scales (S,3), quats (S,4), normals (S,3).
    """
    rng = np.random.default_rng(seed)
    p0 = positions[faces[:, 0]]
    p1 = positions[faces[:, 1]]
    p2 = positions[faces[:, 2]]
    cross = np.cross(p1 - p0, p2 - p0)
    areas = 0.5 * np.linalg.norm(cross, axis=-1)
    face_n = cross / np.maximum(np.linalg.norm(cross, axis=-1,
                                               keepdims=True), 1e-12)
    counts = np.maximum(
        np.round(areas * surfels_per_unit_area).astype(np.int64),
        min_surfels_per_face)
    # guarantee at least one surfel somewhere
    if counts.sum() == 0:
        counts[np.argmax(areas)] = 1
    face_ids = np.repeat(np.arange(len(faces)), counts)
    s = len(face_ids)
    u = rng.uniform(size=(s, 2))
    flip = u.sum(-1) > 1.0
    u[flip] = 1.0 - u[flip]
    means = (p0[face_ids] + u[:, :1] * (p1 - p0)[face_ids]
             + u[:, 1:] * (p2 - p0)[face_ids])
    n = face_n[face_ids]
    # per-surfel radius: share of face area, with overlap factor
    share = areas[face_ids] / np.maximum(counts[face_ids], 1)
    radius = np.sqrt(share / np.pi) * 1.6
    # tangent frame
    helper = np.where(np.abs(n[:, 2:3]) < 0.9,
                      np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
    t1 = np.cross(n, helper)
    t1 /= np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-12)
    t2 = np.cross(n, t1)
    frames = np.stack([t1, t2, n], axis=-1)  # columns
    quats = _frames_to_quats(frames)
    log_scales = np.log(np.stack(
        [radius, radius, np.maximum(radius * thickness_ratio, 1e-5)], -1))
    return dict(means=means.astype(np.float32),
                log_scales=log_scales.astype(np.float32),
                quats=quats.astype(np.float32),
                normals=n.astype(np.float32),
                face_ids=face_ids, bary=u.astype(np.float32),
                radius=radius.astype(np.float32),
                frames=frames.astype(np.float32))


def _interp_attr(attr: np.ndarray, faces: np.ndarray, face_ids: np.ndarray,
                 bary: np.ndarray) -> np.ndarray:
    """Barycentric interpolation of a per-vertex attribute at surfels."""
    f = faces[face_ids]
    w0 = (1.0 - bary[:, 0] - bary[:, 1])[:, None]
    return (attr[f[:, 0]] * w0 + attr[f[:, 1]] * bary[:, 0:1]
            + attr[f[:, 2]] * bary[:, 1:2]).astype(np.float32)


def bake_surfel_materials(prim: dict, surf: dict, tex_env: Optional[dict],
                          use_lod: bool = False, lod_factor: float = 1.0):
    """Sample every material texture channel at each surfel's UV.

    The baking analog of the reference's per-hit material kernel
    (closesthit.rchit:364-439): baseColor/emissive/SG in sRGB, metal-rough/
    normal/occlusion UNORM, KHR_texture_transform, alphaMode MASK/BLEND
    (alpha.rahit:14-62) gating surfel opacity, optional surfel-footprint
    mip selection (ray-cone LOD analog, closesthit.rchit:21-37 — ``use_lod``
    and ``lod_factor`` mirror the scene-config keys, engine.cpp:1243-1244).

    Returns dict of per-surfel arrays: color (S,3), emissive (S,3),
    metallic, roughness, clearcoat, clearcoat_roughness, alpha (S,),
    keep (S,) bool, normals (S,3), quats (S,4).
    """
    s = len(surf["means"])
    faces, face_ids, bary = prim["indices"], surf["face_ids"], surf["bary"]
    uvs, refs = prim.get("uvs", {}), prim.get("textures", {}) or {}
    sg = prim.get("sg")

    out = dict(
        color=np.tile(prim["base_color"][:3], (s, 1)).astype(np.float32),
        emissive=np.tile(prim["emissive"], (s, 1)).astype(np.float32),
        metallic=np.full(s, prim["metallic"], np.float32),
        roughness=np.full(s, prim["roughness"], np.float32),
        clearcoat=np.full(s, prim.get("clearcoat", 0.0), np.float32),
        clearcoat_roughness=np.full(
            s, max(prim.get("clearcoat_roughness", 0.0), 0.03), np.float32),
        alpha=np.full(s, float(prim["base_color"][3]), np.float32),
        keep=np.ones(s, bool),
        normals=surf["normals"], quats=surf["quats"])

    def sample(name):
        """(S, 4) RGBA taps for texture ref ``name``, or (None, None)."""
        ref = refs.get(name)
        if ref is None or tex_env is None or not uvs:
            return None, None
        uv_set = uvs.get(ref["texcoord"], uvs.get(0))
        if uv_set is None:
            return None, None
        uv = _interp_attr(uv_set, faces, face_ids, bary)
        uv = apply_texture_transform(uv, ref["transform"])
        sampler = TextureSampler(tex_env["gltf"], tex_env["buffers"],
                                 tex_env["base_dir"], ref["index"],
                                 srgb=ref["srgb"],
                                 image_cache=tex_env["cache"])
        lod = None
        if use_lod:
            # Texel density per face: sqrt(uv-area-in-texels / world-area);
            # mip level = log2 of the surfel diameter's texel footprint.
            p0 = prim["positions"][faces[:, 0]]
            e1 = prim["positions"][faces[:, 1]] - p0
            e2 = prim["positions"][faces[:, 2]] - p0
            a_w = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            t0 = uv_set[faces[:, 0]]
            tu = (uv_set[faces[:, 1]] - t0) * np.asarray(sampler.size)
            tv = (uv_set[faces[:, 2]] - t0) * np.asarray(sampler.size)
            a_t = 0.5 * np.abs(tu[:, 0] * tv[:, 1] - tu[:, 1] * tv[:, 0])
            density = np.sqrt(a_t / np.maximum(a_w, 1e-12))
            foot = 2.0 * surf["radius"] * density[face_ids] * lod_factor
            lod = np.log2(np.maximum(foot, 1.0)).astype(np.float32)
        return sampler.sample(uv, lod=lod), ref

    tap, _ = sample("base_color")
    if tap is not None:
        out["color"] = out["color"] * tap[:, :3]
        out["alpha"] = out["alpha"] * tap[:, 3]
    tap, _ = sample("metallic_roughness")
    if tap is not None:  # glTF: B = metallic, G = roughness
        out["metallic"] = out["metallic"] * tap[:, 2]
        out["roughness"] = out["roughness"] * tap[:, 1]
    tap, ref = sample("occlusion")
    if tap is not None:  # R channel, lerped by strength
        occ = 1.0 + ref["strength"] * (tap[:, 0] - 1.0)
        out["color"] = out["color"] * occ[:, None]
    tap, _ = sample("emissive")
    if tap is not None:
        out["emissive"] = out["emissive"] * tap[:, :3]
    tap, ref = sample("clearcoat")
    if tap is not None:  # R channel
        out["clearcoat"] = out["clearcoat"] * tap[:, 0]
    tap, ref = sample("clearcoat_roughness")
    if tap is not None:  # G channel
        out["clearcoat_roughness"] = np.maximum(
            out["clearcoat_roughness"] * tap[:, 1], 0.03)

    if sg is not None:
        # Per-surfel specular-glossiness -> metal-rough conversion
        # (closesthit.rchit:396-410 shades SG natively; the per-Gaussian
        # SoA carries metal-rough, so convert at bake).
        diffuse = np.tile(sg["diffuse"][None, :], (s, 1))
        spec = np.tile(np.append(sg["specular"], sg["glossiness"])[None, :],
                       (s, 1))
        tap, _ = sample("sg_diffuse")
        if tap is not None:
            diffuse = diffuse * tap
        tap, _ = sample("sg_spec_gloss")
        if tap is not None:
            spec = spec * tap
        metallic = np.clip((spec[:, :3].max(-1) - 0.04) / 0.96, 0.0, 1.0)
        out["metallic"] = metallic.astype(np.float32)
        out["color"] = (diffuse[:, :3] * (1.0 - metallic[:, None])
                        + spec[:, :3] * metallic[:, None]).astype(np.float32)
        out["alpha"] = diffuse[:, 3].astype(np.float32)
        out["roughness"] = np.sqrt(
            np.maximum(1.0 - spec[:, 3], 0.04)).astype(np.float32)

    tap, ref = sample("normal")
    if tap is not None:
        # Tangent-space normal map: perturb each surfel's frame and rebuild
        # its quaternion (closesthit.rchit TBN path, :364-385). Tangents
        # come from the TANGENT attribute when present, else from UV
        # gradients per face (standard derivation).
        n = surf["normals"]
        if prim.get("tangents") is not None:
            tan4 = _interp_attr(prim["tangents"], faces, face_ids, bary)
            t_vec, handed = tan4[:, :3], tan4[:, 3]
        else:
            uv_set = uvs.get(ref["texcoord"], uvs.get(0))
            p0 = prim["positions"][faces[:, 0]]
            e1 = prim["positions"][faces[:, 1]] - p0
            e2 = prim["positions"][faces[:, 2]] - p0
            t0 = uv_set[faces[:, 0]]
            d1 = uv_set[faces[:, 1]] - t0
            d2 = uv_set[faces[:, 2]] - t0
            det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
            inv = 1.0 / np.where(np.abs(det) < 1e-12, 1.0, det)
            t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * inv[:, None]
            t_vec = t_face[face_ids]
            handed = np.ones(len(face_ids), np.float32)
        t_vec = t_vec - n * np.sum(t_vec * n, -1, keepdims=True)
        t_norm = np.linalg.norm(t_vec, axis=-1, keepdims=True)
        t_vec = np.where(t_norm > 1e-8, t_vec / np.maximum(t_norm, 1e-12),
                         surf["frames"][..., 0])
        b_vec = np.cross(n, t_vec) * handed[:, None]
        nt = (tap[:, :3] * 2.0 - 1.0).copy()
        nt[:, :2] *= ref["scale"]
        n_new = (t_vec * nt[:, 0:1] + b_vec * nt[:, 1:2] + n * nt[:, 2:3])
        n_new /= np.maximum(np.linalg.norm(n_new, axis=-1, keepdims=True),
                            1e-12)
        t_new = t_vec - n_new * np.sum(t_vec * n_new, -1, keepdims=True)
        t_new /= np.maximum(np.linalg.norm(t_new, axis=-1, keepdims=True),
                            1e-12)
        frames = np.stack([t_new, np.cross(n_new, t_new), n_new], axis=-1)
        out["normals"] = n_new.astype(np.float32)
        out["quats"] = _frames_to_quats(frames)

    mode = prim.get("alpha_mode", "OPAQUE")
    if mode == "MASK":
        # alpha.rahit:14-31 — cutoff compare; failing surfels are cut out.
        out["keep"] = out["alpha"] >= prim.get("alpha_cutoff", 0.5)
        out["alpha"] = np.ones(s, np.float32)
    elif mode != "BLEND":
        out["alpha"] = np.ones(s, np.float32)  # OPAQUE ignores alpha
    return out


def load_gltf_scene(path: str, surfels_per_unit_area: float = 200.0,
                    opacity_logit: float = 7.0, seed: int = 13,
                    use_lod: bool = False, lod_factor: float = 1.0,
                    device=None):
    """Load a glTF file as (GaussianScene, PunctualLights | None) on
    ``device`` (None: the CUDA card).

    Textures are baked per surfel (see :func:`bake_surfel_materials`);
    ``use_lod`` / ``lod_factor`` pick each surfel's mip level from its
    footprint (the scene config's use_lod and lod_factor keys)."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        concat_scenes,
    )

    parsed = parse_gltf(path)
    tex_env = parsed.get("texture_env")
    parts = []
    for prim in parsed["primitives"]:
        surf = surfelize_mesh(prim["positions"], prim["indices"],
                              prim.get("normals"),
                              surfels_per_unit_area=surfels_per_unit_area,
                              seed=seed)
        m = len(surf["means"])
        if m == 0:
            continue
        baked = bake_surfel_materials(prim, surf, tex_env,
                                      use_lod=use_lod,
                                      lod_factor=lod_factor)
        keep = baked["keep"]
        if not keep.any():
            continue
        # BLEND-mode texture alpha folds into the surfel opacity: a
        # Gaussian of opacity o*a transmits like a stochastic a-blend.
        alpha = np.clip(baked["alpha"][keep], 1e-4, 1.0)
        base_op = 1.0 / (1.0 + np.exp(-opacity_logit))
        op = np.clip(base_op * alpha, 1e-4, 1.0 - 1e-6)
        logits = np.log(op / (1.0 - op)).astype(np.float32)
        parts.append(make_scene(
            means=surf["means"][keep],
            log_scales=surf["log_scales"][keep],
            quats=np.asarray(baked["quats"])[keep],
            opacity_logits=logits,
            colors=baked["color"][keep],
            emission=baked["emissive"][keep],
            metallic=baked["metallic"][keep],
            roughness=baked["roughness"][keep],
            clearcoat=baked["clearcoat"][keep],
            clearcoat_roughness=baked["clearcoat_roughness"][keep],
            transmission=np.full(int(keep.sum()),
                                 prim.get("transmission", 0.0),
                                 np.float32),
            device=device))
    if not parts:
        raise ValueError(f"no geometry in {path}")
    scene = concat_scenes(parts)
    lights = parsed["lights"]
    punctual = None
    if lights:
        punctual = make_punctual_lights(
            position=[l["position"] for l in lights],
            direction=[l["direction"] for l in lights],
            color=[l["color"] for l in lights],
            intensity=[l["intensity"] for l in lights],
            light_type=[l["type"] for l in lights],
            range=[l["range"] for l in lights],
            inner_cone_cos=[l["inner_cone_cos"] for l in lights],
            outer_cone_cos=[l["outer_cone_cos"] for l in lights],
            device=device)
    return scene, punctual
