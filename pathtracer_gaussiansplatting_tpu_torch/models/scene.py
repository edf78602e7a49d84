"""Scene assembly: procedural scenes, config-driven loading, the trainable
scene.

Counterpart of ``pathtracer_gaussiansplatting_tpu/models/scene.py``
(``concat_scenes``, ``transform_scene``, ``rtbox_scene``,
``debug_cube_scene`` and its panels, ``random_cloud``, ``surface_scene``,
``load_scene_from_config``). The constructors draw from numpy's seeded
generator exactly as the reference does, so one seed gives the same scene
in both packages; the result is built on ``device`` (None: the CUDA card,
``core/device.py``). ``load_scene_from_config`` assembles a scene config's
objects (3DGS checkpoints, glTF files, ``builtin:`` scenes), each with its
world transform baked into the Gaussians, its rtbox and its lights. ``SceneParams`` holds
a scene's leaves as ``nn.Parameter``s, the port's form of the JAX scene
pytree that ``optax`` updates.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    PUNCTUAL_FIELDS, SCENE_FIELDS, GaussianScene, PunctualLights,
    make_punctual_lights, make_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.ops.quaternions import (
    quat_to_rotmat, rotmat_to_quat,
)


def concat_scenes(scenes: Sequence[GaussianScene]) -> GaussianScene:
    """Concatenate scenes along the Gaussian axis; the SH bands are padded
    with zeros to the largest degree present."""
    k_max = max(s.sh_coeffs.shape[1] for s in scenes)

    def pad_sh(s):
        k = s.sh_coeffs.shape[1]
        return torch.nn.functional.pad(s.sh_coeffs, (0, 0, 0, k_max - k))

    return GaussianScene(**{
        f: torch.cat([pad_sh(s) if f == "sh_coeffs" else getattr(s, f)
                      for s in scenes]) for f in SCENE_FIELDS})


def transform_scene(scene: GaussianScene, position=(0, 0, 0),
                    scale=(1, 1, 1), rotation_euler_deg=(0, 0, 0)
                    ) -> GaussianScene:
    """Bake a world transform into the Gaussian parameters.

    Rotation is XYZ euler degrees (R = Rz Ry Rx); scale is per world axis,
    and a rotated Gaussian's principal axes are scaled by the scale's
    magnitude along each of their directions.
    """
    rx, ry, rz = [np.radians(a) for a in rotation_euler_deg]

    def rot_x(a):
        return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                         [0, np.sin(a), np.cos(a)]])

    def rot_y(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])

    def rot_z(a):
        return np.array([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    dev = scene.means.device
    r = torch.tensor((rot_z(rz) @ rot_y(ry) @ rot_x(rx)).astype(np.float32),
                     device=dev)
    s = torch.tensor(np.asarray(scale, np.float32), device=dev)
    pos = torch.tensor(np.asarray(position, np.float32), device=dev)

    means = (scene.means * s) @ r.T + pos
    frames = quat_to_rotmat(scene.quats)               # (N,3,3) columns=axes
    axis_scale = torch.sqrt(torch.sum((s[None, :, None] * frames) ** 2,
                                      dim=1))
    new_log_scales = scene.log_scales + torch.log(
        torch.clamp_min(axis_scale, 1e-12))
    new_quats = rotmat_to_quat(r @ frames)
    return scene.replace(means=means, log_scales=new_log_scales,
                         quats=new_quats)


def _panel(center, tangent_u, tangent_v, color, metallic, roughness,
           emissive_intensity, res: int, thickness: float = 0.01,
           device=None) -> GaussianScene:
    """A rectangular wall as a res x res grid of flat Gaussians, each
    spanning 0.8 of its grid cell."""
    center = np.asarray(center, np.float64)
    tu = np.asarray(tangent_u, np.float64)
    tv = np.asarray(tangent_v, np.float64)
    n = np.cross(tu, tv)
    n /= np.linalg.norm(n)
    us = (np.arange(res) + 0.5) / res - 0.5
    uu, vv = np.meshgrid(us, us)
    means = (center[None]
             + uu.reshape(-1, 1) * 2 * tu[None]
             + vv.reshape(-1, 1) * 2 * tv[None])
    m = res * res
    su = np.linalg.norm(tu) * 2 / res * 0.8
    sv = np.linalg.norm(tv) * 2 / res * 0.8
    log_scales = np.tile(np.log([su, sv, thickness]), (m, 1))
    frame = np.stack([tu / np.linalg.norm(tu), tv / np.linalg.norm(tv), n], -1)
    quat = rotmat_to_quat(torch.as_tensor(frame.astype(np.float32))).numpy()
    quats = np.tile(quat, (m, 1))
    emission = np.tile(np.asarray(color, np.float64) * emissive_intensity,
                       (m, 1))
    return make_scene(
        means=means.astype(np.float32),
        log_scales=log_scales.astype(np.float32),
        quats=quats.astype(np.float32),
        opacity_logits=np.full((m,), 9.0, np.float32),
        colors=np.tile(np.asarray(color, np.float32), (m, 1)),
        emission=emission.astype(np.float32),
        metallic=np.full((m,), metallic, np.float32),
        roughness=np.full((m,), roughness, np.float32),
        device=device,
    )


_PANEL_GEOMS = {
    # name: (center offset in half-dims, tangent_u axis, tangent_v axis)
    "floor": ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    "ceiling": ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
    "back_wall": ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
    "left_wall": ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
    "right_wall": ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    "front_wall": ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
}


def rtbox_scene(rtbox: dict, res: int = 24, device=None) -> GaussianScene:
    """Cornell box from a parsed rtbox.json (``utils.config.
    load_rtbox_config``): each listed panel a res x res grid of flat
    Gaussians with its material; a panel with light intensity > 0 emits
    intensity / area, which registers it for NEE through the emission
    channel."""
    pos = np.asarray(rtbox["position"], np.float64)
    half = np.asarray(rtbox["dimensions"], np.float64) / 2.0
    parts = []
    for name, mat in rtbox["panels"].items():
        if name not in _PANEL_GEOMS:
            continue
        off, tu_axis, tv_axis = _PANEL_GEOMS[name]
        center = pos + np.asarray(off) * half
        # Half-extent of the panel along each tangent axis direction.
        tu = np.asarray(tu_axis, np.float64) * (half @ np.abs(tu_axis))
        tv = np.asarray(tv_axis, np.float64) * (half @ np.abs(tv_axis))
        area = 4.0 * np.linalg.norm(tu) * np.linalg.norm(tv)
        inten = mat["light_intensity"] / max(area, 1e-6)
        parts.append(_panel(center, tu, tv, mat["base_color"],
                            mat["metallic"], mat["roughness"], inten, res,
                            device=device))
    return concat_scenes(parts)


def debug_cube_scene(center=(0.0, 0.0, 0.0), size: float = 1.0,
                     res: int = 8, device=None) -> GaussianScene:
    """Emissive yellow cube: six panels of res x res flat Gaussians."""
    half = size / 2.0
    parts = []
    for off, tu_axis, tv_axis in _PANEL_GEOMS.values():
        c = np.asarray(center) + np.asarray(off) * half
        tu = np.asarray(tu_axis, np.float64) * half
        tv = np.asarray(tv_axis, np.float64) * half
        parts.append(_panel(c, tu, tv, (1.0, 1.0, 0.0), 0.0, 1.0,
                            2.0, res, thickness=0.005 * size, device=device))
    return concat_scenes(parts)


def surface_scene(n: int, seed: int = 13, half=(2.0, 1.5, 2.0),
                  overlap: float = 0.7, flatness: float = 0.1,
                  light_intensity: float = 6.0,
                  device=None) -> GaussianScene:
    """Surface-structured benchmark scene: a Cornell-style room with a
    mirror, a diffuse and a glass sphere and an emissive ceiling panel,
    Gaussians sampled on the surfaces with trained-3DGS-like statistics
    (tangent sigma ``overlap`` x the mean sample spacing, normal sigma
    ``flatness`` x tangent, smallest axis along the normal)."""
    rng = np.random.default_rng(seed)
    hx, hy, hz = (float(h) for h in half)

    def rect(center, tu, tv, m):
        u = rng.uniform(-1, 1, (m, 1))
        v = rng.uniform(-1, 1, (m, 1))
        c = np.asarray(center, np.float64)[None]
        nrm = np.cross(tu, tv)
        nrm = nrm / np.linalg.norm(nrm)
        pts = c + u * np.asarray(tu)[None] + v * np.asarray(tv)[None]
        return pts, np.tile(nrm, (m, 1))

    def sphere(center, radius, m):
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return np.asarray(center)[None] + radius * d, d

    white, gray = (0.85, 0.85, 0.85), (0.6, 0.6, 0.6)
    # (sampler, area, color, metallic, roughness, transmission, emission)
    panel_em = np.asarray((1.0, 1.0, 0.9)) * light_intensity
    surfaces = [
        (lambda m: rect((0, -hy, 0), (hx, 0, 0), (0, 0, hz), m),
         4 * hx * hz, white, 0.0, 0.85, 0.0, None),                 # floor
        (lambda m: rect((0, hy, 0), (hx, 0, 0), (0, 0, -hz), m),
         4 * hx * hz, white, 0.0, 0.9, 0.0, None),                  # ceiling
        (lambda m: rect((0, 0, -hz), (hx, 0, 0), (0, hy, 0), m),
         4 * hx * hy, white, 0.0, 0.8, 0.0, None),                  # back
        (lambda m: rect((0, 0, hz), (-hx, 0, 0), (0, hy, 0), m),
         4 * hx * hy, gray, 0.0, 0.8, 0.0, None),                   # front
        (lambda m: rect((-hx, 0, 0), (0, 0, hz), (0, hy, 0), m),
         4 * hz * hy, (0.8, 0.15, 0.15), 0.0, 0.8, 0.0, None),      # left
        (lambda m: rect((hx, 0, 0), (0, 0, -hz), (0, hy, 0), m),
         4 * hz * hy, (0.15, 0.8, 0.15), 0.0, 0.8, 0.0, None),      # right
        (lambda m: sphere((-0.9, -hy + 0.6, -0.6), 0.6, m),
         4 * np.pi * 0.36, (0.95, 0.95, 0.95), 1.0, 0.15, 0.0,
         None),                                                     # mirror
        (lambda m: sphere((0.9, -hy + 0.5, 0.3), 0.5, m),
         np.pi, (0.2, 0.3, 0.8), 0.0, 0.6, 0.0, None),              # diffuse
        (lambda m: sphere((0.0, -hy + 0.45, 0.9), 0.45, m),
         4 * np.pi * 0.2, (0.98, 0.98, 0.98), 0.0, 0.05, 1.0,
         None),                                                     # glass
        (lambda m: rect((0, hy - 0.02, 0), (0.6, 0, 0), (0, 0, -0.6), m),
         1.44, (1.0, 1.0, 0.9), 0.0, 0.9, 0.0, panel_em),           # light
    ]
    total_area = sum(s[1] for s in surfaces)
    s_tan = overlap * np.sqrt(total_area / n)

    counts = [max(1, int(round(n * a / total_area)))
              for _, a, *_ in surfaces]
    counts[0] += n - sum(counts)

    pts_l, nrm_l, col_l, met_l, rgh_l, trn_l, emi_l = \
        [], [], [], [], [], [], []
    for (sampler, _a, color, met, rough, trans, emi), m in zip(surfaces,
                                                               counts):
        p, nv = sampler(m)
        pts_l.append(p)
        nrm_l.append(nv)
        col = np.asarray(color, np.float64)[None] \
            * rng.uniform(0.9, 1.1, (m, 1))
        col_l.append(np.clip(col, 0, 1))
        met_l.append(np.full(m, met))
        rgh_l.append(np.clip(rng.normal(rough, 0.05, m), 0.02, 1.0))
        trn_l.append(np.full(m, trans))
        emi_l.append(np.tile(emi if emi is not None else (0.0, 0.0, 0.0),
                             (m, 1)))
    pts = np.concatenate(pts_l)
    nrm = np.concatenate(nrm_l)
    m_total = len(pts)

    # Tangent frame per splat with a random in-plane rotation.
    a = np.where(np.abs(nrm[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]],
                 [[1.0, 0.0, 0.0]])
    t1 = np.cross(nrm, a)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(nrm, t1)
    phi = rng.uniform(0, 2 * np.pi, (m_total, 1))
    u1 = np.cos(phi) * t1 + np.sin(phi) * t2
    u2 = -np.sin(phi) * t1 + np.cos(phi) * t2
    frames = np.stack([u1, u2, nrm], axis=-1)        # columns = axes
    quats = rotmat_to_quat(torch.as_tensor(frames.astype(np.float32)))

    jitter = rng.normal(0.0, 0.15, (m_total, 2))
    log_t = np.log(s_tan) + jitter
    log_scales = np.stack(
        [log_t[:, 0], log_t[:, 1],
         np.log(flatness * s_tan) + rng.normal(0, 0.1, m_total)], -1)
    return make_scene(
        means=pts.astype(np.float32),
        log_scales=log_scales.astype(np.float32),
        quats=quats.numpy(),
        opacity_logits=rng.normal(2.5, 0.5, m_total).astype(np.float32),
        colors=np.concatenate(col_l).astype(np.float32),
        emission=np.concatenate(emi_l).astype(np.float32),
        metallic=np.concatenate(met_l).astype(np.float32),
        roughness=np.concatenate(rgh_l).astype(np.float32),
        transmission=np.concatenate(trn_l).astype(np.float32),
        device=device,
    )


def random_cloud(n: int, seed: int = 13, spread: float = 1.0,
                 sh_degree: int = 0, emissive_frac: float = 0.0,
                 scale_range=(-3.0, -1.5), device=None) -> GaussianScene:
    """Random anisotropic Gaussian cloud in [-spread, spread]^3."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    log_scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    log_scales += np.log(max(spread, 1e-6))
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = rng.uniform(-1.0, 1.0, (n, 3))
    if k > 1:
        sh[:, 1:] = rng.normal(0, 0.08, (n, k - 1, 3))
    emission = np.zeros((n, 3), np.float32)
    if emissive_frac > 0:
        ne = max(1, int(n * emissive_frac))
        emission[:ne] = rng.uniform(2.0, 8.0, (ne, 3))
    return make_scene(
        means=means, log_scales=log_scales, quats=quats,
        opacity_logits=rng.uniform(-1, 2, (n,)).astype(np.float32),
        sh_coeffs=sh, emission=emission,
        metallic=rng.uniform(0, 1, (n,)).astype(np.float32),
        roughness=rng.uniform(0.2, 1, (n,)).astype(np.float32),
        device=device,
    )


def load_scene_from_config(cfg, base_dir: str = ".", device=None):
    """Assemble (GaussianScene, PunctualLights | None) from a SceneConfig
    (``utils/config.py``) on ``device`` (None: the CUDA card).

    An object's ``model`` is a 3DGS ``.ply`` checkpoint, a ``.gltf`` /
    ``.glb`` file (relative paths from ``base_dir``) or a builtin scene:
    ``builtin:random_cloud?n=1000&seed=13&sh_degree=0&emissive_frac=0`` or
    ``builtin:debug_cube?size=1``; any other builtin name raises. Each
    object's transform is baked into its Gaussians; the rtbox, when the
    config uses one, is added untransformed. The lights are the glTF
    files' KHR_lights_punctual lights, then the sun (a directional light).
    """
    import os
    import urllib.parse

    from pathtracer_gaussiansplatting_tpu_torch.data.gltf import (
        load_gltf_scene,
    )
    from pathtracer_gaussiansplatting_tpu_torch.data.ply import load_3dgs_ply
    from pathtracer_gaussiansplatting_tpu_torch.utils.config import (
        load_rtbox_config,
    )

    def path_of(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    parts, gltf_lights = [], []
    for obj in cfg.objects:
        model = obj.model
        if model.startswith("builtin:"):
            name, _, query = model[len("builtin:"):].partition("?")
            params = dict(urllib.parse.parse_qsl(query))
            if name == "random_cloud":
                s = random_cloud(int(params.get("n", 1000)),
                                 seed=int(params.get("seed", 13)),
                                 sh_degree=int(params.get("sh_degree", 0)),
                                 emissive_frac=float(
                                     params.get("emissive_frac", 0)),
                                 device=device)
            elif name == "debug_cube":
                s = debug_cube_scene(size=float(params.get("size", 1.0)),
                                     device=device)
            else:
                raise ValueError(f"unknown builtin scene '{name}'")
        elif model.endswith((".gltf", ".glb")):
            s, obj_lights = load_gltf_scene(path_of(model), device=device)
            if obj_lights is not None:
                gltf_lights.append(obj_lights)
        else:
            s = load_3dgs_ply(path_of(model), device=device)
        parts.append(transform_scene(s, obj.position, obj.scale,
                                     obj.rotation))
    if cfg.use_rt_box and cfg.rt_box_file:
        parts.append(rtbox_scene(load_rtbox_config(path_of(cfg.rt_box_file)),
                                 device=device))
    if not parts:
        raise ValueError("scene config contains no objects")
    scene = concat_scenes(parts)

    # The glTF lights keep their positions in the file's space: the object
    # transform is baked into the Gaussians only, as the reference reads
    # lights in model space before baking.
    all_lights = list(gltf_lights)
    if cfg.sun is not None:
        all_lights.append(make_punctual_lights(
            direction=[list(cfg.sun.direction)],
            color=[list(cfg.sun.color)],
            intensity=[cfg.sun.intensity], light_type=[1], num=1,
            device=device))
    punctual = None
    if all_lights:
        punctual = PunctualLights(**{
            f: torch.cat([getattr(lt, f) for lt in all_lights])
            for f in PUNCTUAL_FIELDS})
    return scene, punctual


class SceneParams(nn.Module):
    """The 11 ``GaussianScene`` fields as trainable parameters."""

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        for f in SCENE_FIELDS:
            setattr(self, f, nn.Parameter(fields[f].detach().clone()))

    @classmethod
    def from_scene(cls, scene: GaussianScene) -> "SceneParams":
        return cls(**{f: getattr(scene, f) for f in SCENE_FIELDS})

    def scene(self) -> GaussianScene:
        """The parameters as a GaussianScene (differentiable view)."""
        return GaussianScene(**{f: getattr(self, f) for f in SCENE_FIELDS})

    def grad_scene(self) -> GaussianScene:
        """The gradients as a GaussianScene (zeros where none)."""
        return GaussianScene(**{
            f: torch.zeros_like(x) if x.grad is None else x.grad
            for f, x in self.named_parameters()})
