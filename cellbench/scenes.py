"""The benchmark's inputs, made from the seed on the device: the scenes as
raw float32 tensors (the 11 fields of a Gaussian scene), handed alike to
the program and to the reference.

``surface_room`` follows the port's ``models/scene.surface_scene`` (a
Cornell-style room with a mirror, a diffuse and a glass sphere and an
emissive ceiling panel; surfels with trained-3DGS-like statistics) and
``random_cloud`` its ``random_cloud``; both draw with a ``torch.Generator``
on the device, in a few large calls, so set-up never waits on the host.
"""
from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
GEOMETRY_SEED = 2 ** 31 - 1   # the one draw of every seed's Gaussians
COLOUR_JITTER = 0.1           # a seed's jitter of each base colour (SH DC)
FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs",
          "emission", "metallic", "roughness", "clearcoat",
          "clearcoat_roughness", "transmission")


def make(config: dict, seed: int, device) -> dict:
    """The scene a configuration file names: ``config["scene"]`` (a
    function of this module) of ``config["n"]`` Gaussians, with
    ``config["scene_args"]`` as its keywords.

    Every seed's scene holds the same Gaussians, those of one draw
    (``GEOMETRY_SEED``), in an order of the seed's and with the seed's
    jitter of each one's base colour. A scene's work follows its geometry
    (the fullest tile sets the packets' width, a cell's fill the march's),
    so a seed that drew the geometry would choose the work.
    """
    if config["scene"] not in SCENES:
        raise ValueError(f"no scene {config['scene']!r}: one of {SCENES}")
    n = config["n"]
    raw = globals()[config["scene"]](n, GEOMETRY_SEED, device,
                                     **config.get("scene_args", {}))
    gen = generator(seed, device)
    order = torch.randperm(n, generator=gen, device=device)
    raw = {k: v[order].contiguous() for k, v in raw.items()}
    dc = raw["sh_coeffs"][:, 0]
    dc += COLOUR_JITTER * (2.0 * torch.rand(dc.shape, generator=gen,
                                            device=device) - 1.0)
    return raw


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _frames_to_quats(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations (columns the axes) -> (N, 4) unit quaternions
    (w, x, y, z), by the largest of the four candidates."""
    m00, m11, m22 = m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]
    cand = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                        1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    k = torch.argmax(cand, -1)
    s = 2.0 * torch.sqrt(torch.clamp_min(cand.gather(1, k[:, None])[:, 0],
                                         1e-12))
    q = torch.stack([
        torch.stack([s / 4, (m[:, 2, 1] - m[:, 1, 2]) / s,
                     (m[:, 0, 2] - m[:, 2, 0]) / s,
                     (m[:, 1, 0] - m[:, 0, 1]) / s], -1),
        torch.stack([(m[:, 2, 1] - m[:, 1, 2]) / s, s / 4,
                     (m[:, 0, 1] + m[:, 1, 0]) / s,
                     (m[:, 0, 2] + m[:, 2, 0]) / s], -1),
        torch.stack([(m[:, 0, 2] - m[:, 2, 0]) / s,
                     (m[:, 0, 1] + m[:, 1, 0]) / s, s / 4,
                     (m[:, 1, 2] + m[:, 2, 1]) / s], -1),
        torch.stack([(m[:, 1, 0] - m[:, 0, 1]) / s,
                     (m[:, 0, 2] + m[:, 2, 0]) / s,
                     (m[:, 1, 2] + m[:, 2, 1]) / s, s / 4], -1),
    ], 1)
    q = q[torch.arange(m.shape[0], device=m.device), k]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def surface_room(n: int, seed: int, device, half=(2.0, 1.5, 2.0),
                 overlap: float = 0.7, flatness: float = 0.1,
                 light_intensity: float = 6.0) -> dict:
    """The surface room of ``n`` Gaussians (``models/scene.surface_scene``'s
    surfaces, areas, materials and statistics)."""
    gen = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    hx, hy, hz = (float(h) for h in half)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    def rect(center, tu, tv, m):
        uv = uni((m, 2), -1.0, 1.0)
        tu, tv = torch.tensor(tu, **f32), torch.tensor(tv, **f32)
        nrm = torch.linalg.cross(tu, tv)
        pts = torch.tensor(center, **f32) + uv[:, :1] * tu + uv[:, 1:] * tv
        return pts, (nrm / torch.linalg.vector_norm(nrm)).expand(m, 3)

    def sphere(center, radius, m):
        d = torch.randn((m, 3), generator=gen, **f32)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return torch.tensor(center, **f32) + radius * d, d

    white, gray = (0.85, 0.85, 0.85), (0.6, 0.6, 0.6)
    panel = tuple(c * light_intensity for c in (1.0, 1.0, 0.9))
    # (sampler, area, colour, metallic, roughness, transmission, emission)
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
         4 * math.pi * 0.36, (0.95, 0.95, 0.95), 1.0, 0.15, 0.0,
         None),                                                     # mirror
        (lambda m: sphere((0.9, -hy + 0.5, 0.3), 0.5, m),
         math.pi, (0.2, 0.3, 0.8), 0.0, 0.6, 0.0, None),            # diffuse
        (lambda m: sphere((0.0, -hy + 0.45, 0.9), 0.45, m),
         4 * math.pi * 0.2, (0.98, 0.98, 0.98), 0.0, 0.05, 1.0,
         None),                                                     # glass
        (lambda m: rect((0, hy - 0.02, 0), (0.6, 0, 0), (0, 0, -0.6), m),
         1.44, (1.0, 1.0, 0.9), 0.0, 0.9, 0.0, panel),              # light
    ]
    total_area = sum(s[1] for s in surfaces)
    s_tan = overlap * math.sqrt(total_area / n)
    counts = [max(1, int(round(n * s[1] / total_area))) for s in surfaces]
    counts[0] += n - sum(counts)

    pts, nrm, col, met, rgh, trn, emi = [], [], [], [], [], [], []
    for (sampler, _a, color, m_, rough, t_, em), m in zip(surfaces, counts):
        p, nv = sampler(m)
        pts.append(p)
        nrm.append(nv)
        col.append(torch.tensor(color, **f32).expand(m, 3))
        met.append(torch.full((m,), m_, **f32))
        rgh.append(torch.full((m,), rough, **f32))
        trn.append(torch.full((m,), t_, **f32))
        emi.append(torch.tensor(em or (0.0, 0.0, 0.0), **f32).expand(m, 3))
    pts, nrm = torch.cat(pts), torch.cat(nrm)
    col = torch.clamp(torch.cat(col) * uni((n, 1), 0.9, 1.1), 0.0, 1.0)
    rough = torch.clamp(torch.cat(rgh)
                        + 0.05 * torch.randn((n,), generator=gen, **f32),
                        0.02, 1.0)

    # A tangent frame per splat with a random in-plane rotation.
    a = torch.where(torch.abs(nrm[:, 2:3]) < 0.9,
                    torch.tensor([0.0, 0.0, 1.0], **f32),
                    torch.tensor([1.0, 0.0, 0.0], **f32))
    t1 = torch.linalg.cross(nrm, a)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(nrm, t1)
    phi = uni((n, 1), 0.0, 2 * math.pi)
    u1 = torch.cos(phi) * t1 + torch.sin(phi) * t2
    u2 = -torch.sin(phi) * t1 + torch.cos(phi) * t2
    quats = _frames_to_quats(torch.stack([u1, u2, nrm], -1))

    jit = torch.randn((n, 3), generator=gen, **f32)
    log_scales = torch.stack([
        math.log(s_tan) + 0.15 * jit[:, 0], math.log(s_tan) + 0.15 * jit[:, 1],
        math.log(flatness * s_tan) + 0.1 * jit[:, 2]], -1)
    sh = torch.zeros((n, 1, 3), **f32)
    sh[:, 0] = (col - 0.5) / SH_C0
    zeros = torch.zeros((n,), **f32)
    return dict(
        means=pts.contiguous(), log_scales=log_scales, quats=quats,
        opacity_logits=2.5 + 0.5 * torch.randn((n,), generator=gen, **f32),
        sh_coeffs=sh, emission=torch.cat(emi).contiguous(),
        metallic=torch.cat(met), roughness=rough, clearcoat=zeros,
        clearcoat_roughness=torch.full((n,), 0.03, **f32),
        transmission=torch.cat(trn))


def random_cloud(n: int, seed: int, device, spread: float = 1.0,
                 scale_range=(-3.0, -1.5)) -> dict:
    """A random anisotropic cloud in [-spread, spread]^3 with SH degree 0
    (``models/scene.random_cloud``'s distributions)."""
    gen = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((n, 14), generator=gen, **f32)
    quats = torch.randn((n, 4), generator=gen, **f32)
    lo, hi = scale_range
    zeros = torch.zeros((n,), **f32)
    return dict(
        means=spread * (2.0 * u[:, 0:3] - 1.0),
        log_scales=lo + (hi - lo) * u[:, 3:6] + math.log(max(spread, 1e-6)),
        quats=quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True),
        opacity_logits=-1.0 + 3.0 * u[:, 6],
        sh_coeffs=(2.0 * u[:, 7:10] - 1.0)[:, None, :].contiguous(),
        emission=torch.zeros((n, 3), **f32),
        metallic=u[:, 10].contiguous(),
        roughness=(0.2 + 0.8 * u[:, 11]).contiguous(),
        clearcoat=zeros, clearcoat_roughness=torch.full((n,), 0.03, **f32),
        transmission=zeros.clone())


SCENES = ("surface_room", "random_cloud")
