"""The capture pose in plain torch, for chosen pixels: the port's
``data/capture.make_tiled_pose_renderer`` (one binning a pose, then spp
jittered samples of the tile pass for the primary hit and the bounce loop
on the grid backend, accumulated), worked out for the pixels asked for
only. Every ray's random numbers depend only on its frame and its
tile-major index, and the grid march treats each ray alone, so these
pixels come out as they do in a whole pose.
"""
from __future__ import annotations

import torch

from . import lights as lights_mod
from . import rng as rng_mod
from . import tiles as tiles_mod
from .pathtrace import GridBackend, RayKeys, _interaction, pathtrace
from .types import Rays

CAPTURE_SEED = 13      # the capture's base key, rng.prng_key(13)
GATHER_RAYS = 8192     # rays a composite chunk gathers packets for


def _primary(packets, cam, config, settings, py, px, frame, key, jitter,
             lowp):
    """(dirs (R, 3), tile-major index (R,), interaction) of the pixels'
    primary rays in ``frame`` (whose key is ``key``), jittered as the
    capture jitters them where ``jitter``, else through pixel centres."""
    w = cam.width
    ts = config.tile_size
    tiles_x, _ = tiles_mod.num_tiles(cam, config)
    jx = jy = 0.5
    if jitter:
        jkey = rng_mod.dim_key(key, 0)
        r2 = rng_mod.r2_host(frame)
        pix = (py * w + px) * 2
        jx = torch.fmod(rng_mod.uniform_at(jkey[0], jkey[1], pix)
                        + torch.tensor(r2[0], device=py.device), 1.0)
        jy = torch.fmod(rng_mod.uniform_at(jkey[0], jkey[1], pix + 1)
                        + torch.tensor(r2[1], device=py.device), 1.0)
    dirs = tiles_mod.pixel_dirs(cam, py, px, jx, jy)
    tile = (py // ts) * tiles_x + px // ts
    index = tile * ts * ts + (py % ts) * ts + px % ts
    outs = []
    for s in range(0, py.shape[0], GATHER_RAYS):
        t = tile[s:s + GATHER_RAYS]
        outs.append(tiles_mod.composite(
            packets["geom"][t], packets["featsT"][t],
            dirs[s:s + GATHER_RAYS, None, :], settings, lowp))
    out, alpha, depth = (torch.cat(x)[:, 0] for x in zip(*outs))
    origins = cam.c2w[:3, 3][None].expand(dirs.shape[0], 3)
    return dirs, index, _interaction(out, alpha, depth, origins, dirs,
                                     settings)


def capture_keys(spp: int) -> dict:
    """The capture's frame keys: ``frame_key(PRNGKey(13), f)``."""
    base = rng_mod.prng_key(CAPTURE_SEED)
    return {f: rng_mod.frame_key(base, f) for f in range(spp)}


def session_keys(seed: int, frames: int) -> dict:
    """The interactive session's frame keys: ``fold_in(PRNGKey(seed),
    f)``."""
    base = rng_mod.prng_key(seed)
    return {f: rng_mod.fold_in(base, f) for f in range(frames)}


@torch.no_grad()
def render_pixels(scene, accel, cams, pixels, settings, config, spps,
                  keys: dict, jitter: bool = True, lowp: bool = False):
    """[(S, 3)] accumulated radiance of the pixels ``pixels`` = [(py, px)
    (S,) int64 each] of each camera over its ``spps`` samples (frames 0
    .. spp - 1, keyed by ``keys``), as the tiled pose renderer (with
    ``jitter``) or the interactive session (without) makes them; no
    punctual lights."""
    tables = lights_mod.build_light_tables(scene, None)
    backend = GridBackend(accel, settings, lowp=lowp)
    origins, dirs, inters, frames, index = [], [], [], [], []
    for cam, (py, px), spp in zip(cams, pixels, spps):
        packets = tiles_mod.prepare(scene, cam, settings, config, lowp)
        for f in range(spp):
            d, idx, inter = _primary(packets, cam, config, settings, py, px,
                                     f, keys[f], jitter, lowp)
            origins.append(cam.c2w[:3, 3][None].expand(d.shape[0], 3))
            dirs.append(d)
            inters.append(inter)
            frames.append(torch.full_like(idx, f))
            index.append(idx)
        del packets
    primary = {k: torch.cat([i[k] for i in inters]) for k in inters[0]}
    rays = Rays(torch.cat(origins), torch.cat(dirs))
    radiance = pathtrace(scene, rays, settings,
                         RayKeys(keys, torch.cat(frames), torch.cat(index)),
                         tables, backend, primary)
    out, at = [], 0
    for (py, _), spp in zip(pixels, spps):
        s = py.shape[0]
        part = radiance[at:at + spp * s].reshape(spp, s, 3)
        at += spp * s
        acc = torch.zeros_like(part[0])
        for f in range(spp):
            blend = 1.0 / (torch.tensor(float(f), dtype=torch.float32) + 1.0)
            acc = acc + (part[f] - acc) * blend.to(acc.device)
        out.append(acc)
    return out
