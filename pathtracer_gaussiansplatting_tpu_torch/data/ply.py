"""PLY files: the point-cloud export and the 3DGS checkpoint.

Counterpart of ``pathtracer_gaussiansplatting_tpu/data/ply.py``:

  * ``save_point_cloud_ply`` / ``load_point_cloud_ply``: ascii 1.0,
    properties x y z nx ny nz and uchar red green blue, the points filtered
    to hits, byte for byte the JAX package's file. The rows are formatted
    by the host library's C++ (``csrc/ply_rows.py``).
  * ``load_3dgs_ply`` / ``save_3dgs_ply``: the standard 3DGS checkpoint
    (binary_little_endian; x y z, nx ny nz, f_dc_*, f_rest_* channel-major,
    opacity as a logit, scale_* as logs, rot_* as w x y z). The writer's
    file is byte for byte the JAX package's for the same scene; the reader
    takes the whole vertex block with one ``np.frombuffer``.
"""
from __future__ import annotations

import io
import os

from typing import Optional

import numpy as np

from pathtracer_gaussiansplatting_tpu_torch.csrc.ply_rows import (
    format_ply_rows,
)


def _numpy(x) -> np.ndarray:
    """numpy view of an array or a tensor (on any device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_point_cloud_ply(path, positions, normals, colors, flags=None):
    """Write an ascii PLY of the points; returns the number of rows.

    Args:
      positions, normals: (N, 3) float; colors: (N, 3) float in [0, 1],
        written as 0-255 (truncated).
      flags: optional (N,); rows with flag <= 0 are dropped.
    """
    positions, normals, colors = (_numpy(x) for x in (positions, normals,
                                                      colors))
    if flags is not None:
        keep = _numpy(flags) > 0.0
        positions, normals, colors = positions[keep], normals[keep], colors[keep]
    rgb = (np.clip(colors, 0.0, 1.0) * 255.0).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.StringIO()
    buf.write("ply\n")
    buf.write("format ascii 1.0\n")
    buf.write(f"element vertex {len(positions)}\n")
    for p in ("x", "y", "z", "nx", "ny", "nz"):
        buf.write(f"property float {p}\n")
    for c in ("red", "green", "blue"):
        buf.write(f"property uchar {c}\n")
    buf.write("end_header\n")
    body = format_ply_rows(np.asarray(positions, np.float32),
                           np.asarray(normals, np.float32), rgb)
    with open(path, "w") as f:
        f.write(buf.getvalue())
        f.write(body)
    return len(positions)


def load_point_cloud_ply(path):
    """Read back an ascii PLY written by :func:`save_point_cloud_ply`:
    dict of positions, normals (N, 3) and colors (N, 3) in [0, 1]."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ply" and lines[1].startswith("format ascii")
    n = 0
    header_end = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
        if ln == "end_header":
            header_end = i + 1
            break
    rows = np.array([[float(x) for x in ln.split()]
                     for ln in lines[header_end:header_end + n]])
    if rows.size == 0:
        rows = rows.reshape(0, 9)
    return dict(positions=rows[:, 0:3], normals=rows[:, 3:6],
                colors=rows[:, 6:9] / 255.0)


def _parse_ply_header(f):
    """Parse a PLY header from a binary file handle; returns (fmt, names,
    types, count), the handle left at the first data byte."""
    magic = f.readline().strip()
    assert magic == b"ply", "not a PLY file"
    fmt = None
    names, types = [], []
    count = 0
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == b"format":
            fmt = parts[1].decode()
        elif parts[0] == b"element":
            if parts[1] == b"vertex":
                count = int(parts[2])
            else:
                raise ValueError("only vertex elements supported")
        elif parts[0] == b"property":
            types.append(parts[1].decode())
            names.append(parts[2].decode())
        elif parts[0] == b"end_header":
            break
    return fmt, names, types, count


_PLY_DTYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}


def load_3dgs_ply(path, max_sh_degree: Optional[int] = None, device=None):
    """Load a 3DGS checkpoint PLY into a GaussianScene on ``device`` (None:
    the CUDA card).

    f_rest_{k} is laid out channel-major ((K-1) coefficients x 3
    channels); opacity and scales are stored before activation (logit,
    log). ``max_sh_degree`` drops the higher SH bands. The file's other
    fields (emission, materials) are not in the format: they take
    ``make_scene``'s defaults.
    """
    from pathtracer_gaussiansplatting_tpu_torch.core.types import make_scene

    with open(path, "rb") as f:
        fmt, names, types, count = _parse_ply_header(f)
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count)
            data = {n: rows[:, i] for i, n in enumerate(names)}
        else:
            dtype = np.dtype([(n, _PLY_DTYPES[t])
                              for n, t in zip(names, types)])
            raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                count=count)
            data = {n: np.asarray(raw[n], np.float32) for n in names}

    means = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    n = means.shape[0]
    dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], -1)
    rest_names = sorted((k for k in data if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    n_rest = len(rest_names)
    k_total = 1 + n_rest // 3
    if max_sh_degree is not None:
        k_total = min(k_total, (max_sh_degree + 1) ** 2)
    sh = np.zeros((n, k_total, 3), np.float32)
    sh[:, 0, :] = dc
    if n_rest and k_total > 1:
        rest = np.stack([data[k] for k in rest_names], -1)  # (N, n_rest)
        rest = rest.reshape(n, 3, n_rest // 3)              # channel-major
        sh[:, 1:, :] = rest.transpose(0, 2, 1)[:, : k_total - 1, :]
    log_scales = np.stack([data[f"scale_{i}"] for i in range(3)], -1)
    quats = np.stack([data[f"rot_{i}"] for i in range(4)], -1)
    return make_scene(
        means=means,
        log_scales=log_scales.astype(np.float32),
        quats=quats.astype(np.float32),
        opacity_logits=np.asarray(data["opacity"], np.float32),
        sh_coeffs=sh,
        device=device,
    )


def save_3dgs_ply(path, scene):
    """Write a GaussianScene (on any device) as a binary 3DGS checkpoint
    PLY: the normals are zero, f_rest channel-major."""
    means = _numpy(scene.means).astype(np.float32)
    n = means.shape[0]
    sh = _numpy(scene.sh_coeffs).astype(np.float32)
    k = sh.shape[1]
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * (k - 1))]
    names += ["opacity"] + [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    dtype = np.dtype([(nm, "<f4") for nm in names])
    out = np.zeros(n, dtype=dtype)
    out["x"], out["y"], out["z"] = means.T
    for i in range(3):
        out[f"f_dc_{i}"] = sh[:, 0, i]
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    for i in range(rest.shape[1]):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = _numpy(scene.opacity_logits).astype(np.float32)
    ls = _numpy(scene.log_scales).astype(np.float32)
    qs = _numpy(scene.quats).astype(np.float32)
    for i in range(3):
        out[f"scale_{i}"] = ls[:, i]
    for i in range(4):
        out[f"rot_{i}"] = qs[:, i]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm in names:
            f.write(f"property float {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(out.tobytes())
