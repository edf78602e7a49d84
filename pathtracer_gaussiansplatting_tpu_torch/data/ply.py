"""Point-cloud PLY export and import.

Counterpart of ``save_point_cloud_ply``, ``load_point_cloud_ply`` and
``_parse_ply_header`` in ``pathtracer_gaussiansplatting_tpu/data/ply.py``:
ascii 1.0, properties x y z nx ny nz and uchar red green blue, the points
filtered to hits, byte for byte the JAX package's file. The rows are
formatted by the host library's C++ (``csrc/ply_rows.py``).
"""
from __future__ import annotations

import io
import os

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
