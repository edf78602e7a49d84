"""Point-cloud PLY rows: the ctypes wrapper of ``csrc/ply_rows.cpp`` and
its plain Python version.

Counterpart of ``format_ply_rows`` in
``pathtracer_gaussiansplatting_tpu/csrc/build.py``, whose Python row loop
is copied here as ``format_ply_rows_plain`` (the test oracle). The wrapper
always runs the C++ library (built with g++ at first use,
``csrc/build.py:build_host``): a failed build raises, and nothing drops to
the Python loop.
"""
from __future__ import annotations

import ctypes

import numpy as np

ROW_BYTES = 100   # no row is longer (nine fields of at most 12 characters)
SLACK = 160       # ptgs_format_ply_rows wants this much room before a row


def _lib():
    from pathtracer_gaussiansplatting_tpu_torch.csrc import build

    lib = build.load_host()
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ptgs_format_ply_rows.argtypes = [
        f32p, f32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.ptgs_format_ply_rows.restype = ctypes.c_int64
    return lib


def _arrays(pos, nrm, rgb):
    return (np.ascontiguousarray(pos, np.float32),
            np.ascontiguousarray(nrm, np.float32),
            np.ascontiguousarray(rgb, np.uint8))


def format_ply_rows(pos, nrm, rgb) -> str:
    """The PLY body: one row "x y z nx ny nz r g b\\n" for each of the N
    points, floats as %g; pos, nrm (N, 3) float32, rgb (N, 3) uint8."""
    pos, nrm, rgb = _arrays(pos, nrm, rgb)
    f32p = ctypes.POINTER(ctypes.c_float)
    cap = ROW_BYTES * len(pos) + SLACK
    buf = np.empty(cap, np.uint8)
    written = _lib().ptgs_format_ply_rows(
        pos.ctypes.data_as(f32p), nrm.ctypes.data_as(f32p),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(pos),
        buf.ctypes.data, cap)
    if written < 0:
        raise RuntimeError(f"ptgs_format_ply_rows: {cap} bytes were too few "
                           f"for {len(pos)} rows")
    return buf[:written].tobytes().decode("ascii")


def format_ply_rows_plain(pos, nrm, rgb) -> str:
    """Plain Python version of :func:`format_ply_rows` (the reference's
    fallback, one f-string a row)."""
    pos, nrm, rgb = _arrays(pos, nrm, rgb)
    lines = []
    for p, m, c in zip(pos, nrm, rgb):
        lines.append(f"{p[0]:g} {p[1]:g} {p[2]:g} {m[0]:g} {m[1]:g} {m[2]:g} "
                     f"{c[0]} {c[1]} {c[2]}\n")
    return "".join(lines)
