"""The host side of the hand-written CUDA kernels, one layer for every
wrapper in ``kernels/``: the entry points' argument types, the CPU-or-card
decision, the input check, the launch and its count.

``SIGNATURES`` gives each ``extern "C"`` entry point of ``csrc/*.cu`` its
ctypes argument types; they are bound once, when :func:`function` first
loads the library (``csrc/build.load()``). :func:`on_cpu` sends CPU inputs
to a wrapper's plain version and holds the rest to one Hopper card.
:func:`check` holds a kernel's tensors to their shapes, dtypes,
contiguity and alignment before any pointer leaves Python. :func:`launch`
calls an entry point on the card's current stream, raises on a CUDA error
and adds one to its key in ``launches``, one ``collections.Counter`` of
launches by kernel and path, read by ``chip_smoke.py`` and the tests.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MARCH = [_P] * 13 + [_I] * 8 + [_F] * 7 + [_P]

# Every entry point's parameters, in the order of its C declaration; the
# last of a launch is its stream.
SIGNATURES = {
    "ptgs_tile_composite_fwd": [_P] * 7 + [_I] * 8 + [_F] * 6 + [_P],
    "ptgs_tile_composite_fwd_clusters": [_I, _I, _P],
    "ptgs_tile_composite_bwd": [_P] * 11 + [_I] * 9 + [_F] * 6 + [_P],
    "ptgs_tile_composite_bwd_clusters": [_I] * 4 + [_P] * 2,
    "ptgs_tile_composite_variant": [_I] + [_P] * 5 + [_I] * 4 + [_F] * 6
                                   + [_P],
    "ptgs_packet_gather_count": [_P] * 2 + [_I] * 2 + [_P] * 2,
    "ptgs_packet_gather_reduce": [_P] * 2 + [_I] * 4 + [_P] * 7,
    "ptgs_dense_topk": [_P] * 14 + [_I] * 3 + [_F] * 5 + [_P],
    "ptgs_dense_visibility": [_P] * 7 + [_I] * 2 + [_F] * 3 + [_P],
    "ptgs_dense_visibility_count": [_P] * 8 + [_I] * 2 + [_F] * 3 + [_P],
    "ptgs_dense_visibility_pairs": [_P] * 9 + [_I] * 2 + [_F] * 3 + [_P],
    "ptgs_dense_composite": [_P] * 5 + [_I] * 3 + [_P] * 2,
    "ptgs_grid_trace": _MARCH,
    "ptgs_grid_visibility": _MARCH,
    "ptgs_threefry_uniforms": [_P, _P, _P, _I, ctypes.c_longlong, _I, _F,
                               _F, _P],
}

# Launches on the card by key: the kernel, and for the tile and march
# kernels the path (e.g. "tile_fwd", "tile_fwd_cluster", "grid_trace_wide").
launches = collections.Counter()

_FUNCTIONS = {}


def function(entry: str):
    """The entry point ``entry`` of the kernel library, its argument types
    and int return bound (all of ``SIGNATURES`` at the first call)."""
    if not _FUNCTIONS:
        from pathtracer_gaussiansplatting_tpu_torch.csrc import build

        lib, bound = build.load(), {}
        for name, argtypes in SIGNATURES.items():
            bound[name] = getattr(lib, name)
            bound[name].argtypes = argtypes
            bound[name].restype = ctypes.c_int
        _FUNCTIONS.update(bound)
    return _FUNCTIONS[entry]


def on_cpu(name: str, tensors) -> bool:
    """True for inputs all on the CPU, False for inputs all on one Hopper
    CUDA device; raises on anything else."""
    if all(x.device.type == "cpu" for x in tensors.values()):
        return True
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda" or any(x.device != dev for x in tensors.values()):
        raise ValueError(f"{name}: inputs must all be on the CPU or all on "
                         f"one CUDA device, got "
                         f"{[str(x.device) for x in tensors.values()]}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{name}: the kernel is built for sm_90a "
                           f"(Hopper); {torch.cuda.get_device_name(dev)} "
                           "is not")
    return False


def check(name: str, tensors: dict, expect: dict,
          dtypes: Optional[dict] = None, aligned=()) -> None:
    """Raises ValueError unless each tensor is contiguous, of its shape in
    ``expect`` and of its dtype in ``dtypes`` (float32 where none is
    given), and each tensor named in ``aligned`` starts on a 16-byte
    boundary (the kernels' 16-byte copies)."""
    for key, x in tensors.items():
        dtype = (dtypes or {}).get(key, torch.float32)
        shape = tuple(expect[key])
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} tensor of shape "
                f"{shape}, got {x.dtype} {tuple(x.shape)} "
                f"contiguous={x.is_contiguous()}")
    for key in aligned:
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary")


def ptr(x: Optional[torch.Tensor]):
    """A tensor's device pointer, None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def launch(name: str, entry: str, *args, device, count: Optional[str]):
    """Calls ``entry`` with ``args`` and the current stream of ``device``
    under its device guard; raises RuntimeError on a CUDA error, else adds
    one to ``launches[count]`` (None counts nothing)."""
    with torch.cuda.device(device):
        err = function(entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {entry} launch failed with CUDA error "
                           f"{err}")
    if count is not None:
        launches[count] += 1
