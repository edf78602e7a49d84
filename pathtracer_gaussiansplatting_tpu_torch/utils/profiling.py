"""Profiling helpers: fenced timers, a rays/s meter, device memory, traces.

Counterpart of ``pathtracer_gaussiansplatting_tpu/utils/profiling.py`` on
tensors. CUDA work is asynchronous: ``fence`` synchronizes the devices of
the tensors it is given and pulls every leaf's sum to the host, so a
host-clock time taken after it covers the work that produced them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.device import resolve_device


def _leaves(tree):
    """The array leaves of nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif hasattr(tree, "dtype"):
        yield tree


def fence(*trees) -> float:
    """Wait for every computation producing the given tensors; returns the
    float sum of every leaf, as the reference does."""
    leaves = [x for tree in trees for x in _leaves(tree)]
    for dev in {x.device for x in leaves
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)
    return sum(float(torch.sum(x)) if isinstance(x, torch.Tensor)
               else float(np.sum(x)) for x in leaves)


@contextlib.contextmanager
def device_timer(label: str = "", result_holder: Optional[dict] = None):
    """Times a block on the host clock; a tensor tree the block stores as
    ``out["result"]`` is fenced before the clock stops."""
    t0 = time.perf_counter()
    out = {}
    yield out
    if "result" in out:
        fence(out["result"])
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label or "elapsed"] = dt


class RaysPerSecondMeter:
    """Streaming rays/s counter for render loops."""

    def __init__(self):
        self.rays = 0
        self.t0 = time.perf_counter()

    def add(self, num_rays: int):
        self.rays += num_rays

    @property
    def rays_per_s(self) -> float:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return self.rays / dt

    def reset(self):
        self.rays = 0
        self.t0 = time.perf_counter()


def device_memory_stats(print_out: bool = False, device=None) -> list:
    """Memory in use, its limit and its peak, MiB, under the reference's
    keys: one row per visible CUDA device (``device=None`` means the card
    and raises without one), or the one zero row of ``device="cpu"``.
    In use and peak are the caching allocator's allocated bytes, the limit
    the device's total memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    rows = []
    for d in devices:
        used = limit = peak = 0
        if d.type == "cuda":
            s = torch.cuda.memory_stats(d)
            used = s.get("allocated_bytes.all.current", 0)
            peak = s.get("allocated_bytes.all.peak", 0)
            limit = torch.cuda.mem_get_info(d)[1]
        rows.append(dict(device=str(d), used_mib=round(used / 2**20, 1),
                         limit_mib=round(limit / 2**20, 1),
                         peak_mib=round(peak / 2**20, 1)))
        if print_out:
            print(f"[mem] {d}: {used / 2**20:.1f} / {limit / 2**20:.1f} MiB "
                  f"(peak {rows[-1]['peak_mib']:.1f})")
    return rows


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around the block (the CPU, and the CUDA devices where
    there are any); writes a Chrome trace into ``log_dir``. A profiler
    that fails to start or stop raises."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
