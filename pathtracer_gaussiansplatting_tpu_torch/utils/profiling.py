"""Profiling helpers: fenced timers, device memory, traces, and the
program's spans and counters.

Counterpart of ``pathtracer_gaussiansplatting_tpu/utils/profiling.py`` on
tensors. CUDA work is asynchronous: ``fence`` synchronizes the devices of
the tensors it is given and pulls every leaf's sum to the host, so a
host-clock time taken after it covers the work that produced them.

``span`` and ``count`` record only while a ``torch.profiler`` records:
spans are the profiler's own user annotations (``ptgs.<layer>``, on the
clock of its device trace), counters sum on the device and are read by
``counts``. With no profiler each costs one check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

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


# Counters of ``count``: name -> an int or a 0-dim device tensor.
_COUNTS: dict = {}


def _recording() -> bool:
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """The profiler range ``name`` around a block while a profiler records,
    else a no-op (an entered ``record_function`` costs some microseconds
    whether or not anything records)."""
    if _recording():
        return record_function(name)
    return contextlib.nullcontext()


def count(name: str, value) -> None:
    """Adds ``value`` to the counter ``name`` while a profiler records: an
    int, or a tensor whose elements are summed on its device (no host
    sync until :func:`counts`), or a function of no arguments returning
    either, called only then (a count that costs device work)."""
    if not _recording():
        return
    if callable(value):
        value = value()
    if isinstance(value, torch.Tensor):
        value = value.sum()
    prev = _COUNTS.get(name)
    _COUNTS[name] = value if prev is None else prev + value


def counts() -> dict:
    """{name: int} of every counter since :func:`reset_counts`."""
    return {k: int(v) for k, v in _COUNTS.items()}


def reset_counts() -> None:
    _COUNTS.clear()


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
