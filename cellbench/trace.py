"""The traced segment: ``torch.profiler`` over a few of the cell's own
calls after the window, reduced to device intervals by kernel name.

The segment records the card's activity alone (``ProfilerActivity.CUDA``):
recording every host operation as well slows a launch-bound host by tens
of percent, and the idle share would measure the profiler. Kernels are
attributed by their names only, never by host interval. The device's busy
time is the union of every kernel, copy and set on the card; the
segment's length is taken on the host clock between two fences. A second
segment of as many calls records the host's operations too, and only
names the longest idle gaps by what the host was doing (``Trace.host``).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# The port's hand-written kernels, by a part of their names (csrc/*.cu).
HAND_KERNELS = ("tile_composite", "grid_march_kernel", "threefry",
                "dense_topk", "dense_visibility", "variant_kernel")


class Trace:
    """Device and host events of one traced segment (times in seconds from
    the segment's first event)."""

    def __init__(self, events, window_s: float, units: dict):
        self.window_s, self.units = window_s, units
        cuda, cpu_t = torch.autograd.DeviceType.CUDA, \
            torch.autograd.DeviceType.CPU
        # Host ranges (``record_function``, such as ``ptgs.shade``) are
        # mirrored on the device's timeline; they are no device work.
        ranges = {e.name() for e in events if e.is_user_annotation()}
        dev = [e for e in events if e.device_type() == cuda
               and e.duration_ns() > 0 and not e.is_user_annotation()
               and e.name() not in ranges]
        cpu = [e for e in events
               if e.device_type() == cpu_t and e.duration_ns() > 0]
        self.names = [e.name() for e in dev]
        t0 = min([e.start_ns() for e in dev + cpu], default=0)
        self.start = np.array([e.start_ns() - t0 for e in dev], np.int64)
        self.end = self.start + np.array([e.duration_ns() for e in dev],
                                         np.int64)
        self.cpu_names = [e.name() for e in cpu]
        self.cpu_start = np.array([e.start_ns() - t0 for e in cpu], np.int64)
        self.cpu_end = self.cpu_start + np.array(
            [e.duration_ns() for e in cpu], np.int64)
        self.is_kernel = np.array(
            [not n.startswith(("Memcpy", "Memset")) for n in self.names],
            bool)

    def _merged(self):
        """Disjoint busy intervals (ns) of the device."""
        if not len(self.start):
            return np.zeros((0, 2), np.int64)
        order = np.argsort(self.start, kind="stable")
        s, e = self.start[order], self.end[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1])
        return np.stack([starts, ends], -1)

    @property
    def busy_s(self) -> float:
        iv = self._merged()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds in kernels whose name ``match`` accepts."""
        sel = [i for i, n in enumerate(self.names)
               if self.is_kernel[i] and match(n)]
        return float((self.end[sel] - self.start[sel]).sum()) * 1e-9

    def kernel_count(self, match: Callable[[str], bool] = lambda n: True):
        return sum(1 for i, n in enumerate(self.names)
                   if self.is_kernel[i] and match(n))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most
        time, summed by name."""
        tot = {}
        for n, s, e in zip(self.names, self.start, self.end):
            tot[n] = tot.get(n, 0) + int(e - s)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], v * 1e-9] for n, v in best]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: the longest gaps
        between device work, each named by the innermost host operation
        running at its middle."""
        iv = self._merged()
        if len(iv) < 2:
            return []
        gs, ge = iv[:-1, 1], iv[1:, 0]
        order = np.argsort(-(ge - gs))[:top]
        out = []
        for i in order:
            mid = (gs[i] + ge[i]) // 2
            inside = np.nonzero((self.cpu_start <= mid)
                                & (self.cpu_end >= mid))[0]
            name = "host idle" if not len(inside) else \
                self.cpu_names[inside[np.argmax(self.cpu_start[inside])]]
            out.append([name[:200], float(ge[i] - gs[i]) * 1e-9])
        return out


def is_hand(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


def segment(call: Callable[[], dict], n_calls: int, activities) -> Trace:
    """Profile ``n_calls`` calls of ``call`` (each returns the units of work
    it did, summed into ``Trace.units``), between two fences."""
    units = {}
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            for k, v in call().items():
                units[k] = units.get(k, 0) + v
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), window, units)


def traced(call: Callable[[], dict], n_calls: int) -> Trace:
    """The card's segment of ``n_calls`` calls, with ``host``: the segment
    of as many more calls that records the host's operations too."""
    tr = segment(call, n_calls, [ProfilerActivity.CUDA])
    tr.host = segment(call, n_calls, [ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
    return tr
