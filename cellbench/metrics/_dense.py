"""What the dense trace's readers share: the dense top-K's (K1's) least
time, counted from the port's counters, and the gathers' device time,
joined to their launches from anchors.

The bound follows ``chip_smoke.dense_bound``'s function's bound: whatever
kernel does the work, each ray's origin and direction read once, its (K,)
index, t and alpha written once, the (N, 16) float32 table read once a
launch, and 60 flops (the exact path's) on each listed pair with alpha >
0, a lower bound of the pairs with alpha > 0 (``render/reference
.dense_topk``'s counters ``dense_rays``, ``dense_list_slots``,
``dense_list_filled``).

The join: ``_spans.py`` pairs the n-th kernel on the card with the n-th
kernel launch of the whole segment, and one record the profiler drops
shifts every op after it. A dense pose holds some 30,000 launches a
sample, and a traced segment of it has been seen shifted (K1's time then
credited to the span around ``ptgs.topk``). So the gathers are joined
from anchors: each ``ptgs.topk`` span launches K1 alone (its arguments are
views and the backend's cached table), the m-th K1 kernel is the m-th
span's launch, and the launches after it pair with the ops after that K1
up to the next one.
"""
from __future__ import annotations

import bisect
from importlib import import_module

import numpy as np

from cellbench.metrics._spans import KERNEL, launch_kind, op_kind
from cellbench.metrics._tilecount import bound_s

PROFILING = "pathtracer_gaussiansplatting_tpu_torch.utils.profiling"
PAIR_FLOPS = 60          # the exact path on one (ray, Gaussian) pair
TABLE_BYTES = 4 * 16     # a row of the (N, 16) float32 table
COUNTERS = ("dense_rays", "dense_list_slots", "dense_list_filled")


def is_topk(name: str) -> bool:
    return "dense_topk" in name


def is_vis(name: str) -> bool:
    return "dense_visibility" in name


def counters():
    """{name: int} of the dense top-K's counters, or None where the
    program counts none of them (a traced segment must have run)."""
    counts = getattr(import_module(PROFILING), "counts", None)
    got = counts() if counts is not None else {}
    if not all(got.get(k) is not None for k in COUNTERS) \
            or not got["dense_list_slots"]:
        return None
    return {k: got[k] for k in COUNTERS}


def topk_bound_s(got: dict, launches: int, n: int) -> float:
    """The least seconds of ``launches`` top-K launches over a scene of
    ``n`` Gaussians that together listed the counters' ``got``."""
    n_bytes = 4.0 * (6 * got["dense_rays"] + 3 * got["dense_list_slots"]) \
        + TABLE_BYTES * n * launches
    return bound_s(n_bytes, PAIR_FLOPS * got["dense_list_filled"])


def anchored_s(host, span: str):
    """Device seconds of the kernels launched inside the spans ``span`` of
    the host segment ``host``, each span's launches joined from the K1
    launch of the last ``ptgs.topk`` span before it; None where the K1
    kernels and the ``ptgs.topk`` spans do not pair, or a span's launches
    run past the next K1."""
    cpu = list(zip(host.cpu_start, host.cpu_end, host.cpu_names))
    launches = np.sort(np.array([s for s, _, n in cpu
                                 if launch_kind(n) == KERNEL], np.int64))
    topk = sorted(s for s, _, n in cpu if n == "ptgs.topk")
    inside = sorted((s, e) for s, e, n in cpu if n == span)
    ops = sorted((s, e - s, n) for n, s, e in zip(host.names, host.start,
                                                   host.end)
                 if op_kind(n) == KERNEL)
    anchors = [p for p, (_, _, n) in enumerate(ops) if is_topk(n)]
    if not inside or not topk or len(anchors) != len(topk):
        return None
    k1_launch = np.searchsorted(launches, topk)
    total = 0
    for s, e in inside:
        j = bisect.bisect_right(topk, s) - 1
        if j < 0:
            return None
        end = anchors[j + 1] if j + 1 < len(anchors) else len(ops)
        for launch in range(*np.searchsorted(launches, (s, e))):
            p = anchors[j] + launch - k1_launch[j]
            if not anchors[j] < p < end:
                return None
            total += ops[p][1]
    return total * 1e-9
