"""Device time credited to the program's spans: the ``ptgs.<layer>``
ranges of the port's ``utils/profiling.span``, in the host-recorded
segment (``run.trace.host``), where the profiler records them as its own
user annotations on the clock of the device trace.

A device kernel, copy or set is joined to the runtime call that launched
it (``cudaLaunchKernel``, which the hand kernels' launches are too,
``cudaLaunchKernelExC`` of the cluster kernels, ``cudaMemcpyAsync``,
``cudaMemsetAsync``, ...). The segment (``cellbench/trace.Trace``) keeps
names and times, not the profiler's correlation ids, so the join is by
stream order: the program launches all its work from one thread on the
current stream, which runs it in the order it was launched, so the n-th
kernel on the card is the n-th kernel launch on the host, and so for
copies and sets. Times do not take part: the card's clock drifts from
the host's by up to ~2 ms over a segment, so an op can read as starting
before its own launch. Ops of a kind beyond its launches go unjoined. A
record the profiler drops or mistimes shifts the ops after it by one,
which moves credit only where that shifts an op across a span's edge.

An op goes to the innermost span that holds its launch's start: the
span that issued it, wherever on the device timeline it ran. Work
launched outside every span, such as autograd's backward while the
program's thread waits in ``backward()``, goes to none. A span's self
time is what goes to it as the innermost; the time under it adds its
child spans'. An idle gap between the device's busy intervals goes to
the innermost span open at the gap's midpoint: the layer the host was in
while the card waited. Gaps include the profiler's own cost a launch
(CUPTI's), so they read higher than in an untraced run. Spans are taken
to lie on one thread, the program's, and to nest.

A segment without such spans (a program that records none) credits
nothing, and the readers return None.
"""
from __future__ import annotations

import functools

import numpy as np

PREFIX = "ptgs."
NONE = -1       # launched outside every span
UNJOINED = -2   # no launch in the segment for the op

KERNEL, COPY, SET = 0, 1, 2


def launch_kind(name: str):
    """The kind of device op a host call launches, or None."""
    if not name.startswith("cu"):
        return None
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return KERNEL
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return COPY
    if name.startswith(("cudaMemset", "cuMemset")):
        return SET
    return None


def op_kind(name: str) -> int:
    if name.startswith("Memcpy"):
        return COPY
    if name.startswith("Memset"):
        return SET
    return KERNEL


class Spans:
    """The segment's ``ptgs.*`` spans, each device op credited to one of
    them (``credit``: a span's index, NONE or UNJOINED), and its idle gaps
    to the spans open at their midpoints."""

    def __init__(self, host):
        cpu = [(s, e, n) for n, s, e in zip(host.cpu_names, host.cpu_start,
                                            host.cpu_end)]
        spans = sorted(((s, e, n) for s, e, n in cpu
                        if n.startswith(PREFIX)),
                       key=lambda t: (t[0], -t[1]))
        self.start = np.array([s[0] for s in spans], np.int64)
        self.end = np.array([s[1] for s in spans], np.int64)
        self.name = [s[2] for s in spans]
        # The parent of each span: the innermost earlier span that holds
        # it (the ranges of one thread nest).
        self.parent = np.full(len(spans), NONE, np.int64)
        stack = []
        for i in range(len(spans)):
            while stack and self.end[stack[-1]] < self.end[i]:
                stack.pop()
            self.parent[i] = stack[-1] if stack else NONE
            stack.append(i)

        self.op_names = list(host.names)
        self.op_start = np.asarray(host.start, np.int64)
        self.op_ns = np.asarray(host.end, np.int64) - self.op_start
        self.credit = np.full(len(self.op_names), UNJOINED, np.int64)
        ops_kind = np.array([op_kind(n) for n in self.op_names], np.int64)
        for kind in (KERNEL, COPY, SET):
            calls = np.sort(np.array([s for s, _, n in cpu
                                      if launch_kind(n) == kind], np.int64))
            sel = np.nonzero(ops_kind == kind)[0]
            sel = sel[np.argsort(self.op_start[sel], kind="stable")]
            n = min(len(calls), len(sel))
            self.credit[sel[:n]] = self._innermost(calls[:n])
        self.gap_ns, self.gap_credit = self._gaps()

    def _innermost(self, at) -> np.ndarray:
        """The innermost span holding each time of ``at``, or NONE."""
        if not len(self.name):
            return np.full(len(at), NONE, np.int64)
        # The latest span starting at or before the time, then out
        # through its parents until one still holds it.
        pos = np.searchsorted(self.start, at, "right") - 1
        cand = np.where(pos >= 0, np.maximum(pos, 0), NONE)
        while True:
            out_of = (cand >= 0) & (self.end[np.maximum(cand, 0)] < at)
            if not out_of.any():
                return cand
            cand = np.where(out_of, self.parent[np.maximum(cand, 0)], cand)

    def _gaps(self):
        """(lengths, credited span) of the idle gaps between the device's
        busy intervals."""
        if len(self.op_start) < 2:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        order = np.argsort(self.op_start, kind="stable")
        s = self.op_start[order]
        reach = np.maximum.accumulate(s + self.op_ns[order])
        new = np.nonzero(s[1:] > reach[:-1])[0] + 1
        gs, ge = reach[new - 1], s[new]
        return ge - gs, self._innermost((gs + ge) // 2)

    def count(self, name: str) -> int:
        return self.name.count(name)

    def under(self, name: str) -> np.ndarray:
        """(spans + 1,) bool: whether each span (and, last, none) is
        ``name`` or lies inside one."""
        out = np.zeros(len(self.name) + 1, bool)
        for i, n in enumerate(self.name):    # parents come before children
            out[i] = n == name or (self.parent[i] >= 0
                                   and out[self.parent[i]])
        return out

    def _of(self, credit, name: str, self_only: bool) -> np.ndarray:
        if self_only:
            mask = np.array([n == name for n in self.name] + [False])
        else:
            mask = self.under(name)
        # NONE and UNJOINED take the last entry, False
        return mask[np.where(credit >= 0, credit, len(self.name))]

    def device_s(self, name: str, self_only: bool = False) -> float:
        """Device seconds of the ops credited to ``name``'s spans (with
        their child spans', unless ``self_only``)."""
        return float(self.op_ns[self._of(self.credit, name,
                                         self_only)].sum()) * 1e-9

    def gap_s(self, name: str) -> float:
        """Idle seconds of the gaps credited to ``name``'s spans or their
        child spans."""
        return float(self.gap_ns[self._of(self.gap_credit, name,
                                          False)].sum()) * 1e-9


@functools.lru_cache(maxsize=1)
def _spans(host) -> Spans:
    return Spans(host)


def host_spans(run, name: str, unit: str = ""):
    """(the host segment's Spans, its ``unit`` count) where the segment
    holds a span ``name`` and ``unit`` (if named) of work; else None."""
    host = getattr(run.trace, "host", None) if run.trace is not None \
        else None
    if host is None:
        return None
    n = host.units.get(unit, 0) if unit else 1
    if not n or not any(c == name for c in host.cpu_names):
        return None
    return _spans(host), n


def ms_per(run, name: str, unit: str, self_only: bool = False):
    """Device ms under (or, ``self_only``, in) span ``name`` per ``unit``
    of the host segment's work."""
    got = host_spans(run, name, unit)
    if got is None:
        return None
    sp, n = got
    return 1e3 * sp.device_s(name, self_only) / n


def gap_ms_per(run, name: str, unit: str):
    """Device idle ms in gaps inside span ``name`` per ``unit``."""
    got = host_spans(run, name, unit)
    if got is None:
        return None
    sp, n = got
    return 1e3 * sp.gap_s(name) / n
