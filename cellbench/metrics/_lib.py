"""Arithmetic the readers share."""
from cellbench.trace import is_hand


def idle_pct(run):
    """The share of the window in which the card ran nothing: 1 - the
    traced segment's busy seconds a call over the untraced window's
    seconds a call, in %. The traced segment's own length is left out:
    the profiler's cost a launch stretches it, most in launch-bound
    cells."""
    tr = run.trace
    if tr is None or not tr.units.get("calls") or not run.units.get("calls"):
        return None
    busy = tr.busy_s / tr.units["calls"]
    return 100.0 * (1.0 - busy / (run.window_s / run.units["calls"]))


def kernel_ms_per(run, match, unit: str):
    """Device ms in kernels ``match`` accepts, per ``unit`` of the traced
    segment's work."""
    tr = run.trace
    if tr is None or not tr.units.get(unit):
        return None
    return 1e3 * tr.kernel_s(match) / tr.units[unit]


def roofline_pct(run, kernel: str, bound_key: str):
    """The least time of a step's work in ``kernel`` (the driver's
    ``tile_bounds`` of the traced steps' inputs, which its
    ``trace_extras`` kept) over its mean device time a step, in %; None
    where the kernel did not run."""
    tr = run.trace
    if tr is None or run.extras is None or not tr.units.get("steps"):
        return None
    spent = tr.kernel_s(lambda n: kernel in n) / tr.units["steps"]
    if spent <= 0:
        return None
    return 100.0 * run.driver.tile_bounds(run.extras)[bound_key] / spent


def not_hand(name: str) -> bool:
    return not is_hand(name)
