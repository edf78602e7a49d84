"""The median frame latency of the window, in ms, beside its tail."""
import numpy as np


def read(run):
    if not run.units.get("frames"):
        return None
    return 1e3 * float(np.median(run.latencies))
