"""The 95th percentile of every frame's latency in the window, in ms: from
the call of ``InteractiveSession.step()`` (after its event, if it has
one) until the image is back on the host."""
import numpy as np


def read(run):
    if not run.units.get("frames"):
        return None
    return 1e3 * float(np.percentile(run.latencies, 95))
