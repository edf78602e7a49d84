"""The forward tile kernel's share of its roofline on a training step
(``csrc/tile_composite_fwd.cu``): the least time of the step's forward
work (``_tilecount``, counted from the inputs) over the kernel's mean
device time a step, in %."""
from cellbench.metrics._lib import roofline_pct


def read(run):
    return roofline_pct(run, "tile_composite_fwd", "fwd_s")
