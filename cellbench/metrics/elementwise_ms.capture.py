"""Device ms a sample in kernels that are not the port's hand kernels: the
bounce loop's and the shading's elementwise work (BSDF, NEE, lights,
accumulation), its gathers, the binning's sort."""
from cellbench.metrics._lib import kernel_ms_per, not_hand


def read(run):
    return kernel_ms_per(run, not_hand, "samples")
