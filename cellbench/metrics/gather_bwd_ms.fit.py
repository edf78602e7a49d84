"""Device ms a training step in the packet gathers' backward, PyTorch's
``indexing_backward_kernel``."""
from cellbench.metrics._lib import kernel_ms_per


def read(run):
    return kernel_ms_per(run, lambda n: "indexing_backward" in n, "steps")
