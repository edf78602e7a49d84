"""Device ms a path-traced sample in the grid march kernels K3/K4
(``csrc/grid_march.cu``); an interactive frame is one sample
(``grid_march_ms.<cell kind>``: one reader for each cell's metric)."""
from cellbench.metrics._lib import kernel_ms_per


def read(run):
    return kernel_ms_per(run, lambda n: "grid_march_kernel" in n, "samples")
