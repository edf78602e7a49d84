"""Seconds from the process's start to the first timed call: imports,
inputs from the seed, the port's set-up (the kernels' build or load, the
grid, the optimizer), and one warm call of the window's own shapes."""


def read(run):
    return run.setup_s
