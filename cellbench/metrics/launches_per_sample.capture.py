"""Kernel launches on the card a path-traced sample, in the traced
segment."""


def read(run):
    tr = run.trace
    if tr is None or not tr.units.get("samples"):
        return None
    return tr.kernel_count() / tr.units["samples"]
