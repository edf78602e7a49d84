"""Training pixels completed in the window (steps x width x height), over
the window's seconds up to the fence after the last step."""


def read(run):
    n = run.units.get("train_rays")
    return n / run.window_s if n else None
