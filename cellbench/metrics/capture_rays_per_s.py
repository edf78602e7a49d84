"""Camera-ray samples completed in the window (pixels x samples of every
pose rendered), over the window's seconds up to the fence after the last
call."""


def read(run):
    n = run.units.get("camera_rays")
    return n / run.window_s if n else None
