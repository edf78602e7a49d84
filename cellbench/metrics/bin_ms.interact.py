"""Device ms a binning (an instance of the span ``ptgs.bin``: the frame
after a camera move bins the scene anew) in the traced frames, the work
credited by launch (``_spans.py``)."""
from cellbench.metrics._spans import host_spans


def read(run):
    got = host_spans(run, "ptgs.bin", "frames")
    if got is None:
        return None
    sp, _ = got
    return 1e3 * sp.device_s("ptgs.bin") / sp.count("ptgs.bin")
