"""Read the numbers that decide ``correct`` for the program and for its
stand-ins, seed after seed, in one process (set-up is most of a run).

    python3 cellbench/control.py --workload <name> --seconds <s>
        --seeds <n> [<n> ...] [--stand-ins lowp [half ...]]

For each seed: one run of the cell as ``run.py`` makes it (a window of
``--seconds``), then the comparison for the program and for each stand-in
(the reference in the program's place: ``lowp`` in bfloat16, the control;
``half``, for training, with half the image rows left out of the loss, a
planted fault). One JSON line a seed; the limits in the traffic file are
set from these readings (``PERF.md``). On the card only.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if str(Path(__file__).resolve().parent.parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cellbench.run import execute  # noqa: E402


def readings(workload: str, seeds, seconds: float, stand_ins=("lowp",),
             device=None, overrides=None):
    """[{seed, program: {number: value}, <stand-in>: {...}, metrics}] a
    seed; the numbers include those the comparison shows but does not
    hold to a limit (the look behind a number)."""
    out = []
    for seed in seeds:
        args = argparse.Namespace(workload=workload, seed=seed,
                                  seconds=seconds, trace=0)
        res = execute(args, device=device, overrides=overrides,
                      t_start=time.perf_counter(), stand_ins=stand_ins)
        row = dict(seed=seed, **res["looks"])
        row["metrics"] = {k: m["value"] for k, m in res["metrics"].items()}
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--stand-ins", nargs="*", default=["lowp"])
    a = ap.parse_args(argv)
    readings(a.workload, a.seeds, a.seconds, tuple(a.stand_ins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
