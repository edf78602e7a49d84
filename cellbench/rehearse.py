"""Rehearse a cell on the CPU at a tiny size, end to end.

    python3 cellbench/rehearse.py --workload <name> [--seed n]
        [--seconds 1] [--trace 0|1] [--stand-ins lowp half ...]

The same set-up, window, comparison and metric readers as ``run.py``, with
the port's plain versions in place of its CUDA kernels and the sizes of
each file's ``rehearsal`` block, so that a cell's first run on the card
takes no path the CPU has not taken. No number it prints is a device
figure: there is no trace, and its rates are the CPU's. Each of
``--stand-ins`` is judged after the program, its numbers under ``looks``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if str(Path(__file__).resolve().parent.parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cellbench.run import (  # noqa: E402
    BENCH_DIR, ROOT, cell_entry, execute, load_json,
)


def rehearse(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
             trace: int = 0, stand_ins=(), overrides=None) -> dict:
    """One run of ``workload`` on the CPU at the rehearsal's sizes;
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) are set over
    those."""
    cell = cell_entry(load_json(ROOT / "BENCHMARK.json"), workload)
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    sizes = dict(config=dict(config.get("rehearsal", {})),
                 traffic=dict(traffic.get("rehearsal", {})))
    for key, part in (overrides or {}).items():
        sizes[key].update(part)
    return execute(args, device="cpu", t_start=time.perf_counter(),
                   overrides=sizes, stand_ins=tuple(stand_ins))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--stand-ins", nargs="*", default=[])
    a = ap.parse_args(argv)
    print(json.dumps(rehearse(a.workload, a.seed, a.seconds, a.trace,
                              a.stand_ins)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
