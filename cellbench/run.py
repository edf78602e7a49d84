"""Run one cell of the benchmark once.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``cellbench/configs/<config>.json``) and its traffic mix
(``cellbench/traffic/<traffic>.json``, whose ``driver`` names the module
under ``cellbench/drivers/`` that drives the port); each metric is read by
``cellbench/metrics/<metric>.py``. A run sets up (inputs from the seed,
the port's objects, one warm call of the window's own shapes), calls the
timed path until ``--seconds`` have passed, fences, and with ``--trace 1``
profiles a few more calls. Then it frees the port's state, holds what the
window produced to the plain reference, and prints one JSON line: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), with each number compared beside its limit last.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cellbench import trace as trace_mod  # noqa: E402

# Top-level modules the run must not hold once the window has closed:
# JAX and the JAX package (compared by whole top-level name; the port's
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_gaussiansplatting_tpu")


class Fail(Exception):
    """A run that prints no result."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Run:
    """What the metric readers read: the window's units of work, its
    seconds and per-call latencies, the set-up seconds, the traced segment
    and the cell's driver (with what its ``trace_extras`` kept)."""

    def __init__(self, cell, driver):
        self.cell, self.driver = cell, driver
        self.units, self.latencies = {}, []
        self.window_s = self.setup_s = 0.0
        self.stages = {}
        self.trace = self.extras = None


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise Fail(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or where a metric has no reader of its own,
    the reader of the name's stem before its first dot
    (``device_idle.fit`` -> ``metrics/device_idle.py``)."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.exists() else \
        BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def verdict(look: dict, limits: dict) -> tuple:
    """([(number, value, limit)], correct) of one comparison's numbers."""
    checks = [(k, look[k], lim) for k, lim in limits.items()]
    return checks, all(v <= lim for _, v, lim in checks)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(device, n: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=n,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(args, device=None, overrides=None, t_start=T_START,
            stand_ins=None) -> dict:
    """One run of the cell; returns the result's dict. ``device`` and
    ``overrides`` (config and traffic keys set over the files', the CPU
    rehearsal's tiny sizes) are for ``cellbench/rehearse.py``; each of
    ``stand_ins`` (the driver's stand-ins: the reference in the program's
    place in a lower precision, or with a planted fault) is judged after
    the program, and the numbers of the program and of each, limited or
    not, go under ``looks`` (``cellbench/control.py``; none where
    ``stand_ins`` is None).
    """
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_entry(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Fail(f"{cell['chips']} cards asked, "
                       f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    for key, part in (overrides or {}).items():
        (config if key == "config" else traffic).update(part)
    driver_mod = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                             f"cellbench_driver_{traffic['driver']}")
    driver = driver_mod.Cell(config, traffic, args.seed, device)
    run = Run(cell, driver)

    t_setup = time.perf_counter()
    # The seconds the reference spent making the cell's inputs (the fit's
    # targets) are no set-up of the program's: timed apart, left out.
    reference_s = driver.setup()
    sync(device)
    run.setup_s = time.perf_counter() - t_start - reference_s
    run.stages.update(before_setup=t_setup - t_start,
                      setup=time.perf_counter() - t_setup - reference_s,
                      reference_inputs=reference_s)
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        for k, v in driver.call().items():
            run.units[k] = run.units.get(k, 0) + v
        run.latencies.append(time.perf_counter() - c0)
        if time.perf_counter() - t0 >= args.seconds:
            break
    sync(device)
    run.window_s = time.perf_counter() - t0
    if args.trace:
        n = traffic["trace_calls"]
        run.extras = driver.trace_extras(n)
        if device.type == "cuda":
            run.trace = trace_mod.traced(driver.call, n)
    info = device_info(device, cell["chips"])
    driver.release()
    t_check = time.perf_counter()
    look = driver.check()
    checks, correct = verdict(look, traffic["limits"])
    run.stages["check"] = time.perf_counter() - t_check
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, args.workload, section):
        reader = load_module(reader_path(m["name"]),
                             "cellbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    result = dict(correct=correct, attempted=run.units.get("calls", 0),
                  failed=0, metrics=metrics, device=info)
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        result["breakdown"] = dict(device_ops=run.trace.device_ops(),
                                   idle_gaps=run.trace.host.idle_gaps())
    if stand_ins is not None:
        result["looks"] = dict(program=look,
                               **{s: driver.check(s) for s in stand_ins})
    lat = run.latencies
    half = len(lat) // 2
    srt = sorted(lat)
    result["timings"] = dict(
        run.stages, window=run.window_s, calls=len(lat), call_min=srt[0],
        call_median=srt[len(srt) // 2], call_max=srt[-1],
        # the mean call of the window's first and second halves: how far
        # a run drifts within its window
        first_half=sum(lat[:half]) / max(half, 1),
        second_half=sum(lat[half:]) / max(len(lat) - half, 1))
    result["checks"] = {name: dict(value=v, limit=lim)
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = execute(args)
    except Fail as err:
        print(f"cellbench: {err}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"cellbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("cellbench: seconds " + " ".join(
        f"{k}={v:.4g}" for k, v in result.pop("timings").items()),
        file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
