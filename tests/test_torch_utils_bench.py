"""The port's utils/logging, utils/profiling, data/images.srgb_to_linear,
the grid truncation warning and the bench (CPU): the logging and profiling
helpers and the sRGB decode against the JAX package's on numpy-seeded
inputs; a tiny bench.run; BenchConfig against the root bench.py's
defaults and variables; ``cli bench``."""
import ast
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.data import images as jimages
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.render import grid_trace as jgt
from pathtracer_gaussiansplatting_tpu.utils import logging as jlogging
from pathtracer_gaussiansplatting_tpu.utils import profiling as jprof
from pathtracer_gaussiansplatting_tpu_torch import bench
from pathtracer_gaussiansplatting_tpu_torch import cli as tcli
from pathtracer_gaussiansplatting_tpu_torch.data import images as timages
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt
from pathtracer_gaussiansplatting_tpu_torch.utils import logging as tlogging
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling as tprof

from torch_parity import CPU, TORCH_THREADS, gspt_log, to_torch_scene

torch.set_num_threads(TORCH_THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A tiny bench: every workload at a few hundred to a thousand rays.
TINY = bench.BenchConfig(n=2000, res=32, iters=2, k=32, spp=4, pt_n=2000,
                         pt_w=32, pt_h=24, pt_depth=2, pt12_w=32, pt12_h=24,
                         pose_spp=1, pose_width=32, pose_height=32)


def reference_bench():
    """(the root bench.py's result keys, {variable: default expression})."""
    return bench.reference_bench(os.path.join(ROOT, "bench.py"))


# ---- utils/logging and utils/profiling against the JAX package ----------

def test_metrics_logger_matches(tmp_path, caplog):
    rng = np.random.default_rng(3)
    records = [(int(i), dict(rays_per_s=float(rng.uniform(1e5, 1e7)),
                             loss=float(rng.uniform(0, 1))))
               for i in range(4)]
    lines = []
    for mod, name in ((jlogging, "ref.jsonl"), (tlogging, "port.jsonl")):
        path = str(tmp_path / name)
        m = mod.MetricsLogger(path)
        for step, metrics in records:
            m.log(step, **metrics)
        m.close()
        with open(path) as fh:
            lines.append([json.loads(line) for line in fh])
    for got, want in zip(*lines[::-1]):
        assert got.pop("ts") > 0 and want.pop("ts") > 0
        assert got == want
    # Without a path each record goes to the gspt logger.
    step, metrics = records[0]
    messages = []
    for mod in (jlogging, tlogging):
        caplog.clear()
        with gspt_log(caplog, logging.INFO):
            mod.MetricsLogger().log(step, **metrics)
        messages.append([(r.name, r.getMessage()) for r in caplog.records])
    assert messages[1] == messages[0] and len(messages[0]) == 1
    logger = tlogging.get_logger()
    assert logger.name == "gspt" and not logger.propagate
    assert logger is tlogging.get_logger() and len(logger.handlers) == 1


def test_fence_matches():
    """The float sum of every leaf (tensors and a numpy scalar) of nested
    dicts, lists, tuples and scenes, as the JAX fence returns it."""
    rng = np.random.default_rng(5)
    arrays = dict(a=rng.normal(size=(64, 3)).astype(np.float32),
                  b=[rng.uniform(0, 2, size=(17,)).astype(np.float32),
                     (rng.normal(size=(4, 4, 4)).astype(np.float32),)],
                  c=np.int32(7))
    js = j_random_cloud(300, seed=9)

    def jax_tree(x):
        return dict(a=jnp.asarray(x["a"]),
                    b=[jnp.asarray(x["b"][0]), (jnp.asarray(x["b"][1][0]),)],
                    c=x["c"])

    def torch_tree(x):
        return dict(a=torch.from_numpy(x["a"]),
                    b=[torch.from_numpy(x["b"][0]),
                       (torch.from_numpy(x["b"][1][0]),)],
                    c=x["c"])

    want = jprof.fence(jax_tree(arrays), js)
    got = tprof.fence(torch_tree(arrays), to_torch_scene(js))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6)
    assert tprof.fence() == 0.0 == jprof.fence()


def test_device_timer_fills_holder():
    for mod, tree in ((jprof, jnp.ones(8)), (tprof, torch.ones(8))):
        holder = {}
        with mod.device_timer("render", holder) as out:
            out["result"] = tree * 2
        with mod.device_timer(result_holder=holder):
            pass
        assert sorted(holder) == ["elapsed", "render"]
        assert all(v >= 0 for v in holder.values())


def test_device_memory_stats_keys():
    want = jprof.device_memory_stats()
    got = tprof.device_memory_stats(device="cpu")
    assert len(got) == 1 and sorted(got[0]) == sorted(want[0])
    assert got[0]["device"] == "cpu"
    assert got[0]["used_mib"] == got[0]["limit_mib"] == got[0]["peak_mib"] \
        == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_memory_stats()


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)):
        torch.ones(256).cumsum(0).sum()
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".json")
    with open(files[0]) as fh:
        assert json.load(fh)["traceEvents"]


def test_srgb_to_linear_bit_equal():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.uniform(-0.2, 1.2, 4000),
        [0.0, 1.0, -1.0, 2.0, 0.04045, np.nextafter(0.04045, 0.0),
         np.nextafter(0.04045, 1.0)]])
    want = jimages.srgb_to_linear(x)
    got = timages.srgb_to_linear(x)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert np.array_equal(timages.srgb_to_linear(x.astype(np.float32)),
                          jimages.srgb_to_linear(x.astype(np.float32)))


def test_grid_truncation_warning_matches(caplog):
    """A grid of 2^3 cells of at most 16 Gaussians drops most of 600
    insertions: the warning goes to the gspt logger with the reference's
    whole message."""
    js = j_random_cloud(600, seed=13)
    kw = dict(dims=(2, 2, 2), max_per_cell=16)
    messages = []
    for build, scene in ((jgt.build_grid_accel, js),
                         (tgt.build_grid_accel, to_torch_scene(js))):
        caplog.clear()
        with gspt_log(caplog):
            build(scene, **kw)
        messages.append([(r.name, r.levelno, r.getMessage())
                         for r in caplog.records])
    assert messages[1] == messages[0] and len(messages[0]) == 1
    name, level, text = messages[0][0]
    assert name == "gspt" and level == logging.WARNING
    assert text.startswith("grid_accel truncation:")
    assert text.endswith("— raise max_per_cell or radius_percentile if "
                         "fringe coverage matters")


# ---- the bench ------------------------------------------------------------

def test_bench_run_tiny():
    keys, _ = reference_bench()
    res = bench.run(TINY, device=CPU)
    assert sorted(res) == sorted(bench.REPLACED_KEYS.get(k, k) for k in keys)
    numbers = {k: v for k, v in res.items() if isinstance(v, (int, float))}
    assert len(numbers) == len(res) - 7   # the strings: metric, unit,
    # the three configs, the note and the device
    for k, v in numbers.items():
        assert math.isfinite(v) and v > 0, (k, v)
    amortized = TINY.spp * TINY.res ** 2 / (
        (res["binning_ms_per_pose"] + TINY.spp * res["sample_ms"]) * 1e-3)
    assert abs(res["value"] - amortized) <= 0.5 + 1e-9 * amortized
    assert res["per_sample_rays_per_s"] == round(
        TINY.res ** 2 / (res["sample_ms"] * 1e-3))
    assert res["mfu"] <= 1.0 and res["fwd_bound_share"] <= 1.0
    assert res["pathtrace_config"] == "2000 gaussians, 32x24, depth 2, " \
        "grid backend"
    assert res["device"] == "cpu" and res["unit"] == "rays/s"


def test_bench_config_from_env(monkeypatch):
    """BenchConfig's defaults are the root bench.py's literals (PT12_W and
    PT12_H default to the path trace's size there), and each variable it
    reads is honored."""
    _, env = reference_bench()
    assert set(env) - {"GSPT_BENCH_PT12_CHUNKS"} == {
        f"GSPT_BENCH_{f.upper()}" for f in bench.BenchConfig.ENV_FIELDS}
    default = bench.BenchConfig()
    for var, expr in env.items():
        if var == "GSPT_BENCH_PT12_CHUNKS":
            continue
        field = var[len("GSPT_BENCH_"):].lower()
        want = expr.value if isinstance(expr, ast.Constant) \
            else getattr(default, expr.id)
        assert getattr(default, field) == want, var
    assert (default.pose_width, default.pose_height, bench.POSE_FOV) == \
        (800, 800, 45.0)
    for k in list(os.environ):
        if k.startswith("GSPT_BENCH_"):
            monkeypatch.delenv(k)
    assert bench.BenchConfig.from_env() == default
    for field in bench.BenchConfig.ENV_FIELDS:
        value = getattr(default, field) + 3
        got = bench.BenchConfig.from_env({f"GSPT_BENCH_{field.upper()}":
                                          str(value)})
        changed = {f.name for f in dataclasses.fields(got)
                   if getattr(got, f.name) != getattr(default, f.name)}
        follows = {"pt_w": {"pt12_w"}, "pt_h": {"pt12_h"}}.get(field, set())
        assert changed == {field} | follows and getattr(got, field) == value
    monkeypatch.setenv("GSPT_BENCH_POSE_SPP", "512")
    monkeypatch.setenv("GSPT_BENCH_PT_W", "640")
    monkeypatch.setenv("GSPT_BENCH_PT12_W", "320")
    got = bench.BenchConfig.from_env()
    assert (got.pose_spp, got.pt_w, got.pt12_w, got.pt12_h) == \
        (512, 640, 320, 1080)


def test_cli_bench_reaches_main(monkeypatch, capsys):
    calls = []

    def stub(config, device=None):
        calls.append((config, device))
        return dict(value=1, device=str(device))

    monkeypatch.setattr(bench, "run", stub)
    tcli.main(["bench", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == dict(value=1, device="cpu")
    assert calls == [(bench.BenchConfig.from_env(), "cpu")]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["bench"])


def test_port_modules_import_without_jax():
    code = ("import sys\n"
            "import pathtracer_gaussiansplatting_tpu_torch.bench\n"
            "import pathtracer_gaussiansplatting_tpu_torch.cli\n"
            "import pathtracer_gaussiansplatting_tpu_torch.utils.logging\n"
            "import pathtracer_gaussiansplatting_tpu_torch.utils.profiling\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

