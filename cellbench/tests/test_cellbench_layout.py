"""BENCHMARK.json against the contract, and the harness finding each
configuration, traffic mix and metric by name from its file alone."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from cellbench.run import (
    ROOT, cell_entry, load_json, load_module, reader_path,
)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cellbench/run.py"]
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert reader_path(m["name"]).exists()
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    """Each cell's config, traffic, driver and metrics exist by name, and
    it reports setup_s, another end-to-end metric and a per-layer one."""
    w = cell_entry(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert (ROOT / "cellbench" / "configs" / f"{w['config']}.json").exists()
    traffic = load_json(ROOT / "cellbench" / "traffic"
                        / f"{w['traffic']}.json")
    driver = ROOT / "cellbench" / "drivers" / f"{traffic['driver']}.py"
    assert hasattr(load_module(driver, "t_" + traffic["driver"]), "Cell")
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    assert all(m["moves"] in e2e for m in per)


NEW_METRIC = '''"""Steps a traced segment ran (a test's metric)."""


def read(run):
    return run.units.get("steps")
'''


def test_new_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix and a metric added as new files and
    entries, no existing file edited, run end to end."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "pathtracer_gaussiansplatting_tpu_torch").symlink_to(
        ROOT / "pathtracer_gaussiansplatting_tpu_torch")
    bench = json.loads(json.dumps(BENCH))
    cb = tmp_path / "cellbench"
    cfg = load_json(cb / "configs" / "cloud1m.json")
    cfg.update(name="cloud2k", n=2000, width=32, height=32, rehearsal={})
    (cb / "configs" / "cloud2k.json").write_text(json.dumps(cfg))
    traffic = load_json(cb / "traffic" / "fit.json")
    traffic.update(views=4, rehearsal={})
    (cb / "traffic" / "fit4.json").write_text(json.dumps(traffic))
    (cb / "metrics" / "steps_total.fit4.py").write_text(NEW_METRIC)
    bench["configs"].append(dict(name="cloud2k", source="a test",
                                 file="cellbench/configs/cloud2k.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="fit4.cloud2k", config="cloud2k",
                                   traffic="fit4", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "fit_rays_per_s":
            m["workloads"].append("fit4.cloud2k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, str(cb / "rehearse.py"), "--workload",
         "fit4.cloud2k", "--seconds", "0.5"],
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert set(res["metrics"]) == {"fit_rays_per_s", "setup_s"}
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    # The same cell's per-layer line holds the new reader's metric.
    bench["per_layer"].append(dict(
        name="steps_total.fit4", unit="steps", better="higher",
        source="program_counter", layer="train step and autograd",
        moves="fit_rays_per_s", workloads=["fit4.cloud2k"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    sys.path.insert(0, str(tmp_path))
    try:
        run = load_module(cb / "run.py", "t_run_copy")
        reader = load_module(cb / "metrics" / "steps_total.fit4.py", "t_m")
        assert run.ROOT == tmp_path
        assert reader.read(type("R", (), {"units": {"steps": 7}})()) == 7
    finally:
        sys.path.remove(str(tmp_path))


def copy_with_cell(tmp_path, cell: dict, config: dict = None) -> dict:
    """A copy of the benchmark with one more cell (and its configuration
    file, where one is given) in BENCHMARK.json; no file edited."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "pathtracer_gaussiansplatting_tpu_torch").symlink_to(
        ROOT / "pathtracer_gaussiansplatting_tpu_torch")
    bench = json.loads(json.dumps(BENCH))
    if config is not None:
        path = f"cellbench/configs/{config['name']}.json"
        (tmp_path / path).write_text(json.dumps(config))
        bench["configs"].append(dict(name=config["name"], source="a test",
                                     file=path, reduced=[], why="a test"))
    bench["workloads"].append(dict(cell, chips=1, why="a test"))
    traffic = load_json(ROOT / "cellbench" / "traffic"
                        / f"{cell['traffic']}.json")
    rate = dict(capture="capture_rays_per_s", fit="fit_rays_per_s",
                interact="frame_ms_p95")[traffic["driver"]]
    for m in bench["end_to_end"]:
        if m["name"] == rate:
            m["workloads"].append(cell["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def cloud_capture_config() -> dict:
    """The capture's render settings on the random cloud: a scene named by
    the configuration, not by the driver."""
    cfg = load_json(ROOT / "cellbench" / "configs" / "surface500k.json")
    cfg.update(name="cloudcap", scene="random_cloud", n=2000,
               scene_args=dict(spread=1.5), rehearsal=dict(spp=2, width=32,
                                                           height=32))
    return cfg


@pytest.mark.parametrize("cell,config", [
    (dict(name="fit.surface500k", config="surface500k", traffic="fit"),
     None),
    (dict(name="capture.cloudcap", config="cloudcap", traffic="capture"),
     cloud_capture_config()),
], ids=["fit-on-surface", "capture-on-cloud"])
def test_existing_pieces_pair_without_edits(tmp_path, cell, config):
    """A traffic mix paired with another configuration's scene runs end to
    end on that scene, from entries and data files alone."""
    copy_with_cell(tmp_path, cell, config)
    out = subprocess.run(
        [sys.executable, "cellbench/rehearse.py", "--workload",
         cell["name"], "--seconds", "0.5"],
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


def test_scene_is_the_configurations():
    """The driver makes the scene that the configuration names, and no
    other; an unknown scene is refused."""
    from cellbench import scenes
    cfg = dict(scene="random_cloud", n=64, scene_args=dict(spread=3.0))
    raw = scenes.make(cfg, 5, "cpu")
    assert float(raw["means"].abs().max()) > 1.5    # the spread it names
    assert bool((raw["emission"] == 0).all())
    room = scenes.make(dict(scene="surface_room", n=20000), 5, "cpu")
    assert float(room["emission"].max()) > 0        # the room's panel
    with pytest.raises(ValueError):
        scenes.make(dict(scene="teapot", n=64), 5, "cpu")


def test_no_card_or_no_program_no_result(tmp_path):
    """A run without a CUDA card, or in a directory holding only
    BENCHMARK.json and cellbench/, exits non-zero and prints no result
    (on a machine without a card the first reason ends it)."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "fit.cloud1m", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout
