"""The port's two multi-device tools against the JAX package's scripts, on
the CPU: ``tools/scaling.py`` (``benchmarks/scaling.py``: ray-parallel
weak scaling on spawned gloo worlds of 1 and 2 ranks, and the Gaussian
ring at 2) against the JAX functions on the 8-virtual-device mesh of
tests/conftest.py cut to the same shape, and ``tools/spatial_chip.py``
(``benchmarks/spatial_chip.py``: one slab's dense step and grid march)
against the JAX functions on the same slab. The JAX spatial script is
never run here: it writes the root's SPATIAL_CHIP_r05.json."""
import ast
import importlib.util
import io
import json
import math
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import (
    Camera as JCamera, generate_rays as j_generate_rays, look_at as j_look_at,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud, surface_scene as j_surface_scene,
)
from pathtracer_gaussiansplatting_tpu.parallel import mesh as jmesh
from pathtracer_gaussiansplatting_tpu.parallel import shard as jshard
from pathtracer_gaussiansplatting_tpu.parallel import spatial as jspatial
from pathtracer_gaussiansplatting_tpu.render import grid_trace as jgt
from pathtracer_gaussiansplatting_tpu_torch.render import grid_trace as tgt
from pathtracer_gaussiansplatting_tpu_torch.tools import scaling, spatial_chip

from torch_parity import CPU, np_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_parallel.py's tolerance for the sharded renderers'
# radiance against the JAX package's (test_dense_ray_sharded_matches,
# test_ring_topk_matches).
RTOL, ATOL = 2e-4, 2e-6
# tests/test_torch_spatial.py's: the slab ring's interaction, and the grid
# slabs (the march's XLA FMA allowance) on the keys test_grid_slabs_match
# holds.
SLAB_RTOL, SLAB_ATOL = 3e-4, 3e-4
GRID_RTOL, GRID_ATOL = 1e-4, 2e-4
# The grid tables: tests/test_torch_grid_trace.py::
# test_build_grid_accel_matches's gate (1e-6 of the table's scale).
TABLE_RTOL = 1e-6
# The march is held to the JAX package's run op by op (jax.disable_jit),
# as tests/test_torch_downstream.py holds the binning: on surface_scene's
# thin surfels XLA's jitted march contracts the quadratic's multiply-adds
# into FMAs, which moved trans by up to 2.2e-3 on 13 of the 256 rays
# against the port (and against the JAX package's own op-by-op march);
# op by op on the same tables the port came within 1.7e-6.
GRID_KEYS = ("trans", "albedo", "depth", "alpha_acc", "normal")
# The sizes: the scripts' code paths at a few hundred Gaussians.
N_GAUSS, RAYS_PER_DEVICE = 200, 64
SPATIAL = dict(n=4000, n_slabs=4, rays=64, rays_grid=256)
SPATIAL_ENV = dict(zip(("GSPT_SPATIAL_N", "GSPT_SPATIAL_SLABS",
                        "GSPT_SPATIAL_RAYS", "GSPT_SPATIAL_RAYS_GRID"),
                       SPATIAL.values()))
# benchmarks/spatial_chip.py's link keys and the port's in their place.
LINK_KEYS = {"comm_ms_at_45GBps": "comm_ms_at_link"}


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _load_script(name: str):
    """A JAX script of benchmarks/ as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"gspt_script_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _j_rays(nd):
    """The script's rays_for(nd) at the test's size."""
    return j_generate_rays(JCamera(c2w=j_look_at((0, 0.5, 4.0), (0, 0, 0)),
                                   fov_y_deg=50.0, width=RAYS_PER_DEVICE,
                                   height=nd))


@pytest.fixture(scope="module")
def scaling_run():
    """The port's tool on the CPU at 2 ranks: worlds of 1 and 2 spawned
    gloo ranks (each with a deadline), the ring in the second."""
    with torch.no_grad():
        return scaling.run_scaling(n_gauss=N_GAUSS,
                                   rays_per_device=RAYS_PER_DEVICE, iters=1,
                                   ranks=2, device=CPU)


@pytest.mark.parametrize("nd", [1, 2])
def test_ray_dp_matches(scaling_run, nd):
    """run_ray_dp's gathered image on a world of nd ranks against the JAX
    render_dense_ray_sharded on the (nd, 1) mesh."""
    mesh = jmesh.make_mesh((nd, 1), devices=jax.devices()[:nd])
    want = jshard.render_dense_ray_sharded(
        j_random_cloud(N_GAUSS, seed=13, spread=1.2), _j_rays(nd),
        JRenderSettings(max_contribs=32), mesh)
    got = scaling_run["images"][nd]
    assert got.shape == (RAYS_PER_DEVICE * nd, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ring_matches(scaling_run):
    """The ring at (1, 2), padded and sharded as the script does, against
    the JAX ring_topk_radiance; the tool reports it functional."""
    mesh = jmesh.make_mesh((1, 2), devices=jax.devices()[:2])
    scene = j_random_cloud(N_GAUSS, seed=13, spread=1.2)
    sharded = jmesh.shard_scene(jmesh.pad_to_multiple(scene, 2), mesh)
    rays = _j_rays(1)
    place = jmesh.ray_sharding(mesh)
    want = jshard.ring_topk_radiance(
        sharded, JRays(jax.device_put(rays.origins, place),
                       jax.device_put(rays.directions, place)),
        JRenderSettings(max_contribs=32), mesh)
    np.testing.assert_allclose(scaling_run["ring_image"], np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    ring = [ln for ln in scaling_run["lines"] if ln.get("mode") ==
            "gauss-ring"]
    assert ring == [dict(mode="gauss-ring", devices=2, functional_ok=True)]


def test_scaling_lines_match_the_script(scaling_run):
    """The tool's lines against benchmarks/scaling.py's (main at a small
    size, its stdout captured): the same modes, the same keys a mode, the
    same summary keys; the world sizes past --ranks are reported, not
    run."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        _load_script("scaling").main(n_gauss=N_GAUSS, rays_per_device=32,
                                     iters=1)
    want = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    got = scaling_run["lines"]

    def keys_by_mode(lines):
        out = {}
        for ln in lines:
            if "skipped" not in ln:
                out.setdefault(ln.get("mode", "summary"), set()).update(ln)
        return out

    assert keys_by_mode(got) == keys_by_mode(want)
    assert [ln["devices"] for ln in want if ln.get("mode") == "ray-dp"] == \
        [1, 2, 4, 8]
    dp = [ln for ln in got if ln.get("mode") == "ray-dp"]
    assert [ln["devices"] for ln in dp] == [1, 2, 4, 8]
    assert all("needs" in ln["skipped"] for ln in dp[2:])
    assert all(ln["rays_per_s"] > 0 for ln in dp[:2])
    summary = json.loads(json.dumps(got[-1]))
    assert set(summary["efficiencies"]) == {"1", "2"}
    assert summary["efficiencies"]["1"] == 1.0
    assert "ICI" not in summary["summary"]
    assert "NVLink" not in summary["summary"]


@pytest.fixture(scope="module")
def slab_run():
    """The port's spatial tool at the test's size on the CPU, and the JAX
    script's slab 0, grid and rays at the same size."""
    step = spatial_chip.slab_step(device=CPU, **SPATIAL)
    spatial_chip.measure(step, SPATIAL["n_slabs"])
    s = SPATIAL["n_slabs"]
    slabbed, axis = jspatial.partition_slabs(
        j_surface_scene(SPATIAL["n"], seed=13), s)
    nb = slabbed.num_gaussians // s
    rng = np.random.default_rng(0)

    def rays(r):
        o = rng.uniform(-1.2, 1.2, (r, 3)).astype(np.float32)
        d = rng.normal(size=(r, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    return dict(step=step, slabbed=slabbed, axis=axis,
                block=jax.tree.map(lambda x: x[:nb], slabbed),
                rays=rays(SPATIAL["rays"]),
                rays_grid=rays(SPATIAL["rays_grid"]))


def test_slab_step_matches(slab_run):
    """The dense slab step (the table built once) against the JAX
    _slab_interaction_feats on the same slab and rays: feats (R, 15) and
    trans (R,)."""
    step = slab_run["step"]
    o, d = slab_run["rays"]
    np.testing.assert_array_equal(np_of(step.origins), np.asarray(o))
    feats, trans = jspatial._slab_interaction_feats(
        slab_run["block"], o, d, jnp.asarray(slab_run["axis"]),
        JRenderSettings())
    assert step.feats.shape == (SPATIAL["rays"], 15)
    np.testing.assert_allclose(np_of(step.feats), np.asarray(feats),
                               rtol=SLAB_RTOL, atol=SLAB_ATOL)
    np.testing.assert_allclose(np_of(step.trans), np.asarray(trans),
                               rtol=SLAB_RTOL, atol=SLAB_ATOL)
    assert float(np.asarray(trans).min()) < 0.99   # the rays hit the slab


def test_grid_slab_matches(slab_run):
    """The grid slab: slab 0's grid from the tool (build_slab_accels, with
    its fill) against the JAX build_slab_accels' slab 0, and the tool's
    trace_grid on it against the JAX trace_grid on the same tables, run
    op by op."""
    tables, meta = jspatial.build_slab_accels(slab_run["slabbed"],
                                              SPATIAL["n_slabs"])
    got_accel = slab_run["step"].accel
    assert got_accel.dims == meta.dims
    assert got_accel.jump_unit == meta.jump_unit
    assert np.array_equal(np_of(got_accel.btab), np.asarray(tables["btab"][0]))
    for key in ("geom", "packet", "lo", "hi"):
        w = np.asarray(tables[key][0])
        np.testing.assert_allclose(np_of(getattr(got_accel, key)), w,
                                   rtol=TABLE_RTOL,
                                   atol=TABLE_RTOL * np.abs(w).max(),
                                   err_msg=key)
    kc = got_accel.max_per_cell
    jgeom = np.asarray(tables["geom"][0]).reshape(-1, tgt.GEOM_COLS, kc)
    np.testing.assert_array_equal(np_of(got_accel.fill),
                                  (jgeom[:, tgt.G_OPAC] > 0).sum(-1))
    accel = jgt.GridAccel(
        **{k: jnp.asarray(np_of(getattr(got_accel, k)))
           for k in ("btab", "geom", "packet", "lo", "hi")},
        dims=got_accel.dims, jump_unit=got_accel.jump_unit)
    with jax.disable_jit():
        want = jgt.trace_grid(slab_run["block"],
                              JRays(*slab_run["rays_grid"]),
                              JRenderSettings(), accel)
    got = slab_run["step"].trace
    for key in GRID_KEYS:
        np.testing.assert_allclose(np_of(got[key]), np.asarray(want[key]),
                                   rtol=GRID_RTOL, atol=GRID_ATOL,
                                   err_msg=key)
    assert int(got["frozen_alive"]) == int(want["frozen_alive"])
    assert float(np_of(got["alpha_acc"]).max()) > 0.5


def _script_result_keys() -> dict:
    """The keys of benchmarks/spatial_chip.py's result dict (:114-138),
    read from its source: {key: None, or the nested dict's keys}."""
    with open(os.path.join(ROOT, "benchmarks", "spatial_chip.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "result"):
            return {kw.arg: ({k.arg: None for k in kw.value.keywords}
                             if isinstance(kw.value, ast.Call) else None)
                    for kw in node.value.keywords}
    raise AssertionError("no result dict in benchmarks/spatial_chip.py")


def test_spatial_chip_main_keys_and_root_file(tmp_path, monkeypatch, capsys):
    """tools/spatial_chip.main end to end on the CPU: the script's keys,
    the link keys mapped and named, table_build_ms and device beside them;
    the line printed and spatial_chip.json written under GSPT_SPATIAL_DIR;
    the root's SPATIAL_CHIP_r05.json (a TPU figure) untouched."""
    root_file = os.path.join(ROOT, "SPATIAL_CHIP_r05.json")
    with open(root_file, "rb") as fh:
        before = fh.read()
    for k, v in SPATIAL_ENV.items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setenv("GSPT_SPATIAL_DIR", str(tmp_path))
    result = spatial_chip.main(["--device", "cpu"])
    with open(root_file, "rb") as fh:
        assert fh.read() == before

    want = _script_result_keys()

    def mapped(keys):
        return {LINK_KEYS.get(k, k) for k in keys}

    assert set(result) == mapped(want) | {"link_GBps", "link_source",
                                          "table_build_ms"}
    assert set(result["grid_slab"]) == mapped(want["grid_slab"])
    assert result["device"] == "cpu"
    assert result["link_GBps"] == spatial_chip.LINK_GBPS == 450.0
    assert "assumed" in result["link_source"]
    assert "no ring across cards is measured" in result["grid_slab"]["note"]
    assert result["carry_bytes_per_ray_step"] == 284
    assert result["slab_gaussians"] == SPATIAL["n"] // SPATIAL["n_slabs"]
    flat = dict(result, **{f"grid_slab/{k}": v
                           for k, v in result["grid_slab"].items()})
    assert all(math.isfinite(v) and v > 0 for v in flat.values()
               if isinstance(v, (int, float)))
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[0]) == result
    with open(tmp_path / "spatial_chip.json") as fh:
        assert json.load(fh) == result
    assert "45GBps" not in json.dumps(result)


@pytest.mark.parametrize("tool", [scaling, spatial_chip],
                         ids=["scaling", "spatial_chip"])
def test_tools_take_the_card_by_default(tool):
    """Without --device each tool takes the CUDA card, and raises where
    there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
