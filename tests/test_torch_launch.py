"""The launch layer of the hand kernels (kernels/launch.py), on the CPU.

- Each SIGNATURES entry matches its ``extern "C"`` declaration in
  csrc/*.cu, parsed from the source: the same name, parameter count and C
  types; and every entry point has an entry.
- The dispatch check: CPU inputs go to the plain versions; mixed devices
  raise ValueError; a card other than sm_90 raises RuntimeError.
- The input check names the kernel and the key of a tensor of the wrong
  shape, dtype, contiguity or alignment.
- Each wrapper on CPU tensors leaves launch.launches untouched.
"""
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.csrc import build
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace as dt
from pathtracer_gaussiansplatting_tpu_torch.kernels import grid_march
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import threefry as k5
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc
from pathtracer_gaussiansplatting_tpu_torch.kernels import (
    tile_composite_variants as tv,
)

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def declarations() -> dict:
    """Each extern "C" entry point of csrc/*.cu: its parameters' ctypes
    types (any pointer a void pointer), from the source text."""
    out = {}
    for src in sorted(Path(build.CSRC_DIR).glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            types_ = []
            for param in params.split(","):
                c_type = re.sub(r"\bconst\b", "",
                                param.rsplit(None, 1)[0]).strip()
                types_.append(ctypes.c_void_p if "*" in param
                              else C_TYPES[c_type])
            out[name] = types_
    return out


def test_every_entry_point_has_a_signature():
    assert sorted(declarations()) == sorted(launch.SIGNATURES)
    assert len(launch.SIGNATURES) == 15


@pytest.mark.parametrize("entry", sorted(launch.SIGNATURES))
def test_signature_matches_declaration(entry):
    want = declarations()[entry]
    got = launch.SIGNATURES[entry]
    assert len(got) == len(want)
    assert got == want


def fake(device: str):
    """A stand-in with a device only: the dispatch check reads nothing
    else, so CUDA devices are named without a card."""
    return types.SimpleNamespace(device=torch.device(device))


@pytest.mark.parametrize("devices, capability, outcome", [
    (("cpu", "cpu"), None, True),
    (("cpu", "meta"), None, ValueError),
    (("meta", "cpu"), None, ValueError),
    (("cuda:0", "cuda:1"), (9, 0), ValueError),
    (("cuda:0", "cpu"), (9, 0), ValueError),
    (("cuda:0", "cuda:0"), (8, 0), RuntimeError),
    (("cuda:0", "cuda:0"), (9, 0), False),
])
def test_dispatch(monkeypatch, devices, capability, outcome):
    """on_cpu: True for CPU inputs, False for one Hopper card; ValueError
    for mixed devices (CPU and meta, two cards), RuntimeError off sm_90."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "a card")
    tensors = {f"x{i}": fake(d) for i, d in enumerate(devices)}
    if isinstance(outcome, bool):
        assert launch.on_cpu("k", tensors) is outcome
    else:
        match = "CPU or all on one CUDA device" if outcome is ValueError \
            else "sm_90a"
        with pytest.raises(outcome, match=f"^k: .*{match}"):
            launch.on_cpu("k", tensors)


@pytest.mark.parametrize("change, key", [
    (dict(a=torch.zeros(3, 4)), "a"),                        # shape
    (dict(a=torch.zeros(2, 3, dtype=torch.float64)), "a"),   # dtype
    (dict(a=torch.zeros(3, 2).t()), "a"),                    # contiguity
    (dict(b=torch.zeros(5, dtype=torch.int64)), "b"),        # stated dtype
    (dict(c=torch.zeros(9)[1:]), "c"),                       # alignment
])
def test_check_names_kernel_and_key(change, key):
    """check passes good inputs and raises ValueError naming the kernel and
    the key of the bad one."""
    good = dict(a=torch.zeros(2, 3), b=torch.zeros(5, dtype=torch.int32),
                c=torch.zeros(8))
    expect = dict(a=(2, 3), b=(5,), c=(8,))
    kw = dict(dtypes=dict(b=torch.int32), aligned=("c",))
    launch.check("my_kernel", good, expect, **kw)
    with pytest.raises(ValueError, match=f"^my_kernel: {key} must"):
        launch.check("my_kernel", dict(good, **change), expect, **kw)


def _tile_inputs():
    g = torch.Generator().manual_seed(3)
    t_total, p, k = 2, 32, 16
    geom = torch.zeros(t_total, tc.GEOM_ROWS, k)
    geom[:, :3] = 1.0
    geom[:, tc.ROW_OPAC] = 0.5 * torch.rand(t_total, k, generator=g)
    dirs = torch.nn.functional.normalize(
        torch.randn(t_total, p, 3, generator=g), dim=-1)
    packets = dict(geom=geom,
                   featsT=torch.rand(t_total, tc.FEATURE_DIM, k, generator=g),
                   count=torch.full((t_total,), float(k)))
    cot = (torch.ones(t_total, p, tc.FEATURE_DIM), torch.ones(t_total, p),
           torch.zeros(t_total, p))
    return packets, dirs, cot


def _dense_inputs():
    g = torch.Generator().manual_seed(5)
    n, r = 40, 8
    table = torch.zeros(n, dt.TABLE_COLS)
    table[:, :3] = torch.randn(n, 3, generator=g)
    table[:, 3:12] = torch.eye(3).reshape(9) * 4.0
    table[:, 12] = 0.5
    table[:, 13:] = 1.0
    o = torch.zeros(r, 3)
    o[:, 2] = -4.0
    d = torch.nn.functional.normalize(
        torch.randn(r, 3, generator=g) * 0.1 + torch.tensor([0., 0., 1.]),
        dim=-1)
    return o, d, table


def _wrappers():
    s = RenderSettings()

    def fwd():
        packets, dirs, _ = _tile_inputs()
        tc.tile_composite(packets, dirs, s)

    def bwd():
        packets, dirs, cot = _tile_inputs()
        tc.tile_composite_bwd(packets, dirs, cot, s, want_dirs=False)

    def gather_bwd():
        t_total, k, n = 2, 8, 5
        tc.packet_gather_bwd(torch.ones(t_total, tc.GEOM_ROWS, k),
                             torch.ones(t_total, 3, k),
                             torch.zeros(t_total, k, dtype=torch.int32),
                             torch.ones(t_total, k, dtype=torch.bool), n)

    def variant():
        packets, dirs, _ = _tile_inputs()
        tv.tile_composite_variant("full", packets["geom"], packets["featsT"],
                                  dirs, packets["count"], s)

    def topk():
        o, d, table = _dense_inputs()
        dt.dense_topk(o, d, table, 4, s)

    def vis():
        o, d, table = _dense_inputs()
        dt.dense_visibility(o, d, torch.full((8,), 8.0), table, s)

    def vis_pairs():
        o, d, table = _dense_inputs()
        dt.dense_visibility_pairs(o, d, torch.full((8,), 8.0), table, s)

    def composite():
        o, d, table = _dense_inputs()
        idx, t, alpha = dt.dense_topk(o, d, table, 4, s)
        feats = torch.zeros(table.shape[0], dt.composite_cols(0))
        dt.dense_composite(idx, t, alpha, d, feats, 0)

    def march():
        o, d, _ = _dense_inputs()
        accel = types.SimpleNamespace(**{k: torch.zeros(1) for k in (
            "btab", "geom", "packet", "fill", "lo", "hi")})
        with pytest.raises(ValueError, match="plain march"):
            grid_march.march_kernel(accel, o, d, s, [])

    def threefry():
        with pytest.raises(ValueError, match="plain version"):
            k5.threefry_uniforms([(1, 2)], [1], 8, "cpu")

    return dict(tile_composite=fwd, tile_composite_bwd=bwd,
                packet_gather_bwd=gather_bwd, tile_composite_variant=variant,
                dense_topk=topk, dense_visibility=vis,
                dense_visibility_pairs=vis_pairs, dense_composite=composite,
                march_kernel=march, threefry_uniforms=threefry)


@pytest.mark.parametrize("wrapper", sorted(_wrappers()))
def test_cpu_wrappers_launch_nothing(wrapper):
    """On CPU tensors every wrapper runs its plain version (or, for the
    march and K5, refuses them) and counts no launch."""
    before = dict(launch.launches)
    _wrappers()[wrapper]()
    assert dict(launch.launches) == before
