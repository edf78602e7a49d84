"""The dense capture cell (``capture.surface40k``) on the CPU: the plain
dense reference against the port's plain versions, the route the
configuration's size takes, the cell's rehearsal and control, planted
faults in the flat capture, and the dense readers against hand counts on
a toy segment."""
import functools
import importlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cellbench.metrics import _dense
from cellbench.reference import dense as ref_dense
from cellbench.reference import types as ref_types
from cellbench.rehearse import rehearse
from cellbench.run import BENCH_DIR, load_json
from test_cellbench_spans import CPU, CUDA, Ev, reader

PORT = "pathtracer_gaussiansplatting_tpu_torch"
CAPTURE = PORT + ".data.capture"


@pytest.fixture(scope="module")
def room():
    """A 2000-Gaussian room, rays from inside it, both as the port's and
    the reference's types."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import (
        GaussianScene, RenderSettings,
    )
    from cellbench import scenes
    raw = scenes.make(dict(scene="surface_room", n=2000), 2 ** 31 + 5, "cpu")
    gen = torch.Generator().manual_seed(3)
    dirs = torch.randn((96, 3), generator=gen)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    origins = 0.3 * torch.randn((96, 3), generator=gen)
    kw = dict(ambient=(0.05, 0.05, 0.06, 1.0))
    return dict(port=GaussianScene(**raw), ref=ref_types.GaussianScene(**raw),
                port_settings=RenderSettings(**kw),
                ref_settings=ref_types.RenderSettings(**kw),
                origins=origins, dirs=dirs)


def test_reference_matches_the_ports_plain_versions(room):
    """The all-pairs top-K and its composite, and the shadow product, as
    the port's plain (CPU) versions give them."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import Rays
    from pathtracer_gaussiansplatting_tpu_torch.render import reference
    o, d = room["origins"], room["dirs"]
    active = torch.arange(o.shape[0]) % 4 > 0
    want = reference.trace_dense(room["port"], Rays(o, d),
                                 room["port_settings"], active=active)
    backend = ref_dense.DenseBackend(room["ref"], room["ref_settings"])
    got = backend.trace(room["ref"], ref_types.Rays(o, d),
                        room["ref_settings"], active=active)
    assert set(got) == set(want)
    assert float(want["alpha_acc"].max()) > 0.5
    for key, w in want.items():
        if w.dtype == torch.bool:
            assert torch.equal(got[key], w), key
        else:
            torch.testing.assert_close(got[key], w, rtol=1e-5, atol=1e-5,
                                       msg=key)
    t_end = 0.5 + torch.rand(o.shape[0], generator=torch.Generator()
                             .manual_seed(4)) * 3.0
    want_vis = reference.visibility_dense(room["port"], o, d, t_end,
                                          room["port_settings"], active)
    got_vis, frozen = backend.visibility(o, d, t_end, active)
    assert frozen == 0 and float(want_vis.min()) < 0.5
    torch.testing.assert_close(got_vis, want_vis, rtol=1e-6, atol=1e-6)


def test_reference_topk_keeps_the_nearest(room):
    """The list is the K smallest peak t among the pairs with alpha > 0,
    front to back, padded past them."""
    g = ref_dense._Gaussians(room["ref"], False)
    s = room["ref_settings"]
    idx, t, alpha = ref_dense.topk(g, room["origins"], room["dirs"], 8, s)
    assert bool((t[:, 1:] >= t[:, :-1]).all())
    full_idx, full_t, full_a = ref_dense.topk(
        g, room["origins"], room["dirs"], room["ref"].num_gaussians, s)
    n_pos = (full_a > 0).sum(-1)
    keep = torch.minimum(n_pos, torch.tensor(8))
    for r in range(idx.shape[0]):
        k = int(keep[r])
        assert torch.equal(t[r, :k], full_t[r, :k])
        assert bool((alpha[r, k:] == 0).all() and (t[r, k:] == s.t_max)
                    .all())


def test_the_configurations_size_takes_the_dense_route():
    from pathtracer_gaussiansplatting_tpu_torch.data.capture import (
        resolve_backend,
    )
    cfg = load_json(BENCH_DIR / "configs" / "surface40k.json")
    assert resolve_backend("auto", cfg["n"]) == cfg["route"] == "dense"


def test_rehearsal_is_correct():
    res = rehearse("capture.surface40k", seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


def test_control_is_not_correct():
    res = rehearse("capture.surface40k", seconds=0.5, stand_ins=("lowp",))
    lowp = res["looks"]["lowp"]
    assert any(lowp[k] > c["limit"] for k, c in res["checks"].items()), \
        lowp


def one_bounce_fewer(settings):
    return settings.__class__(**dict(vars(settings),
                                     max_depth=settings.max_depth - 1))


def half_the_list(settings):
    return settings.__class__(**dict(vars(settings),
                                     max_contribs=settings.max_contribs
                                     // 2))


def with_settings(make, change, scene, settings, *a, **kw):
    return make(scene, change(settings), *a, **kw)


@pytest.mark.parametrize("change", [one_bounce_fewer, half_the_list],
                         ids=["one-bounce-fewer", "half-the-list"])
def test_planted_fault_is_not_correct(monkeypatch, change):
    """The flat renderer made with one bounce fewer, or with half the
    top-K's list, fails the check. At the rehearsal's size the list holds
    8 of the room's contributors, so that halving it shows."""
    capture = importlib.import_module(CAPTURE)
    monkeypatch.setattr(capture, "make_accumulating_renderer",
                        functools.partial(with_settings,
                                          capture.make_accumulating_renderer,
                                          change))
    res = rehearse("capture.surface40k", seconds=0.5,
                   overrides=dict(config=dict(max_contribs=8)))
    assert not res["correct"], res["checks"]


def test_sound_run_at_the_faults_size_is_correct():
    res = rehearse("capture.surface40k", seconds=0.5,
                   overrides=dict(config=dict(max_contribs=8)))
    assert res["correct"], res["checks"]


# A toy host segment of one sample: ptgs.trace [0, 300) holding ptgs.topk
# [10, 100) and ptgs.gather [120, 200); ptgs.shade [400, 700) holding
# ptgs.vis [450, 600) holding ptgs.dense_vis [460, 590). Each device op
# follows its launch.
LAUNCH = "cudaLaunchKernel"
TOY = [
    Ev("ptgs.trace", CPU, 0, 300), Ev("ptgs.topk", CPU, 10, 90),
    Ev("ptgs.gather", CPU, 120, 80), Ev("ptgs.shade", CPU, 400, 300),
    Ev("ptgs.vis", CPU, 450, 150), Ev("ptgs.dense_vis", CPU, 460, 130),
    Ev(LAUNCH, CPU, 20, 2), Ev("dense_topk_kernel", CUDA, 25, 40),
    Ev(LAUNCH, CPU, 70, 2), Ev("reduce_kernel", CUDA, 72, 8),
    Ev(LAUNCH, CPU, 130, 2), Ev("vectorized_gather_kernel", CUDA, 135, 30),
    Ev(LAUNCH, CPU, 140, 2), Ev("index_elementwise_kernel", CUDA, 170, 20),
    Ev(LAUNCH, CPU, 220, 2), Ev("einsum_kernel", CUDA, 225, 10),
    Ev(LAUNCH, CPU, 470, 2), Ev("dense_visibility_kernel", CUDA, 475, 60),
    Ev(LAUNCH, CPU, 650, 2), Ev("elementwise_kernel", CUDA, 655, 5),
]


def toy_run(events=None, units=None, n=1000):
    from cellbench import trace as trace_mod
    host = trace_mod.Trace(TOY if events is None else events, window_s=1e-6,
                           units=dict(samples=2) if units is None else units)
    card = trace_mod.Trace([e for e in (TOY if events is None else events)
                            if e.device_type() == CUDA], window_s=1e-6,
                           units=dict(samples=2))
    card.host = host
    driver = types.SimpleNamespace(cfg=dict(n=n))
    return types.SimpleNamespace(trace=card, extras=None, driver=driver)


def toy_counts():
    """The counters of two top-K launches of 100 rays at K = 4."""
    from pathtracer_gaussiansplatting_tpu_torch.utils import profiling
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            profiling.count("dense_rays", 100)
            profiling.count("dense_list_slots", 400)
            profiling.count("dense_list_filled",
                            torch.arange(400) % 8 < 3)   # 150 filled
    return profiling


def test_dense_readers_on_a_toy_segment():
    profiling = toy_counts()
    try:
        run = toy_run()
        # Two samples: ms = 1e3 * ns * 1e-9 / 2. K1 and K2 by name; the
        # gathers' two kernels joined from K1's launch.
        assert reader("dense_topk_ms.capture").read(run) == pytest.approx(
            1e-6 * 40 / 2)
        assert reader("dense_gather_ms.capture").read(run) == \
            pytest.approx(1e-6 * 50 / 2)
        assert reader("dense_vis_ms.capture").read(run) == pytest.approx(
            1e-6 * 60 / 2)
        assert reader("dense_list_fill.capture").read(run) == \
            pytest.approx(37.5)
        # Both segments: a launch each (the table's 64 N bytes each), the
        # kernel's 40 ns each; the rays' 4 (6 R + 3 R K) bytes and 60 flops
        # a filled slot as counted.
        n_bytes = 4.0 * (6 * 200 + 3 * 800) + 64 * 1000 * 2
        bound = max(n_bytes / 3.35e12, 60 * 300 / 67e12)
        want = 100.0 * bound / 80e-9
        assert _dense.topk_bound_s(
            dict(dense_rays=200, dense_list_slots=800,
                 dense_list_filled=300), 2, 1000) == pytest.approx(bound)
        got = reader("dense_topk_roofline.capture").read(run)
        assert got == pytest.approx(want)
    finally:
        profiling.reset_counts()


def test_gathers_joined_from_k1_survive_a_dropped_record():
    """A kernel record the profiler dropped before the spans shifts the
    stream-order join, which then credits the gathers' span with the
    wrong ops; the join from K1's launch still reads the gathers' two
    kernels. K1 kernels that do not pair with the top-K spans read
    nothing."""
    from cellbench.metrics._spans import ms_per
    dropped = [Ev(LAUNCH, CPU, 2, 2)] + TOY        # its kernel's record lost
    run = toy_run(events=dropped)
    assert ms_per(run, "ptgs.gather", "samples") != pytest.approx(
        1e-6 * 50 / 2)
    assert reader("dense_gather_ms.capture").read(run) == pytest.approx(
        1e-6 * 50 / 2)
    assert _dense.anchored_s(run.trace.host, "ptgs.gather") == \
        pytest.approx(50e-9)
    extra = TOY + [Ev("ptgs.topk", CPU, 800, 10)]   # a span without K1
    assert _dense.anchored_s(toy_run(events=extra).trace.host,
                             "ptgs.gather") is None


DENSE_READERS = ("dense_topk_ms.capture", "dense_gather_ms.capture",
                 "dense_vis_ms.capture", "dense_list_fill.capture",
                 "dense_topk_roofline.capture")


@pytest.mark.parametrize("name", DENSE_READERS)
def test_dense_readers_without_their_spans_or_counters(name):
    """None without a trace, without a host segment, with no samples, with
    none of the dense spans (the parent's program, or another route); the
    counter readers also with no counter recorded."""
    r = reader(name)
    profiling = toy_counts()
    try:
        bare = [e for e in TOY if not e.name().startswith("ptgs.")]
        no_host = types.SimpleNamespace(trace=types.SimpleNamespace(
            host=None))
        for run in (types.SimpleNamespace(trace=None), no_host,
                    toy_run(units={}), toy_run(events=bare)):
            assert r.read(run) is None
        assert r.read(toy_run()) is not None
        profiling.reset_counts()
        counted = name in ("dense_list_fill.capture",
                           "dense_topk_roofline.capture")
        assert (r.read(toy_run()) is None) == counted
    finally:
        profiling.reset_counts()
