"""The packet gather's backward (``tile_composite.PacketGather``): on the
CPU its gradient against autograd of the plain gather, bit for bit; on a
CUDA card the segment-sum kernels (``csrc/packet_gather.cu``) against the
plain version, bit for bit, at the fit cell's shapes and others."""
import math
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_gaussiansplatting_tpu_torch.core.camera import Camera, look_at
from pathtracer_gaussiansplatting_tpu_torch.core.types import RenderSettings
from pathtracer_gaussiansplatting_tpu_torch.kernels import launch
from pathtracer_gaussiansplatting_tpu_torch.kernels import tile_composite as tc
from pathtracer_gaussiansplatting_tpu_torch.models.scene import random_cloud
from pathtracer_gaussiansplatting_tpu_torch.ops.binning import (
    BinningConfig, bin_gaussians, num_tiles, project_gaussians,
)
from pathtracer_gaussiansplatting_tpu_torch.render.tiled import (
    _packet_features, _tile_dirs,
)
from pathtracer_gaussiansplatting_tpu_torch.utils import profiling

from torch_parity import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)


def binned(n, spread, k, tile_size, width, height, eye, device="cpu",
           seed=3):
    """A random cloud binned for one pose: (table (N, 25), tile_idx,
    tile_mask, dirs (T, P, 3), count)."""
    scene = random_cloud(n, seed=seed, spread=spread, device=device)
    cam = Camera(c2w=look_at(eye, (0.0, 0.0, 0.0), device=device),
                 fov_y_deg=50.0, width=width, height=height)
    cfg = BinningConfig(max_per_tile=k, tile_size=tile_size)
    settings = RenderSettings()
    with torch.no_grad():
        idx, mask, _, _ = bin_gaussians(project_gaussians(scene, cam, cfg),
                                        *num_tiles(cam, cfg), cfg)
        origin = cam.c2w[:3, 3]
        table = tc.packet_table(scene, _packet_features(scene, origin,
                                                        settings), origin)
    return table, idx, mask, _tile_dirs(cam, cfg)[0]


@pytest.fixture
def deterministic():
    """The CPU's index_put_ with accumulate adds duplicates by atomics
    across threads, in no fixed order; in deterministic mode it sorts them
    and adds each run in ascending slot order from 0, as CUDA's does."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def live_zeroed(x, mask, seed):
    """Seeded normal cotangents shaped like ``x`` (T, R, K), zero at the
    masked slots."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn(x.shape, generator=g, device=x.device) \
        * mask[:, None, :]


def grads(gather, table, idx, mask, dirs):
    """The table's gradient through ``gather`` and the tile composite, for
    a fixed loss on its three outputs."""
    t = table.clone().requires_grad_()
    geom, featsT, count = gather(t, idx, mask)
    out, alpha, depth = tc.tile_composite(
        dict(geom=geom, featsT=featsT, count=count), dirs, RenderSettings())
    w = torch.linspace(-1.0, 1.0, out.numel(),
                       device=out.device).reshape(out.shape)
    loss = (out * w).sum() + 0.3 * alpha.sum() + 0.01 * (depth * alpha).sum()
    return torch.autograd.grad(loss, t)[0]


def segment_sum(d_geom, d_featsT, idx, mask, n):
    """Each Gaussian's sum over its live slots in ascending flat slot
    order, from 0: the kernel's order, in plain PyTorch."""
    d_rows = torch.cat([d_geom[:, :tc.TABLE_GEOM].transpose(1, 2),
                        d_featsT.transpose(1, 2)], -1).reshape(
        -1, tc.TABLE_GEOM + d_featsT.shape[1])
    live = torch.nonzero(mask.reshape(-1)).squeeze(1)
    gauss = idx.reshape(-1)[live].long()
    order = torch.sort(gauss, stable=True).indices
    gauss, vals = gauss[order], d_rows[live[order]]
    first = torch.ones_like(gauss, dtype=torch.bool)
    first[1:] = gauss[1:] != gauss[:-1]
    pos = torch.arange(len(gauss), device=gauss.device)
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    acc = d_rows.new_zeros((n, d_rows.shape[1]))
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == r
        acc[gauss[sel]] = acc[gauss[sel]] + vals[sel]
    return acc


# (n, spread, K, tile size, eye) of a 64x48 pose: masked slots, tiles with
# no live slot and Gaussians in none (the cap drops them) in each; 8x8
# tiles in the last.
CPU_CASES = [(800, 1.0, 64, 16, (0.0, 0.5, 8.0)),
             (400, 0.4, 32, 16, (0.0, 0.5, 4.0)),
             (600, 1.2, 48, 8, (0.0, 0.5, 6.0))]


@pytest.mark.parametrize("n,spread,k,tile,eye", CPU_CASES)
def test_grad_matches_autograd(n, spread, k, tile, eye, deterministic):
    """PacketGather's gradient through the tile composite equals autograd
    of the plain gather (the packets as built before it) bit for bit, and
    its forward outputs are the plain gather's."""
    table, idx, mask, dirs = binned(n, spread, k, tile, 64, 48, eye)
    assert (~mask).any() and (mask.sum(1) == 0).any()
    want = grads(tc.gather_packets, table, idx, mask, dirs)
    got = grads(tc.PacketGather.apply, table, idx, mask, dirs)
    assert torch.equal(got, want)
    assert (want.abs().sum(1) > 0).any()
    hit = torch.zeros(n, dtype=torch.bool)
    hit[idx[mask].long()] = True
    assert (~hit).any() and bool((got[~hit] == 0).all())
    for g, w in zip(tc.PacketGather.apply(table, idx, mask),
                    tc.gather_packets(table, idx, mask)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,spread,k,tile,eye", CPU_CASES)
def test_segment_sum_matches_plain(n, spread, k, tile, eye, deterministic):
    """On the CPU the backward is the plain version; a sum over the live
    slots alone in ascending slot order (the kernel's) equals it bit for
    bit on cotangents that are zero at masked slots."""
    table, idx, mask, _ = binned(n, spread, k, tile, 64, 48, eye)
    t_total, kk = idx.shape
    d_geom = live_zeroed(torch.empty(t_total, tc.GEOM_ROWS, kk), mask, 1)
    d_featsT = live_zeroed(torch.empty(t_total, tc.FEATURE_DIM, kk), mask, 2)
    want = tc.packet_gather_bwd_plain(d_geom, d_featsT, idx, mask, n)
    assert torch.equal(segment_sum(d_geom, d_featsT, idx, mask, n), want)
    assert torch.equal(tc.packet_gather_bwd(d_geom, d_featsT, idx, mask, n),
                       want)


def test_plain_is_autograd_on_long_segments(deterministic):
    """Gaussians in hundreds of slots each, a mask with holes: the plain
    version equals autograd of the gather on any cotangent, and the
    ascending-order sum equals it where the masked slots' are zero."""
    g = torch.Generator().manual_seed(5)
    t_total, k, n = 20, 48, 7
    idx = torch.randint(0, n, (t_total, k), generator=g, dtype=torch.int32)
    mask = torch.rand((t_total, k), generator=g) < 0.7
    table = torch.randn((n, 25), generator=g, requires_grad=True)
    geom, featsT, _ = tc.gather_packets(table, idx, mask)
    d_geom = torch.randn(geom.shape, generator=g)
    d_featsT = torch.randn(featsT.shape, generator=g)
    want = torch.autograd.grad((geom, featsT), table, (d_geom, d_featsT),
                               retain_graph=True)[0]
    assert torch.equal(
        tc.packet_gather_bwd_plain(d_geom, d_featsT, idx, mask, n), want)
    d_geom, d_featsT = (x * mask[:, None, :] for x in (d_geom, d_featsT))
    want = torch.autograd.grad((geom, featsT), table, (d_geom, d_featsT))[0]
    assert torch.equal(segment_sum(d_geom, d_featsT, idx, mask, n), want)


def test_backward_counts_slots():
    """While a profiler records, the backward counts the packets' slots
    and their live slots; with none recording it counts nothing."""
    table, idx, mask, dirs = binned(400, 0.4, 32, 16, 64, 48,
                                    (0.0, 0.5, 4.0))
    profiling.reset_counts()
    try:
        grads(tc.PacketGather.apply, table, idx, mask, dirs)
        assert "packet_slots" not in profiling.counts()
        with profile(activities=[ProfilerActivity.CPU]):
            grads(tc.PacketGather.apply, table, idx, mask, dirs)
        got = profiling.counts()
        assert got["packet_slots"] == idx.numel()
        assert got["packet_slots_live"] == int(mask.sum())
    finally:
        profiling.reset_counts()


def test_dispatch_cpu_and_no_fallback():
    """CPU tensors take the plain version and launch nothing; any other
    device must launch the kernels or raise."""
    table, idx, mask, _ = binned(400, 0.4, 32, 16, 64, 48, (0.0, 0.5, 4.0))
    d_geom = live_zeroed(torch.empty(idx.shape[0], 16, idx.shape[1]), mask, 3)
    d_featsT = live_zeroed(torch.empty(idx.shape[0], 14, idx.shape[1]),
                           mask, 4)
    before = launch.launches["packet_gather_bwd"]
    tc.packet_gather_bwd(d_geom, d_featsT, idx, mask, len(table))
    assert launch.launches["packet_gather_bwd"] == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tc.packet_gather_bwd(d_geom.to("meta"), d_featsT.to("meta"),
                             idx.to("meta"), mask.to("meta"), len(table))
    with pytest.raises(ValueError):
        tc.packet_gather_bwd(d_geom.to("meta"), d_featsT, idx, mask,
                             len(table))


# ---- on the card -----------------------------------------------------------

def ring_eye(azimuth_deg=0.0, elevation_deg=20.0, distance=4.0):
    """An eye of the fit cell's ring of views."""
    a, e = math.radians(azimuth_deg), math.radians(elevation_deg)
    return (distance * math.cos(a) * math.cos(e), distance * math.sin(e),
            distance * math.sin(a) * math.cos(e))


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,tile", [(256, 16), (512, 16), (256, 8)])
def test_kernel_bit_equal_on_card(k, tile):
    """The fit cell's scene and view (random_cloud 1M, spread 1.5, 800x800,
    a ring view): the kernels' d_table equals the plain version's bit for
    bit, with cotangents from the tile backward and with random ones zero
    at masked slots; twice the same bits; zero rows for Gaussians in no
    live slot; one count under "packet_gather_bwd" a call."""
    dev = card()
    table, idx, mask, dirs = binned(1_000_000, 1.5, k, tile, 800, 800,
                                    ring_eye(), device=dev, seed=1)
    n, t_total = len(table), idx.shape[0]
    assert (~mask).any()
    geom, featsT, count = tc.gather_packets(table, idx, mask)
    packets = dict(geom=geom, featsT=featsT, count=count)
    g = torch.Generator(device=dev).manual_seed(k + tile)
    p = dirs.shape[1]
    cot = (torch.randn((t_total, p, tc.FEATURE_DIM), generator=g, device=dev),
           torch.randn((t_total, p), generator=g, device=dev),
           torch.randn((t_total, p), generator=g, device=dev))
    d_geom, d_featsT, _ = tc.tile_composite_bwd(packets, dirs, cot,
                                                RenderSettings(), False)
    dead = ~mask[:, None, :]
    assert bool((d_geom.masked_select(dead) == 0).all())
    assert bool((d_featsT.masked_select(dead) == 0).all())
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit[idx[mask].long()] = True
    for seed, (dg, df) in enumerate([(d_geom, d_featsT), (
            live_zeroed(d_geom, mask, 7), live_zeroed(d_featsT, mask, 8))]):
        want = tc.packet_gather_bwd_plain(dg, df, idx, mask, n)
        before = launch.launches["packet_gather_bwd"]
        got = tc.packet_gather_bwd(dg, df, idx, mask, n)
        again = tc.packet_gather_bwd(dg, df, idx, mask, n)
        torch.cuda.synchronize()
        assert launch.launches["packet_gather_bwd"] == before + 2
        assert torch.equal(got, want), f"cotangents {seed}"
        assert torch.equal(got, again)
        assert torch.equal(got, segment_sum(dg, df, idx, mask, n))
        assert bool((got[~hit] == 0).all())


@pytest.mark.cuda
def test_kernel_long_segments_on_card():
    """Gaussians in hundreds of live slots each (the warp sorts the
    segment in memory) and a mask with holes: bit-equal to the plain
    version; a Gaussian past the last index in no slot gets zeros."""
    dev = card()
    g = torch.Generator(device=dev).manual_seed(11)
    t_total, k, n = 300, 64, 40
    idx = torch.randint(0, n - 1, (t_total, k), generator=g, device=dev,
                        dtype=torch.int32)
    idx[:2] = 3  # one Gaussian in ~128 extra slots
    mask = torch.rand((t_total, k), generator=g, device=dev) < 0.8
    d_geom = live_zeroed(torch.empty((t_total, 16, k), device=dev), mask, 1)
    d_featsT = live_zeroed(torch.empty((t_total, 14, k), device=dev), mask, 2)
    want = tc.packet_gather_bwd_plain(d_geom, d_featsT, idx, mask, n)
    got = tc.packet_gather_bwd(d_geom, d_featsT, idx, mask, n)
    assert torch.equal(got, want)
    assert torch.equal(got, tc.packet_gather_bwd(d_geom, d_featsT, idx, mask,
                                                 n))
    assert bool((got[n - 1] == 0).all())


@pytest.mark.cuda
def test_kernel_raises_on_card():
    """A wrong dtype, shape or device raises; nothing falls back."""
    dev = card()
    t_total, k, n = 8, 32, 50
    idx = torch.randint(0, n, (t_total, k), device=dev, dtype=torch.int32)
    mask = torch.ones((t_total, k), dtype=torch.bool, device=dev)
    d_geom = torch.zeros((t_total, 16, k), device=dev)
    d_featsT = torch.zeros((t_total, 14, k), device=dev)
    bad = [dict(idx=idx.long()), dict(mask=mask.to(torch.uint8)),
           dict(d_geom=d_geom.double()), dict(d_geom=d_geom[:, :11]),
           dict(d_featsT=torch.zeros((t_total, 22, k), device=dev)),
           dict(mask=mask.cpu()), dict(d_featsT=d_featsT.cpu())]
    before = launch.launches["packet_gather_bwd"]
    for change in bad:
        args = {**dict(d_geom=d_geom, d_featsT=d_featsT, idx=idx, mask=mask),
                **change}
        with pytest.raises(ValueError):
            tc.packet_gather_bwd(args["d_geom"], args["d_featsT"],
                                 args["idx"], args["mask"], n)
    assert launch.launches["packet_gather_bwd"] == before


@pytest.mark.cuda
def test_train_step_on_card():
    """The tiled train step launches the backward once a step, and its
    trace holds the kernels and no PyTorch index backward: no
    indexing_backward_kernel of PyTorch's, no index_put_, index_add_ or
    scatter_add_."""
    from pathtracer_gaussiansplatting_tpu_torch.models.scene import (
        SceneParams,
    )
    from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (
        make_optimizer, make_tiled_train_step,
    )
    dev = card()
    scene = random_cloud(20_000, seed=4, spread=1.0, device=dev)
    cam = Camera(c2w=look_at(ring_eye(), (0.0, 0.0, 0.0), device=dev),
                 fov_y_deg=50.0, width=128, height=128)
    opt = make_optimizer(5e-3)
    params = SceneParams.from_scene(scene)
    state = opt(params.parameters())
    step = make_tiled_train_step(RenderSettings(), opt, BinningConfig())
    target = torch.full((128, 128, 3), 0.5, device=dev)
    before = launch.launches["packet_gather_bwd"]
    step(params, state, cam, target)
    torch.cuda.synchronize()
    assert launch.launches["packet_gather_bwd"] == before + 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, cam, target)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    ours = {m.group(0) for x in names
            for m in [re.search(r"packet_indexing_backward\w*", x)] if m}
    assert ours == {"packet_indexing_backward_count",
                    "packet_indexing_backward_fill",
                    "packet_indexing_backward_kernel"}, sorted(ours)
    assert not [x for x in names if "indexing_backward" in x
                and "packet_indexing_backward" not in x]
    assert not [x for x in names if any(
        op in x for op in ("index_put", "index_add", "scatter_add"))]
    assert np.isfinite(float(params.means.grad.abs().sum()))
