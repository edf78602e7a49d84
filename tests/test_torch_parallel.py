"""The port's (rays, gauss) mesh, sharded renderers and mesh training step
against the JAX package, on the CPU: the JAX functions on the
8-virtual-device mesh of tests/conftest.py cut to n devices, the port's on
n spawned gloo ranks (tests/torch_mesh_ranks.py; one spawn per module runs
every case), the same mesh shapes and the same numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import (
    generate_rays as j_generate_rays,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.parallel import mesh as jmesh
from pathtracer_gaussiansplatting_tpu.parallel import shard as jshard
from pathtracer_gaussiansplatting_tpu.parallel import train as jtrain
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, Rays, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import SceneParams
from pathtracer_gaussiansplatting_tpu_torch.parallel import mesh as pm
from pathtracer_gaussiansplatting_tpu_torch.parallel import shard
from pathtracer_gaussiansplatting_tpu_torch.parallel import train
from pathtracer_gaussiansplatting_tpu_torch.render.reference import (
    render_radiance_dense,
)

import torch_mesh_ranks as ranks
from torch_parity import TORCH_THREADS, cameras, np_of, to_torch_scene

torch.set_num_threads(TORCH_THREADS)

# Radiance, port against the JAX package: sigma 0.2-0.5 splats keep the
# quadratic well conditioned, so both select the same pairs and alpha
# agrees to ~1e-4 relative (tests/test_torch_reference.py).
RTOL, ATOL = 2e-4, 2e-6
# Gradients to the means: tests/test_parallel.py's own tolerance for the
# ring against the dense renderer.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# One Adam step (tests/test_torch_train_dense.py): a gradient entry near 0
# moves its leaf by up to lr either way on an ulp of difference.
LEAF_RTOL, LEAF_ATOL_LR = 1e-3, 1e-2
# Gradients summed over the rays axis against one device's: the same
# terms in another order.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-8


def _mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cloud, 32x16 rays and a flat target in both packages, and the
    port's results on four gloo ranks."""
    scene = j_random_cloud(96, seed=13, spread=1.0, scale_range=(-1.6, -0.7))
    tscene = j_random_cloud(96, seed=3, spread=1.0, scale_range=(-1.6, -0.7),
                            sh_degree=1)
    jcam, _ = cameras(width=32, height=16)
    rays = j_generate_rays(jcam)
    target = np.full((rays.num_rays, 3), 0.25, np.float32)
    io = tmp_path_factory.mktemp("mesh_ranks")
    ranks.save_inputs(io, **ranks.scene_arrays("scene", scene),
                      **ranks.scene_arrays("train", tscene),
                      rays_o=np.asarray(rays.origins),
                      rays_d=np.asarray(rays.directions), target=target)
    return dict(scene=scene, tscene=tscene, rays=rays, target=target,
                settings=JRenderSettings(**ranks.PAR_SETTINGS),
                out=ranks.spawn("parallel_cases", io))


def _torch_rays(rays):
    """(origins, directions) of JAX rays as CPU tensors."""
    return tuple(torch.from_numpy(np.array(x))
                 for x in (rays.origins, rays.directions))


def _jloss(fn):
    return lambda means: jnp.mean(fn(means) ** 2)


@pytest.mark.parametrize("multiple", [1, 5, 8])
def test_pad_to_multiple_matches(multiple):
    """The fill values bit-equal to the JAX package's; the three fields it
    leaves at N rows are padded with its default 0."""
    js = j_random_cloud(50, seed=5)
    got = pm.pad_to_multiple(to_torch_scene(js), multiple)
    want = jmesh.pad_to_multiple(js, multiple)
    assert got.num_gaussians % multiple == 0
    for f in SCENE_FIELDS:
        g, w = np_of(getattr(got, f)), np.asarray(getattr(want, f))
        if w.shape[0] == g.shape[0]:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:  # clearcoat, clearcoat_roughness, transmission
            np.testing.assert_array_equal(g[:w.shape[0]], w, err_msg=f)
            assert not g[w.shape[0]:].any(), f


def test_dense_ray_sharded_matches(world):
    """render_dense_ray_sharded at (4, 1): radiance and the means'
    gradient (summed over the four ranks)."""
    mesh = _mesh((4, 1))
    scene, rays, settings = world["scene"], world["rays"], world["settings"]
    want = jshard.render_dense_ray_sharded(scene, rays, settings, mesh)
    np.testing.assert_allclose(world["out"]["dense"], np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    g = jax.grad(_jloss(lambda m: jshard.render_dense_ray_sharded(
        scene.replace(means=m), rays, settings, mesh)))(scene.means)
    np.testing.assert_allclose(world["out"]["dense_grad"], np.asarray(g),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_ring_topk_matches(world, shape):
    """ring_topk_radiance: the scene blocks rotate around the gauss ring;
    radiance and the gradient to every block's means."""
    mesh = _mesh(shape)
    scene, rays, settings = world["scene"], world["rays"], world["settings"]
    sharded = jmesh.shard_scene(jmesh.pad_to_multiple(scene, shape[1]), mesh)
    tag = f"ring_{shape[0]}x{shape[1]}"
    want = jshard.ring_topk_radiance(sharded, rays, settings, mesh)
    np.testing.assert_allclose(world["out"][tag], np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    g = jax.grad(_jloss(lambda m: jshard.ring_topk_radiance(
        sharded.replace(means=m), rays, settings, mesh)))(sharded.means)
    np.testing.assert_allclose(world["out"][tag + "_grad"], np.asarray(g),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("n_blocks", [2, 5])
def test_ring_block_candidates_keep_the_same_k(world, n_blocks):
    """On the card a block offers its own K nearest (the top-K kernel), on
    the CPU every pair: merged block by block (five blocks include four
    padding Gaussians), both keep the same K contributions wherever no
    two depths are equal, so the merged lists agree bit for bit."""
    scene = pm.pad_to_multiple(to_torch_scene(world["scene"]), n_blocks)
    o, d = _torch_rays(world["rays"])
    settings = RenderSettings(**ranks.PAR_SETTINGS)
    k, per = settings.max_contribs, scene.num_gaussians // n_blocks
    results = []
    for every_pair in (True, False):
        state = (torch.full((o.shape[0], k), settings.t_max),
                 torch.zeros((o.shape[0], k)),
                 torch.zeros((o.shape[0], k, 3)))
        for b in range(n_blocks):
            block = shard.unpack_scene(
                shard.pack_scene(scene)[b * per:(b + 1) * per], scene)
            state = shard._merge_topk(state, shard._block_candidates(
                block, o, d, settings, every_pair=every_pair), k)
        results.append(state)
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_padding_is_inert(world):
    """tests/test_parallel.py::TestRingTopK::test_padding_is_inert: padding
    Gaussians change no ray's radiance."""
    scene = to_torch_scene(world["scene"])
    rays = Rays(*_torch_rays(world["rays"]))
    settings = RenderSettings(**ranks.PAR_SETTINGS)
    np.testing.assert_allclose(
        np_of(render_radiance_dense(pm.pad_to_multiple(scene, 7), rays,
                                    settings)),
        np_of(render_radiance_dense(scene, rays, settings)), atol=1e-5)


def test_train_step_matches(world):
    """One make_train_step(mesh=) step at (4, 1): the scene after it
    against the JAX package's, and the all-reduced gradients against one
    device's (tests/test_parallel.py::
    test_replicated_grads_equal_single_device)."""
    out, settings = world["out"], world["settings"]
    mesh = _mesh((4, 1))
    step = jtrain.make_train_step(settings, optax.adam(ranks.TRAIN_LR),
                                  mesh=mesh)
    jscene = world["tscene"]
    want, _, loss = step(jscene, optax.adam(ranks.TRAIN_LR).init(jscene),
                         world["rays"], jnp.asarray(world["target"]))
    np.testing.assert_allclose(out["train_loss"], float(loss), rtol=1e-5)
    for f in SCENE_FIELDS:
        np.testing.assert_allclose(
            out[f"train_scene/{f}"], np.asarray(getattr(want, f)),
            rtol=LEAF_RTOL, atol=LEAF_ATOL_LR * ranks.TRAIN_LR, err_msg=f)

    params = SceneParams.from_scene(to_torch_scene(jscene))
    rays = Rays(*_torch_rays(world["rays"]))
    loss1 = train.l2_loss(render_radiance_dense(
        params.scene(), rays, RenderSettings(**ranks.PAR_SETTINGS)),
        torch.from_numpy(world["target"]))
    loss1.backward()
    np.testing.assert_allclose(out["train_loss"], loss1.item(), rtol=1e-6)
    for f, p in params.named_parameters():
        want = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(out[f"train_grad/{f}"], np_of(want),
                                   rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=f)


def test_fit_scene_mesh_matches_one_device(world):
    """fit_scene(mesh=) at (4, 1) takes the steps fit_scene takes on one
    device: the same losses."""
    _, losses = train.fit_scene(
        to_torch_scene(world["tscene"]), Rays(*_torch_rays(world["rays"])),
        torch.from_numpy(world["target"]),
        RenderSettings(**ranks.PAR_SETTINGS), steps=ranks.FIT_STEPS,
        lr=ranks.FIT_LR)
    np.testing.assert_allclose(world["out"]["fit_losses"], losses, rtol=1e-5)


def test_initialize_multihost_world_of_one(world):
    """With no rendezvous and no launcher's environment, one process gets
    a world of one (rank 0) and the default mesh (1, 1)."""
    np.testing.assert_array_equal(world["out"]["world1"], [0, 1, 1])


def test_make_mesh_checks_its_shape(world):
    assert "!= 4 ranks" in str(world["out"]["bad_shape"])
