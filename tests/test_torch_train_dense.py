"""The port's dense training (make_train_step, fit_scene) vs the JAX
package (CPU): ten Adam steps on every leaf of a random cloud against a
target rendered by the dense renderer, and the dense table built once a
step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.camera import (
    generate_rays as j_generate_rays,
)
from pathtracer_gaussiansplatting_tpu.core.types import (
    Rays as JRays, RenderSettings as JRenderSettings,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.parallel import train as jtrain
from pathtracer_gaussiansplatting_tpu.render.reference import (
    render_radiance_dense as j_render_radiance_dense,
)
from pathtracer_gaussiansplatting_tpu_torch.core.camera import generate_rays
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    SCENE_FIELDS, RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.kernels import dense_trace
from pathtracer_gaussiansplatting_tpu_torch.models.scene import SceneParams
from pathtracer_gaussiansplatting_tpu_torch.parallel import train as ttrain

from torch_parity import CPU, TORCH_THREADS, cameras, np_of, to_torch_scene

torch.set_num_threads(TORCH_THREADS)

# Ten steps of Adam on every leaf. The clouds' sigmas are 0.2-0.5 against
# a camera ~4 away, so no (ray, Gaussian) pair sits within rounding of an
# alpha cutoff (ROADMAP section 3) and both packages select the same pairs:
# losses within LOSS_RTOL. Adam divides each gradient by its running RMS,
# so a gradient entry near 0 moves its leaf by up to lr either way on an
# ulp of difference: leaves within LEAF_RTOL |x| + LEAF_ATOL_LR x lr.
LOSS_RTOL = 1e-4
LEAF_RTOL = 1e-3
LEAF_ATOL_LR = 1e-2
STEPS, LR = 10, 2e-2
SETTINGS = dict(background=(0.1, 0.1, 0.1), max_contribs=32)


@pytest.fixture(scope="module")
def problem():
    """A 300-Gaussian start and a 40-Gaussian target cloud (sigma
    0.2-0.5), 32x24 rays, and the target image, in both packages."""
    start = j_random_cloud(300, seed=3, spread=1.0,
                           scale_range=(-1.6, -0.7), sh_degree=1)
    goal = j_random_cloud(40, seed=4, spread=1.0, scale_range=(-1.6, -0.7))
    jcam, tcam = cameras(width=32, height=24)
    jrays = j_generate_rays(jcam)
    target = j_render_radiance_dense(goal, jrays, JRenderSettings(**SETTINGS))
    return dict(jstart=start, tstart=to_torch_scene(start), jrays=jrays,
                trays=generate_rays(tcam), target=np.array(target))


def test_fit_scene_dense_matches(problem):
    jfit, jlosses = jtrain.fit_scene(
        problem["jstart"], problem["jrays"], jnp.asarray(problem["target"]),
        JRenderSettings(**SETTINGS), steps=STEPS, lr=LR)
    tfit, tlosses = ttrain.fit_scene(
        problem["tstart"], problem["trays"],
        torch.from_numpy(problem["target"]), RenderSettings(**SETTINGS),
        steps=STEPS, lr=LR)
    print("losses", tlosses[0], tlosses[-1])
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    for f in SCENE_FIELDS:
        got, want = np_of(getattr(tfit, f)), np_of(getattr(jfit, f))
        np.testing.assert_allclose(got, want, rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL_LR * LR, err_msg=f)
    # Leaves the dense render does not read keep their start values.
    for f in ("metallic", "roughness", "clearcoat", "transmission"):
        np.testing.assert_array_equal(np_of(getattr(tfit, f)),
                                      np_of(getattr(problem["tstart"], f)))


def test_train_step_builds_the_table_once_a_step(problem, monkeypatch):
    """One step renders once and builds the dense kernels' table once;
    gradients reach the geometry, opacity and colors."""
    calls = []
    real = dense_trace.gaussian_table

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(dense_trace, "gaussian_table", counted)
    params = SceneParams.from_scene(problem["tstart"])
    opt = ttrain.make_optimizer(LR)
    opt_state = opt(params.parameters())
    step = ttrain.make_train_step(RenderSettings(**SETTINGS), opt)
    target = torch.from_numpy(problem["target"])
    for i in range(3):
        params, opt_state, loss = step(params, opt_state, problem["trays"],
                                       target)
        assert len(calls) == i + 1
        assert torch.isfinite(loss)
    for f in ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs"):
        assert float(getattr(params, f).grad.abs().max()) > 0, f
    assert params.metallic.grad is None


def test_train_step_custom_render_and_loss(problem):
    """render_fn and loss_fn replace the dense render and the L2 loss."""
    jscene, tscene = problem["jstart"], problem["tstart"]
    jrays, trays = problem["jrays"], problem["trays"]
    target = problem["target"]
    jstep = jtrain.make_train_step(
        JRenderSettings(**SETTINGS), jtrain.make_optimizer(LR),
        render_fn=lambda s, r: j_render_radiance_dense(
            s, JRays(r.origins, r.directions), JRenderSettings(**SETTINGS)),
        loss_fn=jtrain.l1_loss)
    jopt = jtrain.make_optimizer(LR).init(jscene)
    _, _, jloss = jstep(jscene, jopt, jrays, jnp.asarray(target))
    params = SceneParams.from_scene(tscene)
    opt = ttrain.make_optimizer(LR)
    tstep = ttrain.make_train_step(
        RenderSettings(**SETTINGS), opt,
        render_fn=lambda s, r: ttrain.render_radiance_dense(
            s, r, RenderSettings(**SETTINGS)),
        loss_fn=ttrain.l1_loss)
    _, _, tloss = tstep(params, opt(params.parameters()), trays,
                        torch.from_numpy(target))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert CPU == str(params.means.device)
