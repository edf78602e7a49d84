"""The port's render/lights.py vs the JAX package (CPU): light tables for
every mix of emitters, emissive sampling on the JAX tables carried across,
punctual sampling for all three light types; and the reference's light
table checks (tests/test_pathtrace.py) run on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.core.types import (
    make_punctual_lights as j_make_punctual_lights,
)
from pathtracer_gaussiansplatting_tpu.models.scene import (
    random_cloud as j_random_cloud,
)
from pathtracer_gaussiansplatting_tpu.render import lights as jl
from pathtracer_gaussiansplatting_tpu_torch.core.types import (
    make_punctual_lights,
)
from pathtracer_gaussiansplatting_tpu_torch.render import lights as tl

from torch_parity import (
    CPU, TORCH_THREADS, assert_close, np_of, to_torch_lights, to_torch_scene,
    to_torch_tables,
)

torch.set_num_threads(TORCH_THREADS)

# f32 sums and cumsums run in another order in XLA and torch: a few ulps
# of the flux total.
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-5, 1e-6
R = 512


def _scene(emissive: bool):
    scene = j_random_cloud(300, seed=17, spread=1.2,
                           emissive_frac=0.1 if emissive else 0.0)
    # Ties between scale axes: the surfel's axes order by a stable argsort.
    ls = np.array(scene.log_scales)
    ls[:40, 1] = ls[:40, 0]
    ls[40:60, 2] = ls[40:60, 1]
    ls[60:70] = ls[60:70, :1]
    return scene.replace(log_scales=jnp.asarray(ls))


def _lights():
    """A point light with a range, a directional light and a spot."""
    return j_make_punctual_lights(
        position=[[0.5, 2.0, 1.0], [0.0, 3.0, 0.0], [-1.0, 1.5, 2.0]],
        direction=[[0.0, -1.0, 0.0], [0.3, -1.0, 0.2], [0.4, -0.6, -1.0]],
        color=[[1.0, 0.9, 0.8], [0.6, 0.7, 1.0], [1.0, 1.0, 1.0]],
        intensity=[5.0, 0.02, 8.0], light_type=[0, 1, 2],
        range=[4.0, 0.0, 0.0], inner_cone_cos=[1.0, 1.0, 0.95],
        outer_cone_cos=[0.7, 0.7, 0.8])


@pytest.mark.parametrize("emissive,punctual", [
    (True, False), (False, True), (True, True), (False, False)],
    ids=["emissive", "punctual", "both", "none"])
def test_build_light_tables_matches(emissive, punctual):
    js = _scene(emissive)
    jp = _lights() if punctual else None
    want = jl.build_light_tables(js, jp)
    got = tl.build_light_tables(to_torch_scene(js),
                                to_torch_lights(jp) if punctual else None)
    for f in ("emissive_cdf", "emissive_strength", "emissive_flux",
              "punctual_cdf", "punctual_prob", "punctual_flux",
              "p_emissive"):
        assert_close(getattr(got, f), getattr(want, f), TABLE_RTOL,
                     TABLE_ATOL, err_msg=f)
    assert_close(tl.surfel_area(to_torch_scene(js)), jl.surfel_area(js),
                 RTOL, ATOL)


def test_sample_emissive_matches():
    """On the JAX tables carried across, so that the CDF steps are the
    same floats and searchsorted picks the same surfel."""
    js = _scene(True)
    jt = jl.build_light_tables(js)
    rng = np.random.default_rng(3)
    u_sel = rng.uniform(0, 1, R).astype(np.float32)
    u_sel[:8] = np.asarray(jt.emissive_cdf)[np.flatnonzero(
        np.diff(np.asarray(jt.emissive_cdf)))[:8]]   # exactly on a CDF step
    u_disk = rng.uniform(0, 1, (R, 2)).astype(np.float32)
    want = jl.sample_emissive(jnp.asarray(u_sel), jnp.asarray(u_disk), js, jt)
    got = tl.sample_emissive(torch.from_numpy(u_sel),
                             torch.from_numpy(u_disk), to_torch_scene(js),
                             to_torch_tables(jt))
    assert np.array_equal(np_of(got["index"]), np.asarray(want["index"]))
    assert len(np.unique(np_of(got["index"]))) > 10
    for k in ("position", "normal", "emission", "strength"):
        assert_close(got[k], want[k], RTOL, ATOL, err_msg=k)


def test_sample_punctual_matches():
    js, jp = _scene(True), _lights()
    jt = jl.build_light_tables(js, jp)
    rng = np.random.default_rng(4)
    u_sel = rng.uniform(0, 1, R).astype(np.float32)
    pos = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    want = jl.sample_punctual(jnp.asarray(u_sel), jp, jt, jnp.asarray(pos))
    got = tl.sample_punctual(torch.from_numpy(u_sel), to_torch_lights(jp),
                             to_torch_tables(jt), torch.from_numpy(pos))
    idx = np.searchsorted(np.asarray(jt.punctual_cdf), u_sel)
    assert set(np.unique(idx)) == {0, 1, 2}   # every light type sampled
    for k in ("direction", "dist", "radiance", "inv_prob"):
        assert_close(got[k], want[k], RTOL, ATOL, err_msg=k)


def test_pdf_and_mis_match():
    rng = np.random.default_rng(5)
    a, b, c, d = (rng.uniform(0, 2, R).astype(np.float32) for _ in range(4))
    c[:16] = 0.0
    for flux in (0.0, 3.5):
        assert_close(
            tl.pdf_nee_solid_angle(torch.from_numpy(a), torch.tensor(flux),
                                   torch.from_numpy(b), torch.from_numpy(c)),
            jl.pdf_nee_solid_angle(a, jnp.float32(flux), b, c), RTOL, ATOL)
    assert_close(tl.power2_mis(torch.from_numpy(a), torch.from_numpy(d)),
                 jl.power2_mis(a, d), RTOL, ATOL)


def _wall(emission=None):
    """The reference's test wall: one flat white surfel at z = 0, and an
    emitter at z = 1 when ``emission`` is given."""
    from pathtracer_gaussiansplatting_tpu_torch.core.types import make_scene

    n = 1 if emission is None else 2
    return make_scene(
        means=[[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]][:n],
        log_scales=np.log([[3.0, 3.0, 0.01], [0.3, 0.3, 0.01]][:n]),
        quats=[[1.0, 0, 0, 0]] * n, opacity_logits=[9.0] * n,
        colors=[[0.8, 0.8, 0.8], [0.0, 0.0, 0.0]][:n],
        emission=[[0.0, 0.0, 0.0], emission or [0, 0, 0]][:n], device=CPU)


def test_cdf_normalized():
    t = tl.build_light_tables(_wall([5.0, 5.0, 5.0]))
    cdf = np_of(t.emissive_cdf)
    assert cdf[-1] == pytest.approx(1.0, abs=1e-5)
    assert (np.diff(cdf) >= 0).all()
    assert float(t.p_emissive) == 1.0


def test_p_emissive_clamp():
    pl = make_punctual_lights(position=[[0, 0, 2]], intensity=[1000.0],
                              light_type=[0], device=CPU)
    t = tl.build_light_tables(_wall([1e-3] * 3), pl)
    assert 0.1 <= float(t.p_emissive) <= 0.9


def test_punctual_flux_rule():
    pl = make_punctual_lights(position=[[0, 0, 2], [0, 0, 3]],
                              intensity=[1.0, 1.0], light_type=[1, 0],
                              device=CPU)
    probs = np_of(tl.build_light_tables(_wall(), pl).punctual_prob)
    assert probs[0] == pytest.approx(400.0 / (400.0 + 4 * np.pi), rel=1e-5)
