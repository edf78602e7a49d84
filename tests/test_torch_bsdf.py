"""The port's ops/bsdf.py vs the JAX package (CPU), on numpy-seeded inputs
that include roughness 1e-3, grazing angles, metals, total internal
reflection and eta = 1; and the reference's material physics checks
(tests/test_materials.py) run on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_gaussiansplatting_tpu.ops import bsdf as jbsdf
from pathtracer_gaussiansplatting_tpu_torch.ops import bsdf as tbsdf

from torch_parity import TORCH_THREADS, assert_close, np_of

torch.set_num_threads(TORCH_THREADS)

# float32 transcendental functions (exp, pow, sin, cos) round differently
# in XLA and torch by an ulp or two; GGX terms at roughness 1e-3 divide by
# a ~1e-12 a^2 and amplify that to ~1e-5 relative.
RTOL, ATOL = 1e-4, 1e-6
N_RAYS = 256


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inp():
    """Shading frames and materials: rows 0-31 grazing views (n.v ~ 1e-3 to
    2e-2), rows 32-63 roughness 1e-3, rows 64-95 metals, rows 96-127
    roughness 1."""
    rng = np.random.default_rng(31)
    n = _unit(rng.normal(size=(N_RAYS, 3)))
    v = rng.normal(size=(N_RAYS, 3))
    v = _unit(v * np.sign(np.sum(v * n, -1, keepdims=True)))
    t = _unit(np.cross(n, rng.normal(size=(N_RAYS, 3))))
    cos = rng.uniform(1e-3, 2e-2, (32, 1))
    v[:32] = _unit(cos * n[:32] + np.sqrt(1 - cos ** 2) * t[:32])
    l = rng.normal(size=(N_RAYS, 3))
    l = _unit(l * np.sign(np.sum(l * n, -1, keepdims=True)))
    rough = rng.uniform(0.05, 1.0, N_RAYS)
    rough[32:64] = 1e-3
    rough[96:128] = 1.0
    metallic = rng.uniform(0, 1, N_RAYS)
    metallic[64:96] = 1.0
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        n=n, v=v, l=l, albedo=f32(rng.uniform(0, 1, (N_RAYS, 3))),
        metallic=f32(metallic), rough=f32(rough),
        u_lobe=f32(rng.uniform(0, 1, N_RAYS)),
        u_dir=f32(rng.uniform(0, 1, (N_RAYS, 2))),
        u_cc=f32(rng.uniform(0, 1, N_RAYS)),
        clearcoat=f32(np.where(rng.uniform(0, 1, N_RAYS) < 0.5, 0.0,
                               rng.uniform(0.2, 1.0, N_RAYS))),
        cc_rough=f32(rng.uniform(1e-3, 0.3, N_RAYS)),
        cos=f32(rng.uniform(-0.2, 1.0, N_RAYS)))


def both(inp, *names):
    """The named inputs as (jax arrays, torch tensors)."""
    return ([jnp.asarray(inp[k]) for k in names],
            [torch.from_numpy(inp[k]) for k in names])


def check(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            check(got[k], want[k], rtol, atol)
    elif isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            check(g, w, rtol, atol)
    elif np.asarray(want).dtype == bool:
        assert np.array_equal(np_of(got), np.asarray(want))
    else:
        assert_close(got, want, rtol, atol)


@pytest.mark.parametrize("fn,args", [
    ("orthonormal_basis", ("n",)),
    ("cosine_hemisphere", ("u_dir", "n")),
    ("sample_ggx_half", ("u_dir", "n", "rough")),
    ("d_ggx", ("cos", "rough")),
    ("v_smith_ggx_fast", ("cos", "u_lobe", "rough")),
    ("f_schlick", ("cos", "albedo")),
    ("pdf_ggx", ("n", "v", "l", "rough")),
    ("pdf_lambert", ("n", "l")),
    ("specular_prob", ("n", "v", "metallic")),
    ("f0_of", ("albedo", "metallic")),
    ("eval_bsdf", ("n", "v", "l", "albedo", "metallic", "rough")),
    ("mixture_pdf", ("n", "v", "l", "metallic", "rough")),
    ("sample_bsdf", ("u_lobe", "u_dir", "n", "v", "albedo", "metallic",
                     "rough")),
    ("sample_clearcoated", ("u_cc", "u_lobe", "u_dir", "n", "v", "albedo",
                            "metallic", "rough", "clearcoat", "cc_rough")),
])
def test_bsdf_function_matches(inp, fn, args):
    if fn == "f_schlick":
        inp = dict(inp, cos=inp["cos"][:, None])
    jargs, targs = both(inp, *args)
    want = getattr(jbsdf, fn)(*jargs)
    check(getattr(tbsdf, fn)(*targs), want)


@pytest.mark.parametrize("ior", [1.01, 1.5, 1.0], ids=["ior1.01", "ior1.5",
                                                       "eta1"])
def test_sample_glass_matches(inp, ior):
    (jn, jv, ja, jm, ju), (tn, tv, ta, tm, tu) = both(
        inp, "n", "v", "albedo", "metallic", "u_lobe")
    check(tbsdf.sample_glass(tu, tn, tv, ta, tm, ior),
          jbsdf.sample_glass(ju, jn, jv, ja, jm, ior))


@pytest.mark.parametrize("eta", [1.0, 1.0 / 1.5, 1.5], ids=["eta1", "enter",
                                                           "exit_tir"])
def test_refract_matches(inp, eta):
    (jn, jv), (tn, tv) = both(inp, "n", "v")
    got, tir = tbsdf.refract(-tv, tn, eta)
    want, jtir = jbsdf.refract(-jv, jn, eta)
    assert np.array_equal(np_of(tir), np.asarray(jtir))
    if eta > 1.0:
        assert bool(tir.any()) and not bool(tir.all())
    check(got, want, RTOL, 1e-5)


def test_refract_straight_through_at_eta_1():
    out, tir = tbsdf.refract(torch.tensor([[0.0, 0.0, -1.0]]),
                             torch.tensor([[0.0, 0.0, 1.0]]), 1.0)
    assert not bool(tir[0])
    assert_close(out, [[0.0, 0.0, -1.0]], 0, 1e-6)


def test_refract_tir():
    d = torch.tensor([[np.sin(1.4), 0.0, -np.cos(1.4)]], dtype=torch.float32)
    out, tir = tbsdf.refract(d, torch.tensor([[0.0, 0.0, 1.0]]), 1.5)
    assert bool(tir[0])
    assert_close(out[0], np.zeros(3), 0, 1e-6)


def test_sample_glass_reflect_vs_refract():
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(2, 1)
    out = tbsdf.sample_glass(torch.tensor([0.0, 0.99]), n, n.clone(),
                             torch.full((2, 3), 0.9), torch.zeros(2), 1.01)
    refl, refr = np_of(out["direction"])
    np.testing.assert_allclose(refl, [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(refr, [0, 0, -1], atol=1e-2)
    np.testing.assert_allclose(np_of(out["weight"])[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(np_of(out["weight"])[1], 0.9, atol=1e-6)
    assert np_of(out["offset_sign"]).tolist() == [1.0, -1.0]


def test_zero_clearcoat_matches_base(inp):
    _, t = both(inp, "u_cc", "u_lobe", "u_dir", "n", "v", "albedo",
                "metallic", "rough")
    base = tbsdf.sample_bsdf(*t[1:])
    coated = tbsdf.sample_clearcoated(*t, torch.zeros(N_RAYS),
                                      torch.full((N_RAYS,), 0.03))
    assert torch.equal(coated["direction"], base["direction"])
    assert_close(coated["weight"], base["weight"], 1e-5, 0)
    assert_close(coated["pdf"], base["pdf"], 1e-5, 0)


def test_clearcoat_energy_bounded():
    """The directional albedo under a full coat stays <= 1 (white
    furnace), on numpy uniforms."""
    m = 4096
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (m, 4)).astype(np.float32))
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(m, 1)
    v = torch.tensor([[0.3, 0.0, 0.954]]) / np.linalg.norm([0.3, 0, 0.954])
    out = tbsdf.sample_clearcoated(
        u[:, 0], u[:, 1], u[:, 2:4], n, v.repeat(m, 1).float(),
        torch.ones(m, 3), torch.zeros(m), torch.full((m,), 0.5),
        torch.ones(m), torch.full((m,), 0.1))
    assert float(torch.amax(out["weight"], -1).mean()) <= 1.15


def test_full_metal_has_no_diffuse():
    albedo = torch.tensor([[0.2, 0.9, 0.3]])
    f = tbsdf.eval_bsdf(torch.tensor([[0.0, 0.0, 1.0]]),
                        torch.tensor([[0.0, 0.0, 1.0]]),
                        torch.tensor([[0.6, 0.0, 0.8]]), albedo,
                        torch.ones(1), torch.ones(1))
    assert float(f[0, 1]) < 0.9 / np.pi * 0.8
