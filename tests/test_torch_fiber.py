"""The port's fiber BCSDFs (bsdf/fiber.py) against the JAX package on the
CPU:
  * the hair BSDF's host precompute (precompute_hair_azimuthal,
    hair_sigma_a, hair_lobe_params) bit-equal;
  * eval, pdf and sample of hair, rough_wire and lambertian_fiber on
    numpy-seeded local directions (y along the fiber), uv and random
    numbers, through bsdf_eval / bsdf_pdf / bsdf_sample on a BSDF table
    that both packages flatten (the JAX one carried across).

Tolerances.  lambertian_fiber and rough_wire: rtol 1e-4 / atol 1e-6 on
every lane.  Hair: its longitudinal lobe's stable branch (fiber_m, v <
0.1) exponentiates -b + log I0(a) - 1/v, terms of size 1/v (up to 162
for the smooth hair here), and the two packages' f32 rounding of them
differs by a few ulps, so eval and pdf are held to rtol 8 ulps of the
largest 1/v (1.5e-4 here) / atol 1e-6.  sample's lobe choice and its
CDF binary search compare interpolated values with a random number, so
a lane on a threshold may take the neighbouring lobe or phi bin: at most
0.2 % of a type's lanes may part in sample.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.bsdf import eval as jev
from tungsten_tpu.bsdf import fiber as jfib
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.bsdf import eval as tev
from tungsten_tpu_torch.bsdf import fiber as tfib
from tungsten_tpu_torch.bsdf import types as tbt
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import jax_fields

DEFS = [{"type": "hair", "scale_angle": 2.5, "melanin_ratio": 1.0,
         "melanin_concentration": 1.3, "roughness": 0.3},
        {"type": "hair", "roughness": 0.1, "sigma_a": [0.3, 0.5, 1.2]},
        {"type": "hair"},
        {"type": "rough_wire", "material": "Au", "roughness": 0.15,
         "albedo": [0.9, 0.8, 0.7]},
        {"type": "rough_wire", "eta": 1.3, "k": 3.0, "roughness": 0.6},
        {"type": "lambertian_fiber", "albedo": [0.6, 0.5, 0.3]}]
N = 4096
SAMPLE_PART = 0.002
EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("params", [
    ({"melanin_ratio": 1.0, "melanin_concentration": 1.3,
      "roughness": 0.3, "scale_angle": 2.5}),
    ({"sigma_a": [0.3, 0.5, 1.2], "roughness": 0.1}),
    ({"sigma_a": 0.8, "roughness": 0.02})])
def test_hair_precompute_bit_equal(params):
    """sigma_a, the lobe parameters and the azimuthal tables (values,
    pdf, cdf, row sums) bit for bit."""
    sa_t, sa_j = tfib.hair_sigma_a(params), jfib.hair_sigma_a(params)
    assert np.array_equal(sa_t, sa_j)
    (lp_t, br_t), (lp_j, br_j) = (tfib.hair_lobe_params(params),
                                  jfib.hair_lobe_params(params))
    assert np.array_equal(lp_t, lp_j) and br_t == br_j
    got = tfib.precompute_hair_azimuthal(sa_t, br_t)
    want = jfib.precompute_hair_azimuthal(sa_j, br_j)
    assert set(got) == set(want) == {"values", "pdf", "cdf", "sums"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _desc():
    return SceneDesc(path="scene.json", json={},
                     bsdfs=[dict(b) for b in DEFS],
                     primitives=[{"type": "quad", "bsdf_index": 0}],
                     media=[], camera={"type": "pinhole",
                                       "resolution": [8, 8]},
                     integrator={}, renderer={})


def _sphere_dirs(r, n):
    w = r.normal(size=(n, 3))
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def shaded():
    """Both packages' eval, pdf and sample over every fiber row, N lanes
    a row, from one flattened table (the JAX calls jitted once each)."""
    js, jset = jax_flatten(_desc())
    own, tset = flatten_scene(_desc(), device="cpu")
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    types = jset.present_bsdf_types
    assert tset.present_bsdf_types == types == (
        tbt.LAMBERTIAN_FIBER, tbt.ROUGH_WIRE, tbt.HAIR)
    for k in ("bsdf_params", "bsdf_aux", "hair_values", "hair_cdf",
              "hair_params"):
        assert np.asarray(getattr(js, k)).tobytes() == \
            getattr(own, k).numpy().tobytes(), k
    r = np.random.default_rng(17)
    M = N * len(DEFS)
    wi, wo = _sphere_dirs(r, M), _sphere_dirs(r, M)
    uv = r.uniform(size=(M, 2)).astype(np.float32)
    u = r.uniform(size=(4, M)).astype(np.float32)
    bidx = np.repeat(np.arange(len(DEFS), dtype=np.int32), N)

    def jax_all(bidx, uv, wi, wo, u):
        sp = jev.ShadePoint(js, bidx, uv)
        return (jev.bsdf_eval(sp, wi, wo, types),
                jev.bsdf_pdf(sp, wi, wo, types)) + tuple(jev.bsdf_sample(
                    sp, wi, u[0], u[1], u[2], types, u_lobe2=u[3]))

    jax_out = [np.asarray(x) for x in jax.jit(jax_all)(*(
        jnp.asarray(x) for x in (bidx, uv, wi, wo, u)))]
    tsp = tev.ShadePoint(ts, torch.from_numpy(bidx).long(),
                         torch.from_numpy(uv))
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    tu = torch.from_numpy(u)
    port_out = [tev.bsdf_eval(tsp, twi, two, types).numpy(),
                tev.bsdf_pdf(tsp, twi, two, types).numpy()]
    port_out += [x.numpy() for x in tev.bsdf_sample(
        tsp, twi, tu[0], tu[1], tu[2], types, u_lobe2=tu[3])]
    inv_v = 1.0 / float(np.asarray(js.hair_params)[:, 1:].min())
    return jax_out, port_out, inv_v


def _close(a, b, rtol):
    ok = np.isclose(b, a, rtol=rtol, atol=1e-6)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


@pytest.mark.parametrize("bidx", range(len(DEFS)),
                         ids=[f"{b['type']}{i}" for i, b in enumerate(DEFS)])
def test_fiber_bsdf_matches_jax(shaded, bidx):
    jax_out, port_out, inv_v = shaded
    lanes = slice(bidx * N, (bidx + 1) * N)
    jf, jp, *jout = (x[lanes] for x in jax_out)
    tf, tp, *tout = (x[lanes] for x in port_out)
    hair = DEFS[bidx]["type"] == "hair"
    rtol = 8 * EPS32 * inv_v if hair else 1e-4
    assert rtol < 2e-4
    assert _close(jf, tf, rtol).all()
    assert _close(jp, tp, rtol).all()
    assert tout[3].dtype == np.int32
    same = jout[3] == tout[3]
    for a, b in zip(jout[:3], tout[:3]):
        same &= _close(a, b, rtol)
    assert same.mean() >= 1.0 - SAMPLE_PART, same.mean()
    # real work: valid samples with a nonzero weight, nonzero eval
    valid = (tout[3] & tev.FLAG_VALID) != 0
    assert valid.mean() > 0.5
    assert (tout[1][valid].max(axis=-1) > 0).mean() > 0.5
    assert (tf.max(axis=-1) > 0).mean() > 0.3


def test_fiber_m_stable_branch():
    """fiber_m's two branches on a sweep of v across 0.1 and of the
    angles, against the JAX package, within 8 ulps of 1/v relative;
    fiber_sample_m within rtol / atol 1e-5."""
    r = np.random.default_rng(3)
    v = np.repeat(np.geomspace(0.004, 0.9, 32), 64).astype(np.float32)
    ang = r.uniform(-np.pi / 2, np.pi / 2, (2, v.size)).astype(np.float32)
    args = (v, np.sin(ang[0]), np.sin(ang[1]), np.cos(ang[0]),
            np.cos(ang[1]))
    got = tfib.fiber_m(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jfib.fiber_m(*(jnp.asarray(a) for a in args)))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 8 * EPS32 / v * np.abs(want)
            + 1e-30).all()
    xi = r.uniform(size=(2, v.size)).astype(np.float32)
    sargs = (v, args[1], args[3], xi[0], xi[1])
    s = tfib.fiber_sample_m(*(torch.from_numpy(a) for a in sargs)).numpy()
    want_s = np.asarray(jfib.fiber_sample_m(*(jnp.asarray(a)
                                              for a in sargs)))
    assert (np.abs(s) <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-5)


def test_wire_roughness_floor_derivative_is_jax():
    """rough_wire's roughness floor, jnp.maximum(roughness, 1e-3): at the
    floor JAX's derivative is half of the slope (a tie splits evenly),
    and the port's _wire_v gives the same gradient there and away from
    it."""
    from types import SimpleNamespace
    x = np.array([1e-3, 0.5, 1e-4, 0.02], np.float32)
    want = np.asarray(jax.grad(lambda r: jnp.sum(jfib._wire_v(
        SimpleNamespace(roughness=r))))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    tfib._wire_v(SimpleNamespace(roughness=t)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)
    assert want[2] == 0.0 and 0.0 < want[0] < want[3]
