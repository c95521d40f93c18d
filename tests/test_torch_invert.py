"""The port's sample inversion (bsdf/invert.py, integrators/invert_path.py)
against the JAX package on the CPU.

  * bsdf_invert on every case of tests/test_invert.py (lambert, mirror,
    conductor, rough conductor per distribution, dielectric, rough
    dielectric, plastic, rough plastic, oren_nayar, phong, diffuse
    transmission, the uninvertible coats), parametrised: N seeded
    incident directions, each with the direction the JAX package's
    sampler draws from seeded uniforms and a seeded random direction (the
    invalid branches), the same seeded mu.  lobe, lobe2, u1 and u2 within
    rtol 1e-5 / atol 1e-6, valid equal; on the sampled half the inversion
    is valid somewhere (the comparison sees real work).
  * invert_camera_direction, invert_area_light_point, invert_choose_light
    and invert_medium_distance on tests/test_invert_path.py's fixtures
    (the light-choice case with a second emitter, so its cdf has two
    bins): the same tolerances (the camera's u1, u2 within atol 1e-5, a
    few ulps of the 64-pixel image coordinate they are cut from), pixels
    and valid flags equal.
"""
import copy
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.bsdf import types as bt
from tungsten_tpu.bsdf.eval import FLAG_VALID, bsdf_sample
from tungsten_tpu.bsdf.invert import bsdf_invert as jax_invert
from tungsten_tpu.integrators import invert_path as JIP
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.bsdf.invert import bsdf_invert as port_invert
from tungsten_tpu_torch.integrators import invert_path as TIP
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_invert import FakeSP, N, _uniforms, _wi  # noqa: E402
from test_torch_flatten import jax_fields  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CAM_ATOL = 1e-5
METALS = {bt.P.ETA_R: 0.2, bt.P.ETA_G: 0.92, bt.P.ETA_B: 1.1,
          bt.P.K_R: 3.9, bt.P.K_G: 2.45, bt.P.K_B: 2.14}

# (case, type, FakeSP keywords, wi over the whole sphere)
CASES = [
    ("lambert", bt.LAMBERT, {}, False),
    ("mirror", bt.MIRROR, {}, False),
    ("conductor", bt.CONDUCTOR, dict(params=METALS), False),
    ("rough_conductor_beckmann", bt.ROUGH_CONDUCTOR,
     dict(roughness=0.3, dist=bt.DIST_BECKMANN, params=METALS), False),
    ("rough_conductor_phong", bt.ROUGH_CONDUCTOR,
     dict(roughness=0.3, dist=bt.DIST_PHONG, params=METALS), False),
    ("rough_conductor_ggx", bt.ROUGH_CONDUCTOR,
     dict(roughness=0.3, dist=bt.DIST_GGX, params=METALS), False),
    ("dielectric", bt.DIELECTRIC,
     dict(params={bt.P.IOR: 1.5, bt.P.EXTRA0: 1.0}), True),
    ("rough_dielectric", bt.ROUGH_DIELECTRIC,
     dict(roughness=0.35, params={bt.P.IOR: 1.5, bt.P.EXTRA0: 1.0}), True),
    ("plastic", bt.PLASTIC,
     dict(params={bt.P.IOR: 1.5, bt.P.EXTRA1: 0.8}), False),
    ("rough_plastic", bt.ROUGH_PLASTIC,
     dict(roughness=0.4, params={bt.P.IOR: 1.5, bt.P.EXTRA1: 0.8,
                                 bt.P.EXTRA2: 1.0}), False),
    ("oren_nayar", bt.OREN_NAYAR, dict(roughness=0.4), False),
    ("phong", bt.PHONG, dict(params={bt.P.EXTRA0: 30.0, bt.P.EXTRA1: 0.4}),
     False),
    ("diffuse_transmission", bt.DIFFUSE_TRANSMISSION,
     dict(params={bt.P.EXTRA0: 0.5}), False),
    ("smooth_coat", bt.SMOOTH_COAT, dict(params={bt.P.IOR: 1.3}), False),
]


class PortSP:
    """The same constant material as a FakeSP, as torch tensors."""

    def __init__(self, fake, n):
        def t(x):
            return torch.from_numpy(np.array(x))
        self.type = t(fake.type).repeat(n // N)
        self.params = t(fake.params).repeat(n // N, 1)
        self.albedo = t(fake.albedo).repeat(n // N, 1)
        self.roughness = t(fake.roughness).repeat(n // N)
        self.dist = t(fake.dist).repeat(n // N)


def _close(a, b):
    return np.isclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_bsdf_invert_matches_jax(case):
    _, type_id, kw, sphere = next(c for c in CASES if c[0] == case)
    types = (int(type_id),)
    fake = FakeSP(type_id, **kw)
    wi = _wi(hemi=not sphere)
    ul, u1, u2, ul2 = _uniforms()
    if type_id == bt.SMOOTH_COAT:
        # as tests/test_invert.py: wo = wi (the coat has no inverse)
        wo_s, flags = wi, jnp.full((N,), FLAG_VALID)
    else:
        wo_s, _, _, flags = bsdf_sample(fake, wi, ul, u1, u2, types,
                                        u_lobe2=ul2)
    rnd = np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    wi2 = jnp.concatenate([wi, wi])
    wo2 = jnp.concatenate([wo_s, jnp.asarray(rnd)])
    mu = np.random.default_rng(9).random((2 * N, 4), dtype=np.float32)
    big = FakeSP(type_id, **kw)
    for k in ("type", "params", "aux", "albedo", "roughness", "dist"):
        v = getattr(big, k)
        setattr(big, k, jnp.concatenate([v, v]))
    j = jax_invert(big, wi2, wo2, types, jnp.asarray(mu))
    t = port_invert(PortSP(fake, 2 * N), torch.from_numpy(np.array(wi2)),
                    torch.from_numpy(np.array(wo2)), types,
                    torch.from_numpy(mu))
    assert (t["valid"].numpy() == np.asarray(j["valid"])).all()
    for k in ("lobe", "lobe2", "u1", "u2"):
        ok = _close(j[k], t[k])
        assert ok.all(), (k, int((~ok).sum()))
    sampled_ok = np.asarray(j["valid"])[:N] & \
        np.asarray((flags & FLAG_VALID) != 0)
    if type_id == bt.SMOOTH_COAT:
        assert not t["valid"].any()
    else:
        assert sampled_ok.mean() > 0.5, sampled_ok.mean()


def _path_desc(second_light=False):
    prims = [
        {"type": "quad", "bsdf_index": 0, "emission": [5.0] * 3,
         "transform": {"position": [0, 2, 0], "scale": [2, 1, 1],
                       "rotation": [0, 0, 180]}},
        {"type": "quad", "bsdf_index": 0,
         "transform": {"position": [0, -1, 0], "scale": [8, 1, 8]}},
    ]
    if second_light:
        prims.append({"type": "quad", "bsdf_index": 0,
                      "emission": [1.0, 2.0, 3.0],
                      "transform": {"position": [1.5, 1, 0.5],
                                    "scale": [0.5, 1, 0.5],
                                    "rotation": [0, 0, 150]}})
    return SceneDesc(
        path="/tmp/ip.json", json={},
        bsdfs=[{"type": "lambert", "albedo": 0.5}], primitives=prims,
        media=[],
        camera={"type": "pinhole", "resolution": [64, 48], "fov": 60,
                "transform": {"position": [0, 0.5, 4.0],
                              "look_at": [0.2, 0.4, 0]}},
        integrator={"type": "path_tracer"}, renderer={"spp": 1})


def _both(second_light=False):
    desc = _path_desc(second_light)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    return js, jset, ts, tset


def test_invert_camera_direction_matches_jax():
    from tungsten_tpu.cameras.camera import generate_rays
    js, jset, ts, tset = _both()
    jset = replace(jset, filter="box", spp=0)
    R = 256
    pixel = (jnp.arange(R, dtype=jnp.uint32) * 7) % (64 * 48)
    _, d = generate_rays(js, jset, pixel, jnp.zeros((R,), jnp.uint32),
                         jnp.uint32(3))
    # a quarter of the directions point away from the view: invalid
    d = np.asarray(d).copy()
    d[::4] *= -1.0
    jp, ju1, ju2, jok = JIP.invert_camera_direction(js, jset, jnp.asarray(d))
    for filt, ok_any in (("box", True), ("tent", False)):
        tp, tu1, tu2, tok = TIP.invert_camera_direction(
            ts, replace(tset, filter=filt), torch.from_numpy(d))
        if not ok_any:
            assert not tok.any()
            continue
        assert (tok.numpy() == np.asarray(jok)).all()
        assert 0.5 < tok.numpy().mean() < 1.0
        assert (tp.numpy() == np.asarray(jp)).all()
        # u = (px + fx) - px: the absolute error is that of the image
        # coordinate (ulp 3.8e-6 at 64 px), where the two packages'
        # rotations round apart
        for a, b in ((ju1, tu1), (ju2, tu2)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=CAM_ATOL)


def test_invert_area_light_point_matches_jax():
    from tungsten_tpu.integrators.lights import (alias_pick_tri,
                                                 area_light_sample)
    js, _, ts, _ = _both()
    R = 256
    rs = np.random.default_rng(1)
    u_tri, u1, u2 = (jnp.asarray(rs.random(R), jnp.float32)
                     for _ in range(3))
    li = jnp.zeros((R,), jnp.int32)
    p = jnp.zeros((R, 3), jnp.float32)
    smp = area_light_sample(js, li, p, u_tri, u1, u2)
    tri = alias_pick_tri(js, li, u_tri)
    q = p + smp["d"] * smp["dist"][..., None]
    dv = q - js.tri_v0[tri]
    e1, e2 = js.tri_e1[tri], js.tri_e2[tri]
    a11, a12, a22 = (jnp.sum(e1 * e1, -1), jnp.sum(e1 * e2, -1),
                     jnp.sum(e2 * e2, -1))
    r1, r2 = jnp.sum(dv * e1, -1), jnp.sum(dv * e2, -1)
    det = a11 * a22 - a12 * a12
    b1 = (r1 * a22 - r2 * a12) / det
    b2 = (r2 * a11 - r1 * a12) / det
    # a few triangles outside the light and barycentrics off the triangle
    tri = np.asarray(tri).copy()
    tri[::8] = js.tri_v0.shape[0] - 1
    b1 = np.asarray(b1).copy()
    b1[1::8] = 1.2
    mu = rs.random(R).astype(np.float32)
    j = JIP.invert_area_light_point(js, li, jnp.asarray(tri), jnp.asarray(b1),
                                    b2, jnp.asarray(mu))
    t = TIP.invert_area_light_point(
        ts, torch.zeros((R,), dtype=torch.int64), torch.from_numpy(tri),
        torch.from_numpy(b1), torch.from_numpy(np.array(b2)),
        torch.from_numpy(mu))
    assert (t[3].numpy() == np.asarray(j[3])).all()
    assert 0.5 < t[3].numpy().mean() < 1.0
    for a, b in zip(j[:3], t[:3]):
        assert _close(a, b).all()


@pytest.mark.parametrize("second_light", [False, True])
def test_invert_choose_light_matches_jax(second_light):
    js, jset, ts, tset = _both(second_light)
    assert tset.num_lights == (2 if second_light else 1)
    R = 256
    rs = np.random.default_rng(2)
    p = (rs.random((R, 3)) * [4, 2, 4] - [2, 1, 2]).astype(np.float32)
    li = rs.integers(-1, tset.num_lights + 1, R).astype(np.int32)
    mu = rs.random(R).astype(np.float32)
    ju, jok = JIP.invert_choose_light(js, jset, jnp.asarray(p),
                                      jnp.asarray(li), jnp.asarray(mu))
    tu, tok = TIP.invert_choose_light(ts, tset, torch.from_numpy(p),
                                      torch.from_numpy(li),
                                      torch.from_numpy(mu))
    assert (tok.numpy() == np.asarray(jok)).all()
    assert _close(ju, tu).all()
    if second_light:
        assert 0.3 < tok.numpy().mean() < 1.0


def test_invert_medium_distance_matches_jax():
    from tungsten_tpu.media.transmittance import (T_EXPONENTIAL, T_LINEAR,
                                                  sample_distance)
    R = 128
    rs = np.random.default_rng(2)
    u1 = jnp.asarray(rs.random(R), jnp.float32)
    u2 = jnp.asarray(rs.random(R), jnp.float32)
    tt = np.full((R,), T_EXPONENTIAL, np.int32)
    tt[::4] = T_LINEAR
    prm = jnp.zeros((R, 4))
    surf = jnp.ones((R,), bool)
    t = np.asarray(sample_distance(jnp.asarray(tt), prm, surf, u1, u2))
    t = t.copy()
    t[1::8] = -1.0
    ju, jok = JIP.invert_medium_distance(jnp.asarray(tt), prm, surf,
                                         jnp.asarray(t))
    tu, tok = TIP.invert_medium_distance(
        torch.from_numpy(tt), torch.zeros((R, 4)), torch.ones((R,), dtype=bool),
        torch.from_numpy(t))
    assert (tok.numpy() == np.asarray(jok)).all()
    assert 0.5 < tok.numpy().mean() < 1.0
    assert _close(ju, tu).all()
