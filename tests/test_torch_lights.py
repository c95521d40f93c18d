"""The port's analytic primitives and their lights against the JAX
package on the CPU:
  * flatten_scene on scenes with the disk, sphere, cylinder,
    infinite_sphere_cap, point and skydome primitives (emissive and not,
    by emission and by power): every FlatScene field equal, and the
    settings;
  * the sky bake (scene/sky.py::generate_sky) bit-equal;
  * every light sample and pdf of the slice on seeded shading points and
    random numbers (rtol 1e-5 / atol 1e-6), the light selection with
    point lights, the escaped-ray cap radiance, and the hit expansion of
    analytic hits;
  * the traversal front: an analytic sphere outside the triangles' box
    is hit (the scene-wide occluder bounds cover analytic prims), and a
    scene without triangles returns straight after the analytic test.
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.integrators import lights as jL
from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.ops import intersect as jis
from tungsten_tpu.scene import sky as jsky
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.integrators import lights as tL
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.ops import intersect as tis
from tungsten_tpu_torch.scene import sky as tsky
from tungsten_tpu_torch.scene.flatten import (
    LIGHT_CAP, LIGHT_CYLINDER, LIGHT_DISK, LIGHT_POINT, LIGHT_SPHERE,
    RenderSettings, flatten_scene)
from test_torch_analytic_render import outdoor
from test_torch_flatten import _assert_same_scene, jax_fields
from dataclasses import fields

TOL = dict(rtol=1e-5, atol=1e-6)
R = 512

FLOOR = {"type": "quad", "bsdf_index": 0,
         "transform": {"position": [0, -1, 0], "scale": [4, 1, 4]}}
PRIMS = {
    "disk": [{"type": "disk", "bsdf_index": 0, "emission": [2, 3, 4],
              "cone_angle": 60,
              "transform": {"position": [0, 1, 0], "scale": [0.5, 1, 0.7],
                            "rotation": [170, 10, 0]}},
             {"type": "disk", "bsdf_index": 0,
              "transform": {"position": [0, -0.9, 0], "scale": 3}}],
    "sphere": [{"type": "sphere", "bsdf_index": 0, "power": [20, 20, 10],
                "transform": {"position": [0.4, 0.2, 0], "scale": 0.3}},
               {"type": "sphere", "bsdf_index": 0,
                "transform": {"position": [-0.4, 0.2, 0], "scale": 0.2}}],
    "cylinder": [{"type": "cylinder", "bsdf_index": 0, "power": [9, 9, 9],
                  "transform": {"position": [0, 0, 0],
                                "scale": [0.4, 1.2, 0.4],
                                "rotation": [20, 0, 30]}},
                 {"type": "cylinder", "bsdf_index": 0, "capped": False,
                  "emission": [1, 2, 3], "sample": False,
                  "transform": {"position": [1, 0, 0], "scale": 0.5}}],
    "infinite_sphere_cap": [
        {"type": "infinite_sphere_cap", "cap_angle": 5, "power": [3, 3, 2],
         "transform": {"rotation": [30, 0, 10]}},
        {"type": "infinite_sphere_cap", "emission": [1, 1, 1],
         "sample": False, "transform": {"rotation": [-60, 0, 0]}}],
    "point": [{"type": "point", "emission": [2, 2, 1],
               "transform": {"position": [0.5, 1.5, 0.5]}},
              {"type": "point", "power": [4, 4, 4],
               "transform": {"position": [-1, 1, 0]}}],
    "skydome": [{"type": "skydome", "turbidity": 5.0, "intensity": 1.5,
                 "temperature": 6500.0,
                 "transform": {"rotation": [40, 0, 20]}}],
}


def _desc(tmp, prims):
    return SceneDesc(path=os.path.join(tmp, "scene.json"), json={},
                     bsdfs=[{"type": "lambert", "albedo": 0.5}], media=[],
                     primitives=[FLOOR] + prims,
                     camera={"type": "pinhole", "resolution": [8, 8]},
                     integrator={"type": "path_tracer"}, renderer={})


def _both(desc):
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    return js, jset, ts, tset


@pytest.mark.parametrize("kind", list(PRIMS) + ["all"])
def test_flat_scene_equals_jax(tmp_path, kind):
    prims = sum(PRIMS.values(), []) if kind == "all" else PRIMS[kind]
    js, jset, ts, tset = _both(_desc(str(tmp_path), copy.deepcopy(prims)))
    _assert_same_scene(ts, jax_fields(js))
    for f in fields(RenderSettings):
        assert getattr(tset, f.name) == getattr(jset, f.name), f.name
    assert tset.num_lights == int(jset.num_lights) >= 1


@pytest.mark.parametrize("sun,kw", [
    ([0.3, 0.8, 0.2], {}),
    ([0.0, 1.0, 0.0], dict(turbidity=8.0, intensity=0.5)),
    ([0.9, 0.05, -0.2], dict(temperature=3500.0, gamma_scale=1.3)),
    ([0.2, -0.4, 0.6], dict(turbidity=1.5, width=64, height=32))])
def test_generate_sky_bit_equal(sun, kw):
    a = tsky.generate_sky(sun, **kw)
    b = jsky.generate_sky(sun, **kw)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a, b)
    assert a.max() > 0


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    """The render test's outdoor scene (every light type of the slice) in
    both packages, with seeded shading points and random numbers."""
    tmp = str(tmp_path_factory.mktemp("lights"))
    desc = SceneDesc(path=os.path.join(tmp, "scene.json"), json={},
                     integrator={}, renderer={}, media=[], **outdoor(tmp))
    js, jset, ts, tset = _both(desc)
    r = np.random.default_rng(17)
    p = r.uniform([-1.5, -0.6, -1.5], [1.5, 2.0, 1.5], (R, 3)).astype(
        np.float32)
    u = r.random((4, R), dtype=np.float32)
    return dict(js=js, jset=jset, ts=ts, tset=tset, p=p, u=u)


def _lights_of(lit, kind):
    lt = lit["ts"].light_type.numpy()[:lit["tset"].num_lights]
    ids = np.nonzero(lt == kind)[0]
    assert len(ids), kind
    return np.resize(ids, R).astype(np.int32)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if a.dtype == bool or b.dtype == bool:
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **TOL)


# eight f32 ulps of 1: the precision a cosine near 1 carries
COS_ULPS = 8 * 2.0 ** -24


def _sample_dicts_close(td, jd, cone=None):
    """The light sample's fields on the valid lanes.  A sphere's cone
    sample (`cone` = (center, radius, p, u2)) takes its pdf from
    1 - cos_max and its distance from the quadric root, both of which
    cancel; they are held to what a COS_ULPS change of cos_max moves
    them by, the directions to TOL."""
    ok = np.asarray(jd["valid"])
    assert np.array_equal(td["valid"].numpy(), ok)
    assert ok.mean() > 0.2
    for k in ("d", "emission") if cone else ("d", "dist", "pdf", "emission"):
        _close(td[k][_t(ok)], np.asarray(jd[k])[ok])
    if cone is None:
        return
    c, r, p, u2 = (np.asarray(x, np.float64)[ok] for x in cone)
    pdf_t, pdf_j = td["pdf"].numpy()[ok], np.asarray(jd["pdf"])[ok]
    one_minus = lambda pdf: (1.0 / (2.0 * np.pi)) / pdf   # 1 - cos_max
    assert np.abs(one_minus(pdf_t) - one_minus(pdf_j)).max() <= COS_ULPS
    # d dist / d cos_max = dist_c u2 (1 - B / det), B = dist_c z
    dist_c = np.linalg.norm(c - p, axis=-1)
    C = dist_c ** 2 - r ** 2
    z = 1.0 - u2 * one_minus(pdf_j.astype(np.float64))
    B = dist_c * z
    det = np.sqrt(np.maximum(B * B - C, 1e-30))
    slack = dist_c * u2 * (1.0 + B / det) * COS_ULPS
    dist_t, dist_j = td["dist"].numpy()[ok], np.asarray(jd["dist"])[ok]
    assert (np.abs(dist_t - dist_j) <= slack + 1e-5 * np.abs(dist_j)).all()


@pytest.mark.parametrize("kind", ["sphere", "disk", "cylinder"])
def test_analytic_light_samples(lit, kind):
    js, ts, p, u = lit["js"], lit["ts"], lit["p"], lit["u"]
    code = {"sphere": LIGHT_SPHERE, "disk": LIGHT_DISK,
            "cylinder": LIGHT_CYLINDER}[kind]
    li = _lights_of(lit, code)
    if kind == "sphere":
        td = tL.sphere_light_sample(ts, _t(li), _t(p), _t(u[0]), _t(u[1]))
        jd = jL.sphere_light_sample(js, _j(li), _j(p), _j(u[0]), _j(u[1]))
        slot = ts.light_slot[_t(li)].long()
        cone = (ts.sph_center[slot], ts.sph_radius[slot], p, u[1])
        tdp = tL.sphere_light_direct_pdf(ts, _t(li), _t(p)).numpy()
        jdp = np.asarray(jL.sphere_light_direct_pdf(js, _j(li), _j(p)))
        assert np.abs(1.0 / tdp - 1.0 / jdp).max() / (2 * np.pi) <= COS_ULPS
    elif kind == "disk":
        td = tL.disk_light_sample(ts, _t(li), _t(p), _t(u[0]), _t(u[1]))
        jd = jL.disk_light_sample(js, _j(li), _j(p), _j(u[0]), _j(u[1]))
    else:
        td = tL.cyl_light_sample(ts, _t(li), _t(p), _t(u[0]), _t(u[1]),
                                 _t(u[2]))
        jd = jL.cyl_light_sample(js, _j(li), _j(p), _j(u[0]), _j(u[1]),
                                 _j(u[2]))
        slot = ts.light_slot[_t(li)].long()
        tq, tn = tL.cyl_position_sample(ts, slot, _t(u[0]), _t(u[1]),
                                        _t(u[2]))
        jq, jn = jL.cyl_position_sample(js, _j(slot.numpy()), _j(u[0]),
                                        _j(u[1]), _j(u[2]))
        _close(tq, jq)
        _close(tn, jn)
    _sample_dicts_close(td, jd, cone if kind == "sphere" else None)
    # the bsdf strategy's pdf of a hit on this light, through the
    # sphere-aware area pdf
    hit_t = np.asarray(jd["dist"])
    n = -np.asarray(jd["d"])
    for has_sph in (False, True):
        a = tL.area_light_direct_pdf(ts, _t(li), _t(hit_t), td["d"], _t(n),
                                     p=_t(p), has_sphere_lights=has_sph)
        b = jL.area_light_direct_pdf(js, _j(li), _j(hit_t), jd["d"], _j(n),
                                     p=_j(p), has_sphere_lights=has_sph)
        if has_sph and kind == "sphere":   # the cone pdf, as above
            b = np.asarray(b)
            assert np.abs(1.0 / a.numpy() - 1.0 / b).max() / (2 * np.pi) \
                <= COS_ULPS
        else:
            _close(a, b)


def test_cap_and_point_terms(lit):
    js, ts, p, u = lit["js"], lit["ts"], lit["p"], lit["u"]
    li = _lights_of(lit, LIGHT_CAP)
    td, tpdf = tL.cap_light_sample(ts, _t(li), _t(u[0]), _t(u[1]))
    jd, jpdf = jL.cap_light_sample(js, _j(li), _j(u[0]), _j(u[1]))
    _close(td, jd)
    _close(tpdf, jpdf)
    cos = ts.light_aux[_t(li), 3]
    _close(tL.cap_pdf_value(cos), jL.cap_pdf_value(_j(cos.numpy())))
    # sampled directions lie in the cap
    assert bool((torch.sum(td * ts.light_aux[_t(li), :3], -1) >=
                 cos - 1e-6).all())
    # the escaped-ray cap radiance: the sampled directions (inside) and
    # random ones (mostly outside), split by the samplable flag
    r = np.random.default_rng(3)
    rnd = r.normal(size=(R, 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    for d in (td.numpy(), rnd):
        ts_, tu_ = tL.eval_caps(ts, _t(d))
        js_, ju_ = jL.eval_caps(js, _j(d))
        _close(ts_, js_)
        _close(tu_, ju_)
    assert float(tL.eval_caps(ts, td)[0].sum()) > 0
    # selection weights with point lights (1/r^2) beside the others
    tw, ttot = tL._choose_light_weights(ts, lit["tset"], _t(p))
    jw, jtot = jL._choose_light_weights(js, lit["jset"], _j(p))
    _close(tw, jw)
    _close(ttot, jtot)
    tli, tsw = tL.choose_light(ts, lit["tset"], _t(p), _t(u[3]))
    jli, jsw = jL.choose_light(js, lit["jset"], _j(p), _j(u[3]))
    assert np.array_equal(tli.numpy(), np.asarray(jli))
    _close(tsw, jsw)
    kinds = set(ts.light_type[tli.long()].tolist())
    assert {LIGHT_CAP, LIGHT_POINT, LIGHT_SPHERE} <= kinds


def test_analytic_hit_expansion(lit):
    """Rays from seeded points toward the analytic prims: the same hits,
    and _expand_hit / _hit_ng of the sphere, disk and cylinder channels
    (position, normals, uv, primitive) equal the JAX package's."""
    js, ts, p = lit["js"], lit["ts"], lit["p"]
    centers = np.concatenate([ts.sph_center.numpy(), ts.dsk_c.numpy(),
                              ts.cyl_pos.numpy()])
    r = np.random.default_rng(9)
    tgt = centers[r.integers(0, len(centers), R)] + \
        r.normal(scale=0.15, size=(R, 3)).astype(np.float32)
    d = tgt - p
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tres = tis.bvh_intersect(ts, _t(p), _t(d), 0.0, 3.0e38)
    jres = jis.bvh_intersect(js, _j(p), _j(d), 0.0, 3.0e38)
    for ch in ("sph", "dsk", "cyl", "tri"):
        assert np.array_equal(tres[ch].numpy(), np.asarray(jres[ch])), ch
        if ch != "tri":
            assert (tres[ch] >= 0).any(), ch
    ti = tpt._expand_hit(ts, _t(p), _t(d), tres)
    ji = jpt._expand_hit(js, _j(p), _j(d), jres)
    ana = _t(np.asarray(jres["tri"]) < 0) & tres["hit"]
    for k in ("p", "ng", "ns", "uv"):
        _close(ti[k][ana], np.asarray(ji[k])[ana.numpy()])
    assert np.array_equal(ti["prim"].numpy(), np.asarray(ji["prim"]))
    _close(tpt._hit_ng(ts, tres, _t(p), _t(d))[ana],
           np.asarray(jpt._hit_ng(js, jres, _j(p), _j(d)))[ana.numpy()])


def test_geo_bounds_cover_analytic_prims(tmp_path):
    """A sphere far outside the triangles' box is still hit: geo_clip
    cuts far limits at the scene-wide occluder box, so that box must hold
    the analytic prims, as the JAX package's does."""
    desc = _desc(str(tmp_path), [
        {"type": "sphere", "bsdf_index": 0,
         "transform": {"position": [0, 0, -20], "scale": 1.0}},
        {"type": "disk", "bsdf_index": 0,
         "transform": {"position": [15, 0, 0], "scale": 1.0,
                       "rotation": [0, 0, 90]}},
        {"type": "cylinder", "bsdf_index": 0,
         "transform": {"position": [0, 12, 0], "scale": 1.0}}])
    js, _, ts, _ = _both(desc)
    assert np.array_equal(ts.geo_lo.numpy(), np.asarray(js.geo_lo))
    assert np.array_equal(ts.geo_hi.numpy(), np.asarray(js.geo_hi))
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    res = tis.bvh_intersect(ts, o, d, 0.0, 3.0e38)
    assert res["hit"].all()
    assert res["sph"][0] == 0 and res["dsk"][1] == 0 and res["cyl"][2] == 0
    np.testing.assert_allclose(res["t"].numpy(), [19.0, 15.0, 11.5],
                               rtol=1e-5)
    occ = tis.bvh_intersect(ts, o, d, 0.0, torch.tensor([25.0, 10.0, 12.0]),
                            any_hit=True)["hit"]
    assert occ.tolist() == [True, False, True]


def test_scene_without_triangles(tmp_path):
    """Analytic prims only: the traversal returns after the analytic test
    (no triangle walk), with the JAX package's result."""
    desc = _desc(str(tmp_path), copy.deepcopy(PRIMS["sphere"]
                                              + PRIMS["disk"]))
    desc.primitives = desc.primitives[1:]            # drop the floor quad
    js, _, ts, _ = _both(desc)
    assert ts.tri_v0.shape[0] == 0
    r = np.random.default_rng(1)
    o = r.uniform(-2, 2, (64, 3)).astype(np.float32)
    d = r.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for any_hit in (False, True):
        tres = tis.bvh_intersect(ts, _t(o), _t(d), 0.0, 3.0e38, any_hit)
        jres = jis.bvh_intersect(js, _j(o), _j(d), 0.0, 3.0e38, any_hit)
        for k in ("sph", "dsk", "tri", "hit"):
            assert np.array_equal(tres[k].numpy(), np.asarray(jres[k])), k
        hit = tres["hit"].numpy()
        assert hit.any()
        _close(tres["t"][_t(hit)], np.asarray(jres["t"])[hit])
