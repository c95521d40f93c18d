"""The port's path tracer on curves against the JAX package on the CPU:
curves in all four modes, the three fiber BCSDFs, instances, and the
curve-aligned shading frame, through both NEE estimators.

Two scenes, built in memory (the curve files written with the port's
IO), 16x16 at 2 spp, max_bounces 6, the default (Sobol') sampler:
  * hair: the miniature of tests/test_fiber.py::test_hair_scene_render,
    seeded random-walk strands in bcsdf_cylinder mode with the hair
    BCSDF (one prim naming it, one taking the curves' default hair row)
    under an infinite_sphere_cap sun, and no triangle: the simple
    two-strategy sub-branch;
  * fibers: ribbon strands with rough_wire, half_cylinder strands with
    lambertian_fiber and cylinder strands with lambert, an `instances`
    primitive stamping a cube and a curve master, a floor and an area
    light: one-sample MIS.

Both packages run the very same scene (the JAX FlatScene carried across
with flat_scene_from_numpy) with bit-equal random numbers, so the
comparison is lane for lane: the per-ray state after 1, 2 and 4 bounce
bodies (alive, pixel, throughput, emission, o, d within rtol 1e-4 /
atol 1e-5), then the image pixel for pixel (rtol 1e-3 / atol 1e-4 on
>= 99 % of pixels, means within 1e-4).  One JAX compile a scene
(`_jit_run`, shared by every bounce count).

The share of lanes that must agree after 1 / 2 / 4 bodies is 99.5 % on
the hair scene, as on the analytic scenes, and 99.5 / 98 / 96 % on the
fibers scene.  A cylinder or half-cylinder hit takes its normal from
(p - spline point) / width: an ulp of the hit point p (XLA fuses o + d t,
PyTorch rounds twice) moves it by an ulp over the width, 4e-6 for
strands 0.03 wide, and every bounce off a strand amplifies the parting
(the 99th percentile of the lanes' direction differences: 1.3e-5 after
one body, 7.3e-5 after two, 9.5e-4 after four; 99.8 / 98.4 / 96.9 % of
the lanes agree).  A bcsdf_cylinder normal faces the viewer and is not
ill-conditioned so.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu import render as jrender
from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.render import render as trender
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_analytic_render import _ids, _jax_image, _lanes_agree, _np
from test_torch_curves import FIBERS, desc_of, strands, write_strands
from test_torch_flatten import jax_fields

W, H, SPP, BOUNCES = 16, 16, 2, 6
SEED = 0xBA5EBA11
CAMERA = {"type": "pinhole", "resolution": [W, H], "fov": 55,
          "transform": {"position": [0, 0.45, -1.3], "look_at": [0, 0.4, 0],
                        "up": [0, 1, 0]}}


def hair(tmp):
    a = write_strands(tmp, "a.fiber", strands(40, 8, seed=11, width=0.02))
    b = write_strands(tmp, "b.hair", strands(30, 8, seed=12, width=0.02,
                                             origin=(0.2, 0.0, 0.2)))
    return [FIBERS[0]], [
        {"type": "curves", "file": a, "bsdf_index": 0,
         "mode": "bcsdf_cylinder", "curve_thickness": 0.02},
        {"type": "curves", "file": b, "mode": "bcsdf_cylinder"},
        {"type": "infinite_sphere_cap", "emission": 100.0, "sample": True,
         "cap_angle": 10, "transform": {"rotation": [34, 0, 24]}}]


def fibers(tmp):
    wire = write_strands(tmp, "w.fiber", strands(24, 8, seed=13, width=0.03,
                                                 origin=(-0.3, 0.0, 0.0)))
    lamb = write_strands(tmp, "l.fiber", strands(24, 8, seed=14, width=0.03,
                                                 origin=(0.3, 0.0, 0.0)))
    cyl = write_strands(tmp, "c.fiber", strands(12, 8, seed=15, width=0.03,
                                                origin=(0.0, 0.1, -0.3),
                                                step=(0.1, 0.0, 0.0)))
    return copy.deepcopy(FIBERS), [
        {"type": "curves", "file": wire, "bsdf_index": 1, "mode": "ribbon"},
        {"type": "curves", "file": lamb, "bsdf_index": 2,
         "mode": "half_cylinder", "curve_taper": True},
        {"type": "instances", "bsdf_index": 3, "masters": [
            {"type": "cube", "transform": {"scale": 0.15}},
            {"type": "curves", "file": cyl, "mode": "cylinder"}],
         "instances": [
            {"id": 0, "transform": {"position": [0.45, 0.1, -0.35],
                                    "rotation": [0, 30, 0]}},
            {"id": 1, "transform": {"position": [0.0, 0.0, 0.0]}},
            {"id": 0, "transform": {"position": [-0.5, 0.6, -0.2]}}]},
        {"type": "quad", "bsdf_index": 3,
         "transform": {"position": [0, -0.05, 0], "scale": 3.0}},
        {"type": "quad", "bsdf_index": 3, "emission": [6.0, 5.5, 5.0],
         "transform": {"position": [0.2, 1.6, -0.6], "scale": 0.8,
                       "rotation": [180, 0, 0]}}]


SCENES = {"hair": hair, "fibers": fibers}
ONE_SAMPLE = {"hair": False, "fibers": True}
AGREE = {"hair": (0.995, 0.995, 0.995), "fibers": (0.995, 0.98, 0.96)}


def scene_desc(name, tmp):
    bsdfs, prims = SCENES[name](tmp)
    return desc_of(tmp, bsdfs, prims, camera=copy.deepcopy(CAMERA),
                   bounces=BOUNCES, spp=SPP)


@pytest.fixture(scope="module", params=list(SCENES))
def traced(request, tmp_path_factory):
    """Both packages' per-lane state after 1, 2 and 4 bodies, and the
    port's image; the JAX image comes from the state after BOUNCES."""
    name = request.param
    tmp = str(tmp_path_factory.mktemp(name))
    desc = scene_desc(name, tmp)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    prev = jrng._SAMPLER
    jrng.set_sampler(jset.stratified_sampler)
    try:
        pixel, sample = _ids()
        js_ = jrender._jit_init(js, jset, jnp.asarray(pixel),
                                jnp.asarray(sample), np.uint32(SEED))
        ts_ = tpt.init_wave(ts, tset, torch.from_numpy(pixel.astype(np.int32)),
                            torch.from_numpy(sample.astype(np.int32)), SEED)
        states = {0: (_np(js_), _np(ts_))}
        for b in (1, 2, 4, BOUNCES):
            js_ = jrender._jit_run(js, jset, np.uint32(SEED), js_, b)
            ts_ = tpt.run_bounces(ts, tset, SEED, ts_, b)
            assert int(js_["bounce"]) == ts_["bounce"] == b
            states[b] = (_np(js_), _np(ts_))
    finally:
        jrng._SAMPLER = prev
    img, stats = trender(ts, tset, spp=SPP, seed=SEED, spp_chunk=SPP,
                         return_stats=True, device="cpu")
    return dict(name=name, js=js, jset=jset, ts=ts, tset=tset, desc=desc,
                states=states, img=img, stats=stats)


def test_estimator_and_settings_match_jax(traced):
    """The hair scene takes the simple two-strategy sub-branch, the
    fibers scene one-sample MIS, in both packages; both see the same
    curve modes and BSDF types."""
    want = ONE_SAMPLE[traced["name"]]
    assert jpt._one_sample_mis(traced["jset"]) is want
    assert tpt._one_sample_mis(traced["tset"]) is want
    tset, jset = traced["tset"], traced["jset"]
    assert tset.has_curves and jset.has_curves
    assert tset.curve_modes == jset.curve_modes == (
        (2,) if traced["name"] == "hair" else (0, 1, 3))
    assert tset.present_bsdf_types == jset.present_bsdf_types
    if traced["name"] == "hair":
        assert traced["ts"].tri_v0.shape[0] == 0
        assert traced["ts"].hair_values.shape[0] == 2   # named + default


def test_state_after_bounces_matches_jax(traced):
    j0, t0 = traced["states"][0]
    assert _lanes_agree(j0, t0).all()
    for b, share in zip((1, 2, 4), AGREE[traced["name"]]):
        j, t = traced["states"][b]
        agree = _lanes_agree(j, t)
        assert agree.mean() >= share, (b, agree.mean())
    j, t = traced["states"][2]
    assert t["alive"].mean() > 0.05
    assert (t["emission"].sum(-1) > 0).mean() > 0.1


def test_image_matches_jax(traced):
    j, _ = traced["states"][BOUNCES]
    want = _jax_image(j)
    img = traced["img"]
    assert img.shape == want.shape == (H, W, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-4
    assert traced["stats"]["rays"] > 0


def test_own_flatten_renders_the_same_image(traced):
    """The port's own flatten_scene (its curve IO, piece BVH and hair
    tables) renders the very image of the JAX tables carried across."""
    own, _ = flatten_scene(copy.deepcopy(traced["desc"]), device="cpu")
    img = trender(own, traced["tset"], spp=SPP, seed=SEED, spp_chunk=SPP,
                  device="cpu")
    assert np.array_equal(img, traced["img"])
