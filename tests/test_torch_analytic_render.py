"""The port's path tracer on analytic primitives and their lights against
the JAX package on the CPU: the analytic sphere, disk and cylinder
(emissive and not), cap, point and skydome lights, the simple
two-strategy NEE and one-sample MIS over them.

Two scenes, built in memory (the aperture bitmap and env map written
with the port's IO), 16x16 at 2 spp, max_bounces 6, the default
(Sobol') sampler:
  * outdoor: a skydome and an infinite_sphere_cap sun along its up axis,
    a point light, an emissive sphere, disk and capped cylinder, an area
    quad, a non-emissive disk floor and cylinder pillar, lambert and
    mirror surfaces; a thinlens camera with a bitmap aperture, a cat eye
    and the mitchell_netravali filter.  The cap sends it down the simple
    sub-branch (an any-hit shadow segment and a closest-hit strategy
    ray) in both packages;
  * studio: the same analytic emitters and the point light without a
    cap, an env map, a mirror sphere, a pinhole camera: one-sample MIS
    in both packages.

Both packages run the very same scene (the JAX FlatScene carried across
with flat_scene_from_numpy) with bit-equal random numbers, so the
comparison is lane for lane: the per-ray state after 1, 2, 4 and 6
bounce bodies (alive, pixel, throughput, emission, o, d within rtol
1e-4 / atol 1e-5 on >= 99.5 % of lanes), then the image pixel for
pixel (rtol 1e-3 / atol 1e-4 on >= 99 % of pixels, means within 1e-4).
One JAX compile a scene (`_jit_run`, shared by every bounce count).
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from dataclasses import replace

from tungsten_tpu import render as jrender
from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.render import render as trender
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import jax_fields

W, H, SPP, BOUNCES = 16, 16, 2, 6
SEED = 0xBA5EBA11
FIELDS = ("throughput", "emission", "o", "d")

BSDFS = [{"name": "wall", "type": "lambert", "albedo": [0.7, 0.6, 0.5]},
         {"name": "mirror", "type": "mirror", "albedo": 0.9},
         {"name": "blue", "type": "lambert", "albedo": [0.2, 0.3, 0.8]}]
EMITTERS = [
    {"type": "sphere", "bsdf_index": 0, "emission": [6.0, 4.0, 2.0],
     "transform": {"position": [-0.9, 0.2, -0.3], "scale": 0.25}},
    {"type": "disk", "bsdf_index": 0, "power": [30.0, 30.0, 40.0],
     "cone_angle": 70.0,
     "transform": {"position": [0.4, 1.8, 0.2], "scale": 0.5,
                   "rotation": [180, 0, 0]}},
    {"type": "cylinder", "bsdf_index": 0, "emission": [1.5, 3.0, 1.5],
     "transform": {"position": [0.9, -0.2, -0.6], "scale": [0.3, 0.9, 0.3]}},
    {"type": "point", "emission": [3.0, 3.0, 2.5],
     "transform": {"position": [-0.3, 1.2, 1.0]}},
]
SOLIDS = [
    {"type": "disk", "bsdf_index": 0,
     "transform": {"position": [0, -0.65, 0], "scale": 4.0}},
    {"type": "cylinder", "bsdf_index": 2, "capped": True,
     "transform": {"position": [-0.2, -0.3, -1.0], "scale": [0.35, 0.7, 0.35],
                   "rotation": [0, 0, 12]}},
    {"type": "cube", "bsdf_index": 2,
     "transform": {"position": [0.1, -0.35, 0.1], "scale": 0.5,
                   "rotation": [0, 30, 0]}},
]
CAMERA = {"resolution": [W, H], "fov": 65,
          "transform": {"position": [0, 0.6, 3.2], "look_at": [0, 0, 0]}}


def outdoor(tmp):
    """Every light type of the slice; the cap takes the simple branch."""
    ap = np.zeros((9, 9, 3), np.float32)
    ap[1:8, 3:6] = 1.0
    ap[3:6, 1:8] = 0.5
    timage.save_hdr(os.path.join(tmp, "aperture.pfm"), ap)
    sun = {"rotation": [25, 0, 15]}
    return dict(
        bsdfs=BSDFS,
        # the area light before the analytic ones: their lanes read the
        # triangle alias table past its end (clamped, then discarded)
        primitives=SOLIDS + [
            {"type": "quad", "bsdf_index": 0, "emission": [4.0, 4.0, 4.0],
             "transform": {"position": [-1.2, 1.6, -0.8],
                           "scale": [0.5, 1, 0.5], "rotation": [0, 0, 160]}},
        ] + EMITTERS + [
            {"type": "quad", "bsdf_index": 1,
             "transform": {"position": [0.3, 0.5, -1.6], "scale": [1.5, 1, 1],
                           "rotation": [90, 0, 0]}},
            {"type": "skydome", "name": "sky", "turbidity": 3.5,
             "intensity": 1.0, "transform": sun},
            {"type": "infinite_sphere_cap", "cap_angle": 2.0,
             "power": [4.0, 3.6, 3.0], "transform": sun},
            {"type": "sphere", "name": "pivot", "bsdf_index": 1,
             "transform": {"position": [0.3, 0.05, 0.6], "scale": 0.3}}],
        camera=dict(CAMERA, type="thinlens", aperture="aperture.pfm",
                    aperture_size=0.08, cateye=0.04, focus_pivot="pivot",
                    reconstruction_filter="mitchell_netravali"))


def studio(tmp):
    """Analytic emitters and a point light under an env map, no cap:
    one-sample MIS."""
    r = np.random.default_rng(11)
    timage.save_hdr(os.path.join(tmp, "env.pfm"),
                    r.uniform(0.1, 0.8, (8, 16, 3)).astype(np.float32))
    return dict(
        bsdfs=BSDFS,
        primitives=SOLIDS + EMITTERS + [
            {"type": "sphere", "bsdf_index": 1,
             "transform": {"position": [0.3, 0.05, 0.6], "scale": 0.3}},
            {"type": "infinite_sphere", "emission": "env.pfm",
             "transform": {"rotation": [0, 40, 0]}}],
        camera=dict(CAMERA, type="pinhole"))


SCENES = {"outdoor": outdoor, "studio": studio}
ONE_SAMPLE = {"outdoor": False, "studio": True}


def scene_desc(name, tmp):
    return SceneDesc(path=os.path.join(tmp, "scene.json"), json={},
                     integrator={"max_bounces": BOUNCES},
                     renderer={"spp": SPP}, media=[], **SCENES[name](tmp))


def _ids():
    n = W * H
    return (np.tile(np.arange(n, dtype=np.uint32), SPP),
            np.repeat(np.arange(SPP, dtype=np.uint32), n))


def _np(state):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor)
            else v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module", params=list(SCENES))
def traced(request, tmp_path_factory):
    """Both packages' per-lane state after 1, 2, 4 and BOUNCES bodies, and
    the port's image."""
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


def test_estimator_choice_matches_jax(traced):
    """A cap scene takes the simple two-strategy sub-branch, a scene of
    analytic lights without caps one-sample MIS, in both packages."""
    want = ONE_SAMPLE[traced["name"]]
    assert jpt._one_sample_mis(traced["jset"]) is want
    assert tpt._one_sample_mis(traced["tset"]) is want
    tset = traced["tset"]
    assert tset.has_disk_lights and tset.has_cyl_lights and \
        tset.has_sphere_lights and tset.has_points and tset.has_env
    assert tset.num_caps == (0 if want else 1)


def _lanes_agree(j, t):
    ok = (j["alive"] == t["alive"]) & \
        (j["pixel"].astype(np.int64) == t["pixel"].astype(np.int64))
    for k in FIELDS:
        ok &= np.isclose(t[k], j[k], rtol=1e-4, atol=1e-5).all(axis=-1)
    return ok


def test_state_after_bounces_matches_jax(traced):
    j0, t0 = traced["states"][0]
    assert _lanes_agree(j0, t0).all()
    if traced["name"] == "outdoor":
        # the cat eye vignettes some camera samples: weight 0 lanes stay
        # in the wave, dead
        assert 0 < (~t0["alive"]).sum() < t0["alive"].size // 2
    for b in (1, 2, 4, BOUNCES):
        j, t = traced["states"][b]
        agree = _lanes_agree(j, t)
        assert agree.mean() >= 0.995, (b, agree.mean())
    j, t = traced["states"][2]
    assert t["alive"].any()
    assert (t["emission"].sum(-1) > 0).mean() > 0.3


def _jax_image(j):
    e = np.where(np.isfinite(j["emission"]), j["emission"], 0.0)
    img = np.zeros((W * H, 3), np.float64)
    np.add.at(img, j["pixel"].astype(np.int64), e)
    return (img / SPP).reshape(H, W, 3)


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
    """The port's own flatten_scene (the sky baked, the aperture read by
    the port) renders the very image of the JAX tables carried across."""
    own, _ = flatten_scene(copy.deepcopy(traced["desc"]), device="cpu")
    img = trender(own, traced["tset"], spp=SPP, seed=SEED, spp_chunk=SPP,
                  device="cpu")
    assert np.array_equal(img, traced["img"])
