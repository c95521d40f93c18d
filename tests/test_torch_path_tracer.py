"""The port's path tracer against the JAX package on the CPU: the
lambert + mirror scene of tests/test_output_buffers.py::_scene (mirror
floor, lambert walls, one area light) with an env map added, 32x24 at
2 spp, max_bounces 6, the default (Sobol') sampler.

  * per-ray wavefront state after 1, 2 and 4 bounce bodies: alive,
    pixel, throughput, emission, o and d agree lane for lane;
  * the rendered image agrees pixel for pixel with the JAX wave's image
    (its state after max_bounces bodies, summed by pixel), and with JAX's
    own render(), which gives that image to f32 rounding.

Both sides run the same scene: the JAX FlatScene is carried across with
flat_scene_from_numpy, and the RNG is bit-equal, so lanes can only part
where a traversal decides a grazing hit differently (XLA contracts the
compiled walk's multiply-adds, PyTorch's CPU kernels do not).  The JAX
side compiles once (`_jit_run`, shared by every bounce count) and the
port renders the carried scene once; module fixtures share both.
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu import render as jrender
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.render import render as trender
from tungsten_tpu_torch.scene.flatten import flat_scene_from_numpy
from tungsten_tpu_torch.scene.flatten import flatten_scene
from test_torch_flatten import jax_fields, scene_with_env

SPP = 2
SEED = 0xBA5EBA11
FIELDS = ("throughput", "emission", "o", "d")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    desc = scene_with_env(tmp_path_factory.mktemp("pt"), mirror_floor=True)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    assert jset.max_bounces == 6 and jset.stratified_sampler
    assert (tset.width, tset.height) == (32, 24)
    return js, jset, ts, tset, desc


def _ids(settings):
    n = settings.width * settings.height
    pixel = np.tile(np.arange(n, dtype=np.uint32), SPP)
    sample = np.repeat(np.arange(SPP, dtype=np.uint32), n)
    return pixel, sample


def _lanes_agree(js, ts):
    """(R,) bool: every compared field of the lane within rtol 1e-4,
    atol 1e-5."""
    ok = (np.asarray(js["alive"]) == ts["alive"].numpy()) & \
        (np.asarray(js["pixel"]).astype(np.int64) ==
         ts["pixel"].numpy().astype(np.int64) & 0xFFFFFFFF)
    for k in FIELDS:
        a = np.asarray(js[k])
        b = ts[k].numpy()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(axis=-1)
    return ok


@pytest.fixture(scope="module")
def traced(scenes):
    """Both packages' wavefront state after 0, 1, 2 and 4 bodies, and the
    JAX state after max_bounces bodies (its image), from one JAX
    compile."""
    js, jset, ts, tset, _ = scenes
    prev = jrng._SAMPLER
    jrng.set_sampler(jset.stratified_sampler)
    try:
        pixel, sample = _ids(jset)
        jstate = jrender._jit_init(js, jset, jnp.asarray(pixel),
                                   jnp.asarray(sample), np.uint32(SEED))
        tstate = tpt.init_wave(ts, tset,
                               torch.from_numpy(pixel.astype(np.int32)),
                               torch.from_numpy(sample.astype(np.int32)),
                               SEED)
        states = {0: (jstate, tstate)}
        for bounce in (1, 2, 4):
            jstate = jrender._jit_run(js, jset, np.uint32(SEED), jstate,
                                      bounce)
            tstate = tpt.run_bounces(ts, tset, SEED, tstate, bounce)
            states[bounce] = (jstate, tstate)
        jlast = jrender._jit_run(js, jset, np.uint32(SEED), jstate,
                                 jset.max_bounces)
    finally:
        jrng._SAMPLER = prev
    return states, {k: np.asarray(v) for k, v in jlast.items()}


@pytest.fixture(scope="module")
def port_image(scenes):
    ts, tset = scenes[2:4]
    return trender(ts, tset, spp=SPP, seed=SEED, spp_chunk=SPP,
                   return_stats=True, device="cpu")


def test_state_after_bounces_matches_jax(traced):
    states, _ = traced
    assert _lanes_agree(*states[0]).all()
    for bounce in (1, 2, 4):
        jstate, tstate = states[bounce]
        assert int(jstate["bounce"]) == tstate["bounce"] == bounce
        agree = _lanes_agree(jstate, tstate)
        assert agree.mean() >= 0.999, (bounce, agree.mean())
        # the comparison sees real work: live paths and banked light
        # (the open scene lets most paths escape within a few bounces)
        assert tstate["alive"].any()
        assert (tstate["emission"].sum(-1) > 0).float().mean() > 0.1


def _jax_image(j, settings):
    """The JAX wave's image: its banked emission summed by pixel, over
    SPP (what jrender.render returns for the same samples:
    test_image_matches_jax_render)."""
    e = np.where(np.isfinite(j["emission"]), j["emission"], 0.0)
    n = settings.width * settings.height
    img = np.zeros((n, 3), np.float64)
    np.add.at(img, j["pixel"].astype(np.int64), e)
    return (img / SPP).reshape(settings.height, settings.width, 3)


def test_image_matches_jax(scenes, traced, port_image):
    jlast = traced[1]
    assert int(jlast["bounce"]) == scenes[1].max_bounces
    jax_image = _jax_image(jlast, scenes[1])
    img, stats = port_image
    assert img.shape == jax_image.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    close = np.isclose(img, jax_image, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / jax_image.mean() - 1.0) <= 1e-4
    assert stats["rays"] > 0


def test_image_matches_jax_render(scenes, traced, port_image):
    """JAX's own render() (the staged, compacted chunk path) gives the
    JAX wave's image, which test_image_matches_jax and the BSDF zoo hold
    the port to, up to its f32 rounding; and the port's render() meets
    the same gates against it."""
    js, jset = scenes[:2]
    prev = jrng._SAMPLER
    try:
        jimg = np.asarray(jrender.render(js, jset, spp=SPP, seed=SEED,
                                         spp_chunk=SPP))
    finally:
        jrng._SAMPLER = prev
    wave = _jax_image(traced[1], jset)
    assert jimg.shape == wave.shape == (24, 32, 3)
    assert np.allclose(jimg, wave, rtol=1e-6, atol=1e-7)
    img = port_image[0]
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / jimg.mean() - 1.0) <= 1e-4


def test_carried_scene_renders_the_same_image(scenes, port_image):
    """The JAX tables carried across render the very image of the port's
    own flatten_scene: the two builds are equal field for field."""
    tset = scenes[3]
    own, _ = flatten_scene(copy.deepcopy(scenes[4]), device="cpu")
    a = port_image[0]
    b = trender(own, tset, spp=SPP, seed=SEED, spp_chunk=SPP, device="cpu")
    assert np.array_equal(a, b)
