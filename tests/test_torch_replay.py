"""The port's path-replay gradients (integrators/path_tracer.py::
trace_wave_replay, a torch.autograd.Function) against the JAX package's
on the CPU, against finite differences of the port's own renders, and
the replay's bit-exactness.

The scene lives in memory (and the test's temporary directory): a
Cornell-like box of lambert walls, the back wall with an 8x8 .pfm bitmap
albedo, a rough_conductor block, an oren_nayar wall at roughness exactly
1.0 (on its clip, jnp.clip(roughness, 0.01, 1.0) in
tungsten_tpu/bsdf/eval.py) and a quad light; 24x16, 1 spp, max_bounces
16 (Russian roulette active from the fourth bounce); one-sample MIS.
tests/test_torch_replay_media.py adds the same box in a fog.

The JAX gradient of the mean radiance comes from one compile (a module
fixture), taken w.r.t. tex_const, light_emission, bsdf_params and
bitmaps[0]; the JAX FlatScene is carried across with
flat_scene_from_numpy so both packages trace the very same scene with
bit-equal random numbers.  Tolerance: rtol 1e-3 on the entries above
1e-3 * max|g| of their field, the rest within 1e-3 * max|g| (the two
packages round the shading chain's f32 sums differently; the largest
deviation seen is 1.1e-5 relative).
"""
import copy
import os
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.bsdf.types import P
from tungsten_tpu.integrators.path_tracer import trace_wave_replay as jreplay
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from tungsten_tpu_torch.utils import vecmath as vm
from test_torch_flatten import jax_fields

SEED = 42
RTOL = 1e-3
BOX_FIELDS = ("tex_const", "light_emission", "bsdf_params", "bitmaps")
OREN_NAYAR = 4    # the oren_nayar row of the box's BSDFs


def _quad(b, pos, scale, rot=(0, 0, 0), **kw):
    return dict(type="quad", bsdf_index=b, transform=dict(
        position=list(pos), scale=scale, rotation=list(rot)), **kw)


BOX_BSDFS = [{"type": "lambert", "albedo": [0.7, 0.7, 0.7]},
             {"type": "lambert", "albedo": [0.7, 0.2, 0.2]},
             {"type": "lambert", "albedo": "wall.pfm"},
             {"type": "rough_conductor", "material": "Cu",
              "roughness": 0.3, "distribution": "ggx"},
             {"type": "oren_nayar", "albedo": [0.3, 0.6, 0.3],
              "roughness": 1.0}]


def box_desc(tmp, fog=False, res=(24, 16), max_bounces=16, bsdfs=None):
    tex = np.full((8, 8, 3), 0.4, np.float32)
    tex[2:6, 2:6] = [0.8, 0.3, 0.2]
    timage.save_hdr(os.path.join(tmp, "wall.pfm"), tex)
    media = []
    camera = {"type": "pinhole", "resolution": list(res), "fov": 60,
              "transform": {"position": [0, 1.5, 5.0],
                            "look_at": [0, 1.2, 0]}}
    if fog:
        media = [{"name": "fog", "type": "homogeneous", "sigma_a": 0.04,
                  "sigma_s": [0.25, 0.3, 0.35],
                  "phase_function": {"type": "henyey_greenstein",
                                     "g": 0.4}}]
        camera["medium_index"] = 0
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={},
        bsdfs=copy.deepcopy(bsdfs or BOX_BSDFS),
        primitives=[
            _quad(0, (0, 0, 0), [4, 1, 4]),                   # floor
            _quad(0, (0, 3, 0), [4, 1, 4], (0, 0, 180)),      # ceiling
            _quad(2, (0, 1.5, -2), [4, 1, 3], (90, 0, 0)),    # back wall
            _quad(1, (-2, 1.5, 0), [3, 1, 4], (0, 0, -90)),   # left wall
            _quad(4, (2, 1.5, 0), [3, 1, 4], (0, 0, 90)),     # right wall
            {"type": "cube", "bsdf_index": 3,
             "transform": {"position": [0.4, 0.5, -0.5],
                           "scale": [0.8, 1.0, 0.8], "rotation": [0, 25, 0]}},
            _quad(0, (0, 2.98, 0), 1.0, (0, 0, 180),
                  emission=[6.0, 6.0, 6.0]),
        ],
        media=media, camera=camera,
        integrator={"type": "path_tracer", "max_bounces": max_bounces},
        renderer={"spp": 1})


def _ids(settings):
    n = settings.width * settings.height
    return (torch.arange(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))


def _jax_params(js, names):
    return tuple(js.bitmaps[0] if k == "bitmaps" else getattr(js, k)
                 for k in names)


def _with(scene, names, values):
    """scene.replace of the fields `names` (bitmaps: its slot 0)."""
    ch = {}
    for k, v in zip(names, values):
        ch[k] = (v,) + tuple(scene.bitmaps[1:]) if k == "bitmaps" else v
    return scene.replace(**ch)


def jax_grads(js, jset, names):
    """One compile: the mean radiance and its gradient w.r.t. names."""
    n = jset.width * jset.height

    @partial(jax.jit, static_argnums=(2,))
    def loss(params, scene, settings):
        rad = jreplay(_with(scene, names, params), settings,
                      jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros(n, jnp.uint32), jnp.uint32(SEED))
        return jnp.mean(rad)

    prev = jrng._SAMPLER
    jrng.set_sampler(jset.stratified_sampler)
    try:
        v, g = jax.value_and_grad(loss)(_jax_params(js, names), js, jset)
    finally:
        jrng._SAMPLER = prev
    return float(v), [np.asarray(x) for x in g]


def port_grads(ts, tset, names, values=None):
    """The port's mean radiance, its gradients w.r.t. names (leaves
    holding `values`, default the scene's own), L and the replay's
    ReplayStats."""
    vals = values or [ts.bitmaps[0] if k == "bitmaps" else getattr(ts, k)
                      for k in names]
    leaves = [v.detach().clone().requires_grad_() for v in vals]
    pixel, sample = _ids(tset)
    L, stats = tpt.trace_wave_replay(_with(ts, names, leaves), tset, pixel,
                                     sample, SEED, with_stats=True)
    loss = L.mean()
    loss.backward()
    return (float(loss.detach()), [x.grad.numpy() for x in leaves],
            L.detach(), stats)


def scenes(tmp, **kw):
    """(JAX scene, JAX settings, the port's carried scene, the port's
    settings) of box_desc(tmp, **kw)."""
    desc = box_desc(str(tmp), **kw)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    return js, jset, ts, tset


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    js, jset, ts, tset = scenes(tmp_path_factory.mktemp("box"))
    assert tpt._one_sample_mis(tset) and jset.max_bounces == 16
    jv, jg = jax_grads(js, jset, BOX_FIELDS)
    tv, tg, L, stats = port_grads(ts, tset, BOX_FIELDS)
    return dict(ts=ts, tset=tset, jv=jv, jg=jg, tv=tv, tg=tg, L=L,
                stats=stats)


def _assert_grads_close(name, got, want):
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    m = np.abs(want).max()
    assert m > 0, f"{name}: the JAX gradient vanished"
    big = np.abs(want) > 1e-3 * m
    np.testing.assert_allclose(got[big], want[big], rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=1e-3 * m,
                               err_msg=name)


@pytest.mark.parametrize("field", BOX_FIELDS)
def test_box_gradients_match_jax(box, field):
    i = BOX_FIELDS.index(field)
    assert box["tv"] == pytest.approx(box["jv"], rel=1e-5)
    _assert_grads_close(field, box["tg"][i], box["jg"][i])


def test_roughness_on_its_clip_matches_jax(box):
    """The oren_nayar wall's roughness sits at 1.0, on jnp.clip's upper
    bound, where JAX's derivative is 0.5 (jnp.maximum / jnp.minimum
    split a tie evenly) and torch.clamp's is 1: the port's clip takes
    JAX's, so the gradient agrees there too (with torch.clamp it did
    not)."""
    ts = box["ts"]
    assert float(ts.bsdf_params[OREN_NAYAR, P.ROUGHNESS]) == 1.0
    want = box["jg"][2][OREN_NAYAR, P.ROUGHNESS]
    got = box["tg"][2][OREN_NAYAR, P.ROUGHNESS]
    assert abs(want) > 1e-4
    assert got == pytest.approx(want, rel=RTOL)


def test_clip_tie_derivative_is_jax():
    x = np.array([1.0, 0.5, 0.01, 0.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.01, 1.0)))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    vm.clip(t, 0.01, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[0] == want[2] == 0.5
    with torch.no_grad():
        assert torch.equal(vm.clip(t, 0.01, 1.0), torch.clamp(t, 0.01, 1.0))


def test_replay_is_bitwise(box):
    """The forward's L equals trace_wave's radiance lane for lane (full
    width, no compaction), and the backward, re-tracing every bounce
    under autograd, ends on the forward's L bit for bit."""
    ts, tset, L = box["ts"], box["tset"], box["L"]
    pixel, sample = _ids(tset)
    rad = tpt.trace_wave(ts, tset, pixel, sample, SEED,
                         min_wave=pixel.shape[0] + 1)
    assert torch.equal(rad, L)
    stats = box["stats"]
    assert torch.equal(stats.emission, L)
    # Russian roulette ran (it starts at the fourth bounce) and the
    # wave died out before the limit
    assert 4 < stats.bodies <= tset.max_bounces


def test_forward_saves_nothing_per_bounce(box):
    """The replay node keeps (pixel, sample, L, params) and nothing else:
    the forward's memory does not grow with depth (the backward holds
    one bounce body's graph at a time)."""
    ts, tset = box["ts"], box["tset"]
    leaf = ts.light_emission.detach().clone().requires_grad_()
    pixel, sample = _ids(tset)
    L = tpt.trace_wave_replay(ts.replace(light_emission=leaf), tset, pixel,
                              sample, SEED)
    saved = L.grad_fn.saved_tensors
    assert len(saved) == 4
    assert saved[0] is pixel and saved[1] is sample
    assert torch.equal(saved[2], L) and saved[3] is leaf


def _fd(ts, tset, names, values, which, index, eps):
    """Central difference of the mean radiance in values[which][index]."""
    out = []
    for s in (1.0, -1.0):
        v = [x.detach().clone() for x in values]
        v[which][index] += s * eps
        pixel, sample = _ids(tset)
        L, _ = tpt.replay_forward(_with(ts, names, v), tset, pixel, sample,
                                  SEED)
        out.append(float(L.double().mean()))
    return (out[0] - out[1]) / (2 * eps)


def rough_bitmap_desc(tmp):
    """tests/test_diff.py::_rough_bitmap_scene, the scene its roughness
    and bitmap-texel gates were stated for: a rough_conductor floor and
    a bitmap-textured lambert back wall under a quad light, 24x16,
    max_bounces 3."""
    tex = np.full((8, 8, 3), 0.4, np.float32)
    tex[2:6, 2:6] = [0.8, 0.3, 0.2]
    timage.save_hdr(os.path.join(tmp, "wall.pfm"), tex)
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={},
        bsdfs=[{"type": "rough_conductor", "material": "Cu",
                "roughness": 0.25, "distribution": "ggx"},
               {"type": "lambert", "albedo": "wall.pfm"}],
        primitives=[
            _quad(0, (0, 0, 0), [4, 1, 4]),
            _quad(1, (0, 1, -1.5), [4, 1, 2], (90, 0, 0)),
            _quad(1, (0, 2.5, 0), 1.5, (0, 0, 180), emission=[8.0] * 3)],
        media=[],
        camera={"type": "pinhole", "resolution": [24, 16], "fov": 60,
                "transform": {"position": [0, 1.2, 3.2],
                              "look_at": [0, 0.8, 0]}},
        integrator={"type": "path_tracer", "max_bounces": 3},
        renderer={"spp": 1})


@pytest.fixture(scope="module")
def shallow(tmp_path_factory):
    """The port's gradients at max_bounces 3 (no Russian roulette): the
    box, and tests/test_diff.py's rough-conductor + bitmap scene."""
    from dataclasses import replace
    out = {}
    _, _, ts, tset = scenes(tmp_path_factory.mktemp("fd"))
    out["box"] = (ts, replace(tset, max_bounces=3))
    ts, tset = flatten_scene(rough_bitmap_desc(
        str(tmp_path_factory.mktemp("rough"))), device="cpu")
    assert tset.max_bounces == 3
    out["rough"] = (ts, tset)
    for k, (ts, tset) in out.items():
        values = [ts.bitmaps[0] if f == "bitmaps" else getattr(ts, f)
                  for f in BOX_FIELDS]
        _, g, _, _ = port_grads(ts, tset, BOX_FIELDS, values)
        out[k] = (ts, tset, values, g)
    return out


@pytest.mark.parametrize("case", ["albedo", "emission", "roughness",
                                  "bitmap"])
def test_gradient_matches_finite_differences(shallow, case):
    """The JAX tests' gates (tests/test_diff.py): albedo 5e-2 on the two
    largest entries, emission 2e-2 (on the box), roughness 0.2 (finite
    differences move the microfacet warp too, which the detached
    estimator leaves out: they differ by the sampling score term) and a
    bitmap texel 8e-2 (on test_diff's own scene for these two)."""
    ts, tset, values, g = shallow["box" if case in ("albedo", "emission")
                                  else "rough"]
    if case == "albedo":
        gt = g[0]
        picks = [np.unravel_index(i, gt.shape)
                 for i in np.argsort(-np.abs(gt).ravel())[:2]]
        which, eps, gate = 0, 1e-3, 5e-2
    elif case == "emission":
        which, picks, eps, gate = 1, [(0, 0)], 1e-2, 2e-2
    elif case == "roughness":
        which, picks, eps, gate = 2, [(0, P.ROUGHNESS)], 5e-3, 0.2
    else:
        gt = g[3]
        which, eps, gate = 3, 1e-2, 8e-2
        picks = [np.unravel_index(int(np.argmax(np.abs(gt))), gt.shape)]
    for idx in picks:
        ad = float(g[which][idx])
        assert abs(ad) > 1e-6, f"{case}: gradient vanished"
        fd = _fd(ts, tset, BOX_FIELDS, values, which, idx, eps)
        assert np.isfinite(fd)
        assert abs(fd - ad) / max(abs(fd), 1e-6) < gate, (case, idx, ad, fd)
    if case == "emission":
        assert g[1][0, 0] > 0   # emission enters linearly


def test_traversal_returns_no_graph(box):
    """bvh_intersect detaches its rays and returns results without a
    graph, so no tensor that requires grad reaches a kernel's raw
    pointers; a kernel wrapper refuses one."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    from tungsten_tpu_torch.ops.intersect import bvh_intersect
    ts = box["ts"]
    o = torch.tensor([[0.0, 1.5, 5.0]] * 4, requires_grad=True)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    res = bvh_intersect(ts, o * 1.0, d, 0.0, 1e30)
    assert bool(res["hit"].all())
    assert not any(v.requires_grad for v in res.values())
    from tungsten_tpu_torch.ops import curve_trace as tct
    with pytest.raises(ValueError, match="requires grad"):
        twt._check(o, "o", torch.float32, (4, 3))
    with pytest.raises(ValueError, match="requires grad"):
        tct._cuda_f32(o, "o", (4, 3))
