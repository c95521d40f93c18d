"""The port's path tracer on media and forward-lobe scenes against the
JAX package on the CPU: the two-strategy NEE, the generalized shadow
ray, medium distance sampling and the forward-lobe passthrough.

Three scenes, built from a numpy seed, 16x12 at 2 spp, max_bounces 6,
the default (Sobol') sampler:
  * fog_room: a homogeneous fog (HG phase) the camera sits in, a lit
    box with a lambert cube; traced with the output values on, so its
    visibility AOV is compared too;
  * voxel_cube: a voxel medium on a synthesized dense grid with an
    emission grid, inside a cube with the `forward` BSDF, beside a
    lambert floor, an area light and an env map (the camera in vacuum);
  * forward_lobes: thinsheet, transparency (a checker alpha over a
    lambert base) and forward surfaces without media, a mirror, an area
    light and an env map.

Both packages run the very same scene (the JAX FlatScene carried across
with flat_scene_from_numpy) with bit-equal random numbers, so the
comparison is lane for lane: the per-ray state (alive, pixel,
throughput, emission, o, d, and the medium fields) after 1, 2 and 4
bounce bodies within rtol 1e-4 / atol 1e-5 on >= 99.5 % of lanes, then
the image pixel for pixel (rtol 1e-3 / atol 1e-4 on >= 99 % of pixels,
means within 1e-4) and the visibility AOV likewise.  Lanes can only part
where float rounding decides a branch: a grazing hit (XLA contracts the
compiled walk's multiply-adds), a raymarch crossing on a step's edge or
a lobe choice on its threshold (see tests/test_torch_media.py).
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from dataclasses import replace

from tungsten_tpu import render as jrender
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.render import render as trender
from tungsten_tpu_torch.render import render_with_aovs
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import jax_fields
from test_torch_media import blob

W, H, SPP, BOUNCES = 16, 12, 2, 6
SEED = 0xBA5EBA11
FIELDS = ("throughput", "emission", "o", "d")
MEDIUM_FIELDS = ("medium", "med_first", "med_bounce")
# bsdf 0 is the lambert "wall" of every scene; primitives name their
# BSDF and media too, so a scene file written from these dicts binds
# the same way (load_scene resolves the names)
LIGHT = {"type": "quad", "bsdf_index": 0, "bsdf": "wall",
         "emission": [7.0, 7.0, 7.0],
         "transform": {"position": [0, 2.4, 0], "scale": [1.2, 1, 1.2],
                       "rotation": [0, 0, 180]}}
FLOOR = {"type": "quad", "bsdf_index": 0, "bsdf": "wall",
         "transform": {"position": [0, -1, 0], "scale": [8, 1, 8]}}
CAMERA = {"type": "pinhole", "resolution": [W, H], "fov": 60,
          "transform": {"position": [0, 0.5, 3.4], "look_at": [0, 0, 0]}}


def _sky(tmp):
    r = np.random.default_rng(6)
    timage.save_hdr(os.path.join(tmp, "sky.pfm"),
                    r.uniform(0.2, 1.5, (8, 16, 3)).astype(np.float32))
    return {"type": "infinite_sphere", "emission": "sky.pfm"}


def fog_room(tmp):
    """A homogeneous HG fog that fills the view, the camera inside it."""
    return dict(
        bsdfs=[{"type": "lambert", "albedo": [0.7, 0.6, 0.5]}],
        media=[{"name": "fog", "type": "homogeneous", "sigma_a": 0.04,
                "sigma_s": [0.25, 0.3, 0.35],
                "phase_function": {"type": "henyey_greenstein", "g": 0.4}}],
        primitives=[LIGHT, FLOOR,
                    {"type": "quad", "bsdf_index": 0,
                     "transform": {"position": [0, 1, -2.5],
                                   "scale": [8, 1, 8],
                                   "rotation": [90, 0, 0]}},
                    {"type": "cube", "bsdf_index": 0,
                     "transform": {"position": [0.3, -0.5, -0.4],
                                   "scale": 0.8, "rotation": [0, 30, 0]}}],
        camera=dict(CAMERA, medium_index=0))


def voxel_cube(tmp):
    """A voxel medium (a seeded smoke puff with an emission grid) inside
    a `forward` cube, lit by an area light and an env map."""
    dens = blob((10, 9, 8), 12, floor=0.05) * 3.0
    np.save(os.path.join(tmp, "puff.npy"), dens)
    np.save(os.path.join(tmp, "glow.npy"),
            np.stack([dens, 0.5 * dens, 0.1 * dens], -1) * 0.3)
    return dict(
        bsdfs=[{"name": "wall", "type": "lambert",
                "albedo": [0.7, 0.6, 0.5]},
               {"name": "boundary", "type": "forward"}],
        media=[{"name": "puff", "type": "voxel", "sigma_a": 0.3,
                "sigma_s": [1.2, 1.5, 1.8],
                "grid": {"type": "dense", "file": "puff.npy",
                         "emission_file": "glow.npy",
                         "transform": {"position": [0, 0, 0],
                                       "scale": 1.6}}}],
        primitives=[LIGHT, FLOOR,
                    {"type": "cube", "bsdf_index": 1, "bsdf": "boundary",
                     "int_medium_index": 0, "int_medium": "puff",
                     "transform": {"position": [0, 0, 0], "scale": 1.6}},
                    _sky(tmp)],
        camera=CAMERA)


def forward_lobes(tmp):
    """thinsheet, transparency and forward surfaces without media."""
    return dict(
        bsdfs=[{"type": "lambert", "albedo": [0.7, 0.6, 0.5]},
               {"type": "thinsheet", "ior": 1.45, "sigma_a": [0.3, 0.6, 1.2],
                "thickness": 0.4},
               {"type": "transparency", "base_index": 0,
                "alpha": {"type": "checker", "on_color": 0.9,
                          "off_color": 0.2, "res_u": 3, "res_v": 3}},
               {"type": "forward"},
               {"type": "mirror", "albedo": 0.9}],
        media=[],
        primitives=[LIGHT, FLOOR,
                    {"type": "quad", "bsdf_index": 1,
                     "transform": {"position": [-0.6, 0, 0.6],
                                   "scale": [1.4, 1, 1.4],
                                   "rotation": [80, 20, 0]}},
                    {"type": "cube", "bsdf_index": 2,
                     "transform": {"position": [0.7, -0.4, 0.0],
                                   "scale": 0.9, "rotation": [0, 25, 0]}},
                    {"type": "cube", "bsdf_index": 3,
                     "transform": {"position": [-0.4, -0.5, -0.8],
                                   "scale": 0.8}},
                    {"type": "quad", "bsdf_index": 4,
                     "transform": {"position": [0, 0.5, -2.0],
                                   "scale": [3, 1, 2],
                                   "rotation": [90, 0, 0]}},
                    _sky(tmp)],
        camera=CAMERA)


SCENES = {"fog_room": fog_room, "voxel_cube": voxel_cube,
          "forward_lobes": forward_lobes}


def scene_desc(name, tmp):
    return SceneDesc(path=os.path.join(tmp, "scene.json"), json={},
                     integrator={"max_bounces": BOUNCES},
                     renderer={"spp": SPP}, **SCENES[name](tmp))


def _ids():
    n = W * H
    return (np.tile(np.arange(n, dtype=np.uint32), SPP),
            np.repeat(np.arange(SPP, dtype=np.uint32), n))


def _np(state):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor)
            else v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module", params=list(SCENES))
def traced(request, tmp_path_factory):
    """Both packages' per-lane state after 1, 2, 4 and BOUNCES bodies (the
    fog room with the output values tracked), and the port's image."""
    name = request.param
    tmp = str(tmp_path_factory.mktemp(name))
    desc = scene_desc(name, tmp)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    if name == "fog_room":
        jset = replace(jset, track_aovs=True)
        tset = replace(tset, track_aovs=True)
    assert not tpt._one_sample_mis(tset)
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
            if b == 2:
                t2 = ts_
    finally:
        jrng._SAMPLER = prev
    img, stats = trender(ts, replace(tset, track_aovs=False), spp=SPP,
                         seed=SEED, spp_chunk=SPP, return_stats=True,
                         device="cpu")
    return dict(name=name, js=js, jset=jset, ts=ts, tset=tset,
                states=states, t2=t2, img=img, stats=stats, tmp=tmp)


def _lanes_agree(j, t, media):
    ok = (j["alive"] == t["alive"]) & \
        (j["pixel"].astype(np.int64) == t["pixel"].astype(np.int64))
    for k in FIELDS:
        ok &= np.isclose(t[k], j[k], rtol=1e-4, atol=1e-5).all(axis=-1)
    if media:
        for k in MEDIUM_FIELDS:
            ok &= j[k] == t[k]
    return ok


def test_state_after_bounces_matches_jax(traced):
    media = traced["tset"].has_media
    for b in (1, 2, 4):
        j, t = traced["states"][b]
        agree = _lanes_agree(j, t, media)
        assert agree.mean() >= 0.995, (b, agree.mean())
        assert t["alive"].any()
    j, t = traced["states"][BOUNCES]
    # the comparison sees real work: banked light on most paths, and
    # for media scenes paths inside a medium
    assert (t["emission"].sum(-1) > 0).mean() > 0.2
    if media:
        seen = np.concatenate([traced["states"][b][1]["medium"]
                               for b in (1, 2, 4)])
        assert (seen >= 0).mean() > 0.1


def _jax_image(j):
    """The JAX final state's radiance banked by pixel (non-finite
    dropped, as bank does), over SPP."""
    e = np.where(np.isfinite(j["emission"]), j["emission"], 0.0)
    img = np.zeros((W * H, 3), np.float64)
    np.add.at(img, j["pixel"].astype(np.int64), e)
    return (img / SPP).reshape(H, W, 3)


def test_image_matches_jax(traced):
    j, _ = traced["states"][BOUNCES]
    want = _jax_image(j)
    img = traced["img"]
    assert img.shape == want.shape
    assert np.isfinite(img).all() and img.mean() > 0
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-4
    assert traced["stats"]["rays"] > 0


@pytest.mark.parametrize("traced", ["fog_room"], indirect=True)
def test_visibility_aov_matches_jax(traced):
    """The fog room's visibility AOV (the light strategy's generalized
    shadow transmittance at the first non-specular vertex) from
    render_with_aovs against the JAX state's (value, count) by pixel."""
    j, _ = traced["states"][BOUNCES]
    ok = np.isfinite(j["emission"]).all(-1)
    val = np.where(ok[:, None], j["aov_vis"], 0.0)
    s = np.zeros((W * H, 2))
    np.add.at(s, j["pixel"].astype(np.int64), val)
    want = (s[:, 0] / np.maximum(s[:, 1], 1.0)).reshape(H, W)
    bufs, _ = render_with_aovs(traced["ts"], traced["tset"], spp=SPP,
                               seed=SEED)
    vis = bufs["visibility"]
    assert np.isclose(vis, want, rtol=1e-3, atol=1e-4).mean() >= 0.99
    # partial visibility through the fog: neither all 0 nor all 1
    assert 0.05 < vis[bufs["visibility_n"] > 0].mean() < 0.95
    assert np.array_equal(bufs["visibility_n"],
                          s[:, 1].reshape(H, W).astype(np.float32))


def test_body_on_shuffled_lanes(traced):
    """The body-start sort (CUDA) and compact_wave permute the whole
    state through _gather_rows: a body run on shuffled lanes gives each
    lane what it gives in order (the medium fields included), and
    compact_wave carries the survivors' medium fields along."""
    ts, tset, s = traced["ts"], traced["tset"], traced["t2"]
    body = tpt._make_bounce_body(ts, tset, SEED)
    ref = body(s)
    r = s["alive"].shape[0]
    perm = torch.randperm(r, generator=torch.Generator().manual_seed(3))
    back = tpt._gather_rows(body(tpt._gather_rows(s, perm)),
                            torch.argsort(perm))
    assert int(back["rays"]) == int(ref["rays"])
    for k, v in ref.items():
        if not isinstance(v, torch.Tensor) or v.ndim == 0:
            continue
        if v.dtype.is_floating_point:
            assert torch.allclose(back[k], v, rtol=1e-6, atol=1e-7), k
        else:
            assert torch.equal(back[k], v), k
    n = int(ref["alive"].sum())
    assert n > 0
    n = n if n < r else r // 2       # the fog room keeps every lane alive
    comp = tpt.compact_wave(ref, n)
    order = torch.nonzero(ref["alive"]).squeeze(1)[:n]
    keys = MEDIUM_FIELDS if tset.has_media else ()
    for k in keys + ("pixel", "sample", "d", "throughput"):
        assert torch.equal(comp[k], ref[k][order]), k


@pytest.mark.parametrize("traced", ["voxel_cube"], indirect=True)
def test_cli_renders_media_scene(traced, tmp_path):
    """The CLI (device cpu) on the voxel scene written as a scene file:
    its image equals render()'s on the same samples."""
    import json
    from tungsten_tpu_torch import cli
    from tungsten_tpu_torch.io import image
    from test_torch_entry import _cli_args
    tmp = str(tmp_path)
    desc = SCENES["voxel_cube"](tmp)
    path = os.path.join(tmp, "scene.json")
    with open(path, "w") as f:
        json.dump(dict(desc, integrator={"max_bounces": BOUNCES},
                       renderer={"spp": SPP, "hdr_output_file": "out.pfm",
                                 "output_file": "out.png"}), f)
    out = cli.render_scene(path, _cli_args(spp=SPP))
    img = image.load_hdr(os.path.join(tmp, "out.pfm"))
    assert out["rays"] > 0 and img.shape == (H, W, 3)
    assert np.isclose(img, traced["img"], rtol=1e-4, atol=1e-5).all()
