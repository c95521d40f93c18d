"""The port's BSDFs (bsdf/types.py, fresnel.py, microfacet.py, eval.py)
against the JAX package on the CPU, type by type.

The table is tests/test_bsdf.py::BSDF_DEFS plus the ported types it
lacks (null, mirror, conductor, dielectric, rough_coat) and variants
that reach the other branches: Beckmann and Phong microfacets, a
reflection-only dielectric, checker-textured roughness and mix ratio,
and a mixed BSDF with a specular child.  Both packages flatten the same
scene description; the port's BSDF rows equal the JAX rows, and the JAX
table carried across with flat_scene_from_numpy is the one both shade.

On numpy-seeded wi, wo (either hemisphere), uv and random numbers, per
type: eval, pdf, and sample's wo, weight, pdf and flags agree within
rtol 1e-4 / atol 1e-6.  The transcendentals (exp and log of the
Beckmann terms, pow of Phong, acos/tan of Oren-Nayar, sqrt) differ by a
few ulps between XLA's CPU kernels and PyTorch's, so a lobe choice that
sits on its threshold may flip; at most 0.2 % of a type's lanes may
part in sample (none in eval and pdf).

A small scene with every ported type (tests/test_output_buffers.py's
box with a cube of each material, an area light and an env map),
carried across with flat_scene_from_numpy, renders as the JAX package
renders it: per-lane wavefront state after 1, 2 and 4 bounce bodies and
the image, at 16x12 x 2 spp, max_bounces 6 (tolerances at the tests).
"""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu import render as jrender
from tungsten_tpu.bsdf import eval as jev
from tungsten_tpu.bsdf import fresnel as jfr
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.bsdf import eval as tev
from tungsten_tpu_torch.bsdf import fresnel as tfr
from tungsten_tpu_torch.bsdf import types as tbt
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.render import render as trender
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_bsdf import BSDF_DEFS
from test_torch_flatten import jax_fields
from test_torch_path_tracer import _jax_image, _lanes_agree

CHECKER = {"type": "checker", "on_color": 0.45, "off_color": 0.08,
           "res_u": 4, "res_v": 4}
EXTRA_DEFS = [
    {"name": "b_null", "type": "null"},
    {"name": "b_mirror", "type": "mirror", "albedo": [0.9, 0.8, 0.7]},
    {"name": "b_cond", "type": "conductor", "material": "Ag"},
    {"name": "b_diel", "type": "dielectric", "ior": 1.5},
    {"name": "b_diel_refl", "type": "dielectric", "ior": 1.33,
     "enable_refraction": False},
    {"name": "b_rdiel_beck", "type": "rough_dielectric", "ior": 1.33,
     "distribution": "beckmann", "roughness": 0.25},
    {"name": "b_rcond_phong", "type": "rough_conductor",
     "distribution": "phong", "roughness": 0.4, "eta": 1.2, "k": 2.5},
    {"name": "b_rplastic_tex", "type": "rough_plastic", "albedo": 0.5,
     "roughness": CHECKER, "distribution": "beckmann"},
    {"name": "b_rcoat", "type": "rough_coat", "ior": 1.5, "roughness": 0.2,
     "sigma_a": 0.3, "substrate": "b_lambert"},
    {"name": "b_mixed_spec", "type": "mixed", "ratio": CHECKER,
     "bsdf0": "b_mirror", "bsdf1": "b_oren"},
]
DEFS = BSDF_DEFS + EXTRA_DEFS
# the ported types this table covers: all but the forward-lobe types,
# which take the path tracer off its one-sample-MIS estimator
# (tests/test_torch_media*.py cover them), and the fiber BCSDFs, which
# shade curves (tests/test_torch_fiber.py, test_torch_curves*.py)
FIBER_TYPES = {tbt.HAIR, tbt.ROUGH_WIRE, tbt.LAMBERTIAN_FIBER}
SURFACE_TYPES = set(tbt.PORTED_TYPES) - set(tbt.FORWARD_LOBE_TYPES) - \
    FIBER_TYPES
N = 4096
SAMPLE_PART = 0.002


def _desc():
    desc = SceneDesc(
        path="scene.json", json={}, bsdfs=[dict(b) for b in DEFS],
        primitives=[{"type": "quad", "bsdf_index": 0}], media=[],
        camera={"type": "pinhole", "resolution": [8, 8]}, integrator={},
        renderer={})
    by_name = {b["name"]: i for i, b in enumerate(desc.bsdfs)}
    for b in desc.bsdfs:
        for k in ("substrate", "bsdf0", "bsdf1"):
            if k in b:
                b[k + "_index"] = by_name[b[k]]
    return desc


@pytest.fixture(scope="module")
def scenes():
    js, jset = jax_flatten(_desc())
    own, tset = flatten_scene(_desc(), device="cpu")
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    return js, jset, ts, tset, own


def test_every_ported_type_is_covered(scenes):
    js, jset, ts, tset, _ = scenes
    assert set(tbt.PORTED_TYPES) == set(tev._REGISTRY)
    assert set(tset.present_bsdf_types) == SURFACE_TYPES
    assert tset.present_bsdf_types == jset.present_bsdf_types


def test_bsdf_rows_equal_jax(scenes):
    """parse_bsdf_row lays every row out as the JAX package does: types,
    params (diffuse Fresnel and complex IORs included), aux and the
    texture table, bit for bit."""
    js, _, _, _, own = scenes
    for k in ("bsdf_type", "bsdf_albedo_tex", "bsdf_params", "bsdf_aux",
              "tex_type", "tex_const", "tex_params"):
        a = np.asarray(getattr(js, k))
        b = getattr(own, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    for ior in (1.1, 1.33, 1.5, 2.4):
        assert tfr.compute_diffuse_fresnel(ior) == \
            jfr.compute_diffuse_fresnel(ior)


def _dirs(r, n, lower_every):
    w = r.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    lower = np.arange(n) % lower_every == 0
    w[:, 2] = np.where(lower, -np.abs(w[:, 2]), np.abs(w[:, 2]))
    w[:, 2] = np.sign(w[:, 2]) * np.clip(np.abs(w[:, 2]), 0.02, None)
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    r = np.random.default_rng(seed)
    wi = _dirs(r, N, 4)
    wo = _dirs(r, N, 3)
    uv = r.uniform(size=(N, 2)).astype(np.float32)
    u = r.uniform(size=(4, N)).astype(np.float32)
    return wi, wo, uv, u


def _close(a, b):
    """(N,) lanes within rtol 1e-4 / atol 1e-6 on every channel."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(b, a, rtol=1e-4, atol=1e-6)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


@pytest.fixture(scope="module")
def shaded(scenes):
    """Both packages' eval, pdf and sample over every type at once: N
    lanes per BSDF row (row i on lanes [i*N, (i+1)*N), drawn from seed
    100 + i), one call per package, so JAX dispatches its ops once."""
    js, jset, ts, _, _ = scenes
    types = jset.present_bsdf_types
    wi, wo, uv, u = (np.concatenate(x, axis=-1 if k == 3 else 0)
                     for k, x in enumerate(zip(*(
                         _inputs(100 + i) for i in range(len(DEFS))))))
    bidx = np.repeat(np.arange(len(DEFS), dtype=np.int32), N)
    jsp = jev.ShadePoint(js, jnp.asarray(bidx), jnp.asarray(uv))
    tsp = tev.ShadePoint(ts, torch.from_numpy(bidx).long(),
                         torch.from_numpy(uv))
    jwi, jwo = jnp.asarray(wi), jnp.asarray(wo)
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    jax_out = [np.asarray(jev.bsdf_eval(jsp, jwi, jwo, types)),
               np.asarray(jev.bsdf_pdf(jsp, jwi, jwo, types))]
    jax_out += [np.asarray(x) for x in jev.bsdf_sample(
        jsp, jwi, *(jnp.asarray(x) for x in u[:3]), types,
        u_lobe2=jnp.asarray(u[3]))]
    port_out = [tev.bsdf_eval(tsp, twi, two, types).numpy(),
                tev.bsdf_pdf(tsp, twi, two, types).numpy()]
    port_out += [x.numpy() for x in tev.bsdf_sample(
        tsp, twi, *(torch.from_numpy(x) for x in u[:3]), types,
        u_lobe2=torch.from_numpy(u[3]))]
    return jax_out, port_out


@pytest.mark.parametrize("bidx,name", [(i, b["name"])
                                       for i, b in enumerate(DEFS)])
def test_bsdf_matches_jax(shaded, bidx, name):
    lanes = slice(bidx * N, (bidx + 1) * N)
    jf, jp, *jout = (x[lanes] for x in shaded[0])
    tf, tp, *tout = (x[lanes] for x in shaded[1])
    assert _close(jf, tf).all(), name
    assert _close(jp, tp).all(), name
    assert tout[3].dtype == np.int32
    same = jout[3] == tout[3]
    for a, b in zip(jout[:3], tout[:3]):
        same &= _close(a, b)
    assert same.mean() >= 1.0 - SAMPLE_PART, (name, same.mean())
    # the comparison sees real work: valid samples with nonzero weight
    valid = (tout[3] & tev.FLAG_VALID) != 0
    if name != "b_null":
        assert valid.mean() > 0.3, name
        assert (tout[1][valid].max(axis=-1) > 0).mean() > 0.5, name


def test_pure_specular_types_sample_dirac_lobes_only(scenes):
    js, jset, ts, _, _ = scenes
    assert tev.PURE_SPECULAR == jev.PURE_SPECULAR & set(tbt.PORTED_TYPES)
    wi, _, uv, u = _inputs(7)
    types = jset.present_bsdf_types
    for bidx, b in enumerate(DEFS):
        t = tbt.NAME_TO_TYPE[b["type"]]
        if t not in tev.PURE_SPECULAR or t == tbt.NULL:
            continue
        sp = tev.ShadePoint(ts, torch.full((N,), bidx, dtype=torch.long),
                            torch.from_numpy(uv))
        _, _, _, flags = tev.bsdf_sample(
            sp, torch.from_numpy(wi), *(torch.from_numpy(x) for x in u[:3]),
            types, u_lobe2=torch.from_numpy(u[3]))
        valid = (flags & tev.FLAG_VALID) != 0
        assert bool(valid.any()), b["name"]
        assert bool(((flags[valid] & tev.FLAG_SPECULAR) != 0).all())


def test_adjoint_drops_the_eta_squared_factor(scenes):
    """Non-adjoint eval scales the rough dielectric's transmission lobe by
    eta^2; adjoint transport omits it (both packages)."""
    js, jset, ts, _, _ = scenes
    bidx = [b["name"] for b in DEFS].index("b_rdiel")
    types = jset.present_bsdf_types
    wi, wo, uv, _ = _inputs(11)
    tsp = tev.ShadePoint(ts, torch.full((N,), bidx, dtype=torch.long),
                         torch.from_numpy(uv))
    jsp = jev.ShadePoint(js, jnp.full((N,), bidx, jnp.int32),
                         jnp.asarray(uv))
    twi, two = torch.from_numpy(wi), torch.from_numpy(wo)
    cam = tev.bsdf_eval(tsp, twi, two, types).numpy()
    adj = tev.bsdf_eval(tsp, twi, two, types, adjoint=True).numpy()
    jadj = np.asarray(jev.bsdf_eval(jsp, jnp.asarray(wi), jnp.asarray(wo),
                                    types, adjoint=True))
    assert _close(jadj, adj).all()
    trans = (wi[:, 2] * wo[:, 2] < 0) & (adj.max(-1) > 1e-6)
    assert trans.sum() > 100
    eta = np.where(wi[:, 2] < 0, 1.5, 1 / 1.5).astype(np.float32)
    np.testing.assert_allclose(cam[trans], adj[trans] *
                               (eta * eta)[trans, None], rtol=1e-5)
    assert np.array_equal(cam[~trans & (wi[:, 2] * wo[:, 2] >= 0)],
                          adj[~trans & (wi[:, 2] * wo[:, 2] >= 0)])


# ------------------------------------------------------------ the zoo scene

SPP = 2
SEED = 0xBA5EBA11


def zoo_scene(tmp_path):
    """A closed-front box (rough plastic floor, oren-nayar and phong
    walls, a diffuse-transmission back wall) holding one cube per
    remaining ported type, lit by an emissive quad and an env map; every
    BSDF of DEFS is a row of its table."""
    r = np.random.default_rng(5)
    sky = r.uniform(0.3, 1.5, (8, 16, 3)).astype(np.float32)
    timage.save_hdr(str(tmp_path / "sky.pfm"), sky)
    desc = _desc()
    idx = {b["name"]: i for i, b in enumerate(desc.bsdfs)}
    desc.bsdfs.append({"name": "light", "type": "lambert", "albedo": 0.0})
    prims = [
        {"type": "quad", "bsdf_index": idx["b_rplastic"],
         "transform": {"position": [0, -1, 0], "scale": [4, 1, 4]}},
        {"type": "quad", "bsdf_index": idx["b_oren"],
         "transform": {"position": [-2, 0.5, 0], "scale": [4, 1, 4],
                       "rotation": [0, 0, -90]}},
        {"type": "quad", "bsdf_index": idx["b_phong"],
         "transform": {"position": [2, 0.5, 0], "scale": [4, 1, 4],
                       "rotation": [0, 0, 90]}},
        {"type": "quad", "bsdf_index": idx["b_dtrans"],
         "transform": {"position": [0, 0.5, -2], "scale": [4, 1, 4],
                       "rotation": [90, 0, 0]}},
        {"type": "quad", "bsdf_index": len(desc.bsdfs) - 1,
         "emission": [6.0, 6.0, 6.0],
         "transform": {"position": [0, 2.2, 0], "scale": [1.2, 1, 1.2],
                       "rotation": [0, 0, 180]}},
    ]
    cubes = [n for n in idx if n not in ("b_rplastic", "b_oren", "b_phong",
                                         "b_dtrans")]
    for k, name in enumerate(cubes):
        x, z = (k % 5) - 2.0, (k // 5) - 1.0
        prims.append({"type": "cube", "bsdf_index": idx[name],
                      "transform": {"position": [0.75 * x, -0.6 + 0.1 * z,
                                                 0.9 * z],
                                    "scale": 0.5,
                                    "rotation": [0, 25.0 * k, 0]}})
    prims.append({"type": "infinite_sphere", "emission": "sky.pfm"})
    desc.primitives = prims
    desc.path = str(tmp_path / "scene.json")
    desc.camera = {"type": "pinhole", "resolution": [16, 12], "fov": 70,
                   "transform": {"position": [0, 0.6, 3.2],
                                 "look_at": [0, -0.3, 0]}}
    desc.integrator = {"type": "path_tracer", "max_bounces": 6}
    return desc


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    desc = zoo_scene(tmp_path_factory.mktemp("zoo"))
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    assert set(tset.present_bsdf_types) == SURFACE_TYPES
    assert (tset.width, tset.height, tset.max_bounces) == (16, 12, 6)
    return js, jset, ts, tset


def _ids(settings):
    n = settings.width * settings.height
    pixel = np.tile(np.arange(n, dtype=np.uint32), SPP)
    sample = np.repeat(np.arange(SPP, dtype=np.uint32), n)
    return pixel, sample


def _shaded_types(ts, state):
    """BSDF types (nested children included) at the next hit of every
    live lane."""
    from tungsten_tpu_torch.ops.intersect import bvh_intersect
    alive = state["alive"]
    res = bvh_intersect(ts, state["o"][alive], state["d"][alive], 0.0, 3e38)
    info = tpt._expand_hit(ts, state["o"][alive], state["d"][alive], res)
    rows = info["bsdf"][res["hit"]]
    aux = ts.bsdf_aux[rows]
    kids = torch.cat([aux[:, 1], aux[:, 2]])
    rows = torch.cat([rows, kids[kids >= 0].long()])
    return {int(t) for t in ts.bsdf_type[rows].unique()}


@pytest.fixture(scope="module")
def zoo_traced(zoo):
    """Both packages' wavefront state after 0, 1, 2 and 4 bodies, and the
    JAX state after max_bounces bodies (its image), from one JAX
    compile (render_pass latches the JAX sampler in a module global: it
    is set as render_pass would and restored)."""
    js, jset, ts, tset = zoo
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


def test_zoo_state_after_bounces_matches_jax(zoo, zoo_traced):
    """Per lane: alive, pixel, throughput, emission, o and d within rtol
    1e-4 / atol 1e-5 after 1, 2 and 4 bodies on >= 0.995 of the lanes
    (a lobe choice on its threshold may flip a lane, see the module
    docstring; none parted when this was written)."""
    ts = zoo[2]
    states, _ = zoo_traced
    seen = _shaded_types(ts, states[0][1])
    for bounce in (1, 2, 4):
        jstate, tstate = states[bounce]
        assert int(jstate["bounce"]) == tstate["bounce"] == bounce
        agree = _lanes_agree(jstate, tstate)
        assert agree.mean() >= 0.995, (bounce, agree.mean())
        assert tstate["alive"].any()
        if bounce < 4:
            seen |= _shaded_types(ts, tstate)
    # the paths shade every ported type within the bounces compared
    assert seen == SURFACE_TYPES, SURFACE_TYPES - seen


def test_zoo_image_matches_jax(zoo, zoo_traced):
    """The image against the JAX wave's (its state after max_bounces
    bodies summed by pixel): >= 0.99 of the pixels within rtol 1e-3 /
    atol 1e-4 and the means within 1e-4 relative (the image gates of
    tests/test_torch_path_tracer.py)."""
    js, jset, ts, tset = zoo
    assert int(zoo_traced[1]["bounce"]) == jset.max_bounces
    jimg = _jax_image(zoo_traced[1], jset)
    img = trender(ts, tset, spp=SPP, seed=SEED, spp_chunk=SPP, device="cpu")
    assert img.shape == jimg.shape == (12, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() / jimg.mean() - 1.0) <= 1e-4
