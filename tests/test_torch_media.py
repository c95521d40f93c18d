"""The port's media modules and forward-lobe BSDFs against the JAX package
on the CPU, module by module, on inputs made with numpy from a seed.

  * media/phase.py: eval, pdf and sample of each phase function, within
    rtol 1e-5 / atol 1e-6 (sample's wo within atol 1e-5: Rayleigh's cube
    root is a power here and jnp.cbrt there).
  * media/transmittance.py: each of the nine laws, at both parameter
    widths the flattener writes ((M,4), and (M,16) once any law is
    interpolated), for each start/end case: eval_tr, surface_probability,
    medium_pdf and sigma_bar within rtol 1e-4 / atol 1e-6 on every lane,
    sample_distance on seeded u likewise (the erlang law's ten Newton
    steps carry the transcendentals' ulps, hence 1e-4); and the port's
    dispatch over the laws present equal, bit for bit, to its dispatch
    over all nine.
  * media/grid.py: density and emission at seeded points, unit_tau and
    inverse_unit_tau for each medium kind (homogeneous, exponential,
    atmosphere, voxel from a dense .npy and from a .vdb) and each voxel
    method (raymarching, residual_ratio, exact_linear, exact_nearest)
    within rtol 1e-4 / atol 1e-5 on >= 99 % of lanes.  Lanes may part:
    XLA contracts the trilinear and boundary-stepping multiply-adds
    into fused ones and PyTorch's CPU kernels do not, so a DDA may step
    into another cell at a grazing boundary, and the raymarch inversion
    sums its steps with a cumulative sum (the JAX loop adds one step at
    a time), so a crossing that sits on a step's edge may land in the
    next step.  The atmosphere's closed form subtracts two erf values
    near 1 and scales the difference by (sqrt(pi)/2s) exp((r^2-h^2)s^2),
    which reaches hundreds here, so its lanes are held to an absolute
    error of 1e-6 of that scale (16 ulps of erf, whose last bits differ
    between XLA and PyTorch).  _query_rand is equal bit for bit, so
    ratio tracking draws the same events: its estimate agrees within rtol 1e-5 on
    every lane.
  * io/vdb.py: a file the JAX writer wrote reads back equal with the
    port's reader, and the reverse, ZIP and uncompressed.
  * scene/flatten.py: the media tables, grids and supergrids of a scene
    with every medium kind equal the JAX build bit for bit.
  * bsdf/: thinsheet, transparency and forward: eval, pdf, sample (also
    with no_specular) and the forward lobe (bsdf_forward) within rtol
    1e-4 / atol 1e-6, and the thin-film Fresnel term.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.bsdf import eval as jev
from tungsten_tpu.bsdf import fresnel as jfr
from tungsten_tpu.io import vdb as jvdb
from tungsten_tpu.media import grid as jgr
from tungsten_tpu.media import phase as jph
from tungsten_tpu.media import transmittance as jtr
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.bsdf import eval as tev
from tungsten_tpu_torch.bsdf import fresnel as tfr
from tungsten_tpu_torch.io import vdb as tvdb
from tungsten_tpu_torch.media import grid as tgr
from tungsten_tpu_torch.media import phase as tph
from tungsten_tpu_torch.media import transmittance as ttr
from tungsten_tpu_torch.scene.flatten import (RenderSettings,
                                              flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import _assert_same_scene, jax_fields

R = 512


def _close(a, b, rtol, atol):
    """(lanes,) bool: every channel of a lane within rtol / atol."""
    ok = np.isclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _dirs(r, n):
    w = r.normal(size=(n, 3))
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ scenes

def blob(shape, seed, floor=0.0):
    """A seeded smoke puff: a noisy ellipsoid, zero outside (plus floor)."""
    r = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    c = (np.asarray(shape) - 1) / 2
    r2 = sum(((a - ci) / (s / 2.2)) ** 2 for a, ci, s in zip((x, y, z), c,
                                                              shape))
    return (np.where(r2 < 1, (1 - r2) * (0.5 + r.random(shape)), 0.0)
            + floor).astype(np.float32)


def write_vdb_grids(path, shape, seed):
    """A density grid and a Cd emission grid, written with the port."""
    dens = blob(shape, seed)
    em = np.zeros(shape + (3,), np.float32)
    em[..., 0] = dens * 2.0
    em[..., 1] = dens
    tr = np.eye(4)
    tvdb.write_vdb(path, {
        "density": tvdb.VdbGridData("density", dens, (3, -2, 5), tr),
        "Cd": tvdb.VdbGridData("Cd", em, (3, -2, 5), tr)})


def media_desc(tmp, interpolated=False):
    """Every medium kind, each in a cube of its own, in a fog the camera
    sits in: homogeneous fog (HG phase), a voxel medium on a dense .npy
    with an emission grid, an exponential, an atmosphere centred on a
    named primitive, a voxel medium on a .vdb (normalize_size), and
    either an erlang fog or one with the interpolated law."""
    r = np.random.default_rng(11)
    np.save(os.path.join(tmp, "g.npy"), r.uniform(0, 3, (6, 5, 4))
            .astype(np.float32))
    np.save(os.path.join(tmp, "e.npy"), r.uniform(0, 1, (6, 5, 4))
            .astype(np.float32))
    write_vdb_grids(os.path.join(tmp, "g.vdb"), (12, 10, 8), 3)
    law = ({"type": "interpolated", "ratio": 0.3,
            "tr_a": {"type": "linear", "max_t": 2.0},
            "tr_b": "erlang"} if interpolated else
           {"type": "erlang", "rate": 3.0})
    media = [
        {"name": "fog", "type": "homogeneous", "sigma_a": 0.05,
         "sigma_s": [0.2, 0.3, 0.4],
         "phase_function": {"type": "henyey_greenstein", "g": 0.3}},
        {"name": "vox", "type": "voxel", "sigma_a": 0.1, "sigma_s": 1.0,
         "max_bounces": 5,
         "grid": {"type": "dense", "file": "g.npy", "emission_file": "e.npy",
                  "emission_scale": 2.0, "scale_emission_by_density": True,
                  "transform": {"position": [0.6, 0, 0], "scale": 1.0}}},
        {"name": "expo", "type": "exponential", "sigma_a": 0.1,
         "sigma_s": 0.5, "density": 2.0, "falloff_scale": 2.0,
         "unit_point": [0, -0.5, 0], "falloff_direction": [0.2, 1, 0]},
        {"name": "atmo", "type": "atmosphere", "sigma_a": 0.1,
         "sigma_s": 0.5, "radius": 0.6, "falloff_scale": 3.0,
         "primitive": "atmo_cube"},
        {"name": "vdb", "type": "voxel", "sigma_a": 0.2, "sigma_s": 0.8,
         "phase_function": "rayleigh",
         "grid": {"type": "vdb", "file": "g.vdb", "density_scale": 2.0,
                  "transform": {"position": [0, -0.9, -1.2], "scale": 1.2}}},
        {"name": "law", "type": "homogeneous", "sigma_a": 0.3,
         "sigma_s": 0.6, "transmittance": law},
    ]
    prims = [
        {"type": "quad", "bsdf_index": 0, "emission": [6, 6, 6],
         "transform": {"position": [0, 2.4, 0], "scale": [1.5, 1, 1.5],
                       "rotation": [0, 0, 180]}},
        {"type": "quad", "bsdf_index": 0,
         "transform": {"position": [0, -1.5, 0], "scale": [8, 1, 8]}},
        {"type": "cube", "bsdf_index": 1, "int_medium_index": 1,
         "ext_medium_index": 0,
         "transform": {"position": [0.6, 0, 0], "scale": 1.0}},
        {"type": "cube", "bsdf_index": 1, "int_medium_index": 2,
         "ext_medium_index": 0,
         "transform": {"position": [-1.2, 0, 0], "scale": 0.8}},
        {"type": "cube", "name": "atmo_cube", "bsdf_index": 1,
         "int_medium_index": 3, "ext_medium_index": 0,
         "transform": {"position": [-0.8, 0.9, -1.0], "scale": 1.0}},
        {"type": "cube", "bsdf_index": 1, "int_medium_index": 4,
         "ext_medium_index": 0,
         "transform": {"position": [0, -0.3, -1.2], "scale": 1.2}},
        {"type": "cube", "bsdf_index": 1, "int_medium_index": 5,
         "ext_medium_index": 0,
         "transform": {"position": [1.2, 1.0, -0.8], "scale": 0.6}},
    ]
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={},
        bsdfs=[{"type": "lambert", "albedo": 0.7}, {"type": "forward"}],
        primitives=prims, media=media,
        camera={"type": "pinhole", "resolution": [16, 12], "fov": 60,
                "medium_index": 0,
                "transform": {"position": [0, 0.4, 3.2],
                              "look_at": [0, 0.2, 0]}},
        integrator={"max_bounces": 6}, renderer={"spp": 2})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX build of media_desc and the port's copy of it."""
    desc = media_desc(str(tmp_path_factory.mktemp("media")))
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    return js, jset, ts, tset


@pytest.mark.parametrize("interpolated", [False, True])
def test_flat_media_tables_equal_jax(tmp_path, interpolated):
    desc = media_desc(str(tmp_path), interpolated)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    ref = jax_fields(js)
    _assert_same_scene(ts, ref)
    for f in dataclasses.fields(RenderSettings):
        assert getattr(tset, f.name) == getattr(jset, f.name), f.name
    assert tset.has_media and tset.med_kinds == (0, 1, 2, 3)
    assert ts.med_trans_params.shape == (6, 16 if interpolated else 4)
    assert len(ts.grid_density) == 2 and ts.grid_emission[1].shape[-1] == 3
    # the carried-across scene is the same scene
    _assert_same_scene(flat_scene_from_numpy(ref, "cpu"), ref)


# ------------------------------------------------------------------- phase

@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_phase_matches_jax(ptype):
    r = np.random.default_rng(20 + ptype)
    wi, wo = _dirs(r, R), _dirs(r, R)
    g = r.uniform(-0.9, 0.9, R).astype(np.float32)
    g[::7] = 0.0                         # the HG g ~ 0 guard
    u = r.uniform(size=(2, R)).astype(np.float32)
    pt = np.full(R, ptype, np.int32)
    je = jph.phase_eval(jnp.asarray(pt), jnp.asarray(g), jnp.asarray(wi),
                        jnp.asarray(wo))
    te = tph.phase_eval(_t(pt), _t(g), _t(wi), _t(wo))
    assert _close(je, te, 1e-5, 1e-6).all()
    assert _close(jph.phase_pdf(jnp.asarray(pt), jnp.asarray(g),
                                jnp.asarray(wi), jnp.asarray(wo)),
                  tph.phase_pdf(_t(pt), _t(g), _t(wi), _t(wo)),
                  1e-5, 1e-6).all()
    jw, jp = jph.phase_sample(jnp.asarray(pt), jnp.asarray(g),
                              jnp.asarray(wi), *map(jnp.asarray, u))
    tw, tp = tph.phase_sample(_t(pt), _t(g), _t(wi), *map(_t, u))
    assert _close(jw, tw, 1e-5, 1e-5).all()
    assert _close(jp, tp, 1e-4, 1e-6).all()


# ----------------------------------------------------------- transmittance

LAWS = list(range(9))
CASES = [(True, True), (True, False), (False, True), (False, False)]


def _law_params(r, law, n):
    """(n, 4) parameter rows for a base law, in its valid ranges."""
    p = np.zeros((n, 4), np.float32)
    if law in (jtr.T_LINEAR, jtr.T_QUADRATIC):
        p[:, 0] = r.uniform(0.5, 3.0, n)
    elif law == jtr.T_DOUBLE_EXPONENTIAL:
        p[:, 0] = r.uniform(0.2, 1.0, n)
        p[:, 1] = r.uniform(2.0, 10.0, n)
    elif law == jtr.T_ERLANG:
        p[:, 0] = r.uniform(1.0, 6.0, n)
    elif law == jtr.T_DAVIS:
        p[:, 0] = r.uniform(1.05, 4.0, n)
    elif law == jtr.T_DAVIS_WEINSTEIN:
        p[:, 0] = r.uniform(0.5, 1.0, n)
        p[:, 1] = r.uniform(0.5, 2.0, n)
    elif law == jtr.T_PULSE:
        p[:, 0] = r.uniform(0.0, 0.5, n)
        p[:, 1] = r.uniform(1.0, 3.0, n)
        p[:, 2] = r.integers(1, 9, n)
    return p


def _law_table(law, seed):
    """(ttype (R,), params (R,16), params (R,4) or None): R lanes of one
    law; interpolated rows mix two seeded base laws."""
    r = np.random.default_rng(seed)
    tt = np.full(R, law, np.int32)
    p16 = np.zeros((R, 16), np.float32)
    if law == jtr.T_INTERPOLATED:
        ta = r.integers(0, 8, R)
        tb = r.integers(0, 8, R)
        p16[:, 4], p16[:, 5] = ta, tb
        p16[:, 6] = r.uniform(0, 1, R)
        for k in range(8):
            p16[ta == k, 8:12] = _law_params(r, k, int((ta == k).sum()))
            p16[tb == k, 12:16] = _law_params(r, k, int((tb == k).sum()))
        return tt, p16, None
    p16[:, :4] = _law_params(r, law, R)
    return tt, p16, p16[:, :4].copy()


@pytest.mark.parametrize("start,end", CASES,
                         ids=["ss", "sm", "ms", "mm"])
@pytest.mark.parametrize("law", LAWS, ids=list(jtr.NAMES))
def test_transmittance_law_matches_jax(law, start, end):
    tt, p16, p4 = _law_table(law, 40 + law)
    r = np.random.default_rng(70 + law)
    tau = r.uniform(0.0, 4.0, (R, 3)).astype(np.float32)
    u1, u2 = r.uniform(size=(2, R)).astype(np.float32)
    s = np.full(R, start)
    e = np.full(R, end)
    for p in (p4, p16):
        if p is None:
            continue
        jargs = (jnp.asarray(tt), jnp.asarray(tau), jnp.asarray(p))
        targs = (_t(tt), _t(tau), _t(p))
        laws = ttr.present_laws(_t(tt), _t(p))
        pairs = [
            (jtr.eval_tr(*jargs, jnp.asarray(s), jnp.asarray(e)),
             [ttr.eval_tr(*targs, _t(s), _t(e), lw) for lw in (None, laws)]),
            (jtr.surface_probability(*jargs, jnp.asarray(s)),
             [ttr.surface_probability(*targs, _t(s), lw)
              for lw in (None, laws)]),
            (jtr.medium_pdf(*jargs, jnp.asarray(s)),
             [ttr.medium_pdf(*targs, _t(s), lw) for lw in (None, laws)]),
            (jtr.sigma_bar(jnp.asarray(tt), jnp.asarray(p)),
             [ttr.sigma_bar(_t(tt), _t(p), lw) for lw in (None, laws)]),
            (jtr.sample_distance(jnp.asarray(tt), jnp.asarray(p),
                                 jnp.asarray(s), jnp.asarray(u1),
                                 jnp.asarray(u2)),
             [ttr.sample_distance(_t(tt), _t(p), _t(s), _t(u1), _t(u2), lw)
              for lw in (None, laws)]),
        ]
        for k, (want, (got_all, got_present)) in enumerate(pairs):
            assert torch.equal(got_all, got_present), (k, p.shape)
            want = np.asarray(want)
            assert np.isfinite(want).any(), k
            ok = _close(want, got_all.numpy(), 1e-4, 1e-6)
            assert ok.all(), (k, p.shape, ok.mean())


# -------------------------------------------------------------------- grid

# (centre, size) of each medium's cube in media_desc (the fog's: the room)
MEDIUM_BOXES = [((0, 0, -0.5), 4.0), ((0.6, 0, 0), 1.0), ((-1.2, 0, 0), 0.8),
                ((-0.8, 0.9, -1.0), 1.0), ((0, -0.3, -1.2), 1.2),
                ((1.2, 1.0, -0.8), 0.6)]


def _rays(seed, n=R):
    """Seeded rays in the media: each lane's medium cycles over the
    table and its origin lies in or near that medium's cube; unit
    directions, far limits in [0.2, 5] with one in eight infinite."""
    r = np.random.default_rng(seed)
    mi = (np.arange(n) % 6).astype(np.int32)
    c = np.asarray([MEDIUM_BOXES[m][0] for m in mi], np.float32)
    s = np.asarray([MEDIUM_BOXES[m][1] for m in mi], np.float32)[:, None]
    o = (c + r.uniform(-0.6, 0.6, (n, 3)) * s).astype(np.float32)
    d = _dirs(r, n)
    t_max = r.uniform(0.2, 5.0, n).astype(np.float32)
    t_max[::8] = 3.0e38
    tau_c = r.uniform(0.0, 3.0, n).astype(np.float32)
    return o, d, t_max, mi, tau_c


def _atmo_atol(js, mi, o, d):
    """(R,) absolute tolerance: 1e-6 of the atmosphere closed form's
    scale (sqrt(pi)/2s) exp((r^2-h^2)s^2) on its lanes, 1e-5 elsewhere."""
    prm = np.asarray(js.med_exp_params)[mi]
    s, r = prm[:, 0], prm[:, 4]
    p = o - prm[:, 1:4]
    t0 = (p * d).sum(-1)
    h_sq = np.maximum((p * p).sum(-1) - t0 * t0, 0.0)
    pre = np.sqrt(np.pi) * 0.5 / np.maximum(s, 1e-20) * \
        np.exp((r * r - h_sq) * s * s)
    return np.where(np.asarray(js.med_kind)[mi] == jgr.MED_ATMOSPHERE,
                    1e-6 * pre, 1e-5)


def test_density_and_emission_match_jax(scene):
    js, jset, ts, tset = scene
    o, _, _, mi, _ = _rays(1)
    jd = jgr.density(js, jset, jnp.asarray(mi), jnp.asarray(o))
    td = tgr.density(ts, tset, _t(mi).long(), _t(o))
    assert _close(jd, td, 1e-5, 1e-6).all()
    je = jgr.emission(js, jset, jnp.asarray(mi), jnp.asarray(o))
    te = tgr.emission(ts, tset, _t(mi).long(), _t(o))
    assert _close(je, te, 1e-5, 1e-6).all()
    # the comparison sees real work: dense and vdb voxels, emission
    assert (td.numpy()[mi == 1] > 0).mean() > 0.1
    assert (td.numpy()[mi == 4] > 0).mean() > 0.05
    assert (te.numpy()[mi == 1].max(-1) > 0).any()


METHODS = ["raymarching", "residual_ratio", "exact_linear", "exact_nearest"]


@pytest.mark.parametrize("method", METHODS)
def test_optical_depth_matches_jax(scene, method):
    """unit_tau with the method as voxel_integration and inverse_unit_tau
    with it as voxel_sampling (raymarching where the reference has no
    such sampler)."""
    js, jset, ts, tset = scene
    sampling = method if method.startswith("exact") else "raymarching"
    jset = dataclasses.replace(jset, voxel_integration=method,
                               voxel_sampling=sampling)
    tset = dataclasses.replace(tset, voxel_integration=method,
                               voxel_sampling=sampling)
    o, d, t_max, mi, tau_c = _rays(2)
    jargs = (jnp.asarray(mi), jnp.asarray(o), jnp.asarray(d),
             jnp.asarray(t_max))
    targs = (_t(mi).long(), _t(o), _t(d), _t(t_max))
    want = np.asarray(jgr.unit_tau(js, jset, *jargs))
    got = tgr.unit_tau(ts, tset, *targs).numpy()
    atol = _atmo_atol(js, mi, o, d)
    ok = _close(want, got, 1e-4, atol)
    for m in range(6):
        assert ok[mi == m].mean() >= 0.99, (m, ok[mi == m].mean())
    # real work: voxel lanes crossing density, finite and infinite rays
    vox = (mi == 1) | (mi == 4)
    assert (got[vox] > 0.05).mean() > 0.2
    jt, jr, jtot = (np.asarray(x) for x in jgr.inverse_unit_tau(
        js, jset, *jargs, jnp.asarray(tau_c)))
    tt_, tr_, ttot = (x.numpy() for x in tgr.inverse_unit_tau(
        ts, tset, *targs, _t(tau_c)))
    found = jt < 1e38
    assert np.array_equal(found, tt_ < 1e38) or \
        (found == (tt_ < 1e38)).mean() >= 0.99
    ok = _close(jt, tt_, 1e-4, 1e-5) & _close(jr, tr_, 1e-4, 1e-5) & \
        _close(jtot, ttot, 1e-4, atol)
    for m in range(6):
        assert ok[mi == m].mean() >= 0.99, (m, ok[mi == m].mean())
    assert found[vox].mean() > 0.1 and (~found[vox]).mean() > 0.1


def test_query_rand_is_bitwise_and_tracking_agrees(scene):
    js, jset, ts, tset = scene
    r = np.random.default_rng(5)
    o = r.normal(size=(R, 3)).astype(np.float32)
    o[::5] = 0.0
    o[1::5, 0] = -0.0
    d = _dirs(r, R)
    for salt, j in ((0x5157, 0), (0x5157, 191), (0xDEADBEEF, 7)):
        a = np.asarray(jgr._query_rand(jnp.asarray(o), jnp.asarray(d),
                                       salt, j))
        b = tgr._query_rand(_t(o), _t(d), salt, j).numpy()
        assert a.view(np.int32).tobytes() == b.view(np.int32).tobytes()
    # ratio tracking over the .vdb grid: the same events, the same
    # estimate
    o, d, t_max, mi, _ = _rays(3, 6 * R)
    o, d, t_max = o[mi == 4], d[mi == 4], t_max[mi == 4]
    jset = dataclasses.replace(jset, voxel_integration="residual_ratio")
    want = np.asarray(jgr._rr_tau_grid(js, jset, 1, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(t_max)))
    got = tgr._rr_tau_grid(ts, tset, 1, _t(o), _t(d), _t(t_max)).numpy()
    assert _close(want, got, 1e-5, 1e-6).all()
    assert (got != 0).mean() > 0.1 and np.abs(got).max() > 0.1


# --------------------------------------------------------------------- vdb

@pytest.mark.parametrize("compression", [jvdb.COMPRESS_NONE,
                                         jvdb.COMPRESS_ZIP],
                         ids=["none", "zip"])
def test_vdb_files_cross_read(tmp_path, compression):
    """A file the JAX writer wrote reads back equal with the port's
    reader, and a file the port's writer wrote with the JAX reader."""
    dens = blob((20, 17, 9), 8)
    em = np.stack([dens, dens * 0.5, dens * 2.0], -1)
    tr = np.eye(4)
    tr[0, 0] = tr[1, 1] = tr[2, 2] = 0.25
    tr[3, :3] = (-1.0, 2.0, 0.5)
    for write, read, cls in ((jvdb.write_vdb, tvdb.read_vdb,
                              jvdb.VdbGridData),
                             (tvdb.write_vdb, jvdb.read_vdb,
                              tvdb.VdbGridData)):
        path = str(tmp_path / f"{write.__module__}.vdb")
        write(path, {"density": cls("density", dens, (-5, 3, 40), tr),
                     "Cd": cls("Cd", em, (-5, 3, 40), tr)},
              compression=compression)
        back = read(path)
        assert sorted(back) == ["Cd", "density"]
        ref = (jvdb if read is tvdb.read_vdb else tvdb).read_vdb(path)
        for name in ("density", "Cd"):
            a, b = back[name], ref[name]
            assert a.values.dtype == np.float32
            assert np.array_equal(a.values, b.values)
            assert np.array_equal(a.ijk_min, b.ijk_min)
            assert np.array_equal(a.transform, b.transform)
        # and the values are the written ones
        lo = back["density"].ijk_min - np.asarray((-5, 3, 40))
        v = back["density"].values
        assert np.isclose(v.sum(), dens.sum())
        assert np.array_equal(v[-lo[0]:-lo[0] + 20, -lo[1]:-lo[1] + 17,
                                -lo[2]:-lo[2] + 9], dens)


# ---------------------------------------------------- forward-lobe BSDFs

FWD_DEFS = [
    {"type": "lambert", "albedo": [0.6, 0.5, 0.4]},
    {"type": "thinsheet", "ior": 1.4, "sigma_a": [0.2, 0.5, 1.0],
     "thickness": 0.3},
    {"type": "transparency", "base_index": 0,
     "alpha": {"type": "checker", "on_color": 0.8, "off_color": 0.2,
               "res_u": 4, "res_v": 4}},
    {"type": "forward"},
    {"type": "thinsheet", "ior": 1.9},
    {"type": "mirror"},
]


@pytest.fixture(scope="module")
def fwd_shaded():
    desc = SceneDesc(path="scene.json", json={}, bsdfs=FWD_DEFS,
                     primitives=[{"type": "quad", "bsdf_index": 0}],
                     media=[], camera={"type": "pinhole",
                                       "resolution": [8, 8]},
                     integrator={}, renderer={})
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    assert tset.present_bsdf_types == jset.present_bsdf_types
    types = jset.present_bsdf_types
    r = np.random.default_rng(9)
    n = len(FWD_DEFS) * R
    wi, wo = _dirs(r, n), _dirs(r, n)
    uv = r.uniform(size=(n, 2)).astype(np.float32)
    u = r.uniform(size=(4, n)).astype(np.float32)
    bidx = np.repeat(np.arange(len(FWD_DEFS), dtype=np.int32), R)
    jsp = jev.ShadePoint(js, jnp.asarray(bidx), jnp.asarray(uv))
    tsp = tev.ShadePoint(ts, _t(bidx).long(), _t(uv))
    jwi, jwo, twi, two = (jnp.asarray(wi), jnp.asarray(wo), _t(wi), _t(wo))
    jout, tout = [], []
    jout += [jev.bsdf_eval(jsp, jwi, jwo, types),
             jev.bsdf_pdf(jsp, jwi, jwo, types),
             jev.bsdf_forward(jsp, jwi, types)]
    tout += [tev.bsdf_eval(tsp, twi, two, types),
             tev.bsdf_pdf(tsp, twi, two, types),
             tev.bsdf_forward(tsp, twi, types)]
    for ns in (False, True):
        jout += list(jev.bsdf_sample(jsp, jwi, *map(jnp.asarray, u[:3]),
                                     types, u_lobe2=jnp.asarray(u[3]),
                                     no_specular=ns))
        tout += list(tev.bsdf_sample(tsp, twi, *map(_t, u[:3]), types,
                                     u_lobe2=_t(u[3]), no_specular=ns))
    return ([np.asarray(x) for x in jout], [x.numpy() for x in tout])


@pytest.mark.parametrize("bidx", range(len(FWD_DEFS)),
                         ids=[b["type"] + str(i)
                              for i, b in enumerate(FWD_DEFS)])
def test_forward_lobe_bsdf_matches_jax(fwd_shaded, bidx):
    lanes = slice(bidx * R, (bidx + 1) * R)
    for k, (a, b) in enumerate(zip(*fwd_shaded)):
        a, b = a[lanes], b[lanes]
        assert a.dtype == b.dtype, k
        assert _close(a, b, 1e-4, 1e-6).all(), (k, FWD_DEFS[bidx])
    fwd = fwd_shaded[1][2][lanes]
    name = FWD_DEFS[bidx]["type"]
    # forward passes everything, transparency 1 - alpha, thinsheet its
    # film transmittance, the rest nothing
    if name == "forward":
        assert (fwd == 1.0).all()
    elif name in ("transparency", "thinsheet"):
        assert ((fwd > 0) & (fwd < 1)).all()
    else:
        assert (fwd == 0).all()
    # no_specular drops the Dirac samples (flags and weight) only
    flags, flags_ns = fwd_shaded[1][6][lanes], fwd_shaded[1][10][lanes]
    spec = (flags & tev.FLAG_SPECULAR) != 0
    assert (flags_ns[spec] == 0).all() and (fwd_shaded[1][8][lanes][spec]
                                            == 0).all()
    assert (flags_ns[~spec] == flags[~spec]).all()


def test_thin_film_reflectance_matches_jax():
    r = np.random.default_rng(4)
    eta = r.uniform(0.4, 1.0, R).astype(np.float32)
    cos_i = r.uniform(0.0, 1.0, R).astype(np.float32)
    for a, b in zip(jfr.thin_film_reflectance(jnp.asarray(eta),
                                              jnp.asarray(cos_i)),
                    tfr.thin_film_reflectance(_t(eta), _t(cos_i))):
        assert _close(np.asarray(a), b.numpy(), 1e-5, 1e-6).all()
