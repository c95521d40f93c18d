"""The port's photon maps (tungsten_tpu_torch/integrators/photon_map.py)
against the JAX package's, piece by piece on the CPU, on the same inputs.

Two scenes, built in memory: a caustic scene (an area light over a
lambert floor, a mirror sphere and a lambert sphere, both UV-sphere
meshes written with the port's mesh IO) for the surface map, and
tests/test_photon_volume.py's fog fixture in planes mode (which records
photons, beams and planes) for the volume maps.  JAX traces 4,096 photon
paths a scene, jitted once per settings; the port runs the same scene
carried across with flat_scene_from_numpy, with bit-equal random numbers.

  * trace_photons per slot: valid, vol, bounce (and the beam and plane
    flags) equal on >= 0.995 of slots; pos, dir, power and the beam and
    plane fields within rtol 1e-5 / atol 1e-6 on >= 0.995 of the slots
    valid in both (a photon reflected off a mirror after a hit a few
    ulps apart drifts further), rays equal.
  * the photon, beam and plane grids built from the JAX photons: keys,
    beam / plane ids and the sorted payloads bitwise (the port drops the
    invalid photons, beams and lattice points before its sort, so the
    grids are held on JAX's valid prefix, whose tail is all invalid).
  * _gather_estimate, _gather_volume, _beam_eval and _plane_eval on the
    JAX grids and shared query points or rays, JAX eager: the k nearest
    photons selected at the same candidate positions (lax.top_k captured
    while JAX runs) and every estimate within rtol 1e-5 (atol 1e-6 of the
    largest); _plane_eval's shadow rays go to the port's plain walk.
  * ppm_gamma to 1e-12, the saturating float-to-int cell cast, and two
    photons tied at the k-th distance, taken in lax.top_k's order.
"""
import copy
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.integrators import photon_map as jpm
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu.utils import vecmath as jvm
from tungsten_tpu_torch.integrators import photon_map as tpm
from tungsten_tpu_torch.io import mesh as tmesh
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_photon_volume import _fog_scene
from test_torch_flatten import jax_fields

N_PATHS = 4096
SEED = 7
RTOL, ATOL = 1e-5, 1e-6
GATHER_R = 0.35
FLAGS = ("valid", "vol", "bounce", "b_valid", "pl_valid")
VALID_OF = {"pos": "valid", "dir": "valid", "power": "valid",
            "b_o": "b_valid", "b_d": "b_valid", "b_len": "b_valid",
            "b_pow": "b_valid", "pl_p0": "pl_valid", "pl_p1": "pl_valid",
            "pl_d1": "pl_valid", "pl_l1": "pl_valid", "pl_pow": "pl_valid"}


def uv_sphere(nu, nv):
    """Unit UV sphere: (pos, normal, uv, indices), outward winding."""
    th = np.pi * np.arange(nv + 1) / nv
    ph = 2.0 * np.pi * np.arange(nu + 1) / nu
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    pos = np.stack([st * np.cos(ph), np.broadcast_to(ct, (nv + 1, nu + 1)),
                    st * np.sin(ph)], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack(np.meshgrid(np.arange(nu + 1) / nu, np.arange(nv + 1) / nv),
                  -1).reshape(-1, 2).astype(np.float32)
    tris = []
    for i in range(nv):
        for j in range(nu):
            a = i * (nu + 1) + j
            b, c = a + 1, a + nu + 1
            if i > 0:
                tris.append((a, b, c))
            if i < nv - 1:
                tris.append((b, c + 1, c))
    return pos, pos.copy(), uv, np.asarray(tris, np.int32)


def caustic_scene(d, w=16, h=16):
    """An area light over a lambert floor with a mirror sphere (its
    caustic on the floor) and a lambert sphere, the spheres meshes
    written to `d`."""
    pos, nrm, uv, idx = uv_sphere(24, 12)
    tmesh.save_wo3(os.path.join(d, "sphere.wo3"), tmesh.Mesh(
        pos=pos, normal=nrm, uv=uv, indices=idx,
        material=np.zeros(len(idx), np.int32)))
    return SceneDesc(
        path=os.path.join(d, "caustic.json"), json={}, media=[],
        bsdfs=[{"type": "lambert", "albedo": 0.6},
               {"type": "mirror", "albedo": 0.9},
               {"type": "lambert", "albedo": [0.2, 0.5, 0.8]}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [15.0] * 3,
             "transform": {"position": [0, 2.5, 0], "scale": 1.0,
                           "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, -1, 0], "scale": [6, 1, 6]}},
            {"type": "mesh", "file": "sphere.wo3", "smooth": True,
             "bsdf_index": 1,
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.6}},
            {"type": "mesh", "file": "sphere.wo3", "smooth": True,
             "bsdf_index": 2,
             "transform": {"position": [-1.1, -0.6, 0.6], "scale": 0.4}}],
        camera={"type": "pinhole", "resolution": [w, h], "fov": 50,
                "transform": {"position": [0, 1.2, 4.0],
                              "look_at": [0, -0.5, 0]}},
        integrator={"type": "photon_map", "max_bounces": 6,
                    "photon_count": 1 << 16, "gather_radius": 0.1,
                    "gather_photon_count": 16},
        renderer={"spp": 1})


def fog_planes_scene():
    desc = _fog_scene()
    desc.integrator["volume_photon_type"] = "planes"
    return desc


def both(desc):
    """The JAX scene and settings, and the port's scene carried across
    from the JAX arrays with the port's own settings.  The JAX settings
    get a seed of their own, so their jit is compiled for this file's
    sampler (JAX's trace_photons caches by settings)."""
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    return js, replace(jset, seed=0x5EED), ts, tset


class sampler:
    """JAX's module-global sampler set for the settings, restored after."""

    def __init__(self, settings):
        self.on = settings.stratified_sampler

    def __enter__(self):
        self.prev = jrng._SAMPLER
        jrng.set_sampler(self.on)

    def __exit__(self, *exc):
        jrng._SAMPLER = self.prev


def traced(desc):
    js, jset, ts, tset = both(desc)
    with sampler(jset):
        j = jpm.trace_photons(js, jset, N_PATHS, np.uint32(SEED),
                              np.uint32(0))
        j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: v.numpy() for k, v in tpm.trace_photons(ts, tset, N_PATHS,
                                                    SEED).items()}
    return dict(js=js, jset=jset, ts=ts, tset=tset, jax=j, port=t)


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    return traced(caustic_scene(str(tmp_path_factory.mktemp("caustic"))))


@pytest.fixture(scope="module")
def fog():
    return traced(fog_planes_scene())


# ---------------------------------------------------------- photon pass

@pytest.mark.parametrize("case", ["surface", "fog"])
def test_trace_photons_matches_jax(case, request):
    c = request.getfixturevalue(case)
    j, t = c["jax"], c["port"]
    assert set(j) == set(t)
    assert int(j["rays"]) == int(t["rays"])
    for k in FLAGS:
        if k in j:
            assert j[k].shape == t[k].shape, k
            assert (j[k] == t[k]).mean() >= 0.995, (k, (j[k] == t[k]).mean())
    for k, v in VALID_OF.items():
        if k not in j:
            continue
        m = j[v] & t[v]
        if case == "surface" and k.startswith("b_"):
            assert not m.any()      # no media: no beams
            continue
        assert m.sum() > 200, k
        ok = np.isclose(t[k], j[k], rtol=RTOL, atol=ATOL)
        ok = ok.reshape(len(ok), -1).all(-1)[m]
        assert ok.mean() >= 0.995, (k, ok.mean())
    # the comparison sees real work
    if case == "surface":
        assert t["valid"].mean() > 0.05 and (t["bounce"] >= 2).sum() > 100
    else:
        assert t["vol"].mean() > 0.5 and t["b_valid"].mean() > 0.1
        assert t["pl_valid"].mean() > 0.1


# ----------------------------------------------------------------- grids

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def per_path(photons):
    """The photon, beam and plane powers divided by the paths traced."""
    out = dict(photons)
    for k in ("power", "b_pow", "pl_pow"):
        if k in out:
            out[k] = out[k] / np.float32(N_PATHS)
    return out


def _numpy_grid(grid):
    return {k: (v if isinstance(v, float) else np.asarray(v))
            for k, v in grid.items()}


def to_torch(grid):
    """A JAX grid (numpy) as the port's: arrays as tensors, scalars as
    floats."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) and v.ndim else float(v))
            for k, v in grid.items()}


def build_grids(mod, ph, settings, surf_r):
    """The surface grid at surf_r and, with media, the points volume,
    beam and plane grids at the volume radius, built by `mod`."""
    out = {"surf": mod.build_photon_grid(
        dict(ph, valid=ph["valid"] & ~ph["vol"]), surf_r)}
    if settings.has_media:
        r = settings.vol_gather_radius
        out["vol"] = mod.build_photon_grid(
            dict(ph, valid=ph["valid"] & ph["vol"]), r)
        out["beam"] = mod.build_beam_grid(ph, r)
        out["plane"] = mod.build_plane_grid(ph, r)
    return out


@pytest.fixture(scope="module")
def grids(surface, fog):
    """Each scene's grids of the JAX photons (powers per path), built by
    JAX and by the port: {scene: (jax grids, port grids)}."""
    out = {}
    for name, c, r in (("surface", surface, GATHER_R),
                       ("fog", fog, fog["jset"].gather_radius)):
        ph = {k: v for k, v in per_path(c["jax"]).items() if k != "rays"}
        jg = {k: _numpy_grid(g) for k, g in
              build_grids(jpm, ph, c["jset"], r).items()}
        tg = build_grids(tpm, {k: torch.from_numpy(v) for k, v in ph.items()},
                         c["tset"], r)
        out[name] = (jg, tg)
    return out


def test_grid_builds_match_jax_bitwise(grids):
    for scene, (jg, tg) in grids.items():
        assert set(jg) == set(tg)
        for name in jg:
            j, t = jg[name], tg[name]
            # the port keeps JAX's valid prefix; JAX's tail is invalid
            n = len(_np(t["key"]))
            assert (j["key"][n:] == tpm.INVALID_KEY).all(), name
            assert n > 100 and (j["key"][:n] != tpm.INVALID_KEY).all()
            assert np.array_equal(_np(t["lo"]), j["lo"]), (scene, name)
            assert np.float32(t["inv_cell"]) == np.float32(j["inv_cell"])
            for f, v in j.items():
                if f in ("lo", "inv_cell", "cell"):
                    continue
                got, want = _np(t[f]), v
                if f in ("key", "bid", "pid") or name in ("surf", "vol"):
                    want = want[:n]
                assert got.shape == want.shape, (scene, name, f)
                assert np.array_equal(
                    np.ascontiguousarray(got).view(np.uint8),
                    np.ascontiguousarray(want).view(np.uint8)), \
                    (scene, name, f)


def test_saturating_cell_cast_matches_jax():
    """A point 1e9 cells out on either side, infinities and a NaN land in
    the cells JAX's saturating astype(int32) and clip give them (the
    plain torch cast would put +1e9 cells and +inf in cell 1)."""
    lo = np.asarray([0.5, -1.0, 2.0], np.float32)
    inv = 1.0 / 0.05
    p = np.asarray([[0.55, -0.9, 2.3], [0.5 + 1e9 * 0.05, -1.0, 2.0],
                    [0.5 - 1e9 * 0.05, 30.0, 2.1], [np.nan, 0.0, np.inf],
                    [-np.inf, np.nan, 2.05]], np.float32)
    want = np.asarray(jnp.clip(((jnp.asarray(p) - lo) * inv).astype(
        jnp.int32), 1, jpm.GRID_RES - 3))
    got = tpm._cell(torch.from_numpy(p), torch.from_numpy(lo), inv).numpy()
    assert np.array_equal(got, want)
    assert got[1, 0] == jpm.GRID_RES - 3 and got[3, 0] == 1


def test_ppm_gamma_matches_jax():
    for alpha in (0.3, 0.7):
        for i in range(12):
            assert abs(tpm.ppm_gamma(i, alpha) - jpm.ppm_gamma(i, alpha)) \
                <= 1e-12


# ----------------------------------------------------------- the gathers

class capture_top_k:
    """Record what jax.lax.top_k returns while the JAX gather runs."""

    def __enter__(self):
        self.orig = jax.lax.top_k
        self.got = []

        def top_k(x, k):
            out = self.orig(x, k)
            self.got.append(out)
            return out
        jax.lax.top_k = top_k
        return self

    def __exit__(self, *exc):
        jax.lax.top_k = self.orig


def close_rows(got, want):
    """Per row: within rtol 1e-5 and atol 1e-6 of the largest entry."""
    got, want = _np(got), _np(want)
    atol = ATOL * max(float(np.abs(want).max()), 1e-30)
    return np.isclose(got, want, rtol=RTOL, atol=atol).all(-1)


# the tie case: a query at TIE_Q with 13 photons nearer than 0.25 (at
# k/64 along x) and six at exactly 0.25 on the axes, so the 16th nearest
# is tied six ways (every coordinate and distance exact in binary)
TIE_Q = np.asarray([4.25, 2.0, -4.375], np.float32)
TIE_OFF = np.concatenate([
    np.asarray([[k / 64.0, 0, 0] for k in range(1, 14)]),
    np.asarray([[0.25, 0, 0], [-0.25, 0, 0], [0, 0.25, 0], [0, -0.25, 0],
                [0, 0, 0.25], [0, 0, -0.25]])]).astype(np.float32)


def _with_tie_photons(ph):
    n = len(TIE_OFF)
    extra = dict(pos=TIE_Q + TIE_OFF,
                 dir=np.tile(np.asarray([0, -1, 0], np.float32), (n, 1)),
                 power=np.linspace(1e-3, 2e-3, n * 3,
                                   dtype=np.float32).reshape(n, 3),
                 bounce=np.ones(n, np.int32), valid=np.ones(n, bool),
                 vol=np.zeros(n, bool))
    return {k: np.concatenate([ph[k], extra[k]]) for k in extra}


def _surface_queries(c, n):
    """n query points: half near photons (jittered within half the
    radius), a quarter on the floor at random, the rest far outside the
    map; then the tie query."""
    r = np.random.default_rng(11)
    j = c["jax"]
    pos = j["pos"][j["valid"] & ~j["vol"]]
    a = pos[r.integers(0, len(pos), n // 2)] + \
        r.uniform(-1, 1, (n // 2, 3)) * GATHER_R * 0.5
    b = np.stack([r.uniform(-3, 3, n // 4), np.full(n // 4, -1.0),
                  r.uniform(-3, 3, n // 4)], -1)
    far = r.uniform(20, 40, (n - n // 2 - n // 4, 3))
    return np.concatenate([a, b, far, TIE_Q[None]]).astype(np.float32)


def test_gather_estimate_selects_and_estimates_as_jax(surface):
    """257 query points (near photons, on the floor, far away, and the
    tie query) on the JAX surface grid of the caustic scene's photons
    (powers per path) plus the tie photons, at a radius of 0.35, where
    4,096 paths' photons fill many points' k: JAX's _gather_estimate
    eagerly with lax.top_k captured, the port's on the same grid."""
    c = surface
    s, ts = c["jset"], c["tset"]
    K = s.gather_count
    grid = _numpy_grid(jpm.build_photon_grid(
        _with_tie_photons(per_path(c["jax"])), GATHER_R))
    p = _surface_queries(c, 256)
    n = len(p)
    r = np.random.default_rng(12)
    ns = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (n, 1))
    tan, bit = (np.asarray(x) for x in jvm.ortho_frame(jnp.asarray(ns)))
    wi = r.normal(size=(n, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2])
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    bsdf = r.choice([0, 2], n).astype(np.int32)   # the two lambert BSDFs
    uv = r.uniform(size=(n, 2)).astype(np.float32)
    cb = r.integers(1, 3, n).astype(np.int32)
    J = jnp.asarray
    with capture_top_k() as cap:
        est_j = np.asarray(jpm._gather_estimate(
            c["js"], s, grid, np.float32(GATHER_R), J(p),
            (J(tan), J(bit), J(ns)), J(wi), J(bsdf), J(uv), J(cb)))
    neg, sel_j = (np.asarray(x) for x in cap.got[-1])
    d2_j = -neg
    grid_t = to_torch(grid)
    T = torch.from_numpy
    est_t = tpm._gather_estimate(
        c["ts"], ts, grid_t, float(np.float32(GATHER_R)), T(p),
        (T(tan), T(bit), T(ns)), T(wi), T(bsdf).long(), T(uv), T(cb)).numpy()
    d2_t, _, pos_t = (x.numpy() for x in tpm._knn(
        grid_t, float(np.float32(GATHER_R)), K, T(p)))
    got = np.isfinite(d2_j)
    assert got.sum() > 1000 and (got.sum(1) == K).sum() > 50
    assert np.array_equal(np.isfinite(d2_t), got)
    assert np.array_equal(np.where(got, sel_j, -1), pos_t)
    assert np.array_equal(np.where(got, d2_j, 0), np.where(got, d2_t, 0))
    # the tie query: 13 nearer photons, then 3 of the 6 tied at 0.25
    assert (d2_j[-1] == np.float32(0.0625)).sum() == 3
    assert len(set(sel_j[-1].tolist())) == K
    ok = close_rows(est_t, est_j)
    assert ok.all(), np.nonzero(~ok)
    assert (est_j.sum(-1) > 0).mean() > 0.3 and est_j[-1].sum() > 0


def _medium_of(c):
    js = c["js"]
    mi = int(np.clip(int(js.cam_medium), 0, js.med_phase.shape[0] - 1))
    return np.asarray(js.med_phase)[mi], np.asarray(js.med_g)[mi]


def test_gather_volume_matches_jax(fog, grids):
    """256 points (by volume photons, and at random in the room) on the
    JAX points grid of the fog photons."""
    c = fog
    s = c["jset"]
    vgrid = grids["fog"][0]["vol"]
    j = c["jax"]
    r = np.random.default_rng(5)
    vp = j["pos"][j["valid"] & j["vol"]]
    p = np.concatenate([
        vp[r.integers(0, len(vp), 192)] + r.uniform(-0.2, 0.2, (192, 3)),
        r.uniform([-3, -1, -3], [3, 2.2, 3], (64, 3))]).astype(np.float32)
    wo = r.normal(size=(256, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    pt, g = _medium_of(c)
    ptype = np.full(256, pt, np.int32)
    pg = np.full(256, g, np.float32)
    vr = np.float32(s.vol_gather_radius)
    want = np.asarray(jpm._gather_volume(
        c["js"], s, vgrid, vr, jnp.asarray(p), jnp.asarray(wo),
        jnp.asarray(ptype), jnp.asarray(pg)))
    T = torch.from_numpy
    got = tpm._gather_volume(c["ts"], c["tset"], to_torch(vgrid), float(vr),
                             T(p), T(wo), T(ptype), T(pg)).numpy()
    assert (want.sum(-1) > 0).mean() > 0.5
    ok = close_rows(got, want)
    assert ok.all(), np.nonzero(~ok)


def _fog_rays(n):
    """Rays from the fog camera's position into the room, marching 3 to
    7 units (their t1)."""
    r = np.random.default_rng(9)
    o = np.tile(np.asarray([0.0, 0.5, 4.0], np.float32), (n, 1))
    tgt = r.uniform([-2, -1, -2], [2, 2.2, 2], (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t1 = r.uniform(3.0, 7.0, n).astype(np.float32)
    return o, d.astype(np.float32), t1


@pytest.mark.parametrize("kind", ["beam", "plane"])
def test_beam_and_plane_eval_match_jax(fog, grids, kind):
    """64 camera rays through the fog on the JAX beam / plane grid of the
    fog photons (beam and plane powers per path), JAX eager; the plane
    map's shadow rays on each side's own walk (the port's plain walk)."""
    c = fog
    s = c["jset"]
    grid = grids["fog"][0][kind]
    o, d, t1 = _fog_rays(64)
    J = jnp.asarray
    T = torch.from_numpy
    vr = np.float32(s.vol_gather_radius)
    if kind == "beam":
        want = jpm._beam_eval(c["js"], s, grid, vr, J(o), J(d), J(t1))
        got = tpm._beam_eval(c["ts"], c["tset"], to_torch(grid), float(vr),
                             T(o), T(d), T(t1))
    else:
        want = jpm._plane_eval(c["js"], s, grid, J(o), J(d), J(t1))
        got = tpm._plane_eval(c["ts"], c["tset"], to_torch(grid), T(o),
                              T(d), T(t1))
    want, got = np.asarray(want), got.numpy()
    assert (want.sum(-1) > 0).mean() > 0.5
    ok = close_rows(got, want)
    assert ok.all(), np.nonzero(~ok)
