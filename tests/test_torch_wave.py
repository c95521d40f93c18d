"""The traversal module (ops/wave_trace.py + ops/intersect.py) against the
JAX package on the random-soup fixture of tests/test_wave.py (700
triangles, 2048 rays):

  * the host table build and the front (_cull_sorted_supers) equal JAX's;
  * the plain walk (the wave kernels' plain version, the CPU path)
    equals JAX bvh_intersect on the CPU: tri exactly, t/u/v to 1e-6;
  * it passes test_wave.py's gates against the Pallas kernel run in
    interpret mode, closest hit and any hit;
  * list_walk (the CUDA kernels' own schedule in plain PyTorch) occludes
    what the Pallas kernel in interpret mode occludes on a 5,000-triangle
    soup, with and without zero-area triangles inside its clusters.
The CUDA kernels themselves are held to the same gates on the card by
tests/test_torch_cuda.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.ops import intersect as jis
from tungsten_tpu.ops import wave_trace as jwt
from tungsten_tpu.scene.bvh import build_bvh as jax_build_bvh
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.ops import intersect as tis
from tungsten_tpu_torch.ops import wave_trace as twt
from tungsten_tpu_torch.scene.bvh import build_bvh
from test_wave import _brute, _rays
from test_wave import _scene as _soup


def _tables(v0, e1, e2):
    return twt.build_wave_tables(v0, e1, e2)


def _analytic(lib, seed=4):
    """A few spheres, disks and cylinders inside the soup's box."""
    r = np.random.default_rng(seed)
    rot = np.stack([np.linalg.qr(r.normal(size=(3, 3)))[0]
                    for _ in range(2)]).astype(np.float32)
    n = r.normal(size=(2, 3))
    f32 = np.float32
    return dict(
        sph_center=lib(r.uniform(-2, 2, (3, 3)).astype(f32)),
        sph_radius=lib(r.uniform(0.2, 0.6, 3).astype(f32)),
        sph_prim=lib(np.arange(3, dtype=np.int32)),
        dsk_c=lib(r.uniform(-2, 2, (2, 3)).astype(f32)),
        dsk_n=lib((n / np.linalg.norm(n, axis=1, keepdims=True)).astype(f32)),
        dsk_r=lib(r.uniform(0.8, 1.4, 2).astype(f32)),
        cyl_pos=lib(r.uniform(-2, 2, (2, 3)).astype(f32)),
        cyl_rot=lib(rot), cyl_r=lib(r.uniform(0.2, 0.5, 2).astype(f32)),
        cyl_hh=lib(r.uniform(0.3, 0.8, 2).astype(f32)),
        cyl_capped=lib(np.array([True, False])),
        dsk_prim=lib(np.array([3, 4], np.int32)),
        cyl_prim=lib(np.array([5, 6], np.int32)),
        prim_bsdf=lib(np.array([0, 1, 2, 1, 0, 2, 1, 0], np.int32)),
        crv_seg_prim=lib(np.zeros((0,), np.int32)))


def _bvh_scene(v0, e1, e2, lib, build, analytic=False):
    """A scene holding what the traversal reads: the soup in BVH leaf
    order (`order` maps a leaf-order id back to the soup id) and its
    occluder bounds; the wave tables are built on the leaf-order arrays
    as flatten_scene builds them.  With `analytic` it also holds spheres,
    disks and cylinders."""
    v1, v2 = v0 + e1, v0 + e2
    lo = np.minimum(v0, np.minimum(v1, v2))
    hi = np.maximum(v0, np.maximum(v1, v2))
    bvh = build(lo, hi)
    o = bvh.order
    sv0, se1, se2 = v0[o], e1[o], e2[o]
    boxes, cbox, attr, remap, sbox = twt.build_wave_tables(sv0, se1, se2)
    sc = SimpleNamespace(
        tri_v0=lib(sv0), tri_e1=lib(se1), tri_e2=lib(se2),
        tri_fin=lib(np.concatenate([sv0, se1, se2], axis=1)),
        bvh_min=lib(bvh.bounds_min), bvh_max=lib(bvh.bounds_max),
        bvh_meta=lib(bvh.meta), bvh_skip=lib(bvh.skip),
        wk_boxes=lib(boxes), wk_cbox=lib(cbox), wk_attr=lib(attr),
        wk_remap=lib(remap), wk_sbox=lib(sbox),
        geo_lo=lib(lo.min(0)), geo_hi=lib(hi.max(0)),
        sph_center=lib(np.zeros((0, 3), np.float32)),
        sph_radius=lib(np.zeros((0,), np.float32)),
        sph_prim=lib(np.zeros((0,), np.int32)),
        tri_prim=lib((np.arange(len(o)) % 8).astype(np.int32)),
        tri_uv0=lib(np.zeros((len(o), 2), np.float32)),
        tri_uv1=lib(np.tile(np.float32([1, 0]), (len(o), 1))),
        tri_uv2=lib(np.tile(np.float32([0, 1]), (len(o), 1))),
        crv_pc_q0=lib(np.zeros((0, 4), np.float32)))
    if analytic:
        sc.__dict__.update(_analytic(lib))
    return sc, o


@pytest.fixture(scope="module")
def soup():
    v0, e1, e2, _ = _soup()
    R = 2 * jwt.BLOCK
    o, d = _rays(R)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::7] = 0.0  # dead rays must never hit
    return v0, e1, e2, o, d, tmin, tmax


def test_build_wave_tables_equal(soup):
    v0, e1, e2 = soup[:3]
    for a, b in zip(jwt.build_wave_tables(v0, e1, e2),
                    twt.build_wave_tables(v0, e1, e2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_cull_sorted_supers_equal(soup):
    """On a 20,000-triangle soup (15 live supers; the 700-triangle one
    has a single super, so nothing to sort), with rays from outside the
    soup in coherent 32-ray bundles (one origin, a narrow cone), as the
    dispatch's sort makes them, so the entries differ."""
    tmin, tmax = soup[5:]
    r = np.random.default_rng(9)
    nb = tmin.shape[0] // twt.SUBWARP
    o = r.normal(size=(nb, 3))
    o = np.repeat(o * 8.0 / np.linalg.norm(o, axis=-1, keepdims=True),
                  twt.SUBWARP, axis=0)
    aim = np.repeat(r.uniform(-2, 2, (nb, 3)), twt.SUBWARP, axis=0)
    d = aim + r.uniform(-0.3, 0.3, aim.shape) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    v0, e1, e2, _ = _soup(num_tris=20000)
    sbox = twt.build_wave_tables(v0, e1, e2)[4]
    assert (sbox[9] > 0).sum() > 8
    tmax = tmax.copy()
    tmax[1::5] = 1.25   # bounded segments too
    G = o.shape[0] // jwt.BLOCK
    js, ji = jwt._cull_sorted_supers(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin)[:, None],
        jnp.asarray(tmax)[:, None], jnp.asarray(sbox), G)
    ts, ti = twt._cull_sorted_supers(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmin)[:, None], torch.from_numpy(tmax)[:, None],
        torch.from_numpy(sbox), G)
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ts.numpy(), ti.numpy()
    assert np.array_equal(js, ts)           # entries exactly
    fin = js < 3e38
    assert fin.sum(-1).min() > 1            # every warp has a list to sort
    # ids where the entry is finite and not tied (JAX's sort is unstable)
    tie = np.zeros_like(fin)
    tie[..., 1:] |= js[..., 1:] == js[..., :-1]
    tie[..., :-1] |= js[..., :-1] == js[..., 1:]
    sel = fin & ~tie
    assert sel.sum() > 100
    assert np.array_equal(ji[sel], ti[sel])


def test_bvh_walk_equals_jax_bvh_intersect(soup, monkeypatch):
    """The plain walk against JAX bvh_intersect on the CPU: hit set and
    triangle ids exactly.  t/u/v are bit-equal to JAX's ray_tri run op by
    op on the winning triangles; the compiled JAX walk differs from that
    by a few ulps in t and up to ~1e-5 in u/v, because XLA contracts the
    compiled Moller-Trumbore's multiply-adds into fused ones."""
    monkeypatch.setattr(jis, "USE_PALLAS", False)
    v0, e1, e2, o, d, tmin, tmax = soup
    js_, jorder = _bvh_scene(v0, e1, e2, jnp.asarray, jax_build_bvh)
    ts_, torder = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    assert np.array_equal(jorder, torder)
    for any_hit, tm in ((False, tmax), (True, np.minimum(tmax, 1.25))):
        jr = jis.bvh_intersect(js_, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmin), jnp.asarray(tm),
                               any_hit=any_hit)
        tr = tis.bvh_intersect(ts_, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(tmin), torch.from_numpy(tm),
                               any_hit=any_hit)
        assert np.array_equal(np.asarray(jr["hit"]), tr["hit"].numpy())
        if any_hit:
            continue
        tri = tr["tri"].numpy()
        assert np.array_equal(np.asarray(jr["tri"]), tri)
        hit = tri >= 0
        assert hit.mean() > 0.2
        k = tri[hit]
        _, et, eu, ev = jis.ray_tri(
            jnp.asarray(o[hit]), jnp.asarray(d[hit]),
            js_.tri_v0[k], js_.tri_e1[k], js_.tri_e2[k], 0.0, 3e38)
        for name, want in (("t", et), ("u", eu), ("v", ev)):
            assert np.array_equal(tr[name].numpy()[hit], np.asarray(want))
        np.testing.assert_allclose(tr["t"].numpy(), np.asarray(jr["t"]),
                                   rtol=1e-5, atol=0)
        for name in ("u", "v"):
            np.testing.assert_allclose(tr[name].numpy(),
                                       np.asarray(jr[name]), rtol=0,
                                       atol=2e-5)


def test_analytic_prims_match_jax(soup, monkeypatch):
    """Spheres, disks and cylinders beside the triangles: the winner
    channels equal JAX bvh_intersect's on the CPU, t to rtol 1e-5, and
    the hit expansions (_hit_prim, _hit_ng, _hit_uv_bsdf) agree."""
    monkeypatch.setattr(jis, "USE_PALLAS", False)
    v0, e1, e2, o, d, tmin, tmax = soup
    js_, _ = _bvh_scene(v0, e1, e2, jnp.asarray, jax_build_bvh, True)
    ts_, _ = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh, True)
    jr = jis.bvh_intersect(js_, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmin), jnp.asarray(tmax))
    tr = tis.bvh_intersect(ts_, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmin), torch.from_numpy(tmax))
    for k in ("hit", "tri", "sph", "dsk", "cyl"):
        assert np.array_equal(np.asarray(jr[k]), tr[k].numpy()), k
    for k in ("sph", "dsk", "cyl"):
        assert (tr[k].numpy() >= 0).sum() > 10, k
    np.testing.assert_allclose(tr["t"].numpy(), np.asarray(jr["t"]),
                               rtol=1e-5, atol=0)
    # the hit expansions of the shadow and bsdf-strategy paths, fed the
    # same hit records
    hit = tr["hit"].numpy()
    jres = {k: jnp.asarray(tr[k].numpy()) for k in tr}
    assert np.array_equal(np.asarray(jpt._hit_prim(js_, jres)),
                          tpt._hit_prim(ts_, tr).numpy())
    juv, jb, jp = jpt._hit_uv_bsdf(js_, jres)
    tuv, tb, tp = tpt._hit_uv_bsdf(ts_, tr)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-6,
                               atol=1e-7)
    for args in ((), (o, d)):
        jng = jpt._hit_ng(js_, jres, *map(jnp.asarray, args))
        tng = tpt._hit_ng(ts_, tr, *map(torch.from_numpy, args))
        np.testing.assert_allclose(tng.numpy()[hit], np.asarray(jng)[hit],
                                   rtol=1e-5, atol=1e-6)


def _gates(t, tri, u, v, bt, bi, uu, vv, live):
    """tests/test_wave.py's gates: hit set, t, tri, u/v."""
    agree = ((tri >= 0) == (bi >= 0))[live]
    assert agree.mean() > 0.998, f"hit-set agreement {agree.mean()}"
    both = live & (bi >= 0) & (tri >= 0)
    assert np.isclose(t[both], bt[both], rtol=2e-3).mean() > 0.999
    assert (tri[both] == bi[both]).mean() > 0.999
    same = both & (tri == bi)
    rows = np.where(same)[0]
    assert np.isclose(u[same], uu[rows, tri[same]], atol=2e-3).all()
    assert np.isclose(v[same], vv[rows, tri[same]], atol=2e-3).all()
    assert (tri[~live] == -1).all()


def _port_hits(sc, order, o, d, tmin, tmax, any_hit, device):
    dev = torch.device(device)
    t, tri, u, v = twt.wave_intersect(
        sc, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
        torch.from_numpy(tmin).to(dev), torch.from_numpy(tmax).to(dev),
        any_hit=any_hit, device=device)
    tri = tri.cpu().numpy()   # leaf-order ids -> soup ids
    tri = np.where(tri >= 0, order[np.clip(tri, 0, None)], -1)
    return t.cpu().numpy(), tri, u.cpu().numpy(), v.cpu().numpy()


def test_plain_walk_passes_wave_gates(soup):
    v0, e1, e2, o, d, tmin, tmax = soup
    boxes, cbox, attr, remap, sbox = jwt.build_wave_tables(v0, e1, e2)
    jt, jtri, ju, jv = map(np.asarray, jwt.wave_intersect(
        jnp.asarray(boxes), jnp.asarray(cbox), jnp.asarray(attr),
        jnp.asarray(remap), jnp.asarray(sbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        ncp=boxes.shape[1], interpret=True, tri_v0=jnp.asarray(v0),
        tri_e1=jnp.asarray(e1), tri_e2=jnp.asarray(e2)))
    sc, order = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    t, tri, u, v = _port_hits(sc, order, o, d, tmin, tmax, False, "cpu")
    live = tmax > 0
    # the interpreted Pallas kernel is the reference of the gates
    _, _, uu, vv = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, jt, jtri, uu, vv, live)
    # and the f32 brute force too
    bt, bi, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, bt, bi, uu, vv, live)


def test_plain_walk_anyhit_gate(soup):
    v0, e1, e2, o, d, tmin, _ = soup
    R = jwt.BLOCK
    o, d, tmin = o[:R], d[:R], tmin[:R]
    tmax = np.full((R,), 1.25, np.float32)
    boxes, cbox, attr, remap, sbox = jwt.build_wave_tables(v0, e1, e2)
    _, jtri, _, _ = jwt.wave_intersect(
        jnp.asarray(boxes), jnp.asarray(cbox), jnp.asarray(attr),
        jnp.asarray(remap), jnp.asarray(sbox), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        ncp=boxes.shape[1], interpret=True, any_hit=True)
    sc, order = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    _, tri_a, _, _ = _port_hits(sc, order, o, d, tmin, tmax, True, "cpu")
    _, tri_c, _, _ = _port_hits(sc, order, o, d, tmin, tmax, False, "cpu")
    _, bi, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    assert ((tri_a >= 0) == (bi >= 0)).mean() > 0.998
    assert ((tri_a >= 0) == (np.asarray(jtri) >= 0)).mean() > 0.998
    assert ((tri_a >= 0) == (tri_c >= 0)).all()


def test_wave_dispatch_sort_pad_unpermute(soup):
    """The dispatch's sort / pad-to-1024 / un-permute (run here around the
    plain walk) returns exactly the unsorted traversal's results."""
    v0, e1, e2, o, d, tmin, tmax = soup
    R = 1500   # not a multiple of 1024: exercises the padding
    sc, _ = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    args = (torch.from_numpy(o[:R]), torch.from_numpy(d[:R]),
            torch.from_numpy(tmin[:R]), torch.from_numpy(tmax[:R]))
    for any_hit in (False, True):
        ref = tis.bvh_walk(sc, *args, any_hit=any_hit)
        got = tis._wave_dispatch(sc, *args, any_hit=any_hit)
        assert torch.equal(ref[1] >= 0, got[1] >= 0)
        if not any_hit:
            for a, b in zip(ref, got):
                assert torch.equal(a, b)


def _zero_area_soup(num_tris=5000, seed=5):
    """The 5,000-triangle soup with every fourth triangle of zero area
    (e1 = 0 or e2 = 0, so n = e1 x e2 is exactly 0): after the BVH sort
    they sit inside clusters, before real triangles."""
    v0, e1, e2, _ = _soup(num_tris=num_tris, seed=seed)
    e1, e2 = e1.copy(), e2.copy()
    e1[::8] = 0.0
    e2[4::8] = 0.0
    return v0, e1, e2


def _list_walk_case(zero_area, any_hit):
    """The 5,000-triangle soup (with every fourth triangle of zero area
    when asked) in its own order, 1,024 rays from tests/test_wave.py,
    every fifth dead (any hit: segments of length 1.25): the soup, the
    rays, its wave tables, list_walk's finalized (t, tri) and needed
    count on the resident front, checked for what needed must be."""
    if zero_area:
        v0, e1, e2 = _zero_area_soup()
    else:
        v0, e1, e2 = _soup(num_tris=5000, seed=5)[:3]
    R = jwt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 1.25 if any_hit else 3e38, np.float32)
    tmax[::5] = 0.0
    tables = twt.build_wave_tables(v0, e1, e2)
    fin = np.concatenate([v0, e1, e2], axis=1)
    sc = SimpleNamespace(**{k: torch.from_numpy(x) for k, x in (
        ("wk_cbox", tables[1]), ("wk_attr", tables[2]),
        ("wk_remap", tables[3]), ("wk_sbox", tables[4]), ("tri_v0", v0),
        ("tri_fin", fin))})
    rays = [torch.from_numpy(x) for x in (o, d, tmin, tmax)]
    f, sent, sids, tmax_c = twt.kernel_inputs(sc, *rays)
    t, tri, need = twt.list_walk(f, sent, sids, sc.wk_cbox, sc.wk_attr,
                                 any_hit)
    need = need.numpy()
    assert (need[tmax <= 0] == 0).all() and need.sum() > 0
    assert (need[tri.numpy() >= 0] >= 1).all()
    t, tri, _, _ = (x.numpy() for x in twt._finish(sc, rays[0], rays[1], t,
                                                   tri, tmax_c, any_hit))
    assert 100 < (tri >= 0).sum() < 0.9 * R
    return (v0, e1, e2), (o, d, tmin, tmax), tables, t, tri


@pytest.mark.parametrize("zero_area", [False, True])
def test_list_walk_anyhit_matches_jax(zero_area):
    """list_walk's any hit on the resident front occludes exactly the
    segments the JAX kernel (wave_intersect, interpret mode) occludes on
    the same tables, on the 5,000-triangle soup and on the same soup
    with zero-area triangles inside its clusters.  The JAX call has the
    shapes of test_plain_walk_anyhit_gate's, so it reuses that compile;
    the closest hit is held to JAX in tests/test_torch_paged.py."""
    _, rays, tables, _, tri = _list_walk_case(zero_area, True)
    _, jtri, _, _ = jwt.wave_intersect(
        *(jnp.asarray(x) for x in tables + rays), ncp=tables[0].shape[1],
        interpret=True, any_hit=True)
    assert np.array_equal(tri >= 0, np.asarray(jtri) >= 0)
