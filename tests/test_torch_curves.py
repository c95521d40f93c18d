"""The port's curves against the JAX package on the CPU:
  * curve files (.fiber, .hair, OBJ) written by one package and read by
    the other, and init_normals, equal;
  * flatten_scene on curves in each of the four modes and with
    curve_taper, curve_thickness, subsample and instances: every crv_*,
    cbvh_* and hair_* table and the geo bounds equal, and the settings;
  * the traversal on one scene of curves in all four modes, a quad (two
    triangles) and an analytic sphere in front of some of them, on
    seeded rays with vertical rays along +-y and per-ray t_min > 0:
    `bvh_intersect` (closest hit, the file's one JAX compile), and the
    port's curve walk alone, in closest and any hit, against the
    `_curve_traverse` result that JAX's bvh_intersect merged (its far
    limits the triangles' and the sphere's best t, from the port's
    traversal, which tests/test_torch_wave.py and test_torch_lights.py
    hold to JAX's);
  * the hit expansion (`_expand_hit`) and `shading_frame` of curve hits;
  * a scene of curves and no triangles.

Stated tolerances of the traversal (the JAX CPU walk runs compiled, and
XLA contracts multiply-adds, so an edge hit may flip): hit sets agree on
>= 0.9999 of the rays, the segment on >= 0.9999 of the rays both hit, t
within rtol 1e-5 where the segments agree, u and v within atol 1e-4 on
>= 97 % of those lanes and within 0.05 on all.  The last is the
reference's: a piece's cylinder test extends its chord past its far end
(it checks seg_t2 >= 0 and the segment parameter, not seg_t2 <= 1), so
on a nearly straight segment several pieces meet a ray at t equal to
within an ulp, and the rounding picks which one wins, with u and v a few
hundredths apart (1.3 % of the lanes here, up to 0.017).
"""
import copy
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.io import curves as jcio
from tungsten_tpu.ops import intersect as jis
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import curves as tcio
from tungsten_tpu_torch.ops import intersect as tis
from tungsten_tpu_torch.scene.flatten import (CURVE_MODES, RenderSettings,
                                              flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import _assert_same_scene, jax_fields
from dataclasses import fields

HIT_SHARE = 0.9999
T_RTOL = 1e-5
UV_ATOL, UV_CLOSE, UV_SHARE = 0.05, 1e-4, 0.97


def strands(n, n_nodes, seed, width=0.02, origin=(0.0, 0.0, 0.0),
            spread=0.4, step=(0.0, 0.1, 0.0)):
    """n seeded random-walk strands of n_nodes nodes (the generator of
    tests/test_fiber.py::test_hair_scene_render): CurveData."""
    rng = np.random.default_rng(seed)
    step = np.asarray(step, np.float64)
    nodes_l, ends, tot = [], [], 0
    for _ in range(n):
        base = np.asarray(origin) + np.array(
            [rng.uniform(-spread, spread), 0.0, rng.uniform(-spread, spread)])
        jitter = rng.normal(0, 0.3, (n_nodes, 3)) * 0.1
        jitter[:, 1] = 0.0
        pts = base[None] + np.cumsum(step[None] + jitter, 0)
        nodes_l.append(np.concatenate(
            [pts, np.full((n_nodes, 1), width)], 1).astype(np.float32))
        tot += n_nodes
        ends.append(tot)
    nodes = np.concatenate(nodes_l)
    ce = np.asarray(ends, np.uint32)
    return tcio.CurveData(ce, nodes, tcio.init_normals(ce, nodes))


def write_strands(tmp, name, data):
    path = os.path.join(tmp, name)
    (tcio.save_hair if name.endswith(".hair") else tcio.save_fiber)(
        path, data)
    return name


def desc_of(tmp, bsdfs, prims, camera=None, bounces=6, spp=2):
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={}, bsdfs=bsdfs,
        primitives=prims, media=[],
        camera=camera or {"type": "pinhole", "resolution": [16, 16],
                          "transform": {"position": [0, 0.5, -2.2],
                                        "look_at": [0, 0.5, 0],
                                        "up": [0, 1, 0]}},
        integrator={"max_bounces": bounces}, renderer={"spp": spp})


FIBERS = [{"name": "hair", "type": "hair", "scale_angle": 2.5,
           "melanin_ratio": 1.0, "melanin_concentration": 1.3,
           "roughness": 0.3, "albedo": 1.0},
          {"name": "wire", "type": "rough_wire", "material": "Cu",
           "roughness": 0.2, "albedo": 0.9},
          {"name": "fiber", "type": "lambertian_fiber",
           "albedo": [0.6, 0.5, 0.3]},
          {"name": "wall", "type": "lambert", "albedo": 0.6}]


def mixed_prims(tmp):
    """Curves in all four modes (the fiber BCSDFs and a default-hair
    prim), with the strands of one mode lying along x so that vertical
    rays meet them."""
    prims = []
    for i, mode in enumerate(("cylinder", "half_cylinder", "bcsdf_cylinder",
                              "ribbon")):
        data = strands(12, 8, seed=20 + i, width=0.03,
                       origin=(-0.9 + 0.6 * i, -0.3, 0.0),
                       step=((0.1, 0.0, 0.0) if mode == "cylinder"
                             else (0.0, 0.1, 0.0)))
        prim = {"type": "curves", "mode": mode,
                "file": write_strands(tmp, f"s{i}.fiber", data)}
        if mode != "bcsdf_cylinder":
            prim["bsdf_index"] = {"cylinder": 3, "half_cylinder": 2,
                                  "ribbon": 1}[mode]
        prims.append(prim)
    return prims


def _rays(n, seed):
    """Seeded rays at the curve block from in front, 64 along +y from
    below and 64 along -y from above (the degenerate ray frame), a third
    with t_min 0.3."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-1.5, 1.5, n), r.uniform(-0.5, 1.2, n),
                  np.full(n, -2.0)], 1).astype(np.float32)
    tgt = np.stack([r.uniform(-1.2, 1.2, n), r.uniform(-0.4, 1.0, n),
                    r.uniform(-0.4, 0.4, n)], 1)
    d = tgt - o
    o[:64] = np.stack([r.uniform(-1.2, -0.2, 64), np.full(64, -1.0),
                       r.uniform(-0.5, 0.5, 64)], 1)
    d[:64] = [0.0, 1.0, 0.0]
    o[64:128] = np.stack([r.uniform(-1.2, -0.2, 64), np.full(64, 2.0),
                          r.uniform(-0.5, 0.5, 64)], 1)
    d[64:128] = [0.0, -1.0, 0.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.where(np.arange(n) % 3 == 2, 0.3, 0.0).astype(np.float32)
    return o, d, t_min


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ curve files

@pytest.mark.parametrize("fmt", ["fiber", "hair", "obj"])
def test_curve_files_cross_read(tmp_path, fmt):
    """A file written by one package reads back equal in the other (OBJ:
    the same text read by both), normals included."""
    data = strands(7, 6, seed=3)
    if fmt == "obj":
        lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in data.nodes[:, :3]]
        start = 1
        for e in data.curve_ends:
            lines.append("l " + " ".join(str(i) for i in range(start, e + 1)))
            start = int(e) + 1
        (tmp_path / "c.obj").write_text("\n".join(lines) + "\n")
        pairs = [(str(tmp_path / "c.obj"),) * 2]
    else:
        a, b = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
        getattr(tcio, f"save_{fmt}")(a, data)
        getattr(jcio, f"save_{fmt}")(b, jcio.CurveData(
            data.curve_ends, data.nodes, data.normals, data.colors))
        pairs = [(a, a), (b, b)]
    for tp, jp in pairs:
        got, want = tcio.load_curves(tp), jcio.load_curves(jp)
        assert np.array_equal(got.curve_ends, want.curve_ends)
        assert np.array_equal(got.nodes, want.nodes)
        assert np.array_equal(got.normals, want.normals)
        if fmt != "obj":
            assert np.array_equal(got.nodes[:, :3], data.nodes[:, :3])


def test_init_normals_equal():
    data = strands(9, 11, seed=5)
    for seed in (0xC0FFEE, 7):
        got = tcio.init_normals(data.curve_ends, data.nodes, seed)
        want = jcio.init_normals(data.curve_ends, data.nodes, seed)
        assert np.array_equal(got, want)


# --------------------------------------------------------------- flatten

def _flatten_case(tmp, case):
    data = strands(10, 7, seed=8, width=0.015)
    name = write_strands(tmp, "c.hair" if case == "taper" else "c.fiber",
                         data)
    prim = {"type": "curves", "file": name, "bsdf_index": 0,
            "transform": {"position": [0.1, -0.2, 0.3], "scale": 1.5,
                          "rotation": [10, 20, 0]}}
    if case in CURVE_MODES:
        prim["mode"] = case
    elif case == "taper":
        prim.update(curve_taper=True, mode="ribbon")
    elif case == "thickness":
        prim.update(curve_thickness=0.05, mode="cylinder")
        del prim["bsdf_index"]          # the default hair row
    elif case == "subsample":
        prim.update(subsample=0.4, mode="bcsdf_cylinder")
    prims = [prim, {"type": "quad", "bsdf_index": 3,
                    "transform": {"position": [0, -0.5, 0], "scale": 0.2}}]
    if case == "instances":
        prims = [{"type": "instances", "bsdf_index": 2,
                  "masters": [dict(prim, mode="half_cylinder"),
                              {"type": "cube",
                               "transform": {"scale": 0.1}}],
                  "instances": [
                      {"id": 0, "transform": {"position": [1, 0, 0],
                                              "rotation": [0, 30, 0]}},
                      {"id": 1, "transform": {"position": [0, 1, 0],
                                              "scale": 2.0}},
                      {"id": 1, "transform": {"position": [-2, 0, 0]}},
                      {"id": 5}]}]
    return desc_of(tmp, copy.deepcopy(FIBERS), prims)


@pytest.mark.parametrize("case", list(CURVE_MODES) + [
    "taper", "thickness", "subsample", "instances"])
def test_curve_tables_equal_jax(tmp_path, case):
    """Every FlatScene field (the crv_*, cbvh_* and hair_* tables and the
    geo bounds among them) and every setting equal to the JAX build;
    the packed rows of the curve walk follow from the JAX-named ones."""
    desc = _flatten_case(str(tmp_path), case)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    assert ts.crv_seg_p0.shape[0] > 0
    _assert_same_scene(ts, jax_fields(js))
    for f in fields(RenderSettings):
        assert getattr(tset, f.name) == getattr(jset, f.name), f.name
    assert tset.has_curves and len(tset.curve_modes) == 1
    # the curve pieces stand inside the occluder bounds, padded by width
    q = torch.cat([ts.crv_pc_q0, ts.crv_pc_q1])
    assert bool((q[:, :3] - q[:, 3:].max() >= ts.geo_lo - 1e-6).all())
    assert bool((q[:, :3] + q[:, 3:].max() <= ts.geo_hi + 1e-6).all())
    if case == "instances":
        assert ts.crv_seg_prim.unique().numel() == 1
        assert ts.tri_v0.shape[0] == 2 * 12        # two cubes
        assert ts.prim_bsdf.tolist() == [0, 2, 2]   # the cubes: the instances' bsdf


# -------------------------------------------------------------- traversal

@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The four-mode scene with a quad and a sphere, both packages' scene
    and one JAX closest-hit bvh_intersect over the seeded rays."""
    tmp = str(tmp_path_factory.mktemp("mixed"))
    prims = mixed_prims(tmp) + [
        {"type": "quad", "bsdf_index": 3,
         "transform": {"position": [-0.6, 0.3, -0.3], "scale": 0.5,
                       "rotation": [-90, 0, 0]}},
        {"type": "sphere", "bsdf_index": 3,
         "transform": {"position": [0.6, 0.4, -0.4], "scale": 0.2}}]
    desc = desc_of(tmp, copy.deepcopy(FIBERS), prims)
    js, _ = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    o, d, t_min = _rays(2048, seed=4)
    t_max = np.full(o.shape[0], 3.0e38, np.float32)
    jres = jis.bvh_intersect(js, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_min), jnp.asarray(t_max))
    jres = {k: np.asarray(v) for k, v in jres.items()}
    return dict(js=js, ts=ts, o=o, d=d, t_min=t_min, t_max=t_max, jres=jres)


def assert_hits_agree(hit, seg, t, u, v, jhit, jseg, jt, ju, jv):
    """The stated traversal tolerances (module docstring)."""
    assert (hit == jhit).mean() >= HIT_SHARE
    both = hit & jhit
    assert both.any()
    assert (seg[both] == jseg[both]).mean() >= HIT_SHARE
    s = both & (seg == jseg)
    np.testing.assert_allclose(t[s], jt[s], rtol=T_RTOL)
    for a, b in ((u[s], ju[s]), (v[s], jv[s])):
        np.testing.assert_allclose(a, b, atol=UV_ATOL)
        assert (np.abs(a - b) <= UV_CLOSE).mean() >= UV_SHARE


def test_bvh_intersect_mixed_scene_matches_jax(mixed):
    """Curves, triangles and a sphere: each winner channel and the hit."""
    m = mixed
    tres = tis.bvh_intersect(m["ts"], _t(m["o"]), _t(m["d"]),
                             _t(m["t_min"]), _t(m["t_max"]))
    tres = {k: v.numpy() for k, v in tres.items()}
    j = m["jres"]
    assert_hits_agree(tres["hit"], tres["crv"], tres["t"], tres["u"],
                      tres["v"], j["hit"], j["crv"], j["t"], j["u"], j["v"])
    for ch in ("tri", "sph", "crv"):
        assert (tres[ch] >= 0).any(), ch
        assert ((tres[ch] >= 0) == (j[ch] >= 0)).mean() >= HIT_SHARE, ch
    # every mode is hit, and the vertical rays meet the strands along x
    mode = m["ts"].crv_seg_mode.numpy()
    hit_modes = set(mode[tres["crv"][tres["crv"] >= 0]].tolist())
    assert hit_modes == {0, 1, 2, 3}
    assert (tres["crv"][:128] >= 0).sum() >= 4
    assert (tres["crv"][m["t_min"] > 0] >= 0).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_curve_walk_matches_jax(mixed, any_hit):
    """curve_walk (the plain walk on CPU tensors) against JAX's
    _curve_traverse as bvh_intersect merged it: where a curve won (crv
    >= 0) its (t, segment, u, v), elsewhere no curve hit under the far
    limit, the best t of the triangles and the sphere where they hit;
    in any hit the hit flag, which is the closest walk's hit set."""
    m = mixed
    o, d, t_min = _t(m["o"]), _t(m["d"]), _t(m["t_min"])
    t_clip = tis.geo_clip(m["ts"], o, d, _t(m["t_max"]))
    front = tis._tri_analytic(m["ts"], o, d, t_min, t_clip, False, False)
    far = torch.where(front["hit"], front["t"], t_clip)
    t, seg, u, v, hit = (x.numpy() for x in tis.curve_walk(
        m["ts"], o, d, t_min, far, any_hit))
    j = m["jres"]
    jhit = j["crv"] >= 0
    if any_hit:
        assert (hit == jhit).mean() >= HIT_SHARE
        assert hit.sum() > 100
    else:
        assert_hits_agree(hit, seg, t, u, v, jhit, j["crv"], j["t"],
                          j["u"], j["v"])
        assert np.array_equal(t[~hit], far.numpy()[~hit])
    # rays whose far limit a triangle or the sphere cut in front of a
    # curve the uncut ray would meet
    full = tis.curve_walk(m["ts"], o, d, t_min, t_clip, any_hit)[4].numpy()
    cut = full & ~hit
    assert cut.sum() >= 4 and not jhit[cut].any()


def test_expand_hit_and_shading_frame_on_curve_hits(mixed):
    """The JAX hits expanded by both packages: point, normals (per mode),
    uv, prim, bsdf, is_curve, the tangent and the tangent frame."""
    m = mixed
    j = m["jres"]
    sel = j["hit"]
    o, d = m["o"][sel], m["d"][sel]
    jres = {k: jnp.asarray(v[sel]) for k, v in j.items()}
    tres = {k: _t(v[sel]) for k, v in j.items()}
    jinfo = jpt._expand_hit(m["js"], jnp.asarray(o), jnp.asarray(d), jres)
    tinfo = tpt._expand_hit(m["ts"], _t(o), _t(d), tres)
    is_crv = tinfo["is_curve"].numpy()
    assert is_crv.sum() > 100 and np.array_equal(
        is_crv, np.asarray(jinfo["is_curve"]))
    for k in ("p", "ng", "ns", "uv", "crv_tangent"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("prim", "bsdf"):
        assert np.array_equal(tinfo[k].numpy(), np.asarray(jinfo[k])), k
    jtan, jbit = jpt.shading_frame(None, jinfo, jinfo["ns"])
    ttan, tbit = tpt.shading_frame(tinfo, tinfo["ns"])
    np.testing.assert_allclose(ttan.numpy(), np.asarray(jtan), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tbit.numpy(), np.asarray(jbit), rtol=1e-5,
                               atol=1e-6)
    # curve lanes: the bitangent is the fiber tangent
    assert np.array_equal(tbit.numpy()[is_crv],
                          tinfo["crv_tangent"].numpy()[is_crv])


def test_scene_of_curves_without_triangles(tmp_path):
    """Curves and a sphere, no triangle: bvh_intersect still walks the
    curves, the body-start sort key is finite over the empty triangle
    BVH, and a render runs."""
    tmp = str(tmp_path)
    desc = desc_of(tmp, copy.deepcopy(FIBERS)[:1], [
        {"type": "curves", "file": write_strands(tmp, "c.fiber", strands(
            20, 8, seed=11, width=0.03)), "mode": "bcsdf_cylinder"},
        {"type": "sphere", "bsdf_index": 0,
         "transform": {"position": [0, 0.4, -0.6], "scale": 0.1}}])
    ts, tset = flatten_scene(desc, device="cpu")
    assert ts.tri_v0.shape[0] == 0 and ts.crv_pc_q0.shape[0] > 0
    o, d, t_min = _rays(256, seed=9)
    res = tis.bvh_intersect(ts, _t(o), _t(d), _t(t_min), 3.0e38)
    assert (res["crv"] >= 0).sum() > 10 and (res["sph"] >= 0).any()
    assert not ((res["crv"] >= 0) & (res["sph"] >= 0)).any()
    occ = tis.bvh_intersect(ts, _t(o), _t(d), _t(t_min), 3.0e38,
                            any_hit=True)["hit"]
    assert torch.equal(occ, res["hit"])
    key = tis.ray_sort_key(ts, _t(o), _t(d), torch.zeros(256, dtype=bool))
    assert key.min() >= 0 and key.max() < 2 ** 31
    from tungsten_tpu_torch.render import render
    img = render(ts, tset, spp=1, device="cpu")
    assert np.isfinite(img).all() and img.shape == (16, 16, 3)


def _packed_walk(crv_rows, cbvh_rows, o, d, t_min, t_max):
    """One ray through the packed rows as csrc/curve_trace.cu reads them
    (a node row: min xyz, first * 8 + count | max xyz, skip; a piece
    row: q0 | q1 | nmid, t0 | t1, seg, mode), in float64: (hit, seg)."""
    nodes = cbvh_rows.view(-1, 2, 4)
    words = cbvh_rows.view(torch.int32).view(-1, 2, 4)
    pieces = crv_rows.view(-1, 4, 4)
    pints = crv_rows.view(torch.int32).view(-1, 4, 4)
    inv = 1.0 / np.where(np.abs(d) < 1e-20, np.where(d >= 0, 1e-20, -1e-20),
                         d)
    best_t, best_seg, node = float(t_max), -1, 0
    while node < nodes.shape[0]:
        lo, hi = nodes[node, 0, :3].double().numpy(), \
            nodes[node, 1, :3].double().numpy()
        meta, skip = int(words[node, 0, 3]), int(words[node, 1, 3])
        ta, tb = (lo - o) * inv, (hi - o) * inv
        near = max(np.minimum(ta, tb).max(), 0.0)
        far = min(np.maximum(ta, tb).min(), best_t)
        box = near <= far * 1.00000024
        count = meta & 7
        if box and count:
            for p in range((meta >> 3), (meta >> 3) + count):
                r = pieces[p].double().numpy()
                seg, mode = int(pints[p, 3, 1]), int(pints[p, 3, 2])
                q = _packed_piece(r, seg, mode, o, d, t_min, best_t)
                if q is not None:
                    best_t, best_seg = q, seg
        node = node + 1 if box and not count else skip
    return best_seg >= 0, best_seg


def _packed_piece(r, seg, mode, o, d, t_min, best_t):
    """The kernel's piece test on one packed row in float64 (the plain
    walk's formulas); the hit t or None."""
    dxz = np.hypot(d[0], d[2])
    lx = np.array([1.0, 0, 0]) if dxz == 0 else \
        np.array([d[2] / dxz, 0.0, -d[0] / dxz])
    ly = np.array([0, 0, -d[1]]) if dxz == 0 else \
        np.array([lx[2] * d[1], dxz, -d[1] * lx[0]])
    frame = np.stack([lx, ly, d])
    e0, e1 = frame @ (r[0, :3] - o), frame @ (r[1, :3] - o)
    w0, w1, pt0, pt1 = r[0, 3], r[1, 3], r[2, 3], r[3, 0]
    if mode != 3:
        v = e1[:2] - e0[:2]
        inv = 1.0 / max(v @ v, 1e-30)
        st = -(e0[:2] @ v) * inv
        dist = abs(e0[0] * v[1] - e0[1] * v[0]) * np.sqrt(inv)
        width = w0 * (1 - st) + w1 * st
        depth = e0[2] * (1 - st) + e1[2] * st
        dz = e1[2] - e0[2]
        t0 = depth - np.sqrt(max((width ** 2 - dist ** 2)
                                 * (1 + dz * dz * inv), 0.0))
        v3 = e0 - e1
        st2 = (np.array([e0[0], e0[1], e0[2] - t0]) @ v3) / max(v3 @ v3,
                                                                1e-30)
        nt = st2 * (pt1 - pt0) + pt0
        ok = dist <= width and st2 >= 0 and t_min < t0 < best_t and \
            0 <= nt <= 1
        return t0 if ok else None
    nm = frame @ r[2, :3]
    v3 = e1 - e0
    inv = 1.0 / max(v3 @ v3, 1e-30)
    nr = v3 * ((v3 @ nm) * inv) - nm
    t0 = (nr @ e0) / (1e-20 if abs(nr[2]) < 1e-20 else nr[2])
    lp = np.array([-e0[0], -e0[1], t0 - e0[2]])
    st = (lp @ v3) * inv
    wr = w0 * (1 - st) + w1 * st
    dv = lp - v3 * st
    nt = st * (pt1 - pt0) + pt0
    ok = t_min <= t0 < best_t and 0 <= st <= 1 and dv @ dv <= wr * wr and \
        0 <= nt <= 1
    return t0 if ok else None


def test_packed_rows_walk_as_the_plain_walk(mixed):
    """The packed node and piece rows, read as the kernel C1 reads them
    (a float64 walk in Python), give the plain walk's hit and segment on
    200 of the seeded rays (the vertical ones among them), all modes."""
    m = mixed
    ts = m["ts"]
    idx = np.r_[0:40, 64:104, 2048 - 120:2048]
    o, d, t_min = m["o"][idx], m["d"][idx], m["t_min"][idx]
    t_clip = tis.geo_clip(ts, _t(o), _t(d), _t(m["t_max"][idx]))
    _, seg, _, _, hit = (x.numpy() for x in tis.curve_walk(
        ts, _t(o), _t(d), _t(t_min), t_clip))
    got = [_packed_walk(ts.crv_rows, ts.cbvh_rows, o[i].astype(np.float64),
                        d[i].astype(np.float64), float(t_min[i]),
                        float(t_clip[i])) for i in range(len(idx))]
    ghit = np.array([g[0] for g in got])
    gseg = np.array([g[1] for g in got])
    assert hit.sum() > 20
    assert (ghit == hit).mean() >= 0.99
    both = ghit & hit
    assert (gseg[both] == seg[both]).mean() >= 0.99
