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
    prims = mixed_prims(tmp)
    prims = prims + [
        # coincident strands: the half-cylinder prim again, last
        dict(prims[1]),
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


def _packed_walk(crv_rows, cwbvh_rows, o, d, t_min, t_max, cap=None,
                 short=8):
    """One ray's closest hit through the packed rows as csrc/curve_trace.cu
    walks them, in float64: a node row holds its four children's boxes
    [min xyz, word | max xyz, end] (word: first * 8 + count for a leaf,
    node * 8 for an interior child, 0 empty; end: one past the child's
    last piece), a piece row q0 | q1 | nmid, t0 | t1, seg, mode.  A visit
    slab-tests the children against the best t and pushes those hit,
    leaves too, so that they pop in slot (depth-first) order; a popped
    entry is tested again against the best t as it stands, then a leaf's
    pieces are tested keeping the least (t, piece index) and a node is
    visited.  With `cap`, the stack holds at most cap entries as the
    kernel's does: the first push onto a full stack abandons the walk,
    which starts again at the root keeping pos, one past the last piece
    of what it has finished since; from then on a push onto a full stack
    drops its deepest cap - short entries, and when the stack runs empty
    the walk starts again at the root, not pushing a child whose pieces
    all lie below pos.  Returns (hit, seg, piece, t, the most stack
    entries held, restarts)."""
    nodes = cwbvh_rows.double().numpy().reshape(-1, 4, 8)
    ints = cwbvh_rows.view(torch.int32).numpy().reshape(-1, 4, 8)
    words, ends = ints[..., 3], ints[..., 7]
    pieces = crv_rows.view(-1, 4, 4)
    pints = crv_rows.view(torch.int32).view(-1, 4, 4)
    inv = 1.0 / np.where(np.abs(d) < 1e-20, np.where(d >= 0, 1e-20, -1e-20),
                         d)
    best_t, best_seg, best_piece = float(t_max), -1, -1
    stack, deepest, node = [], 0, 0
    pos, track, again, restarts = 0, False, False, 0
    while True:
        if node is not None:
            ta = (nodes[node, :, 0:3] - o) * inv
            tb = (nodes[node, :, 4:7] - o) * inv
            near = np.maximum(np.minimum(ta, tb).max(1), 0.0)
            far = np.minimum(np.maximum(ta, tb).min(1), best_t)
            kids = [(near[c], int(words[node, c]), int(ends[node, c]))
                    for c in (3, 2, 1, 0)
                    if words[node, c] > 0
                    and near[c] <= far[c] * 1.00000024
                    and (not track or ends[node, c] > pos)]
            if track and not kids:
                pos = int(ends[node].max())
            node = None
            for k in kids:
                if cap is not None and len(stack) == cap:
                    if not track:     # walk again, from the root
                        stack, track, node = [], True, 0
                        restarts += 1
                        break
                    del stack[:cap - short]
                    again = True
                stack.append(k)
            deepest = max(deepest, len(stack))
            if node is not None:
                continue
        if not stack:
            if not again:
                break
            again, node, restarts = False, 0, restarts + 1
            continue
        tn, w, end = stack.pop()
        if tn > best_t * 1.00000024:
            pos = end if track else pos
            continue
        if not w & 7:
            node = w >> 3
            continue
        for p in range(w >> 3, (w >> 3) + (w & 7)):
            seg, mode = int(pints[p, 3, 1]), int(pints[p, 3, 2])
            t = _packed_piece(pieces[p].double().numpy(), mode, o, d, t_min)
            if t is not None and (t < best_t or (t == best_t
                                                 and p < best_piece)):
                best_t, best_seg, best_piece = t, seg, p
        pos = end if track else pos
    return best_piece >= 0, best_seg, best_piece, best_t, deepest, restarts


def _packed_piece(r, mode, o, d, t_min):
    """The kernel's piece test on one packed row in float64 (the plain
    walk's formulas) but for the best-t compare: the hit t or None."""
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
        ok = dist <= width and st2 >= 0 and t_min < t0 and 0 <= nt <= 1
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
    ok = t_min <= t0 and 0 <= st <= 1 and dv @ dv <= wr * wr and \
        0 <= nt <= 1
    return t0 if ok else None


@pytest.fixture(scope="module")
def packed(mixed):
    """The packed-row walk (_packed_walk, the kernel's stack) on 200 of
    the mixed scene's seeded rays (the vertical ones among them), with
    their far limits clipped at the geometry box: (idx, o, d, t_min,
    t_clip, results)."""
    m = mixed
    ts = m["ts"]
    idx = np.r_[0:40, 64:104, 2048 - 120:2048]
    o, d, t_min = m["o"][idx], m["d"][idx], m["t_min"][idx]
    t_clip = tis.geo_clip(ts, _t(o), _t(d), _t(m["t_max"][idx]))
    got = [_packed_walk(ts.crv_rows, ts.cwbvh_rows, o[i].astype(np.float64),
                        d[i].astype(np.float64), float(t_min[i]),
                        float(t_clip[i]), cap=64) for i in range(len(idx))]
    return idx, o, d, t_min, t_clip, got


def test_packed_rows_walk_as_the_plain_walk(mixed, packed):
    """The packed wide node rows and piece rows, walked as the kernel C1
    walks a closest hit (a stack popped in depth-first order, each entry
    tested again when popped, the least (t, piece index); a float64 walk
    in Python), give the plain walk's hit and segment on 200 of the
    seeded rays (the vertical ones among them), all modes, and never hold
    more stack entries than the packing allows for."""
    from tungsten_tpu_torch.scene.bvh import collapse_wide
    ts = mixed["ts"]
    idx, o, d, t_min, t_clip, got = packed
    _, seg, _, _, hit = (x.numpy() for x in tis.curve_walk(
        ts, _t(o), _t(d), _t(t_min), t_clip))
    ghit = np.array([g[0] for g in got])
    gseg = np.array([g[1] for g in got])
    assert hit.sum() > 20
    assert (ghit == hit).mean() >= 0.99
    both = ghit & hit
    assert (gseg[both] == seg[both]).mean() >= 0.99
    stack = collapse_wide(ts.cbvh_meta.numpy(), ts.cbvh_min.numpy(),
                          ts.cbvh_max.numpy())[2]
    assert 0 < max(g[4] for g in got) <= stack


def _soup_scene(tmp):
    """Vertical strands (no jitter along x and z), half of them with every
    node three times (three equal nodes make a segment of zero-length
    pieces), in two modes: the port's scene."""
    r = np.random.default_rng(31)
    prims = []
    for i, mode in enumerate(("half_cylinder", "ribbon")):
        n, k = 16, 9
        base = np.stack([r.uniform(-0.5, 0.5, n), np.zeros(n),
                         r.uniform(-0.5, 0.5, n)], 1)
        pts = base[:, None] + np.arange(k)[None, :, None] * [0.0, 0.1, 0.0]
        pts[: n // 2] = np.repeat(pts[: n // 2, ::3], 3, axis=1)
        nodes = np.concatenate([pts, np.full((n, k, 1), 0.01)],
                               -1).reshape(-1, 4).astype(np.float32)
        ends = (np.arange(1, n + 1) * k).astype(np.uint32)
        data = tcio.CurveData(ends, nodes, tcio.init_normals(ends, nodes))
        prims.append({"type": "curves", "mode": mode, "bsdf_index": 0,
                      "file": write_strands(tmp, f"soup{i}.fiber", data)})
    return flatten_scene(desc_of(tmp, copy.deepcopy(FIBERS), prims),
                         device="cpu")[0]


@pytest.mark.parametrize("case", ["mixed", "soup"])
def test_wide_rows_cover_every_piece_once(request, tmp_path, case):
    """From the wide root every piece is reachable exactly once, through
    the leaf words of the packed rows, every child's end word is one past
    the last piece below it, and every child box holds the boxes
    of all pieces below it (the build's own piece boxes: chord box, width
    and curvature bulge; exact, as the boxes are the binary BVH's); on the
    mixed scene and on a soup of zero-length and vertical pieces."""
    from tungsten_tpu_torch.scene.flatten import CURVE_SUBDIV
    ts = request.getfixturevalue("mixed")["ts"] if case == "mixed" else \
        _soup_scene(str(tmp_path))
    rows = ts.cwbvh_rows.numpy().reshape(-1, 4, 8)
    ints = ts.cwbvh_rows.view(torch.int32).numpy().reshape(-1, 4, 8)
    words, ends = ints[..., 3], ints[..., 7]
    q0, q1 = ts.crv_pc_q0.numpy(), ts.crv_pc_q1.numpy()
    p0, p1, p2 = (getattr(ts, f"crv_seg_p{i}").numpy() for i in range(3))
    a = 0.5 * p0 - p1 + 0.5 * p2
    bulge = np.linalg.norm(a[:, :3], axis=-1) / (
        4.0 * CURVE_SUBDIV * CURVE_SUBDIV)
    pad = (np.maximum(q0[:, 3], q1[:, 3])
           + bulge[ts.crv_pc_seg.numpy()]).astype(np.float32)[:, None]
    lo = np.minimum(q0[:, :3], q1[:, :3]) - pad
    hi = np.maximum(q0[:, :3], q1[:, :3]) + pad
    if case == "soup":
        chord = np.linalg.norm(q1[:, :3] - q0[:, :3], axis=1)
        assert (chord == 0).sum() >= 2 * 8 * 3 * 8
        assert (q0[:, [0, 2]] == q1[:, [0, 2]]).all(1).sum() > 100

    def below(node):
        """The pieces under a wide node, checking its children's boxes."""
        out = []
        for c in range(4):
            w = int(words[node, c])
            if w == 0:
                continue
            ps = list(range(w >> 3, (w >> 3) + (w & 7))) if w & 7 else \
                below(w >> 3)
            assert ps and ends[node, c] == max(ps) + 1
            assert (rows[node, c, 0:3] <= lo[ps].min(0)).all()
            assert (rows[node, c, 4:7] >= hi[ps].max(0)).all()
            out += ps
        return out
    seen = np.bincount(below(0), minlength=q0.shape[0])
    assert seen.shape[0] == q0.shape[0] > 0 and (seen == 1).all()


def test_coincident_strands_tie_to_the_lower_piece(mixed):
    """The mixed scene holds the half-cylinder strands twice, in two prims
    with equal rows: a ray that meets them meets two pieces at the same t.
    The packed-row walk keeps the lower piece index of the two, as the
    serial walk does, and so the segment of JAX's merged _curve_traverse
    result on every such ray."""
    m = mixed
    ts = m["ts"]
    jcrv = m["jres"]["crv"]
    seg_prim = ts.crv_seg_prim.numpy()
    # prim 1: the half-cylinder strands; prim 4: their copy
    on_twin = np.nonzero((jcrv >= 0) & np.isin(
        seg_prim[np.maximum(jcrv, 0)], (1, 4)))[0]
    assert on_twin.size >= 20
    key = ts.crv_rows.numpy()[:, np.r_[0:13, 14]]    # all but the segment
    o, d, t_min = m["o"], m["d"], m["t_min"]
    t_clip = tis.geo_clip(ts, _t(o), _t(d), _t(m["t_max"])).numpy()
    for i in on_twin[:60]:
        hit, seg, piece = _packed_walk(
            ts.crv_rows, ts.cwbvh_rows, o[i].astype(np.float64),
            d[i].astype(np.float64), float(t_min[i]), float(t_clip[i]),
            cap=64)[:3]
        assert hit and seg == jcrv[i], i
        same = np.nonzero((key == key[piece]).all(1))[0]
        assert same.size == 2 and piece == same.min(), i


def test_deep_tree_walks_past_its_stack(tmp_path):
    """A piece BVH as deep as its pieces (tests/torch_curve_cases.py: a
    caterpillar over 192 pieces stacked in one column) packs, though its
    walk could hold 192 stack entries, far past the kernel's STACK; the
    packed-row walk with the kernel's stack (STACK entries, then it drops
    and restarts) and with 2 * SHORT gives the hit, segment, piece and t
    of the walk with an unbounded stack on every ray, restarting on the
    rays up the column, and the plain walk's hit and segment."""
    from torch_curve_cases import column_rays, deep_curve_scene
    from tungsten_tpu_torch.ops.curve_trace import SHORT, STACK
    from tungsten_tpu_torch.scene.bvh import collapse_wide
    ts = deep_curve_scene(tmp_path, "cpu")
    assert collapse_wide(ts.cbvh_meta.numpy(), ts.cbvh_min.numpy(),
                         ts.cbvh_max.numpy())[2] > STACK
    o, d, t_min = column_rays(48, 5)
    t_max = np.full(48, 3.0e38, np.float32)
    _, seg, _, _, hit = (x.numpy() for x in tis.curve_walk(
        ts, _t(o), _t(d), _t(t_min), _t(t_max)))
    deepest, restarts, ghit, gseg = [], [], [], []
    for i in range(48):
        args = (ts.crv_rows, ts.cwbvh_rows, o[i].astype(np.float64),
                d[i].astype(np.float64), float(t_min[i]), float(t_max[i]))
        free = _packed_walk(*args)
        for cap in (STACK, 2 * SHORT):
            got = _packed_walk(*args, cap=cap, short=SHORT)
            assert got[:4] == free[:4], (i, cap)
            assert got[4] <= cap
            if cap == STACK:
                restarts.append(got[5])
        deepest.append(free[4])
        ghit.append(free[0])
        gseg.append(free[1])
    assert max(deepest) > STACK and sum(r > 0 for r in restarts) >= 5
    ghit, gseg = np.array(ghit), np.array(gseg)
    assert hit.sum() >= 10 and np.array_equal(ghit, hit)
    assert np.array_equal(gseg[hit], seg[hit])


def test_accepted_hits_can_lie_outside_their_box(mixed, packed):
    """Why C1's closest hit keeps the serial depth-first order and does not
    pop nearest first: the cylinder test accepts a hit outside the box
    that bounds its piece (it extends the chord past the piece's far end
    up to the segment's, and its t is the cylinder's), so which hits a
    walk meets depends on what its best t has culled before it gets
    there, and another order may cull the box of the serial walk's
    winner.  Among the packed-row walk's winners on 200 of the mixed
    scene's rays are hits whose t lies outside the slab interval of their
    leaf's box in the wide rows."""
    ts = mixed["ts"]
    idx, o, d, t_min, t_clip, got = packed
    ints = ts.cwbvh_rows.view(torch.int32).numpy().reshape(-1, 4, 8)
    boxes = ts.cwbvh_rows.double().numpy().reshape(-1, 4, 8)
    leaf = {}
    for n, c in zip(*np.nonzero(ints[..., 3] & 7)):
        w = int(ints[n, c, 3])
        for p in range(w >> 3, (w >> 3) + (w & 7)):
            leaf[p] = (n, c)
    outside = 0
    for i, g in enumerate(got):
        if not g[0]:
            continue
        n, c = leaf[g[2]]
        oi, di = o[i].astype(np.float64), d[i].astype(np.float64)
        inv = 1.0 / np.where(np.abs(di) < 1e-20,
                             np.where(di >= 0, 1e-20, -1e-20), di)
        ta = (boxes[n, c, 0:3] - oi) * inv
        tb = (boxes[n, c, 4:7] - oi) * inv
        near, far = np.minimum(ta, tb).max(), np.maximum(ta, tb).min()
        outside += not (near * (1 - 1e-6) <= g[3] <= far * (1 + 1e-6))
    assert outside >= 1
