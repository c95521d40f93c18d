"""A curve scene whose piece BVH is deep: the test cases of the curve
walk's stack restarts, shared by tests/test_torch_curves.py (the CPU
walks) and tests/test_torch_cuda.py (the kernel C1).  Imports neither
JAX nor the JAX package.

`deep_curve_scene` flattens STRANDS short strands along x stacked along
y in one column and then replaces the piece BVH with a caterpillar over
the pieces in their index order (one piece a leaf; every interior node's
left child is the rest of the tree, its right child the next leaf), so
the tree is as deep as there are pieces.  A ray up the column crosses
every strand and meets the box of a piece or two of each, all of which
a closest-hit walk pushes before it tests the first: about 100 stack
entries, past the kernel's STACK.  The plain walk (binary, stackless)
walks the same caterpillar.
"""
from __future__ import annotations

import numpy as np
import torch

STRANDS = 96     # strands of 3 nodes: one segment, 8 pieces each
SPACING = 0.05   # between strands along y


def caterpillar_bvh(lo: np.ndarray, hi: np.ndarray):
    """A binary BVH in scene/bvh.py's layout over primitives 0..L-1 in
    index order, one a leaf: node 0 is T(L), T(j) has left child T(j-1)
    and right child leaf j-1, T(1) is leaf 0.  Returns (meta, bounds_min,
    bounds_max, skip) in build_bvh's dtypes."""
    L = lo.shape[0]
    n = 2 * L - 1
    meta = np.zeros((n, 2), np.int32)
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    skip = np.zeros(n, np.int32)
    cmin = np.minimum.accumulate(lo, axis=0)
    cmax = np.maximum.accumulate(hi, axis=0)
    for j in range(L, 1, -1):          # T(j) at L - j, leaves 0..j-1
        i = L - j
        meta[i] = (L + j - 2, 0)
        bmin[i], bmax[i] = cmin[j - 1], cmax[j - 1]
        skip[i] = L + j - 1
    for k in range(L):                  # leaf k at L - 1 + k
        i = L - 1 + k
        meta[i] = (k, 1)
        bmin[i], bmax[i] = lo[k], hi[k]
        skip[i] = L + k
    return meta, bmin, bmax, skip


def piece_boxes(scene):
    """Each curve piece's box as scene/flatten.py::_build_curve_tables
    bounds it (chord box, width and the segment's curvature bulge)."""
    from tungsten_tpu_torch.scene.flatten import CURVE_SUBDIV
    q0, q1 = scene.crv_pc_q0.cpu().numpy(), scene.crv_pc_q1.cpu().numpy()
    p0, p1, p2 = (getattr(scene, f"crv_seg_p{i}").cpu().numpy()
                  for i in range(3))
    a = 0.5 * p0 - p1 + 0.5 * p2
    bulge = np.linalg.norm(a[:, :3], axis=-1) / (
        4.0 * CURVE_SUBDIV * CURVE_SUBDIV)
    pad = (np.maximum(q0[:, 3], q1[:, 3])
           + bulge[scene.crv_pc_seg.cpu().numpy()]).astype(
        np.float32)[:, None]
    return (np.minimum(q0[:, :3], q1[:, :3]) - pad,
            np.maximum(q0[:, :3], q1[:, :3]) + pad)


def deep_curve_scene(tmp_path, device):
    """The stacked-strand scene with its caterpillar piece BVH, as a
    FlatScene on `device` (module docstring)."""
    from tungsten_tpu_torch.io import curves
    from tungsten_tpu_torch.scene.flatten import (flatten_scene,
                                                  wide_curve_rows)
    from tungsten_tpu_torch.scene.parse import SceneDesc
    r = np.random.default_rng(41)
    base = np.stack([np.full(STRANDS, -0.1), SPACING * np.arange(STRANDS),
                     r.uniform(-0.004, 0.004, STRANDS)], 1)
    pts = base[:, None] + np.arange(3)[None, :, None] * [0.1, 0.0, 0.0]
    pts[:, 1, 1:] += r.uniform(-0.003, 0.003, (STRANDS, 2))
    nodes = np.concatenate([pts, np.full((STRANDS, 3, 1), 0.01)],
                           -1).reshape(-1, 4).astype(np.float32)
    ends = (np.arange(1, STRANDS + 1) * 3).astype(np.uint32)
    curves.save_fiber(str(tmp_path / "column.fiber"), curves.CurveData(
        ends, nodes, curves.init_normals(ends, nodes)))
    desc = SceneDesc(
        path=str(tmp_path / "scene.json"), json={},
        bsdfs=[{"type": "lambertian_fiber", "albedo": 0.5}],
        primitives=[{"type": "curves", "file": "column.fiber",
                     "mode": "half_cylinder", "bsdf_index": 0}],
        media=[],
        camera={"type": "pinhole", "resolution": [8, 8],
                "transform": {"position": [0, 2.4, -3],
                              "look_at": [0, 2.4, 0]}},
        integrator={"max_bounces": 2}, renderer={"spp": 1})
    scene, _ = flatten_scene(desc, device="cpu")
    meta, bmin, bmax, skip = caterpillar_bvh(*piece_boxes(scene))
    rows = wide_curve_rows(meta, bmin, bmax)
    scene = scene.replace(
        cbvh_meta=torch.from_numpy(meta), cbvh_min=torch.from_numpy(bmin),
        cbvh_max=torch.from_numpy(bmax), cbvh_skip=torch.from_numpy(skip),
        cwbvh_rows=torch.from_numpy(rows))
    return scene.to(device)


def column_rays(R: int, seed: int):
    """Seeded rays at the column: half up it from below, nearly straight
    (each crosses every strand), the rest up it at a slant and, every
    fourth, across it along z; a third with t_min 0.3.  numpy f32 (o, d,
    t_min)."""
    r = np.random.default_rng(seed)
    top = SPACING * STRANDS
    o = np.stack([r.uniform(-0.09, 0.09, R), np.full(R, -0.5),
                  r.uniform(-0.012, 0.012, R)], 1)
    tgt = o + np.stack([r.uniform(-0.02, 0.02, R), np.full(R, top + 0.5),
                        r.uniform(-0.005, 0.005, R)], 1)
    h = R // 2
    tgt[h:] = np.stack([r.uniform(-0.1, 0.1, R - h),
                        r.uniform(0.0, top, R - h),
                        r.uniform(-0.01, 0.01, R - h)], 1)
    side = np.arange(R) % 4 == 3
    o[side] = np.stack([r.uniform(-0.09, 0.09, side.sum()),
                        r.uniform(0.0, top, side.sum()),
                        np.full(side.sum(), -1.0)], 1)
    tgt[side] = o[side] + [0.0, 0.0, 1.0]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(np.arange(R) % 3 == 2, 0.3, 0.0)
    return o.astype(np.float32), d.astype(np.float32), \
        t_min.astype(np.float32)
