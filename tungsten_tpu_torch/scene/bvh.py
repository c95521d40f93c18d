"""Host-side BVH build over triangles (numpy, binned SAH).

Replaces the reference's embree BVH build + BvhBuilder
(ref: src/core/bvh/BvhBuilder.cpp:28-61 — exact SAH for small nodes,
binned SAH above) with a vectorized numpy build.  The output is a
flattened node array in depth-first order with both child pointers (for
stack traversal) and skip pointers (for the stackless plain traversal in ops/intersect.py).

Node layout (struct-of-arrays):
  bounds_min / bounds_max : (N, 3) float32
  meta                    : (N, 2) int32
      interior: meta[:,0] = right-child index (left child = node + 1),
                meta[:,1] = 0
      leaf:     meta[:,0] = first primitive, meta[:,1] = count (> 0)
  skip                    : (N,) int32 — next DFS node if subtree skipped
Primitives are permuted so leaf ranges are contiguous (`order`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUM_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class BvhArrays:
    bounds_min: np.ndarray  # (N, 3) f32
    bounds_max: np.ndarray  # (N, 3) f32
    meta: np.ndarray        # (N, 2) i32
    skip: np.ndarray        # (N,) i32
    order: np.ndarray       # (T,) i32 — permutation of input prims

    @property
    def num_nodes(self) -> int:
        return int(self.meta.shape[0])


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray, max_leaf_size: int = 4) -> BvhArrays:
    """Build a binary SAH BVH from per-primitive AABBs.

    Uses the native C++ build (tungsten_tpu_torch/native/bvh_builder.cpp)
    when available — same algorithm and layout, ~50x faster for large
    meshes — with this numpy implementation as the fallback."""
    prim_min = np.asarray(prim_min, dtype=np.float32)
    prim_max = np.asarray(prim_max, dtype=np.float32)
    n = prim_min.shape[0]
    if n > 0:
        from tungsten_tpu_torch import native
        res = native.build_bvh_native(prim_min, prim_max, max_leaf_size)
        if res is not None:
            b_min, b_max, meta, skip, order = res
            return BvhArrays(bounds_min=b_min, bounds_max=b_max,
                             meta=meta, skip=skip, order=order)
    centroids = 0.5 * (prim_min + prim_max)

    b_min, b_max, meta, order_chunks = [], [], [], []
    # Work stack of (index array, parent_slot); parent_slot is the position in
    # `meta` whose right-child pointer must be patched once the left subtree
    # has been emitted (depth-first order).
    if n == 0:
        return BvhArrays(
            bounds_min=np.zeros((1, 3), np.float32),
            bounds_max=np.full((1, 3), -1.0, np.float32),
            meta=np.array([[0, 0]], np.int32),
            skip=np.array([1], np.int32),
            order=np.zeros((0,), np.int32),
        )

    stack = [(np.arange(n), None)]
    emitted = 0
    while stack:
        idx, patch_slot = stack.pop()
        node_id = len(meta)
        if patch_slot is not None:
            meta[patch_slot][0] = node_id
        lo = prim_min[idx].min(axis=0)
        hi = prim_max[idx].max(axis=0)
        b_min.append(lo)
        b_max.append(hi)

        if len(idx) <= max_leaf_size:
            meta.append([emitted, len(idx)])
            order_chunks.append(idx)
            emitted += len(idx)
            continue

        c = centroids[idx]
        c_lo = c.min(axis=0)
        c_hi = c.max(axis=0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] <= 0.0:
            # Degenerate: split in half by index.
            half = len(idx) // 2
            left, right = idx[:half], idx[half:]
        else:
            # Binned SAH along the longest centroid axis.
            scale = NUM_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.minimum(
                ((c[:, axis] - c_lo[axis]) * scale).astype(np.int32), NUM_BINS - 1
            )
            bin_lo = np.full((NUM_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((NUM_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bin_lo, bins, prim_min[idx])
            np.maximum.at(bin_hi, bins, prim_max[idx])
            bin_cnt = np.bincount(bins, minlength=NUM_BINS)
            # Sweep prefix/suffix bounds.
            pre_lo = np.minimum.accumulate(bin_lo, axis=0)
            pre_hi = np.maximum.accumulate(bin_hi, axis=0)
            suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
            pre_cnt = np.cumsum(bin_cnt)
            suf_cnt = bin_cnt.sum() - pre_cnt
            sa_l = _surface_area(pre_lo[:-1], pre_hi[:-1])
            sa_r = _surface_area(suf_lo[1:], suf_hi[1:])
            cost = sa_l * pre_cnt[:-1] + sa_r * suf_cnt[:-1]
            valid = (pre_cnt[:-1] > 0) & (suf_cnt[:-1] > 0)
            if not valid.any():
                half = len(idx) // 2
                left, right = idx[:half], idx[half:]
            else:
                cost = np.where(valid, cost, np.inf)
                split = int(np.argmin(cost))
                mask = bins <= split
                left, right = idx[mask], idx[~mask]

        meta.append([-1, 0])  # right child patched later
        # DFS order: left subtree first -> push right, then left.
        stack.append((right, node_id))
        stack.append((left, None))

    bounds_min = np.asarray(b_min, np.float32)
    bounds_max = np.asarray(b_max, np.float32)
    meta_arr = np.asarray(meta, np.int32)
    order = np.concatenate(order_chunks).astype(np.int32)

    # Skip pointers: node i's skip = the next DFS node that is not in i's
    # subtree.  Computed by a DFS with an explicit "after" value.
    num = meta_arr.shape[0]
    skip = np.zeros(num, np.int32)
    walk = [(0, num)]
    while walk:
        node, after = walk.pop()
        skip[node] = after
        if meta_arr[node, 1] == 0:  # interior
            right = meta_arr[node, 0]
            walk.append((node + 1, right))  # left subtree ends where right begins
            walk.append((right, after))

    return BvhArrays(bounds_min=bounds_min, bounds_max=bounds_max,
                     meta=meta_arr, skip=skip, order=order)


WIDE = 4  # children a node of the wide BVH (collapse_wide)


def collapse_wide(meta: np.ndarray, bounds_min: np.ndarray,
                  bounds_max: np.ndarray):
    """Collapse a binary BVH of this module's layout into a WIDE-ary one,
    level by level in numpy: a wide node takes its binary node's two
    children and then, twice, opens the interior child of largest
    surface area in place (its left and right child take its slot), so
    its children stay in depth-first order and a leaf keeps its
    contiguous primitive range.  The root's wide node is the binary
    root's (a binary root that is a leaf becomes the wide root's one
    child; an empty BVH, one interior node without children, a wide root
    without children).

    Returns (child, wide, stack): child (M, WIDE) int64, the binary node
    in each child slot of each wide node (-1: empty slot); wide (M,
    WIDE) int64, the wide node of an interior child (-1 for a leaf or an
    empty slot); stack, the most entries a walk can hold that pushes
    every child of a node it visits and pops one at a time."""
    meta = np.asarray(meta)
    n = meta.shape[0]
    leaf = meta[:, 1] > 0
    interior = ~leaf & (np.arange(n) + 1 < n)
    left = np.arange(n, dtype=np.int64) + 1
    right = meta[:, 0].astype(np.int64)
    ext = np.maximum(np.asarray(bounds_max, np.float64)
                     - np.asarray(bounds_min, np.float64), 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]
    slot = np.arange(WIDE)[None]
    if n == 0 or not interior[0]:
        child = np.full((1, WIDE), -1, np.int64)
        if n and leaf[0]:
            child[0, 0] = 0
        return child, np.full((1, WIDE), -1, np.int64), int(child[0, 0] == 0)
    children, wides = [], []
    front = np.zeros(1, np.int64)          # binary nodes of this level
    acc = np.zeros(1, np.int64)            # stack entries above them
    base, stack = 1, 0
    while front.size:
        m = front.size
        c = np.full((m, WIDE), -1, np.int64)
        c[:, 0], c[:, 1] = left[front], right[front]
        for k in range(2, WIDE):
            valid = c[:, :k] >= 0
            score = np.where(valid & interior[np.maximum(c[:, :k], 0)],
                             area[np.maximum(c[:, :k], 0)], -np.inf)
            j = np.argmax(score, axis=1)
            rows = np.nonzero(np.isfinite(score[np.arange(m), j]))[0]
            if not rows.size:
                break
            j, cj = j[rows, None], c[rows, j[rows]][:, None]
            opened = np.take_along_axis(
                c[rows], np.clip(np.where(slot <= j, slot, slot - 1), 0,
                                 WIDE - 1), axis=1)
            opened = np.where(slot == j, left[cj], opened)
            opened = np.where(slot == j + 1, right[cj], opened)
            c[rows] = np.where(slot <= k, opened, -1)
        inner = (c >= 0) & interior[np.maximum(c, 0)]
        w = np.full((m, WIDE), -1, np.int64)
        w[inner] = base + np.arange(int(inner.sum()))
        n_in = inner.sum(axis=1)
        n_c = (c >= 0).sum(axis=1)
        stack = max(stack, int((acc + n_c).max()))
        children.append(c)
        wides.append(w)
        # a child popped first has its siblings below it
        acc = np.repeat(acc + n_c - 1, n_in)
        front = c[inner]
        base += front.size
    return np.concatenate(children), np.concatenate(wides), stack


def subtree_end(meta: np.ndarray) -> np.ndarray:
    """(N,) int64: one past the last primitive under each node of a
    binary BVH of this module's layout (primitives lie in depth-first
    order, so a subtree ends where its rightmost leaf does; 0 for an
    interior node of an empty BVH).  Pointer jumping down the right
    spines: a few passes over the nodes, not one a level."""
    meta = np.asarray(meta).astype(np.int64)
    n = meta.shape[0]
    leaf = meta[:, 1] > 0
    idx = np.arange(n, dtype=np.int64)
    nxt = np.where(leaf | (meta[:, 0] <= idx) | (meta[:, 0] >= n), idx,
                   meta[:, 0])
    while True:
        jump = nxt[nxt]
        if np.array_equal(jump, nxt):
            break
        nxt = jump
    return np.where(leaf[nxt], meta[nxt, 0] + meta[nxt, 1], 0)


def sah_cost(bvh: BvhArrays) -> float:
    """SAH quality metric (for tests/diagnostics)."""
    root_sa = _surface_area(bvh.bounds_min[0], bvh.bounds_max[0])
    sa = _surface_area(bvh.bounds_min, bvh.bounds_max) / max(root_sa, 1e-30)
    leaf = bvh.meta[:, 1] > 0
    return float(
        TRAVERSAL_COST * sa[~leaf].sum()
        + INTERSECT_COST * (sa[leaf] * bvh.meta[leaf, 1]).sum()
    )
