"""Ray-scene intersection over SoA ray batches (port of
tungsten_tpu/ops/intersect.py).

Two traversals compute the same hits:
  * CPU tensors: `bvh_walk`, the stackless skip-pointer BVH walk — each
    ray keeps a node cursor; a box hit advances depth-first (cursor+1),
    a miss jumps `skip[cursor]`.  It is the JAX package's CPU traversal
    (`_tri_sph_intersect` with USE_PALLAS off), step for step, and the
    plain version of the CUDA wave kernels.
  * CUDA tensors: `_wave_dispatch` sorts the rays by `ray_sort_key`,
    pads them to 1024 and launches the wave kernel
    (ops/wave_trace.py) — the resident walk, or the paged walk for a
    scene whose attribute table is >= 13 MiB (`traversal_kind`) — then
    un-permutes the results.
The choice follows the device of the tensors; there is no switch and
no fallback.  Analytic spheres, disks and cylinders are tested densely
first (`_analytic_prims`), and the triangle traversal must beat them;
then the curve pieces are walked (`curve_walk`: on the CPU the plain
`curve_walk_plain`, the JAX package's `_curve_traverse` step for step;
on CUDA the hand-written kernel of ops/curve_trace.py) with the best t
so far as the far limit, and a curve hit wins over all of them.
A hit is the dict (t, tri, sph, dsk, cyl, crv, u, v, hit); a channel is
-1 where that primitive type did not win; for a curve hit u is the
spline parameter and v the azimuthal coordinate.
"""
from __future__ import annotations

import torch

INF = 3.0e38
MAX_LEAF = 4      # must match bvh.build_bvh max_leaf_size
WALK_UNROLL = 8   # walk steps between checks for finished rays


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def ray_tri(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore.  All args broadcast; returns (hit, t, u, v)."""
    pvec = _cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    big = torch.abs(det) > 1e-16
    inv_det = torch.where(big, 1.0 / det, 0.0)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = _cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & \
        (t > t_min) & (t < t_max)
    return hit, t, u, v


def ray_box(o, inv_d, lo, hi, t_max):
    """Slab test; returns (hit, t_near)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t_near = torch.clamp(torch.amax(tn, dim=-1), min=0.0)
    t_far = torch.minimum(torch.amin(tf, dim=-1), t_max)
    return t_near <= t_far * 1.00000024, t_near


def _safe_d(d):
    """d with components of magnitude < 1e-20 pushed out to +-1e-20."""
    return torch.where(torch.abs(d) < 1e-20,
                       torch.where(d >= 0, 1e-20, -1e-20), d)


def ray_sphere(o, d, center, radius, t_min, t_max):
    """Analytic sphere; returns (hit, t) for the nearest valid root."""
    oc = o - center
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where((t0 > t_min) & (t0 < t_max), t0, t1)
    return ok & (t > t_min) & (t < t_max), t


def _argmin_winner(ts, best_t):
    """(k, got): per ray the argmin column of ts (R, N) and whether it
    beats best_t."""
    k = torch.argmin(ts, dim=1)
    tk = torch.gather(ts, 1, k[:, None])[:, 0]
    return k.to(torch.int32), tk, tk < best_t


def _analytic_prims(scene, o, d, t_min, t_max, neg=None):
    """Dense tests against every analytic primitive (spheres, disks,
    cylinders — counts are tiny).  Returns (best_t, sph, dsk, cyl)
    winner channels, each -1 where that type did not win; best_t is the
    far limit the triangle traversal then gets.  `neg`: an (R,) int32
    tensor of -1 to start the channels from (read, never written)."""
    R = o.shape[0]
    best_t = t_max
    if neg is None:
        neg = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    best_sph, best_dsk, best_cyl = neg, neg, neg

    if scene.sph_radius.shape[0] > 0:
        hs, ts = ray_sphere(o[:, None, :], d[:, None, :],
                            scene.sph_center[None, :, :],
                            scene.sph_radius[None, :], t_min[:, None],
                            best_t[:, None])
        k, tk, got = _argmin_winner(torch.where(hs, ts, INF), best_t)
        best_t = torch.where(got, tk, best_t)
        best_sph = torch.where(got, k, best_sph)

    dsk_r = getattr(scene, "dsk_r", None)
    if dsk_r is not None and dsk_r.shape[0] > 0:
        # world-space plane test (ref Disk.cpp:64-87)
        nd = torch.sum(d[:, None, :] * scene.dsk_n[None], -1)       # (R, D)
        nd = torch.where(torch.abs(nd) < 1e-12,
                         torch.where(nd >= 0, 1e-12, -1e-12), nd)
        tp = torch.sum((scene.dsk_c[None] - o[:, None, :])
                       * scene.dsk_n[None], -1) / nd
        q = o[:, None, :] + tp[..., None] * d[:, None, :]
        vq = q - scene.dsk_c[None]
        r_sq = torch.sum(vq * vq, -1)
        ok = (tp > t_min[:, None]) & (tp < best_t[:, None]) & \
            (r_sq <= (scene.dsk_r * scene.dsk_r)[None])
        k, tk, got = _argmin_winner(torch.where(ok, tp, INF), best_t)
        best_t = torch.where(got, tk, best_t)
        best_dsk = torch.where(got, k, best_dsk)
        best_sph = torch.where(got, -1, best_sph)

    cyl_r = getattr(scene, "cyl_r", None)
    if cyl_r is not None and cyl_r.shape[0] > 0:
        # local-space caps + quadric side (ref Cylinder.cpp:56-109);
        # pLocal = rot^T (o - pos), xz scaled by 1/r -> unit circle
        # elementwise products summed over i (not einsum: a BLAS batched
        # product may round differently from run to run)
        rel = o[:, None, :] - scene.cyl_pos[None]                # (R, Y, 3)
        rot = scene.cyl_rot[None]                                 # (1, Y, 3, 3)
        pl = torch.sum(rel[..., :, None] * rot, dim=-2)
        dl = torch.sum(d[:, None, :, None] * rot, dim=-2)
        inv_r = 1.0 / torch.clamp(scene.cyl_r, min=1e-20)[None]   # (1, Y)
        px, py, pz = pl[..., 0] * inv_r, pl[..., 1], pl[..., 2] * inv_r
        dx, dy, dz = dl[..., 0] * inv_r, dl[..., 1], dl[..., 2] * inv_r
        hh = scene.cyl_hh[None]
        tbest = torch.broadcast_to(best_t[:, None], px.shape)
        found = torch.zeros(px.shape, dtype=torch.bool, device=o.device)
        dy_s = torch.where(torch.abs(dy) < 1e-6,
                           torch.where(dy >= 0, 1e-6, -1e-6), dy)
        for sign in (1.0, -1.0):
            tc = (sign * hh - py) / dy_s
            cx = px + tc * dx
            cz = pz + tc * dz
            okc = scene.cyl_capped[None] & (torch.abs(dy) > 1e-6) & \
                (tc > t_min[:, None]) & (tc < tbest) & \
                (cx * cx + cz * cz < 1.0)
            tbest = torch.where(okc, tc, tbest)
            found = found | okc
        # side quadric in the scaled xz plane
        A = dx * dx + dz * dz
        B = px * dx + pz * dz
        C = px * px + pz * pz - 1.0
        det_sq = B * B - A * C
        det = torch.sqrt(torch.clamp(det_sq, min=0.0))
        A_s = torch.clamp(A, min=1e-20)
        for sign in (1.0, -1.0):
            tq = (-B - sign * det) / A_s
            h = py + dy * tq
            okq = (det_sq >= 0.0) & (tq > t_min[:, None]) & (tq < tbest) \
                & (h >= -hh) & (h <= hh)
            tbest = torch.where(okq, tq, tbest)
            found = found | okq
        k, tk, got = _argmin_winner(torch.where(found, tbest, INF), best_t)
        best_t = torch.where(got, tk, best_t)
        best_cyl = torch.where(got, k, best_cyl)
        best_sph = torch.where(got, -1, best_sph)
        best_dsk = torch.where(got, -1, best_dsk)

    return best_t, best_sph, best_dsk, best_cyl


def bvh_walk(scene, o, d, t_min, t_max, any_hit: bool = False):
    """Skip-pointer BVH walk over the FlatScene triangles — the plain
    version of the wave kernels.  Returns (t, tri, u, v); t = t_max and
    tri = -1 on a miss.  A step tests the leaf's triangles only for the
    rays that reached one, and finished rays leave the working set every
    WALK_UNROLL steps (each ray's result depends on that ray alone)."""
    R = o.shape[0]
    t_min = torch.broadcast_to(_f32(t_min, o), (R,))
    t_best = torch.broadcast_to(_f32(t_max, o), (R,)).clone()
    tri_best = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros((R,), dtype=torch.float32, device=o.device)
    v_best = torch.zeros_like(u_best)
    T = scene.tri_v0.shape[0]
    if T == 0 or R == 0:
        return t_best, tri_best, u_best, v_best
    num_nodes = scene.bvh_meta.shape[0]
    inv_d = 1.0 / _safe_d(d)

    slots = torch.arange(MAX_LEAF, dtype=scene.bvh_meta.dtype,
                         device=o.device)
    act = torch.arange(R, device=o.device)
    node = torch.zeros((R,), dtype=torch.int64, device=o.device)
    ao, ad, ainv, atmin = o, d, inv_d, t_min
    at, atri, au, av = t_best, tri_best, u_best, v_best
    done = torch.zeros((R,), dtype=torch.bool, device=o.device)
    while True:
        for _ in range(WALK_UNROLL):
            nc = torch.clamp(node, max=num_nodes - 1)
            meta = scene.bvh_meta[nc]
            box_hit, _ = ray_box(ao, ainv, scene.bvh_min[nc],
                                 scene.bvh_max[nc], at)
            is_leaf = meta[:, 1] > 0
            # the rays at a leaf test its triangles side by side: the
            # nearest hit wins, the first of equals on a tie, as testing
            # them in order against the shrinking t_max does
            at_leaf = torch.nonzero(box_hit & is_leaf)[:, 0]
            if at_leaf.shape[0]:
                lm = meta[at_leaf]
                tid = torch.clamp(lm[:, 0:1] + slots, 0, T - 1)
                tl = tid.long()
                lt = at[at_leaf]
                h, t, uu, vv = ray_tri(ao[at_leaf, None], ad[at_leaf, None],
                                       scene.tri_v0[tl], scene.tri_e1[tl],
                                       scene.tri_e2[tl],
                                       atmin[at_leaf, None], lt[:, None])
                h = h & (slots < lm[:, 1:2])
                k = torch.argmin(torch.where(h, t, INF), dim=1, keepdim=True)
                got = torch.gather(h, 1, k)[:, 0]
                at = at.index_put((at_leaf,), torch.where(
                    got, torch.gather(t, 1, k)[:, 0], lt))
                atri = atri.index_put((at_leaf,), torch.where(
                    got, torch.gather(tid, 1, k)[:, 0], atri[at_leaf]))
                au = au.index_put((at_leaf,), torch.where(
                    got, torch.gather(uu, 1, k)[:, 0], au[at_leaf]))
                av = av.index_put((at_leaf,), torch.where(
                    got, torch.gather(vv, 1, k)[:, 0], av[at_leaf]))
            nxt = torch.where(box_hit & ~is_leaf, node + 1,
                              scene.bvh_skip[nc].long())
            if any_hit:
                done = done | (atri >= 0)
                nxt = torch.where(done, num_nodes, nxt)
            node = nxt
        fin = node >= num_nodes
        if bool(fin.any()):
            idx = act[fin]
            t_best[idx] = at[fin]
            tri_best[idx] = atri[fin]
            u_best[idx] = au[fin]
            v_best[idx] = av[fin]
            keep = ~fin
            if not bool(keep.any()):
                break
            act, node, done = act[keep], node[keep], done[keep]
            ao, ad, ainv, atmin = ao[keep], ad[keep], ainv[keep], atmin[keep]
            at, atri, au, av = at[keep], atri[keep], au[keep], av[keep]
    return t_best, tri_best, u_best, v_best


def ray_frame(d):
    """The curve walk's ray-aligned frame (lx, ly, lz = d) of each ray
    (ref Curves.cpp:433-442); rays along +-y (dxz == 0) take lx =
    (1, 0, 0), ly = (0, 0, -d_y)."""
    R = d.shape[0]
    dxz = torch.sqrt(d[:, 0] ** 2 + d[:, 2] ** 2)
    deg = (dxz == 0.0)[:, None]
    sdxz = torch.clamp(dxz, min=1e-20)
    zero = torch.zeros((R,), dtype=d.dtype, device=d.device)
    lx = torch.where(deg, torch.tensor([1.0, 0.0, 0.0], device=d.device),
                     torch.stack([d[:, 2] / sdxz, zero, -d[:, 0] / sdxz],
                                 dim=-1))
    ly = torch.where(deg, torch.stack([zero, zero, -d[:, 1]], dim=-1),
                     torch.stack([lx[:, 2] * d[:, 1], dxz,
                                  -d[:, 1] * lx[:, 0]], dim=-1))
    return lx, ly


def curve_piece_test(scene, pid, o, d, lx, ly, t_min, best):
    """Test piece pid (R,) (in range) for each ray; best = (t, seg, u, v,
    hit) -> the updated best.  The half-cylinder chord test
    (Curves.cpp:51-94) and the ribbon test (Curves.cpp:96-133) both run;
    the segment's mode selects one."""
    from tungsten_tpu_torch.scene.flatten import CURVE_MODE_RIBBON

    def proj(p):  # world point (R,3) -> ray frame
        q = p - o
        return torch.stack([torch.sum(q * lx, -1), torch.sum(q * ly, -1),
                            torch.sum(q * d, -1)], dim=-1)

    q0w = scene.crv_pc_q0[pid]
    q1w = scene.crv_pc_q1[pid]
    e0 = proj(q0w[:, :3])
    e1 = proj(q1w[:, :3])
    w0, w1 = q0w[:, 3], q1w[:, 3]
    pt0 = scene.crv_pc_t0[pid]
    pt1 = scene.crv_pc_t1[pid]
    seg = scene.crv_pc_seg[pid]
    mode = scene.crv_seg_mode[seg.long()]
    bt, bseg, bu, bv, bhit = best

    # ---- half-cylinder chord test ----
    vxy = e1[:, :2] - e0[:, :2]
    lsq = torch.sum(vxy * vxy, -1)
    inv_lsq = 1.0 / torch.clamp(lsq, min=1e-30)
    seg_t = -torch.sum(e0[:, :2] * vxy, -1) * inv_lsq
    signed = e0[:, 0] * vxy[:, 1] - e0[:, 1] * vxy[:, 0]
    dist = torch.abs(signed) * torch.sqrt(inv_lsq)
    width = w0 * (1.0 - seg_t) + w1 * seg_t
    depth = e0[:, 2] * (1.0 - seg_t) + e1[:, 2] * seg_t
    dz = e1[:, 2] - e0[:, 2]
    y_sq = width * width - dist * dist
    l_sq = y_sq * (1.0 + dz * dz * inv_lsq)
    delta = torch.sqrt(torch.clamp(l_sq, min=0.0))
    t0 = depth - delta
    v3 = e0 - e1
    lsq3 = torch.clamp(torch.sum(v3 * v3, -1), min=1e-30)
    e0z = torch.stack([e0[:, 0], e0[:, 1], e0[:, 2] - t0], dim=-1)
    seg_t2 = torch.sum(e0z * v3, -1) / lsq3
    new_t = seg_t2 * (pt1 - pt0) + pt0
    ok_cyl = (dist <= width) & (seg_t2 >= 0.0) & (t0 < bt) & \
        (t0 > t_min) & (new_t >= 0.0) & (new_t <= 1.0)
    v_cyl = 0.5 + 0.5 * dist / torch.clamp(width, min=1e-30)

    # ---- ribbon test ----
    nm = proj(scene.crv_pc_nmid[pid] + o)  # a vector: the rotation only
    v3d = e1 - e0
    lsq_r = torch.sum(v3d * v3d, -1)
    inv_r = 1.0 / torch.clamp(lsq_r, min=1e-30)
    nr = v3d * (torch.sum(v3d * nm, -1) * inv_r)[:, None] - nm
    t0r = torch.sum(nr * e0, -1) / torch.where(
        torch.abs(nr[:, 2]) < 1e-20, 1e-20, nr[:, 2])
    local_p = torch.stack([-e0[:, 0], -e0[:, 1], t0r - e0[:, 2]], dim=-1)
    seg_tr = torch.sum(local_p * v3d, -1) * inv_r
    width_r = w0 * (1.0 - seg_tr) + w1 * seg_tr
    dvec = local_p - v3d * seg_tr[:, None]
    dist_sq = torch.sum(dvec * dvec, -1)
    new_tr = seg_tr * (pt1 - pt0) + pt0
    ok_rib = (t0r >= t_min) & (t0r < bt) & (seg_tr >= 0.0) & \
        (seg_tr <= 1.0) & (dist_sq <= width_r * width_r) & \
        (new_tr >= 0.0) & (new_tr <= 1.0)
    is_rib = mode == CURVE_MODE_RIBBON
    ok = torch.where(is_rib, ok_rib, ok_cyl)
    t_hit = torch.where(is_rib, t0r, t0)
    u_hit = torch.where(is_rib, new_tr, new_t)
    v_hit = torch.where(is_rib, 0.0, v_cyl)
    return (torch.where(ok, t_hit, bt), torch.where(ok, seg, bseg),
            torch.where(ok, u_hit, bu), torch.where(ok, v_hit, bv),
            bhit | ok)


def curve_walk_plain(scene, o, d, t_min, t_max, any_hit: bool = False):
    """Skip-pointer walk over the curve-piece BVH, the JAX package's
    `_curve_traverse` step for step (its plain version on every device):
    a box hit descends, a miss jumps `cbvh_skip`, a leaf tests its up to
    MAX_LEAF pieces in order against the ray's best t.  A ray whose far
    limit is not above t_min cannot hit and never walks; a finished ray
    (cursor past the last node) leaves the working set, where the JAX
    walk goes on re-testing the clamped last node, which changes nothing
    for a closest hit (the tests are strict).  Returns (t, seg, u, v,
    hit); t = t_max and seg = -1 on a miss."""
    R = o.shape[0]
    t_min = torch.broadcast_to(_f32(t_min, o), (R,))
    t_best = torch.broadcast_to(_f32(t_max, o), (R,)).clone()
    seg_best = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros((R,), dtype=torch.float32, device=o.device)
    v_best = torch.zeros_like(u_best)
    hit_best = torch.zeros((R,), dtype=torch.bool, device=o.device)
    n_pieces = scene.crv_pc_q0.shape[0]
    num_nodes = scene.cbvh_meta.shape[0]
    if n_pieces == 0 or R == 0:
        return t_best, seg_best, u_best, v_best, hit_best
    inv_d = 1.0 / _safe_d(d)
    lx, ly = ray_frame(d)

    act = torch.nonzero(t_best > t_min)[:, 0]
    cols = [o, d, inv_d, lx, ly, t_min]
    ao, ad, ainv, alx, aly, atmin = (c[act] for c in cols)
    best = (t_best[act], seg_best[act], u_best[act], v_best[act],
            hit_best[act])
    node = torch.zeros(act.shape, dtype=torch.int64, device=o.device)
    while act.shape[0] > 0:
        for _ in range(WALK_UNROLL):
            nc = torch.clamp(node, max=num_nodes - 1)
            meta = scene.cbvh_meta[nc]
            box_hit, _ = ray_box(ao, ainv, scene.cbvh_min[nc],
                                 scene.cbvh_max[nc], best[0])
            is_leaf = meta[:, 1] > 0
            # the piece tests run on the rays at a leaf only (the same
            # arithmetic lane by lane as testing every ray and masking)
            li = torch.nonzero(box_hit & is_leaf)[:, 0]
            if li.shape[0] > 0:
                lmeta = meta[li]
                sub = tuple(b[li] for b in best)
                lray = [c[li] for c in (ao, ad, alx, aly, atmin)]
                for k in range(min(MAX_LEAF, int(lmeta[:, 1].max()))):
                    valid = k < lmeta[:, 1]
                    pid = torch.clamp(lmeta[:, 0] + k, 0,
                                      n_pieces - 1).long()
                    nb = curve_piece_test(scene, pid, *lray[:4], lray[4],
                                          sub)
                    sub = tuple(torch.where(valid, n, b)
                                for n, b in zip(nb, sub))
                best = tuple(b.index_put((li,), v)
                             for b, v in zip(best, sub))
            nxt = torch.where(box_hit & ~is_leaf, node + 1,
                              scene.cbvh_skip[nc].long())
            if any_hit:
                nxt = torch.where(best[4], num_nodes, nxt)
            node = nxt
        fin = node >= num_nodes
        if bool(fin.any()):
            idx = act[fin]
            for out, b in zip((t_best, seg_best, u_best, v_best, hit_best),
                              best):
                out[idx] = b[fin]
            keep = ~fin
            act, node = act[keep], node[keep]
            ao, ad, ainv, alx, aly, atmin = (
                c[keep] for c in (ao, ad, ainv, alx, aly, atmin))
            best = tuple(b[keep] for b in best)
    return t_best, seg_best, u_best, v_best, hit_best


def curve_walk(scene, o, d, t_min, t_max, any_hit: bool = False):
    """The curve-piece walk of rays (o, d) over (t_min, t_max), scalars
    or (R,): on the CPU `curve_walk_plain`, on CUDA the kernel C1
    (ops/curve_trace.py), which raises rather than fall back.  Returns
    (t, seg, u, v, hit); for any hit only `hit` is the closest walk's."""
    o, d, t_min, t_max = (_detached(x) for x in (o, d, t_min, t_max))
    if o.is_cuda:
        from tungsten_tpu_torch.ops.curve_trace import curve_kernel
        R = o.shape[0]
        return curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d,
                            torch.broadcast_to(_f32(t_min, o), (R,)),
                            torch.broadcast_to(_f32(t_max, o), (R,)),
                            any_hit)
    return curve_walk_plain(scene, o, d, t_min, t_max, any_hit)


def geo_clip(scene, o, d, t_max):
    """(R,) far limits clipped at each ray's exit from the scene-wide
    occluder box: no geometry exists past it, so INF rays (env shadow
    rays, continuations) become short rays and the traversal's interval
    culls tighten to the populated region."""
    safe_d = _safe_d(d)
    tx = torch.maximum((scene.geo_lo - o) / safe_d,
                       (scene.geo_hi - o) / safe_d)
    exit_t = torch.clamp(torch.amin(tx, dim=-1), min=0.0) * 1.0001 + 1e-4
    return torch.minimum(torch.broadcast_to(_f32(t_max, o), (o.shape[0],)),
                         exit_t)


def bvh_intersect(scene, o, d, t_min, t_max, any_hit: bool = False,
                  presorted: bool = False):
    """Closest-hit (or any-hit) traversal of the scene's triangles,
    analytic primitives and curves.  A scene without triangles skips the
    triangle traversal (no kernel launches on empty tables), one without
    curve pieces the curve walk.

    o, d (R,3); t_min/t_max scalars or (R,).  `presorted`: the caller
    guarantees rays already arrive in ray_sort_key order (the path
    tracer's body-start sort), so the CUDA dispatch skips its sort.
    Returns dict(t, tri, sph, dsk, cyl, crv, u, v, hit); a channel is -1
    where that primitive type did not win.  For any_hit t is the far
    limit, not a hit distance, and only `hit` carries meaning.

    Traversal carries no graph (detached sampling, interior derivatives
    only, as the JAX package cuts its tape at the kernel inputs): the
    rays are detached and the results come back without one."""
    with torch.no_grad():
        return _intersect(scene, _detached(o), _detached(d),
                          _detached(t_min), _detached(t_max), any_hit,
                          presorted)


def _detached(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _intersect(scene, o, d, t_min, t_max, any_hit, presorted):
    R = o.shape[0]
    t_min = torch.broadcast_to(_f32(t_min, o), (R,))
    t_clip = geo_clip(scene, o, d, t_max)
    res = _tri_analytic(scene, o, d, t_min, t_clip, any_hit, presorted)
    if scene.crv_pc_q0.shape[0] > 0:
        # the far limit: the best t of the triangles and analytic prims
        # where they hit, else the clipped t_max; an any-hit ray they
        # already occlude leaves the walk (far = t_min: no hit can pass)
        far = torch.where(res["hit"], t_min if any_hit else res["t"],
                          t_clip)
        ct, cseg, cu, cv, chit = curve_walk(scene, o, d, t_min, far,
                                            any_hit)
        res["t"] = torch.where(chit, ct, res["t"])
        for ch in ("tri", "sph", "dsk", "cyl"):
            res[ch] = torch.where(chit, -1, res[ch])
        res["u"] = torch.where(chit, cu, res["u"])
        res["v"] = torch.where(chit, cv, res["v"])
        res["hit"] = res["hit"] | chit
        res["crv"] = torch.where(chit, cseg, res["crv"])
    return res


def _tri_analytic(scene, o, d, t_min, t_max, any_hit, presorted):
    """The analytic prims, then the triangle traversal under their best
    t (t_max already geo-clipped).  Returns dict(t, tri, sph, dsk, cyl,
    crv, u, v, hit) with crv all -1 (bvh_intersect merges the curves).
    The channels that start at -1 share one tensor, which no one
    writes."""
    R = o.shape[0]
    neg = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    best_t, sph, dsk, cyl = _analytic_prims(scene, o, d, t_min, t_max, neg)
    if scene.tri_v0.shape[0] == 0:
        z = torch.zeros((R,), dtype=torch.float32, device=o.device)
        return dict(t=best_t, tri=neg, sph=sph, dsk=dsk, cyl=cyl, crv=neg,
                    u=z, v=z, hit=(sph >= 0) | (dsk >= 0) | (cyl >= 0))
    if o.is_cuda:
        t, tri, u, v = _wave_dispatch(scene, o, d, t_min, best_t, any_hit,
                                      presorted)
    else:
        t, tri, u, v = bvh_walk(scene, o, d, t_min, best_t, any_hit)
    got_tri = tri >= 0
    sph = torch.where(got_tri, -1, sph)
    dsk = torch.where(got_tri, -1, dsk)
    cyl = torch.where(got_tri, -1, cyl)
    hit = got_tri | (sph >= 0) | (dsk >= 0) | (cyl >= 0)
    if any_hit:
        t = best_t
    return dict(t=torch.where(got_tri, t, best_t), tri=tri, sph=sph,
                dsk=dsk, cyl=cyl, crv=neg, u=u, v=v, hit=hit)


def _spread5(x):
    """Interleave up to 5 bits per axis (int64 words)."""
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    x = (x | (x << 2)) & 0x249249
    return x


def ray_sort_key(scene, o, d, dead):
    """The wave traversal's coherence sort key (octant layout):
    dead | direction octant | origin morton | direction morton, as the
    JAX package's uint32 key held in int64 so dead rays (bit 31) sort
    last."""
    lo = scene.bvh_min[0]
    hi = scene.bvh_max[0]
    q = torch.clamp((o - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    qo = (q * 31).to(torch.int64)
    morton = _spread5(qo[:, 0]) | (_spread5(qo[:, 1]) << 1) | \
        (_spread5(qo[:, 2]) << 2)
    qd = ((torch.clamp(d, -1.0, 1.0) + 1.0) * 7.999).to(torch.int64)
    dmorton = _spread5(qd[:, 0]) | (_spread5(qd[:, 1]) << 1) | \
        (_spread5(qd[:, 2]) << 2)
    octant = (d[:, 0] > 0).to(torch.int64) | \
        ((d[:, 1] > 0).to(torch.int64) << 1) | \
        ((d[:, 2] > 0).to(torch.int64) << 2)
    key_live = (octant << 28) | (morton << 13) | (dmorton & 0xFFF)
    return (dead.to(torch.int64) << 31) | key_live


def _sort_for_wave(scene, o, d, t_min, t_max):
    """Stable sort of the rays by ray_sort_key (dead = t_max <= 0);
    returns (o_s, d_s, tmin_s, tmax_s, order) with `order` the original
    ray index of each sorted slot."""
    key = ray_sort_key(scene, o, d, t_max <= 0.0)
    _, order = torch.sort(key, stable=True)
    return o[order], d[order], t_min[order], t_max[order], order


def dispatch_rays(scene, o, d, t_min, t_max, presorted: bool = False):
    """The rays as the kernel takes them: stable-sorted by ray_sort_key
    (unless `presorted`) and padded to a multiple of BLOCK with dead rays
    (d = +z, t_max = 0).  Returns (o, d, t_min, t_max, order); `order`
    is None when presorted."""
    from tungsten_tpu_torch.ops.wave_trace import BLOCK
    order = None
    if not presorted:
        o, d, t_min, t_max, order = _sort_for_wave(scene, o, d, t_min, t_max)
    pad = (-o.shape[0]) % BLOCK
    if pad:
        z = torch.zeros((pad, 3), dtype=o.dtype, device=o.device)
        dz = z.clone()
        dz[:, 2] = 1.0
        o = torch.cat([o, z])
        d = torch.cat([d, dz])
        t_min = torch.cat([t_min, z[:, 0]])
        t_max = torch.cat([t_max, z[:, 0]])
    return o, d, t_min, t_max, order


def _wave_dispatch(scene, o, d, t_min, t_max, any_hit: bool,
                   presorted: bool = False):
    """Sort + pad rays to 1024, run the scene's wave walk (resident or
    paged, by traversal_kind), scatter the results back to submission
    order.  Returns (t, tri, u, v)."""
    from tungsten_tpu_torch.ops import wave_trace as wt
    walk = wt.wave_intersect_paged if wt.traversal_kind(scene) == "paged" \
        else wt.wave_intersect
    R = o.shape[0]
    o_s, d_s, tmin_s, tmax_s, order = dispatch_rays(scene, o, d, t_min,
                                                    t_max, presorted)
    t, tri, u, v = walk(scene, o_s, d_s, tmin_s, tmax_s, any_hit=any_hit,
                        device=o.device)
    t, tri, u, v = t[:R], tri[:R], u[:R], v[:R]
    if order is None:
        return t, tri, u, v
    out = []
    for x in (t, tri, u, v):
        y = torch.empty_like(x)
        y[order] = x
        out.append(y)
    return tuple(out)


def occluded(scene, o, d, t_min, t_max):
    """Binary occlusion along segments (t_min, t_max)."""
    return bvh_intersect(scene, o, d, t_min, t_max, any_hit=True)["hit"]
