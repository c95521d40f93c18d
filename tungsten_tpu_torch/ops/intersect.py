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
first (`_analytic_prims`), and the triangle traversal must beat them.
A hit is the dict (t, tri, sph, dsk, cyl, u, v, hit); a channel is -1
where that primitive type did not win.
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


def _analytic_prims(scene, o, d, t_min, t_max):
    """Dense tests against every analytic primitive (spheres, disks,
    cylinders — counts are tiny).  Returns (best_t, sph, dsk, cyl)
    winner channels, each -1 where that type did not win; best_t is the
    far limit the triangle traversal then gets."""
    R = o.shape[0]
    best_t = t_max
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
    tri = -1 on a miss.  Finished rays leave the working set every
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
            test_leaf = box_hit & is_leaf
            for k in range(MAX_LEAF):
                valid = test_leaf & (k < meta[:, 1])
                tid = torch.clamp(meta[:, 0] + k, 0, T - 1)
                tl = tid.long()
                h, t, uu, vv = ray_tri(ao, ad, scene.tri_v0[tl],
                                       scene.tri_e1[tl], scene.tri_e2[tl],
                                       atmin, at)
                h = h & valid
                at = torch.where(h, t, at)
                atri = torch.where(h, tid, atri)
                au = torch.where(h, uu, au)
                av = torch.where(h, vv, av)
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
    """Closest-hit (or any-hit) traversal of the scene's triangles and
    analytic primitives (curves are not ported: a scene carrying them
    raises in flat_scene_from_numpy).  A scene without triangles returns
    straight after the analytic test: no kernel launches on empty
    tables.

    o, d (R,3); t_min/t_max scalars or (R,).  `presorted`: the caller
    guarantees rays already arrive in ray_sort_key order (the path
    tracer's body-start sort), so the CUDA dispatch skips its sort.
    Returns dict(t, tri, sph, dsk, cyl, u, v, hit); a channel is -1
    where that primitive type did not win.  For any_hit t is the far
    limit, not a hit distance."""
    R = o.shape[0]
    t_min = torch.broadcast_to(_f32(t_min, o), (R,))
    best_t, sph, dsk, cyl = _analytic_prims(
        scene, o, d, t_min, geo_clip(scene, o, d, t_max))
    if scene.tri_v0.shape[0] == 0:
        z = torch.zeros((R,), dtype=torch.float32, device=o.device)
        return dict(t=best_t, tri=torch.full_like(sph, -1), sph=sph,
                    dsk=dsk, cyl=cyl, u=z, v=z,
                    hit=(sph >= 0) | (dsk >= 0) | (cyl >= 0))
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
                dsk=dsk, cyl=cyl, u=u, v=v, hit=hit)


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
