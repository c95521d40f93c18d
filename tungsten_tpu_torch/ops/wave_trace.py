"""Cluster-table ray traversal: host table build, the traversal fronts,
the CUDA wave kernels and their plain schedule (port of
tungsten_tpu/ops/wave_trace.py).

The JAX package's Pallas kernel (`_make_kernel`, launched by
`wave_intersect`) walks, per 128-ray warp, an entry-sorted list of
"supers" (16 consecutive clusters of <= 128 triangles), slab-tests the
member clusters per ray and evaluates the surviving clusters'
precomputed Moller-Trumbore rows on the TPU's matrix unit.  Here the
same walk over the same tables is hand-written CUDA in
csrc/wave_trace.cu: per 128-ray block, each ray slab-tests the clusters
against its own best t and tests only the clusters it accepts, its
triangles split over 4 to 32 threads, each cluster's 16x128 f32
attribute rows staged in shared memory and evaluated as f32 FMA chains.
The bf16 hi/lo split and the packed 7-bit winner key were TPU devices
and are gone.  A narrow launch splits each block's walk over several
CTAs (`splits`, by default `launch_splits`), which share each ray's best
through a word in device memory.

Scenes whose attribute table is >= 13 MiB take the PAGED walk
(`wave_intersect_paged`, the JAX package's `_make_kernel_paged`).  It
computes what the resident walk does, and on this card the page order
only shaped L2 locality: its closest hit, and since chip_smoke.py timed
both any-hit wrappers on a 606,724-triangle scene (the resident front
and kernel the faster) its any hit too, launch the resident kernels on
the resident front.  The paged any-hit walk (`paged_anyhit_kernel`, the
per-warp lists sorted by (page, entry), a page being PAGE_SUP supers,
walked page slot by page slot) stays built and checked as the page
order's yardstick; no wrapper launches it.

On the CPU both wrappers run the kernels' plain version, the torch port
of the skip-pointer BVH walk (ops/intersect.py::bvh_walk) — the same
traversal the JAX package runs on its CPU backend.  On a CUDA tensor
they launch their kernel or raise; they never fall back.  `list_walk`
is the kernels' own schedule in plain PyTorch (the lists in order, the
same culls and counts), the yardstick the tests and chip_smoke.py hold
the kernels to.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np
import torch

BLOCK = 1024        # ray padding granule of the dispatch (as on the TPU)
WARP = 128          # rays per culled warp = rays per CUDA block
CLUSTER = 128       # triangles per cluster (padded)
SUP = 16            # clusters per super
ATTR_ROWS = 16      # rows per cluster attr block
FCOLS = 16          # ray feature columns: o 1 d m tmin tmax invd pad
INF = 3.0e38
NPINF = np.float32(3.0e38)
SUBWARP = 32        # rays per cull interval (phase A)
# f32 multiplies and adds per ray-triangle test in the kernel's leaf:
# det (5), u*det and v*det (11 each), t*det (6), the sign fold (4),
# u + v and the two t-range products (3); comparisons not counted.  The
# unit of the operation bound that chip_smoke.py reports.
FLOPS_PER_TEST = 40

# the paged walk: supers per page (read at call time, so a test can
# shrink it, as tests/test_paged.py does); a page holds page_clusters()
PAGE_SUP = 16
MAX_PAGE_CLUSTERS = 256     # the kernel's shared-memory page of boxes
# attribute-table bytes from which a scene takes the paged walk (the JAX
# package's enable_pallas_if_suitable rule)
PAGED_ATTR_BYTES = 13 * 1024 * 1024

# launches of the CUDA kernels per route (plain integers; the plain CPU
# version does not count): "closest" / "anyhit" and "paged_closest" /
# "paged_anyhit" are the resident kernels launched by wave_intersect and
# by wave_intersect_paged, "paged_walk" the paged any-hit walk
LAUNCHES = {"closest": 0, "anyhit": 0, "paged_closest": 0,
            "paged_anyhit": 0, "paged_walk": 0}
# a list to append (route, rays, splits) to at every launch, or None
LAUNCH_LOG: list | None = None

# the narrow-launch split: CTAs per 128-ray block so that a launch gives
# each SM CTAS_PER_SM CTAs, at most MAX_SPLITS a block (a full-width wave
# keeps one); the kernels take up to 64
CTAS_PER_SM = 4
MAX_SPLITS = 16


# --------------------------------------------------------------- host build

def build_wave_tables(tri_v0, tri_e1, tri_e2):
    """SAH cluster partition + kernel tables (numpy; identical to the JAX
    package's build).

    Returns (boxes (16, NCp) f32 attr-major [rows 0-2 lo, 3-5 hi,
    9 valid], cbox (NCp, 8) f32 cluster-major [lox loy loz hix hiy hiz
    valid pad], attr (NCp*16, 128) f32 precomputed Moller-Trumbore rows,
    remap (NCp*128,) i32 (cluster*128+lane) -> original tri id, -1
    padding, sbox (16, NSp) super-cluster AABBs in the boxes layout).

    attr row layout per cluster (lane = triangle), all products in
    float64 then rounded:
      rows  0:3   ne2v0 = -(e2 x v0)        (u*det, with d)
      rows  3:6   e2                        (u*det, with m = o x d)
      rows  6:9   e1v0  =  (e1 x v0)        (v*det, with d)
      rows  9:12  ne1   = -e1               (v*det, with m)
      rows 12:15  n     =  (e1 x e2)        (t*det, with o; det = -d.n)
      row  15     nnv0  = -(n . v0)         (t*det, with 1)
    """
    from tungsten_tpu_torch.scene.bvh import build_bvh

    T = tri_v0.shape[0]
    v1 = tri_v0 + tri_e1
    v2 = tri_v0 + tri_e2
    tlo = np.minimum(np.minimum(tri_v0, v1), v2)
    thi = np.maximum(np.maximum(tri_v0, v1), v2)

    clusters = []
    if T > 0:
        bvh = build_bvh(tlo, thi, max_leaf_size=4)
        # treelet decomposition: cut the BVH at the shallowest complete
        # subtrees holding <= 128 prims
        meta = bvh.meta
        num = meta.shape[0]
        start = np.zeros(num, np.int64)
        count = np.zeros(num, np.int64)
        for node in range(num - 1, -1, -1):
            if meta[node, 1] > 0:
                start[node] = meta[node, 0]
                count[node] = meta[node, 1]
            else:
                right = meta[node, 0]
                start[node] = start[node + 1]
                count[node] = count[node + 1] + count[right]
        treelets = []
        stack = [0]
        while stack:
            node = stack.pop()
            if count[node] <= CLUSTER:
                treelets.append((int(start[node]), int(count[node])))
            else:
                stack.append(int(meta[node, 0]))   # right
                stack.append(node + 1)             # left (DFS order)
        treelets.sort()
        # greedy-pack ADJACENT treelets into full 128-slots
        run_start, run_count = treelets[0]
        for s, c in treelets[1:]:
            if run_count + c <= CLUSTER:
                run_count += c
            else:
                clusters.append(bvh.order[run_start:run_start +
                                          run_count].astype(np.int64))
                run_start, run_count = s, c
        clusters.append(bvh.order[run_start:run_start +
                                  run_count].astype(np.int64))

    nc = len(clusters)
    ncp = -(-max(nc, 1) // 128) * 128
    nsup = ncp // SUP
    nsp = -(-nsup // 128) * 128
    boxes = np.zeros((16, ncp), np.float32)
    boxes[0:3, :] = NPINF
    boxes[3:6, :] = -NPINF
    cbox = np.zeros((ncp, 8), np.float32)
    attr = np.zeros((ncp * ATTR_ROWS, 128), np.float32)
    remap = np.full((ncp * CLUSTER,), -1, np.int32)

    v0d = tri_v0.astype(np.float64)
    e1d = tri_e1.astype(np.float64)
    e2d = tri_e2.astype(np.float64)
    for i, ids in enumerate(clusters):
        n = ids.shape[0]
        lo = tlo[ids].min(axis=0)
        hi = thi[ids].max(axis=0)
        boxes[0:3, i] = lo
        boxes[3:6, i] = hi
        boxes[9, i] = 1.0
        cbox[i, 0:3] = lo
        cbox[i, 3:6] = hi
        cbox[i, 6] = 1.0
        nr = np.cross(e1d[ids], e2d[ids])
        base = i * ATTR_ROWS
        attr[base + 0:base + 3, :n] = (-np.cross(e2d[ids], v0d[ids])).T
        attr[base + 3:base + 6, :n] = e2d[ids].T
        attr[base + 6:base + 9, :n] = np.cross(e1d[ids], v0d[ids]).T
        attr[base + 9:base + 12, :n] = (-e1d[ids]).T
        attr[base + 12:base + 15, :n] = nr.T
        attr[base + 15, :n] = -np.sum(nr * v0d[ids], axis=-1)
        remap[i * CLUSTER:i * CLUSTER + n] = ids

    sbox = np.zeros((16, nsp), np.float32)
    sbox[0:3, :] = NPINF
    sbox[3:6, :] = -NPINF
    for s in range(nsup):
        sel = slice(s * SUP, (s + 1) * SUP)
        valid = cbox[sel, 6] > 0
        if valid.any():
            sbox[0:3, s] = cbox[sel, 0:3][valid].min(axis=0)
            sbox[3:6, s] = cbox[sel, 3:6][valid].max(axis=0)
            sbox[9, s] = 1.0
    return boxes, cbox, attr, remap, sbox


# ------------------------------------------------------------------- front

def _warp_entries(o, d, tmin_c, tmax_c, sbox, G):
    """Phase A: subwarp-interval cull vs super boxes, unioned per warp.

    o/d (R,3); tmin_c/tmax_c (R,1); sbox (16, NSp).  Returns (G, 8, NSp)
    f32: per warp and super the conservative entry t, INF where no ray
    of the warp can need the super.  The arithmetic (and so the rounding
    the 1.00000024 fudge covers) is the JAX package's, op for op."""
    nsp = sbox.shape[1]
    R = o.shape[0]
    ns = R // SUBWARP
    live = (tmax_c > 0.0).reshape(ns, SUBWARP, 1)
    od = torch.cat([o, d], dim=1).reshape(ns, SUBWARP, 6)
    lo = torch.amin(torch.where(live, od, INF), dim=1)          # (ns, 6)
    hi = torch.amax(torch.where(live, od, -INF), dim=1)
    tmin_s = torch.amin(torch.where(live[..., 0],
                                    tmin_c.reshape(ns, SUBWARP), INF), dim=1)
    tmax_s = torch.amax(torch.where(live[..., 0],
                                    tmax_c.reshape(ns, SUBWARP), -INF), dim=1)
    any_live = torch.any(live[..., 0], dim=1)

    tn = tmin_s[:, None].expand(ns, nsp)
    tf = torch.clamp(tmax_s, max=1e37)[:, None].expand(ns, nsp)
    for ax in range(3):
        lo_row = sbox[ax][None, :]
        hi_row = sbox[ax + 3][None, :]
        d0 = lo[:, 3 + ax][:, None]
        d1 = hi[:, 3 + ax][:, None]
        same = (d0 > 0.0) | (d1 < 0.0)
        i0 = 1.0 / torch.where(same, d1, 1.0)
        i1 = 1.0 / torch.where(same, d0, 1.0)
        n0_lo = lo_row - hi[:, ax][:, None]
        n1_lo = lo_row - lo[:, ax][:, None]
        n0_hi = hi_row - hi[:, ax][:, None]
        n1_hi = hi_row - lo[:, ax][:, None]

        def hull(n0, n1, i0=i0, i1=i1):
            p = (n0 * i0, n0 * i1, n1 * i0, n1 * i1)
            return (torch.minimum(torch.minimum(p[0], p[1]),
                                  torch.minimum(p[2], p[3])),
                    torch.maximum(torch.maximum(p[0], p[1]),
                                  torch.maximum(p[2], p[3])))

        a0_lo, a1_lo = hull(n0_lo, n1_lo)
        a0_hi, a1_hi = hull(n0_hi, n1_hi)
        a0 = torch.minimum(a0_lo, a0_hi)
        a1 = torch.maximum(a1_lo, a1_hi)
        tn = torch.maximum(tn, torch.where(same, a0, -INF))
        tf = torch.minimum(tf, torch.where(same, a1, INF))

    pend = (tn <= tf * 1.00000024) & (sbox[9][None, :] > 0.0) & \
        any_live[:, None]
    entry = torch.where(pend, tn, INF)                           # (ns, nsp)
    return torch.amin(entry.reshape(G, 8, WARP // SUBWARP, nsp), dim=2)


def _cull_sorted_supers(o, d, tmin_c, tmax_c, sbox, G):
    """The resident walk's front: per-warp pending lists SORTED by
    conservative entry.  Returns (sent (G, 8, NSp) f32 entries
    INF-padded, sids (G, 8, NSp) i32)."""
    entry_w = _warp_entries(o, d, tmin_c, tmax_c, sbox, G)
    sent, sids = torch.sort(entry_w, dim=-1, stable=True)
    return sent, sids.to(torch.int32)


def _cull_paged(o, d, tmin_c, tmax_c, sbox, G, n_pages):
    """The paged walk's front: the same cull, but per-warp lists sorted
    by (page, entry) — a super's page is its id // PAGE_SUP — plus
    per-(warp, page slot) index ranges and a compact per-block page list.

    Returns (pages (G, S) i32 block page list, ascending, padded by
    repeating the last needed page (all 0 on an all-dead block);
    sent (G, 8, NSp) f32; sids (G, 8, NSp) i32; offs/offe (G, 8, S) i32
    slot ranges, empty on pad slots); S = n_pages.  The JAX package sorts
    on both keys at once with an unstable sort; here a stable sort by
    entry and then a stable sort by page give the same order, with tied
    entries in ascending super id."""
    entry_w = _warp_entries(o, d, tmin_c, tmax_c, sbox, G)
    nsp = entry_w.shape[-1]
    dev = entry_w.device
    page_col = (torch.arange(nsp, dtype=torch.int32, device=dev) //
                PAGE_SUP).expand(entry_w.shape)
    page_w = torch.where(entry_w < INF, page_col,
                         torch.tensor(n_pages, dtype=torch.int32,
                                      device=dev))      # sentinel: last
    e1, ids = torch.sort(entry_w, dim=-1, stable=True)
    spage, by_page = torch.sort(torch.gather(page_w, -1, ids), dim=-1,
                                stable=True)
    sent = torch.gather(e1, -1, by_page)
    sids = torch.gather(ids, -1, by_page).to(torch.int32)
    # per-(warp, page) offsets by a batched binary search
    targets = torch.arange(n_pages + 1, dtype=torch.int32,
                           device=dev).expand(G * 8, n_pages + 1)
    off_pg = torch.searchsorted(spage.reshape(G * 8, nsp).contiguous(),
                                targets.contiguous(), side="left",
                                out_int32=True).reshape(G, 8, n_pages + 1)
    # block page list (union over warps), compacted ascending
    present = torch.any(off_pg[:, :, 1:] > off_pg[:, :, :-1], dim=1)  # (G,P)
    order = torch.argsort((~present).to(torch.int32), dim=1,
                          stable=True).to(torch.int32)
    npg = torch.sum(present, dim=1, dtype=torch.int32)               # (G,)
    slot = torch.arange(n_pages, dtype=torch.int32, device=dev)[None, :]
    last = torch.gather(order, 1, torch.clamp(npg - 1, min=0)[:, None]
                        .long())
    pages = torch.where(slot < npg[:, None], order, last)
    pages = torch.where((npg == 0)[:, None], 0, pages)
    # per-slot ranges (empty on pad slots)
    pages_b = pages[:, None, :].expand(G, 8, n_pages).long()
    offs = torch.gather(off_pg[:, :, :-1], 2, pages_b)
    offe = torch.gather(off_pg[:, :, 1:], 2, pages_b)
    pad = (slot >= npg[:, None])[:, None, :]
    offs = torch.where(pad, 0, offs)
    offe = torch.where(pad, 0, offe)
    return pages, sent, sids, offs, offe


def ray_features(o, d, t_min, t_max):
    """(R, 16) f32 ray rows [o, 1, d, o x d, tmin, tmax, 1/d, pad] — the
    kernel's input layout (rays on rows, one 64-byte row per thread)."""
    R = o.shape[0]
    m = torch.linalg.cross(o, d, dim=-1)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20,
                              torch.where(d >= 0, 1e-20, -1e-20), d)
    ones = torch.ones((R, 1), dtype=o.dtype, device=o.device)
    tmin_c = torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32,
                                                device=o.device), (R,))[:, None]
    tmax_c = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                device=o.device), (R,))[:, None]
    f = torch.cat([o, ones, d, m, tmin_c, tmax_c, inv_d, torch.zeros_like(ones)],
                  dim=1).contiguous()
    return f, tmin_c, tmax_c


def kernel_inputs(scene, o, d, t_min, t_max):
    """The front of a resident launch: ray features and the per-warp
    super lists for rays in dispatch order (R a multiple of BLOCK).
    Returns (f (R, 16), sent (R/128, NSp) f32, sids (R/128, NSp) i32,
    tmax_c (R, 1))."""
    R = o.shape[0]
    if R % BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {BLOCK}")
    G = R // BLOCK
    f, tmin_c, tmax_c = ray_features(o, d, t_min, t_max)
    sent, sids = _cull_sorted_supers(o, d, tmin_c, tmax_c, scene.wk_sbox, G)
    nsp = sent.shape[-1]
    return f, sent.reshape(G * 8, nsp), sids.reshape(G * 8, nsp), tmax_c


def page_clusters() -> int:
    """Clusters per page (the JAX package's PAGE_CLUSTERS): PAGE_SUP
    supers, within the kernel's shared-memory page."""
    n = PAGE_SUP * SUP
    if not 0 < n <= MAX_PAGE_CLUSTERS:
        raise ValueError(f"PAGE_SUP {PAGE_SUP}: a page of {n} clusters is "
                         f"outside 1..{MAX_PAGE_CLUSTERS}")
    return n


def n_pages_of(scene) -> int:
    """Pages of the paged walk: the cluster slots in page_clusters()
    units."""
    return -(-scene.wk_cbox.shape[0] // page_clusters())


def paged_kernel_inputs(scene, o, d, t_min, t_max):
    """The front of a paged launch (R a multiple of BLOCK).  Returns
    (f (R, 16), sent/sids (R/128, NSp), pages (R/1024, S) i32,
    offs/offe (R/128, S) i32, tmax_c (R, 1))."""
    R = o.shape[0]
    if R % BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {BLOCK}")
    G = R // BLOCK
    f, tmin_c, tmax_c = ray_features(o, d, t_min, t_max)
    pages, sent, sids, offs, offe = _cull_paged(
        o, d, tmin_c, tmax_c, scene.wk_sbox, G, n_pages_of(scene))
    nsp, S = sent.shape[-1], pages.shape[-1]
    return (f, sent.reshape(G * 8, nsp), sids.reshape(G * 8, nsp),
            pages.contiguous(), offs.reshape(G * 8, S).contiguous(),
            offe.reshape(G * 8, S).contiguous(), tmax_c)


def traversal_kind(scene) -> str:
    """"paged" for a scene whose attribute table is >= 13 MiB, else
    "resident" — the JAX package's rule (enable_pallas_if_suitable)."""
    nbytes = scene.wk_attr.numel() * scene.wk_attr.element_size()
    return "paged" if nbytes >= PAGED_ATTR_BYTES else "resident"


# ------------------------------------------------------------ CUDA kernel

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA wave kernels cannot be built")


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build csrc/wave_trace.cu with nvcc (first use) and bind it."""
    from tungsten_tpu_torch._build import build_shared
    path = build_shared("wave_trace", ["csrc/wave_trace.cu"],
                        [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wave_trace_launch.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    lib.wave_trace_launch.restype = ci
    lib.wave_trace_paged_launch.argtypes = [vp] * 13 + [ci] * 6 + [vp]
    lib.wave_trace_paged_launch.restype = ci
    return lib


def _check(x, name, dtype, shape):
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernels take raw "
                         f"pointers, so traversal inputs are detached")
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(f, sent, sids, cbox, attr):
    """Checks shared by both walks; returns (R, nb, nsp, ncp)."""
    R = f.shape[0]
    if R % WARP:
        raise ValueError(f"ray count {R} is not a multiple of {WARP}")
    nb = R // WARP
    nsp = sent.shape[-1]
    ncp = cbox.shape[0]
    _check(f, "f", torch.float32, (R, FCOLS))
    _check(sent, "sent", torch.float32, (nb, nsp))
    _check(sids, "sids", torch.int32, (nb, nsp))
    _check(cbox, "cbox", torch.float32, (ncp, 8))
    _check(attr, "attr", torch.float32, (ncp * ATTR_ROWS, CLUSTER))
    return R, nb, nsp, ncp


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_splits(n_blocks: int, device) -> int:
    """CTAs per 128-ray block for a launch of n_blocks blocks on `device`:
    enough for CTAS_PER_SM CTAs on every SM, 1 to MAX_SPLITS."""
    sms = _sm_count(torch.device(device).index or 0)
    want = -(-CTAS_PER_SM * sms // max(n_blocks, 1))
    return max(1, min(MAX_SPLITS, want))


def _splits(splits, nb, device) -> int:
    if splits is None:
        return launch_splits(nb, device)
    if not 1 <= int(splits) <= 64:
        raise ValueError(f"splits {splits} outside 1..64")
    return int(splits)


def _outputs(f):
    """(t, tri, tests (2, R), words, done counts): the kernel outputs and
    one zero-filled buffer holding the tests, a 64-bit word per ray (the
    closest-hit key; the any-hit walks use its first R int32 as the
    occluded words) and a counter per block (the split walks' scratch)."""
    R = f.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=f.device)
    tri = torch.empty((R,), dtype=torch.int32, device=f.device)
    buf = torch.zeros((4 * R + R // WARP,), dtype=torch.int32,
                      device=f.device)
    return t, tri, buf[:2 * R].view(2, R), buf[2 * R:4 * R], buf[4 * R:]


def _launched(route, R, splits):
    LAUNCHES[route] += 1
    if LAUNCH_LOG is not None:
        LAUNCH_LOG.append((route, R, splits))


# the LAUNCHES entries a resident launch may count under, by mode
_RESIDENT_ROUTES = {False: ("closest", "paged_closest"),
                    True: ("anyhit", "paged_anyhit")}


def wave_kernel(f, sent, sids, cbox, attr, any_hit: bool, splits=None,
                route: str | None = None):
    """Launch a resident CUDA walk on the current stream: the closest-hit
    kernel (K1, K3's closest hit) or K2 (any hit, K3's any hit).

    f (R, 16) f32 ray features (R % 128 == 0); sent/sids (R/128, NSp) the
    entry-sorted warp lists (kernel_inputs); cbox (NCp, 8) f32; attr
    (NCp*16, 128) f32; splits: CTAs per block (None: launch_splits;
    every value gives the same t and tri, for any hit the same occluded
    flag); route: the LAUNCHES entry (None: "closest" or "anyhit"; the
    paged wrapper's "paged_closest" or "paged_anyhit").  Returns (t (R,)
    f32: closest hit the nearest hit, any hit -3e38 where the segment is
    occluded, else t_max clipped to 1e37; tri (R,) i32: closest hit
    cluster*128+slot or -1, any hit >= 0 exactly where occluded (a
    cluster*128 of some hit); tests (2, R) i32: per ray the ray-triangle
    tests it needs (row 0: the real triangles of the clusters whose slab
    accepts it with the best t its CTA knows, up to an any-hit ray's
    hit) and the tests its threads ran (row 1))."""
    route = route or _RESIDENT_ROUTES[any_hit][0]
    if route not in _RESIDENT_ROUTES[any_hit]:
        raise ValueError(f"route {route!r} for any_hit={any_hit}")
    R, nb, nsp, ncp = _check_common(f, sent, sids, cbox, attr)
    S = _splits(splits, nb, f.device)
    lib = load_kernels()
    t, tri, tests, words, done = _outputs(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.wave_trace_launch(
        f.data_ptr(), sent.data_ptr(), sids.data_ptr(), cbox.data_ptr(),
        attr.data_ptr(), t.data_ptr(), tri.data_ptr(), tests.data_ptr(),
        words.data_ptr(), done.data_ptr(), nb, nsp, ncp // SUP,
        int(any_hit), S, stream)
    if err != 0:
        raise RuntimeError(f"wave_trace {'any' if any_hit else 'closest'}"
                           f"-hit kernel launch failed: CUDA error {err}")
    _launched(route, R, S)
    return t, tri, tests


def paged_anyhit_kernel(f, sent, sids, pages, offs, offe, cbox, attr,
                        splits=None):
    """Launch the paged any-hit CUDA walk on the current stream, counted
    as "paged_walk".  No wrapper launches it (wave_intersect_paged's any
    hit runs wave_kernel on the resident front, the faster wrapper on a
    large scene); chip_smoke.py and the card tests hold it to K2 and to
    list_walk on the paged front.

    As wave_kernel's any hit, with the paged front's (page, entry)-sorted
    sent/sids, pages (R/1024, S) i32 and offs/offe (R/128, S) i32 (R %
    1024 == 0); the walk reads PAGE_SUP at the call; splits divides each
    block's page slots.  Returns (t: -3e38 where the segment is occluded,
    else t_max clipped to 1e37; tri: >= 0 exactly where occluded, a
    cluster*128 of some hit; tests as wave_kernel's, row 0 up to the
    ray's hit)."""
    R, nb, nsp, ncp = _check_common(f, sent, sids, cbox, attr)
    if R % BLOCK:
        raise ValueError(f"ray count {R} is not a multiple of {BLOCK}")
    S = pages.shape[-1]
    _check(pages, "pages", torch.int32, (R // BLOCK, S))
    _check(offs, "offs", torch.int32, (nb, S))
    _check(offe, "offe", torch.int32, (nb, S))
    page_clusters()
    n_splits = _splits(splits, nb, f.device)
    lib = load_kernels()
    t, tri, tests, words, done = _outputs(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.wave_trace_paged_launch(
        f.data_ptr(), sent.data_ptr(), sids.data_ptr(), pages.data_ptr(),
        offs.data_ptr(), offe.data_ptr(), cbox.data_ptr(), attr.data_ptr(),
        t.data_ptr(), tri.data_ptr(), tests.data_ptr(), words.data_ptr(),
        done.data_ptr(), nb, nsp, S, ncp, PAGE_SUP, n_splits, stream)
    if err != 0:
        raise RuntimeError(f"wave_trace paged any-hit kernel launch failed: "
                           f"CUDA error {err}")
    _launched("paged_walk", R, n_splits)
    return t, tri, tests


# ------------------------------------------------------ the plain schedule

def _slab16(x, box, tb):
    """The kernels' slab test (slab16): rays x (V, 128, 16) against
    boxes (V, 16, 8) with best t tb (V, 128); (V, 128, 16) bool."""
    o = x[..., None, 0:3]
    inv = x[..., None, 12:15]
    t0 = (box[:, None, :, 0:3] - o) * inv
    t1 = (box[:, None, :, 3:6] - o) * inv
    lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tn = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]),
                    torch.fmax(lo[..., 2], x[..., None, 10]))
    tf = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]),
                    torch.fmin(hi[..., 2], tb[..., None]))
    fudge = torch.tensor(1.00000024, dtype=torch.float32, device=x.device)
    return (tn <= tf * fudge) & (box[:, None, :, 6] > 0.0)


def _leaf(x, a):
    """The kernels' leaf (leaf_test, leaf_inside) for rays x (P, 16)
    against clusters a (P, 16, 128): (inside (P, 128) bool, ad, tn)."""
    c = [x[:, i:i + 1] for i in range(FCOLS)]
    r = [a[:, i] for i in range(ATTR_ROWS)]
    det = -(c[4] * r[12] + c[5] * r[13] + c[6] * r[14])
    udet = (c[4] * r[0] + c[5] * r[1] + c[6] * r[2] + c[7] * r[3] +
            c[8] * r[4] + c[9] * r[5])
    vdet = (c[4] * r[6] + c[5] * r[7] + c[6] * r[8] + c[7] * r[9] +
            c[8] * r[10] + c[9] * r[11])
    tdet = c[0] * r[12] + c[1] * r[13] + c[2] * r[14] + r[15]
    sg = torch.where(det >= 0.0, 1.0, -1.0)
    ad, un, vn, tn = det * sg, udet * sg, vdet * sg, tdet * sg
    inside = (un >= 0.0) & (vn >= 0.0) & (un + vn <= ad) & \
        (tn > c[10] * ad) & (ad > 1e-16)
    return inside, ad, tn


def list_walk(f, sent, sids, cbox, attr, any_hit: bool):
    """The kernels' schedule in plain PyTorch, one CTA a block: the
    serial walk that wave_kernel (both modes) computes on the resident
    front, and paged_anyhit_kernel on the paged one.

    Per 128-ray block the list (sent, sids) in order: entry k is visited
    iff sent[k] <= the block's largest best t over its live rays (any
    hit: those not yet occluded), which is the resident walk's stop and
    the paged walk's per-slot stop alike.  Each such ray slab-tests the
    super's 16 clusters with its own best t (the 1.00000024 fudge) and
    tests the triangles of the clusters it accepts with the kernels'
    leaf.  Closest hit keeps per ray the least (t, walk position,
    cluster, slot) among t < t_max, i.e. strict t < best with ties to
    the earliest in walk order; any hit stops a ray at its first hit in
    (cluster, slot) order.  Vectorised over blocks, a loop over list
    positions; only tests and chip_smoke.py use it.

    Returns (t (R,) f32, tri (R,) i32, needed (R,) i32) as the kernels
    return t, tri and tests[0] at splits=1 (for any hit, tri is the
    first hit cluster's cluster*128)."""
    R = f.shape[0]
    nb, nsp, ncp = R // WARP, sent.shape[-1], cbox.shape[0]
    dev = f.device
    x = f.reshape(nb, WARP, FCOLS)
    tmax = torch.clamp(x[..., 11], max=1e37)
    live = tmax > 0.0
    rows = attr.reshape(ncp, ATTR_ROWS, CLUSTER)
    n_real = (rows[:, 12:15] != 0.0).any(dim=1).sum(dim=1,
                                                  dtype=torch.int32)
    best_t = tmax.clone().reshape(R)     # any hit: t_max until occluded
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    needed = torch.zeros((R,), dtype=torch.int32, device=dev)
    lanes = torch.arange(SUP, device=dev)
    for k in range(nsp):
        still = live & (tri.reshape(nb, WARP) < 0) if any_hit else live
        bound = torch.where(still, best_t.reshape(nb, WARP),
                            -INF).amax(dim=1)
        blocks = torch.nonzero(sent[:, k] <= bound)[:, 0]
        if blocks.numel() == 0:
            continue
        sid = torch.clamp(sids[blocks, k], max=ncp // SUP - 1).long()
        cid = sid[:, None] * SUP + lanes                       # (V, 16)
        xv = x[blocks]
        acc = _slab16(xv, cbox[cid], best_t.reshape(nb, WARP)[blocks]) & \
            still[blocks][..., None]
        v_i, r_i, c_i = torch.nonzero(acc, as_tuple=True)
        if v_i.numel() == 0:
            continue
        ray = blocks[v_i] * WARP + r_i
        pc = cid[v_i, c_i]
        inside, ad, tn = _leaf(xv[v_i, r_i], rows[pc])
        tmax_p = tmax.reshape(R)[ray][:, None]
        if any_hit:
            hit = inside & (tn < tmax_p * ad)
            has = hit.any(dim=1)
            first = torch.argmax(hit.to(torch.int32), dim=1)
            c_hit = torch.full((R,), SUP, dtype=torch.int64, device=dev)
            c_hit.scatter_reduce_(0, ray, torch.where(has, c_i, SUP),
                                  "amin")
            cf = c_hit[ray]
            needed.index_add_(0, ray, torch.where(
                c_i < cf, n_real[pc],
                torch.where(c_i == cf, first.to(torch.int32) + 1, 0)))
            stop = has & (c_i == cf)
            tri[ray[stop]] = (pc[stop] * CLUSTER).to(torch.int32)
            continue
        needed.index_add_(0, ray, n_real[pc])
        tc = tn / torch.clamp(ad, min=1e-30)
        cand = inside & (tc < tmax_p)
        tp, slot = torch.where(cand, tc, INF).min(dim=1)
        # per ray the least (t, cluster, slot) of this position, taken if
        # its t beats the best so far: an equal t found at an earlier
        # position keeps winning
        t_new = torch.full((R,), INF, dtype=torch.float32, device=dev)
        t_new.scatter_reduce_(0, ray, tp, "amin")
        at_min = cand.any(dim=1) & (tp == t_new[ray])
        key = torch.where(at_min, pc * CLUSTER + slot, ncp * CLUSTER)
        key_new = torch.full((R,), ncp * CLUSTER, dtype=torch.int64,
                             device=dev)
        key_new.scatter_reduce_(0, ray, key, "amin")
        win = at_min & (key == key_new[ray]) & (tp < best_t[ray])
        best_t[ray[win]] = tp[win]
        tri[ray[win]] = key[win].to(torch.int32)
    if any_hit:
        return torch.where(tri >= 0, -INF, tmax.reshape(R)), tri, needed
    return best_t, tri, needed


def _rays_on(o, device):
    """The device the caller asked for, which must be the rays' device."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if o.device.type != dev.type:
        raise ValueError(f"rays live on {o.device}, asked for {dev}")
    return dev


def _finish(scene, o, d, t, tri, tmax_c, any_hit):
    """Kernel output -> (t, tri, u, v): cluster slots remapped to
    FlatScene triangle ids, misses (and every any-hit lane) at their
    t_max, closest hits refined by one f32 Moller-Trumbore."""
    R = o.shape[0]
    hit_ok = t <= -1.0 if any_hit else tri >= 0
    tri = torch.where(
        hit_ok,
        scene.wk_remap[torch.clamp(tri, 0, scene.wk_remap.shape[0] - 1).long()],
        -1)
    u = torch.zeros((R,), dtype=torch.float32, device=o.device)
    v = torch.zeros_like(u)
    t = tmax_c[:, 0] if any_hit else torch.where(hit_ok, t, tmax_c[:, 0])
    if not any_hit and scene.tri_v0.shape[0] > 0:
        # winner finalize: one full-f32 Moller-Trumbore per hit ray from
        # one packed (T, 9) [v0|e1|e2] row; misses tap row 0
        from tungsten_tpu_torch.ops.intersect import ray_tri
        rows_f = scene.tri_fin[torch.clamp(tri, 0,
                                           scene.tri_v0.shape[0] - 1).long()]
        _, tf, uf, vf = ray_tri(o, d, rows_f[:, 0:3], rows_f[:, 3:6],
                                rows_f[:, 6:9], -INF, INF)
        fine = hit_ok & torch.isfinite(tf)
        t = torch.where(fine, tf, t)
        u = torch.where(fine, uf, u)
        v = torch.where(fine, vf, v)
    return t, tri, u, v


def _intersect(scene, o, d, t_min, t_max, any_hit, device, route):
    """Either wrapper's body: the plain walk on CPU tensors, else the
    resident front, the resident kernel counted under `route`, remap and
    finalize."""
    _rays_on(o, device)
    if not o.is_cuda:
        from tungsten_tpu_torch.ops.intersect import bvh_walk
        return bvh_walk(scene, o, d, t_min, t_max, any_hit)
    f, sent, sids, tmax_c = kernel_inputs(scene, o, d, t_min, t_max)
    t, tri, _ = wave_kernel(f, sent, sids, scene.wk_cbox, scene.wk_attr,
                            any_hit, route=route)
    return _finish(scene, o, d, t, tri, tmax_c, any_hit)


def wave_intersect(scene, o, d, t_min, t_max, any_hit: bool = False,
                   device=None):
    """Closest-hit (or any-hit) triangle traversal through the resident
    walk.  o/d (R,3).

    Returns (t, tri, u, v); tri is a FlatScene triangle id, -1 on miss;
    t is t_max on a miss.  For any_hit only `tri >= 0` is meaningful.
    CUDA tensors launch the kernel (R must be a multiple of 1024, as the
    dispatch pads it); CPU tensors run the plain version.  `device`
    (None = CUDA, raising when absent) must be the device the rays live
    on."""
    return _intersect(scene, o, d, t_min, t_max, any_hit, device,
                      "anyhit" if any_hit else "closest")


def wave_intersect_paged(scene, o, d, t_min, t_max, any_hit: bool = False,
                         device=None):
    """The same traversal for scenes whose attribute table is >= 13 MiB
    (the JAX package's wave_intersect_paged): the resident kernels on the
    resident front, counted as "paged_closest" / "paged_anyhit" (see the
    module docstring).  Same arguments and results as wave_intersect;
    CPU tensors run the plain version."""
    return _intersect(scene, o, d, t_min, t_max, any_hit, device,
                      "paged_anyhit" if any_hit else "paged_closest")
