"""The CUDA wave kernels on the card (marked `cuda`; they skip without a
CUDA device).  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On the random-soup fixture of tests/test_wave.py (700 triangles, 2048
rays; regenerated here with numpy) both kernel modes pass that file's
gates against the f32 brute force and against the plain walk on the same
device, and a small render through the kernels matches the plain path.
The paged wrapper (the resident kernels on the resident front) passes
the same gates on the 5,000-triangle soup of tests/test_paged.py with
the page shrunk to one super, and the paged any-hit walk (no wrapper
launches it) agrees with K2 ray for ray.  The closest-hit kernel, K2
and the paged any-hit walk agree with list_walk (their schedule in
plain PyTorch) on the same rays, also where coherent bundles spread
each block over several pages and where zero-area triangles sit inside
clusters before real ones; their launches split over 1, 2, 8 or the
launcher's count of CTAs a block, and two launches, are bitwise equal,
and a block with a few live rays among dead ones gives them their full
block's results.
The tensor-core leaf kernel (K4, K5: csrc/leaf_mma.cu) agrees with its
plain versions on seeded random bf16 inputs and exactly on the TPU
tool's all-ones inputs at every shape of the tool, and a launch held to
one block equals the full grid bitwise; the CLI renders a tiny scene
file through the wave kernels.  The closest-hit kernel honours each
ray's near limit on mostly dead waves of rays that start on a triangle
(the generalized shadow ray's hops, t_min = EPSILON), and a small scene
with fog, a voxel medium and forward-lobe surfaces renders through K1
alone as the plain path renders it on the CPU.  With analytic spheres in
the soup, the closest-hit kernel takes each ray's far limit from the
analytic hit and K2 the simple NEE's shadow segments (far limit
dist * SHADOW_FUDGE), both against the f32 brute force; and a small
scene of analytic prims with cap, point and skydome lights under a
thinlens camera renders through K1 and K2 as the plain path renders it.
The curve-piece walk C1 (csrc/curve_trace.cu) agrees with the plain
curve walk on a scene of all four curve modes in closest and any hit,
gives the live rays of a mostly dead wave their own results bitwise, both
with 1, 2 and 4 lanes a ray, gives a 1,024-ray slice the same results
bitwise at every group size and inside a full-width launch, refuses a bad
group size or stack, keeps the lower piece of coincident strands as the
plain walk does, restarts on a piece BVH deeper than its stack with the
same results at every group size and stack, and
a small curve scene with the fiber BCSDFs renders through C1, K1 and K2
as the plain path renders it.  Path-replay gradients on the card launch
K1 and K2 in the forward and in the backward, end on the forward's L
bitwise and agree with the plain path's on the CPU; a train step on a
one-rank NCCL group gives the replay's loss and gradients.  A BDPT wave
on the card (walks on K1, connections on K2) agrees with the plain path
on the CPU lane for lane, and BDPT and light-tracer renders, and a BDPT
render of fog, forward-lobe surfaces and a thinlens camera through K1
alone, match the plain path's images.  The photon pass on the card (K1)
agrees with the plain path's slot for slot, the photon, beam and plane
grids built on the card are the CPU's bitwise, the k nearest photons
are selected bitwise and the four gathers agree; photon-map and PPM
renders of the surface map and the three volume maps (K2 in planes
mode) match the plain path's images.  MLT tape traces of 4,096 chains,
sorted and compacted on the card, give each lane its own chain's result
(the CPU's lane for lane, the reversible-jump inversions too), and
kelemen, reversible-jump and multiplexed renders match the CPU's means.
The ordered sums S1 (csrc/segment_sum.cu) equal their plain version on
the CPU bitwise on unsorted, keyed, sorted and unique ids, the scan entry
equals torch.cumsum on the CPU bitwise (its backward too), the path
tracer, BDPT and the light tracer render the same frame twice bit for
bit, and path-replay gradients repeat bit for bit.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import intersect as tis
from tungsten_tpu_torch.ops import wave_trace as twt
from tungsten_tpu_torch.scene.bvh import build_bvh


def _soup(num_tris=700, seed=3):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (num_tris, 3)).astype(np.float32) * 2
    e1 = rng.normal(size=(num_tris, 3)).astype(np.float32) * 0.3
    e2 = rng.normal(size=(num_tris, 3)).astype(np.float32) * 0.3
    return v0, e1, e2


def _rays(R, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _brute(v0, e1, e2, o, d, t_min, t_max):
    """t_min: a scalar or (R,) per ray."""
    t_min = np.asarray(t_min, np.float32)
    if t_min.ndim == 1:
        t_min = t_min[:, None]
    return _brute_t(v0, e1, e2, o, d, t_min, t_max)


def _brute_t(v0, e1, e2, o, d, t_min, t_max):
    """f32 Moller-Trumbore against every triangle: (t, tri, u, v)."""
    pv = np.cross(d[:, None, :], e2[None])
    det = np.sum(e1[None] * pv, -1)
    inv = np.where(np.abs(det) > 1e-16, 1 / det, 0)
    tv = o[:, None, :] - v0[None]
    uu = np.sum(tv * pv, -1) * inv
    qv = np.cross(tv, e1[None])
    vv = np.sum(d[:, None, :] * qv, -1) * inv
    tt = np.sum(e2[None] * qv, -1) * inv
    hit = ((np.abs(det) > 1e-16) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
           & (tt > t_min) & (tt < t_max[:, None]))
    tc = np.where(hit, tt, 3e38)
    bt = tc.min(1)
    bi = np.where(bt < 3e38, tc.argmin(1), -1)
    return bt, bi, uu, vv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wave kernels are CUDA-only)")
    return torch.device("cuda")


def _scene(v0, e1, e2, dev):
    """What the traversal reads, in BVH leaf order (`order` maps a leaf id
    back to the soup id)."""
    v1, v2 = v0 + e1, v0 + e2
    lo = np.minimum(v0, np.minimum(v1, v2))
    hi = np.maximum(v0, np.maximum(v1, v2))
    bvh = build_bvh(lo, hi)
    o = bvh.order
    sv0, se1, se2 = v0[o], e1[o], e2[o]
    boxes, cbox, attr, remap, sbox = twt.build_wave_tables(sv0, se1, se2)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return SimpleNamespace(
        tri_v0=t(sv0), tri_e1=t(se1), tri_e2=t(se2),
        tri_fin=t(np.concatenate([sv0, se1, se2], axis=1)),
        bvh_min=t(bvh.bounds_min), bvh_max=t(bvh.bounds_max),
        bvh_meta=t(bvh.meta), bvh_skip=t(bvh.skip), wk_boxes=t(boxes),
        wk_cbox=t(cbox), wk_attr=t(attr), wk_remap=t(remap), wk_sbox=t(sbox),
        geo_lo=t(lo.min(0)), geo_hi=t(hi.max(0)),
        sph_center=t(np.zeros((0, 3), np.float32)),
        sph_radius=t(np.zeros((0,), np.float32)),
        crv_pc_q0=t(np.zeros((0, 4), np.float32))), o


def _hits(fn, sc, order, o, d, tmin, tmax, any_hit):
    dev = sc.tri_v0.device
    t, tri, u, v = fn(sc, *(torch.from_numpy(x).to(dev)
                            for x in (o, d, tmin, tmax)), any_hit=any_hit)
    tri = tri.cpu().numpy()
    tri = np.where(tri >= 0, order[np.clip(tri, 0, None)], -1)
    return t.cpu().numpy(), tri, u.cpu().numpy(), v.cpu().numpy()


def _gates(t, tri, u, v, bt, bi, uu, vv, live):
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


@pytest.mark.cuda
def test_cuda_kernels_pass_wave_gates(cuda_device):
    v0, e1, e2 = _soup()
    R = 2 * twt.BLOCK
    o, d = _rays(R)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::7] = 0.0   # dead rays must never hit
    live = tmax > 0
    sc, order = _scene(v0, e1, e2, cuda_device)
    before = dict(twt.LAUNCHES)
    t, tri, u, v = _hits(twt.wave_intersect, sc, order, o, d, tmin, tmax,
                         False)
    assert twt.LAUNCHES["closest"] == before["closest"] + 1
    bt, bi, uu, vv = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, bt, bi, uu, vv, live)
    pt, pi, _, _ = _hits(tis.bvh_walk, sc, order, o, d, tmin, tmax, False)
    _gates(t, tri, u, v, pt, pi, uu, vv, live)
    # the kernel path is deterministic
    again = _hits(twt.wave_intersect, sc, order, o, d, tmin, tmax, False)
    assert all(np.array_equal(a, b) for a, b in zip((t, tri, u, v), again))

    tmax_b = np.where(live, np.float32(1.25), np.float32(0.0))
    _, tri_a, _, _ = _hits(twt.wave_intersect, sc, order, o, d, tmin, tmax_b,
                           True)
    assert twt.LAUNCHES["anyhit"] == before["anyhit"] + 1
    _, tri_c, _, _ = _hits(twt.wave_intersect, sc, order, o, d, tmin, tmax_b,
                           False)
    _, bi_b, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax_b)
    assert ((tri_a >= 0) == (bi_b >= 0))[live].mean() > 0.998
    assert ((tri_a >= 0) == (tri_c >= 0)).all()
    assert (tri_a[~live] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_counts_tests(cuda_device, any_hit):
    """Per ray, the tests the data needs are at most the tests the thread
    ran, dead rays need none, and a hit needs at least one."""
    v0, e1, e2 = _soup()
    R = 2 * twt.BLOCK
    o, d = _rays(R)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::7] = 0.0
    sc, _ = _scene(v0, e1, e2, cuda_device)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (o, d, np.full((R,), 1e-4, np.float32), tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    f, sent, sids, _ = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)
    t, tri, tests = twt.wave_kernel(f, sent, sids, sc.wk_cbox, sc.wk_attr,
                                    any_hit)
    need, ran = tests[0].cpu().numpy(), tests[1].cpu().numpy()
    live = (tmax_s > 0).cpu().numpy()
    assert (need <= ran).all() and (need >= 0).all()
    assert (need[~live] == 0).all() and (ran[~live] == 0).all()
    assert (need[(tri >= 0).cpu().numpy()] >= 1).all()
    assert need.sum() > 0


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    f = torch.zeros((128, twt.FCOLS), device=cuda_device)
    lists = torch.zeros((1, 128), device=cuda_device)
    cbox = torch.zeros((128, 8), device=cuda_device)
    attr = torch.zeros((128 * twt.ATTR_ROWS, twt.CLUSTER),
                       device=cuda_device)
    with pytest.raises(ValueError, match="sids"):
        twt.wave_kernel(f, lists, lists, cbox, attr, False)   # f32 ids
    with pytest.raises(ValueError, match="CUDA"):
        twt.wave_kernel(f.cpu(), lists, lists.int(), cbox, attr, False)


@pytest.mark.cuda
def test_cuda_render_matches_plain_path(cuda_device):
    """A small lambert + mirror render through the kernels agrees with the
    plain path on the CPU, and both kernel modes launched."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    desc = SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
               {"type": "mirror", "albedo": 1.0}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 1,
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf_index": 0,
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.8}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, 1, -3], "scale": [10, 1, 10],
                           "rotation": [90, 0, 0]}}],
        media=[], camera={"type": "pinhole", "resolution": [48, 32],
                          "fov": 60,
                          "transform": {"position": [0, 0.6, 4.0],
                                        "look_at": [0, 0.0, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 4})
    scene, settings = flatten_scene(desc)
    before = dict(twt.LAUNCHES)
    gpu = render(scene, settings, spp=4, seed=7, spp_chunk=4)
    assert twt.traversal_kind(scene) == "resident"
    assert all(twt.LAUNCHES[k] > before[k] for k in ("closest", "anyhit"))
    assert all(twt.LAUNCHES[k] == before[k]
               for k in ("paged_closest", "paged_anyhit", "paged_walk"))
    cpu = render(scene.to("cpu"), settings, spp=4, seed=7, spp_chunk=4,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3

    # the same scene through the paged wrapper (the threshold lowered to
    # 0 and a page of one super): only its routes count launches (the
    # resident kernels; the paged any-hit walk never runs), and the image
    # is the resident path's up to traversal-order ties
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twt, "PAGED_ATTR_BYTES", 0)
        mp.setattr(twt, "PAGE_SUP", 1)
        before = dict(twt.LAUNCHES)
        paged = render(scene, settings, spp=4, seed=7, spp_chunk=4)
        assert all(twt.LAUNCHES[k] > before[k]
                   for k in ("paged_closest", "paged_anyhit"))
        assert all(twt.LAUNCHES[k] == before[k]
                   for k in ("closest", "anyhit", "paged_walk"))
    close = np.isclose(paged, gpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    assert abs(paged.mean() / gpu.mean() - 1.0) <= 5e-3


@pytest.fixture
def one_super_pages(monkeypatch):
    monkeypatch.setattr(twt, "PAGE_SUP", 1)


@pytest.mark.cuda
def test_cuda_paged_kernel_passes_wave_gates(cuda_device, one_super_pages):
    """The paged wrapper over several pages: test_wave.py's gates against
    the brute force and the plain walk, closest hit and any hit (both the
    resident kernels on the resident front); the paged any-hit walk's
    occluded set equals K2's on the same rays, and the closest hit
    equals list_walk's, the triangle too except where the two t are
    equal (ties)."""
    v0, e1, e2 = _soup(num_tris=5000, seed=5)
    R = 2 * twt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::5] = 0.0
    live = tmax > 0
    sc, order = _scene(v0, e1, e2, cuda_device)
    assert twt.n_pages_of(sc) >= 3
    before = dict(twt.LAUNCHES)
    t, tri, u, v = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin,
                         tmax, False)
    assert twt.LAUNCHES["paged_closest"] == before["paged_closest"] + 1
    bt, bi, uu, vv = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, bt, bi, uu, vv, live)
    pt, pi, _, _ = _hits(tis.bvh_walk, sc, order, o, d, tmin, tmax, False)
    _gates(t, tri, u, v, pt, pi, uu, vv, live)
    again = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin, tmax,
                  False)
    assert all(np.array_equal(a, b) for a, b in zip((t, tri, u, v), again))

    # raw kernel outputs: the paged any-hit walk against K2 on the same
    # rays, the closest hit (the resident kernel on the resident front)
    # against list_walk
    args = [torch.from_numpy(x).to(cuda_device) for x in (o, d, tmin, tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    f, sent, sids, pages, offs, offe, _ = twt.paged_kernel_inputs(
        sc, o_s, d_s, tmin_s, tmax_s)
    f1, sent1, sids1, _ = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)
    assert torch.equal(f, f1)
    t3, tri3, tests3 = twt.paged_anyhit_kernel(f, sent, sids, pages, offs,
                                               offe, sc.wk_cbox, sc.wk_attr)
    t1, tri1, _ = twt.wave_kernel(f1, sent1, sids1, sc.wk_cbox, sc.wk_attr,
                                  True)
    assert torch.equal(tri3 >= 0, tri1 >= 0)
    assert torch.equal(t3 <= -1.0, tri3 >= 0)
    t3, tri3, tests3c = twt.wave_kernel(f1, sent1, sids1, sc.wk_cbox,
                                        sc.wk_attr, False,
                                        route="paged_closest")
    lt, ltri, _ = twt.list_walk(f1, sent1, sids1, sc.wk_cbox, sc.wk_attr,
                                False)
    assert torch.equal(tri3 >= 0, ltri >= 0)
    assert bool(((tri3 == ltri) | torch.isclose(t3, lt, rtol=1e-6,
                                                atol=0)).all())
    assert bool((tri3 == ltri).float().mean() > 0.999)
    for tests in (tests3, tests3c):
        need, ran = tests[0], tests[1]
        assert bool((need <= ran).all()) and int(need.sum()) > 0
        assert bool((ran[tmax_s <= 0] == 0).all())

    tmax_b = np.where(live, np.float32(1.25), np.float32(0.0))
    _, tri_a, _, _ = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin,
                           tmax_b, True)
    assert twt.LAUNCHES["paged_anyhit"] == before["paged_anyhit"] + 1
    assert twt.LAUNCHES["paged_walk"] == before["paged_walk"] + 1
    assert twt.LAUNCHES["paged_closest"] == before["paged_closest"] + 3
    _, bi_b, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax_b)
    assert ((tri_a >= 0) == (bi_b >= 0))[live].mean() > 0.998
    _, tri_k2, _, _ = _hits(twt.wave_intersect, sc, order, o, d, tmin,
                            tmax_b, True)
    assert np.array_equal(tri_a >= 0, tri_k2 >= 0)
    assert (tri_a[~live] == -1).all()


def _bf16(rng, shape, dev):
    """Seeded uniform [-1, 1) values, rounded to bf16 on the device."""
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)


def _close_to_plain(got, want, iters):
    """The leaf kernel's (row, checksum, last product) against its plain
    version's.  bf16 products are exact in f32; the sums differ only in
    order: the last product within 1e-5 of its l1 scale per element, the
    row sums within 1e-5 * iters of theirs, the f64 checksum within 1e-6
    of the l1 norm of everything it adds up."""
    row, cs, last = got
    prow, pcs, plast = want
    scale = plast.abs().amax().item() + 1.0
    assert torch.allclose(last, plast, rtol=0, atol=1e-5 * scale)
    assert torch.allclose(row, prow, rtol=0, atol=1e-5 * iters * scale)
    l1 = plast.abs().sum().item() * iters
    assert abs(cs.item() - pcs.item()) <= 1e-6 * l1 + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_cuda_leaf_variants_match_plain(cuda_device, variant):
    """K5 on seeded random bf16 inputs (the tables at their full width,
    70 iterations so the slice index wraps) against the plain version;
    on the tool's all-ones inputs, row and checksum exactly equal."""
    from tungsten_tpu_torch.tools import mxubench as mxb
    rng = np.random.default_rng(21)
    a = _bf16(rng, (mxb.K_LEAF, mxb.N_LEAF), cuda_device)
    rows = mxb.TABLE_ROWS[variant]
    tbl = _bf16(rng, (rows, mxb.NCP * 512), cuda_device) if rows else None
    before = dict(mxb.LAUNCHES)
    got = mxb.leaf_variant(variant, a, tbl, iters=70, full=True)
    assert mxb.LAUNCHES[f"leaf_variant_{variant}"] == \
        before[f"leaf_variant_{variant}"] + 1
    _close_to_plain(got, mxb.leaf_variant_plain(variant, a, tbl, 70), 70)
    a1, t1 = mxb.ones_inputs(mxb.K_LEAF, mxb.N_LEAF, cuda_device, rows)
    row, cs, _ = mxb.leaf_variant(variant, a1, t1)
    prow, pcs, _ = mxb.leaf_variant_plain(variant, a1, t1)
    assert torch.equal(row, prow) and cs.item() == pcs.item()
    assert cs.item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(128, 48, 128), (512, 16, 128),
                                   (512, 128, 128), (256, 48, 256),
                                   (2048, 48, 128)])
def test_cuda_leaf_product_layout(cuda_device, M, K, N):
    """The kernel's product at the K4 shapes on a full random B (staged
    from a table, as kB stages it) against numpy: every element of the
    last product, row 0 and the checksum.  K4 itself multiplies a zero
    scratch or the store chain's few rows, which would hide a fragment
    indexing mistake."""
    from tungsten_tpu_torch.tools import mxubench as mxb
    rng = np.random.default_rng(M + K + N)
    a = _bf16(rng, (K, N), cuda_device)
    tbl = _bf16(rng, (K, 3 * mxb.TBL_STEP), cuda_device)
    p = mxb.make_params(M, N, K, K, 3, mxb._k_steps(None, K),
                        tbl_ld=tbl.shape[1])
    got = mxb.leaf_kernel("mma_loop", a, p, tbl, full=True)
    af = a.float().cpu().numpy().astype(np.float64)
    tf = tbl.float().cpu().numpy().astype(np.float64)
    prods = [tf[:, i * mxb.TBL_STEP:i * mxb.TBL_STEP + M].T @ af
             for i in range(3)]
    want = (torch.from_numpy(sum(x[0:1] for x in prods)).float(),
            torch.tensor(sum(x.sum() for x in prods), dtype=torch.float64),
            torch.from_numpy(prods[-1]).float())
    _close_to_plain(tuple(x.cpu() for x in got), want, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,stores", [(512, 48, 128, False),
                                          (512, 48, 128, True),
                                          (1024, 48, 128, True),
                                          (512, 16, 128, True),
                                          (128, 48, 128, True),
                                          (256, 48, 128, False),
                                          (512, 128, 128, True),
                                          (512, 48, 256, False),
                                          (2048, 48, 128, False)])
def test_cuda_mma_loop_matches_plain(cuda_device, M, K, N, stores):
    """K4 against its plain version at every shape of the TPU tool, from
    4 blocks (M 128) to 64 (M 2048): random inputs (the scratch started
    random too, since its zeros would hide the product) within the
    stated tolerance over the whole last product, the tool's all-ones
    inputs exactly."""
    from tungsten_tpu_torch.tools import mxubench as mxb
    rng = np.random.default_rng(5)
    a = _bf16(rng, (K, N), cuda_device)
    b0 = _bf16(rng, (K, M), cuda_device)
    got = mxb.mma_loop(a, M, iters=9, with_stores=stores, full=True, b0=b0)
    want = mxb.mma_loop_plain(a, M, 9, stores, b0)
    assert want[2].abs().amax().item() > 1.0
    _close_to_plain(got, want, 9)
    a1, _ = mxb.ones_inputs(K, N, cuda_device)
    row, cs, _ = mxb.mma_loop(a1, M, with_stores=stores)
    prow, pcs, _ = mxb.mma_loop_plain(a1, M, mxb.LOOP_ITERS, stores)
    assert torch.equal(row, prow) and cs.item() == pcs.item()
    assert (cs.item() > 0) == stores


@pytest.mark.cuda
def test_cuda_cli_renders_a_tiny_scene(cuda_device, tmp_path):
    """The CLI on the card: a 32x24 scene file with output buffers and
    more than 16 spp, adaptive sampling left on (so render_adaptive runs
    for the main image and the buffers come from the AOV wavefront);
    both wave kernel modes launch, every file it writes loads."""
    import json
    from tungsten_tpu_torch import cli
    from tungsten_tpu_torch.io import image as im
    scene = {
        "bsdfs": [{"name": "d", "type": "lambert", "albedo": [0.6, 0.3, 0.2]},
                  {"name": "m", "type": "mirror", "albedo": 1.0}],
        "primitives": [
            {"type": "quad", "bsdf": "d", "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf": "m",
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf": "d",
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.8}}],
        "camera": {"type": "pinhole", "resolution": [32, 24], "fov": 60,
                   "transform": {"position": [0, 0.6, 4.0],
                                 "look_at": [0, 0, 0]}},
        "integrator": {"max_bounces": 8},
        "renderer": {"spp": 24, "spp_step": 8, "output_file": "tiny.png",
                     "hdr_output_file": "tiny.pfm"}}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(scene))
    args = cli.build_parser().parse_args([str(path)])
    assert args.device == "cuda"
    before = dict(twt.LAUNCHES)
    res = cli.render_scene(str(path), args)
    assert res["spp"] == 24 and res["rays"] > 0
    assert all(twt.LAUNCHES[k] > before[k] for k in ("closest", "anyhit"))
    hdr = im.load_hdr(str(tmp_path / "tiny.pfm"))
    assert hdr.shape == (24, 32, 3) and np.isfinite(hdr).all()
    assert hdr.mean() > 0
    with open(tmp_path / "tiny.png", "rb") as f:
        assert im.decode_png(f.read()).shape == (24, 32, 3)
    scene["renderer"] = {"spp": 4, "output_buffers": [
        {"type": t, "hdr_output_file": f"{t}.pfm"}
        for t in ("color", "depth", "normal", "albedo", "visibility")]}
    path.write_text(json.dumps(scene))
    res = cli.render_scene(str(path), args)
    assert len(res["files"]) == 6
    for fn in res["files"][1:]:
        img = im.load_hdr(fn)
        assert img.shape == (24, 32, 3) and np.isfinite(img).all(), fn


@pytest.mark.cuda
def test_cuda_leaf_rejects_bad_inputs(cuda_device):
    from tungsten_tpu_torch.tools import mxubench as mxb
    a = torch.ones((48, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        mxb.mma_loop(a.float(), 512)
    with pytest.raises(ValueError, match="slices"):
        mxb.leaf_variant("b", a, torch.ones((48, 4096), dtype=torch.bfloat16,
                                            device=cuda_device))
    p = mxb.make_params(200, 128, 48, 48, 1, mxb._k_steps(None, 48))
    with pytest.raises(RuntimeError, match="launch failed"):
        mxb.leaf_kernel("mma_loop", a, p)     # M not a multiple of 16


@pytest.mark.cuda
def test_cuda_paged_wrapper_rejects_bad_inputs(cuda_device):
    f = torch.zeros((twt.BLOCK, twt.FCOLS), device=cuda_device)
    lists = torch.zeros((8, 128), device=cuda_device)
    cbox = torch.zeros((256, 8), device=cuda_device)
    attr = torch.zeros((256 * twt.ATTR_ROWS, twt.CLUSTER),
                       device=cuda_device)
    pages = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    rng = torch.zeros((8, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="offs"):
        twt.paged_anyhit_kernel(f, lists, lists.int(), pages, rng.float(),
                                rng, cbox, attr)
    with pytest.raises(ValueError, match="pages"):
        twt.paged_anyhit_kernel(f, lists, lists.int(), pages.float(), rng,
                                rng, cbox, attr)
    with pytest.raises(ValueError, match="splits"):
        twt.paged_anyhit_kernel(f, lists, lists.int(), pages, rng, rng,
                                cbox, attr, splits=0)
    for splits in (0, 65):
        with pytest.raises(ValueError, match="splits"):
            twt.wave_kernel(f, lists, lists.int(), cbox, attr, True,
                            splits=splits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mma_loop", "mma_loop_stores",
                                  "leaf_variant_a", "leaf_variant_b",
                                  "leaf_variant_c"])
def test_cuda_leaf_one_block_equals_grid(cuda_device, name):
    """A launch held to one block (which walks every tile through all
    iterations) gives bitwise the full grid's row, checksum and last
    product, on random inputs."""
    from tungsten_tpu_torch.tools import mxubench as mxb
    rng = np.random.default_rng(8)
    a = _bf16(rng, (mxb.K_LEAF, mxb.N_LEAF), cuda_device)
    if name.startswith("mma_loop"):
        b0 = _bf16(rng, (mxb.K_LEAF, 1024), cuda_device)

        def run(blocks):
            return mxb.mma_loop(a, 1024, 9, name.endswith("stores"),
                                full=True, b0=b0, blocks=blocks)
    else:
        rows = mxb.TABLE_ROWS[name[-1]]
        tbl = _bf16(rng, (rows, 4 * mxb.TBL_STEP), cuda_device) \
            if rows else None

        def run(blocks):
            return mxb.leaf_variant(name[-1], a, tbl, iters=4, full=True,
                                    blocks=blocks)
    grid, one = run(0), run(1)
    assert all(torch.equal(x, y) for x, y in zip(grid, one))


def _bundle_rays(R, seed):
    """Rays from outside the soup in coherent 32-ray bundles (one origin,
    a narrow cone), as the dispatch's sort makes them, so a block's
    supers lie on several pages with their entries interleaved."""
    rng = np.random.default_rng(seed)
    nb = R // twt.SUBWARP
    o = rng.normal(size=(nb, 3))
    o = np.repeat(o * 8.0 / np.linalg.norm(o, axis=-1, keepdims=True),
                  twt.SUBWARP, axis=0)
    aim = np.repeat(rng.uniform(-2, 2, (nb, 3)), twt.SUBWARP, axis=0)
    d = aim + rng.uniform(-0.3, 0.3, aim.shape) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# the three split walks: the closest-hit kernel and K2 on the resident
# front (K1, K2 and K3's closest and any hit), the paged any-hit walk on
# the paged one
KERNELS = ["closest", "anyhit", "paged_walk"]


def _front(sc, dev, o, d, tmin, tmax, kernel):
    """The kernel's inputs for rays in the given order (no dispatch
    sort): the resident front, or for the paged walk the paged one."""
    args = [torch.from_numpy(x).to(dev) for x in (o, d, tmin, tmax)]
    if kernel == "paged_walk":
        return twt.paged_kernel_inputs(sc, *args)[:6]
    return twt.kernel_inputs(sc, *args)[:3]


def _launch(sc, front, kernel, splits=None):
    """One launch of `kernel` (of KERNELS) on its front."""
    if kernel == "paged_walk":
        return twt.paged_anyhit_kernel(*front, sc.wk_cbox, sc.wk_attr,
                                       splits=splits)
    return twt.wave_kernel(*front, sc.wk_cbox, sc.wk_attr,
                           kernel == "anyhit", splits=splits)


def _vs_list_walk(sc, front, any_hit, t, tri, tests):
    """A splits=1 launch against list_walk on the same front: closest hit
    the hit set, t within rtol 1e-5 / atol 1e-5 (nvcc contracts the
    leaf's multiply-adds into FMAs, PyTorch does not, and t*det cancels
    for a hit near the origin, so its error is absolute there), the
    triangle on > 0.999 of hits and elsewhere a t within rtol 1e-6 (a
    near-tie the two roundings break apart); any hit the occluded set;
    row 0 equal to list_walk's needed count ray for ray; row 0 <= row
    1."""
    lt, ltri, lneed = twt.list_walk(front[0], front[1], front[2],
                                    sc.wk_cbox, sc.wk_attr, any_hit)
    assert torch.equal(tri >= 0, ltri >= 0)
    if any_hit:
        assert torch.equal(t <= -1.0, lt <= -1.0)
    else:
        hit = tri >= 0
        assert bool((tri == ltri)[hit].float().mean() > 0.999)
        assert bool(((tri == ltri) | torch.isclose(t, lt, rtol=1e-6,
                                                   atol=0)).all())
        assert torch.allclose(t, lt, rtol=1e-5, atol=1e-5)
    assert torch.equal(tests[0], lneed)
    assert bool((tests[0] <= tests[1]).all())


def _flag(t, tri, any_hit):
    """What splits must not change: t and tri for closest hit, the
    occluded flag for any hit."""
    return (tri >= 0,) if any_hit else (t, tri)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_splits_are_bitwise_equal(cuda_device, one_super_pages,
                                       kernel):
    """The closest-hit kernel (K1, K3's closest hit), K2 and the paged
    any-hit walk on 8 blocks of coherent bundles through a
    20,000-triangle soup: splits 1, 2, 8 and the launcher's choice give
    bitwise the same t and tri (closest) or occluded flag (any hit), two
    launches are bitwise equal, and splits=1 is list_walk's walk, its
    row 0 equal to list_walk's needed count."""
    any_hit = kernel != "closest"
    v0, e1, e2 = _soup(num_tris=20000, seed=9)
    R = twt.BLOCK
    o, d = _bundle_rays(R, seed=10)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::7] = 0.0
    if any_hit:
        tmax = np.where(tmax > 0, np.float32(8.0), np.float32(0.0))
    sc, _ = _scene(v0, e1, e2, cuda_device)
    front = _front(sc, cuda_device, o, d, tmin, tmax, kernel)
    assert twt.launch_splits(R // twt.WARP, cuda_device) > 8
    t, tri, tests = _launch(sc, front, kernel, splits=1)
    _vs_list_walk(sc, front, any_hit, t, tri, tests)
    assert 0.05 < float((tri >= 0).float().mean()) < 0.95
    want = _flag(t, tri, any_hit)
    for splits in (2, 8, None, None):
        got = _flag(*_launch(sc, front, kernel, splits)[:2], any_hit)
        assert all(torch.equal(a, b) for a, b in zip(want, got)), splits


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_few_live_rays_in_a_block(cuda_device, kernel):
    """A block with 1 to 3 live rays among dead ones gives those rays the
    results of their full block (the launcher's split): closest hit the
    same t bitwise and the same triangle except at equal t, any hit (K2
    and the paged walk) the same occluded flag."""
    any_hit = kernel != "closest"
    v0, e1, e2 = _soup(num_tris=5000, seed=5)
    R = twt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), np.float32(1.25) if any_hit else 3e38, np.float32)
    sc, _ = _scene(v0, e1, e2, cuda_device)
    t, tri, _ = _launch(sc, _front(sc, cuda_device, o, d, tmin, tmax,
                                   kernel), kernel)
    keep = np.zeros((R,), bool)
    for b, rays in enumerate(([5], [0, 127], [17, 64, 100])):
        keep[[b * twt.WARP + r for r in rays]] = True
    tmax_s = np.where(keep, tmax, np.float32(0.0))
    ts, tris, tests = _launch(sc, _front(sc, cuda_device, o, d, tmin, tmax_s,
                                         kernel), kernel)
    k = torch.from_numpy(keep).to(cuda_device)
    assert bool((tris[~k] == -1).all()) and int(tests[:, ~k].sum()) == 0
    assert torch.equal(tri[k] >= 0, tris[k] >= 0)
    assert bool((tri[k] >= 0).any())
    if not any_hit:
        assert torch.equal(t[k], ts[k])
        assert bool(((tri[k] == tris[k]) | (t[k] == ts[k])).all())


@pytest.mark.cuda
def test_cuda_paged_closest_interleaved_pages(cuda_device, one_super_pages):
    """K3's closest hit where each block's supers span several pages with
    entries interleaved across them (coherent bundles through a
    20,000-triangle soup, a page of one super): the paged wrapper's
    closest hit launches the closest-hit kernel on the resident front,
    which equals list_walk on those rays (its row 0 list_walk's needed
    count) and runs at most 1.5x the tests they need, and the wrapper
    passes the gates against the brute force."""
    v0, e1, e2 = _soup(num_tris=20000, seed=9)
    R = 4 * twt.BLOCK
    o, d = _bundle_rays(R, seed=10)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::7] = 0.0
    live = tmax > 0
    sc, order = _scene(v0, e1, e2, cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in (o, d, tmin, tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    offs, offe = twt.paged_kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)[4:6]
    slots = (offe > offs).sum(dim=1)
    assert int(slots.max()) >= 4             # blocks span several pages
    front = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)[:3]
    t3, tri3, tests3 = twt.wave_kernel(*front, sc.wk_cbox, sc.wk_attr, False,
                                       splits=1, route="paged_closest")
    _vs_list_walk(sc, front, False, t3, tri3, tests3)
    need, ran = int(tests3[0].sum()), int(tests3[1].sum())
    assert 0 < need and ran <= 1.5 * need
    assert bool((tests3[:, tmax_s <= 0] == 0).all())
    before = dict(twt.LAUNCHES)
    t, tri, u, v = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin,
                         tmax, False)
    assert twt.LAUNCHES["paged_closest"] == before["paged_closest"] + 1
    assert twt.LAUNCHES["closest"] == before["closest"]
    bt, bi, uu, vv = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, bt, bi, uu, vv, live)


@pytest.mark.cuda
def test_cuda_paged_closest_zero_area_triangles(cuda_device,
                                                one_super_pages):
    """Zero-area triangles (n = 0) sit inside clusters, before real ones,
    wherever the BVH order puts them: the closest-hit kernel (K3's closest
    hit on this paged setting) still tests every real triangle, so it
    equals list_walk ray for ray, counts only the real triangles as
    needed (list_walk's count), runs the holes, and the paged wrapper
    passes the gates against the brute force; the paged any-hit walk
    equals list_walk on the paged front too."""
    v0, e1, e2 = _soup(num_tris=5000, seed=5)
    e1[::8] = 0.0
    e2[4::8] = 0.0
    R = 2 * twt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::5] = 0.0
    live = tmax > 0
    sc, order = _scene(v0, e1, e2, cuda_device)
    attr = sc.wk_attr.reshape(-1, twt.ATTR_ROWS, twt.CLUSTER)
    real = (attr[:, 12:15] != 0).any(dim=1)
    last = twt.CLUSTER - real.flip(1).int().argmax(1)
    holes = (torch.arange(twt.CLUSTER, device=cuda_device) < last[:, None])
    assert int((holes & ~real & real.any(1, keepdim=True)).sum()) > 100
    args = [torch.from_numpy(x).to(cuda_device) for x in (o, d, tmin, tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    front = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)[:3]
    t3, tri3, tests3 = twt.wave_kernel(*front, sc.wk_cbox, sc.wk_attr, False,
                                       splits=1, route="paged_closest")
    _vs_list_walk(sc, front, False, t3, tri3, tests3)
    assert bool((tests3[0] < tests3[1]).any())     # holes run, not needed
    pfront = twt.paged_kernel_inputs(sc, o_s, d_s, tmin_s,
                                     torch.clamp(tmax_s, max=1.25))[:6]
    _vs_list_walk(sc, pfront, True, *twt.paged_anyhit_kernel(
        *pfront, sc.wk_cbox, sc.wk_attr, splits=1))
    t, tri, u, v = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin,
                         tmax, False)
    bt, bi, uu, vv = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    _gates(t, tri, u, v, bt, bi, uu, vv, live)


@pytest.mark.cuda
def test_cuda_anyhit_zero_area_triangles(cuda_device):
    """K2 where zero-area triangles (n = 0) sit inside clusters before
    real ones: at splits=1 it equals list_walk(any_hit=True) on the
    resident front ray for ray (the occluded set, row 0 its needed
    count), dead rays cost no test, and at the launcher's split the
    occluded set is the same; the wrapper's occluded flag agrees with
    the brute force."""
    v0, e1, e2 = _soup(num_tris=5000, seed=5)
    e1[::8] = 0.0
    e2[4::8] = 0.0
    R = 2 * twt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), np.float32(1.25), np.float32)
    tmax[::5] = 0.0
    live = tmax > 0
    sc, order = _scene(v0, e1, e2, cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in (o, d, tmin, tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    front = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)[:3]
    t2, tri2, tests2 = twt.wave_kernel(*front, sc.wk_cbox, sc.wk_attr, True,
                                       splits=1)
    _vs_list_walk(sc, front, True, t2, tri2, tests2)
    assert 0.05 < float((tri2 >= 0).float().mean()) < 0.95
    assert bool((tests2[:, tmax_s <= 0] == 0).all())
    _, tri_s, _ = twt.wave_kernel(*front, sc.wk_cbox, sc.wk_attr, True)
    assert torch.equal(tri_s >= 0, tri2 >= 0)
    before = twt.LAUNCHES["anyhit"]
    _, tri, _, _ = _hits(twt.wave_intersect, sc, order, o, d, tmin, tmax,
                         True)
    assert twt.LAUNCHES["anyhit"] == before + 1
    _, bi, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    assert ((tri >= 0) == (bi >= 0))[live].mean() > 0.998
    assert (tri[~live] == -1).all()


@pytest.mark.cuda
def test_cuda_closest_honours_per_ray_tmin_on_dead_waves(cuda_device):
    """Rays that start on a soup triangle, as the shadow walk's hops do,
    with per-ray near limits (EPSILON on most, 1e-3 or 0.2 on some; a
    zero limit would leave the start triangle's own hit at t ~ 0 to
    rounding), in
    waves where one ray in 16 (or in 128) is live: the closest-hit
    kernel passes the wave gates against the f32 brute force and the
    plain walk with the same limits, and never returns a hit at or
    below a ray's near limit."""
    from tungsten_tpu_torch.integrators.path_tracer import EPSILON
    v0, e1, e2 = _soup()
    R = 8 * twt.BLOCK
    rng = np.random.default_rng(11)
    k = rng.integers(0, v0.shape[0], R)
    a, b = rng.uniform(0, 0.5, (2, R)).astype(np.float32)
    o = (v0[k] + a[:, None] * e1[k] + b[:, None] * e2[k]).astype(np.float32)
    _, d = _rays(R, seed=12)
    tmin = np.full((R,), EPSILON, np.float32)
    tmin[1::5] = 1e-3
    tmin[2::5] = 0.2
    sc, order = _scene(v0, e1, e2, cuda_device)
    for every in (16, 128):
        tmax = np.where(np.arange(R) % every == 0, np.float32(3e38),
                        np.float32(0.0))
        live = tmax > 0
        before = twt.LAUNCHES["closest"]
        t, tri, u, v = _hits(twt.wave_intersect, sc, order, o, d, tmin,
                             tmax, False)
        assert twt.LAUNCHES["closest"] == before + 1
        bt, bi, uu, vv = _brute(v0, e1, e2, o, d, tmin, tmax)
        _gates(t, tri, u, v, bt, bi, uu, vv, live)
        pt, pi, _, _ = _hits(tis.bvh_walk, sc, order, o, d, tmin, tmax,
                             False)
        _gates(t, tri, u, v, pt, pi, uu, vv, live)
        hit = tri >= 0
        assert hit[live].mean() > 0.2
        assert (t[hit] > tmin[hit]).all()
        # no ray sees the triangle it starts on
        assert not (hit & (tri == k)).any()


@pytest.mark.cuda
def test_cuda_media_render_matches_plain_path(cuda_device):
    """A 32x32 render of a fog room with a voxel medium in a `forward`
    cube and thinsheet / transparency surfaces: through the closest-hit
    kernel alone (the two-strategy NEE and the generalized shadow ray
    trace closest hits), and as the plain path renders it on the CPU
    (<= 1 % of pixels off by more than rtol 1e-3 / atol 1e-4, means
    within 0.5 %)."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    x = np.linspace(-1, 1, 12, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - (X * X + Y * Y + Z * Z), 0.05, None) * 3.0
    desc = SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.5, 0.4]},
               {"type": "forward"},
               {"type": "thinsheet", "ior": 1.5, "sigma_a": 0.3},
               {"type": "transparency", "alpha": 0.5, "base_index": 0}],
        media=[{"type": "homogeneous", "sigma_a": 0.02, "sigma_s": 0.15},
               {"type": "voxel", "sigma_a": 0.2, "sigma_s": 1.5,
                "grid": {"type": "dense", "data": dens.tolist(),
                         "transform": {"position": [0.3, -0.2, 0],
                                       "scale": 1.2}}}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf_index": 1, "int_medium_index": 1,
             "ext_medium_index": 0,
             "transform": {"position": [0.3, -0.2, 0], "scale": 1.2}},
            {"type": "quad", "bsdf_index": 2,
             "transform": {"position": [-1.2, 0, 0.5],
                           "rotation": [90, 30, 0]}},
            {"type": "cube", "bsdf_index": 3,
             "transform": {"position": [-0.9, -0.6, -0.6], "scale": 0.7}}],
        camera={"type": "pinhole", "resolution": [32, 32], "fov": 60,
                "medium_index": 0,
                "transform": {"position": [0, 0.6, 4.0],
                              "look_at": [0, 0.0, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 4})
    scene, settings = flatten_scene(desc)
    assert settings.has_media
    before = dict(twt.LAUNCHES)
    gpu = render(scene, settings, spp=4, seed=7, spp_chunk=4)
    assert twt.LAUNCHES["closest"] > before["closest"]
    assert all(twt.LAUNCHES[k] == before[k]
               for k in ("anyhit", "paged_closest", "paged_anyhit",
                         "paged_walk"))
    cpu = render(scene.to("cpu"), settings, spp=4, seed=7, spp_chunk=4,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3


@pytest.mark.cuda
def test_cuda_kernels_under_analytic_far_limits(cuda_device):
    """Analytic spheres in the soup: bvh_intersect tests them first and
    hands K1 each ray's far limit from the nearest sphere hit (0 where a
    ray is dead), so the triangle walk must honour far limits well inside
    the box; K2 takes shadow segments toward points on the spheres, far
    limit dist * SHADOW_FUDGE.  Both against the f32 brute force with the
    same limits (the wave gates), the sphere channel where no triangle
    is nearer."""
    from tungsten_tpu_torch.integrators.path_tracer import SHADOW_FUDGE
    v0, e1, e2 = _soup()
    R = 4 * twt.BLOCK
    o, _ = _rays(R, seed=21)
    sc, order = _scene(v0, e1, e2, cuda_device)
    rng = np.random.default_rng(22)
    c = rng.uniform(-1.5, 1.5, (12, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.5, 12).astype(np.float32)
    # rays aimed near the spheres, so that many end on one
    aim = c[rng.integers(0, 12, R)] + rng.normal(
        scale=0.4, size=(R, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    sc.sph_center = torch.from_numpy(c).to(cuda_device)
    sc.sph_radius = torch.from_numpy(r).to(cuda_device)
    for k in ("dsk_r", "cyl_r"):
        setattr(sc, k, torch.zeros((0,), device=cuda_device))
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::9] = 0.0
    live = tmax > 0
    to = lambda x: torch.from_numpy(x).to(cuda_device)   # noqa: E731
    # the analytic test alone gives the triangle walk's far limits
    best_t, sph, _, _ = tis._analytic_prims(
        sc, to(o), to(d), to(np.zeros(R, np.float32)),
        tis.geo_clip(sc, to(o), to(d), to(tmax)))
    sph_hit = (sph >= 0).cpu().numpy()
    assert sph_hit[live].mean() > 0.2
    before = dict(twt.LAUNCHES)
    res = tis.bvh_intersect(sc, to(o), to(d), 0.0, to(tmax))
    assert twt.LAUNCHES["closest"] == before["closest"] + 1
    far = best_t.cpu().numpy()
    bt, bi, uu, vv = _brute(v0, e1, e2, o, d, 0.0, far)
    tri = res["tri"].cpu().numpy()
    tri = np.where(tri >= 0, order[np.clip(tri, 0, None)], -1)
    _gates(res["t"].cpu().numpy(), tri, res["u"].cpu().numpy(),
           res["v"].cpu().numpy(), bt, bi, uu, vv, live)
    # a sphere wins exactly where no triangle is nearer
    got_sph = res["sph"].cpu().numpy() >= 0
    assert ((got_sph == (sph_hit & (bi < 0))) | ~live).mean() > 0.998
    # the plain walk under the same limits agrees
    pt, pi, _, _ = _hits(tis.bvh_walk, sc, order, o, d,
                         np.zeros(R, np.float32), far, False)
    assert ((pi >= 0) == (bi >= 0))[live].mean() > 0.998

    # K2 on shadow segments toward points on the spheres' near sides (the
    # simple NEE's), the far limits cut by any sphere in between
    k = rng.integers(0, 12, R)
    w = rng.normal(size=(R, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w = np.where(np.sum(w * (o - c[k]), -1, keepdims=True) < 0, -w, w)
    q = c[k] + r[k, None] * w
    to_q = q - o
    dist = np.linalg.norm(to_q, axis=-1).astype(np.float32)
    sd = (to_q / dist[:, None]).astype(np.float32)
    far_s = np.where(live, dist * np.float32(SHADOW_FUDGE),
                     np.float32(0.0)).astype(np.float32)
    best_s, sph_s, _, _ = tis._analytic_prims(
        sc, to(o), to(sd), to(np.zeros(R, np.float32)),
        tis.geo_clip(sc, to(o), to(sd), to(far_s)))
    before = dict(twt.LAUNCHES)
    occ = tis.bvh_intersect(sc, to(o), to(sd), 0.0, to(far_s),
                            any_hit=True)
    assert twt.LAUNCHES["anyhit"] == before["anyhit"] + 1
    occ_tri = (occ["tri"] >= 0).cpu().numpy()
    far_k2 = best_s.cpu().numpy()
    _, bi_s, _, _ = _brute(v0, e1, e2, o, sd, 0.0, far_k2)
    assert (occ_tri == (bi_s >= 0))[live].mean() > 0.998
    assert not occ_tri[~live].any()
    assert 0.05 < occ_tri[live].mean() < 0.95
    assert np.array_equal(occ["hit"].cpu().numpy(),
                          occ_tri | (sph_s >= 0).cpu().numpy())
    _, tri_c, _, _ = _hits(twt.wave_intersect, sc, order, o, sd,
                           np.zeros(R, np.float32), far_k2, False)
    assert np.array_equal(occ_tri, tri_c >= 0)


@pytest.mark.cuda
def test_cuda_analytic_render_matches_plain_path(cuda_device, tmp_path):
    """A 32x32 render of analytic prims (an emissive sphere, disk and
    capped cylinder, a disk floor), a point light, a skydome with an
    infinite_sphere_cap sun and a thinlens camera with a cat eye: the cap
    takes the simple two-strategy NEE, so K1 and K2 both launch, and the
    image is the plain path's on the CPU (<= 1 % of pixels off by more
    than rtol 1e-3 / atol 1e-4, means within 0.5 %)."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    sun = {"rotation": [25, 0, 15]}
    desc = SceneDesc(
        path=str(tmp_path / "scene.json"), json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.5, 0.4]},
               {"type": "mirror", "albedo": 0.9}],
        primitives=[
            {"type": "disk", "bsdf_index": 0,
             "transform": {"position": [0, -1, 0], "scale": 6}},
            {"type": "cube", "bsdf_index": 0,
             "transform": {"position": [0.3, -0.6, 0], "scale": 0.8}},
            {"type": "sphere", "bsdf_index": 0, "emission": [5, 4, 3],
             "transform": {"position": [-0.8, 0, -0.5], "scale": 0.3}},
            {"type": "disk", "bsdf_index": 0, "power": [30, 30, 30],
             "transform": {"position": [0, 2, 0], "scale": 0.6,
                           "rotation": [180, 0, 0]}},
            {"type": "cylinder", "bsdf_index": 1, "capped": True,
             "transform": {"position": [1, -0.4, -0.5],
                           "scale": [0.4, 1.2, 0.4]}},
            {"type": "cylinder", "bsdf_index": 0, "emission": [1, 3, 1],
             "transform": {"position": [-1.2, -0.5, 0.6],
                           "scale": [0.2, 1.0, 0.2]}},
            {"type": "point", "emission": [3, 3, 3],
             "transform": {"position": [0.5, 1.2, 1.0]}},
            {"type": "skydome", "transform": sun},
            {"type": "infinite_sphere_cap", "cap_angle": 2.0,
             "power": [4, 4, 3], "transform": sun},
            {"type": "sphere", "name": "pivot", "bsdf_index": 1,
             "transform": {"position": [0.4, 0.1, 0.6], "scale": 0.3}}],
        media=[], camera={"type": "thinlens", "resolution": [32, 32],
                          "fov": 60, "aperture_size": 0.05,
                          "cateye": 0.03, "focus_pivot": "pivot",
                          "reconstruction_filter": "mitchell_netravali",
                          "transform": {"position": [0, 0.6, 4.0],
                                        "look_at": [0, 0.0, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 4})
    scene, settings = flatten_scene(desc)
    assert settings.num_caps == 1 and settings.has_points
    before = dict(twt.LAUNCHES)
    gpu = render(scene, settings, spp=4, seed=7, spp_chunk=4)
    assert all(twt.LAUNCHES[k] > before[k] for k in ("closest", "anyhit"))
    cpu = render(scene.to("cpu"), settings, spp=4, seed=7, spp_chunk=4,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3


def _curve_desc(tmp_path, cap: bool, twins: bool = False):
    """A small curve scene written with the port's curve IO: strands in
    all four modes with the three fiber BCSDFs and lambert, an instanced
    cube, a floor and an area light, and with `cap` an
    infinite_sphere_cap sun (the simple two-strategy NEE) instead of
    one-sample MIS.  With `twins` the half-cylinder prim a second time,
    last: coincident strands, whose pieces a ray meets at equal t."""
    from tungsten_tpu_torch.io import curves
    from tungsten_tpu_torch.scene.parse import SceneDesc
    r = np.random.default_rng(5)
    prims = []
    for i, (mode, bsdf) in enumerate((("cylinder", 3), ("half_cylinder", 2),
                                      ("bcsdf_cylinder", 0),
                                      ("ribbon", 1))):
        n, k = 24, 8
        base = np.stack([r.uniform(-0.2, 0.2, n) - 0.75 + 0.5 * i,
                         np.zeros(n), r.uniform(-0.2, 0.2, n)], 1)
        steps = 0.1 * np.stack([r.normal(0, 0.3, (n, k)), np.ones((n, k)),
                                r.normal(0, 0.3, (n, k))], -1)
        if mode == "cylinder":      # strands along x meet vertical rays
            steps = steps[..., [1, 0, 2]]
        pts = base[:, None] + np.cumsum(steps, 1)
        nodes = np.concatenate([pts, np.full((n, k, 1), 0.02)],
                               -1).reshape(-1, 4).astype(np.float32)
        ends = (np.arange(1, n + 1) * k).astype(np.uint32)
        curves.save_fiber(str(tmp_path / f"c{i}.fiber"), curves.CurveData(
            ends, nodes, curves.init_normals(ends, nodes)))
        prims.append({"type": "curves", "file": f"c{i}.fiber", "mode": mode,
                      "bsdf_index": bsdf})
    prims += [
        {"type": "instances", "bsdf_index": 3,
         "masters": [{"type": "cube", "transform": {"scale": 0.2}}],
         "instances": [{"id": 0, "transform": {"position": [x, 0.1, -0.4]}}
                       for x in (-0.6, 0.0, 0.6)]},
        {"type": "quad", "bsdf_index": 3,
         "transform": {"position": [0, -0.02, 0], "scale": 4}},
        {"type": "quad", "bsdf_index": 3, "emission": [5, 5, 5],
         "transform": {"position": [0, 2.0, -0.5], "scale": 1.0,
                       "rotation": [180, 0, 0]}}]
    if twins:
        prims.append(dict(prims[1]))
    if cap:
        prims.append({"type": "infinite_sphere_cap", "cap_angle": 5.0,
                      "power": [4, 4, 3],
                      "transform": {"rotation": [30, 0, 20]}})
    return SceneDesc(
        path=str(tmp_path / "scene.json"), json={},
        bsdfs=[{"type": "hair", "roughness": 0.3},
               {"type": "rough_wire", "material": "Cu", "roughness": 0.2},
               {"type": "lambertian_fiber", "albedo": [0.6, 0.5, 0.3]},
               {"type": "lambert", "albedo": 0.6}],
        primitives=prims, media=[],
        camera={"type": "pinhole", "resolution": [32, 32], "fov": 55,
                "transform": {"position": [0, 0.5, -2.4],
                              "look_at": [0, 0.4, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 4})


def _curve_rays(R, seed):
    """Seeded rays at the strands from in front, a quarter vertical
    (along -y from above), a third with t_min 0.2."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-1.2, 1.2, R), r.uniform(0.0, 1.0, R),
                  np.full(R, -2.0)], 1)
    d = np.stack([r.uniform(-1.0, 1.0, R), r.uniform(0.0, 0.9, R),
                  r.uniform(-0.3, 0.3, R)], 1) - o
    q = R // 4
    o[:q] = np.stack([r.uniform(-1.0, -0.3, q), np.full(q, 2.0),
                      r.uniform(-0.3, 0.3, q)], 1)
    d[:q] = [0.0, -1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(np.arange(R) % 3 == 1, 0.2, 0.0)
    return o.astype(np.float32), d.astype(np.float32), \
        t_min.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_curve_kernel_matches_plain_walk(cuda_device, tmp_path,
                                              any_hit, lanes):
    """C1 at each forced group size (lanes a ray) against the plain curve
    walk on the same device and inputs, on a scene of all four curve
    modes with far limits cut by triangles (the floor, instanced cubes):
    the hit set and the segment equal on >= 0.9999 of the rays, t within
    rtol 1e-5 where the segments agree; any hit's set equals C1's closest
    hit's; each launch counted once; dead rays visit no node."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False))
    assert scene.crv_pc_q0.shape[0] == 4 * 24 * 6 * 8
    R = 8192
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(R, 11))
    front = tis._tri_analytic(scene, o, d, tmin,
                              tis.geo_clip(scene, o, d, 3.0e38), False, False)
    far = torch.where(front["hit"], front["t"], 3.0e38)
    far[::17] = 0.0                               # dead rays
    route = "curve_anyhit" if any_hit else "curve_closest"
    before = dict(tct.LAUNCHES)
    t, seg, u, v, hit, counts, _, _ = tct.curve_kernel(
        scene.crv_rows, scene.cwbvh_rows, o, d, tmin, far, any_hit,
        stats=True, lanes=lanes)
    assert tct.LAUNCHES[route] == before[route] + 1
    pt, pseg, pu, pv, phit = tis.curve_walk_plain(scene, o, d, tmin, far,
                                                  any_hit)
    assert tct.LAUNCHES[route] == before[route] + 1   # the plain walk: 0
    assert (hit == phit).float().mean().item() >= 0.9999
    assert int(hit.sum()) > 200
    live = far > tmin
    assert not bool(hit[~live].any()) and not bool(counts[:, ~live].any())
    assert bool((counts[0][live] > 0).all())
    if any_hit:
        closest = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d,
                                   tmin, far, False, lanes=lanes)[4]
        assert torch.equal(closest, hit)
        return
    both = hit & phit
    assert (seg == pseg)[both].float().mean().item() >= 0.9999
    s = both & (seg == pseg)
    assert torch.allclose(t[s], pt[s], rtol=1e-5, atol=0.0)
    assert torch.equal(t[~hit], far[~hit])
    modes = scene.crv_seg_mode[seg[hit].long()]
    assert set(modes.tolist()) == {0, 1, 2, 3}
    assert bool(hit[: R // 4].any())                  # vertical rays


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_cuda_curve_kernel_few_live_rays(cuda_device, tmp_path, lanes):
    """A wave of 65,536 rays with one in 256 live gives each live ray the
    result it gets launched alone with its neighbours, bitwise, and the
    dead ones a miss with no node visited, at each forced group size."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False))
    R = 65536
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(R, 12))
    far = torch.zeros(R, device=cuda_device)
    idx = torch.arange(0, R, 256, device=cuda_device)
    far[idx] = 3.0e38
    for any_hit in (False, True):
        wide = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d, tmin,
                                far, any_hit, stats=True, lanes=lanes)[:6]
        alone = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o[idx],
                                 d[idx], tmin[idx], far[idx], any_hit,
                                 stats=True, lanes=lanes)[:6]
        for a, b in zip(wide, alone):
            assert torch.equal(a[..., idx], b)
        dead = far == 0
        assert not bool(wide[4][dead].any())
        assert not bool(wide[5][:, dead].any())
        assert int(wide[4].sum()) > 0


@pytest.mark.cuda
def test_cuda_curve_lanes_are_bitwise_equal(cuda_device, tmp_path):
    """A 1,024-ray slice (the width of a render's late bounces) gives the
    same t, seg, u, v, hit and statistics bitwise with 1, 2 and 4 lanes a
    ray and with the launcher's choice, in closest and any hit, and the
    same as these rays inside a full-width launch of 65,536."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False))
    R, k = 65536, 1024
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(R, 13))
    front = tis._tri_analytic(scene, o, d, tmin,
                              tis.geo_clip(scene, o, d, 3.0e38), False, False)
    far = torch.where(front["hit"], front["t"], 3.0e38)
    sl = slice(4096, 4096 + k)
    assert tct.curve_lanes(k, cuda_device) == 4
    for any_hit in (False, True):
        full = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d, tmin,
                                far, any_hit, stats=True)[:6]
        runs = [tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o[sl],
                                 d[sl], tmin[sl], far[sl], any_hit,
                                 stats=True, lanes=g)[:6]
                for g in (None, 1, 2, 4)]
        assert int(runs[0][4].sum()) > 50
        for run in runs[1:] + [[x[..., sl] for x in full]]:
            for a, b in zip(run, runs[0]):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_curve_kernel_refuses_bad_lanes(cuda_device, tmp_path):
    """lanes other than 1, 2, 4 or None raise before any launch."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False))
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(256, 14))
    far = torch.full((256,), 3.0e38, device=cuda_device)
    before = dict(tct.LAUNCHES)
    for bad in (0, 3, 8, -1, 2.0, True):
        with pytest.raises(ValueError, match="lanes"):
            tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d, tmin,
                             far, False, lanes=bad)
    assert tct.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_curve_kernel_refuses_bad_stack(cuda_device, tmp_path):
    """A stack that is not a multiple of SHORT in (SHORT, STACK] raises
    before any launch."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False))
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(256, 15))
    far = torch.full((256,), 3.0e38, device=cuda_device)
    before = dict(tct.LAUNCHES)
    for bad in (0, 8, 12, 72, 128, 16.0, True):
        with pytest.raises(ValueError, match="stack"):
            tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d, tmin,
                             far, False, stack=bad)
    assert tct.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_cuda_curve_ties_to_the_lower_piece(cuda_device, tmp_path, lanes):
    """With the half-cylinder strands twice (coincident pieces, met at
    equal t), C1 keeps the lower piece index of the two, as the serial
    walk does: on the rays where C1's hit and the plain walk's both lie on
    either copy, the segment, and so the copy, is the plain walk's, at
    each forced group size.  A rule that kept the higher piece would give
    the other copy on about all of them, one that ignored the index on
    about half.  Not exactly all: where the cylinders of two pieces of a
    segment meet a ray at t within an ulp, fused multiply-adds decide
    which piece wins, and the lower copy of the one may not be the lower
    copy of the other (rare: well under 1 % of these rays); so
    >= 0.99."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, _ = flatten_scene(_curve_desc(tmp_path, cap=False, twins=True))
    R = 8192
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in _curve_rays(R, 16))
    far = tis.geo_clip(scene, o, d, 3.0e38)
    t, seg, _, _, hit = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows,
                                         o, d, tmin, far, False, lanes=lanes)
    _, pseg, _, _, phit = tis.curve_walk_plain(scene, o, d, tmin, far,
                                               False)
    prim = scene.crv_seg_prim
    copies = torch.unique(prim[scene.crv_seg_mode == 1])
    assert copies.numel() == 2
    on = hit & phit & torch.isin(prim[pseg.clamp(min=0).long()], copies) \
        & torch.isin(prim[seg.clamp(min=0).long()], copies)
    assert int(on.sum()) >= 500
    assert (seg[on] == pseg[on]).float().mean().item() >= 0.99


@pytest.mark.cuda
def test_cuda_curve_kernel_restarts_on_a_deep_tree(cuda_device, tmp_path):
    """On a piece BVH as deep as its pieces (tests/torch_curve_cases.py:
    its walk could hold 192 stack entries), the rays up the column drop
    stack entries and restart; t, seg, u, v and hit are the same bitwise
    with every forced lanes, in closest and any hit, and with a stack of
    2 * SHORT (closest hit; any hit: hit, as a restart changes which hit
    an any-hit ray meets first), and agree with the plain walk on the
    same device (hit set and segment on >= 0.9999 of the rays, t within
    rtol 1e-5)."""
    from torch_curve_cases import column_rays, deep_curve_scene
    from tungsten_tpu_torch.ops import curve_trace as tct
    scene = deep_curve_scene(tmp_path, cuda_device)
    R = 4096
    o, d, tmin = (torch.from_numpy(x).to(cuda_device)
                  for x in column_rays(R, 17))
    far = torch.full((R,), 3.0e38, device=cuda_device)
    args = (scene.crv_rows, scene.cwbvh_rows, o, d, tmin, far)
    for any_hit in (False, True):
        ref = tct.curve_kernel(*args, any_hit, stats=True)
        assert int((ref[5][4] > 0).sum()) >= R // 8
        for kw in ({"lanes": 1}, {"lanes": 2}, {"lanes": 4},
                   {"stack": 2 * tct.SHORT},
                   {"stack": 2 * tct.SHORT, "lanes": 1}):
            got = tct.curve_kernel(*args, any_hit, **kw)
            same = (4,) if any_hit and "stack" in kw else range(5)
            for j in same:
                assert torch.equal(got[j], ref[j]), kw
        pt, pseg, _, _, phit = tis.curve_walk_plain(scene, o, d, tmin, far,
                                                    any_hit)
        t, seg, _, _, hit = ref[:5]
        assert int(hit.sum()) > R // 4
        assert (hit == phit).float().mean().item() >= 0.9999
        if not any_hit:
            both = hit & phit
            assert (seg == pseg)[both].float().mean().item() >= 0.9999
            s = both & (seg == pseg)
            assert torch.allclose(t[s], pt[s], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_cuda_curve_render_matches_plain_path(cuda_device, tmp_path):
    """A 32x32 render of the four curve modes with the fiber BCSDFs, an
    instanced cube, a floor and an area light, without a cap: one-sample
    MIS, so C1 serves both the closest hits and the shadow rays (any
    hit) beside K1 and K2, and the image is the plain path's on the CPU
    (<= 1 % of pixels off by more than rtol 1e-3 / atol 1e-4, means
    within 0.5 %)."""
    from tungsten_tpu_torch.integrators.path_tracer import _one_sample_mis
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_curve_desc(tmp_path, cap=False))
    assert _one_sample_mis(settings) and settings.curve_modes == (0, 1, 2, 3)
    before = dict(twt.LAUNCHES, **tct.LAUNCHES)
    gpu = render(scene, settings, spp=4, seed=7, spp_chunk=4)
    after = dict(twt.LAUNCHES, **tct.LAUNCHES)
    assert all(after[k] > before[k] for k in ("closest", "anyhit",
                                              "curve_closest",
                                              "curve_anyhit"))
    cpu = render(scene.to("cpu"), settings, spp=4, seed=7, spp_chunk=4,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3


def _replay_desc(tmp_path):
    """A small box for the replay: lambert walls, a bitmap wall, a
    rough_conductor block and an oren_nayar wall on its roughness clip,
    under a quad light (tests/test_torch_replay.py's box, 32x24, 8
    bounces)."""
    from tungsten_tpu_torch.io import image
    from tungsten_tpu_torch.scene.parse import SceneDesc
    tex = np.full((8, 8, 3), 0.4, np.float32)
    tex[2:6, 2:6] = [0.8, 0.3, 0.2]
    image.save_hdr(str(tmp_path / "wall.pfm"), tex)

    def quad(b, pos, scale, rot=(0, 0, 0), **kw):
        return dict(type="quad", bsdf_index=b, transform=dict(
            position=list(pos), scale=scale, rotation=list(rot)), **kw)
    return SceneDesc(
        path=str(tmp_path / "scene.json"), json={},
        bsdfs=[{"type": "lambert", "albedo": [0.7, 0.7, 0.7]},
               {"type": "lambert", "albedo": "wall.pfm"},
               {"type": "rough_conductor", "material": "Cu",
                "roughness": 0.3, "distribution": "ggx"},
               {"type": "oren_nayar", "albedo": [0.3, 0.6, 0.3],
                "roughness": 1.0}],
        primitives=[quad(0, (0, 0, 0), [4, 1, 4]),
                    quad(0, (0, 3, 0), [4, 1, 4], (0, 0, 180)),
                    quad(1, (0, 1.5, -2), [4, 1, 3], (90, 0, 0)),
                    quad(3, (2, 1.5, 0), [3, 1, 4], (0, 0, 90)),
                    {"type": "cube", "bsdf_index": 2,
                     "transform": {"position": [0.4, 0.5, -0.5],
                                   "scale": [0.8, 1.0, 0.8],
                                   "rotation": [0, 25, 0]}},
                    quad(0, (0, 2.98, 0), 1.0, (0, 0, 180),
                         emission=[6.0, 6.0, 6.0])],
        media=[], camera={"type": "pinhole", "resolution": [32, 24],
                          "fov": 60,
                          "transform": {"position": [0, 1.5, 5.0],
                                        "look_at": [0, 1.2, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 1})


REPLAY_PARAMS = ("tex_const", "light_emission", "bsdf_params")


def _replay_grads(scene, settings, seed=7):
    """(L, loss, {field: gradient}, the replay's ReplayStats) of the
    mean radiance, one sample a pixel."""
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    n = settings.width * settings.height
    dev = scene.device
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
              for k in REPLAY_PARAMS}
    L, stats = tpt.trace_wave_replay(
        scene.replace(**leaves), settings,
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev), seed,
        with_stats=True)
    loss = L.mean()
    fwd = dict(twt.LAUNCHES)
    loss.backward()
    return (L.detach(), float(loss.detach()),
            {k: v.grad for k, v in leaves.items()}, stats, fwd)


@pytest.mark.cuda
def test_cuda_replay_matches_plain_path(cuda_device, tmp_path):
    """trace_wave_replay on the card: K1 and K2 launch in the forward and
    again in the backward (never the plain walk), the backward ends on
    the forward's L bit for bit, and the gradients agree with the plain
    path's on the CPU (a lane may part where the kernel and the plain
    walk round a grazing hit differently, and the gathers' backward adds
    with atomics: rtol 1e-3 on entries above 1e-2 * max|g|, the rest
    within 1e-3 * max|g|)."""
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_replay_desc(tmp_path))
    before = dict(twt.LAUNCHES)
    L, loss, grads, stats, fwd = _replay_grads(scene, settings)
    for k in ("closest", "anyhit"):
        assert fwd[k] > before[k] and twt.LAUNCHES[k] > fwd[k], k
    assert torch.equal(stats.emission, L)
    cL, closs, cgrads, _, _ = _replay_grads(scene.to("cpu"), settings)
    assert loss == pytest.approx(closs, rel=1e-4)
    for k in REPLAY_PARAMS:
        got, want = grads[k].cpu().numpy(), cgrads[k].numpy()
        m = np.abs(want).max()
        assert m > 0 and np.isfinite(got).all(), k
        big = np.abs(want) > 1e-2 * m
        np.testing.assert_allclose(got[big], want[big], rtol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[~big], want[~big], atol=1e-3 * m,
                                   err_msg=k)


@pytest.mark.cuda
def test_cuda_train_step_on_one_nccl_rank(cuda_device, tmp_path,
                                          monkeypatch):
    """train_step_sharded on a one-rank NCCL group (init_distributed from
    the launcher's variables): the loss and gradients of the replay on
    the whole frame (the gathers' backward adds with atomics on the
    card: rtol 1e-5, atol 1e-7 * max|g|)."""
    import torch.distributed as dist
    from tungsten_tpu_torch.parallel import distributed as D
    from tungsten_tpu_torch.parallel import sharded as S
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    for k, v in (("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(D.free_port())), ("WORLD_SIZE", "1"),
                 ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    scene, settings = flatten_scene(_replay_desc(tmp_path))
    _, want_loss, want, _, _ = _replay_grads(scene, settings)
    assert D.init_distributed(timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        n = settings.width * settings.height
        loss, grads = S.train_step_sharded(
            scene, settings, S.make_mesh(), lambda sc, p: sc.replace(**p),
            lambda rad, pix: torch.sum(rad) / (3 * n),
            {k: getattr(scene, k) for k in REPLAY_PARAMS}, seed=7)
    finally:
        dist.destroy_process_group()
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    for k in REPLAY_PARAMS:
        got, ref = grads[k].cpu().numpy(), want[k].cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-7 * np.abs(ref).max(), err_msg=k)


# -------------------------------- BDPT and the light tracer (K1 and K2)

def _bdpt_desc():
    """The lambert + mirror scene of test_cuda_render_matches_plain_path
    under the bidirectional path tracer, 32x24, max_bounces 4."""
    from tungsten_tpu_torch.scene.parse import SceneDesc
    return SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
               {"type": "mirror", "albedo": 1.0}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 1,
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf_index": 0,
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.8}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, 1, -3], "scale": [10, 1, 10],
                           "rotation": [90, 0, 0]}}],
        media=[], camera={"type": "pinhole", "resolution": [32, 24],
                          "fov": 60,
                          "transform": {"position": [0, 0.6, 4.0],
                                        "look_at": [0, 0.0, 0]}},
        integrator={"type": "bidirectional_path_tracer", "max_bounces": 4},
        renderer={"spp": 2})


def _share_close(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return np.isclose(a, b, rtol=1e-3, atol=1e-4).reshape(
        a.shape[0], -1).all(-1).mean()


@pytest.mark.cuda
def test_cuda_bdpt_wave_matches_plain_path(cuda_device):
    """One BDPT wave (32x24, 2 spp, 4 vertices a subpath, 4 edges) on the
    card against the plain path on the CPU on the same lanes: radiance
    per lane, splat pixels and splat values on >= 0.99 of entries within
    rtol 1e-3 / atol 1e-4 (a lane parts where the kernel and the plain
    walk round a grazing hit differently), rays within 1 %; the walks
    launch K1 and the connections K2.  Then both integrators' render()
    images against the CPU's with phase 6's gates (<= 1 % of pixels off,
    means within 0.5 %)."""
    from dataclasses import replace
    from tungsten_tpu_torch.integrators.bdpt import trace_bdpt
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_bdpt_desc())
    cpu_scene = scene.to("cpu")
    n = settings.width * settings.height
    pixel = torch.arange(n, dtype=torch.int32).repeat(2)
    sample = torch.arange(2, dtype=torch.int32).repeat_interleave(n)
    before = dict(twt.LAUNCHES)
    got = trace_bdpt(scene, settings, pixel.to(cuda_device),
                     sample.to(cuda_device), 7, 4, 4)
    assert twt.LAUNCHES["closest"] > before["closest"]
    assert twt.LAUNCHES["anyhit"] > before["anyhit"]
    want = trace_bdpt(cpu_scene, settings, pixel, sample, 7, 4, 4)
    assert _share_close(got[0], want[0]) >= 0.99
    assert (got[1].cpu() == want[1]).float().mean().item() >= 0.99
    assert _share_close(got[2], want[2]) >= 0.99
    assert float(got[0].sum()) > 0 and float(got[2].sum()) > 0
    assert abs(int(got[3]) / int(want[3]) - 1.0) <= 0.01
    for integrator in ("bidirectional_path_tracer", "light_tracer"):
        s = replace(settings, integrator_type=integrator)
        gpu = render(scene, s, spp=2, seed=7, spp_chunk=2)
        cpu = render(cpu_scene, s, spp=2, seed=7, spp_chunk=2, device="cpu")
        assert np.isfinite(gpu).all() and gpu.mean() > 0
        close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
        assert close.mean() >= 0.99, (integrator, close.mean())
        assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3, integrator


@pytest.mark.cuda
def test_cuda_bdpt_media_render_matches_plain_path(cuda_device):
    """BDPT on a fog-filled `forward` cube with a thinsheet sphere under a
    thinlens camera (cat eye 0.3): the walks, the connection hops and the
    lens connections all trace closest hits, so K1 alone launches; the
    image is the plain path's on the CPU under phase 6's gates."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    desc = SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.7, 0.6, 0.5]},
               {"type": "forward"},
               {"type": "thinsheet", "ior": 1.45, "sigma_a": [0.3, 0.6, 1.2],
                "thickness": 0.4},
               {"type": "mirror", "albedo": 0.9}],
        media=[{"type": "homogeneous", "sigma_a": 0.05,
                "sigma_s": [0.5, 0.6, 0.7],
                "phase_function": {"type": "henyey_greenstein", "g": 0.3}}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [7.0, 7.0, 7.0],
             "transform": {"position": [0, 2.4, 0], "scale": [1.2, 1, 1.2],
                           "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, -1, 0], "scale": [8, 1, 8]}},
            {"type": "cube", "bsdf_index": 1, "int_medium_index": 0,
             "transform": {"position": [0.2, -0.1, 0], "scale": 1.6}},
            {"type": "sphere", "bsdf_index": 2,
             "transform": {"position": [-0.9, -0.3, 0.9], "scale": 0.45}},
            {"type": "quad", "bsdf_index": 3,
             "transform": {"position": [0, 0.5, -2.0], "scale": [3, 1, 2],
                           "rotation": [90, 0, 0]}}],
        camera={"type": "thinlens", "resolution": [32, 24], "fov": 60,
                "aperture_size": 0.3, "cateye": 0.3, "focus_distance": 3.4,
                "transform": {"position": [0, 0.5, 3.4],
                              "look_at": [0, 0, 0]}},
        integrator={"type": "bidirectional_path_tracer", "max_bounces": 4},
        renderer={"spp": 2})
    scene, settings = flatten_scene(desc)
    assert settings.has_media
    before = dict(twt.LAUNCHES)
    gpu = render(scene, settings, spp=2, seed=7, spp_chunk=2)
    assert twt.LAUNCHES["closest"] > before["closest"]
    assert all(twt.LAUNCHES[k] == before[k]
               for k in ("anyhit", "paged_closest", "paged_anyhit",
                         "paged_walk"))
    cpu = render(scene.to("cpu"), settings, spp=2, seed=7, spp_chunk=2,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3


# ------------------------------------------ the photon maps (K1 and K2)

def _photon_desc(volume=None):
    """The BDPT card scene under photon_map (32x24, max_bounces 4, 65,536
    photon paths, gather radius 0.1); with `volume` its room filled with
    a homogeneous fog the light and the surfaces face (their exterior
    medium) and the camera sits in, with that volume photon type."""
    desc = _bdpt_desc()
    desc.integrator = {"type": "photon_map", "max_bounces": 4,
                       "photon_count": 1 << 16, "gather_radius": 0.1,
                       "gather_photon_count": 16}
    if volume:
        desc.media = [{"type": "homogeneous", "sigma_a": 0.02,
                       "sigma_s": 0.25}]
        for p in desc.primitives:
            p["ext_medium_index"] = 0
        desc.camera["medium_index"] = 0
        desc.integrator.update(volume_photon_type=volume,
                               volume_gather_radius=0.3,
                               volume_photon_count=2000)
    return desc


def _photons_agree(got, want):
    """Flags equal on >= 0.999 of slots; positions, directions and
    powers (and the beam and plane fields) within rtol 1e-5 / atol 1e-6
    on >= 0.95 and within rtol 1e-3 / atol 1e-4 on >= 0.995 of the slots
    valid on both (the kernels' t is an ulp off the plain walk's, and a
    photon reflected off a curved mirror after such a hit drifts
    further)."""
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.numpy() for k, v in want.items()}
    assert set(g) == set(w)
    for k in ("valid", "vol", "bounce", "b_valid", "pl_valid"):
        if k in g:
            assert (g[k] == w[k]).mean() >= 0.999, k
    for k, v in (("pos", "valid"), ("dir", "valid"), ("power", "valid"),
                 ("b_o", "b_valid"), ("b_pow", "b_valid"),
                 ("pl_p1", "pl_valid"), ("pl_pow", "pl_valid")):
        if k not in g or not (g[v] & w[v]).any():
            continue
        m = g[v] & w[v]
        for share, rtol, atol in ((0.95, 1e-5, 1e-6), (0.995, 1e-3, 1e-4)):
            ok = np.isclose(g[k], w[k], rtol=rtol, atol=atol)
            ok = ok.reshape(len(ok), -1).all(-1)[m]
            assert ok.mean() >= share, (k, rtol, ok.mean())
    assert abs(int(g["rays"]) / int(w["rays"]) - 1.0) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("volume", [None, "planes"])
def test_cuda_photons_match_plain_path(cuda_device, volume):
    """The photon pass on the card (its walk on K1) against the plain
    path on the CPU, slot for slot (_photons_agree); then the grids
    built on the card from the CPU's photons are the CPU's bitwise, and
    the gathers on them select the same photons (the k nearest bitwise)
    and estimate within rtol 1e-5 (atol 1e-6 of the largest)."""
    from tungsten_tpu_torch.integrators import photon_map as pm
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.utils import vecmath as vm
    scene, settings = flatten_scene(_photon_desc(volume))
    cpu_scene = scene.to("cpu")
    before = dict(twt.LAUNCHES)
    got = pm.trace_photons(scene, settings, 8192, 7)
    assert twt.LAUNCHES["closest"] > before["closest"]
    want = pm.trace_photons(cpu_scene, settings, 8192, 7)
    _photons_agree(got, want)
    assert want["valid"].float().mean() > 0.05

    cpu = {k: v for k, v in want.items() if k != "rays"}
    dev = {k: v.to(cuda_device) for k, v in cpu.items()}
    r = 0.3
    kinds = [("surf", pm.build_photon_grid,
              lambda ph: dict(ph, valid=ph["valid"] & ~ph["vol"]))]
    if volume:
        kinds += [("vol", pm.build_photon_grid,
                   lambda ph: dict(ph, valid=ph["valid"] & ph["vol"])),
                  ("beam", pm.build_beam_grid, lambda ph: ph),
                  ("plane", pm.build_plane_grid, lambda ph: ph)]
    grids = {}
    for name, build, pick in kinds:
        gc, gg = build(pick(cpu), r), build(pick(dev), r)
        for k, v in gc.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(gg[k].cpu(), v), (name, k)
            else:
                assert gg[k] == v, (name, k)
        assert gc["key"].shape[0] > 0, name
        grids[name] = (gc, gg)

    rng = np.random.default_rng(4)
    pos = want["pos"][want["valid"]].numpy()
    p = (pos[rng.integers(0, len(pos), 512)]
         + rng.uniform(-0.1, 0.1, (512, 3))).astype(np.float32)
    pc = torch.from_numpy(p)
    K = settings.gather_count
    sel_c = pm._knn(grids["surf"][0], r, K, pc)
    sel_g = pm._knn(grids["surf"][1], r, K, pc.to(cuda_device))
    for a, b in zip(sel_c, sel_g):
        assert torch.equal(a, b.cpu())
    assert torch.isfinite(sel_c[0]).sum() > 1000

    def close(a, b):
        b = b.cpu()
        atol = 1e-6 * max(float(a.abs().max()), 1e-30)
        return bool(torch.isclose(b, a, rtol=1e-5, atol=atol).all())

    n = p.shape[0]
    ns = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3).contiguous()
    tan, bit = (x.contiguous() for x in vm.ortho_frame(ns))
    wi = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    wi[:, 2] = wi[:, 2].abs()
    wi = wi / wi.norm(dim=-1, keepdim=True)
    bsdf = torch.zeros((n,), dtype=torch.int64)
    uv = torch.zeros((n, 2))
    cb = torch.ones((n,), dtype=torch.int32)
    args = (pc, (tan, bit, ns), wi, bsdf, uv, cb)
    est_c = pm._gather_estimate(cpu_scene, settings, grids["surf"][0], r,
                                *args)
    est_g = pm._gather_estimate(
        scene, settings, grids["surf"][1], r,
        *[tuple(x.to(cuda_device) for x in a) if isinstance(a, tuple)
          else a.to(cuda_device) for a in args])
    assert close(est_c, est_g) and float(est_c.sum()) > 0
    if not volume:
        return
    ptype = cpu_scene.med_phase[:1].expand(n).contiguous()
    pg = cpu_scene.med_g[:1].expand(n).contiguous()
    vc = pm._gather_volume(cpu_scene, settings, grids["vol"][0], r, pc, -wi,
                           ptype, pg)
    vg = pm._gather_volume(scene, settings, grids["vol"][1], r,
                           pc.to(cuda_device), -wi.to(cuda_device),
                           ptype.to(cuda_device), pg.to(cuda_device))
    assert close(vc, vg) and float(vc.sum()) > 0
    o = torch.tensor([0.0, 0.6, 4.0]).expand(64, 3).contiguous()
    tgt = torch.from_numpy(rng.uniform([-2, -1, -2], [2, 2, 2], (64, 3))
                           .astype(np.float32))
    d = (tgt - o) / (tgt - o).norm(dim=-1, keepdim=True)
    t1 = torch.full((64,), 5.0)
    before = dict(twt.LAUNCHES)
    for kind in ("beam", "plane"):
        if kind == "beam":
            ec = pm._beam_eval(cpu_scene, settings, grids[kind][0], r, o, d,
                               t1)
            eg = pm._beam_eval(scene, settings, grids[kind][1], r,
                               o.to(cuda_device), d.to(cuda_device),
                               t1.to(cuda_device))
        else:
            ec = pm._plane_eval(cpu_scene, settings, grids[kind][0], o, d, t1)
            eg = pm._plane_eval(scene, settings, grids[kind][1],
                                o.to(cuda_device), d.to(cuda_device),
                                t1.to(cuda_device))
        assert close(ec, eg) and float(ec.sum()) > 0, kind
    assert twt.LAUNCHES["anyhit"] > before["anyhit"]


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,volume", [
    ("photon_map", None), ("progressive_photon_map", None),
    ("photon_map", "points"), ("photon_map", "beams"),
    ("photon_map", "planes")])
def test_cuda_photon_render_matches_plain_path(cuda_device, integrator,
                                               volume):
    """A photon-map render (32x24, 2 spp) on the card against the plain
    path on the CPU under phase 6's gates: K1 launches, and K2 too in
    planes mode (the planes' shadow rays)."""
    from dataclasses import replace
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_photon_desc(volume))
    settings = replace(settings, integrator_type=integrator)
    before = dict(twt.LAUNCHES)
    gpu = render(scene, settings, spp=2, seed=7, spp_chunk=2)
    assert twt.LAUNCHES["closest"] > before["closest"]
    assert (twt.LAUNCHES["anyhit"] > before["anyhit"]) == (volume == "planes")
    cpu = render(scene.to("cpu"), settings, spp=2, seed=7, spp_chunk=2,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3


def test_photon_render_takes_cuda_by_default():
    """device=None means CUDA for a photon-map scene as for the others:
    with a card the scene flattens onto it and renders through K1;
    without one flatten_scene and render raise, naming CUDA."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    desc = _photon_desc()
    desc.camera["resolution"] = [8, 6]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flatten_scene(desc)
        scene, settings = flatten_scene(desc, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            render(scene, settings, spp=1)
        return
    scene, settings = flatten_scene(desc)
    assert scene.device.type == "cuda"
    before = twt.LAUNCHES["closest"]
    img = render(scene, settings, spp=1)
    assert twt.LAUNCHES["closest"] > before and img.mean() > 0


# ------------------------------------------------ MLT (tapes on K1 and K2)

def _mlt_tapes(settings, R, dev):
    from tungsten_tpu_torch.integrators import mlt
    tape = mlt._uniform_tape(0x1A4E, 0, 0, R, mlt.tape_dims(settings), dev)
    b_pick = torch.clamp((mlt._uniform_tape(0xB1C, 0, 0, R, 1, dev)[:, 0]
                          * settings.max_bounces).to(torch.int32),
                         max=settings.max_bounces - 1)
    return tape, b_pick


@pytest.mark.cuda
def test_cuda_mlt_tape_lanes_match_plain_path(cuda_device):
    """trace_tape and trace_tape_rj of 4,096 chains on the card, whose
    body sorts its rays by the traversal key and whose staged loop
    compacts (4,096 -> 2,048 -> 1,024 lanes), against the plain path on
    the CPU lane for lane: each lane reads its own chain's tape row
    wherever the sort and the compactions move it.  Radiance and pixel
    within rtol 1e-4 / atol 1e-6, the rj flags equal, rj_dims / rj_nee
    within rtol 1e-4 / atol 1e-5, each on >= 0.999 of lanes; K1 and K2
    launch."""
    from dataclasses import replace
    from tungsten_tpu_torch.integrators import mlt
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_bdpt_desc())
    s = replace(settings, integrator_type="reversible_jump_mlt",
                stratified_sampler=False)
    cpu_scene = scene.to("cpu")
    tape, b_pick = _mlt_tapes(s, 4096, cuda_device)
    before = dict(twt.LAUNCHES)
    got = mlt.trace_tape(scene, s, tape, 7)
    assert twt.LAUNCHES["closest"] > before["closest"]
    assert twt.LAUNCHES["anyhit"] > before["anyhit"]
    want = mlt.trace_tape(cpu_scene, s, tape.cpu(), 7)

    def share(a, b, rtol=1e-4, atol=1e-6):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        ok = a == b if a.dtype.kind in "biu" else \
            np.isclose(a, b, rtol=rtol, atol=atol)
        return ok.reshape(a.shape[0], -1).all(-1).mean()

    assert share(got[0], want[0]) >= 0.999
    assert share(got[1], want[1]) == 1.0
    assert float(got[2].sum()) > 0
    got = mlt.trace_tape_rj(scene, s, tape, b_pick, 7)
    want = mlt.trace_tape_rj(cpu_scene, s, tape.cpu(), b_pick.cpu(), 7)
    for k in (1, 3):
        assert share(got[k], want[k]) >= 0.999, k
    for k in (0, 2):
        assert share(got[k], want[k], 1e-4, 1e-5) >= 0.999, k
    assert got[1].float().mean() > 0.05 and bool(got[3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["kelemen_mlt", "reversible_jump_mlt",
                                        "multiplexed_mlt"])
def test_cuda_mlt_render_matches_plain_path(cuda_device, integrator):
    """A render of each MLT integrator (32x24, 768 chains, 1 mutation a
    pixel; kelemen and multiplexed on the bidirectional tape) on the card
    against the plain path on the CPU: the chains follow the same
    trajectories but where a rounding flips an acceptance, so the
    images' means agree within 2 %."""
    from dataclasses import replace
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_bdpt_desc())
    s = replace(settings, integrator_type=integrator, mlt_sample_pool=3072)
    gpu = render(scene, s, spp=1, seed=7)
    cpu = render(scene.to("cpu"), s, spp=1, seed=7, device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 0.02, integrator


def _exporter_obj(pos, nrm, uv, idx) -> str:
    """Each triangle's corners as v / vt / vn lines just before `f -3/-3/-3
    -2/-2/-2 -1/-1/-1`, every float as repr of its f32 value."""
    out = []
    for tri in idx:
        for arr, tag in ((pos, "v"), (uv, "vt"), (nrm, "vn")):
            out += [tag + " " + " ".join(repr(float(x)) for x in arr[k])
                    for k in tri]
        out.append("f -3/-3/-3 -2/-2/-2 -1/-1/-1")
    return "\n".join(out) + "\n"


def _ball(nu=16, nv=8):
    th = np.pi * np.arange(nv + 1) / nv
    ph = 2.0 * np.pi * np.arange(nu + 1) / nu
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    pos = np.stack([st * np.cos(ph), np.broadcast_to(ct, (nv + 1, nu + 1)),
                    st * np.sin(ph)], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack(np.meshgrid(np.arange(nu + 1) / nu, np.arange(nv + 1) / nv),
                  -1).reshape(-1, 2).astype(np.float32)
    tris = [t for i in range(nv) for j in range(nu)
            for t, keep in (((i * (nu + 1) + j, i * (nu + 1) + j + 1,
                              (i + 1) * (nu + 1) + j), i > 0),
                            ((i * (nu + 1) + j + 1, (i + 1) * (nu + 1) + j + 1,
                              (i + 1) * (nu + 1) + j), i < nv - 1)) if keep]
    return pos, pos.copy(), uv, np.asarray(tris, np.int32)


@pytest.mark.cuda
def test_cuda_obj_mesh_scene_matches_wo3(cuda_device, tmp_path):
    """An exporter-style OBJ mesh loads to the same Mesh bitwise through
    the native loader and the Python parser (material 0), its scene
    flattens on the card to the tables of the same mesh stored as .wo3,
    field for field, and a 1-spp render (one sample a pixel, so the
    frame's atomic adds are exact) launches K1 and K2 and gives the .wo3
    scene's image bitwise."""
    import json
    from dataclasses import fields
    from tungsten_tpu_torch.io import mesh as tmesh
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import FlatScene, load_flat_scene
    pos, nrm, uv, idx = _ball()
    (tmp_path / "ball.obj").write_text(_exporter_obj(pos, nrm, uv, idx))
    tmesh.save_wo3(str(tmp_path / "ball.wo3"), tmesh.Mesh(
        pos=pos, normal=nrm, uv=uv, indices=idx,
        material=np.zeros(len(idx), np.int32)))
    nat = tmesh.load_obj(str(tmp_path / "ball.obj"))
    py = tmesh.load_obj_python(str(tmp_path / "ball.obj"))
    for k in ("pos", "normal", "uv", "indices", "material"):
        assert getattr(nat, k).tobytes() == getattr(py, k).tobytes(), k
    assert not nat.material.any()
    imgs, scenes = [], []
    for ext in ("obj", "wo3"):
        sj = {"bsdfs": [{"name": "d", "type": "lambert", "albedo": 0.6},
                        {"name": "m", "type": "mirror", "albedo": 0.9}],
              "primitives": [
                  {"type": "quad", "bsdf": "d",
                   "transform": {"position": [0, -0.5, 0],
                                 "scale": [8, 1, 8]}},
                  {"type": "quad", "bsdf": "d", "emission": [9.0, 8.0, 7.0],
                   "transform": {"position": [0, 2.5, 0], "scale": [2, 1, 2],
                                 "rotation": [0, 0, 180]}},
                  {"type": "mesh", "file": f"ball.{ext}", "bsdf": "d",
                   "transform": {"position": [-0.6, 0, 0], "scale": 0.5}},
                  {"type": "mesh", "file": f"ball.{ext}", "bsdf": "m",
                   "transform": {"position": [0.6, 0.1, 0.2],
                                 "scale": 0.45}}],
              "camera": {"type": "pinhole", "resolution": [32, 24],
                         "fov": 50, "transform": {"position": [0, 1.5, 4],
                                                  "look_at": [0, 0, 0]}},
              "integrator": {"type": "path_tracer", "max_bounces": 4}}
        path = tmp_path / f"{ext}.json"
        path.write_text(json.dumps(sj))
        scene, settings = load_flat_scene(str(path))
        assert scene.device.type == "cuda"
        before = dict(twt.LAUNCHES)
        imgs.append(render(scene, settings, spp=1, seed=5))
        assert all(twt.LAUNCHES[k] > before[k] for k in ("closest", "anyhit"))
        scenes.append(scene)
    for f in fields(FlatScene):
        a, b = getattr(scenes[0], f.name), getattr(scenes[1], f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif isinstance(a, (list, tuple)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), f.name
    assert imgs[0].mean() > 0 and np.array_equal(imgs[0], imgs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_segment_sum_matches_plain(cuda_device, dtype):
    """S1 (csrc/segment_sum.cu) bitwise its plain version on the CPU:
    unsorted ids with empty and long segments (stable-sorted on the
    card), rows keyed by (id, sample), sorted ids added into a non-zero
    output, unique unsorted lanes; one launch a call."""
    from tungsten_tpu_torch.ops import segment_sum as tss
    g = np.random.default_rng(31)
    P, N = 50_000, 700
    ids = g.integers(0, N // 2, P) * 2        # the odd outputs empty
    ids[g.uniform(size=P) < 0.3] = 6          # one long segment
    ids = torch.from_numpy(ids)
    v = torch.from_numpy(g.standard_normal((P, 3)) *
                         10.0 ** g.integers(-3, 3, (P, 1))).to(dtype)
    base = torch.from_numpy(g.standard_normal((N, 3))).to(dtype)
    dev = cuda_device
    before = tss.LAUNCHES["segment_sum"]
    got = tss.ordered_index_add(base.to(dev), ids.to(dev), v.to(dev))
    assert tss.LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(got.cpu(), base.clone().index_add_(0, ids, v))
    sample = torch.from_numpy(g.integers(0, 64, P))
    key = (ids << 31) | sample
    got = tss.ordered_index_add(torch.zeros((N, 3), dtype=dtype,
                                            device=dev), ids.to(dev),
                                v.to(dev), key=key.to(dev))
    seg, perm = tss.sort_rows(ids, key)
    assert torch.equal(got.cpu(), tss.segment_sum_plain(
        torch.zeros((N, 3), dtype=dtype), seg, v, perm))
    srt = torch.sort(ids).values
    got = tss.ordered_index_add(base.to(dev), srt.to(dev), v.to(dev),
                                grouped=True)
    assert torch.equal(got.cpu(), base.clone().index_add_(0, srt, v))
    lanes = torch.from_numpy(g.permutation(P))
    got = tss.ordered_index_add(torch.zeros((P, 3), dtype=dtype,
                                            device=dev), lanes.to(dev),
                                v.to(dev), grouped=True)
    assert torch.equal(got.cpu(), torch.zeros((P, 3), dtype=dtype)
                       .index_add_(0, lanes, v))
    # runs of 64 rows, then the runs: the CPU's blocked sums bitwise
    got = tss.ordered_index_add(base.to(dev), ids.to(dev), v.to(dev),
                                block=64)
    assert torch.equal(got.cpu(), tss.ordered_index_add(
        base.clone(), ids, v, block=64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((70000,), 0), ((4096, 5), -1),
                                       ((300, 96), 1), ((40, 30, 7), 0)])
def test_cuda_ordered_cumsum_is_the_cpu_cumsum(cuda_device, shape, dim):
    """S1's scan entry bitwise torch.cumsum on the CPU (float rows summed
    in double on both), f32 and f64, and its backward the CPU's."""
    from tungsten_tpu_torch.ops import segment_sum as tss
    g = np.random.default_rng(32)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(g.standard_normal(shape) * 1e3).to(dtype)
        before = tss.LAUNCHES["ordered_scan"]
        got = tss.ordered_cumsum(x.to(cuda_device), dim)
        assert tss.LAUNCHES["ordered_scan"] == before + 1
        assert torch.equal(got.cpu(), torch.cumsum(x, dim))
        w = torch.from_numpy(g.standard_normal(shape)).to(dtype)
        xh = x.clone().requires_grad_()
        xc = x.clone().to(cuda_device).requires_grad_()
        (torch.cumsum(xh, dim) * w).sum().backward()
        (tss.ordered_cumsum(xc, dim) * w.to(cuda_device)).sum().backward()
        assert torch.equal(xc.grad.cpu(), xh.grad)


@pytest.mark.cuda
def test_cuda_renders_repeat_bitwise(cuda_device):
    """The same small scene, settings and seed rendered twice on the card
    gives the same frame bit for bit, through the path tracer (its banks
    through S1, its light choice through the scan), BDPT and the light
    tracer (their splats through S1), without any process-wide
    determinism switch."""
    from dataclasses import replace
    from tungsten_tpu_torch.ops import segment_sum as tss
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    desc = SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
               {"type": "mirror", "albedo": 1.0}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0, "emission": [1.0, 2.0, 3.0],
             "transform": {"position": [2.4, 0.5, 0], "rotation": [0, 0, 90]}},
            {"type": "quad", "bsdf_index": 1,
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf_index": 0,
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.8}}],
        media=[], camera={"type": "pinhole", "resolution": [48, 32],
                          "fov": 60,
                          "transform": {"position": [0, 0.6, 4.0],
                                        "look_at": [0, 0.0, 0]}},
        integrator={"max_bounces": 8}, renderer={"spp": 16})
    scene, settings = flatten_scene(desc)
    assert not torch.are_deterministic_algorithms_enabled()
    for integ in ("path_tracer", "bidirectional_path_tracer",
                  "light_tracer"):
        s = replace(settings, integrator_type=integ)
        before = dict(tss.LAUNCHES)
        a = render(scene, s, spp=16, seed=7, spp_chunk=16)
        assert tss.LAUNCHES["segment_sum"] > before["segment_sum"], integ
        b = render(scene, s, spp=16, seed=7, spp_chunk=16)
        assert a.mean() > 0 and np.array_equal(a, b), integ


@pytest.mark.cuda
def test_cuda_replay_gradients_repeat_bitwise(cuda_device):
    """Path-replay gradients of a small scene twice on the card: L and
    every gradient bit for bit (take's backward sums in a fixed order,
    where F.embedding's CUDA backward adds with atomics)."""
    from tungsten_tpu_torch.integrators.path_tracer import trace_wave_replay
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import SceneDesc
    desc = SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
               {"type": "rough_conductor", "roughness": 0.3}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0, "emission": [1.0, 2.0, 3.0],
             "transform": {"position": [2.4, 0.5, 0], "rotation": [0, 0, 90]}},
            {"type": "quad", "bsdf_index": 1,
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "cube", "bsdf_index": 0,
             "transform": {"position": [0.3, -0.4, 0], "scale": 0.8}}],
        media=[], camera={"type": "pinhole", "resolution": [64, 64],
                          "fov": 60,
                          "transform": {"position": [0, 0.6, 4.0],
                                        "look_at": [0, 0.0, 0]}},
        integrator={"max_bounces": 6}, renderer={"spp": 4})
    scene, settings = flatten_scene(desc)
    n = settings.width * settings.height
    pixel = torch.arange(n, dtype=torch.int32, device=cuda_device).repeat(4)
    sample = torch.arange(4, dtype=torch.int32,
                          device=cuda_device).repeat_interleave(n)
    runs = []
    for _ in range(2):
        leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
                  for k in ("tex_const", "light_emission", "bsdf_params")}
        L = trace_wave_replay(scene.replace(**leaves), settings, pixel,
                              sample, 7)
        L.mean().backward()
        runs.append((L.detach(), {k: v.grad for k, v in leaves.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, grad in runs[0][1].items():
        assert torch.isfinite(grad).all() and grad.abs().max() > 0, k
        assert torch.equal(grad, runs[1][1][k]), k
