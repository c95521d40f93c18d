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
        sph_radius=t(np.zeros((0,), np.float32))), o


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
