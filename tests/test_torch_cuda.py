"""The CUDA wave kernels on the card (marked `cuda`; they skip without a
CUDA device).  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On the random-soup fixture of tests/test_wave.py (700 triangles, 2048
rays; regenerated here with numpy) both kernel modes pass that file's
gates against the f32 brute force and against the plain walk on the same
device, and a small render through the kernels matches the plain path.
The paged kernel (both modes) passes the same gates on the 5,000-triangle
soup of tests/test_paged.py with the page shrunk to one super, and
agrees with the resident kernel ray for ray.
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
               for k in ("paged_closest", "paged_anyhit"))
    cpu = render(scene.to("cpu"), settings, spp=4, seed=7, spp_chunk=4,
                 device="cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    assert abs(gpu.mean() / cpu.mean() - 1.0) <= 5e-3

    # the same scene through the paged walk (the threshold lowered to 0
    # and a page of one super): only the paged kernels launch, and the
    # image is the resident path's up to traversal-order ties
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twt, "PAGED_ATTR_BYTES", 0)
        mp.setattr(twt, "PAGE_SUP", 1)
        before = dict(twt.LAUNCHES)
        paged = render(scene, settings, spp=4, seed=7, spp_chunk=4)
        assert all(twt.LAUNCHES[k] > before[k]
                   for k in ("paged_closest", "paged_anyhit"))
        assert all(twt.LAUNCHES[k] == before[k] for k in ("closest", "anyhit"))
    close = np.isclose(paged, gpu, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    assert abs(paged.mean() / gpu.mean() - 1.0) <= 5e-3


@pytest.fixture
def one_super_pages(monkeypatch):
    monkeypatch.setattr(twt, "PAGE_SUP", 1)


@pytest.mark.cuda
def test_cuda_paged_kernel_passes_wave_gates(cuda_device, one_super_pages):
    """The paged kernel over several pages: test_wave.py's gates against
    the brute force and the plain walk, closest hit and any hit; against
    the resident kernel on the same rays the hit set is equal and the
    triangle too except where the two t are equal (ties)."""
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

    # raw kernel outputs against the resident kernel, any hit and closest
    args = [torch.from_numpy(x).to(cuda_device) for x in (o, d, tmin, tmax)]
    o_s, d_s, tmin_s, tmax_s, _ = tis.dispatch_rays(sc, *args)
    f, sent, sids, pages, offs, offe, _ = twt.paged_kernel_inputs(
        sc, o_s, d_s, tmin_s, tmax_s)
    f1, sent1, sids1, _ = twt.kernel_inputs(sc, o_s, d_s, tmin_s, tmax_s)
    assert torch.equal(f, f1)
    for any_hit in (False, True):
        t3, tri3, tests3 = twt.paged_kernel(f, sent, sids, pages, offs, offe,
                                            sc.wk_cbox, sc.wk_attr, any_hit)
        t1, tri1, _ = twt.wave_kernel(f1, sent1, sids1, sc.wk_cbox,
                                      sc.wk_attr, any_hit)
        assert torch.equal(tri3 >= 0, tri1 >= 0)
        if any_hit:
            assert torch.equal(t3 <= -1.0, tri3 >= 0)
        else:
            assert bool(((tri3 == tri1) | (t3 == t1)).all())
            assert bool((tri3 == tri1).float().mean() > 0.999)
        need, ran = tests3[0], tests3[1]
        assert bool((need <= ran).all()) and int(need.sum()) > 0
        assert bool((ran[tmax_s <= 0] == 0).all())

    tmax_b = np.where(live, np.float32(1.25), np.float32(0.0))
    _, tri_a, _, _ = _hits(twt.wave_intersect_paged, sc, order, o, d, tmin,
                           tmax_b, True)
    assert twt.LAUNCHES["paged_anyhit"] == before["paged_anyhit"] + 2
    _, bi_b, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax_b)
    assert ((tri_a >= 0) == (bi_b >= 0))[live].mean() > 0.998
    _, tri_k2, _, _ = _hits(twt.wave_intersect, sc, order, o, d, tmin,
                            tmax_b, True)
    assert np.array_equal(tri_a >= 0, tri_k2 >= 0)
    assert (tri_a[~live] == -1).all()


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
        twt.paged_kernel(f, lists, lists.int(), pages, rng.float(), rng,
                         cbox, attr, False)
    with pytest.raises(ValueError, match="pages"):
        twt.paged_kernel(f, lists, lists.int(), pages.float(), rng, rng,
                         cbox, attr, False)
