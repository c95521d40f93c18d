"""The paged traversal of the port (ops/wave_trace.py: _cull_paged,
traversal_kind, wave_intersect_paged) against the JAX package on the
CPU, with the page shrunk to one super (16 clusters) as
tests/test_paged.py shrinks it, so the soup fixtures span many pages:

  * the paged front equals JAX's _cull_paged: pages, offs and offe
    exactly, sent bit-equal, sids wherever the entry is finite and
    untied (JAX sorts on (page, entry) with an unstable sort);
  * traversal_kind picks the paged walk from 13 MiB of attribute table
    up, exactly the JAX package's rule, and the dispatch follows it;
  * wave_intersect_paged on CPU tensors (the plain walk) passes
    test_paged.py's brute-force gates, closest hit and any hit.
The CUDA kernel is held to the same gates on the card by
tests/test_torch_cuda.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.ops import wave_trace as jwt
from tungsten_tpu_torch.ops import intersect as tis
from tungsten_tpu_torch.ops import wave_trace as twt
from tungsten_tpu_torch.scene.bvh import build_bvh
from test_torch_wave import _bvh_scene
from test_wave import _brute, _rays
from test_wave import _scene as _soup


@pytest.fixture
def one_super_pages(monkeypatch):
    """PAGE_SUP 1 in both packages (both read it at call time; the JAX
    package keeps its clusters per page in a second global)."""
    monkeypatch.setattr(twt, "PAGE_SUP", 1)
    monkeypatch.setattr(jwt, "PAGE_SUP", 1)
    monkeypatch.setattr(jwt, "PAGE_CLUSTERS", jwt.SUP)


def _bundles(R, seed=9):
    """Rays from outside the soup in coherent 32-ray bundles (one origin,
    a narrow cone), as the dispatch's sort makes them, so the entries of
    a warp's supers differ; every fifth ray is a bounded segment and
    every seventh is dead."""
    r = np.random.default_rng(seed)
    nb = R // twt.SUBWARP
    o = r.normal(size=(nb, 3))
    o = np.repeat(o * 8.0 / np.linalg.norm(o, axis=-1, keepdims=True),
                  twt.SUBWARP, axis=0)
    aim = np.repeat(r.uniform(-2, 2, (nb, 3)), twt.SUBWARP, axis=0)
    d = aim + r.uniform(-0.3, 0.3, aim.shape) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[1::5] = 1.25
    tmax[::7] = 0.0
    return o.astype(np.float32), d.astype(np.float32), tmin, tmax


def test_cull_paged_equals_jax(one_super_pages):
    v0, e1, e2, _ = _soup(num_tris=20000)
    cbox, sbox = twt.build_wave_tables(v0, e1, e2)[1::3]
    n_pages = -(-cbox.shape[0] // twt.page_clusters())
    assert n_pages > 8
    o, d, tmin, tmax = _bundles(2 * twt.BLOCK)
    G = o.shape[0] // twt.BLOCK
    jp, js, ji, jo, je = map(np.asarray, jwt._cull_paged(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin)[:, None],
        jnp.asarray(tmax)[:, None], jnp.asarray(sbox), G, n_pages))
    tp, ts, ti, to, te = (x.numpy() for x in twt._cull_paged(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmin)[:, None], torch.from_numpy(tmax)[:, None],
        torch.from_numpy(sbox), G, n_pages))
    for name, a, b in (("pages", jp, tp), ("offs", jo, to), ("offe", je, te)):
        assert a.dtype == b.dtype == np.int32, name
        assert np.array_equal(a, b), name
    assert js.tobytes() == ts.tobytes()          # entries bit for bit
    # the walk sees several pages per block, and pad slots stay empty
    npg = (je > jo).any(axis=1).sum(-1)
    assert npg.min() > 1
    assert (jo[..., npg.max():] == je[..., npg.max():]).all()
    # ids where the entry is finite and not tied with a neighbour
    fin = js < 3e38
    tie = np.zeros_like(fin)
    tie[..., 1:] |= js[..., 1:] == js[..., :-1]
    tie[..., :-1] |= js[..., :-1] == js[..., 1:]
    sel = fin & ~tie
    assert sel.sum() > 100
    assert np.array_equal(ji[sel], ti[sel])
    # every id lies on the page its slot range names
    for g in range(G):
        for w in range(8):
            for s in range(n_pages):
                ids = ti[g, w, to[g, w, s]:te[g, w, s]]
                assert (ids // twt.PAGE_SUP == tp[g, s]).all()


def test_traversal_kind_threshold():
    """Paged from 13 MiB of attribute table up, resident below (the JAX
    package: wk_attr.size * 4 < 13 MiB takes the resident kernel)."""
    rows = twt.PAGED_ATTR_BYTES // (4 * twt.CLUSTER)

    def scene(n):
        return SimpleNamespace(wk_attr=torch.empty((n, twt.CLUSTER),
                                                   device="meta"))
    assert twt.PAGED_ATTR_BYTES == 13 * 1024 * 1024
    assert twt.traversal_kind(scene(rows)) == "paged"
    assert twt.traversal_kind(scene(rows + 16)) == "paged"
    assert twt.traversal_kind(scene(rows - 16)) == "resident"
    assert twt.traversal_kind(scene(16)) == "resident"


@pytest.mark.parametrize("any_hit", [False, True])
def test_dispatch_follows_traversal_kind(monkeypatch, any_hit):
    """_wave_dispatch calls the paged walk for a paged scene and the
    resident walk otherwise, for both closest and any hit."""
    v0, e1, e2, _ = _soup()
    sc, _ = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    o, d = _rays(twt.BLOCK)
    args = (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((twt.BLOCK,), 1e-4), torch.full((twt.BLOCK,), 3e38))
    calls = []
    for name in ("wave_intersect", "wave_intersect_paged"):
        real = getattr(twt, name)

        def spy(*a, real=real, name=name, **k):
            calls.append((name, k["any_hit"]))
            return real(*a, **k)
        monkeypatch.setattr(twt, name, spy)
    for limit, want in ((1 << 40, "wave_intersect"),
                        (0, "wave_intersect_paged")):
        monkeypatch.setattr(twt, "PAGED_ATTR_BYTES", limit)
        calls.clear()
        tis._wave_dispatch(sc, *args, any_hit=any_hit)
        assert calls == [(want, any_hit)]


def test_paged_matches_bruteforce(one_super_pages):
    """tests/test_paged.py's gates for wave_intersect_paged on CPU
    tensors: hit set > 0.998, t to rtol 1e-4 and the triangle > 0.99
    where both hit; any hit > 0.998."""
    v0, e1, e2, _ = _soup(num_tris=5000, seed=5)
    sc, order = _bvh_scene(v0, e1, e2, torch.from_numpy, build_bvh)
    assert twt.n_pages_of(sc) >= 3
    R = twt.BLOCK
    o, d = _rays(R, seed=6)
    tmin = np.full((R,), 1e-4, np.float32)
    tmax = np.full((R,), 3e38, np.float32)
    tmax[::5] = 0.0
    t, tri, _, _ = twt.wave_intersect_paged(
        sc, *(torch.from_numpy(x) for x in (o, d, tmin, tmax)),
        device="cpu")
    t, tri = t.numpy(), tri.numpy()
    tri = np.where(tri >= 0, order[np.clip(tri, 0, None)], -1)
    bt, bi, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    live = tmax > 0
    hit_ref = (bi >= 0) & live
    assert ((tri >= 0) == hit_ref).mean() > 0.998
    both = hit_ref & (tri >= 0)
    np.testing.assert_allclose(t[both], bt[both], rtol=1e-4)
    assert (tri[both] == bi[both]).mean() > 0.99

    tmax = np.full((R,), 3e38, np.float32)
    _, tri_a, _, _ = twt.wave_intersect_paged(
        sc, *(torch.from_numpy(x) for x in (o, d, tmin, tmax)),
        any_hit=True, device="cpu")
    _, bi, _, _ = _brute(v0, e1, e2, o, d, 1e-4, tmax)
    assert ((tri_a.numpy() >= 0) == (bi >= 0)).mean() > 0.998


def test_paged_wrapper_refuses_bad_page_size(monkeypatch):
    """A page larger than the kernel's shared-memory page, or an empty
    one, is refused before any launch."""
    sc = SimpleNamespace(wk_cbox=torch.zeros((512, 8)))
    assert twt.page_clusters() == twt.MAX_PAGE_CLUSTERS
    assert twt.n_pages_of(sc) == 2
    monkeypatch.setattr(twt, "PAGE_SUP", 1)
    assert twt.n_pages_of(sc) == 32
    for bad in (32, 0):
        monkeypatch.setattr(twt, "PAGE_SUP", bad)
        with pytest.raises(ValueError, match="PAGE_SUP"):
            twt.n_pages_of(sc)
