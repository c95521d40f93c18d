"""The port's ordered float accumulation (ops/segment_sum.py: the
wrappers of kernel S1, csrc/segment_sum.cu) on the CPU.

S1 runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it there against its plain version).  Here, on numpy-seeded inputs
with repeated, empty and long segments, in float32 and float64:

  * S1's plain version, and a step-by-step emulation of the kernel's
    tile walk (a CTA a tile of sorted rows: its heads found by a
    block-wide scan, the owned rows staged, one fold a (head, column),
    the segment that runs past the tile carried through chunks of half
    a tile, ids outside the output skipped), are bitwise `index_add_`
    at several tile sizes, and the emulated walk on float64 agrees with
    `jax.ops.segment_sum`;
  * the CUDA path's preparation (a stable sort of the ids, or of the
    bank's (pixel, sample) key) gives the same sums bitwise as
    `index_add_` on the unsorted rows;
  * index_sums' side-by-side columns equal separate index_add_ calls;
  * the blocked order (runs of `block` rows, then the runs), and take's
    backward on the card (utils/vecmath.py::_Take) that uses it, equal a
    step-by-step emulation bitwise;
  * the ordered scan's arithmetic (double accumulation, left to right or
    right to left) is the CPU's float cumsum and its derivative bit for
    bit, and an emulation of the long path's exact parallel scan (TwoSum
    on every add, the chunk refolded in order where one is inexact)
    gives the same bits, taking the exact path or the refold where it
    should;
  * the wrappers take the plain version for CPU tensors and refuse any
    other device rather than fall back;
  * no float scatter-add or float cumsum is left in the package outside
    the wrapper module, but the integer and unique-index sites listed
    below, and nothing calls torch.use_deterministic_algorithms.
"""
import ast
import os

import jax
import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import segment_sum as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tungsten_tpu_torch")
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
# csrc/segment_sum.cu: threads a segment-sum CTA (a tile is a multiple),
# and the long scan path's threads and largest chunk in bytes
SS_THREADS = 256
LONG_THREADS, LONG_CHUNK_BYTES = 512, 64 * 1024


def _long_chunk(L, item):
    """The long scan path's chunk for rows of L elements of `item` bytes:
    the row rounded up to the threads, at most 64 KB."""
    return min(-(-L // LONG_THREADS) * LONG_THREADS, LONG_CHUNK_BYTES // item)


def _ids(r, P, N):
    """P ids into N outputs: every third output empty, output 8 a long
    segment (a third of the rows), the rest spread."""
    used = np.array([i for i in range(N) if i % 3 != 1])
    ids = r.choice(used, size=P)
    ids[r.uniform(size=P) < 1 / 3] = 8
    return ids


def _values(r, P, C, np_t):
    # magnitudes over six decades, so the order of the adds shows
    return (r.standard_normal((P, C)) *
            10.0 ** r.integers(-3, 3, size=(P, 1))).astype(np_t)


def _s1_emulated(out, seg, v, perm=None, tile=SS_THREADS, walk=None):
    """csrc/segment_sum.cu's segment_sum_kernel step for step in numpy,
    CTA by CTA: the tile's heads (a row whose id differs from the row
    before), the owned rows (from the first head on, rows of ids outside
    [0, N) skipped) staged, each owned segment folded from the staged
    rows in row order into its output row, and a segment that runs past
    the tile carried through the following chunks of tile / 2 rows (a
    chunk's rows of the segment are those with its id) and written once.
    Each output row is written by one CTA at most.  `walk`, a list, gets
    a (t0, heads, first head, runs on, chunks) record a tile."""
    assert tile % SS_THREADS == 0
    P, C = v.shape
    N = out.shape[0]
    ch = tile // 2
    written = np.zeros(N, bool)
    for t0 in range(0, P, tile):
        n = min(tile, P - t0)
        ids = seg[t0:t0 + n]
        head = np.ones(n, bool)
        head[1:] = ids[1:] != ids[:-1]
        if t0 > 0:
            head[0] = seg[t0 - 1] != ids[0]
        heads = np.flatnonzero(head)
        if heads.size == 0:   # the tile continues an earlier segment
            if walk is not None:
                walk.append((t0, 0, None, False, 0))
            continue
        ok = (ids >= 0) & (ids < N)
        sv = np.full((n, C), np.nan, v.dtype)
        rows = np.arange(heads[0], n)
        rows = rows[ok[rows]]
        sv[rows] = v[perm[t0 + rows] if perm is not None else t0 + rows]
        sl = ids[heads[-1]]
        cont = t0 + n < P and seg[t0 + n] == sl and 0 <= sl < N
        for j, h in enumerate(heads):
            s = ids[h]
            if not 0 <= s < N or (cont and j == len(heads) - 1):
                continue
            e = heads[j + 1] if j + 1 < len(heads) else n
            acc = out[s].copy()
            for i in range(h, e):
                acc = acc + sv[i]
            assert not written[s]
            out[s], written[s] = acc, True
        chunks = 0
        if cont:
            acc = out[sl].copy()
            for i in range(heads[-1], n):
                acc = acc + sv[i]
            k = t0 + n
            while True:
                lim = min(ch, P - k)
                other = np.flatnonzero(seg[k:k + lim] != sl)
                got = other[0] if other.size else lim
                r = np.arange(k, k + got)
                buf = v[perm[r] if perm is not None else r]
                for i in range(got):
                    acc = acc + buf[i]
                chunks += 1
                if not (got == lim and k + lim < P):
                    break
                k += ch
            assert not written[sl]
            out[sl], written[sl] = acc, True
        if walk is not None:
            walk.append((t0, len(heads), int(heads[0]), bool(cont), chunks))
    return out


@pytest.mark.parametrize("tile", [SS_THREADS, 4 * SS_THREADS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_version_is_index_add(dt, tile):
    """On sorted ids: the plain version, S1's emulated walk and
    index_add_ agree bit for bit (empty segments stay 0, the long
    segment adds in row order, rows start from out's value)."""
    np_t, t_t = DTYPES[dt]
    r = np.random.default_rng(11)
    P, N, C = 3000, 40, 3
    seg = np.sort(_ids(r, P, N))
    v = _values(r, P, C, np_t)
    base = _values(r, N, C, np_t)
    want = torch.from_numpy(base.copy()).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(v))
    got = ss.segment_sum_plain(torch.from_numpy(base.copy()),
                               torch.from_numpy(seg), torch.from_numpy(v))
    emu = _s1_emulated(base.copy(), seg, v, tile=tile)
    assert got.dtype == t_t
    assert np.array_equal(got.numpy(), want.numpy())
    assert np.array_equal(emu, want.numpy())
    assert np.array_equal(want.numpy()[1::3], base[1::3])
    # the order matters at these magnitudes: a reversed segment differs
    rev = torch.zeros((N, C), dtype=t_t).index_add_(
        0, torch.from_numpy(seg[::-1].copy()),
        torch.from_numpy(v[::-1].copy()))
    fwd = torch.zeros((N, C), dtype=t_t).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(v))
    assert not torch.equal(rev, fwd)


def test_emulated_walk_skips_outside_ids_and_unique_rows():
    """Ids outside [0, N) add nothing; unique unsorted ids (the lane
    banks, grouped) are each their own segment."""
    r = np.random.default_rng(12)
    v = _values(r, 50, 2, np.float32)
    seg = np.array([-1] * 5 + list(range(40)) + [40] * 5)
    emu = _s1_emulated(np.zeros((40, 2), np.float32), seg, v)
    assert np.array_equal(emu, v[5:45])
    lanes = r.permutation(50)
    emu = _s1_emulated(np.zeros((50, 2), np.float32), lanes, v)
    want = torch.zeros((50, 2)).index_add_(0, torch.from_numpy(lanes),
                                           torch.from_numpy(v))
    assert np.array_equal(emu, want.numpy())


@pytest.mark.parametrize("tile", [SS_THREADS, 4 * SS_THREADS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sort_path_is_index_add(dt, tile):
    """The CUDA path's preparation on unsorted ids: a stable sort, then
    the sorted rows through perm (the plain version and S1's emulated
    walk), bitwise index_add_ on the rows as given."""
    np_t, _ = DTYPES[dt]
    r = np.random.default_rng(13)
    P, N, C = 3000, 40, 3
    ids = _ids(r, P, N)
    v = _values(r, P, C, np_t)
    want = torch.zeros((N, C), dtype=DTYPES[dt][1]).index_add_(
        0, torch.from_numpy(ids), torch.from_numpy(v))
    seg, perm = ss.sort_rows(torch.from_numpy(ids))
    assert bool((seg[1:] >= seg[:-1]).all())
    got = ss.segment_sum_plain(torch.zeros_like(want), seg,
                               torch.from_numpy(v), perm)
    assert torch.equal(got, want)
    emu = _s1_emulated(np.zeros((N, C), np_t), seg.numpy(), v,
                       perm.numpy(), tile=tile)
    assert np.array_equal(emu, want.numpy())


def _edge_ids(r, tile, N):
    """Sorted ids that meet every edge of the tile walk: ids below 0,
    short segments inside a tile, a segment across one tile edge, one
    across many tiles (so whole tiles without a head, and tiles that
    open mid-segment), ids past N, and a row count that is not a
    multiple of the tile."""
    return np.concatenate([
        np.full(3, -2),
        np.repeat(np.arange(0, 10), r.integers(1, 20, 10)),
        np.full(tile - 7, 10),
        np.repeat(np.arange(11, 20), 5),
        np.full(5 * tile + 13, 20),
        np.repeat(np.arange(21, 40), r.integers(1, 9, 19)),
        np.full(tile // 2 + 1, 40),
        np.full(7, N + 3)])


@pytest.mark.parametrize("tile", [SS_THREADS, 2 * SS_THREADS,
                                  4 * SS_THREADS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_tile_walk_edges(dt, tile):
    """The emulated tile walk on ids that meet its edges (a segment
    owned across 1, 2 and many tiles, tiles without a head, tiles that
    open mid-segment, ids outside [0, N), P not a multiple of the tile),
    grouped and through the stable sort's perm, into a non-zero output:
    bitwise index_add_, and the walk took every edge."""
    np_t, t_t = DTYPES[dt]
    r = np.random.default_rng(20)
    N = 60
    seg = _edge_ids(r, tile, N)
    P = seg.shape[0]
    assert P % tile != 0
    v = _values(r, P, 3, np_t)
    base = _values(r, N, 3, np_t)
    keep = (seg >= 0) & (seg < N)
    want = torch.from_numpy(base.copy()).index_add_(
        0, torch.from_numpy(seg[keep]), torch.from_numpy(v[keep]))
    walk = []
    emu = _s1_emulated(base.copy(), seg, v, tile=tile, walk=walk)
    assert np.array_equal(emu, want.numpy())
    chunks = [w[4] for w in walk if w[3]]
    assert 1 in chunks and max(chunks) >= 3
    assert any(w[1] == 0 for w in walk)              # no head
    assert any(w[1] and w[2] > 0 for w in walk)      # opens mid-segment
    # the same rows unsorted, through the stable sort's perm
    sh = r.permutation(P)
    sseg, perm = ss.sort_rows(torch.from_numpy(seg[sh]))
    assert np.array_equal(sseg.numpy(), seg)
    emu = _s1_emulated(base.copy(), sseg.numpy(), v[sh], perm.numpy(),
                       tile=tile)
    want = torch.from_numpy(base.copy()).index_add_(
        0, torch.from_numpy(seg[sh][keep[sh]]),
        torch.from_numpy(v[sh][keep[sh]]))
    assert np.array_equal(emu, want.numpy())
    assert want.dtype == t_t


def test_tile_walk_agrees_with_jax_segment_sum():
    """The emulated tile walk on float64 against the JAX package's own
    primitive, `jax.ops.segment_sum` on the CPU (eager): within 1e-12 of
    each segment's sum of |v| (XLA need not add a scatter's rows in the
    same association), ids outside [0, N) dropped by both."""
    r = np.random.default_rng(21)
    N = 60
    seg = _edge_ids(r, SS_THREADS, N)
    v = _values(r, seg.shape[0], 3, np.float64)
    emu = _s1_emulated(np.zeros((N, 3)), seg, v)
    with jax.enable_x64(True):
        got = np.asarray(jax.ops.segment_sum(
            jax.numpy.asarray(v), jax.numpy.asarray(seg), num_segments=N))
    keep = (seg >= 0) & (seg < N)
    scale = np.zeros((N, 3))
    np.add.at(scale, seg[keep], np.abs(v[keep]))
    assert got.dtype == np.float64
    assert np.all(np.abs(emu - got) <= 1e-12 * scale)


def test_bank_key_restores_the_cpu_order():
    """path_tracer.bank's key on the card: rays of a sample-major wave
    (the CPU's state order) shuffled as the body sort shuffles them, then
    sorted by (pixel << 31 | sample), sum each pixel's samples as
    index_add_ sums the unshuffled wave."""
    r = np.random.default_rng(14)
    n_pix, spp = 300, 16
    pixel = np.tile(np.arange(n_pix), spp)
    sample = np.repeat(np.arange(5, 5 + spp), n_pix)
    v = _values(r, n_pix * spp, 3, np.float32)
    want = torch.zeros((n_pix, 3)).index_add_(0, torch.from_numpy(pixel),
                                              torch.from_numpy(v))
    sh = r.permutation(pixel.shape[0])
    idx = torch.from_numpy(pixel[sh])
    key = (idx << 31) | torch.from_numpy(sample[sh])
    seg, perm = ss.sort_rows(idx, key)
    got = ss.segment_sum_plain(torch.zeros((n_pix, 3)), seg,
                               torch.from_numpy(v[sh]), perm)
    assert torch.equal(got, want)
    # a sort by pixel alone keeps the shuffled order, which sums apart
    seg2, perm2 = ss.sort_rows(idx)
    other = ss.segment_sum_plain(torch.zeros((n_pix, 3)), seg2,
                                 torch.from_numpy(v[sh]), perm2)
    assert not torch.equal(other, want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_index_sums_equal_separate_sums(dt):
    """Several tensors summed side by side in one call equal each one's
    own index_add_ (1-D, (P, 3) and (P, 2, 2) values)."""
    np_t, t_t = DTYPES[dt]
    r = np.random.default_rng(15)
    P, N = 2000, 64
    ids = torch.from_numpy(_ids(r, P, N))
    vals = {"a": torch.from_numpy(_values(r, P, 1, np.float32)[:, 0]),
            "b": torch.from_numpy(_values(r, P, 3, np.float32)),
            "c": torch.from_numpy(_values(r, P, 4, np.float32)).reshape(
                P, 2, 2)}
    got = ss.index_sums(ids, vals, N, t_t)
    for k, v in vals.items():
        want = torch.zeros((N,) + tuple(v.shape[1:]), dtype=t_t).index_add_(
            0, ids, v.to(t_t))
        assert got[k].shape == want.shape and torch.equal(got[k], want), k
    assert ss.LAUNCHES == {"segment_sum": 0, "ordered_scan": 0}


def _two_level(out, seg, v, block):
    """Each segment's rows (sorted ids) in runs of `block` rows, each run
    summed left to right from 0, then the runs added to out in order."""
    out = out.copy()
    r = 0
    while r < len(seg):
        s, runs = seg[r], []
        while r < len(seg) and seg[r] == s:
            acc = v.dtype.type(0) * v[r]
            for _ in range(block):
                if r >= len(seg) or seg[r] != s:
                    break
                acc = acc + v[r]
                r += 1
            runs.append(acc)
        for x in runs:
            out[s] = out[s] + x
    return out


@pytest.mark.parametrize("block", [1, 7, 64, 5000])
def test_blocked_sums(block):
    """ordered_index_add's `block`: each segment's rows in runs of
    `block` (each run in row order), then the runs in order; on unsorted
    ids after the stable sort, into a non-zero output.  Into zeros, a
    block longer than every segment is index_add_ itself."""
    r = np.random.default_rng(18)
    P, N = 1200, 12
    ids = _ids(r, P, N)
    v = _values(r, P, 3, np.float32)
    base = _values(r, N, 3, np.float32)
    got = ss.ordered_index_add(torch.from_numpy(base.copy()),
                               torch.from_numpy(ids), torch.from_numpy(v),
                               block=block)
    order = np.argsort(ids, kind="stable")
    want = _two_level(base, ids[order], v[order], block)
    assert np.array_equal(got.numpy(), want)
    if block == 5000:   # into zeros: one run a segment, index_add_'s sum
        got = ss.ordered_index_add(torch.zeros((N, 3)),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(v), block=block)
        assert torch.equal(got, torch.zeros((N, 3)).index_add_(
            0, torch.from_numpy(ids), torch.from_numpy(v)))
    assert ss.LAUNCHES == {"segment_sum": 0, "ordered_scan": 0}


def test_take_backward_sums_in_runs():
    """utils/vecmath.py's _Take (take's gather on the card where the
    table carries a graph), run here on CPU tensors: its forward is
    F.embedding's, its backward the ordered runs of TAKE_BLOCK lanes,
    within rounding of F.embedding's backward; `take` on the CPU keeps
    F.embedding's backward."""
    from tungsten_tpu_torch.utils import vecmath as vm
    r = np.random.default_rng(19)
    n = 3 * vm.TAKE_BLOCK + 77
    idx = torch.from_numpy(r.integers(0, 3, n))
    table = torch.from_numpy(_values(r, 3, 2, np.float32))
    g = torch.from_numpy(_values(r, n, 2, np.float32))
    t1 = table.clone().requires_grad_()
    out = vm._Take.apply(t1, idx)
    assert torch.equal(out, torch.nn.functional.embedding(idx, table))
    out.backward(g)
    order = np.argsort(idx.numpy(), kind="stable")
    want = _two_level(np.zeros((3, 2), np.float32), idx.numpy()[order],
                      g.numpy()[order], vm.TAKE_BLOCK)
    assert np.array_equal(t1.grad.numpy(), want)
    t2 = table.clone().requires_grad_()
    (vm.take(t2, idx) * g).sum().backward()
    t3 = table.clone().requires_grad_()
    (torch.nn.functional.embedding(idx, t3) * g).sum().backward()
    assert torch.equal(t2.grad, t3.grad)
    assert torch.allclose(t1.grad, t3.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dim", [((10000,), 0), ((64, 96), 1),
                                       ((37, 5), 0), ((6, 7, 9), -1)])
def test_ordered_scan_is_the_cpu_cumsum(shape, dim):
    """The scan entry's arithmetic (each row left to right in double,
    each output rounded once) is torch.cumsum's on the CPU, float32 and
    float64; ordered_cumsum on CPU tensors is torch.cumsum."""
    r = np.random.default_rng(16)
    for np_t in (np.float32, np.float64):
        x = (r.standard_normal(shape) * 1e3).astype(np_t)
        want = torch.cumsum(torch.from_numpy(x), dim=dim)
        emu = np.cumsum(x.astype(np.float64), axis=dim).astype(np_t)
        assert np.array_equal(emu, want.numpy())
        got = ss.ordered_cumsum(torch.from_numpy(x), dim)
        assert torch.equal(got, want)


def test_reverse_scan_is_the_cpu_derivative():
    """The scan right to left in double (the kernels' `reverse`, one
    launch) is the CPU's cumsum derivative bit for bit: its backward is
    flip, cumsum, flip, so each output is the cotangents from the right
    added right to left in double."""
    r = np.random.default_rng(22)
    for np_t, t_t in DTYPES.values():
        for shape in ((10000,), (64, 96), (37, 5)):
            x = torch.from_numpy(r.standard_normal(shape)).to(t_t)
            g = (r.standard_normal(shape) * 1e3).astype(np_t)
            xh = x.clone().requires_grad_()
            (torch.cumsum(xh, -1) * torch.from_numpy(g)).sum().backward()
            emu = np.cumsum(g[..., ::-1].astype(np.float64),
                            axis=-1)[..., ::-1].astype(np_t)
            assert np.array_equal(emu, xh.grad.numpy())


def _add_exact(a, b, bad):
    """csrc/segment_sum.cu's add_exact, elementwise: a + b, and `bad`
    set where the TwoSum error term is not exactly 0 (NaN included)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    bad[0] |= bool(np.any(~(err == 0.0)))
    return s


def _scan_long_emulated(x, reverse=False):
    """ordered_scan_long_kernel on one row in numpy, step for step:
    chunks of _long_chunk elements; in a chunk each of LONG_THREADS
    threads adds its run of consecutive elements to its total (thread 0
    from the carry), the totals are scanned across each warp and the
    warps' totals across warp 0 (Kogge-Stone, as the shuffles do, on all
    32 lanes), and each thread adds its run again from its carry-in,
    every add checked; an exact chunk writes those prefixes plus +0.0, an
    inexact one is refolded left to right from the carry.  Returns (y,
    the path each chunk took)."""
    xs = x[::-1] if reverse else x
    y = np.empty_like(xs)
    chunk = _long_chunk(xs.shape[0], xs.itemsize)
    carry, paths = 0.0, []
    with np.errstate(invalid="ignore", over="ignore"):
        for q0 in range(0, xs.shape[0], chunk):
            c = xs[q0:q0 + chunk].astype(np.float64)
            n = c.shape[0]
            per = -(-n // LONG_THREADS)
            pos = np.arange(LONG_THREADS * per).reshape(LONG_THREADS, per)
            live = pos < n
            xm = np.where(live, np.concatenate(
                [c, np.zeros(LONG_THREADS * per - n)])[pos], 0.0)
            mine = live.sum(1)
            bad = [False]
            # (a) each thread's total (thread 0 from the carry)
            total = xm[:, 0].copy()
            total[0] = _add_exact(np.array([carry]), xm[:1, 0], bad)[0]
            for k in range(1, per):
                m = live[:, k]
                total[m] = _add_exact(total[m], xm[m, k], bad)
            total = np.where(mine > 0, total, 0.0)
            # (b) the totals across each warp, then across the warps
            incl = total.reshape(-1, 32)
            for d in (1, 2, 4, 8, 16):
                incl[:, d:] = _add_exact(incl[:, :-d].copy(), incl[:, d:],
                                         bad)
            nw = LONG_THREADS // 32
            winc = np.concatenate([incl[:, 31], np.zeros(32 - nw)])
            d = 1
            while d < nw:   # warp 0's lanes, those past the warps on 0.0
                winc[d:] = _add_exact(winc[:-d].copy(), winc[d:], bad)
                d *= 2
            # (c) each thread's carry-in, and its run again from it (thread
            # 0's from the carry: the adds of (a))
            flat = incl.reshape(-1)
            cin = np.full(LONG_THREADS, carry)
            for t in range(1, LONG_THREADS):
                warp, lane = divmod(t, 32)
                cin[t] = winc[warp - 1] if warp > 0 else flat[t - 1]
                if warp > 0 and lane > 0:
                    cin[t] = _add_exact(cin[t:t + 1], flat[t - 1:t],
                                        bad)[0]
            run = cin.copy()
            pre = np.zeros_like(xm)
            for k in range(per):
                m = live[:, k]
                run[m] = _add_exact(run[m], xm[m, k], bad)
                pre[:, k] = run
            if not bad[0]:
                out = 0.0 + pre[live]
                carry = out[-1]
                paths.append("exact")
            else:
                out, acc = np.empty(n), carry
                for i in range(n):
                    acc = acc + c[i]
                    out[i] = acc
                carry = acc
                paths.append("refold")
            y[q0:q0 + n] = out.astype(x.dtype)
    return (y[::-1] if reverse else y), paths


def _scan_input(kind, np_t, r):
    n = 10000 if kind in ("narrow", "wide", "negzero") else 40000
    if kind == "narrow":   # integers / 64: every partial sum exact
        return (r.integers(-1000, 1000, n) / 64).astype(np_t)
    if kind == "wide":     # magnitudes over 24 decades
        return (r.standard_normal(n) * 10.0 ** r.uniform(-12, 12, n)
                ).astype(np_t)
    if kind == "negzero":  # runs of -0.0, exact sums through zero
        x = np.full(n, -0.0)
        x[5000:5006] = [1.0, -0.0, -1.0, 0.0, -0.0, 2.5]
        x[9000:] = np.where(np.arange(1000) % 2, 0.125, -0.125)
        return x.astype(np_t)
    x = np.ones(n)
    x[SPECIAL_AT] = np.inf if kind == "inf" else np.nan
    return x.astype(np_t)


SPECIAL_AT = 30000   # the inf or NaN of a 40,000-element row


def _want_paths(kind, n, item, reverse):
    """The path each chunk should take: all exact on narrow spans and
    runs of -0.0, all refolded on wide spans, and around an inf or NaN
    exact up to its chunk, refolded from it on (its carry is one)."""
    chunk = _long_chunk(n, item)
    chunks = -(-n // chunk)
    if kind in ("narrow", "negzero"):
        return ["exact"] * chunks
    if kind == "wide":
        return ["refold"] * chunks
    at = (n - 1 - SPECIAL_AT if reverse else SPECIAL_AT) // chunk
    return ["exact"] * at + ["refold"] * (chunks - at)


SCAN_CASES = ("narrow", "wide", "negzero", "inf", "nan")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", SCAN_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_scan_long_path_is_the_cpu_cumsum(dt, kind, reverse):
    """The long scan path's emulation on the MLT pool's (10000,) shape
    (40,000 elements, several chunks, around an inf or NaN) is bitwise
    torch.cumsum on the CPU (right to left: cumsum's derivative) and
    takes the path it should: the exact parallel scan on narrow-span
    inputs and on runs of -0.0 (which the CPU's fold turns into +0.0, as
    the exact path's +0.0 does), the refold on wide-span inputs, and
    from the chunk of an inf or NaN on."""
    np_t, _ = DTYPES[dt]
    x = _scan_input(kind, np_t, np.random.default_rng(23))
    t = torch.from_numpy(x.copy())
    want = (torch.cumsum(t.flip(0), 0).flip(0) if reverse
            else torch.cumsum(t, 0)).numpy()
    got, paths = _scan_long_emulated(x, reverse)
    assert got.tobytes() == want.tobytes()
    assert paths == _want_paths(kind, x.shape[0], x.itemsize, reverse)
    if kind == "negzero":
        zero = want == 0
        assert zero.any() and not np.signbit(want[zero]).any()


def test_wrappers_take_the_plain_version_on_cpu():
    r = np.random.default_rng(17)
    ids = torch.from_numpy(_ids(r, 500, 20))
    v = torch.from_numpy(_values(r, 500, 3, np.float32))
    before = dict(ss.LAUNCHES)
    got = ss.ordered_index_add(torch.zeros((20, 3)), ids, v)
    assert torch.equal(got, torch.zeros((20, 3)).index_add_(0, ids, v))
    assert ss.LAUNCHES == before


@pytest.mark.parametrize("entry", ["segment_sum", "ordered_scan",
                                   "ordered_index_add", "ordered_cumsum"])
def test_kernel_wrappers_refuse_non_cuda_tensors(entry):
    """S1's wrappers launch on CUDA tensors only: the kernel entries
    given CPU tensors, and the routing wrappers given tensors on a device
    that is neither the CPU nor CUDA, raise before they build or launch
    anything and count no launch (no fallback to the plain version)."""
    before = dict(ss.LAUNCHES)
    v = torch.ones((6, 3))
    ids = torch.tensor([0, 0, 1, 2, 2, 2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        if entry == "segment_sum":
            ss.segment_sum_kernel(torch.zeros((3, 3)), ids, v)
        elif entry == "ordered_scan":
            ss.ordered_scan_kernel(v)
        elif entry == "ordered_index_add":
            ss.ordered_index_add(torch.zeros((3, 3), device="meta"),
                                 ids.to("meta"), v.to("meta"))
        else:
            ss.ordered_cumsum(v.to("meta"), 0)
    assert ss.LAUNCHES == before


# float scatters and float cumsums allowed outside ops/segment_sum.py:
# (file, enclosing function, call): integer sums, exact in any order,
# and scatters onto unique rows (one add a row)
ALLOWED = {
    ("ops/wave_trace.py", "list_walk", "index_add_"),       # int counts
    ("integrators/photon_map.py", "_plane_eval", "index_add_"),  # nonzero
    ("integrators/photon_map.py", "gather_walk", "index_add"),   # nonzero
    ("integrators/photon_map.py", "_candidates", "cumsum"),  # int counts
    ("integrators/photon_map.py", "_knn", "cumsum"),         # int counts
}
SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
            "index_reduce", "index_reduce_", "cumsum", "cumsum_"}


def _calls(path):
    """(enclosing top-level function or class, method name, call node)
    of every method call of a module (None at module level)."""
    out = []
    for node in ast.iter_child_nodes(ast.parse(open(path).read())):
        name = node.name if isinstance(node, (
            ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) else None
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                        ast.Attribute):
                out.append((name, sub.func.attr, sub))
    return out


def test_no_unordered_float_accumulation_in_the_package():
    """Every float scatter-add and float cumsum of the package goes
    through ops/segment_sum.py, but the listed integer and unique-row
    sites; no put_ / index_put_ accumulates, no scatter_reduce sums; and
    no module switches the whole process to deterministic algorithms."""
    found = set()
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, PKG)
            for func, attr, call in _calls(path):
                assert attr != "use_deterministic_algorithms", (rel, func)
                if rel == os.path.join("ops", "segment_sum.py"):
                    continue
                base = call.func.value
                if attr in SCATTERS:
                    if attr.startswith("cumsum") and isinstance(
                            base, ast.Name) and base.id == "np":
                        continue   # host numpy
                    site = (rel.replace(os.sep, "/"), func, attr)
                    assert site in ALLOWED, site
                    found.add(site)
                if attr in ("index_put", "index_put_", "put_", "put"):
                    for kw in call.keywords:
                        assert not (kw.arg == "accumulate" and not (
                            isinstance(kw.value, ast.Constant) and
                            kw.value.value is False)), (rel, func)
                if attr in ("scatter_reduce", "scatter_reduce_"):
                    red = [a for a in call.args[3:4]] + [
                        kw.value for kw in call.keywords
                        if kw.arg == "reduce"]
                    assert red and all(
                        isinstance(x, ast.Constant) and
                        x.value in ("amin", "amax") for x in red), (rel,
                                                                   func)
    # every allowed site still exists (a stale entry would hide nothing)
    assert found == ALLOWED
