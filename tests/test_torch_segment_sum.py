"""The port's ordered float accumulation (ops/segment_sum.py: the
wrappers of kernel S1, csrc/segment_sum.cu) on the CPU.

S1 runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it there against its plain version).  Here, on numpy-seeded inputs
with repeated, empty and long segments, in float32 and float64:

  * S1's plain version, and a step-by-step emulation of the kernel's
    walk (heads, U-row batches, a segment ending mid-batch, ids outside
    the output skipped), are bitwise `index_add_`;
  * the CUDA path's preparation (a stable sort of the ids, or of the
    bank's (pixel, sample) key) gives the same sums bitwise as
    `index_add_` on the unsorted rows;
  * index_sums' side-by-side columns equal separate index_add_ calls;
  * the blocked order (runs of `block` rows, then the runs), and take's
    backward on the card (utils/vecmath.py::_Take) that uses it, equal a
    step-by-step emulation bitwise;
  * the ordered scan's arithmetic (double accumulation) is the CPU's
    float cumsum bit for bit;
  * the wrappers take the plain version for CPU tensors and refuse any
    other device rather than fall back;
  * no float scatter-add or float cumsum is left in the package outside
    the wrapper module, but the integer and unique-index sites listed
    below, and nothing calls torch.use_deterministic_algorithms.
"""
import ast
import os

import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import segment_sum as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tungsten_tpu_torch")
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
U = 8   # csrc/segment_sum.cu: rows a head loads before it adds them


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


def _s1_emulated(out, seg, v, perm=None):
    """csrc/segment_sum.cu's segment_sum_kernel step for step in numpy,
    one (head, column) at a time: the head's id, U-row batches loaded
    before any is added, the walk ending at the first other id."""
    P, C = v.shape
    N = out.shape[0]
    for r in range(P):
        s = seg[r]
        if r > 0 and seg[r - 1] == s:
            continue
        if not 0 <= s < N:
            continue
        for c in range(C):
            acc = out[s, c]
            j, more = r, True
            while more:
                sk = [seg[k] if k < P else s + 1 for k in range(j, j + U)]
                vk = [v[perm[k] if perm is not None else k, c]
                      if sk[k - j] == s else v.dtype.type(0)
                      for k in range(j, j + U)]
                for u in range(U):
                    if more and sk[u] == s:
                        acc = acc + vk[u]
                    else:
                        more = False
                j += U
            out[s, c] = acc
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_version_is_index_add(dt):
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
    emu = _s1_emulated(base.copy(), seg, v)
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


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sort_path_is_index_add(dt):
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
                       perm.numpy())
    assert np.array_equal(emu, want.numpy())


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
