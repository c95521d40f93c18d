"""Ordered float accumulation: kernel S1 (csrc/segment_sum.cu) and its
wrappers, the one path of the port's float scatters with repeated
indices and of its float running sums.

PyTorch's `index_add_` on CUDA adds with atomics and its 1-D float
`cumsum` with a look-back scan, so a framebuffer, a splat, a tile
statistic or a photon gather summed with them changes in its last bits
from run to run.  The JAX package's renders repeat bit for bit.  Here
every such sum adds in one fixed order:

  * `ordered_index_add(out, idx, v)` is `out.index_add_(0, idx, v)` with
    each output row taking its rows in the order the CPU adds them (row
    index order).  On CPU tensors it IS `index_add_` (the plain
    version).  On CUDA tensors it stable-sorts the ids (unless the caller
    says they are grouped already: sorted, or unique) and launches S1,
    which adds each segment's rows in that order with one writer an
    output element; it launches S1 or raises, and never falls back.
    `key` sorts the rows of a segment by another order than their index
    (the bank's (pixel, sample), which is the CPU's order of a pixel's
    samples whatever order the card's body sort left the rays in).
    `block` splits each segment into runs of that many rows, each run
    added in index order, then the runs' sums in order, on the CPU as on
    the card: a fixed association again, not the CPU's index_add_, for
    the few huge segments of a gather's backward (a million lanes onto a
    table of a few rows), where one thread a segment would walk hundreds
    of thousands of rows one after another.
  * `ordered_cumsum(x, dim)` is `torch.cumsum(x, dim)`: on CPU tensors
    `torch.cumsum` itself, which accumulates float rows in double; on
    CUDA tensors S1's scan entry, one thread a row, in double too.
  * `index_sums(idx, values, n)` sums several (P, ...) tensors by the
    same ids with one sort and one launch (their columns side by side).

Nothing here changes what the CPU computes, and no process-wide switch
(torch.use_deterministic_algorithms) is touched.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

# launches of each entry of S1 (plain integers; the plain versions do
# not count)
LAUNCHES = {"segment_sum": 0, "ordered_scan": 0}
# a list to append (entry, rows, columns, outputs, dtype, ids grouped by
# the caller) to at every launch, or None
LAUNCH_LOG: list | None = None
_FLOATS = (torch.float32, torch.float64)


@functools.lru_cache(maxsize=1)
def load_kernel() -> ctypes.CDLL:
    """Build csrc/segment_sum.cu with nvcc (first use) and bind it."""
    from tungsten_tpu_torch._build import build_shared
    from tungsten_tpu_torch.ops.wave_trace import NVCC_FLAGS, _nvcc
    path = build_shared("segment_sum", ["csrc/segment_sum.cu"],
                        [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_launch.argtypes = [vp] * 4 + [cl, ci, cl, ci, vp]
    lib.segment_sum_launch.restype = ci
    lib.ordered_scan_launch.argtypes = [vp, vp, cl, cl, ci, vp]
    lib.ordered_scan_launch.restype = ci
    return lib


def sort_rows(idx, key=None):
    """(seg, perm): the ids in the order of a stable sort of `key`
    (default: the ids themselves) and that order.  A stable sort's output
    is unique, so the order of the rows of a segment is fixed: their
    index order, or `key`'s then their index order."""
    if key is None:
        return torch.sort(idx, stable=True)
    perm = torch.sort(key, stable=True).indices
    return idx[perm], perm


def segment_sum_plain(out, seg, v, perm=None):
    """S1's plain version: `out.index_add_(0, seg, v[perm])`, which adds
    the rows of each segment in index order as S1 does."""
    return out.index_add_(0, seg, v if perm is None else v[perm])


def _log(entry, rows, cols, n, dtype, grouped):
    LAUNCHES[entry] += 1
    if LAUNCH_LOG is not None:
        LAUNCH_LOG.append((entry, rows, cols, n, str(dtype), grouped))


def _cuda(x, name):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel takes raw "
                         f"pointers and has no backward")
    return x


def segment_sum_kernel(out, seg, v, perm=None):
    """Launch S1 on the current stream: out[seg[r]] += v[perm[r]] for
    every row r in index order, equal ids in `seg` contiguous.  out (N,
    ...) and v (P, ...) CUDA f32 or f64 of the same type and trailing
    shape, out contiguous (it is written in place); seg, perm (P,)
    integer ids.  Returns out."""
    _cuda(out, "out")
    _cuda(v, "v")
    _cuda(seg, "seg")
    if out.dtype not in _FLOATS or v.dtype != out.dtype:
        raise ValueError(f"out {out.dtype} / v {v.dtype}: S1 takes float32 "
                         f"or float64, both the same")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous: S1 writes it in place")
    P = v.shape[0]
    if tuple(v.shape[1:]) != tuple(out.shape[1:]) or seg.shape != (P,):
        raise ValueError(f"v {tuple(v.shape)}, out {tuple(out.shape)}, seg "
                         f"{tuple(seg.shape)}: shapes do not match")
    C = math.prod(out.shape[1:])
    seg = seg.to(torch.int64).contiguous()
    v = v.contiguous()
    if perm is not None:
        perm = _cuda(perm, "perm").to(torch.int64).contiguous()
        if perm.shape != (P,):
            raise ValueError(f"perm {tuple(perm.shape)}: expected ({P},)")
    N = out.shape[0]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = load_kernel().segment_sum_launch(
        seg.data_ptr(), None if perm is None else perm.data_ptr(),
        v.data_ptr(), out.data_ptr(), P, C, N,
        int(out.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    _log("segment_sum", P, C, N, out.dtype, perm is None)
    return out


def _blocks(seg, block: int):
    """For grouped ids `seg` (P,): each row's run (at most `block` rows
    of one segment, runs numbered in row order) and each run's id."""
    P = seg.shape[0]
    r = torch.arange(P, device=seg.device)
    head = torch.ones((P,), dtype=torch.bool, device=seg.device)
    head[1:] = seg[1:] != seg[:-1]
    start = torch.cummax(torch.where(head, r, 0), 0).values
    run_head = head | ((r - start) % block == 0)
    return torch.cumsum(run_head.to(torch.int64), 0) - 1, seg[run_head]


def ordered_index_add(out, idx, v, key=None, grouped=False, block=None):
    """`out.index_add_(0, idx, v)` in a fixed order; returns out.

    CPU tensors: `index_add_` itself.  CUDA tensors: S1, the rows of each
    output row added in index order (or in the order of `key` (P,), then
    index order, where `key` orders the rows by idx first), after a
    stable sort unless `grouped` says equal ids are contiguous already
    (sorted ids, or unique ones).  With `block`, on either device: each
    segment's rows in runs of `block`, each run's sum in index order,
    then the runs' sums in order (S1 twice on the card, index_add_ twice
    on the CPU).  Raises rather than fall back when S1 cannot run."""
    if grouped and key is not None:
        raise ValueError("grouped ids take no sort key")
    cpu = out.device.type == "cpu"
    if cpu and block is None:
        return out.index_add_(0, idx, v)
    add = segment_sum_plain if cpu else segment_sum_kernel
    seg, perm = (idx, None) if grouped else sort_rows(idx, key)
    if block is None:
        return add(out, seg, v, perm)
    run, run_seg = _blocks(seg, block)
    runs = add(torch.zeros((run_seg.shape[0],) + tuple(v.shape[1:]),
                           dtype=out.dtype, device=out.device), run, v, perm)
    return add(out, run_seg, runs)


def index_sums(idx, values: dict, n: int, dtype=torch.float32, key=None,
               grouped=False) -> dict:
    """{name: zeros((n,) + v.shape[1:], dtype) with every v (P, ...)
    index-added by idx}, all in one ordered_index_add (their columns side
    by side: each column's sum is its own, so the result is each one's
    own ordered sum)."""
    flat = [v.reshape(v.shape[0], -1).to(dtype) for v in values.values()]
    widths = [f.shape[1] for f in flat]
    dev = flat[0].device
    cat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    out = ordered_index_add(
        torch.zeros((n, sum(widths)), dtype=dtype, device=dev), idx, cat,
        key=key, grouped=grouped)
    res, off = {}, 0
    for (name, v), w in zip(values.items(), widths):
        res[name] = out[:, off:off + w].reshape((n,) + tuple(v.shape[1:]))
        off += w
    return res


def ordered_scan_kernel(x):
    """Launch S1's scan entry: the inclusive sum along the last axis of
    CUDA f32 / f64 x, each row left to right in double.  Returns a new
    tensor."""
    _cuda(x, "x")
    if x.dtype not in _FLOATS:
        raise ValueError(f"x {x.dtype}: the scan takes float32 or float64")
    x = x.contiguous()
    y = torch.empty_like(x)
    L = x.shape[-1] if x.ndim else 1
    rows = x.numel() // max(L, 1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load_kernel().ordered_scan_launch(
        x.data_ptr(), y.data_ptr(), rows, L, int(x.dtype == torch.float64),
        stream)
    if err != 0:
        raise RuntimeError(f"ordered_scan kernel launch failed: CUDA error "
                           f"{err}")
    _log("ordered_scan", rows, L, rows, x.dtype, True)
    return y


class _OrderedScan(torch.autograd.Function):
    """The ordered scan with its backward, the reversed ordered scan of
    the cotangent (cumsum's own derivative)."""

    @staticmethod
    def forward(ctx, x):
        return ordered_scan_kernel(x.detach())

    @staticmethod
    def backward(ctx, g):
        return ordered_scan_kernel(g.flip(-1)).flip(-1)


def ordered_cumsum(x, dim: int):
    """`torch.cumsum(x, dim)` of a float tensor in a fixed order: on CPU
    tensors torch.cumsum itself (its float rows accumulate in double),
    on CUDA tensors the ordered scan along `dim`, in double too, with
    its derivative where x requires grad."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=dim)
    last = dim % x.ndim == x.ndim - 1
    x = x if last else x.movedim(dim, -1)
    y = _OrderedScan.apply(x) if x.requires_grad else ordered_scan_kernel(x)
    return y if last else y.movedim(-1, dim)
