"""The curve-piece walk on the card: kernel C1 (csrc/curve_trace.cu) and
its wrapper.

The JAX package walks its curve pieces in a plain XLA while_loop
(`tungsten_tpu/ops/intersect.py::_curve_traverse`), not a Pallas kernel.
Copied op by op into PyTorch that is about a hundred launches a BVH step,
so on CUDA tensors the walk runs as one hand-written kernel instead: one
thread a ray, over the packed node and piece rows of the FlatScene
(`cbvh_rows`, `crv_rows`; scene/flatten.py::pack_curve_rows).  Its plain
version is `ops/intersect.py::curve_walk_plain`, the JAX walk step for
step; `ops/intersect.py::curve_walk` picks one or the other from the
device of the tensors.  On CUDA tensors it launches C1 or raises; it
never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# launches of C1 per mode (plain integers; the plain version does not
# count)
LAUNCHES = {"curve_closest": 0, "curve_anyhit": 0}
# a list to append (route, rays) to at every launch, or None
LAUNCH_LOG: list | None = None

# f32 operations of the kernel, counted from csrc/curve_trace.cu (adds,
# multiplies, divides, square roots, min/max and compares alike): a node
# visit's slab test, and a half-cylinder piece test with both endpoint
# projections (a ribbon test takes 122, so counting every test at 102
# keeps the operation bound of chip_smoke.py a least time)
FLOPS_PER_NODE = 26
FLOPS_PER_PIECE = 102


@functools.lru_cache(maxsize=1)
def load_kernel() -> ctypes.CDLL:
    """Build csrc/curve_trace.cu with nvcc (first use) and bind it."""
    from tungsten_tpu_torch._build import build_shared
    from tungsten_tpu_torch.ops.wave_trace import NVCC_FLAGS, _nvcc
    path = build_shared("curve_trace", ["csrc/curve_trace.cu"],
                        [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.curve_trace_launch.argtypes = [vp] * 6 + [ci] * 3 + [vp] * 9
    lib.curve_trace_launch.restype = ci
    return lib


def _cuda_f32(x, name, shape):
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel takes raw "
                         f"pointers, so traversal inputs are detached")
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    return x.contiguous()


def curve_kernel(crv_rows, cbvh_rows, o, d, t_min, t_max, any_hit: bool,
                 stats: bool = False):
    """Launch C1 on the current stream.

    crv_rows (Cp, 16) / cbvh_rows (N, 8) f32 packed rows; o, d (R, 3),
    t_min, t_max (R,) f32, all CUDA.  Returns (t, seg, u, v, hit); with
    `stats` also counts (2, R) i32, the node visits and piece tests of
    each ray, and node_mark (N,) and piece_mark (Cp,) uint8, 1 where the
    walk read that row (without it the kernel stores none of these).
    t = t_max and seg = -1 where nothing hit; an
    any-hit ray stops at its first hit, so only its `hit` is the closest
    walk's."""
    R = o.shape[0]
    o = _cuda_f32(o, "o", (R, 3))
    d = _cuda_f32(d, "d", (R, 3))
    t_min = _cuda_f32(t_min, "t_min", (R,))
    t_max = _cuda_f32(t_max, "t_max", (R,))
    nodes = _cuda_f32(cbvh_rows, "cbvh_rows", (cbvh_rows.shape[0], 8))
    pieces = _cuda_f32(crv_rows, "crv_rows", (crv_rows.shape[0], 16))
    dev = o.device
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    seg = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    counts = node_mark = piece_mark = None
    if stats:
        counts = torch.empty((2, R), dtype=torch.int32, device=dev)
        node_mark = torch.zeros((nodes.shape[0],), dtype=torch.uint8,
                                device=dev)
        piece_mark = torch.zeros((pieces.shape[0],), dtype=torch.uint8,
                                 device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curve_trace_launch(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        pieces.data_ptr(), nodes.data_ptr(), R, nodes.shape[0],
        int(any_hit), t.data_ptr(), seg.data_ptr(), u.data_ptr(),
        v.data_ptr(), hit.data_ptr(),
        *((counts.data_ptr(), node_mark.data_ptr(), piece_mark.data_ptr())
          if stats else (None, None, None)), stream)
    if err != 0:
        raise RuntimeError(f"curve_trace {'any' if any_hit else 'closest'}"
                           f"-hit kernel launch failed: CUDA error {err}")
    route = "curve_anyhit" if any_hit else "curve_closest"
    LAUNCHES[route] += 1
    if LAUNCH_LOG is not None:
        LAUNCH_LOG.append((route, R))
    out = (t, seg, u, v, hit)
    return out + (counts, node_mark, piece_mark) if stats else out

