"""The curve-piece walk on the card: kernel C1 (csrc/curve_trace.cu) and
its wrapper.

The JAX package walks its curve pieces in a plain XLA while_loop
(`tungsten_tpu/ops/intersect.py::_curve_traverse`), not a Pallas kernel.
Copied op by op into PyTorch that is about a hundred launches a BVH step,
so on CUDA tensors the walk runs as one hand-written kernel instead: a
stack walk (depth first for a closest hit, nearest first for an any hit)
over the 4-wide node rows and the piece rows of the FlatScene
(`cwbvh_rows`, `crv_rows`; scene/flatten.py::pack_curve_rows), with 1, 2
or 4 lanes a ray (`curve_lanes`) and a stack of at most STACK entries
(a ray that would hold more drops its deepest and starts again at the
root past what it finished), which returns the serial walk's closest
hit for every choice of lanes and stack.  Its plain version is
`ops/intersect.py::curve_walk_plain`, the JAX walk step for step;
`ops/intersect.py::curve_walk` picks one or the other from the device of
the tensors.  On CUDA tensors it launches C1 or raises; it never falls
back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tungsten_tpu_torch.scene.flatten import CRV_ROW, CWBVH_ROW

# launches of C1 per mode (plain integers; the plain version does not
# count)
LAUNCHES = {"curve_closest": 0, "curve_anyhit": 0}
# a list to append (route, rays, lanes) to at every launch, or None
LAUNCH_LOG: list | None = None

# f32 operations of the kernel, counted from csrc/curve_trace.cu (adds,
# multiplies, divides, square roots, min/max and compares alike): the
# slab test of one child box (26; a visit tests its node's occupied
# slots), and a half-cylinder piece test with both endpoint projections
# (a ribbon test takes 122, so counting every test at 102 keeps the
# operation bound of chip_smoke.py a least time)
FLOPS_PER_BOX = 26
FLOPS_PER_PIECE = 102
LANES = (1, 2, 4)
# stack entries a ray holds in all, and in shared memory (csrc/
# curve_trace.cu STACK, SHORT): `stack` takes a multiple of SHORT in
# (SHORT, STACK]
STACK, SHORT = 64, 8
# per-ray statistics of stats=True, the rows of `counts`
COUNTS = ("visits", "piece_tests", "spills", "box_tests", "restarts")
# rays an SM from which an any-hit launch takes one lane a ray
ONE_LANE_RAYS_PER_SM = 1024


@functools.lru_cache(maxsize=1)
def load_kernel() -> ctypes.CDLL:
    """Build csrc/curve_trace.cu with nvcc (first use) and bind it."""
    from tungsten_tpu_torch._build import build_shared
    from tungsten_tpu_torch.ops.wave_trace import NVCC_FLAGS, _nvcc
    path = build_shared("curve_trace", ["csrc/curve_trace.cu"],
                        [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.curve_trace_launch.argtypes = [vp] * 6 + [ci] * 4 + [vp] * 9
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


def curve_lanes(n_rays: int, device, any_hit: bool = False) -> int:
    """Lanes a ray for a launch of n_rays rays on `device`.  Closest hit:
    4 at every width (a warp then waits on the walks of 8 rays, not 32;
    on the hair scene's continuation rays 4 lanes beat 1 at every width,
    full width included: PERF.md); any hit: 1 from ONE_LANE_RAYS_PER_SM
    rays an SM, else 4 (on the hair scene's shadow segments 1 lane ran
    fastest at 262,144 rays and up, 4 at 131,072 and below).  Two lanes
    won no width that was timed and is only forced, by tests."""
    if not any_hit:
        return 4
    from tungsten_tpu_torch.ops.wave_trace import _sm_count
    sms = _sm_count(torch.device(device).index or 0)
    return 1 if n_rays >= ONE_LANE_RAYS_PER_SM * sms else 4


def curve_kernel(crv_rows, cwbvh_rows, o, d, t_min, t_max, any_hit: bool,
                 stats: bool = False, lanes=None, stack=None):
    """Launch C1 on the current stream.

    crv_rows (Cp, 16) / cwbvh_rows (M, 32) f32 packed rows; o, d (R, 3),
    t_min, t_max (R,) f32, all CUDA; lanes: 1, 2 or 4 lanes a ray (None:
    curve_lanes); stack: the most stack entries a ray holds before it
    drops its deepest and later restarts (None: STACK; tests force fewer
    to make it restart).  Every lanes gives the same outputs bitwise, and
    every stack the same closest hit (t, seg, u, v, hit) bitwise and the
    same any-hit `hit` (which first hit an any-hit ray meets follows the
    order of its walk, and a restart changes that order).  Returns (t, seg, u, v, hit); with `stats`
    also counts (5, R) i32, each ray's COUNTS (node visits, piece tests,
    stack spills, child boxes tested, restarts), and node_mark (M,) and
    piece_mark (Cp,) uint8, 1 where the walk read that row (without it
    the kernel stores none of these).  t = t_max and seg = -1 where
    nothing hit; an any-hit ray stops at its first hit, so only its
    `hit` is the closest walk's."""
    R = o.shape[0]
    o = _cuda_f32(o, "o", (R, 3))
    d = _cuda_f32(d, "d", (R, 3))
    t_min = _cuda_f32(t_min, "t_min", (R,))
    t_max = _cuda_f32(t_max, "t_max", (R,))
    nodes = _cuda_f32(cwbvh_rows, "cwbvh_rows",
                      (cwbvh_rows.shape[0], CWBVH_ROW))
    pieces = _cuda_f32(crv_rows, "crv_rows", (crv_rows.shape[0], CRV_ROW))
    if nodes.shape[0] == 0:
        raise ValueError("cwbvh_rows: no root row")
    if lanes is None:
        lanes = curve_lanes(R, o.device, any_hit)
    elif type(lanes) is not int or lanes not in LANES:
        raise ValueError(f"lanes {lanes!r}: C1 takes one of {LANES}")
    if stack is None:
        stack = STACK
    elif type(stack) is not int or not (SHORT < stack <= STACK and
                                        stack % SHORT == 0):
        raise ValueError(f"stack {stack!r}: C1 takes a multiple of {SHORT} "
                         f"above {SHORT} and at most {STACK}")
    dev = o.device
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    seg = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    counts = node_mark = piece_mark = None
    if stats:
        counts = torch.empty((len(COUNTS), R), dtype=torch.int32,
                             device=dev)
        node_mark = torch.zeros((nodes.shape[0],), dtype=torch.uint8,
                                device=dev)
        piece_mark = torch.zeros((pieces.shape[0],), dtype=torch.uint8,
                                 device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.curve_trace_launch(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        pieces.data_ptr(), nodes.data_ptr(), R, int(any_hit), lanes, stack,
        t.data_ptr(), seg.data_ptr(), u.data_ptr(),
        v.data_ptr(), hit.data_ptr(),
        *((counts.data_ptr(), node_mark.data_ptr(), piece_mark.data_ptr())
          if stats else (None, None, None)), stream)
    if err != 0:
        raise RuntimeError(f"curve_trace {'any' if any_hit else 'closest'}"
                           f"-hit kernel launch failed: CUDA error {err}")
    route = "curve_anyhit" if any_hit else "curve_closest"
    LAUNCHES[route] += 1
    if LAUNCH_LOG is not None:
        LAUNCH_LOG.append((route, R, lanes))
    out = (t, seg, u, v, hit)
    return out + (counts, node_mark, piece_mark) if stats else out

