"""Tensor-core leaf microbenchmark (port of tools_mxubench.py).

The TPU tool timed MXU products inside a Pallas loop that mimics the
wave-trace leaf's serialized visit chain: K4 (`make_loop_kernel`, the
product B^T a of a (K,M) scratch and the (K,N) input, optionally after a
chain of block stores) at several (M, K, N), and K5, three quad-cluster
leaf layouts (`kA` 48 stores + one product, `kB` / `kC` resident tables
read slice by slice).  On this card the MXU's counterpart is the tensor
cores: every variant is the hand-written CUDA kernel
csrc/leaf_mma.cu (wgmma m64n64k16 bf16 -> f32 from shared memory, one
64x64 tile of the product a block over the whole card, as the TPU's one
core was its whole chip).  Each returns what the TPU
kernel returned, the (1, N) f32 sum of row 0 of every product, plus a
checksum: the sum of every element of every product, accumulated in
float64 so that it is exact on the tool's all-ones inputs.  The checksum
keeps the whole product alive in the kernel (see the source's note).

Beside each kernel, its plain version (`*_plain`: torch.matmul on bf16
values upcast to f32, in a Python loop), a launch count (LAUNCHES) and
its bound: 2*M*K*N operations a product at the card's dense bf16 peak
(989 TFLOP/s), or the bytes the function must move from device memory
at 3.35 TB/s, whichever is larger.  The same at the share of both rates
of the SMs the launch's grid can occupy is reported beside it as
`sm_bound_ns`, with the blocks launched.  The wrappers take the plain
version for CPU tensors and launch the kernel for CUDA tensors; they
never fall back.

    python -m tungsten_tpu_torch.tools.mxubench [--device cuda|cpu]

runs the TPU tool's shapes (tools_mxubench.py:69-75) and the three
variants and prints, for each, ns per product (per quad for the
variants), TFLOP/s, the bound and torch.matmul's device time for the
same (M, K, N) (calls replayed from a CUDA graph): a yardstick only,
which the port never calls.  Unlike the TPU
tool it catches no failure, and it runs the variants (the TPU tool's
`__main__` calls bench_variants before defining it).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import time

import torch

LOOP_ITERS = 512            # bench(iters=512)
VARIANT_ITERS = 256         # the variants' fori_loop
M_LEAF, K_LEAF, N_LEAF = 2048, 48, 128
NCP = 1024                  # the variants' tables: (rows, NCP * 512)
TBL_PERIOD, TBL_STEP = 64, 2048   # column (i % 64) * 2048
# tools_mxubench.py:69-75
SHAPES = [(512, 48, 128), (512, 16, 128), (512, 128, 128), (1024, 48, 128),
          (2048, 48, 128), (512, 48, 256), (128, 48, 128), (256, 48, 128)]
STORE_SHAPES = [(512, 48, 128), (1024, 48, 128)]
VARIANTS = ("a", "b", "c")
TABLE_ROWS = {"a": None, "b": 48, "c": 32}
# the H100 SXM's dense bf16 tensor-core peak and HBM rate, and its SMs
# (NVIDIA data sheet: 989 TFLOP/s, 3.35 TB/s, 132 SMs)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
N_SM = 132
TIMED_RUNS = 5
TILE = 64                   # the kernel's (rows, columns) of product a block

# launches of the CUDA kernel per variant (the plain version does not count)
LAUNCHES = {"mma_loop": 0, "mma_loop_stores": 0, "leaf_variant_a": 0,
            "leaf_variant_b": 0, "leaf_variant_c": 0}

_MAX_KSTEPS, _MAX_PIECES, _MAX_MTILES = 8, 128, 32


class LeafParams(ctypes.Structure):
    """csrc/leaf_mma.cu's LeafParams, field for field."""
    _fields_ = [("tbl_ld", ctypes.c_longlong),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("kb_rows", ctypes.c_int), ("ka_rows", ctypes.c_int),
                ("iters", ctypes.c_int), ("nk", ctypes.c_int),
                ("kstep_b", ctypes.c_int * _MAX_KSTEPS),
                ("kstep_a", ctypes.c_int * _MAX_KSTEPS),
                ("n_pieces", ctypes.c_int),
                ("pc_row", ctypes.c_int * _MAX_PIECES),
                ("pc_rows", ctypes.c_int * _MAX_PIECES),
                ("pc_col", ctypes.c_int * _MAX_PIECES),
                ("pc_src", ctypes.c_int * _MAX_PIECES),
                ("pc_width", ctypes.c_int * _MAX_PIECES),
                ("tile_piece", ctypes.c_int * (_MAX_MTILES + 1)),
                ("src_rows", ctypes.c_int),
                ("table", ctypes.c_int),
                ("tbl_period", ctypes.c_int), ("tbl_step", ctypes.c_int),
                ("blocks", ctypes.c_int)]


# ------------------------------------------------------- what each computes

def loop_stores(M: int, K: int) -> list[tuple[int, int, int]]:
    """K4's store chain as (first B row, first B column, rows of a[0:rows,
    0:128]): tools_mxubench.py:27-31."""
    return [(ko + 4, c, 6) for ko in (0, 16, 32) if ko + 10 <= K
            for c in range(0, min(M, 512), 128)]


def variant_a_stores() -> list[tuple[int, int, int]]:
    """kA's 48 block stores (4 clusters x 3 arrangements of src, src,
    src4, src3): tools_mxubench.py:94-100."""
    out = []
    for q in range(4):
        for ko in (0, 16, 32):
            c = q * 512
            out += [(ko + 4, c + 128, 6), (ko + 4, c + 256, 6),
                    (ko, c + 384, 4), (ko + 4, c, 3)]
    return out


def split_stores(M: int, stores):
    """The store chain split over the kernel's 64-column tiles of B (the
    product's rows): (pieces, starts).  A piece (B row, rows, B column,
    a column, width) writes a[0:rows, a column:+width] into B[row:+rows,
    column:+width]; tile mt (columns 64*mt .. 64*mt+63) applies pieces
    [starts[mt], starts[mt+1]) in chain order."""
    pieces, starts = [], []
    for m0 in range(0, M, TILE):
        starts.append(len(pieces))
        for r0, c0, rows in stores:
            lo, hi = max(c0, m0), min(c0 + 128, m0 + TILE)
            if lo < hi:
                pieces.append((r0, rows, lo, lo - c0, hi - lo))
    starts.append(len(pieces))
    return pieces, starts


def tile_origins(M: int, N: int) -> list[tuple[int, int]]:
    """(first product row, first column) of each 64x64 tile in the
    kernel's tile order, in which the checksum's partials are summed.  A
    tile's block stages columns [row, row + 64) of each table slice."""
    return [(m0, n0) for m0 in range(0, M, TILE) for n0 in range(0, N, TILE)]


def grid_blocks(p) -> int:
    """Blocks one launch with these parameters runs: one a tile, or
    p.blocks of them walking the tiles in turn."""
    tiles = (p.M // TILE) * (p.N // TILE)
    return min(p.blocks, tiles) if p.blocks > 0 else tiles


def _k_steps(variant: str | None, K: int):
    """(B's 16-row block, a's 16-row block) of each 16-deep k step."""
    if variant == "c":   # K 32 against a[0:32], then rows 0-15 vs a[32:48]
        return [0, 1, 0], [0, 1, 2]
    return list(range(K // 16)), list(range(K // 16))


def _plain_loop(a, iters, b_of_iter, variant=None):
    """The plain version's loop: per iteration the product in f32 (bf16
    values upcast), row 0 summed in order, every element summed in f64.
    Returns (row (1, N) f32, checksum f64, last product (M, N) f32)."""
    af = a.float()
    N = a.shape[1]
    row = torch.zeros((1, N), dtype=torch.float32, device=a.device)
    cs = torch.zeros((), dtype=torch.float64, device=a.device)
    s = None
    for i in range(iters):
        b = b_of_iter(i).float()
        if variant == "c":
            s = b.T @ af[0:32] + b[0:16].T @ af[32:48]
        else:
            s = b.T @ af
        row = row + s[0:1]
        cs = cs + s.sum(dtype=torch.float64)
    return row, cs, s


def mma_loop_plain(a, M: int, iters: int = LOOP_ITERS,
                   with_stores: bool = False, b0=None):
    """K4's plain version: a (K, N) bf16; b0 as mma_loop's."""
    K = a.shape[0]
    b = torch.zeros((K, M), dtype=torch.bfloat16, device=a.device) \
        if b0 is None else b0.clone()
    stores = loop_stores(M, K) if with_stores else []

    def b_of_iter(_):
        for r0, c0, rows in stores:
            b[r0:r0 + rows, c0:c0 + 128] = a[0:rows, 0:128]
        return b
    return _plain_loop(a, iters, b_of_iter)


def leaf_variant_plain(variant: str, a, tbl=None,
                       iters: int = VARIANT_ITERS):
    """K5's plain version: a (48, 128) bf16; tbl (48 or 32, >= 64 * 2048)
    bf16 for variants b and c (the slices read are (i % 64) * 2048)."""
    if variant == "a":
        b = torch.zeros((K_LEAF, M_LEAF), dtype=torch.bfloat16,
                        device=a.device)
        stores = variant_a_stores()

        def b_of_iter(_):
            for r0, c0, rows in stores:
                b[r0:r0 + rows, c0:c0 + 128] = a[0:rows, 0:128]
            return b
    else:
        def b_of_iter(i):
            col = (i % TBL_PERIOD) * TBL_STEP
            return tbl[:, col:col + M_LEAF]
    return _plain_loop(a, iters, b_of_iter, variant)


# ------------------------------------------------------------------ kernel

@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build csrc/leaf_mma.cu with nvcc (first use) and bind it."""
    from tungsten_tpu_torch._build import build_shared
    from tungsten_tpu_torch.ops.wave_trace import NVCC_FLAGS, _nvcc
    path = build_shared("leaf_mma", ["csrc/leaf_mma.cu"],
                        [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.leaf_mma_launch.argtypes = [vp] * 6 + [ctypes.POINTER(LeafParams),
                                               vp]
    lib.leaf_mma_launch.restype = ctypes.c_int
    lib.leaf_mma_smem_bytes.argtypes = [ctypes.POINTER(LeafParams)]
    lib.leaf_mma_smem_bytes.restype = ctypes.c_int
    return lib


def make_params(M: int, N: int, kb_rows: int, ka_rows: int, iters: int,
                k_steps, stores=(), tbl_ld: int = 0,
                blocks: int = 0) -> LeafParams:
    """The kernel's launch parameters: the store chain split over tiles;
    tbl_ld > 0 is table mode (the table's row stride); blocks > 0 caps
    the grid (a check of the kernel; the tool's rows run one block a
    tile)."""
    p = LeafParams()
    p.M, p.N, p.kb_rows, p.ka_rows, p.iters = M, N, kb_rows, ka_rows, iters
    kb, ka = k_steps
    p.nk = len(kb)
    for j, (x, y) in enumerate(zip(kb, ka)):
        p.kstep_b[j], p.kstep_a[j] = x, y
    pieces, starts = split_stores(M, stores)
    if len(pieces) > _MAX_PIECES or len(starts) > _MAX_MTILES + 1:
        raise ValueError(f"{len(pieces)} store pieces over {len(starts) - 1}"
                         f" tiles: the kernel takes {_MAX_PIECES} over "
                         f"{_MAX_MTILES}")
    p.n_pieces = len(pieces)
    for i, (r0, rows, col, src, width) in enumerate(pieces):
        p.pc_row[i], p.pc_rows[i], p.pc_col[i] = r0, rows, col
        p.pc_src[i], p.pc_width[i] = src, width
    for i, s0 in enumerate(starts):
        p.tile_piece[i] = s0
    p.src_rows = max((rows for _, _, rows in stores), default=0)
    p.blocks = blocks
    if tbl_ld:
        p.table, p.tbl_ld = 1, tbl_ld
        p.tbl_period, p.tbl_step = TBL_PERIOD, TBL_STEP
    return p


@functools.lru_cache(maxsize=None)
def _row_params(M: int, N: int, K: int, iters: int, variant: str | None,
                with_stores: bool, tbl_ld: int, blocks: int) -> LeafParams:
    """A tool row's launch parameters, built once: the kernel only reads
    them, and building them (the split of kA's chain) costs the host
    more than a launch's device time, which the timing would count."""
    rows = TABLE_ROWS[variant] if variant else None
    stores = variant_a_stores() if variant == "a" else \
        loop_stores(M, K) if with_stores else ()
    return make_params(M, N, rows or K, K, iters, _k_steps(variant, K),
                       stores, tbl_ld, blocks)


def _check(x, name, shape):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: dtype {x.dtype}, expected torch.bfloat16")
    if tuple(x.shape[:len(shape)]) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def leaf_kernel(name: str, a, p: LeafParams, tbl=None, full: bool = False):
    """One launch of csrc/leaf_mma.cu on the current stream.  tbl is the
    table (p.table) or else the scratch's initial (kb_rows, M) value
    (None: zeros).  Returns (row (1, N) f32, checksum () f64, last
    product (M, N) f32 or None)."""
    _check(a, "a", (p.ka_rows, p.N))
    if tbl is not None and p.table:
        _check(tbl, "tbl", (p.kb_rows,))
        if tbl.shape[1] < (min(p.iters, TBL_PERIOD) - 1) * TBL_STEP + p.M:
            raise ValueError(f"tbl: {tbl.shape[1]} columns do not hold the "
                             f"slices {p.iters} iterations read")
    elif tbl is not None:
        _check(tbl, "b0", (p.kb_rows, p.M))
    lib = load_kernels()
    dev = a.device
    row = torch.empty((1, p.N), dtype=torch.float32, device=dev)
    cs = torch.empty((), dtype=torch.float64, device=dev)
    partial = torch.empty(((p.M // TILE) * (p.N // TILE),),
                          dtype=torch.float64, device=dev)
    last = torch.empty((p.M, p.N), dtype=torch.float32, device=dev) \
        if full else None
    err = lib.leaf_mma_launch(
        a.data_ptr(), tbl.data_ptr() if tbl is not None else None,
        row.data_ptr(), partial.data_ptr(), cs.data_ptr(),
        last.data_ptr() if last is not None else None, ctypes.byref(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf_mma kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return row, cs, last


def mma_loop(a, M: int, iters: int = LOOP_ITERS, with_stores: bool = False,
             full: bool = False, b0=None, blocks: int = 0):
    """K4: `iters` products of the (K, M) scratch with a (K, N) bf16.
    b0, a (K, M) bf16, starts the scratch in place of the TPU kernel's
    zeros: without it K4's product is zero but for the stored rows, so a
    check of the product needs it.  blocks > 0 caps the grid (checks
    only).  Returns (row, checksum, last product or None) as leaf_kernel;
    on a CPU tensor the plain version (which always returns the
    product)."""
    if a.device.type == "cpu":
        return mma_loop_plain(a, M, iters, with_stores, b0)
    K, N = a.shape
    p = _row_params(M, N, K, iters, None, with_stores, 0, blocks)
    return leaf_kernel("mma_loop_stores" if with_stores else "mma_loop", a,
                       p, b0, full=full)


def leaf_variant(variant: str, a, tbl=None, iters: int = VARIANT_ITERS,
                 full: bool = False, blocks: int = 0):
    """K5: variant "a", "b" or "c" on a (48, 128) bf16 (and the table of
    variants b and c); blocks as mma_loop's.  Returns as mma_loop."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if a.device.type == "cpu":
        return leaf_variant_plain(variant, a, tbl, iters)
    rows = TABLE_ROWS[variant]
    p = _row_params(M_LEAF, a.shape[1], a.shape[0], iters, variant, False,
                    tbl.shape[1] if rows else 0, blocks)
    return leaf_kernel(f"leaf_variant_{variant}", a, p,
                       tbl if rows else None, full=full)


# ----------------------------------------------------------------- bounds

def flops_per_product(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def bound_ns(M: int, K: int, N: int, iters: int, table_rows=None,
             sms: int = N_SM):
    """(least ns per product, "operations" or "bytes", bytes staged per
    iteration): the product's operations at the bf16 peak of `sms` SMs
    (the whole card by default) against the device-memory bytes the
    whole run must move (a once, the table slices it touches once, the
    outputs once) at their share of the HBM rate, spread over the
    iterations."""
    share = sms / N_SM
    ops_ns = flops_per_product(M, K, N) / (PEAK_BF16 * share) * 1e9
    nbytes = K * N * 2 + N * 4 + 8
    staged = 0
    if table_rows:
        staged = table_rows * M * 2
        nbytes += min(iters, TBL_PERIOD) * staged
    bytes_ns = nbytes / (PEAK_BYTES * share) * 1e9 / iters
    if ops_ns >= bytes_ns:
        return ops_ns, "operations", staged
    return bytes_ns, "bytes", staged


# ----------------------------------------------------------------- timing

def time_ms(fn, device, runs: int = TIMED_RUNS) -> float:
    """Median ms of fn() over `runs` after one warm-up: CUDA events on the
    card, the host clock on the CPU.  On the card each timed call is
    queued behind an untimed one, so the host's work for the call
    overlaps that one's device time and the events see the device's."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            fn()
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def library_ms(M: int, K: int, N: int, device, calls: int = 50) -> float | None:
    """torch.matmul's device ms for one (M, K) x (K, N) bf16 product on the
    card (the B^T view of a (K, M) tensor, as the kernel reads it): the
    yardstick of the kernels' rows.  `calls` products are captured in a
    CUDA graph and its replay is timed with events, so the host's launch
    rate does not enter.  None on the CPU."""
    if device.type != "cuda":
        return None
    g = torch.Generator(device=device).manual_seed(1)
    b = torch.rand((K, M), generator=g, device=device).to(torch.bfloat16)
    a = torch.rand((K, N), generator=g, device=device).to(torch.bfloat16)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):   # cuBLAS's handle and workspace
        for _ in range(3):
            torch.matmul(b.T, a)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            torch.matmul(b.T, a)
    return time_ms(graph.replay, device) / calls


def ones_inputs(K: int, N: int, device, table_rows=None):
    """The tool's inputs: jnp.ones((K, N)) and jnp.ones((rows, NCP*512))."""
    a = torch.ones((K, N), dtype=torch.bfloat16, device=device)
    tbl = torch.ones((table_rows, NCP * 512), dtype=torch.bfloat16,
                     device=device) if table_rows else None
    return a, tbl


def _result(name, M, K, N, iters, ms, blocks, dev, table_rows=None):
    """One row's numbers: ns per product, TFLOP/s, the bound at the whole
    card and at the SMs `blocks` can occupy, and torch.matmul's device
    time (on the tool's own grid only: a capped grid is a check)."""
    ns = ms * 1e6 / iters
    b_ns, by, staged = bound_ns(M, K, N, iters, table_rows)
    lib = library_ms(M, K, N, dev) if blocks == len(tile_origins(M, N)) \
        else None
    return dict(name=name, M=M, K=K, N=N, iters=iters, ns=ns,
                tflops=flops_per_product(M, K, N) / ns * 1e-3,
                bound_ns=b_ns, bound_by=by, blocks=blocks,
                sm_bound_ns=bound_ns(M, K, N, iters, table_rows,
                                     sms=min(blocks, N_SM))[0],
                staged_bytes=staged,
                library_ns=None if lib is None else lib * 1e6,
                device=str(dev))


def bench(M: int, K: int, N: int, iters: int = LOOP_ITERS,
          with_stores: bool = False, device=None, blocks: int = 0) -> dict:
    """One K4 shape on the tool's inputs: the kernel's ns per product
    against its bound and torch.matmul's device time; blocks > 0 caps
    the grid (the anti-hoisting check; no yardstick then)."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    a, _ = ones_inputs(K, N, dev)
    ms = time_ms(lambda: mma_loop(a, M, iters, with_stores, blocks=blocks),
                 dev)
    p = _row_params(M, N, K, iters, None, with_stores, 0, blocks)
    return _result("mma_loop_stores" if with_stores else "mma_loop", M, K, N,
                   iters, ms, grid_blocks(p), dev)


def bench_variant(variant: str, iters: int = VARIANT_ITERS,
                  device=None) -> dict:
    """One K5 variant on the tool's inputs: ns per quad (one product),
    its bound, the bytes it stages per iteration and torch.matmul's
    device time for the (2048, 48, 128) product."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rows = TABLE_ROWS[variant]
    a, tbl = ones_inputs(K_LEAF, N_LEAF, dev, rows)
    ms = time_ms(lambda: leaf_variant(variant, a, tbl, iters), dev)
    r = _result(f"leaf_variant_{variant}", M_LEAF, K_LEAF, N_LEAF, iters, ms,
                len(tile_origins(M_LEAF, N_LEAF)), dev, rows)
    r["table_mb"] = (rows * NCP * 512 * 2 >> 20) if rows else 0
    return r


def format_result(r: dict) -> str:
    lib = "n/a" if r["library_ns"] is None else f"{r['library_ns']:.0f} ns"
    if r["name"].startswith("leaf_variant"):
        extra = (f"  [table {r['table_mb']} MiB in device memory, "
                 f"{r['staged_bytes']} bytes staged per iteration]"
                 if r["table_mb"] else "")
        head = (f"variant {r['name'][-1].upper()}: {r['ns']:9.1f} ns/quad "
                f"({r['ns'] / 4:8.1f} ns/cluster-visit)")
    else:
        extra = ""
        label = "+stores" if r["name"].endswith("stores") else "       "
        head = (f"M={r['M']:5d} K={r['K']:3d} N={r['N']:4d} {label}: "
                f"{r['ns']:9.1f} ns/matmul")
    return (f"{head} ({r['tflops']:6.2f} TFLOP/s), bound {r['bound_ns']:.2f} "
            f"ns ({r['bound_by']}; {r['blocks']} blocks: "
            f"{r['sm_bound_ns']:.1f} ns), torch.matmul {lib}{extra}")


def run_all(device=None, verbose: bool = True) -> list[dict]:
    """The tool's main path: every K4 shape, the store-chain shapes and
    the three K5 variants.  Returns one result dict each."""
    out = [bench(*s, device=device) for s in SHAPES]
    out += [bench(*s, with_stores=True, device=device) for s in STORE_SHAPES]
    out += [bench_variant(v, device=device) for v in VARIANTS]
    if verbose:
        for r in out:
            print(format_result(r), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tungsten_tpu_torch.tools.mxubench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        "cpu (plain versions; host times, not device times)"
    print(f"device: {name}", flush=True)
    run_all(dev)


if __name__ == "__main__":
    main()
