"""Tensor-core leaf microbenchmark (port of tools_mxubench.py).

The TPU tool timed MXU products inside a Pallas loop that mimics the
wave-trace leaf's serialized visit chain: K4 (`make_loop_kernel`, the
product B^T a of a (K,M) scratch and the (K,N) input, optionally after a
chain of block stores) at several (M, K, N), and K5, three quad-cluster
leaf layouts (`kA` 48 stores + one product, `kB` / `kC` resident tables
read slice by slice).  On this card the MXU's counterpart is the tensor
cores: every variant is the hand-written CUDA kernel
csrc/leaf_mma.cu (mma.sync m16n8k16 bf16 -> f32 from shared memory, one
block, as the TPU ran grid=(1,) on one core).  Each returns what the TPU
kernel returned, the (1, N) f32 sum of row 0 of every product, plus a
checksum: the sum of every element of every product, accumulated in
float64 so that it is exact on the tool's all-ones inputs.  The checksum
keeps the whole product alive in the kernel (see the source's note).

Beside each kernel, its plain version (`*_plain`: torch.matmul on bf16
values upcast to f32, in a Python loop), a launch count (LAUNCHES) and
its bound: 2*M*K*N operations a product at the card's dense bf16 peak
(989 TFLOP/s), or the bytes the function must move from device memory
at 3.35 TB/s, whichever is larger.  The same at one SM's share of both
rates (1/132) is reported beside it as `sm_bound_ns`: the least time of
one block, as the TPU tool ran one core.  The wrappers take the plain
version for CPU tensors and launch the kernel for CUDA tensors; they
never fall back.

    python -m tungsten_tpu_torch.tools.mxubench [--device cuda|cpu]

runs the TPU tool's shapes (tools_mxubench.py:69-75) and the three
variants and prints, for each, ns per product (per quad for the
variants), TFLOP/s, the bound and torch.matmul's time for the same
(M, K, N): a yardstick only, which the port never calls.  Unlike the TPU
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

# launches of the CUDA kernel per variant (the plain version does not count)
LAUNCHES = {"mma_loop": 0, "mma_loop_stores": 0, "leaf_variant_a": 0,
            "leaf_variant_b": 0, "leaf_variant_c": 0}

_MAX_KSTEPS, _MAX_STORES = 8, 48


class LeafParams(ctypes.Structure):
    """csrc/leaf_mma.cu's LeafParams, field for field."""
    _fields_ = [("tbl_ld", ctypes.c_longlong),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("kb_rows", ctypes.c_int), ("ka_rows", ctypes.c_int),
                ("iters", ctypes.c_int), ("nk", ctypes.c_int),
                ("kstep_b", ctypes.c_int * _MAX_KSTEPS),
                ("kstep_a", ctypes.c_int * _MAX_KSTEPS),
                ("n_stores", ctypes.c_int),
                ("st_row", ctypes.c_int * _MAX_STORES),
                ("st_col", ctypes.c_int * _MAX_STORES),
                ("st_rows", ctypes.c_int * _MAX_STORES),
                ("table", ctypes.c_int),
                ("tbl_period", ctypes.c_int), ("tbl_step", ctypes.c_int)]


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
    lib.leaf_mma_launch.argtypes = [vp] * 5 + [ctypes.POINTER(LeafParams),
                                               vp]
    lib.leaf_mma_launch.restype = ctypes.c_int
    lib.leaf_mma_smem_bytes.argtypes = [ctypes.POINTER(LeafParams)]
    lib.leaf_mma_smem_bytes.restype = ctypes.c_int
    return lib


def make_params(M: int, N: int, kb_rows: int, ka_rows: int, iters: int,
                k_steps, stores=(), tbl=None) -> LeafParams:
    """The kernel's launch parameters."""
    p = LeafParams()
    p.M, p.N, p.kb_rows, p.ka_rows, p.iters = M, N, kb_rows, ka_rows, iters
    kb, ka = k_steps
    p.nk = len(kb)
    for j, (x, y) in enumerate(zip(kb, ka)):
        p.kstep_b[j], p.kstep_a[j] = x, y
    p.n_stores = len(stores)
    for s, (r0, c0, rows) in enumerate(stores):
        p.st_row[s], p.st_col[s], p.st_rows[s] = r0, c0, rows
    if tbl is not None:
        p.table, p.tbl_ld = 1, tbl.shape[1]
        p.tbl_period, p.tbl_step = TBL_PERIOD, TBL_STEP
    return p


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
        p.tbl_ld = p.M
    lib = load_kernels()
    dev = a.device
    row = torch.empty((1, p.N), dtype=torch.float32, device=dev)
    cs = torch.empty((), dtype=torch.float64, device=dev)
    last = torch.empty((p.M, p.N), dtype=torch.float32, device=dev) \
        if full else None
    err = lib.leaf_mma_launch(
        a.data_ptr(), tbl.data_ptr() if tbl is not None else None,
        row.data_ptr(), cs.data_ptr(),
        last.data_ptr() if last is not None else None, ctypes.byref(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf_mma kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return row, cs, last


def mma_loop(a, M: int, iters: int = LOOP_ITERS, with_stores: bool = False,
             full: bool = False, b0=None):
    """K4: `iters` products of the (K, M) scratch with a (K, N) bf16.
    b0, a (K, M) bf16, starts the scratch in place of the TPU kernel's
    zeros: without it K4's product is zero but for the stored rows, so a
    check of the product needs it.  Returns (row, checksum, last product
    or None) as leaf_kernel; on a CPU tensor the plain version (which
    always returns the product)."""
    if a.device.type == "cpu":
        return mma_loop_plain(a, M, iters, with_stores, b0)
    K, N = a.shape
    p = make_params(M, N, K, K, iters, _k_steps(None, K),
                    loop_stores(M, K) if with_stores else ())
    return leaf_kernel("mma_loop_stores" if with_stores else "mma_loop", a,
                       p, b0, full=full)


def leaf_variant(variant: str, a, tbl=None, iters: int = VARIANT_ITERS,
                 full: bool = False):
    """K5: variant "a", "b" or "c" on a (48, 128) bf16 (and the table of
    variants b and c).  Returns as mma_loop."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if a.device.type == "cpu":
        return leaf_variant_plain(variant, a, tbl, iters)
    rows = TABLE_ROWS[variant]
    p = make_params(M_LEAF, a.shape[1], rows or K_LEAF, a.shape[0], iters,
                    _k_steps(variant, K_LEAF),
                    variant_a_stores() if variant == "a" else (),
                    tbl if rows else None)
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
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
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
    """torch.matmul's ms for one (M, K) x (K, N) bf16 product on the card
    (the B^T view of a (K, M) tensor, as the kernel reads it): the
    yardstick of the kernels' rows.  None on the CPU."""
    if device.type != "cuda":
        return None
    g = torch.Generator(device=device).manual_seed(1)
    b = torch.rand((K, M), generator=g, device=device).to(torch.bfloat16)
    a = torch.rand((K, N), generator=g, device=device).to(torch.bfloat16)

    def run():
        for _ in range(calls):
            torch.matmul(b.T, a)
    return time_ms(run, device) / calls


def ones_inputs(K: int, N: int, device, table_rows=None):
    """The tool's inputs: jnp.ones((K, N)) and jnp.ones((rows, NCP*512))."""
    a = torch.ones((K, N), dtype=torch.bfloat16, device=device)
    tbl = torch.ones((table_rows, NCP * 512), dtype=torch.bfloat16,
                     device=device) if table_rows else None
    return a, tbl


def bench(M: int, K: int, N: int, iters: int = LOOP_ITERS,
          with_stores: bool = False, device=None) -> dict:
    """One K4 shape on the tool's inputs: the kernel's ns per product
    against its bound and torch.matmul's time."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    a, _ = ones_inputs(K, N, dev)
    ms = time_ms(lambda: mma_loop(a, M, iters, with_stores), dev)
    b_ns, by, _ = bound_ns(M, K, N, iters)
    lib = library_ms(M, K, N, dev)
    ns = ms * 1e6 / iters
    return dict(name="mma_loop_stores" if with_stores else "mma_loop",
                M=M, K=K, N=N, iters=iters, ns=ns,
                tflops=flops_per_product(M, K, N) / ns * 1e-3,
                bound_ns=b_ns, bound_by=by,
                sm_bound_ns=bound_ns(M, K, N, iters, sms=1)[0],
                library_ns=None if lib is None else lib * 1e6,
                device=str(dev))


def bench_variant(variant: str, iters: int = VARIANT_ITERS,
                  device=None) -> dict:
    """One K5 variant on the tool's inputs: ns per quad (one product),
    its bound, the bytes it stages per iteration and torch.matmul's
    time for the (2048, 48, 128) product."""
    from tungsten_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rows = TABLE_ROWS[variant]
    a, tbl = ones_inputs(K_LEAF, N_LEAF, dev, rows)
    ms = time_ms(lambda: leaf_variant(variant, a, tbl, iters), dev)
    b_ns, by, staged = bound_ns(M_LEAF, K_LEAF, N_LEAF, iters, rows)
    lib = library_ms(M_LEAF, K_LEAF, N_LEAF, dev)
    ns = ms * 1e6 / iters
    return dict(name=f"leaf_variant_{variant}", M=M_LEAF, K=K_LEAF,
                N=N_LEAF, iters=iters, ns=ns,
                tflops=flops_per_product(M_LEAF, K_LEAF, N_LEAF) / ns * 1e-3,
                bound_ns=b_ns, bound_by=by,
                sm_bound_ns=bound_ns(M_LEAF, K_LEAF, N_LEAF, iters, rows,
                                     sms=1)[0],
                staged_bytes=staged,
                table_mb=(rows * NCP * 512 * 2 >> 20) if rows else 0,
                library_ns=None if lib is None else lib * 1e6,
                device=str(dev))


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
            f"ns ({r['bound_by']}; one SM {r['sm_bound_ns']:.1f} ns), "
            f"torch.matmul {lib}{extra}")


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
