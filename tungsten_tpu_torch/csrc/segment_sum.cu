// Ordered float accumulation for Hopper (sm_90a): kernel S1.
//
// S1 replaces no Pallas kernel.  The JAX package sums its framebuffer,
// splats, tile statistics and photon gathers with XLA scatters
// (`.at[].add`, `segment_sum`), which add in a fixed order on the TPU and
// on the CPU, so its renders repeat bit for bit.  PyTorch's `index_add_`
// on CUDA adds with atomics, in whatever order the threads arrive, so the
// port's card frames changed from run to run in the last bits.  S1 adds
// in one fixed order instead: the order in which the CPU's `index_add_`
// adds the same rows (row index order), so the card repeats itself and,
// on the same inputs, matches the CPU bit for bit.
//
// segment_sum_kernel: given segment ids `seg` (P,) in which equal ids
// are contiguous (sorted ids, or unique ones) and values v (P, C), it
// adds each segment's rows in index order into out[seg] (N, C), starting
// from the value out holds: out[s, c] = ((out[s, c] + v[r0, c]) + v[r1,
// c]) + ..., with exactly one writer per output element.  `perm` (P,),
// when given, is the row of v that sorted row r reads (v[perm[r]]), so
// the caller's stable sort is applied on the fly.  Ids outside [0, N)
// and empty segments write nothing.
//
// Its walk, in tiles of `tile` sorted rows (256-4,096 rows, the most
// whose values fit in 12 KB of shared memory: 1,024 for 3 f32 columns)
// and blocks of at most 32 columns (grid.y):
//   1. the CTA stages the tile's ids (and the row before and after it)
//      and perm into shared memory with cp.async, coalesced;
//   2. it flags the heads (a row whose id differs from the row before)
//      and lists them in row order with a block-wide scan; the CTA owns
//      the segments whose head lies in its tile, and skips the rows
//      before its first head (an earlier tile's segment);
//   3. it gathers v[perm[r]] of the owned rows into shared memory with
//      cp.async, threads spread over the (row, vector) pairs, 16, 8 or 4
//      bytes a copy where C and the alignment allow (without perm the
//      rows are one contiguous range, copied 16 bytes at a time);
//   4. one thread a (head, column) folds its segment from shared memory
//      in row order and writes the output once;
//   5. a segment that runs past the tile is folded by its head's CTA:
//      warp 0 carries the accumulators (a lane a column) through the
//      following chunks of tile / 2 rows, which warps 1-7 stage into the
//      two halves of the value buffer in turn (double-buffered, named
//      barriers between the two roles), so a long segment costs its
//      dependent adds from shared memory and the chunks' loads overlap
//      them.  Grouped ids mean a segment's id appears nowhere else, so
//      a chunk's rows of the segment are exactly those with its id.
// What bounds it: bytes (the ids, perm and values read once, the output
// rows read and written once), except where one segment is long; that
// is a chain of dependent adds by nature (the order is the CPU's).
//
// ordered_scan_kernel: the inclusive sum along the last axis of a
// row-major (rows, L) array, each row added left to right in double
// (the CPU's float cumsum accumulates in double too, aten
// cpu_cum_base_kernel), each output rounded once to the input type;
// with `reverse`, right to left (cumsum's derivative, the CPU's
// flip-cumsum-flip).  Two paths, by L:
//   * rows (L <= 256): a CTA stages a block of rows into shared memory
//     (an odd row stride, so a warp's threads read distinct banks), a
//     thread folds a row in double in place, and the CTA stores the
//     block coalesced;
//   * long (L > 256): a CTA a row, in chunks of up to 64 KB (16,384 f32,
//     8,192 f64; the row rounded up to the CTA's 512 threads) staged
//     with cp.async, a pad after every 32 elements so that the threads'
//     runs of consecutive elements fall in distinct banks.
//     A chunk is first scanned in parallel: each thread's run of up to 32
//     consecutive elements to its total, the totals across the CTA, then
//     each thread's run again from its carry-in, its prefixes kept aside,
//     every add followed by its TwoSum error term.  If every error is exactly zero, every partial
//     sum was exact, so each prefix is the exact sum of the carry and the
//     chunk's elements up to it, representable in double, and the
//     left-to-right fold would have produced the same bits; the prefixes
//     are written (plus +0.0: the fold starts from +0.0 and never
//     produces -0.0).  If any error is non-zero or not finite (inf, NaN,
//     overflow), one thread refolds the chunk left to right in double
//     from shared memory (the threads convert to and from double around
//     it), which is the CPU's order by construction.  Either way the
//     chunk's last prefix is the fold's value, the carry of the next.
// PyTorch's CUDA cumsum of a 1-D float tensor is a decoupled look-back
// scan whose association depends on timing.  Both paths are bound by
// bytes (x read once, y written once), the refold by its dependent adds.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int SS_THREADS = 256;      // segment sum: threads a CTA
constexpr int SS_WARPS = SS_THREADS / 32;
constexpr int SS_PRODUCERS = SS_THREADS - 32;   // warps 1-7
constexpr int SS_COLS = 32;          // at most this many columns a CTA
constexpr int SS_MIN_CTAS = 6;       // registers capped for 6 CTAs an SM
constexpr int SS_VALUE_BYTES = 12 * 1024;   // a tile's values, at most
constexpr int SCAN_THREADS = 256;    // the rows path
constexpr int SCAN_ROWS_MAX_L = 256;       // rows path up to this L
constexpr int SCAN_ROWS_BYTES = 48 * 1024; // its shared staging
constexpr long long SCAN_LONG_MAX_ROWS = 1024;   // long path below this
constexpr int LONG_THREADS = 512;    // the long path
constexpr int LONG_CHUNK_BYTES = 64 * 1024;   // its largest chunk of T

// named barriers of the segment sum's continuation (0 is __syncthreads)
constexpr int BAR_FULL = 1;    // + buffer: a chunk staged
constexpr int BAR_EMPTY = 3;   // + buffer: a chunk folded
constexpr int BAR_PROD = 5;    // the producers among themselves

__device__ __forceinline__ unsigned smem_addr(const void *p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void *dst, const void *src) {
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "n"(BYTES));
    }
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// named barriers by immediate id (so ptxas counts the ids in use); `b`
// picks id ID + 1
template <int ID>
__device__ __forceinline__ void bar_sync(int b, int count) {
    if (b) {
        asm volatile("bar.sync %0, %1;\n" ::"n"(ID + 1), "r"(count)
                     : "memory");
    } else {
        asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
    }
}

template <int ID>
__device__ __forceinline__ void bar_arrive(int b, int count) {
    if (b) {
        asm volatile("bar.arrive %0, %1;\n" ::"n"(ID + 1), "r"(count)
                     : "memory");
    } else {
        asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "r"(count)
                     : "memory");
    }
}

// copies `n` vectors of W elements of T, one cp.async each
template <typename T, int W>
__device__ __forceinline__ void copy_vecs(T *dst, const T *src, int n) {
    for (int q = 0; q < n; ++q) {
        cp_async<static_cast<int>(W * sizeof(T))>(dst + q * W, src + q * W);
    }
}

// Stages rows [lo, hi) (local to `row0`, the global row of buffer row 0)
// of columns [c0, c0 + ncol) of v into buf (row stride cw), the rows'
// vectors spread over `nth` threads (this one `t`).  `prow` gives the
// source row of local row i (perm in shared memory), or null for row0 +
// i; a row whose id (`sid`, local) lies outside [0, N) is skipped.
template <typename T, int W>
__device__ void stage_rows(T *buf, const T *v, const long long *prow,
                           const long long *sid, long long row0, int lo,
                           int hi, int C, int c0, int ncol, int cw,
                           long long N, int t, int nth) {
    const int vpr = ncol / W;
    const int items = (hi - lo) * vpr;
    for (int it = t; it < items; it += nth) {
        const int rr = it / vpr;
        const int q = it - rr * vpr;
        const int i = lo + rr;
        const long long s = sid[i];
        if (s < 0 || s >= N) continue;
        const long long row = prow ? prow[i] : row0 + i;
        cp_async<static_cast<int>(W * sizeof(T))>(
            buf + i * cw + q * W, v + row * C + c0 + q * W);
    }
}

// Stages the contiguous elements [e0, e1) of v counted from `base` into
// buf[e0, e1): 16 bytes a copy in the aligned middle (v and base 16-byte
// aligned), single elements at the edges.
template <typename T>
__device__ void stage_flat(T *buf, const T *v, long long base, int e0,
                           int e1, int t, int nth) {
    constexpr int VE = 16 / sizeof(T);
    const int u0 = (e0 + VE - 1) / VE, u1 = e1 / VE;
    if (u0 >= u1) {
        for (int e = e0 + t; e < e1; e += nth) {
            cp_async<static_cast<int>(sizeof(T))>(buf + e, v + base + e);
        }
        return;
    }
    for (int e = e0 + t; e < u0 * VE; e += nth) {
        cp_async<static_cast<int>(sizeof(T))>(buf + e, v + base + e);
    }
    for (int u = u0 + t; u < u1; u += nth) {
        cp_async<16>(buf + u * VE, v + base + u * VE);
    }
    for (int e = u1 * VE + t; e < e1; e += nth) {
        cp_async<static_cast<int>(sizeof(T))>(buf + e, v + base + e);
    }
}

// acc plus x[0], x[cw], ... x[(n - 1) * cw], in that order, eight loads
// issued ahead of their adds
template <typename T>
__device__ __forceinline__ T fold_col(const T *x, int n, int cw, T acc) {
    int r = 0;
    for (; r + 8 <= n; r += 8) {
        T t[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = x[(r + k) * cw];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = acc + t[k];
    }
    for (; r < n; ++r) acc = acc + x[r * cw];
    return acc;
}

// Step 4 of the walk: `items` (head, column) pairs (head-major), spread
// over `nth` threads (this one `t`), each folding its segment's staged
// rows into its output; IB items a thread at a time, so that their
// output reads are in flight together.
template <typename T>
__device__ void fold_items(const T *sv, const long long *sseg,
                           const int *sheads, T *out, int items, int nh,
                           int n, int ncol, int cw, int C, int c0,
                           long long N, int t, int nth) {
    constexpr int IB = 4;
    for (int it0 = t; it0 < items; it0 += nth * IB) {
        T acc[IB];
        long long at[IB];
        int first_v[IB], rows[IB];   // its first staged value, its rows
#pragma unroll
        for (int u = 0; u < IB; ++u) {
            const int it = it0 + u * nth;
            at[u] = -1;
            if (it >= items) continue;
            const int j = it / ncol;
            const int c = it - j * ncol;
            const int h = sheads[j];
            const long long s = sseg[h + 1];
            if (s < 0 || s >= N) continue;
            at[u] = s * C + c0 + c;
            acc[u] = out[at[u]];
            first_v[u] = h * cw + c;
            rows[u] = (j + 1 < nh ? sheads[j + 1] : n) - h;
        }
#pragma unroll
        for (int u = 0; u < IB; ++u) {
            if (at[u] < 0) continue;
            out[at[u]] = fold_col(sv + first_v[u], rows[u], cw, acc[u]);
        }
    }
}

template <typename T, int W>
__global__ void __launch_bounds__(SS_THREADS, SS_MIN_CTAS)
segment_sum_kernel(const long long *__restrict__ seg,
                   const long long *__restrict__ perm,
                   const T *__restrict__ v, T *__restrict__ out,
                   long long P, int C, long long N, int tile, int cw,
                   int flat16) {
    extern __shared__ __align__(16) unsigned char smem[];
    T *sv = reinterpret_cast<T *>(smem);   // tile x cw values
    long long *sseg = reinterpret_cast<long long *>(
        smem + static_cast<size_t>(tile) * cw * sizeof(T));   // tile + 2
    long long *sperm = sseg + tile + 2;                         // tile
    int *sheads = reinterpret_cast<int *>(sperm + tile);        // tile
    __shared__ int swarp[SS_WARPS + 1];
    __shared__ int scnt[2];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long t0 = static_cast<long long>(blockIdx.x) * tile;
    const int c0 = blockIdx.y * cw;
    const int ncol = min(cw, C - c0);
    const int n = static_cast<int>(min(static_cast<long long>(tile),
                                       P - t0));

    // 1. the tile's ids: sseg[i] is row t0 - 1 + i (i = 0 .. n + 1)
    for (int i = tid; i < n + 2; i += SS_THREADS) {
        const long long r = t0 - 1 + i;
        if (r >= 0 && r < P) cp_async<8>(sseg + i, seg + r);
    }
    if (perm) {
        for (int i = tid; i < n; i += SS_THREADS) {
            cp_async<8>(sperm + i, perm + t0 + i);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. the heads, in row order (rows tid * rpt .. of this thread)
    const int rpt = tile / SS_THREADS;
    int cnt = 0;
    for (int k = 0; k < rpt; ++k) {
        const int i = tid * rpt + k;
        if (i < n && (t0 + i == 0 || sseg[i] != sseg[i + 1])) ++cnt;
    }
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) swarp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < SS_WARPS ? swarp[lane] : 0;
        int winc = w;
#pragma unroll
        for (int d = 1; d < SS_WARPS; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, winc, d);
            if (lane >= d) winc += y;
        }
        if (lane < SS_WARPS) swarp[lane] = winc - w;
        if (lane == SS_WARPS - 1) swarp[SS_WARPS] = winc;
    }
    __syncthreads();
    int w = swarp[warp] + inc - cnt;
    for (int k = 0; k < rpt; ++k) {
        const int i = tid * rpt + k;
        if (i < n && (t0 + i == 0 || sseg[i] != sseg[i + 1])) {
            sheads[w++] = i;
        }
    }
    const int nh = swarp[SS_WARPS];
    if (nh == 0) return;   // the whole tile continues an earlier segment
    __syncthreads();

    const int first = sheads[0], hl = sheads[nh - 1];
    const long long sl = sseg[hl + 1];
    // the last segment runs past the tile (a valid id only: an invalid
    // one adds nothing, and the next tiles see no head for it)
    const bool cont = t0 + n < P && sseg[n + 1] == sl && sl >= 0 && sl < N;

    // 3. the owned rows' values
    if (!perm && flat16 && ncol == C) {
        stage_flat<T>(sv, v, t0 * C, first * C, n * C, tid, SS_THREADS);
    } else {
        stage_rows<T, W>(sv, v, perm ? sperm : nullptr, sseg + 1, t0, first,
                         n, C, c0, ncol, cw, N, tid, SS_THREADS);
    }
    cp_async_wait_all();
    __syncthreads();

    // 4. one thread a (head, column): its segment in row order (the
    // last one later if it runs on)
    fold_items(sv, sseg, sheads, out, (cont ? nh - 1 : nh) * ncol, nh, n,
               ncol, cw, C, c0, N, tid, SS_THREADS);
    if (!cont) return;

    // 5. the segment that runs on: warp 0 folds it (a lane a column) from
    // its head through the following chunks of tile / 2 rows, which warps
    // 1-7 stage into the two halves of the value buffer in turn
    T acc = T(0);
    if (tid < ncol) {
        acc = fold_col(sv + hl * cw + tid, n - hl, cw,
                       out[sl * C + c0 + tid]);
    }
    __syncthreads();   // the tile's values are read: the buffer is free
    const int ch = tile / 2;
    long long k = t0 + n;
    if (warp == 0) {
        for (int i = 0;; ++i) {
            const int b = i & 1;
            const int lim = static_cast<int>(min(static_cast<long long>(ch),
                                                 P - k));
            bar_sync<BAR_FULL>(b, SS_THREADS);
            const int got = scnt[b];
            if (tid < ncol) acc = fold_col(sv + b * ch * cw + tid, got, cw, acc);
            __syncwarp();
            if (!(got == lim && k + lim < P)) break;
            bar_arrive<BAR_EMPTY>(b, SS_THREADS);
            k += ch;
        }
        if (tid < ncol) out[sl * C + c0 + tid] = acc;
    } else {
        const int pt = tid - 32;
        for (int i = 0;; ++i) {
            const int b = i & 1;
            const int lim = static_cast<int>(min(static_cast<long long>(ch),
                                                 P - k));
            if (i >= 2) bar_sync<BAR_EMPTY>(b, SS_THREADS);
            if (pt == 0) scnt[b] = lim;
            bar_sync<BAR_PROD>(0, SS_PRODUCERS);
            // the chunk's rows of the segment (its id, from the start):
            // staged; the first other row found, reduced by warp
            T *buf = sv + b * ch * cw;
            int other = lim;
            for (int r = pt; r < lim; r += SS_PRODUCERS) {
                const long long id = seg[k + r];
                const long long row = perm ? perm[k + r] : k + r;
                if (id != sl) {
                    other = r;
                    break;
                }
                copy_vecs<T, W>(buf + r * cw, v + row * C + c0, ncol / W);
            }
            __syncwarp();
            other = __reduce_min_sync(0xffffffffu, other);
            if (lane == 0 && other < lim) atomicMin(&scnt[b], other);
            cp_async_wait_all();
            __syncwarp();
            bar_sync<BAR_PROD>(0, SS_PRODUCERS);
            const int got = scnt[b];
            bar_arrive<BAR_FULL>(b, SS_THREADS);
            if (!(got == lim && k + lim < P)) {
                // the consumer arrived once more, after chunk i - 1
                if (i >= 1) bar_sync<BAR_EMPTY>(b ^ 1, SS_THREADS);
                break;
            }
            k += ch;
        }
    }
}

// Folds p[0 .. n) left to right in double from acc, each element
// replaced by its prefix rounded to T, eight elements read ahead of the
// adds (they sit where the prefixes are written, so the compiler would
// not read them early itself); returns the last prefix.
template <typename T>
__device__ double fold_run(T *p, int n, double acc) {
    double cur[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) cur[k] = k < n ? static_cast<double>(p[k]) : 0.0;
    int e = 0;
    for (; e + 16 <= n; e += 8) {
        double nxt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) nxt[k] = static_cast<double>(p[e + 8 + k]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            acc += cur[k];
            p[e + k] = static_cast<T>(acc);
            cur[k] = nxt[k];
        }
    }
    for (; e < n; ++e) {
        acc += static_cast<double>(p[e]);
        p[e] = static_cast<T>(acc);
    }
    return acc;
}

// fold_run on doubles two at a time (16-byte shared loads and stores, p
// 16-byte aligned): the long path's refold, one thread's chain of adds
__device__ double fold_doubles(double *p, int n, double acc) {
    double2 *q = reinterpret_cast<double2 *>(p);
    const int n2 = n / 2;
    double2 cur[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = k < n2 ? q[k] : make_double2(0, 0);
    int i = 0;
    for (; i + 8 <= n2; i += 4) {
        double2 nxt[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) nxt[k] = q[i + 4 + k];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            acc += cur[k].x;
            cur[k].x = acc;
            acc += cur[k].y;
            cur[k].y = acc;
            q[i + k] = cur[k];
            cur[k] = nxt[k];
        }
    }
    for (int e = 2 * i; e < n; ++e) {
        acc += p[e];
        p[e] = acc;
    }
    return acc;
}

// The rows path: rows [row0, row0 + nr) of L elements, staged with row
// stride ls (odd) in scan order (reversed with `reverse`), a thread a
// row.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
ordered_scan_rows_kernel(const T *__restrict__ x, T *__restrict__ y,
                         long long rows, int L, int rblock, int ls,
                         int reverse) {
    extern __shared__ __align__(16) unsigned char smem[];
    T *sx = reinterpret_cast<T *>(smem);
    const int tid = threadIdx.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * rblock;
    const int nr = static_cast<int>(min(static_cast<long long>(rblock),
                                        rows - row0));
    const int n = nr * L;
    const T *xb = x + row0 * L;
    T *yb = y + row0 * L;
    // element e = r * L + j sits at r * ls + j (L - 1 - j reversed); a
    // thread steps by SCAN_THREADS elements: dr rows and dj columns, with
    // the carry
    const int dr = SCAN_THREADS / L, dj = SCAN_THREADS - dr * L;
    {
        int r = tid / L, j = tid - (tid / L) * L;
        for (int e = tid; e < n; e += SCAN_THREADS) {
            cp_async<static_cast<int>(sizeof(T))>(
                sx + r * ls + (reverse ? L - 1 - j : j), xb + e);
            r += dr;
            j += dj;
            if (j >= L) {
                j -= L;
                ++r;
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int r = tid; r < nr; r += SCAN_THREADS) fold_run(sx + r * ls, L, 0.0);
    __syncthreads();
    int r = tid / L, j = tid - (tid / L) * L;
    for (int e = tid; e < n; e += SCAN_THREADS) {
        yb[e] = sx[r * ls + (reverse ? L - 1 - j : j)];
        r += dr;
        j += dj;
        if (j >= L) {
            j -= L;
            ++r;
        }
    }
}

// a + b and whether it was exact (TwoSum's error term is exactly 0; a
// NaN error, from inf or overflow, counts as inexact)
__device__ __forceinline__ double add_exact(double a, double b, bool &bad) {
    const double s = a + b;
    const double bb = s - a;
    const double err = (a - (s - bb)) + (b - bb);
    if (!(err == 0.0)) bad = true;
    return s;
}

// The long path: a CTA a row, in chunks of `chunk` elements (a multiple
// of LONG_THREADS) in scan order (right to left with `reverse`), each
// staged into shared memory, element e at pad(e).  counts (nullable):
// [chunks taken exact, chunks refolded].
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

template <typename T>
__global__ void __launch_bounds__(LONG_THREADS)
ordered_scan_long_kernel(const T *__restrict__ x, T *__restrict__ y,
                         long long L, int chunk, int reverse,
                         unsigned long long *__restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    // the chunk, padded; then the exact path's prefixes (T, padded) or the
    // refold's doubles (unpadded) in one region
    T *sx = reinterpret_cast<T *>(smem);
    double *sd = reinterpret_cast<double *>(
        smem + (static_cast<size_t>(pad(chunk) * sizeof(T)) + 15) / 16 * 16);
    T *sp = reinterpret_cast<T *>(sd);
    __shared__ double swarp[LONG_THREADS / 32];
    __shared__ double scarry;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int NW = LONG_THREADS / 32;
    const T *xr = x + static_cast<long long>(blockIdx.x) * L;
    T *yr = y + static_cast<long long>(blockIdx.x) * L;
    // scan position q <-> element phys(q)
    auto phys = [&](long long q) { return reverse ? L - 1 - q : q; };
    if (tid == 0) scarry = 0.0;
    for (long long q0 = 0; q0 < L; q0 += chunk) {
        const int n = static_cast<int>(min(static_cast<long long>(chunk),
                                           L - q0));
        for (int e = tid; e < n; e += LONG_THREADS) {
            cp_async<static_cast<int>(sizeof(T))>(sx + pad(e),
                                                  xr + phys(q0 + e));
        }
        cp_async_wait_all();
        __syncthreads();   // the chunk staged, scarry set
        const double carry = scarry;
        // (a) this thread's run of `per` elements: its total, every add
        // checked (thread 0 from the carry)
        const int per = (n + LONG_THREADS - 1) / LONG_THREADS;
        const int lo = min(tid * per, n), hi = min(lo + per, n);
        bool bad = false;
        double total = 0.0;
        if (lo < hi) {
            total = static_cast<double>(sx[pad(lo)]);
            if (tid == 0) total = add_exact(carry, total, bad);
            for (int e = lo + 1; e < hi; ++e) {
                total = add_exact(total, static_cast<double>(sx[pad(e)]),
                                  bad);
            }
        }
        // (b) the totals: an inclusive scan across the warp, then across
        // the warps, every add checked
        double incl = total;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const double yv = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl = add_exact(yv, incl, bad);
        }
        if (lane == 31) swarp[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            double winc = lane < NW ? swarp[lane] : 0.0;
#pragma unroll
            for (int d = 1; d < NW; d <<= 1) {
                const double yv = __shfl_up_sync(0xffffffffu, winc, d);
                if (lane >= d) winc = add_exact(yv, winc, bad);
            }
            __syncwarp();
            if (lane < NW) swarp[lane] = winc;   // inclusive by warp
        }
        __syncthreads();
        // (c) this thread's carry-in (the warps before it, then the
        // threads before it in its warp) and its run again from it, every
        // add checked; the prefixes kept aside, plus +0.0 (the
        // left-to-right fold never makes -0.0)
        const double wexcl = __shfl_up_sync(0xffffffffu, incl, 1);
        double run = carry;
        if (tid > 0) {
            run = warp > 0 ? swarp[warp - 1] : wexcl;
            if (warp > 0 && lane > 0) run = add_exact(run, wexcl, bad);
        }
        for (int e = lo; e < hi; ++e) {
            run = add_exact(run, static_cast<double>(sx[pad(e)]), bad);
            sp[pad(e)] = static_cast<T>(0.0 + run);
        }
        const bool any_bad = __syncthreads_or(bad);
        if (!any_bad) {
            if (lo < hi && hi == n) scarry = 0.0 + run;
        } else {
            // the chunk left to right in double by one thread, the
            // conversions shared by all
            for (int e = tid; e < n; e += LONG_THREADS) {
                sd[e] = static_cast<double>(sx[pad(e)]);
            }
            __syncthreads();
            if (tid == 0) scarry = fold_doubles(sd, n, carry);
            __syncthreads();
            for (int e = tid; e < n; e += LONG_THREADS) {
                sx[pad(e)] = static_cast<T>(sd[e]);
            }
        }
        if (counts && tid == 0) atomicAdd(counts + (any_bad ? 1 : 0), 1ull);
        __syncthreads();
        const T *res = any_bad ? sx : sp;
        for (int e = tid; e < n; e += LONG_THREADS) {
            yr[phys(q0 + e)] = res[pad(e)];
        }
        __syncthreads();   // the chunk stored before the next is staged
    }
}

inline unsigned blocks(long long n, long long per) {
    return static_cast<unsigned>((n + per - 1) / per);
}

// Raises `kernel`'s dynamic shared memory limit to `bytes` on the current
// device once (`done`: the bytes allowed so far, by device), so that a
// launch costs the host no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int *done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (static_cast<int>(bytes) <= done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e == cudaSuccess) done[dev] = static_cast<int>(bytes);
    return e;
}

template <typename T, int W>
int launch_segment_sum(const long long *seg, const long long *perm,
                       const T *v, T *out, long long P, int C, long long N,
                       int tile, int cw, int nb, int flat16,
                       cudaStream_t st) {
    const size_t smem = static_cast<size_t>(tile) * cw * sizeof(T) +
                        (static_cast<size_t>(tile) + 2) * 8 +
                        static_cast<size_t>(tile) * 8 +
                        static_cast<size_t>(tile) * 4;
    static int done[64] = {};
    const cudaError_t e = allow_smem(segment_sum_kernel<T, W>, smem, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(blocks(P, tile), nb);
    segment_sum_kernel<T, W><<<grid, SS_THREADS, smem, st>>>(
        seg, perm, v, out, P, C, N, tile, cw, flat16);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int segment_sum_typed(const long long *seg, const long long *perm,
                      const void *vp, void *op, long long P, int C,
                      long long N, cudaStream_t st) {
    const T *v = static_cast<const T *>(vp);
    T *out = static_cast<T *>(op);
    const auto addr = reinterpret_cast<uintptr_t>(v);
    // elements a copy: 16, 8 or 4 bytes, dividing C and v's alignment
    int w = 16 / static_cast<int>(sizeof(T));
    while (w > 1 && (C % w != 0 || addr % (w * sizeof(T)) != 0)) w /= 2;
    const int nb0 = (C + SS_COLS - 1) / SS_COLS;
    int cw = (C + nb0 - 1) / nb0;
    cw = (cw + w - 1) / w * w;
    const int nb = (C + cw - 1) / cw;
    // rows a tile: the most, 256-4,096, whose values fit SS_VALUE_BYTES
    int tile = SS_THREADS;
    while (tile < 4096 &&
           static_cast<long long>(tile) * 2 * cw * sizeof(T) <= SS_VALUE_BYTES) {
        tile *= 2;
    }
    const int flat16 = addr % 16 == 0;
    if constexpr (sizeof(T) == 4) {   // 16-byte copies: 4 floats, 2 doubles
        if (w == 4) {
            return launch_segment_sum<T, 4>(seg, perm, v, out, P, C, N, tile,
                                            cw, nb, flat16, st);
        }
    }
    if (w == 2) {
        return launch_segment_sum<T, 2>(seg, perm, v, out, P, C, N, tile, cw,
                                        nb, flat16, st);
    }
    return launch_segment_sum<T, 1>(seg, perm, v, out, P, C, N, tile, cw, nb,
                                    flat16, st);
}

// The scan's path for `rows` rows of L elements of T: the long path for
// rows longer than SCAN_ROWS_MAX_L when they are fewer than
// SCAN_LONG_MAX_ROWS or a row does not fit the rows path's staging.
template <typename T>
bool scan_long(long long rows, long long L) {
    const bool fits =
        (std::min<long long>(L, SCAN_ROWS_BYTES) | 1) * sizeof(T) <=
        static_cast<size_t>(SCAN_ROWS_BYTES);
    return L > SCAN_ROWS_MAX_L && (!fits || rows < SCAN_LONG_MAX_ROWS);
}

template <typename T>
int ordered_scan_typed(const void *xp, void *yp, long long rows, long long L,
                       int reverse, unsigned long long *counts,
                       cudaStream_t st) {
    const T *x = static_cast<const T *>(xp);
    T *y = static_cast<T *>(yp);
    if (scan_long<T>(rows, L)) {
        if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
        // a chunk: the row rounded up to the threads, at most 64 KB
        const int chunk = static_cast<int>(std::min<long long>(
            (L + LONG_THREADS - 1) / LONG_THREADS * LONG_THREADS,
            LONG_CHUNK_BYTES / static_cast<int>(sizeof(T))));
        const int padded = chunk + chunk / 32;
        const size_t smem =
            (static_cast<size_t>(padded) * sizeof(T) + 15) / 16 * 16 +
            static_cast<size_t>(padded) * 8;
        static int done_long[64] = {};
        const cudaError_t e =
            allow_smem(ordered_scan_long_kernel<T>, smem, done_long);
        if (e != cudaSuccess) return static_cast<int>(e);
        ordered_scan_long_kernel<T><<<static_cast<unsigned>(rows),
                                      LONG_THREADS, smem, st>>>(
            x, y, L, chunk, reverse, counts);
        return static_cast<int>(cudaGetLastError());
    }
    const int ls = static_cast<int>(L) | 1;
    // rows a CTA: enough CTAs for 4 an SM (in 32s), within what the
    // staging holds and at most 1,024
    static int sms[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (sms[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long spread = (rows + 4LL * sms[dev] - 1) / (4LL * sms[dev]);
    const int fits = SCAN_ROWS_BYTES / (ls * static_cast<int>(sizeof(T)));
    const int rb = std::max(
        1, static_cast<int>(std::min<long long>(
               {(spread + 31) / 32 * 32, static_cast<long long>(fits),
                1024LL})));
    const size_t smem = static_cast<size_t>(rb) * ls * sizeof(T);
    static int done_rows[64] = {};
    e = allow_smem(ordered_scan_rows_kernel<T>, smem, done_rows);
    if (e != cudaSuccess) return static_cast<int>(e);
    ordered_scan_rows_kernel<T><<<blocks(rows, rb), SCAN_THREADS, smem, st>>>(
        x, y, rows, static_cast<int>(L), rb, ls, reverse);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches S1 on `stream`: seg (P,) int64 ids with equal ids contiguous,
// perm (P,) int64 or null, v (P, C) and out (N, C) row-major, f32
// (f64 = 0) or f64 (f64 = 1).  Returns a cudaError_t (0 = ok).
int segment_sum_launch(const void *seg, const void *perm, const void *v,
                       void *out, long long P, int C, long long N, int f64,
                       void *stream) {
    if (P <= 0 || C <= 0 || N <= 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto *s = static_cast<const long long *>(seg);
    const auto *p = static_cast<const long long *>(perm);
    if (f64) return segment_sum_typed<double>(s, p, v, out, P, C, N, st);
    return segment_sum_typed<float>(s, p, v, out, P, C, N, st);
}

// 1 if the ordered scan of `rows` rows of L elements, f32 (f64 = 0) or
// f64 (f64 = 1), takes the long path, 0 if the rows path.
int ordered_scan_long(long long rows, long long L, int f64) {
    return f64 ? scan_long<double>(rows, L) : scan_long<float>(rows, L);
}

// Launches the ordered scan on `stream`: x and y (rows, L) row-major, f32
// (f64 = 0) or f64 (f64 = 1), right to left with `reverse`, on the path
// ordered_scan_long names.  counts (nullable, 2 x u64): the long path adds
// its chunks taken exact and refolded.  Returns a cudaError_t (0 = ok).
int ordered_scan_launch(const void *x, void *y, long long rows, long long L,
                        int f64, int reverse, void *counts, void *stream) {
    if (rows <= 0 || L <= 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    auto *c = static_cast<unsigned long long *>(counts);
    if (f64) {
        return ordered_scan_typed<double>(x, y, rows, L, reverse, c, st);
    }
    return ordered_scan_typed<float>(x, y, rows, L, reverse, c, st);
}

}  // extern "C"
