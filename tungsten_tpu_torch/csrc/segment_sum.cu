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
// from the value out holds, with exactly one writer per output element:
// the thread of the segment's first row (its head) and column.  The
// other threads read two ids and leave.  `perm` (P,), when given, is the
// row of v that sorted row r reads (v[perm[r]]), so the caller's stable
// sort is applied on the fly and v is never gathered into a copy.  A
// head walks its segment U rows at a time: the U ids, the U perm entries
// and the U values are loaded before any is added, so a long segment (a
// photon gather's row has up to 27 * 48 candidates) waits on memory once
// per U rows, not once a row; the adds stay in row order.  (One thread a
// row carrying every column measured slower on the photon gathers, whose
// long segments then lose the columns' parallelism, and on the f64 tile
// sums.)  Ids outside [0, N) are skipped.  Empty segments write nothing.
//
// ordered_scan_kernel: the inclusive sum along the last axis of a
// row-major (rows, L) array, one thread a row, each row added left to
// right in double (the CPU's float cumsum accumulates in double too,
// aten cpu_cum_base_kernel), each output rounded once to the input type.
// PyTorch's CUDA cumsum of a 1-D float tensor is a decoupled look-back
// scan whose association depends on timing.
//
// What bounds them.  Both move bytes and do one add a byte-group: S1
// reads the ids, perm and values once and writes the touched output
// rows once (a bank of 1,048,576 rows x 3 f32 with 8-byte ids and perm
// is about 29 MB, 9 us at 3.35 TB/s).  The simple design leaves most
// threads of a warp idle (one head in 16 rows on the smoke bank) and a
// head's loads uncoalesced across the warp; the bank is one launch a
// stage, so this costs microseconds against a render of about a second.
// A segment of hundreds of thousands of rows (a gather's backward onto a
// few table rows) is one thread's serial walk: the wrapper splits such
// sums into runs first (ops/segment_sum.py, `block`).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;   // rows a head loads before it adds them

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const long long *__restrict__ seg,
                   const long long *__restrict__ perm,
                   const T *__restrict__ v, T *__restrict__ out,
                   long long P, int C, long long N) {
    const long long i =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= P * C) return;
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    const long long s = seg[r];
    if (r > 0 && seg[r - 1] == s) return;   // not the segment's head
    if (s < 0 || s >= N) return;
    T acc = out[s * C + c];
    bool more = true;
    for (long long j = r; more; j += U) {
        long long sk[U];
        T vk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long k = j + u;
            sk[u] = k < P ? seg[k] : s + 1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long k = j + u;
            const long long row = sk[u] == s ? (perm ? perm[k] : k) : -1;
            vk[u] = row >= 0 ? v[row * C + c] : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (more && sk[u] == s) {
                acc = acc + vk[u];
            } else {
                more = false;
            }
        }
    }
    out[s * C + c] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ordered_scan_kernel(const T *__restrict__ x, T *__restrict__ y,
                    long long rows, long long L) {
    const long long row =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (row >= rows) return;
    const T *xr = x + row * L;
    T *yr = y + row * L;
    double acc = 0.0;
    for (long long j = 0; j < L; ++j) {
        acc += static_cast<double>(xr[j]);
        yr[j] = static_cast<T>(acc);
    }
}

inline unsigned blocks_for(long long n) {
    return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// Launches S1 on `stream`: seg (P,) int64 ids with equal ids contiguous,
// perm (P,) int64 or null, v (P, C) and out (N, C) row-major, f32
// (f64 = 0) or f64 (f64 = 1).  Returns cudaGetLastError() (0 = ok).
int segment_sum_launch(const void *seg, const void *perm, const void *v,
                       void *out, long long P, int C, long long N, int f64,
                       void *stream) {
    if (P <= 0 || C <= 0 || N <= 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto *s = static_cast<const long long *>(seg);
    const auto *p = static_cast<const long long *>(perm);
    if (f64) {
        segment_sum_kernel<double><<<blocks_for(P * C), THREADS, 0, st>>>(
            s, p, static_cast<const double *>(v), static_cast<double *>(out),
            P, C, N);
    } else {
        segment_sum_kernel<float><<<blocks_for(P * C), THREADS, 0, st>>>(
            s, p, static_cast<const float *>(v), static_cast<float *>(out),
            P, C, N);
    }
    return static_cast<int>(cudaGetLastError());
}

// Launches the ordered scan on `stream`: x and y (rows, L) row-major, f32
// (f64 = 0) or f64 (f64 = 1).  Returns cudaGetLastError() (0 = ok).
int ordered_scan_launch(const void *x, void *y, long long rows, long long L,
                        int f64, void *stream) {
    if (rows <= 0 || L <= 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (f64) {
        ordered_scan_kernel<double><<<blocks_for(rows), THREADS, 0, st>>>(
            static_cast<const double *>(x), static_cast<double *>(y), rows,
            L);
    } else {
        ordered_scan_kernel<float><<<blocks_for(rows), THREADS, 0, st>>>(
            static_cast<const float *>(x), static_cast<float *>(y), rows, L);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
