// Tensor-core leaf microbenchmark kernel for Hopper (sm_90a): K4 and K5.
//
// leaf_mma_kernel replaces the Pallas TPU kernels of tools_mxubench.py:
//   K4  make_loop_kernel (launched by `bench`): `iters` serialized
//       iterations of the product B^T a, (M,K)x(K,N) -> (M,N) f32, where
//       B is a (K,M) bf16 scratch zeroed once and a the (K,N) bf16 input;
//       with stores, each iteration first writes a[0:6, 0:128] into
//       B[ko+4:ko+10, c:c+128] for ko in (0,16,32), ko+10 <= K, and c in
//       range(0, min(M,512), 128).  Row 0 of every product is added to
//       the (1,N) f32 output.
//   K5  the quad-cluster leaf variants of bench_variants:
//       kA  256 iterations of 48 block stores into the (48,2048) scratch
//           (4 clusters x 3 arrangements of src / src4 / src3) and one
//           (2048,48,128) product;
//       kB  a (48, 1024*512) bf16 table, read at column (i%64)*2048 each
//           iteration: one product, no stores;
//       kC  a (32, 1024*512) table: the K=32 product against a[0:32] plus
//           the K=16 product of the slice's first 16 rows against
//           a[32:48].
// One launch runs one of them on ONE block, as the TPU ran grid=(1,) on
// one core; the host builds the variant's LeafParams (mxubench.py).
//
// The product is the kernel's own tensor-core code: mma.sync m16n8k16
// bf16 x bf16 -> f32, operands read from shared memory with ldmatrix.
// Both operands are stored contraction-major, B as (K,M) and a as (K,N),
// while the mma wants A (= B^T) with K pairs per register along its rows
// and its B operand with K pairs along its columns: each 8x8 matrix is
// therefore loaded with ldmatrix's .trans form, for both operands.  Each
// of the 8 warps takes (16-row, 64-column) tiles of the product in turn
// and runs the K/16 steps of each tile (kC: three steps, the third
// pairing the slice's rows 0-15 with a's rows 32-47).
//
// Keeping the product whole.  The TPU kept only row 0, and a compiler
// deletes every other tile of a product nobody reads.  So the kernel also
// returns a checksum: the sum over iterations of every element of every
// product (each thread sums its tile's 32 accumulators in f32 and adds
// that into an f64 total, so the all-ones inputs of the tool give an
// exact integer).  Operands are re-read from shared memory every
// iteration (ldmatrix with a memory clobber) and each iteration ends in
// __syncthreads(), as the TPU's serial chain did, so nothing is hoisted
// out of the loop: chip_smoke.py checks that the time per product grows
// with M*N across the tool's shapes.  A debugging pointer, when given,
// receives the last iteration's full (M,N) product.
//
// Design for this card.  B (up to 48 x 2048 bf16 = 192 KiB) and a live in
// dynamic shared memory (above 48 KB only after cudaFuncSetAttribute),
// rows padded by 16 bytes so the 8 row addresses of an ldmatrix fall in
// distinct banks.  The TPU held kB's 48 MiB and kC's 32 MiB tables in
// VMEM; no SM holds them, so they stay in device memory, where the 64
// slices touched (12 MiB and 8 MiB) stay in the 50 MB L2, and each
// iteration stages its (48,2048) or (32,2048) slice into shared memory
// with cp.async before multiplying.
//
// Bound.  2*M*K*N operations per product at the card's dense bf16
// tensor-core peak (989 TFLOP/s).  One block reaches at most one SM's
// share of it (7.49 TFLOP/s, reported beside the bound), and mma.sync
// only part of that (wgmma is the route to all of it); the rows of a
// product are independent, so splitting M over blocks is the route to
// the card.  A simple kernel that is right comes first: one block, no
// double buffering of the table slices, no wgmma, no reuse of a's
// fragments across row tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NCHUNK = 64;      // product columns per warp tile (8 mma tiles)
constexpr int PAD = 8;          // bf16 of padding per shared row (16 bytes)
constexpr int MAX_KSTEPS = 8;
constexpr int MAX_STORES = 48;
constexpr int SMEM_LIMIT = 232448;

}  // namespace

// The launch parameters (mirrored by ctypes in tools/mxubench.py).
struct LeafParams {
    long long tbl_ld;            // table row stride in elements (table mode)
    int M, N;                    // product rows and columns
    int kb_rows, ka_rows;        // rows of B and of a held in shared memory
    int iters;                   // serialized iterations
    int nk;                      // 16-deep k steps per product
    int kstep_b[MAX_KSTEPS];     // B's 16-row block of each k step
    int kstep_a[MAX_KSTEPS];     // a's 16-row block of each k step
    int n_stores;                // block stores per iteration
    int st_row[MAX_STORES];      // first B row of each store
    int st_col[MAX_STORES];      // first B column (128 columns are stored)
    int st_rows[MAX_STORES];     // rows stored: a[0:st_rows, 0:128]
    int table;                   // 1: stage B from the table every iteration
    int tbl_period, tbl_step;    // table column = (i % period) * step
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t &r0,
                                              uint32_t &r1, uint32_t &r2,
                                              uint32_t &r3) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
        : "r"(addr)
        : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
leaf_mma_kernel(const uint16_t *__restrict__ a, const uint16_t *__restrict__ tbl,
                float *__restrict__ row_out, double *__restrict__ checksum_out,
                float *__restrict__ full_out, const LeafParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int M = p.M, N = p.N;
    const int ldb = M + PAD, lda = N + PAD;
    uint16_t *B_s = reinterpret_cast<uint16_t *>(smem);
    uint16_t *a_s = B_s + p.kb_rows * ldb;
    float *out_s = reinterpret_cast<float *>(a_s + p.ka_rows * lda);
    double *red_s = reinterpret_cast<double *>(out_s + N);
    int *ks_s = reinterpret_cast<int *>(red_s + WARPS);   // kstep_b, kstep_a
    int *st_s = ks_s + 2 * MAX_KSTEPS;                     // row, col, rows

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;   // mma group and thread in it

    // ---- set-up: parameters, a, the zeroed scratch, the row sums ----
    if (tid < MAX_KSTEPS) {
        ks_s[tid] = p.kstep_b[tid];
        ks_s[MAX_KSTEPS + tid] = p.kstep_a[tid];
    }
    if (tid < MAX_STORES) {
        st_s[tid] = p.st_row[tid];
        st_s[MAX_STORES + tid] = p.st_col[tid];
        st_s[2 * MAX_STORES + tid] = p.st_rows[tid];
    }
    const int a_chunks = N / 8;   // 16-byte chunks per row of a
    for (int i = tid; i < p.ka_rows * a_chunks; i += THREADS) {
        const int r = i / a_chunks, c = i % a_chunks;
        *reinterpret_cast<uint4 *>(a_s + r * lda + c * 8) =
            *reinterpret_cast<const uint4 *>(a + (size_t)r * N + c * 8);
    }
    const int b_chunks = M / 8;
    if (!p.table) {   // the scratch: zeros, or the initial value in tbl
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        for (int i = tid; i < p.kb_rows * b_chunks; i += THREADS) {
            const int r = i / b_chunks, c = i % b_chunks;
            *reinterpret_cast<uint4 *>(B_s + r * ldb + c * 8) =
                tbl ? *reinterpret_cast<const uint4 *>(tbl + (size_t)r * M +
                                                       c * 8)
                    : z;
        }
    }
    for (int i = tid; i < N; i += THREADS) out_s[i] = 0.0f;
    __syncthreads();

    const int n_nc = N / NCHUNK;
    const int n_items = (M / 16) * n_nc;
    double cs = 0.0;

    for (int it = 0; it < p.iters; ++it) {
        // ---- the store chain (K4 with stores, kA) ----
        if (p.n_stores) {
            for (int s = 0; s < p.n_stores; ++s) {
                const int rows = st_s[2 * MAX_STORES + s];
                const int r0 = st_s[s], c0 = st_s[MAX_STORES + s];
                for (int i = tid; i < rows * 16; i += THREADS) {
                    const int r = i >> 4, c = (i & 15) * 8;
                    *reinterpret_cast<uint4 *>(B_s + (r0 + r) * ldb + c0 + c) =
                        *reinterpret_cast<const uint4 *>(a_s + r * lda + c);
                }
            }
            __syncthreads();
        }
        // ---- the table slice of this iteration (kB, kC) ----
        if (p.table) {
            const long long col = (long long)(it % p.tbl_period) * p.tbl_step;
            for (int i = tid; i < p.kb_rows * b_chunks; i += THREADS) {
                const int r = i / b_chunks, c = i % b_chunks;
                cp_async16(smem_addr(B_s + r * ldb + c * 8),
                           tbl + (size_t)r * p.tbl_ld + col + c * 8);
            }
            cp_async_wait_all();
            __syncthreads();
        }
        // ---- the whole (M,N) product, tile by tile ----
        const bool last = (it == p.iters - 1) && full_out != nullptr;
        for (int item = warp; item < n_items; item += WARPS) {
            const int mt = item / n_nc, nc = item % n_nc;
            float acc[8][4];
#pragma unroll
            for (int t = 0; t < 8; ++t)
                acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
            const int q = lane >> 3, r = lane & 7;
            for (int j = 0; j < p.nk; ++j) {
                const int kb = ks_s[j] * 16, ka = ks_s[MAX_KSTEPS + j] * 16;
                // A = B^T: matrix q holds m rows (q&1)*8.., k cols (q>>1)*8..
                uint32_t a0, a1, a2, a3;
                ldsm_x4_trans(smem_addr(B_s + (kb + (q >> 1) * 8 + r) * ldb +
                                        mt * 16 + (q & 1) * 8),
                              a0, a1, a2, a3);
#pragma unroll
                for (int t = 0; t < 8; t += 2) {
                    // matrices: (k 0-7, tile t), (k 8-15, tile t),
                    // (k 0-7, tile t+1), (k 8-15, tile t+1)
                    uint32_t b0, b1, b2, b3;
                    ldsm_x4_trans(smem_addr(a_s + (ka + (q & 1) * 8 + r) * lda +
                                            nc * NCHUNK + (t + (q >> 1)) * 8),
                                  b0, b1, b2, b3);
                    mma_bf16(acc[t], a0, a1, a2, a3, b0, b1);
                    mma_bf16(acc[t + 1], a0, a1, a2, a3, b2, b3);
                }
            }
            float part = 0.0f;
#pragma unroll
            for (int t = 0; t < 8; ++t)
                part += (acc[t][0] + acc[t][1]) + (acc[t][2] + acc[t][3]);
            cs += static_cast<double>(part);
            const int n_base = nc * NCHUNK + 2 * tig;
            if (mt == 0 && g == 0) {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    out_s[n_base + t * 8] += acc[t][0];
                    out_s[n_base + t * 8 + 1] += acc[t][1];
                }
            }
            if (last) {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    float *row0 = full_out + (size_t)(mt * 16 + g) * N +
                                  n_base + t * 8;
                    float *row8 = row0 + (size_t)8 * N;
                    row0[0] = acc[t][0];
                    row0[1] = acc[t][1];
                    row8[0] = acc[t][2];
                    row8[1] = acc[t][3];
                }
            }
        }
        __syncthreads();
    }

    // ---- outputs: row 0 sums and the checksum ----
    for (int i = tid; i < N; i += THREADS) row_out[i] = out_s[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cs += __shfl_down_sync(0xffffffffu, cs, o);
    if (lane == 0) red_s[warp] = cs;
    __syncthreads();
    if (tid == 0) {
        double tot = 0.0;
        for (int w = 0; w < WARPS; ++w) tot += red_s[w];
        checksum_out[0] = tot;
    }
}

int smem_bytes(const LeafParams &p) {
    return (p.kb_rows * (p.M + PAD) + p.ka_rows * (p.N + PAD)) * 2 +
           p.N * 4 + WARPS * 8 + (2 * MAX_KSTEPS + 3 * MAX_STORES) * 4;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one launch with these parameters takes.
int leaf_mma_smem_bytes(const LeafParams *p) { return smem_bytes(*p); }

// Launches one block of leaf_mma_kernel on `stream`.  a (ka_rows, N) bf16;
// tbl the (kb_rows, tbl_ld) bf16 table, or without table mode the
// scratch's initial (kb_rows, M) value (a test input: the TPU kernels
// zero it), or null; row_out (N,) f32;
// checksum_out (1,) f64; full_out (M, N) f32 or null.  Returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for parameters
// the kernel does not take.
int leaf_mma_launch(const void *a, const void *tbl, void *row_out,
                    void *checksum_out, void *full_out, const LeafParams *p,
                    void *stream) {
    const LeafParams &q = *p;
    bool ok = q.M > 0 && q.M % 16 == 0 && q.N > 0 && q.N % NCHUNK == 0 &&
              q.nk > 0 && q.nk <= MAX_KSTEPS && q.iters > 0 &&
              q.n_stores >= 0 && q.n_stores <= MAX_STORES &&
              (q.table == 0 || (tbl != nullptr && q.tbl_period > 0)) &&
              (q.n_stores == 0 || q.N >= 128);
    for (int j = 0; ok && j < q.nk; ++j)
        ok = q.kstep_b[j] >= 0 && (q.kstep_b[j] + 1) * 16 <= q.kb_rows &&
             q.kstep_a[j] >= 0 && (q.kstep_a[j] + 1) * 16 <= q.ka_rows;
    for (int s = 0; ok && s < q.n_stores; ++s)
        ok = q.st_rows[s] > 0 && q.st_rows[s] <= q.ka_rows &&
             q.st_row[s] >= 0 && q.st_row[s] + q.st_rows[s] <= q.kb_rows &&
             q.st_col[s] >= 0 && q.st_col[s] % 8 == 0 &&
             q.st_col[s] + 128 <= q.M;
    const int smem = smem_bytes(q);
    if (!ok || smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        leaf_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    leaf_mma_kernel<<<1, THREADS, smem, s>>>(
        static_cast<const uint16_t *>(a), static_cast<const uint16_t *>(tbl),
        static_cast<float *>(row_out), static_cast<double *>(checksum_out),
        static_cast<float *>(full_out), q);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
