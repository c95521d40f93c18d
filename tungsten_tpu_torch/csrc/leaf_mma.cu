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
// The host builds the variant's LeafParams (tools/mxubench.py).
//
// The whole card.  The TPU ran grid=(1,) on a v5e, whose one TensorCore
// is the whole chip; here the counterpart is all 132 SMs.  The rows of a
// product are independent, so the (M,N) product is cut into 64x64 tiles
// (M/64 x N/64 of them: 4 at (128,48,128), 64 at (2048,48,128)) and each
// block owns one tile for all iterations, which stay serialized inside
// the block as the TPU's chain was.  A block applies only the pieces of
// the store chain that land in its own 64 columns of B (B's columns are
// the product's rows; the host splits the chain, `split_stores`, and the
// block reads its tile's pieces into shared memory once), stages
// only its own 64 columns of each table slice, and the block that owns
// row 0 writes it.  LeafParams.blocks caps the grid (one block then
// walks the tiles in order, each through all iterations: the same
// arithmetic in the same order, so the results are bitwise the full
// grid's); chip_smoke.py's anti-hoisting check times that launch.
//
// The product: wgmma.mma_async m64n64k16, bf16 x bf16 -> f32, one
// warpgroup (128 threads) a block, both operands read from shared memory
// through descriptors.  B is stored (K,M) and a (K,N): both are MN-major,
// which wgmma takes for 16-bit types through its transpose immediates,
// so nothing is re-laid out.  Each operand tile is K rows of 64 bf16 (128
// bytes) in the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), 1024-byte aligned: one swizzle atom spans the whole
// 64-wide tile, and a 16-deep k step starts 2048 bytes further on.  kC's
// third step (slice rows 0-15 against a rows 32-47) is one more
// descriptor pair.  One wgmma group is committed and waited per
// iteration; row 0 and the checksum are read from the accumulators.
//
// Hazards.  The store chain and the staging write shared memory through
// the generic proxy, wgmma reads it through the async proxy: in every
// iteration that writes (and the first), each thread runs
// fence.proxy.async.shared::cta before the barrier that precedes
// wgmma.fence, and a barrier at the top keeps the writes behind the last
// iteration's wgmma.  An iteration that only multiplies (K4 without
// stores) needs neither.  The chain's 16-byte stores and the staging
// apply the descriptors' swizzle.
//
// Table mode (kB, kC).  The tables stay in device memory (48 / 32 MiB;
// the 64 slices touched, 12 / 8 MiB, sit in the 50 MB L2).  Each block
// double-buffers its (rows x 64) sub-slice: iteration i+1's comes in by
// cp.async while iteration i multiplies.
//
// Keeping the product whole.  The TPU kept only row 0, and a compiler
// deletes every tile of a product nobody reads.  So the kernel also
// returns a checksum: the sum over iterations of every element of every
// product (each thread sums its 32 accumulators in f32 and adds that
// into an f64 total, so the all-ones inputs of the tool give an exact
// integer).  Each block reduces its tile's total in a fixed order into
// one f64 partial per tile, and a second one-thread kernel sums the
// partials in tile order: no f64 atomics, so runs are repeatable.  The
// operands are read through asm volatile wgmma with a memory clobber
// every iteration, so nothing is hoisted out of the loop.  A debugging
// pointer, when given, receives the last iteration's full (M,N) product.
//
// Bound.  2*M*K*N operations per product at the card's dense bf16
// tensor-core peak (989 TFLOP/s); the grid occupies M*N/4096 SMs, whose
// share of that peak is reported beside it.  At these sizes a product is
// a few wgmma of ~20 ns each per SM, so the per-iteration latency of the
// serialized chain (barriers, fences, commit and wait, the epilogue)
// holds the kernel, not the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // one warpgroup
constexpr int TILE = 64;              // product rows and columns a block
constexpr int ROW_BYTES = TILE * 2;   // one 64-wide bf16 row
constexpr int KSTEP_BYTES = 16 * ROW_BYTES;
constexpr int MAX_KSTEPS = 8;
constexpr int MAX_PIECES = 128;
constexpr int MAX_MTILES = 32;
constexpr int SMEM_LIMIT = 232448;

}  // namespace

// The launch parameters (mirrored by ctypes in tools/mxubench.py).
struct LeafParams {
    long long tbl_ld;            // table row stride in elements (table mode)
    int M, N;                    // product rows and columns
    int kb_rows, ka_rows;        // rows of B and of a
    int iters;                   // serialized iterations
    int nk;                      // 16-deep k steps per product
    int kstep_b[MAX_KSTEPS];     // B's 16-row block of each k step
    int kstep_a[MAX_KSTEPS];     // a's 16-row block of each k step
    // the store chain split over 64-column tiles of B: piece i writes
    // a[0:pc_rows, pc_src:pc_src+pc_width] into B[pc_row:pc_row+pc_rows,
    // pc_col:pc_col+pc_width]; tile mt's pieces are
    // [tile_piece[mt], tile_piece[mt+1])
    int n_pieces;
    int pc_row[MAX_PIECES], pc_rows[MAX_PIECES], pc_col[MAX_PIECES];
    int pc_src[MAX_PIECES], pc_width[MAX_PIECES];
    int tile_piece[MAX_MTILES + 1];
    int src_rows;                // rows of a the pieces read
    int table;                   // 1: stage B from the table every iteration
    int tbl_period, tbl_step;    // table column = (i % period) * step
    int blocks;                  // grid cap (0: one block a tile)
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
    return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor: 128-byte swizzle, both byte offsets
// 1024 (the next 8-row atom; a 64-wide MN-major tile is one atom wide)
__device__ __forceinline__ uint64_t desc(const void *p) {
    const uint64_t a = (smem_addr(p) & 0x3FFFF) >> 4;
    return a | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
           (uint64_t(1) << 62);
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n"
                 "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D(64x64, f32) = A(64x16) B(16x64) + (accumulate ? D : 0), A and B
// MN-major bf16 in shared memory
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
}

// rows x 64 bf16 at src (row stride ld elements) into a swizzled tile
__device__ __forceinline__ void stage_async(unsigned char *dst,
                                            const uint16_t *src, long long ld,
                                            int rows) {
    for (int i = threadIdx.x; i < rows * 8; i += THREADS) {
        const int r = i >> 3, c = i & 7;
        cp_async16(dst + swz(r, c), src + r * ld + c * 8);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
leaf_mma_kernel(const uint16_t *__restrict__ a,
                const uint16_t *__restrict__ tbl,
                float *__restrict__ row_out, double *__restrict__ partial,
                float *__restrict__ full_out,
                const __grid_constant__ LeafParams p) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char *smem =
        smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const int M = p.M, N = p.N;
    const int b_bytes = p.kb_rows * ROW_BYTES;
    // B's buffers: two in table mode (the next slice lands in the other)
    unsigned char *const B0 = smem;
    unsigned char *const B1 = smem + (p.table ? b_bytes : 0);
    unsigned char *A_s = smem + (p.table ? 2 : 1) * b_bytes;
    uint16_t *src_s = reinterpret_cast<uint16_t *>(A_s + p.ka_rows *
                                                   ROW_BYTES);
    double *red = reinterpret_cast<double *>(src_s + p.src_rows * N);
    // this tile's store pieces: B row, rows, first 16-byte chunk in the
    // tile, a's first column, chunks a row
    int *pc_s = reinterpret_cast<int *>(red + 4);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_nt = N / TILE, n_tiles = (M / TILE) * n_nt;

    // a's rows the store pieces read, once: a is invariant
    for (int i = tid; i < p.src_rows * (N / 8); i += THREADS)
        reinterpret_cast<uint4 *>(src_s)[i] =
            reinterpret_cast<const uint4 *>(a)[i];

    float d[32];   // the accumulators
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int mt = tile / n_nt, m0 = mt * TILE, n0 = (tile % n_nt) * TILE;
        __syncthreads();   // the previous tile's reads are over
        for (int i = tid; i < p.ka_rows * 8; i += THREADS) {
            const int r = i >> 3, c = i & 7;
            *reinterpret_cast<uint4 *>(A_s + swz(r, c)) =
                *reinterpret_cast<const uint4 *>(a + (size_t)r * N + n0 +
                                                 c * 8);
        }
        if (p.table) {   // iteration 0's sub-slice
            stage_async(B0, tbl + m0, p.tbl_ld, p.kb_rows);
            cp_async_commit();
        } else {         // the scratch: zeros, or the initial value in tbl
            for (int i = tid; i < p.kb_rows * 8; i += THREADS) {
                const int r = i >> 3, c = i & 7;
                *reinterpret_cast<uint4 *>(B0 + swz(r, c)) =
                    tbl ? *reinterpret_cast<const uint4 *>(
                              tbl + (size_t)r * M + m0 + c * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
            }
        }
        const int pc0 = p.tile_piece[mt], n_pc = p.tile_piece[mt + 1] - pc0;
        for (int i = tid; i < n_pc; i += THREADS) {
            const int pc = pc0 + i;
            pc_s[5 * i] = p.pc_row[pc];
            pc_s[5 * i + 1] = p.pc_rows[pc];
            pc_s[5 * i + 2] = (p.pc_col[pc] - m0) >> 3;
            pc_s[5 * i + 3] = p.pc_src[pc];
            pc_s[5 * i + 4] = p.pc_width[pc] >> 3;
        }
        // an iteration that writes shared memory (stores, staging) is
        // fenced and barriered; one that only multiplies needs neither
        const bool writes = p.table || n_pc > 0;
        float rsum[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) rsum[j] = 0.0f;
        double cs = 0.0;

        for (int it = 0; it < p.iters; ++it) {
            unsigned char *const Bc = (it & 1) ? B1 : B0;
            const bool sync = writes || it == 0;
            if (sync) __syncthreads();   // set-up written; last wgmma done
            const bool more = p.table && it + 1 < p.iters;
            if (more) {   // the next sub-slice, into the other buffer
                const long long col =
                    (long long)((it + 1) % p.tbl_period) * p.tbl_step;
                stage_async((it & 1) ? B0 : B1, tbl + col + m0, p.tbl_ld,
                            p.kb_rows);
                cp_async_commit();
            }
            // the store chain's pieces in this tile's columns
            for (int pc = 0; pc < n_pc; ++pc) {
                const int *q5 = pc_s + 5 * pc;
                const int row0 = q5[0], c0 = q5[2], w8 = q5[4];
                const uint16_t *s = src_s + q5[3];
                for (int i = tid; i < q5[1] * w8; i += THREADS) {
                    const int r = i / w8, q = i % w8;
                    *reinterpret_cast<uint4 *>(Bc + swz(row0 + r, c0 + q)) =
                        *reinterpret_cast<const uint4 *>(s + r * N + q * 8);
                }
            }
            if (p.table) {
                if (more) cp_async_wait<1>();
                else cp_async_wait<0>();
            }
            if (sync) {
                fence_proxy_async();
                __syncthreads();
            }

            wgmma_fence();
            for (int j = 0; j < p.nk; ++j)   // the first step overwrites d
                wgmma_64x64x16(d, desc(Bc + p.kstep_b[j] * KSTEP_BYTES),
                               desc(A_s + p.kstep_a[j] * KSTEP_BYTES), j);
            wgmma_commit_wait();

            // accumulator j*4+e: row 16*warp + lane/4 (+8 for e >= 2),
            // column 8*j + 2*(lane%4) + (e&1)
            float part = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                part += (d[4 * j] + d[4 * j + 1]) + (d[4 * j + 2] +
                                                     d[4 * j + 3]);
            cs += static_cast<double>(part);
            if (mt == 0 && warp == 0 && lane < 4) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    rsum[2 * j] += d[4 * j];
                    rsum[2 * j + 1] += d[4 * j + 1];
                }
            }
            if (full_out != nullptr && it == p.iters - 1) {
                const int r = m0 + 16 * warp + (lane >> 2);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int c = n0 + 8 * j + 2 * (lane & 3);
                    *reinterpret_cast<float2 *>(full_out + (size_t)r * N + c) =
                        make_float2(d[4 * j], d[4 * j + 1]);
                    *reinterpret_cast<float2 *>(full_out +
                                                (size_t)(r + 8) * N + c) =
                        make_float2(d[4 * j + 2], d[4 * j + 3]);
                }
            }
        }

        // ---- this tile's row 0 and its checksum partial ----
        if (mt == 0 && warp == 0 && lane < 4) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<float2 *>(row_out + n0 + 8 * j + 2 * lane) =
                    make_float2(rsum[2 * j], rsum[2 * j + 1]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            cs += __shfl_down_sync(0xffffffffu, cs, o);
        if (lane == 0) red[warp] = cs;
        __syncthreads();
        if (tid == 0) partial[tile] = ((red[0] + red[1]) + red[2]) + red[3];
    }
}

// the checksum: the tiles' partials summed in tile order
__global__ void leaf_sum_kernel(const double *__restrict__ partial, int n,
                                double *__restrict__ out) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += partial[i];
    *out = s;
}

int smem_bytes(const LeafParams &p) {
    return 1024 + ((p.table ? 2 : 1) * p.kb_rows + p.ka_rows) * ROW_BYTES +
           p.src_rows * p.N * 2 + 4 * 8 + MAX_PIECES * 5 * 4;
}

bool params_ok(const LeafParams &q, const void *tbl) {
    bool ok = q.M > 0 && q.M % TILE == 0 && q.M / TILE <= MAX_MTILES &&
              q.N > 0 && q.N % TILE == 0 && q.nk > 0 &&
              q.nk <= MAX_KSTEPS && q.iters > 0 && q.kb_rows % 8 == 0 &&
              q.ka_rows % 8 == 0 && q.blocks >= 0 && q.n_pieces >= 0 &&
              q.n_pieces <= MAX_PIECES && q.src_rows >= 0 &&
              q.src_rows <= q.ka_rows &&
              (q.table == 0 || (tbl != nullptr && q.tbl_period > 0 &&
                                q.tbl_ld % 8 == 0 && q.tbl_step % 8 == 0));
    for (int j = 0; ok && j < q.nk; ++j)
        ok = q.kstep_b[j] >= 0 && (q.kstep_b[j] + 1) * 16 <= q.kb_rows &&
             q.kstep_a[j] >= 0 && (q.kstep_a[j] + 1) * 16 <= q.ka_rows;
    const int n_mt = q.M / TILE;
    for (int mt = 0; ok && mt < n_mt; ++mt) {
        const int lo = q.tile_piece[mt], hi = q.tile_piece[mt + 1];
        ok = lo >= 0 && lo <= hi && hi <= q.n_pieces;
        for (int i = lo; ok && i < hi; ++i)
            ok = q.pc_rows[i] > 0 && q.pc_rows[i] <= q.src_rows &&
                 q.pc_row[i] >= 0 && q.pc_row[i] + q.pc_rows[i] <= q.kb_rows &&
                 q.pc_width[i] > 0 && q.pc_width[i] % 8 == 0 &&
                 q.pc_col[i] % 8 == 0 && q.pc_col[i] >= mt * TILE &&
                 q.pc_col[i] + q.pc_width[i] <= (mt + 1) * TILE &&
                 q.pc_src[i] >= 0 && q.pc_src[i] % 8 == 0 &&
                 q.pc_src[i] + q.pc_width[i] <= q.N;
    }
    return ok && (n_mt == 0 || q.tile_piece[0] == 0) &&
           q.tile_piece[n_mt] == q.n_pieces;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block with these parameters takes.
int leaf_mma_smem_bytes(const LeafParams *p) { return smem_bytes(*p); }

// Launches leaf_mma_kernel (min(blocks, tiles) blocks, all tiles when
// blocks is 0) and the checksum's sum on `stream`.  a (ka_rows, N) bf16;
// tbl the (kb_rows, tbl_ld) bf16 table, or without table mode the
// scratch's initial (kb_rows, M) value (a test input: the TPU kernels
// zero it), or null; row_out (N,) f32; partial (M/64 * N/64,) f64
// scratch; checksum_out (1,) f64; full_out (M, N) f32 or null.  Returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for parameters
// the kernel does not take.
int leaf_mma_launch(const void *a, const void *tbl, void *row_out,
                    void *partial, void *checksum_out, void *full_out,
                    const LeafParams *p, void *stream) {
    const LeafParams &q = *p;
    const int smem = smem_bytes(q);
    if (!params_ok(q, tbl) || smem > SMEM_LIMIT)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        leaf_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int tiles = (q.M / TILE) * (q.N / TILE);
    const int grid = q.blocks > 0 && q.blocks < tiles ? q.blocks : tiles;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    leaf_mma_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const uint16_t *>(a), static_cast<const uint16_t *>(tbl),
        static_cast<float *>(row_out), static_cast<double *>(partial),
        static_cast<float *>(full_out), q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    leaf_sum_kernel<<<1, 1, 0, s>>>(static_cast<const double *>(partial),
                                    tiles, static_cast<double *>(checksum_out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
