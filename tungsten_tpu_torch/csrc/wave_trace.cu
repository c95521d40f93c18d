// Wave traversal kernels for Hopper (sm_90a): resident and paged walks,
// each in closest-hit and any-hit mode.
//
// wave_trace_kernel replaces tungsten_tpu/ops/wave_trace.py::_make_kernel
// (the Pallas TPU kernel launched by wave_intersect), any_hit False and
// True.  wave_trace_paged_closest_kernel and wave_trace_paged_anyhit_kernel
// replace ::_make_kernel_paged (launched by wave_intersect_paged) in
// closest-hit and any-hit mode.  They read the same tables
// (build_wave_tables) and the same per-warp super lists (the fronts
// _cull_sorted_supers and _cull_paged) and return what the TPU kernels
// return: per ray the winning t and cluster*128+slot (closest hit), or
// t = -3e38 with tri >= 0 on an occluded segment (any hit).
//
// Design (K1, K2, K3 any hit).  One CUDA block is one 128-ray warp of
// the TPU kernels, one thread per ray.  Per super each thread slab-tests
// the 16 member clusters (the 1.00000024 fudge and the live / tmin /
// best-t rules of slab16); the block ORs the survivor bits.  Each
// surviving cluster's 16 x 128 f32 attribute rows (8 KB) are staged in
// shared memory, transposed so that one triangle is 16 contiguous floats
// (four broadcast float4 loads), and every live thread evaluates det, u*det,
// v*det and t*det for the 128 triangles as f32 FMA chains — the
// quantities the TPU computed with a K=48 bf16 hi/lo matmul, here
// straight in f32.  Acceptance is the TPU's: u, v >= 0, u + v <= det,
// tmin < t < best t, det > 1e-16 (after folding the sign of det).
//
// The resident walk takes the warp's entry-sorted super list front to
// back and stops once the next entry exceeds the block's largest live
// best t.
//
// The paged walk.  On the TPU a page (256 clusters) existed to fit the
// tables of a large scene through a 12 MB VMEM budget: the grid's second
// axis streamed one page per step, and best t carried across pages in
// the resident output block.  Here the attribute tables stay in device
// memory for both walks (a page's 2 MB of f32 rows could never sit in
// 227 KB of shared memory) and reach the SM through the 50 MB L2, so the
// page order only shapes L2 locality.
//
// Any hit (wave_trace_paged_anyhit_kernel) walks its page slots in
// order, carries best t in registers, and within a slot walks
// [offs, offe) of its (page, entry)-sorted list while the entry is <=
// the block's bound, with a page's cluster boxes (256 x 8 f32 = 8 KB)
// staged in shared memory once per slot it enters; the TPU's scalar
// prefetch of the page list becomes the block's own loads, and its pad
// slots are empty ranges the block skips.
//
// Closest hit (wave_trace_paged_closest_kernel) walks in entry order
// instead: page order made a block's best t fall late and ran 1.5x the
// resident walk's tests.  Each slot range is entry-sorted, so a k-way
// merge over the slot heads (warp 0, an arg-min over the heads 32 slots a
// step, ties to the lower slot = the lower super id) yields the resident
// walk's order, and the walk stops when the least head exceeds the
// block's bound.  A super's 16 boxes (512 B) are read where they are.
// Each ray then tests only the clusters its own slab accepted: per
// surviving cluster the rays that need it are compacted in shared memory
// (ballot and prefix), each listed ray's real triangles are split over 4
// neighbouring threads (slots q, q+4, ...: conflict-free float4 reads of
// the transposed tile), and (t, slot) is reduced over them with the
// serial loop's rule (strict t < best, the lowest slot among equal t).
// The surviving clusters' 8 KB tiles are double-buffered: cp.async loads
// the next while the current one is tested.
//
// Bound.  The work is ray-triangle tests (40 f32 multiplies and adds
// each, FLOPS_PER_TEST in ops/wave_trace.py); at the main path's shapes
// that is far above what the table and ray bytes cost, so the kernels
// are operation-bound.  They count, per ray, the tests the function
// needs: the real triangles of each cluster whose slab accepts that ray
// (with its best t when the walk reaches the super), up to the hit for
// an any-hit ray that stops.  Beside it, the tests the ray's threads
// ran.  K1, K2 and K3's any hit keep the first, simple schedule (every
// live thread of a block evaluates every cluster that any ray of its
// block needs, one cluster staged at a time, blocks of 128 threads); K3's
// closest hit runs only each ray's own clusters, up to each cluster's
// last real triangle (zero-area triangles before it are run, not needed).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARP_RAYS = 128;   // rays per block (one TPU warp)
constexpr int CLUSTER = 128;     // triangles per cluster
constexpr int SUP = 16;          // clusters per super
constexpr int ATTR_ROWS = 16;    // attr rows per cluster
constexpr int FCOLS = 16;        // ray feature columns
constexpr int TSTRIDE = 20;      // staged floats per triangle (16 + pad:
                                 // conflict-free float4 stores)
constexpr int MAX_PAGE_CLUSTERS = 256;   // the JAX package's PAGE_CLUSTERS
constexpr float BIG = 3.0e38f;   // the JAX package's INF
// slot heads of the closest-hit paged walk, in dynamic shared memory
// beside its 25 KB of static state: 16,000 page slots
constexpr int MAX_SLOT_HEAD_BYTES = 192000;

struct Ray {
    float ox, oy, oz, dx, dy, dz, mx, my, mz, rtmin, ix, iy, iz, tmax;
    bool live0;
};

__device__ __forceinline__ Ray load_ray(const float *__restrict__ f,
                                        long long ray) {
    const float4 *fr = reinterpret_cast<const float4 *>(f + ray * FCOLS);
    const float4 f0 = fr[0];   // o.x o.y o.z 1
    const float4 f1 = fr[1];   // d.x d.y d.z m.x
    const float4 f2 = fr[2];   // m.y m.z tmin tmax
    const float4 f3 = fr[3];   // invd.x invd.y invd.z pad
    Ray r;
    r.ox = f0.x; r.oy = f0.y; r.oz = f0.z;
    r.dx = f1.x; r.dy = f1.y; r.dz = f1.z;
    r.mx = f1.w; r.my = f2.x; r.mz = f2.y;
    r.rtmin = f2.z;
    r.ix = f3.x; r.iy = f3.y; r.iz = f3.z;
    r.tmax = fminf(f2.w, 1e37f);
    r.live0 = r.tmax > 0.0f;
    return r;
}

__device__ __forceinline__ float block_max(float v, float *red) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    __syncthreads();   // protect `red` from the previous use
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// the warp_bound live rule: an any-hit ray that has hit drops out
template <bool ANY_HIT>
__device__ __forceinline__ bool still_live(const Ray &r, float tb) {
    return ANY_HIT ? (r.live0 && tb > -1e37f) : r.live0;
}

// One super of the walk: slab-test its 16 member clusters (boxes at `cb`,
// in device or shared memory; global ids cid0 .. cid0+15), OR the
// survivors over the block, then stage and test each surviving cluster.
// Block-uniform: every thread of the block calls it.
template <bool ANY_HIT>
__device__ __forceinline__ void visit_super(
        const Ray &r, const float *cb, int cid0,
        const float *__restrict__ attr, float *tile, unsigned *smask,
        float &tb, int &tri, int &needed, int &executed) {
    const int tid = threadIdx.x;
    unsigned m = 0;
    if (r.live0) {
#pragma unroll 4
        for (int c = 0; c < SUP; ++c) {
            const float4 lo = *reinterpret_cast<const float4 *>(cb + c * 8);
            const float4 hi = *reinterpret_cast<const float4 *>(cb + c * 8 + 4);
            // lo = (lox, loy, loz, hix), hi = (hiy, hiz, valid, pad)
            const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
            const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
            const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fmaxf(fminf(t0z, t1z), r.rtmin));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fminf(fmaxf(t0z, t1z), tb));
            if (tn <= tf * 1.00000024f && hi.z > 0.0f) m |= 1u << c;
        }
    }
    if (tid == 0) *smask = 0u;
    __syncthreads();
    const unsigned wm = __reduce_or_sync(0xffffffffu, m);
    if ((tid & 31) == 0 && wm) atomicOr(smask, wm);
    __syncthreads();
    unsigned bits = *smask;

    while (bits) {
        const int c = __ffs(bits) - 1;
        bits &= bits - 1;
        const int cid = cid0 + c;
        // stage: thread tid owns triangle tid's 16 rows
        const float *ablk = attr + (long long)cid * ATTR_ROWS * CLUSTER;
        float a[ATTR_ROWS];
#pragma unroll
        for (int i = 0; i < ATTR_ROWS; ++i) a[i] = ablk[i * CLUSTER + tid];
        float4 *dst = reinterpret_cast<float4 *>(tile + tid * TSTRIDE);
        dst[0] = make_float4(a[0], a[1], a[2], a[3]);
        dst[1] = make_float4(a[4], a[5], a[6], a[7]);
        dst[2] = make_float4(a[8], a[9], a[10], a[11]);
        dst[3] = make_float4(a[12], a[13], a[14], a[15]);
        const bool act = still_live<ANY_HIT>(r, tb);
        // real triangles of the cluster: padding slots hold zero rows,
        // and a triangle with n = 0 never passes det > 1e-16
        const int n_real = __syncthreads_count(
            a[12] != 0.0f || a[13] != 0.0f || a[14] != 0.0f);
        if (act) {
            int j = 0;
            for (; j < CLUSTER; ++j) {
                const float4 *tr =
                    reinterpret_cast<const float4 *>(tile + j * TSTRIDE);
                const float4 r0 = tr[0];   // ne2v0.xyz, e2.x
                const float4 r1 = tr[1];   // e2.yz, e1v0.xy
                const float4 r2 = tr[2];   // e1v0.z, ne1.xyz
                const float4 r3 = tr[3];   // n.xyz, -(n.v0)
                const float det = -(r.dx * r3.x + r.dy * r3.y + r.dz * r3.z);
                const float udet = r.dx * r0.x + r.dy * r0.y + r.dz * r0.z +
                                   r.mx * r0.w + r.my * r1.x + r.mz * r1.y;
                const float vdet = r.dx * r1.z + r.dy * r1.w + r.dz * r2.x +
                                   r.mx * r2.y + r.my * r2.z + r.mz * r2.w;
                const float tdet = r.ox * r3.x + r.oy * r3.y + r.oz * r3.z +
                                   r3.w;
                const float sg = det >= 0.0f ? 1.0f : -1.0f;
                const float ad = det * sg;
                const float un = udet * sg, vn = vdet * sg, tn = tdet * sg;
                const bool ok = (un >= 0.0f) & (vn >= 0.0f) &
                                (un + vn <= ad) & (tn > r.rtmin * ad) &
                                (tn < tb * ad) & (ad > 1e-16f);
                if (ok) {
                    if (ANY_HIT) {
                        tb = -BIG;
                        tri = cid * CLUSTER;
                        break;
                    }
                    const float tc = tn / fmaxf(ad, 1e-30f);
                    if (tc < tb) {
                        tb = tc;
                        tri = cid * CLUSTER + j;
                    }
                }
            }
            const int ran = j < CLUSTER ? j + 1 : CLUSTER;   // any hit stops
            executed += ran;
            if ((m >> c) & 1u) needed += j < CLUSTER ? ran : n_real;
        }
        __syncthreads();   // the tile is restaged next
    }
}

__device__ __forceinline__ void store(long long ray, float tb, int tri,
                                      int needed, int executed,
                                      float *__restrict__ t_out,
                                      int *__restrict__ tri_out,
                                      int *__restrict__ tests_out) {
    t_out[ray] = tb;
    tri_out[ray] = tri;
    tests_out[ray] = needed;
    tests_out[(long long)gridDim.x * WARP_RAYS + ray] = executed;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(WARP_RAYS)
wave_trace_kernel(const float *__restrict__ f,      // (R, 16) ray features
                  const float *__restrict__ sent,   // (R/128, nsp) entries
                  const int *__restrict__ sids,     // (R/128, nsp) super ids
                  const float *__restrict__ cbox,   // (NCp, 8)
                  const float *__restrict__ attr,   // (NCp*16, 128)
                  float *__restrict__ t_out,        // (R,)
                  int *__restrict__ tri_out,        // (R,)
                  int *__restrict__ tests_out,      // (2, R)
                  int nsp, int nsup) {
    __shared__ __align__(16) float tile[CLUSTER * TSTRIDE];
    __shared__ float red[4];
    __shared__ unsigned smask;

    const long long ray = (long long)blockIdx.x * WARP_RAYS + threadIdx.x;
    const Ray r = load_ray(f, ray);
    float tb = r.tmax;   // best t so far (-BIG once an any-hit ray hits)
    int tri = -1;
    int needed = 0;      // ray-triangle tests this ray needs
    int executed = 0;    // ray-triangle tests its thread ran

    const float *srow = sent + (long long)blockIdx.x * nsp;
    const int *irow = sids + (long long)blockIdx.x * nsp;

    float bound = block_max(still_live<ANY_HIT>(r, tb) ? tb : -BIG, red);
    for (int k = 0; k < nsp; ++k) {
        const float e = srow[k];
        if (!(e <= bound)) break;   // sorted: no later super can help
        const int sid = min(irow[k], nsup - 1);
        visit_super<ANY_HIT>(r, cbox + (long long)sid * SUP * 8, sid * SUP,
                             attr, tile, &smask, tb, tri, needed, executed);
        bound = block_max(still_live<ANY_HIT>(r, tb) ? tb : -BIG, red);
    }
    store(ray, tb, tri, needed, executed, t_out, tri_out, tests_out);
}

__global__ void __launch_bounds__(WARP_RAYS)
wave_trace_paged_anyhit_kernel(const float *__restrict__ f,    // (R, 16)
                               const float *__restrict__ sent, // (R/128, nsp)
                               const int *__restrict__ sids,   // (R/128, nsp)
                               const int *__restrict__ pages,  // (R/1024, S)
                               const int *__restrict__ offs,   // (R/128, S)
                               const int *__restrict__ offe,   // (R/128, S)
                               const float *__restrict__ cbox, // (NCp, 8)
                               const float *__restrict__ attr, // (NCp*16, 128)
                               float *__restrict__ t_out,
                               int *__restrict__ tri_out,
                               int *__restrict__ tests_out,
                               int nsp, int n_slots, int ncp, int page_sup) {
    __shared__ __align__(16) float tile[CLUSTER * TSTRIDE];
    __shared__ __align__(16) float pcb[MAX_PAGE_CLUSTERS * 8];
    __shared__ float red[4];
    __shared__ unsigned smask;

    const int tid = threadIdx.x;
    const long long ray = (long long)blockIdx.x * WARP_RAYS + tid;
    const Ray r = load_ray(f, ray);
    float tb = r.tmax;
    int tri = -1;
    int needed = 0;
    int executed = 0;

    const int page_cl = page_sup * SUP;
    const int nsup = (ncp + page_cl - 1) / page_cl * page_sup;
    const float *srow = sent + (long long)blockIdx.x * nsp;
    const int *irow = sids + (long long)blockIdx.x * nsp;
    const int *prow = pages + (long long)(blockIdx.x / 8) * n_slots;
    const int *srng = offs + (long long)blockIdx.x * n_slots;
    const int *erng = offe + (long long)blockIdx.x * n_slots;

    float bound = block_max(still_live<true>(r, tb) ? tb : -BIG, red);
    for (int p = 0; p < n_slots; ++p) {
        const int ks = srng[p], ke = erng[p];
        // an empty range (pad slot, or a page only other warps need), or
        // one whose first entry is already past the bound: nothing to do
        if (ks >= ke || !(srow[ks] <= bound)) continue;
        const int page = prow[p];
        // stage the page's cluster boxes; clusters past the table are
        // zero rows (valid = 0), as the TPU's page padding was
        __syncthreads();   // the previous slot's boxes are no longer read
        for (int i = tid; i < page_cl * 2; i += WARP_RAYS) {
            const long long row = (long long)page * page_cl + (i >> 1);
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (row < ncp)
                v = reinterpret_cast<const float4 *>(cbox)[row * 2 + (i & 1)];
            reinterpret_cast<float4 *>(pcb)[i] = v;
        }
        __syncthreads();
        for (int k = ks; k < ke; ++k) {
            if (!(srow[k] <= bound)) break;   // sorted within the page
            const int sid = min(irow[k], nsup - 1);
            const int sid_local = min(max(sid - page * page_sup, 0),
                                      page_sup - 1);
            visit_super<true>(r, pcb + sid_local * SUP * 8,
                              page * page_cl + sid_local * SUP, attr, tile,
                              &smask, tb, tri, needed, executed);
            bound = block_max(still_live<true>(r, tb) ? tb : -BIG, red);
        }
    }
    store(ray, tb, tri, needed, executed, t_out, tri_out, tests_out);
}

// 4-byte cp.async (the transposed staging writes one float at a time)
__device__ __forceinline__ void cp_async4(float *dst, const float *src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :
                 : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                   "l"(src)
                 : "memory");
}

// Start the copy of cluster cid's 16 x 128 attribute rows into `tile`,
// transposed (triangle j at j*TSTRIDE): thread t copies triangle t, so
// after its own wait it may read that triangle.
__device__ __forceinline__ void stage_cluster(const float *__restrict__ attr,
                                              int cid, float *tile) {
    const float *src = attr + (long long)cid * ATTR_ROWS * CLUSTER +
                       threadIdx.x;
    float *dst = tile + threadIdx.x * TSTRIDE;
#pragma unroll
    for (int i = 0; i < ATTR_ROWS; ++i) cp_async4(dst + i, src + i * CLUSTER);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One super of the entry-ordered closest-hit walk with per-ray work: each
// live ray slab-tests the 16 member clusters against its own best t; for
// each cluster, the rays whose slab accepted it are compacted into a list
// (ballot and prefix over the block); then each listed ray's real
// triangles are split over QUARTERS neighbouring threads (triangles
// q, q+4, ...) and the (t, slot) winners are reduced over them, the
// lowest slot winning among equal t as in the serial loop.  Cluster tiles
// are double-buffered: the next surviving cluster's rows load by cp.async
// while the current one is tested.  Block-uniform; the rays' state lives
// in shared memory (tb_s, tri_s and the two counts).
struct SplitState {
    float tile[2][CLUSTER * TSTRIDE];
    float tb[WARP_RAYS];
    int tri[WARP_RAYS], needed[WARP_RAYS], ran[WARP_RAYS];
    unsigned char list[SUP][WARP_RAYS];
    int cnt[SUP][WARP_RAYS / 32];
    unsigned nz[2][WARP_RAYS / 32];   // real-triangle ballots, per tile
};

constexpr int QUARTERS = 4;   // threads per ray in the leaf tests

__device__ __forceinline__ void visit_super_split(
        const Ray &r, const float *__restrict__ cb, int cid0,
        const float *__restrict__ f, const float *__restrict__ attr,
        SplitState &st) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float tb = st.tb[tid];
    unsigned m = 0;
    if (r.live0) {
#pragma unroll 4
        for (int c = 0; c < SUP; ++c) {
            const float4 lo = *reinterpret_cast<const float4 *>(cb + c * 8);
            const float4 hi = *reinterpret_cast<const float4 *>(cb + c * 8 + 4);
            const float t0x = (lo.x - r.ox) * r.ix, t1x = (lo.w - r.ox) * r.ix;
            const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.x - r.oy) * r.iy;
            const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.y - r.oz) * r.iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fmaxf(fminf(t0z, t1z), r.rtmin));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fminf(fmaxf(t0z, t1z), tb));
            if (tn <= tf * 1.00000024f && hi.z > 0.0f) m |= 1u << c;
        }
    }
    // per-cluster ray lists: warp counts, then each ray's slot
    unsigned bal[SUP];
#pragma unroll
    for (int c = 0; c < SUP; ++c) {
        bal[c] = __ballot_sync(0xffffffffu, (m >> c) & 1u);
        if (lane == 0) st.cnt[c][warp] = __popc(bal[c]);
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    unsigned bits = 0;
#pragma unroll
    for (int c = 0; c < SUP; ++c) {
        const int c0 = st.cnt[c][0], c1 = st.cnt[c][1], c2 = st.cnt[c][2];
        if (c0 + c1 + c2 + st.cnt[c][3]) bits |= 1u << c;
        if ((m >> c) & 1u) {
            const int before = (warp > 0 ? c0 : 0) + (warp > 1 ? c1 : 0) +
                               (warp > 2 ? c2 : 0);
            st.list[c][before + __popc(bal[c] & below)] =
                static_cast<unsigned char>(tid);
        }
    }
    int cur = 0;
    if (bits) stage_cluster(attr, cid0 + __ffs(bits) - 1, st.tile[0]);
    __syncthreads();   // the lists are complete

    while (bits) {
        const int c = __ffs(bits) - 1;
        bits &= bits - 1;
        const int cid = cid0 + c;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        const float *tile = st.tile[cur];
        // real triangles: a padding slot or a zero-area triangle has n = 0
        // and never passes det > 1e-16.  Padding sits at the end, but
        // zero-area triangles sit wherever the BVH order puts them, so the
        // tests run up to the last real slot, not up to the count.
        const float *own = tile + tid * TSTRIDE;
        const unsigned nzw = __ballot_sync(
            0xffffffffu,
            own[12] != 0.0f || own[13] != 0.0f || own[14] != 0.0f);
        if (lane == 0) st.nz[cur][warp] = nzw;   // read before the next
        __syncthreads();                         // write to nz[cur]
        int n_real = 0, n_last = 0;
#pragma unroll
        for (int w = 0; w < WARP_RAYS / 32; ++w) {
            const unsigned b = st.nz[cur][w];
            n_real += __popc(b);
            if (b) n_last = w * 32 + 32 - __clz(b);
        }
        if (bits) stage_cluster(attr, cid0 + __ffs(bits) - 1,
                                st.tile[cur ^ 1]);
        const int n = st.cnt[c][0] + st.cnt[c][1] + st.cnt[c][2] +
                      st.cnt[c][3];
        for (int base = 0; base < n * QUARTERS; base += WARP_RAYS) {
            const int item = base + tid, q = item & (QUARTERS - 1);
            const bool act = item < n * QUARTERS;
            const int ri = act ? st.list[c][item / QUARTERS] : 0;
            float tl = BIG;
            int jl = CLUSTER, ran = 0;   // jl == CLUSTER: no hit
            if (act) {
                const Ray x = load_ray(f, (long long)blockIdx.x * WARP_RAYS +
                                              ri);
                tl = st.tb[ri];
                for (int j = q; j < n_last; j += QUARTERS) {
                    const float4 *tr =
                        reinterpret_cast<const float4 *>(tile + j * TSTRIDE);
                    const float4 r0 = tr[0];   // ne2v0.xyz, e2.x
                    const float4 r1 = tr[1];   // e2.yz, e1v0.xy
                    const float4 r2 = tr[2];   // e1v0.z, ne1.xyz
                    const float4 r3 = tr[3];   // n.xyz, -(n.v0)
                    const float det = -(x.dx * r3.x + x.dy * r3.y +
                                        x.dz * r3.z);
                    const float udet = x.dx * r0.x + x.dy * r0.y +
                                       x.dz * r0.z + x.mx * r0.w +
                                       x.my * r1.x + x.mz * r1.y;
                    const float vdet = x.dx * r1.z + x.dy * r1.w +
                                       x.dz * r2.x + x.mx * r2.y +
                                       x.my * r2.z + x.mz * r2.w;
                    const float tdet = x.ox * r3.x + x.oy * r3.y +
                                       x.oz * r3.z + r3.w;
                    const float sg = det >= 0.0f ? 1.0f : -1.0f;
                    const float ad = det * sg;
                    const float un = udet * sg, vn = vdet * sg,
                                tn = tdet * sg;
                    const bool ok = (un >= 0.0f) & (vn >= 0.0f) &
                                    (un + vn <= ad) & (tn > x.rtmin * ad) &
                                    (tn < tl * ad) & (ad > 1e-16f);
                    ++ran;
                    if (ok) {
                        const float tc = tn / fmaxf(ad, 1e-30f);
                        if (tc < tl) {
                            tl = tc;
                            jl = j;
                        }
                    }
                }
            }
            // the ray's QUARTERS neighbouring lanes: least (t, slot)
#pragma unroll
            for (int o = 1; o < QUARTERS; o <<= 1) {
                const float t2 = __shfl_xor_sync(0xffffffffu, tl, o);
                const int j2 = __shfl_xor_sync(0xffffffffu, jl, o);
                ran += __shfl_xor_sync(0xffffffffu, ran, o);
                if (t2 < tl || (t2 == tl && j2 < jl)) {
                    tl = t2;
                    jl = j2;
                }
            }
            if (act && q == 0) {
                if (jl < CLUSTER) {
                    st.tb[ri] = tl;
                    st.tri[ri] = cid * CLUSTER + jl;
                }
                st.needed[ri] += n_real;
                st.ran[ri] += ran;
            }
        }
        cur ^= 1;
    }
    __syncthreads();   // the rays' state and the tiles are settled
}

// K3 closest hit: the paged walk's lists merged into entry order.  Each
// (block, slot) range [offs, offe) of the (page, entry)-sorted list is
// entry-sorted, so a k-way merge over the slot heads (warp 0 takes the
// least (entry, slot) over all heads, 32 slots a step) gives the resident
// walk's order, ties in ascending super id; the walk stops when the least
// head exceeds the block's bound.  Super boxes are read where they are.
__global__ void __launch_bounds__(WARP_RAYS)
wave_trace_paged_closest_kernel(const float *__restrict__ f,    // (R, 16)
                                const float *__restrict__ sent, // (R/128, nsp)
                                const int *__restrict__ sids,   // (R/128, nsp)
                                const int *__restrict__ offs,   // (R/128, S)
                                const int *__restrict__ offe,   // (R/128, S)
                                const float *__restrict__ cbox, // (NCp, 8)
                                const float *__restrict__ attr, // (NCp*16, 128)
                                float *__restrict__ t_out,
                                int *__restrict__ tri_out,
                                int *__restrict__ tests_out,
                                int nsp, int n_slots, int ncp) {
    __shared__ __align__(16) SplitState st;
    __shared__ float red[4];
    __shared__ float sel_e;
    __shared__ int sel_k;
    extern __shared__ int slot_heads[];   // head, end, head entry per slot
    int *head = slot_heads, *hend = slot_heads + n_slots;
    float *head_e = reinterpret_cast<float *>(slot_heads + 2 * n_slots);

    const int tid = threadIdx.x, lane = tid & 31;
    const long long ray = (long long)blockIdx.x * WARP_RAYS + tid;
    const Ray r = load_ray(f, ray);
    st.tb[tid] = r.tmax;
    st.tri[tid] = -1;
    st.needed[tid] = 0;
    st.ran[tid] = 0;
    const float *srow = sent + (long long)blockIdx.x * nsp;
    const int *irow = sids + (long long)blockIdx.x * nsp;
    const int *srng = offs + (long long)blockIdx.x * n_slots;
    const int *erng = offe + (long long)blockIdx.x * n_slots;
    for (int p = tid; p < n_slots; p += WARP_RAYS) {
        const int ks = srng[p], ke = erng[p];
        head[p] = ks;
        hend[p] = ke;
        head_e[p] = ks < ke ? srow[ks] : CUDART_INF_F;
    }
    const int last_sup = ncp / SUP - 1;

    float bound = block_max(r.live0 ? r.tmax : -BIG, red);
    for (;;) {
        if (tid < 32) {   // the least (entry, slot) over the slot heads
            float be = CUDART_INF_F;
            int bp = n_slots;
            for (int p = lane; p < n_slots; p += 32)
                if (head_e[p] < be) {
                    be = head_e[p];
                    bp = p;
                }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const float e2 = __shfl_xor_sync(0xffffffffu, be, o);
                const int p2 = __shfl_xor_sync(0xffffffffu, bp, o);
                if (e2 < be || (e2 == be && p2 < bp)) {
                    be = e2;
                    bp = p2;
                }
            }
            if (lane == 0) {
                sel_e = be;
                sel_k = -1;
                if (bp < n_slots) {
                    const int k = head[bp];
                    sel_k = k;
                    head[bp] = k + 1;
                    head_e[bp] = k + 1 < hend[bp] ? srow[k + 1]
                                                  : CUDART_INF_F;
                }
            }
        }
        __syncthreads();
        const float e = sel_e;
        const int k = sel_k;
        if (!(e <= bound)) break;   // no later super can help
        const int sid = min(irow[k], last_sup);
        visit_super_split(r, cbox + (long long)sid * SUP * 8, sid * SUP, f,
                          attr, st);
        bound = block_max(r.live0 ? st.tb[tid] : -BIG, red);
    }
    store(ray, st.tb[tid], st.tri[tid], st.needed[tid], st.ran[tid], t_out,
          tri_out, tests_out);
}

}  // namespace

extern "C" {

// Launches one mode of the resident walk on `stream`; returns
// cudaGetLastError() (0 = ok).
int wave_trace_launch(const void *f, const void *sent, const void *sids,
                      const void *cbox, const void *attr, void *t_out,
                      void *tri_out, void *tests_out, int n_blocks, int nsp,
                      int nsup, int any_hit, void *stream) {
    if (n_blocks <= 0) return 0;
    const dim3 grid(n_blocks), block(WARP_RAYS);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float *F = static_cast<const float *>(f);
    const float *SE = static_cast<const float *>(sent);
    const int *SI = static_cast<const int *>(sids);
    const float *CB = static_cast<const float *>(cbox);
    const float *AT = static_cast<const float *>(attr);
    float *T = static_cast<float *>(t_out);
    int *TR = static_cast<int *>(tri_out);
    int *TS = static_cast<int *>(tests_out);
    if (any_hit)
        wave_trace_kernel<true><<<grid, block, 0, s>>>(F, SE, SI, CB, AT, T,
                                                       TR, TS, nsp, nsup);
    else
        wave_trace_kernel<false><<<grid, block, 0, s>>>(F, SE, SI, CB, AT, T,
                                                        TR, TS, nsp, nsup);
    return static_cast<int>(cudaGetLastError());
}

// Launches one mode of the paged walk (n_blocks = R/128, a multiple of
// 8; page_sup * 16 <= 256) on `stream`; returns cudaGetLastError().  The
// page list is read by the any-hit walk only (closest hit may pass null).
int wave_trace_paged_launch(const void *f, const void *sent, const void *sids,
                            const void *pages, const void *offs,
                            const void *offe, const void *cbox,
                            const void *attr, void *t_out, void *tri_out,
                            void *tests_out, int n_blocks, int nsp,
                            int n_slots, int ncp, int page_sup, int any_hit,
                            void *stream) {
    if (n_blocks <= 0) return 0;
    if (n_blocks % 8 || page_sup <= 0 || page_sup * SUP > MAX_PAGE_CLUSTERS)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(n_blocks), block(WARP_RAYS);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float *F = static_cast<const float *>(f);
    const float *SE = static_cast<const float *>(sent);
    const int *SI = static_cast<const int *>(sids);
    const int *PG = static_cast<const int *>(pages);
    const int *OS = static_cast<const int *>(offs);
    const int *OE = static_cast<const int *>(offe);
    const float *CB = static_cast<const float *>(cbox);
    const float *AT = static_cast<const float *>(attr);
    float *T = static_cast<float *>(t_out);
    int *TR = static_cast<int *>(tri_out);
    int *TS = static_cast<int *>(tests_out);
    if (any_hit) {
        wave_trace_paged_anyhit_kernel<<<grid, block, 0, s>>>(
            F, SE, SI, PG, OS, OE, CB, AT, T, TR, TS, nsp, n_slots, ncp,
            page_sup);
    } else {
        // the slot heads: (head, end, head entry) per slot
        const int heads = n_slots * 12;
        if (heads > MAX_SLOT_HEAD_BYTES)
            return static_cast<int>(cudaErrorInvalidValue);
        if (heads > 16384) {
            cudaError_t e = cudaFuncSetAttribute(
                wave_trace_paged_closest_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, heads);
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        wave_trace_paged_closest_kernel<<<grid, block, heads, s>>>(
            F, SE, SI, OS, OE, CB, AT, T, TR, TS, nsp, n_slots, ncp);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
