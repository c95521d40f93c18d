// Wave traversal kernels for Hopper (sm_90a): one closest-hit kernel for
// the resident and the paged scene, the resident any-hit walk and the
// paged any-hit walk.
//
// wave_trace_closest_kernel replaces tungsten_tpu/ops/wave_trace.py::
// _make_kernel(any_hit=False) (launched by wave_intersect) and
// ::_make_kernel_paged(any_hit=False) (launched by wave_intersect_paged):
// both compute the same closest hit, and on this card the page order only
// shaped L2 locality, so one entry-ordered walk serves both.
// wave_trace_anyhit_kernel replaces _make_kernel(any_hit=True) and, for
// the same reason, _make_kernel_paged(any_hit=True): on a 606,724-
// triangle scene (54 MiB of attribute rows, over the 50 MB L2) its
// wrapper, front included, ran faster than the page-ordered one.
// wave_trace_paged_anyhit_kernel, that page-ordered any-hit walk, stays
// as the page order's yardstick; no wrapper launches it.
// They read the same tables (build_wave_tables) and the same per-warp
// super lists (the fronts _cull_sorted_supers and _cull_paged) and return
// what the TPU kernels return: per ray the winning t and cluster*128+slot
// (closest hit), or t = -3e38 with tri >= 0 on an occluded segment (any
// hit; tri beyond its sign carries no meaning).
//
// Leaf.  A cluster's 16 x 128 f32 attribute rows (8 KB) are staged in
// shared memory transposed, so that one triangle is 16 contiguous floats
// (four float4 loads), and a test evaluates det, u*det, v*det and t*det
// as f32 FMA chains, the quantities the TPU computed with a K=48 bf16
// hi/lo matmul, here straight in f32.  Acceptance is the TPU's: u, v >= 0,
// u + v <= det, t*det > tmin*det, det > 1e-16 (after folding the sign of
// det), and t below the ray's best.
//
// Per-ray work (every kernel of this file).  One CUDA block serves one
// 128-ray warp of the TPU kernel, one thread a ray.  Each ray slab-tests
// a super's 16 clusters against its own best t (the 1.00000024 fudge);
// per cluster the rays whose slab accepted it are compacted into a list
// (ballot and prefix); each listed ray's real triangles are split over P
// neighbouring threads (slots q, q+P, ...: conflict-free float4 reads of
// the transposed tile), P = 128 / (listed rays) rounded down to a power
// of two between 4 and 32, so a cluster that one ray needs still runs on
// a whole warp.  The tiles are double-buffered: cp.async loads the next
// surviving cluster while the current one is tested.  Tests run up to a
// cluster's last real slot (zero-area triangles sit wherever the BVH
// order puts them).
//
// Closest hit walks the warp's entry-sorted list front to back and stops
// once the next entry exceeds the block's largest live best t.  A ray's
// best is a 64-bit key: t's bits (order-preserving as unsigned) over the
// walk position * 2048 + cluster * 128 + slot, so the least key is the
// serial loop's winner (strict t < best, ties to the earliest in walk
// order) whatever order the candidates are found in.
//
// Any hit (visit_anyhit, shared by both any-hit kernels) slab-tests with
// the ray's t_max and lets a ray leave at its first hit: its threads test
// their slots in lockstep and agree through a warp ballot after every
// round, so the lowest hit slot of the first round with a hit is the
// serial loop's, and an occluded ray drops out of later lists and of the
// block's bound (the largest t_max of its live rays not yet occluded).
// The resident any hit (K2) walks the entry-sorted list as closest hit
// does, reading each super's boxes from device memory; the paged any hit
// walks its page slots in order, a page's 256 cluster boxes staged in
// shared memory once per slot it enters (the page order keeps a large
// scene's attribute rows local in L2), and within a slot the (page,
// entry)-sorted range while the entry is <= the block's bound.
//
// Narrow launches.  A render's late bounces launch waves of a few
// thousand rays, a few dozen blocks on a 132-SM card, each on a long
// serial walk.  So the launcher splits each block's walk over `splits`
// CTAs (chosen on the host from the grid width and the SM count; 1 for a
// full-width wave): CTA s of a resident walk takes list positions s,
// s+splits, ..., CTA s of the paged any hit page slots s, s+splits, ....
// The CTAs of a block share each ray's best through one word in device
// memory: the closest-hit key (stored inverted, updated with atomicMax,
// so a zero-filled scratch means "no hit"), read back after every super
// to cull with; the any-hit occluded word (tri + 1), set by the CTA that
// finds a hit and read by the others after every super, which drop the
// ray.  The last CTA of a block to finish (a counter per block) decodes
// the words into t and tri.  The closest-hit result is the least key,
// the any-hit flag the existence of a hit, so both equal the one-CTA
// walk's whatever the CTAs' timing; the any-hit tri (which hit) and the
// counts of tests may differ.
//
// Bound.  The work is ray-triangle tests (40 f32 multiplies and adds
// each, FLOPS_PER_TEST in ops/wave_trace.py); at the main path's shapes
// that is far above what the table and ray bytes cost, so the kernels
// are operation-bound.  They count, per ray, the tests the function
// needs (row 0: the real triangles of each cluster whose slab accepts
// that ray with the best t it sees when it reaches the super, up to the
// hit for an any-hit ray that stops) and the tests its threads ran
// (row 1).  list_walk in ops/wave_trace.py is the same schedule in plain
// PyTorch, one CTA a block (any hit: on either front).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP_RAYS = 128;   // rays per block (one TPU warp)
constexpr int CLUSTER = 128;     // triangles per cluster
constexpr int SUP = 16;          // clusters per super
constexpr int ATTR_ROWS = 16;    // attr rows per cluster
constexpr int FCOLS = 16;        // ray feature columns
constexpr int TSTRIDE = 20;      // staged floats per triangle (16 + pad:
                                 // conflict-free float4 accesses)
constexpr int MAX_PAGE_CLUSTERS = 256;   // the JAX package's PAGE_CLUSTERS
constexpr int MAX_SPLITS = 64;   // CTAs a block's walk may be split over
constexpr int POS_SHIFT = 11;    // key low word: position * 2048 + c * 128
                                 // + slot
constexpr float BIG = 3.0e38f;   // the JAX package's INF
constexpr unsigned long long NO_HIT = ~0ull;

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

// The slab test of one ray against a super's 16 cluster boxes at `cb`
// (device or shared memory) with best t `tb`: bit c set where cluster c
// may hold a hit.
__device__ __forceinline__ unsigned slab16(const Ray &r, const float *cb,
                                           float tb) {
    unsigned m = 0;
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
    return m;
}

// One ray-triangle test of the leaf: the sign-folded det, u*det, v*det
// and t*det of triangle `tr` (16 staged floats) against ray x.
struct Leaf {
    float ad, un, vn, tn;
};

__device__ __forceinline__ Leaf leaf_test(const Ray &x, const float *tri) {
    const float4 *tr = reinterpret_cast<const float4 *>(tri);
    const float4 r0 = tr[0];   // ne2v0.xyz, e2.x
    const float4 r1 = tr[1];   // e2.yz, e1v0.xy
    const float4 r2 = tr[2];   // e1v0.z, ne1.xyz
    const float4 r3 = tr[3];   // n.xyz, -(n.v0)
    const float det = -(x.dx * r3.x + x.dy * r3.y + x.dz * r3.z);
    const float udet = x.dx * r0.x + x.dy * r0.y + x.dz * r0.z +
                       x.mx * r0.w + x.my * r1.x + x.mz * r1.y;
    const float vdet = x.dx * r1.z + x.dy * r1.w + x.dz * r2.x +
                       x.mx * r2.y + x.my * r2.z + x.mz * r2.w;
    const float tdet = x.ox * r3.x + x.oy * r3.y + x.oz * r3.z + r3.w;
    const float sg = det >= 0.0f ? 1.0f : -1.0f;
    Leaf l;
    l.ad = det * sg;
    l.un = udet * sg;
    l.vn = vdet * sg;
    l.tn = tdet * sg;
    return l;
}

// u, v >= 0, u + v <= det, t*det > tmin*det, det > 1e-16
__device__ __forceinline__ bool leaf_inside(const Ray &x, const Leaf &l) {
    return (l.un >= 0.0f) & (l.vn >= 0.0f) & (l.un + l.vn <= l.ad) &
           (l.tn > x.rtmin * l.ad) & (l.ad > 1e-16f);
}

// ------------------------------------------------------ per-ray work

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

// A block's state in the per-ray walks.  key: the closest-hit best (see
// the header); tri: any hit, the occluding cluster*128 or -1.
struct SplitState {
    float tile[2][CLUSTER * TSTRIDE];
    unsigned long long key[WARP_RAYS];
    int tri[WARP_RAYS], needed[WARP_RAYS], ran[WARP_RAYS];
    unsigned char list[SUP][WARP_RAYS];
    int cnt[SUP][WARP_RAYS / 32];
    unsigned nz[2][WARP_RAYS / 32];   // real-triangle ballots, per tile
    float red[4];
    int last;
};

// order-preserving map of a float's bits to an unsigned, and back
__device__ __forceinline__ unsigned f2o(float t) {
    const unsigned u = __float_as_uint(t);
    return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float o2f(unsigned u) {
    return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ float key_time(unsigned long long key,
                                         float tmax) {
    return key == NO_HIT ? tmax : o2f(static_cast<unsigned>(key >> 32));
}

// Per-cluster ray lists of one super: ray tid is listed under cluster c
// iff bit c of m.  Starts the first listed cluster's copy into tile 0 and
// returns the listed clusters (block-uniform).
__device__ __forceinline__ unsigned build_lists(unsigned m, int cid0,
                                                const float *__restrict__ attr,
                                                SplitState &st) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    if (bits) stage_cluster(attr, cid0 + __ffs(bits) - 1, st.tile[0]);
    __syncthreads();   // the lists are complete
    return bits;
}

// Wait for tile `cur` and count its real triangles (a padding slot or a
// zero-area triangle has n = 0): their number and the last real slot + 1.
// The barrier that publishes the tile also carries each warp's ballot;
// the ballots are double-buffered with the tiles, so no warp overwrites
// one another still reads.
__device__ __forceinline__ void tile_ready(int cur, SplitState &st,
                                           int &n_real, int &n_last) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    const float *own = st.tile[cur] + tid * TSTRIDE;
    const unsigned nzw = __ballot_sync(
        0xffffffffu, own[12] != 0.0f || own[13] != 0.0f || own[14] != 0.0f);
    if (lane == 0) st.nz[cur][warp] = nzw;
    __syncthreads();
    n_real = 0;
    n_last = 0;
#pragma unroll
    for (int w = 0; w < WARP_RAYS / 32; ++w) {
        const unsigned b = st.nz[cur][w];
        n_real += __popc(b);
        if (b) n_last = w * 32 + 32 - __clz(b);
    }
}

// threads per listed ray: 128 / n rounded down to a power of two, 4..32
__device__ __forceinline__ int group_log2(int n) {
    return n <= 4 ? 5 : n <= 8 ? 4 : n <= 16 ? 3 : 2;
}

// One super of the closest-hit walk at list position `pos`.  Block-uniform.
__device__ __forceinline__ void visit_closest(
        const Ray &r, const float *__restrict__ cb, int cid0, unsigned pos,
        const float *__restrict__ f, const float *__restrict__ attr,
        long long ray0, SplitState &st) {
    const int tid = threadIdx.x;
    const unsigned m =
        r.live0 ? slab16(r, cb, key_time(st.key[tid], r.tmax)) : 0u;
    unsigned bits = build_lists(m, cid0, attr, st);
    int cur = 0;
    while (bits) {
        const int c = __ffs(bits) - 1;
        bits &= bits - 1;
        int n_real, n_last;
        tile_ready(cur, st, n_real, n_last);
        if (bits) stage_cluster(attr, cid0 + __ffs(bits) - 1,
                                st.tile[cur ^ 1]);
        const float *tile = st.tile[cur];
        const int n = st.cnt[c][0] + st.cnt[c][1] + st.cnt[c][2] +
                      st.cnt[c][3];
        const int lg = group_log2(n), P = 1 << lg;
        for (int base = 0; base < (n << lg); base += WARP_RAYS) {
            const int item = base + tid, q = item & (P - 1);
            const bool act = item < (n << lg);
            const int ri = act ? st.list[c][item >> lg] : 0;
            float tl = BIG;
            int jl = CLUSTER, ran = 0;   // jl == CLUSTER: no candidate
            if (act) {
                const Ray x = load_ray(f, ray0 + ri);
                // the best this CTA knows: a candidate at equal t may
                // still win on its walk position, so equal t is taken
                // while the thread has none
                const float tcap = key_time(st.key[ri], x.tmax);
                for (int j = q; j < n_last; j += P) {
                    const Leaf l = leaf_test(x, tile + j * TSTRIDE);
                    ++ran;
                    if (leaf_inside(x, l)) {
                        const float tc = l.tn / fmaxf(l.ad, 1e-30f);
                        if (tc < x.tmax &&
                            (jl == CLUSTER ? tc <= tcap : tc < tl)) {
                            tl = tc;
                            jl = j;
                        }
                    }
                }
            }
            // the ray's P neighbouring lanes: least (t, slot)
            for (int o = 1; o < P; o <<= 1) {
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
                    const unsigned long long k =
                        (static_cast<unsigned long long>(f2o(tl)) << 32) |
                        ((pos << POS_SHIFT) | (c << 7) | jl);
                    if (k < st.key[ri]) st.key[ri] = k;
                }
                st.needed[ri] += n_real;
                st.ran[ri] += ran;
            }
        }
        cur ^= 1;
    }
    __syncthreads();   // the rays' state and the tiles are settled
}

// One super of an any-hit walk, boxes at `cb` (device memory for K2,
// the staged page in shared memory for the paged walk), cluster ids from
// cid0.  A ray leaves at its first hit.  Block-uniform.
__device__ __forceinline__ void visit_anyhit(
        const Ray &r, const float *cb, int cid0,
        const float *__restrict__ f, const float *__restrict__ attr,
        long long ray0, int *__restrict__ occ_word, SplitState &st) {
    const int tid = threadIdx.x, lane = tid & 31;
    const unsigned m =
        (r.live0 && st.tri[tid] < 0) ? slab16(r, cb, r.tmax) : 0u;
    unsigned bits = build_lists(m, cid0, attr, st);
    int cur = 0;
    while (bits) {
        const int c = __ffs(bits) - 1;
        bits &= bits - 1;
        const int cid = cid0 + c;
        int n_real, n_last;
        tile_ready(cur, st, n_real, n_last);
        if (bits) stage_cluster(attr, cid0 + __ffs(bits) - 1,
                                st.tile[cur ^ 1]);
        const float *tile = st.tile[cur];
        const int n = st.cnt[c][0] + st.cnt[c][1] + st.cnt[c][2] +
                      st.cnt[c][3];
        const int lg = group_log2(n), P = 1 << lg;
        const int g0 = lane & ~(P - 1);    // the group's first lane
        const unsigned gmask = (P == 32 ? 0xffffffffu : (1u << P) - 1u) << g0;
        for (int base = 0; base < (n << lg); base += WARP_RAYS) {
            const int item = base + tid, q = item & (P - 1);
            const int ri = item < (n << lg) ? st.list[c][item >> lg] : -1;
            // a ray occluded by an earlier cluster of this super leaves
            const bool act = ri >= 0 && st.tri[ri] < 0;
            Ray x;
            if (act) x = load_ray(f, ray0 + ri);
            int ran = 0, hit_slot = CLUSTER;
            bool done = !act;
            // round i tests slots i*P .. i*P+P-1, one a lane: the lowest
            // hit slot of the first round with a hit is the serial loop's
            for (int j0 = 0; j0 < n_last; j0 += P) {
                bool hit = false;
                if (!done && j0 + q < n_last) {
                    const Leaf l = leaf_test(x, tile + (j0 + q) * TSTRIDE);
                    ++ran;
                    hit = leaf_inside(x, l) & (l.tn < x.tmax * l.ad);
                }
                const unsigned hb = __ballot_sync(0xffffffffu, hit) & gmask;
                if (hb && !done) hit_slot = j0 + __ffs(hb >> g0) - 1;
                done = done || hb != 0u;
                if (__all_sync(0xffffffffu, done)) break;
            }
            for (int o = 1; o < P; o <<= 1)
                ran += __shfl_xor_sync(0xffffffffu, ran, o);
            if (act && q == 0) {
                if (hit_slot < CLUSTER) {
                    st.tri[ri] = cid * CLUSTER;
                    st.needed[ri] += hit_slot + 1;
                    // the other CTAs of the block drop the ray
                    occ_word[ray0 + ri] = cid * CLUSTER + 1;
                } else {
                    st.needed[ri] += n_real;
                }
                st.ran[ri] += ran;
            }
        }
        cur ^= 1;
    }
    __syncthreads();   // the rays' state and the tiles are settled
}

// Adds this CTA's test counts, then tells whether it is the last CTA of
// block `b` to finish (every other CTA's words and counts then visible).
__device__ __forceinline__ bool finish_cta(long long ray, long long R,
                                           int *__restrict__ tests_out,
                                           int *__restrict__ done_count,
                                           int b, int splits,
                                           SplitState &st) {
    const int tid = threadIdx.x;
    // integer counts: exact in whatever order the CTAs' atomics land
    if (st.needed[tid]) atomicAdd(tests_out + ray, st.needed[tid]);
    if (st.ran[tid]) atomicAdd(tests_out + R + ray, st.ran[tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0) st.last = atomicAdd(done_count + b, 1) == splits - 1;
    __syncthreads();
    if (!st.last) return false;
    __threadfence();
    return true;
}

// After a super of an any-hit walk: drop a ray another CTA of the block
// has found occluded (its word in device memory), then the block's bound,
// the largest t_max of its live rays that are not yet occluded.
__device__ __forceinline__ float anyhit_bound(const Ray &r, long long ray,
                                              const int *occ_words,
                                              int splits, SplitState &st) {
    const int tid = threadIdx.x;
    if (splits > 1 && r.live0 && st.tri[tid] < 0) {
        const int w = __ldcg(occ_words + ray);
        if (w) st.tri[tid] = w - 1;
    }
    return block_max(r.live0 && st.tri[tid] < 0 ? r.tmax : -BIG, st.red);
}

// The end of an any-hit walk: the block's last CTA decodes each ray's
// occluded word into t (-3e38 where occluded, else t_max) and tri.
__device__ __forceinline__ void anyhit_finish(
        const Ray &r, long long ray, long long R, float *__restrict__ t_out,
        int *__restrict__ tri_out, int *__restrict__ tests_out,
        const int *occ_words, int *__restrict__ done_count, int b,
        int splits, SplitState &st) {
    if (!finish_cta(ray, R, tests_out, done_count, b, splits, st)) return;
    const int w = __ldcg(occ_words + ray);
    t_out[ray] = w ? -BIG : r.tmax;
    tri_out[ray] = w - 1;
}

// K1 and K3's closest hit: the warp's entry-sorted list, CTA s of the
// block's `splits` taking positions s, s + splits, ...
__global__ void __launch_bounds__(WARP_RAYS)
wave_trace_closest_kernel(const float *__restrict__ f,      // (R, 16)
                          const float *__restrict__ sent,   // (R/128, nsp)
                          const int *__restrict__ sids,     // (R/128, nsp)
                          const float *__restrict__ cbox,   // (NCp, 8)
                          const float *__restrict__ attr,   // (NCp*16, 128)
                          float *__restrict__ t_out,        // (R,)
                          int *__restrict__ tri_out,        // (R,)
                          int *__restrict__ tests_out,      // (2, R), zeros
                          unsigned long long *__restrict__ words,  // (R,)
                          int *__restrict__ done_count,     // (R/128,)
                          int nsp, int nsup, int splits) {
    __shared__ __align__(16) SplitState st;
    const int tid = threadIdx.x;
    const int b = blockIdx.x / splits, s = blockIdx.x % splits;
    const long long R = (long long)gridDim.x / splits * WARP_RAYS;
    const long long ray0 = (long long)b * WARP_RAYS, ray = ray0 + tid;
    const Ray r = load_ray(f, ray);
    st.key[tid] = NO_HIT;
    st.needed[tid] = 0;
    st.ran[tid] = 0;
    const float *srow = sent + (long long)b * nsp;
    const int *irow = sids + (long long)b * nsp;

    float bound = block_max(r.live0 ? r.tmax : -BIG, st.red);
    for (int k = s; k < nsp; k += splits) {
        if (!(srow[k] <= bound)) break;   // sorted: no later super can help
        const int sid = min(irow[k], nsup - 1);
        visit_closest(r, cbox + (long long)sid * SUP * 8, sid * SUP, k, f,
                      attr, ray0, st);
        if (splits > 1 && r.live0) {
            // publish this CTA's best and take the block's
            const unsigned long long g =
                ~atomicMax(words + ray, ~st.key[tid]);
            if (g < st.key[tid]) st.key[tid] = g;
        }
        bound = block_max(r.live0 ? key_time(st.key[tid], r.tmax) : -BIG,
                          st.red);
    }
    if (splits == 1) {
        words[ray] = ~st.key[tid];
    } else if (r.live0) {
        atomicMax(words + ray, ~st.key[tid]);
    }
    if (!finish_cta(ray, R, tests_out, done_count, b, splits, st)) return;
    const unsigned long long key = ~__ldcg(words + ray);
    int tri = -1;
    if (key != NO_HIT) {
        const unsigned low = static_cast<unsigned>(key);
        const int sid = min(irow[low >> POS_SHIFT], nsup - 1);
        tri = (sid * SUP + ((low >> 7) & (SUP - 1))) * CLUSTER +
              (low & (CLUSTER - 1));
    }
    t_out[ray] = key_time(key, r.tmax);
    tri_out[ray] = tri;
}

// K2 and K3's any hit: the warp's entry-sorted list, CTA s of the
// block's `splits` taking positions s, s + splits, ...
__global__ void __launch_bounds__(WARP_RAYS)
wave_trace_anyhit_kernel(const float *__restrict__ f,      // (R, 16)
                         const float *__restrict__ sent,   // (R/128, nsp)
                         const int *__restrict__ sids,     // (R/128, nsp)
                         const float *__restrict__ cbox,   // (NCp, 8)
                         const float *__restrict__ attr,   // (NCp*16, 128)
                         float *__restrict__ t_out,        // (R,)
                         int *__restrict__ tri_out,        // (R,)
                         int *__restrict__ tests_out,      // (2, R), zeros
                         int *__restrict__ occ_words,      // (R,) zeros
                         int *__restrict__ done_count,     // (R/128,)
                         int nsp, int nsup, int splits) {
    __shared__ __align__(16) SplitState st;
    const int tid = threadIdx.x;
    const int b = blockIdx.x / splits, s = blockIdx.x % splits;
    const long long R = (long long)gridDim.x / splits * WARP_RAYS;
    const long long ray0 = (long long)b * WARP_RAYS, ray = ray0 + tid;
    const Ray r = load_ray(f, ray);
    st.tri[tid] = -1;
    st.needed[tid] = 0;
    st.ran[tid] = 0;
    const float *srow = sent + (long long)b * nsp;
    const int *irow = sids + (long long)b * nsp;

    float bound = block_max(r.live0 ? r.tmax : -BIG, st.red);
    for (int k = s; k < nsp; k += splits) {
        if (!(srow[k] <= bound)) break;   // sorted: no later super can help
        const int sid = min(irow[k], nsup - 1);
        visit_anyhit(r, cbox + (long long)sid * SUP * 8, sid * SUP, f, attr,
                     ray0, occ_words, st);
        bound = anyhit_bound(r, ray, occ_words, splits, st);
    }
    anyhit_finish(r, ray, R, t_out, tri_out, tests_out, occ_words,
                  done_count, b, splits, st);
}

// The paged any-hit walk: CTA s of the block's `splits` taking page
// slots s, s + splits, ...
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
                               int *__restrict__ tests_out,    // zeros
                               int *__restrict__ occ_words,    // (R,) zeros
                               int *__restrict__ done_count,   // (R/128,)
                               int nsp, int n_slots, int ncp, int page_sup,
                               int splits) {
    __shared__ __align__(16) SplitState st;
    __shared__ __align__(16) float pcb[MAX_PAGE_CLUSTERS * 8];
    const int tid = threadIdx.x;
    const int b = blockIdx.x / splits, s = blockIdx.x % splits;
    const long long R = (long long)gridDim.x / splits * WARP_RAYS;
    const long long ray0 = (long long)b * WARP_RAYS, ray = ray0 + tid;
    const Ray r = load_ray(f, ray);
    st.tri[tid] = -1;
    st.needed[tid] = 0;
    st.ran[tid] = 0;

    const int page_cl = page_sup * SUP;
    const int nsup = (ncp + page_cl - 1) / page_cl * page_sup;
    const float *srow = sent + (long long)b * nsp;
    const int *irow = sids + (long long)b * nsp;
    const int *prow = pages + (long long)(b / 8) * n_slots;
    const int *srng = offs + (long long)b * n_slots;
    const int *erng = offe + (long long)b * n_slots;

    float bound = block_max(r.live0 ? r.tmax : -BIG, st.red);
    for (int p = s; p < n_slots; p += splits) {
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
            visit_anyhit(r, pcb + sid_local * SUP * 8,
                         page * page_cl + sid_local * SUP, f, attr, ray0,
                         occ_words, st);
            bound = anyhit_bound(r, ray, occ_words, splits, st);
        }
    }
    anyhit_finish(r, ray, R, t_out, tri_out, tests_out, occ_words,
                  done_count, b, splits, st);
}

}  // namespace

extern "C" {

// Launches one mode of the resident walk on `stream`, the block's walk
// split over `splits` CTAs: closest hit (K1; `words` a 64-bit key a ray)
// or any hit (K2; `words` an occluded word a ray), words, done_count and
// tests zero-filled by the caller.  Returns cudaGetLastError() (0 = ok).
int wave_trace_launch(const void *f, const void *sent, const void *sids,
                      const void *cbox, const void *attr, void *t_out,
                      void *tri_out, void *tests_out, void *words,
                      void *done_count, int n_blocks, int nsp, int nsup,
                      int any_hit, int splits, void *stream) {
    if (n_blocks <= 0) return 0;
    if (splits < 1 || splits > MAX_SPLITS || nsp >= (1 << (32 - POS_SHIFT)) ||
        (long long)n_blocks * splits >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const float *F = static_cast<const float *>(f);
    const float *SE = static_cast<const float *>(sent);
    const int *SI = static_cast<const int *>(sids);
    const float *CB = static_cast<const float *>(cbox);
    const float *AT = static_cast<const float *>(attr);
    float *T = static_cast<float *>(t_out);
    int *TR = static_cast<int *>(tri_out);
    int *TS = static_cast<int *>(tests_out);
    if (any_hit)
        wave_trace_anyhit_kernel<<<n_blocks * splits, WARP_RAYS, 0, st>>>(
            F, SE, SI, CB, AT, T, TR, TS, static_cast<int *>(words),
            static_cast<int *>(done_count), nsp, nsup, splits);
    else
        wave_trace_closest_kernel<<<n_blocks * splits, WARP_RAYS, 0, st>>>(
            F, SE, SI, CB, AT, T, TR, TS,
            static_cast<unsigned long long *>(words),
            static_cast<int *>(done_count), nsp, nsup, splits);
    return static_cast<int>(cudaGetLastError());
}

// Launches the paged any-hit walk (n_blocks = R/128, a multiple of 8;
// page_sup * 16 <= 256; occ_words, done_count and tests zero-filled by
// the caller) on `stream`, the block's page slots split over `splits`
// CTAs; returns cudaGetLastError().
int wave_trace_paged_launch(const void *f, const void *sent, const void *sids,
                            const void *pages, const void *offs,
                            const void *offe, const void *cbox,
                            const void *attr, void *t_out, void *tri_out,
                            void *tests_out, void *occ_words,
                            void *done_count, int n_blocks, int nsp,
                            int n_slots, int ncp, int page_sup, int splits,
                            void *stream) {
    if (n_blocks <= 0) return 0;
    if (n_blocks % 8 || page_sup <= 0 || page_sup * SUP > MAX_PAGE_CLUSTERS ||
        splits < 1 || splits > MAX_SPLITS ||
        (long long)n_blocks * splits >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    wave_trace_paged_anyhit_kernel<<<n_blocks * splits, WARP_RAYS, 0,
                                     reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float *>(f), static_cast<const float *>(sent),
        static_cast<const int *>(sids), static_cast<const int *>(pages),
        static_cast<const int *>(offs), static_cast<const int *>(offe),
        static_cast<const float *>(cbox), static_cast<const float *>(attr),
        static_cast<float *>(t_out), static_cast<int *>(tri_out),
        static_cast<int *>(tests_out), static_cast<int *>(occ_words),
        static_cast<int *>(done_count), nsp, n_slots, ncp, page_sup, splits);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
