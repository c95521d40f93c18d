// The curve-piece walk for Hopper (sm_90a): kernel C1.
//
// curve_trace_kernel replaces tungsten_tpu/ops/intersect.py::
// _curve_traverse, which is not a Pallas kernel but a plain XLA
// while_loop: a stackless skip-pointer walk over the binary curve-piece
// BVH (scene/flatten.py::_build_curve_tables), where a box hit descends
// (node + 1) and a miss jumps skip[node], and a leaf tests its up to
// MAX_LEAF = 4 linear pieces (each 1/8 of a quadratic B-spline segment)
// in order with the reference's half-cylinder chord test (Curves.cpp:
// 51-94) or, for a ribbon segment, the ribbon test (Curves.cpp:96-133),
// in a ray-aligned frame (lx, ly, d).  Every formula is the JAX walk's in
// the same order of operations, with one exception: nvcc contracts
// multiply-adds into fused ones (XLA does so on the JAX CPU walk too), so
// a hit on a width edge or a piece joint may flip against the plain walk.
//
// What bounds it.  A walk is a chain of dependent loads: the next node
// depends on this one's test.  The hair scene's curve tables (3.4M
// pieces, 2.3M binary nodes) are far past the 50 MB L2, so a deep ray
// waits on device memory at every step, and a narrow launch (a render's
// late bounces: 1,024 to 16,384 rays) has too few rays to hide it: its
// time is the chain of its slowest ray.  The test arithmetic (~100 f32
// operations a piece) and the rows' bytes are far below what the card
// could do in that time.
//
// Design, one answer to each of the three things that held the binary
// skip walk back:
//  * Fewer dependent steps: the binary BVH is collapsed into a 4-wide one
//    (scene/bvh.py::collapse_wide, packed by flatten.py::
//    wide_curve_rows), each child's box stored in its parent's 128-byte
//    row [min xyz, word | max xyz, end] x 4 (word: first_piece * 8 +
//    count for a leaf, node * 8 for an interior child, 0 for an empty
//    slot; end: one past the child's last piece), so one visit is eight
//    independent 16-byte loads that replace about two dependent binary
//    levels, and a leaf's box comes with its parent.
//  * A stack walk that culls late: a visit slab-tests the four child
//    boxes against the ray's best t (the JAX walk's slab test and its
//    1.00000024 slack) and pushes every child it hits, leaves included,
//    as (near t, word); a popped entry is dropped when its near t now
//    exceeds the best t, else a leaf's pieces are tested or a node is
//    visited.  Any hit pops the nearest child first, to reach an
//    occluder early.  Closest hit pops in slot order, which is the
//    serial walk's depth-first order, and not nearest first: the
//    cylinder test accepts hits past a piece's end, outside its box, so
//    which hits a walk finds depends on what its order culls, and a
//    near-first order lost the serial walk's hit on too many hair rays
//    for the 0.9999 gates of chip_smoke.py.  In depth-first order each
//    box meets, when popped, the serial walk's own test with the serial
//    walk's best t (a collapsed binary box culls only what its
//    children's boxes cull), so t, seg, u and v are the serial walk's,
//    while the visits are the wide tree's.  The stack's top SHORT
//    entries sit in shared memory (a column a thread); deeper entries
//    spill to a per-thread local array, and the spills are counted.
//    (Prefetching a hit child's rows into L2 and 16 entries in shared
//    memory were tried and measured slower at full width.)
//  * Any depth: a ray whose stack would pass `cap` entries (at most
//    STACK) leaves its walk and walks again from the root, out of line
//    (walk_deep, so that the walk every ray runs keeps its registers and
//    code), depth first in both modes.  That walk keeps `pos`, one past
//    the last piece of what it has finished (a leaf tested, an entry
//    culled, a node with nothing to push); where its stack would pass
//    `cap` it drops its deepest cap - SHORT entries, which are the last
//    in depth-first order, and when the stack runs empty it starts again
//    at the root and skips every child whose pieces all lie below `pos`.
//    So it goes on in the serial walk's order: a box tested again on the
//    way down culls only what its children's boxes would (they lie
//    inside it), and a piece tested again cannot beat itself, so a
//    closest hit does not change.  Nor does whether an any hit hits (its
//    best t stays t_max until it stops), though which hit it meets first
//    may.  The restarts are counted; a tree packs at any depth.
//  * Several lanes a ray on narrow launches: a group of G = 1, 2 or 4
//    neighbouring lanes shares a ray (the host picks G from the mode, the
//    launch width and the SM count, ops/curve_trace.py::curve_lanes: 4
//    for every closest hit, whose long walks diverge most); lane j
//    slab-tests child j (children j, j+G, ... for G < 4) and tests the
//    pieces j, j+G, ... of a leaf, and the group exchanges the child
//    tests and its best hit with warp shuffles.  Every lane keeps the
//    same stack, so the group walks in lockstep.
//
// The serial tie rule in any grouping.  A closest hit keeps the least
// (t, piece index) over the pieces that pass the piece test, compared
// as floats and then indices: pieces lie in the BVH's depth-first order,
// so a piece's index is its place in the serial walk, whose strict
// t < best keeps the earliest of equal t (equal zeros tie there too,
// which a comparison of t's bits would split).  The best after a leaf
// is the least of the best before and the leaf's candidates whichever
// lane tests which piece, so the nodes visited, t, seg, u, v and hit are
// the same bitwise for every G.  Any hit stops at the first hit in piece
// order of the first leaf with a hit (the lowest hit lane of the first
// round with a hit), also the same for every G.  A ray whose far limit
// is not above t_min visits nothing.  On request (a second instance of
// the kernel, STATS, so that a render's launch neither counts nor stores
// what it does not read) the walk counts per ray its node visits, piece
// tests (an any-hit ray's up to its hit), stack spills, child boxes
// tested (the occupied slots of the nodes visited) and restarts, and
// marks the node and piece rows it read (the bound of chip_smoke.py
// counts the distinct rows a run needs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CTA = 64;         // threads a CTA
constexpr int WIDE = 4;         // children a node
constexpr int NODE_F4 = 8;      // float4 a node row (flatten.py CWBVH_ROW)
constexpr int PIECE_F4 = 4;     // float4 a piece row (flatten.py CRV_ROW)
constexpr int MAX_LEAF = 4;     // pieces a leaf
constexpr int SHORT = 8;        // stack entries a thread keeps in shared memory
constexpr int STACK = 64;       // the most stack entries (ops/curve_trace.py)
constexpr int MODE_RIBBON = 3;
constexpr float SLACK = 1.00000024f;
constexpr unsigned long long NONE = ~0ull;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct Ray {
    V3 o, d, lx, ly, inv;
    float tmin;
};

// world point -> the ray frame (ref Curves.cpp:433-442)
__device__ __forceinline__ V3 proj(const Ray &r, V3 p) {
    V3 q = sub(p, r.o);
    return {dot(q, r.lx), dot(q, r.ly), dot(q, r.d)};
}

// A ray's best hit; piece -1 while nothing hit.
struct Best {
    float t, u, v;
    int seg, piece;
};

// (t, piece) before the best's in the serial walk's order
__device__ __forceinline__ bool beats(float t, int piece, const Best &b) {
    return t < b.t || (t == b.t && piece < b.piece);
}

// Piece `piece` against the ray; updates b and returns true where the
// piece wins.
__device__ __forceinline__ bool piece_test(const Ray &r, const float4 *rows,
                                           int piece, Best &b) {
    const float4 *row = rows + static_cast<size_t>(piece) * PIECE_F4;
    const float4 a = __ldg(row + 0);
    const float4 c = __ldg(row + 1);
    const float4 n = __ldg(row + 2);
    const float4 e = __ldg(row + 3);
    const V3 e0 = proj(r, {a.x, a.y, a.z});
    const V3 e1 = proj(r, {c.x, c.y, c.z});
    const float w0 = a.w, w1 = c.w;
    const float pt0 = n.w, pt1 = e.x;
    const int seg = __float_as_int(e.y);
    const int mode = __float_as_int(e.z);
    bool ok;
    float t_hit, u_hit, v_hit;
    if (mode != MODE_RIBBON) {
        // half-cylinder chord test (Curves.cpp:51-94)
        const float vx = e1.x - e0.x, vy = e1.y - e0.y;
        const float lsq = vx * vx + vy * vy;
        const float inv_lsq = 1.0f / fmaxf(lsq, 1e-30f);
        const float seg_t = -(e0.x * vx + e0.y * vy) * inv_lsq;
        const float sgn = e0.x * vy - e0.y * vx;
        const float dist = fabsf(sgn) * sqrtf(inv_lsq);
        const float width = w0 * (1.0f - seg_t) + w1 * seg_t;
        const float depth = e0.z * (1.0f - seg_t) + e1.z * seg_t;
        const float dz = e1.z - e0.z;
        const float y_sq = width * width - dist * dist;
        const float l_sq = y_sq * (1.0f + dz * dz * inv_lsq);
        const float delta = sqrtf(fmaxf(l_sq, 0.0f));
        const float t0 = depth - delta;
        const V3 v3 = sub(e0, e1);
        const float lsq3 = fmaxf(dot(v3, v3), 1e-30f);
        const V3 e0z = {e0.x, e0.y, e0.z - t0};
        const float seg_t2 = dot(e0z, v3) / lsq3;
        const float new_t = seg_t2 * (pt1 - pt0) + pt0;
        ok = (dist <= width) && (seg_t2 >= 0.0f) && beats(t0, piece, b) &&
             (t0 > r.tmin) && (new_t >= 0.0f) && (new_t <= 1.0f);
        t_hit = t0;
        u_hit = new_t;
        v_hit = 0.5f + 0.5f * dist / fmaxf(width, 1e-30f);
    } else {
        // ribbon test (Curves.cpp:96-133); nmid is a vector, projected
        // as (nmid + o) - o as the JAX walk rounds it
        const V3 nm = proj(r, add({n.x, n.y, n.z}, r.o));
        const V3 v3d = sub(e1, e0);
        const float lsq_r = dot(v3d, v3d);
        const float inv_r = 1.0f / fmaxf(lsq_r, 1e-30f);
        const float s = dot(v3d, nm) * inv_r;
        const V3 nr = {v3d.x * s - nm.x, v3d.y * s - nm.y, v3d.z * s - nm.z};
        const float den = fabsf(nr.z) < 1e-20f ? 1e-20f : nr.z;
        const float t0r = dot(nr, e0) / den;
        const V3 lp = {-e0.x, -e0.y, t0r - e0.z};
        const float seg_tr = dot(lp, v3d) * inv_r;
        const float width_r = w0 * (1.0f - seg_tr) + w1 * seg_tr;
        const V3 dv = {lp.x - v3d.x * seg_tr, lp.y - v3d.y * seg_tr,
                       lp.z - v3d.z * seg_tr};
        const float dist_sq = dot(dv, dv);
        const float new_tr = seg_tr * (pt1 - pt0) + pt0;
        ok = (t0r >= r.tmin) && beats(t0r, piece, b) && (seg_tr >= 0.0f) &&
             (seg_tr <= 1.0f) && (dist_sq <= width_r * width_r) &&
             (new_tr >= 0.0f) && (new_tr <= 1.0f);
        t_hit = t0r;
        u_hit = new_tr;
        v_hit = 0.0f;
    }
    if (ok) b = {t_hit, u_hit, v_hit, seg, piece};
    return ok;
}

// one past the last piece under a node: the largest end of its row
__device__ __forceinline__ int node_end(const float4 *nodes, int node) {
    const float4 *row = nodes + static_cast<size_t>(node) * NODE_F4;
    int e = 0;
#pragma unroll
    for (int c = 0; c < WIDE; ++c)
        e = max(e, __float_as_int(__ldg(row + 2 * c + 1).w));
    return e;
}

__device__ __forceinline__ float safe_inv(float x) {
    return 1.0f / (fabsf(x) < 1e-20f ? (x >= 0.0f ? 1e-20f : -1e-20f) : x);
}

// order-preserving map of a float's bits to an unsigned, and back
__device__ __forceinline__ unsigned f2o(float t) {
    const unsigned u = __float_as_uint(t);
    return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float o2f(unsigned u) {
    return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ void order2(unsigned long long &a,
                                       unsigned long long &b) {
    const unsigned long long lo = a < b ? a : b;
    b = a < b ? b : a;
    a = lo;
}

// Shuffles within a group of G lanes (identity for G = 1).
template <int G, typename T>
__device__ __forceinline__ T from(unsigned gmask, T v, int src) {
    if constexpr (G == 1) return v;
    else return __shfl_sync(gmask, v, src, G);
}

template <int G>
__device__ __forceinline__ Best best_from(unsigned gmask, const Best &b,
                                          int src) {
    return {from<G>(gmask, b.t, src), from<G>(gmask, b.u, src),
            from<G>(gmask, b.v, src), from<G>(gmask, b.seg, src),
            from<G>(gmask, b.piece, src)};
}

// Per-ray statistics of the walk (ops/curve_trace.py COUNTS).
struct Counts {
    int visits, tests, spills, boxes, restarts;
};

// The CTA's stack tops in shared memory, a column a thread.
__shared__ unsigned long long top[SHORT][CTA];

// The walk from the root, with the ray's best hit so far in b.
// DEEP = false: the walk a ray starts with (any hit pops nearest first,
// closest hit depth first); it returns true, leaving its stack, where a
// push would pass `cap` entries, and false when it is done.  DEEP = true:
// the walk that takes over then, from the root again and depth first in
// both modes, with pos from the start: it drops and restarts as the
// source note says, and returns false.  STATS: count into n and mark the
// rows read in node_mark and piece_mark (a render's launch does none of
// it).
template <int G, bool DEEP, bool STATS>
__device__ __forceinline__ bool walk(const Ray &r, Best &b, int any_hit,
                                     int cap,
                                     const float4 *__restrict__ N,
                                     const float4 *__restrict__ P,
                                     uint8_t *node_mark,
                                     uint8_t *piece_mark, int lane,
                                     unsigned gmask, Counts &n) {
    const int tid = threadIdx.x;
    unsigned long long spill[STACK - SHORT];
    int node = 0, sp = 0;
    bool visit = true;
    bool again = false;   // DEEP: entries dropped since the last start
    int pos = 0;          // DEEP: the pieces below pos are finished
    while (true) {
        if (visit) {
            // this lane's children: slab tests against the best t
            const float4 *row = N + static_cast<size_t>(node) * NODE_F4;
            if constexpr (STATS) {   // the occupied slots, each a box test
                ++n.visits;
                if (lane == 0) node_mark[node] = 1;
#pragma unroll
                for (int c = 0; c < WIDE; ++c)
                    n.boxes += __float_as_int(__ldg(row + 2 * c).w) > 0;
            }
            float tn_l[WIDE / G];
            int word_l[WIDE / G];
#pragma unroll
            for (int k = 0; k < WIDE / G; ++k) {
                const int c = lane + k * G;
                const float4 lo = __ldg(row + 2 * c);
                const float4 hi = __ldg(row + 2 * c + 1);
                const float t0x = (lo.x - r.o.x) * r.inv.x;
                const float t0y = (lo.y - r.o.y) * r.inv.y;
                const float t0z = (lo.z - r.o.z) * r.inv.z;
                const float t1x = (hi.x - r.o.x) * r.inv.x;
                const float t1y = (hi.y - r.o.y) * r.inv.y;
                const float t1z = (hi.z - r.o.z) * r.inv.z;
                const float t_near = fmaxf(
                    fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                          fminf(t0z, t1z)), 0.0f);
                const float t_far = fminf(
                    fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z)), b.t);
                int w = __float_as_int(lo.w);
                // after a restart a child whose pieces are all finished
                // (end <= pos) is not pushed again
                if (DEEP && __float_as_int(hi.w) <= pos) w = 0;
                tn_l[k] = t_near;
                word_l[k] = (w > 0 && t_near <= t_far * SLACK) ? w : 0;
            }
            // every lane learns every child's result: an entry
            // (near t's bits, word) a child hit
            unsigned long long key[WIDE];
#pragma unroll
            for (int c = 0; c < WIDE; ++c) {
                const float tn = from<G>(gmask, tn_l[c / G], c % G);
                const int w = from<G>(gmask, word_l[c / G], c % G);
                key[c] = w > 0 ? (static_cast<unsigned long long>(f2o(tn))
                                  << 32) | static_cast<unsigned>(w)
                               : NONE;
            }
            if (!DEEP && any_hit) {   // nearest first; misses (NONE) last
                order2(key[0], key[1]);
                order2(key[2], key[3]);
                order2(key[0], key[2]);
                order2(key[1], key[3]);
                order2(key[1], key[2]);
            }
            // a node with nothing to push is finished
            if (DEEP && (key[0] & key[1] & key[2] & key[3]) == NONE)
                pos = node_end(N, node);
            // push them so that the first in order is on top
#pragma unroll
            for (int c = WIDE - 1; c >= 0; --c) {
                if (key[c] == NONE) continue;
                if (sp == cap) {
                    if (!DEEP) return true;
                    sp -= cap - SHORT;   // drop the deepest entries
                    again = true;
                }
                const int s = sp & (SHORT - 1);
                if (sp >= SHORT) {
                    spill[sp - SHORT] = top[s][tid];
                    if constexpr (STATS) ++n.spills;
                }
                top[s][tid] = key[c];
                ++sp;
            }
        }
        if (sp == 0) {
            if (!again) return false;
            again = false;   // start again at the root, past pos
            if constexpr (STATS) ++n.restarts;
            node = 0;
            visit = true;
            continue;
        }
        --sp;
        const int s = sp & (SHORT - 1);
        const unsigned long long k = top[s][tid];
        if (sp >= SHORT) top[s][tid] = spill[sp - SHORT];
        // the box test again against the best t as it stands now
        visit = false;
        const int w = static_cast<int>(k & 0xffffffffu);
        const int cnt = w & 7;
        if (o2f(static_cast<unsigned>(k >> 32)) > b.t * SLACK) {
            if (DEEP) pos = cnt ? (w >> 3) + cnt : node_end(N, w >> 3);
            continue;
        }
        if (cnt == 0) {
            node = w >> 3;
            visit = true;
            continue;
        }
        // a leaf: lane j tests its pieces j, j+G, ...
        const int first = w >> 3;
        if (any_hit) {
#pragma unroll
            for (int base = 0; base < MAX_LEAF; base += G) {
                if (base >= cnt) break;
                const int p = base + lane;
                bool ok = false;
                if (p < cnt) {
                    if constexpr (STATS) piece_mark[first + p] = 1;
                    ok = piece_test(r, P, first + p, b);
                }
                unsigned hits;
                if constexpr (G > 1)
                    hits = (__ballot_sync(gmask, ok) & gmask) >>
                           ((tid & 31) & ~(G - 1));
                else
                    hits = ok ? 1u : 0u;
                if (hits) {   // the first hit in piece order
                    const int src = __ffs(hits) - 1;
                    b = best_from<G>(gmask, b, src);
                    if constexpr (STATS) n.tests += base + src + 1;
                    return false;
                }
            }
            if constexpr (STATS) n.tests += cnt;
        } else {
#pragma unroll
            for (int base = 0; base < MAX_LEAF; base += G) {
                const int p = base + lane;
                if (p < cnt) {
                    if constexpr (STATS) piece_mark[first + p] = 1;
                    piece_test(r, P, first + p, b);
                }
            }
            if constexpr (STATS) n.tests += cnt;
            // the group's best: the least (t, piece) of its lanes'
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                const Best x = {
                    __shfl_xor_sync(gmask, b.t, off, G),
                    __shfl_xor_sync(gmask, b.u, off, G),
                    __shfl_xor_sync(gmask, b.v, off, G),
                    __shfl_xor_sync(gmask, b.seg, off, G),
                    __shfl_xor_sync(gmask, b.piece, off, G)};
                if (beats(x.t, x.piece, b)) b = x;
            }
        }
        if (DEEP) pos = first + cnt;
    }
}

// A ray's best hit and statistics, handed to the deep walk and back.
struct Walked {
    Best b;
    Counts n;
};

// The deep walk out of line, so that the walk every ray runs first keeps
// its own registers and code.
template <int G, bool STATS>
__device__ __noinline__ void walk_deep(const Ray &r, Walked &w, int any_hit,
                                       int cap, const float4 *N,
                                       const float4 *P, uint8_t *node_mark,
                                       uint8_t *piece_mark, int lane,
                                       unsigned gmask) {
    walk<G, true, STATS>(r, w.b, any_hit, cap, N, P, node_mark, piece_mark,
                         lane, gmask, w.n);
}

template <int G, bool STATS>
__global__ void __launch_bounds__(CTA)
curve_trace_kernel(const float *__restrict__ o, const float *__restrict__ d,
                   const float *__restrict__ t_min,
                   const float *__restrict__ t_max,
                   const float *__restrict__ pieces,
                   const float *__restrict__ nodes, int n_rays, int any_hit,
                   int cap, float *__restrict__ t_out,
                   int *__restrict__ seg_out,
                   float *__restrict__ u_out, float *__restrict__ v_out,
                   uint8_t *__restrict__ hit_out, int *__restrict__ counts,
                   uint8_t *__restrict__ node_mark,
                   uint8_t *__restrict__ piece_mark) {
    const int tid = threadIdx.x;
    const long long g = (static_cast<long long>(blockIdx.x) * CTA + tid) / G;
    if (g >= n_rays) return;   // a whole group: CTA is a multiple of G
    const int i = static_cast<int>(g);
    const int lane = tid & (G - 1);
    const unsigned gmask = static_cast<unsigned>((1ull << G) - 1)
                           << ((tid & 31) & ~(G - 1));
    Ray r;
    r.o = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    r.d = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    r.tmin = t_min[i];
    Best b = {t_max[i], 0.0f, 0.0f, -1, -1};
    Counts n = {0, 0, 0, 0, 0};
    if (b.t > r.tmin) {
        r.inv = {safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z)};
        const float dxz = sqrtf(r.d.x * r.d.x + r.d.z * r.d.z);
        if (dxz == 0.0f) {
            r.lx = {1.0f, 0.0f, 0.0f};
            r.ly = {0.0f, 0.0f, -r.d.y};
        } else {
            const float sd = fmaxf(dxz, 1e-20f);
            r.lx = {r.d.z / sd, 0.0f, -r.d.x / sd};
            r.ly = {r.lx.z * r.d.y, dxz, -r.d.y * r.lx.x};
        }
        const float4 *N = reinterpret_cast<const float4 *>(nodes);
        const float4 *P = reinterpret_cast<const float4 *>(pieces);
        if (walk<G, false, STATS>(r, b, any_hit, cap, N, P, node_mark,
                                  piece_mark, lane, gmask, n)) {
            if constexpr (STATS) ++n.restarts;
            // copies: a variable whose address a call takes lives in
            // local memory for the whole kernel, the walk above included
            const Ray rc = r;
            Walked w = {b, n};
            walk_deep<G, STATS>(rc, w, any_hit, cap, N, P, node_mark,
                                piece_mark, lane, gmask);
            b = w.b;
            n = w.n;
        }
    }
    if (lane != 0) return;
    t_out[i] = b.t;
    seg_out[i] = b.seg;
    u_out[i] = b.u;
    v_out[i] = b.v;
    hit_out[i] = b.piece >= 0 ? 1 : 0;
    if constexpr (STATS) {
        counts[i] = n.visits;
        counts[n_rays + i] = n.tests;
        counts[2 * n_rays + i] = n.spills;
        counts[3 * n_rays + i] = n.boxes;
        counts[4 * n_rays + i] = n.restarts;
    }
}

template <int G>
void launch(const void *o, const void *d, const void *t_min,
            const void *t_max, const void *pieces, const void *nodes,
            int n_rays, int any_hit, int cap, void *t_out, void *seg_out,
            void *u_out, void *v_out, void *hit_out, void *counts,
            void *node_mark, void *piece_mark, cudaStream_t st) {
    const long long threads = static_cast<long long>(n_rays) * G;
    const int grid = static_cast<int>((threads + CTA - 1) / CTA);
    const auto kernel = counts ? curve_trace_kernel<G, true>
                               : curve_trace_kernel<G, false>;
    kernel<<<grid, CTA, 0, st>>>(
        static_cast<const float *>(o), static_cast<const float *>(d),
        static_cast<const float *>(t_min), static_cast<const float *>(t_max),
        static_cast<const float *>(pieces), static_cast<const float *>(nodes),
        n_rays, any_hit, cap, static_cast<float *>(t_out),
        static_cast<int *>(seg_out), static_cast<float *>(u_out),
        static_cast<float *>(v_out), static_cast<uint8_t *>(hit_out),
        static_cast<int *>(counts), static_cast<uint8_t *>(node_mark),
        static_cast<uint8_t *>(piece_mark));
}

}  // namespace

extern "C" {

// Launches C1 on `stream` over n_rays rays with `lanes` (1, 2 or 4)
// lanes a ray and at most `cap` stack entries (a multiple of SHORT in
// (SHORT, STACK]): o, d (n_rays, 3), t_min and t_max (n_rays,) f32;
// pieces (Cp, 16) and nodes (M, 32) the packed rows (flatten.py::
// pack_curve_rows); outputs t, seg, u, v, hit (n_rays,); counts
// (5, n_rays) (node visits, piece tests, stack spills, child
// boxes tested, restarts) and node_mark / piece_mark (M,) / (Cp,) bytes
// set to 1 where a row was read, all three or none (null; a kernel
// without the statistics runs then).  Returns cudaGetLastError() (0 =
// ok).
int curve_trace_launch(const void *o, const void *d, const void *t_min,
                       const void *t_max, const void *pieces,
                       const void *nodes, int n_rays, int any_hit, int lanes,
                       int cap, void *t_out, void *seg_out, void *u_out,
                       void *v_out, void *hit_out, void *counts,
                       void *node_mark, void *piece_mark, void *stream) {
    if (n_rays <= 0) return 0;
    if (cap <= SHORT || cap > STACK || cap % SHORT != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (lanes) {
        case 1:
            launch<1>(o, d, t_min, t_max, pieces, nodes, n_rays, any_hit,
                      cap, t_out, seg_out, u_out, v_out, hit_out, counts,
                      node_mark, piece_mark, st);
            break;
        case 2:
            launch<2>(o, d, t_min, t_max, pieces, nodes, n_rays, any_hit,
                      cap, t_out, seg_out, u_out, v_out, hit_out, counts,
                      node_mark, piece_mark, st);
            break;
        case 4:
            launch<4>(o, d, t_min, t_max, pieces, nodes, n_rays, any_hit,
                      cap, t_out, seg_out, u_out, v_out, hit_out, counts,
                      node_mark, piece_mark, st);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
