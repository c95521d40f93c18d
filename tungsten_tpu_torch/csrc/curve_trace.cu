// The curve-piece walk for Hopper (sm_90a): kernel C1.
//
// curve_trace_kernel replaces tungsten_tpu/ops/intersect.py::
// _curve_traverse, which is not a Pallas kernel but a plain XLA
// while_loop: a stackless skip-pointer walk over the curve-piece BVH
// (scene/flatten.py::_build_curve_tables), where a box hit descends
// (node + 1) and a miss jumps skip[node], and a leaf tests its up to
// MAX_LEAF = 4 linear pieces (each 1/8 of a quadratic B-spline segment)
// in order with the reference's half-cylinder chord test (Curves.cpp:
// 51-94) or, for a ribbon segment, the ribbon test (Curves.cpp:96-133),
// in a ray-aligned frame (lx, ly, d).  Every formula is the JAX walk's in
// the same order of operations, with one exception: nvcc contracts
// multiply-adds into fused ones (XLA does so on the JAX CPU walk too), so
// a hit on a width edge or a piece joint may flip against the plain walk.
//
// Design.  One thread a ray, rays in submission order (the path tracer's
// body-start sort already makes neighbours coherent), 128 threads a CTA.
// A node is one 32-byte row [min xyz, first_piece * 8 + count (0 for an
// interior node) | max xyz, skip] and a piece one 64-byte row [q0 xyzw |
// q1 xyzw | nmid xyz, t0 | t1, segment, mode, 0] (flatten.py::
// pack_curve_rows), so a node visit is two float4 loads and a piece test
// four.  Closest hit keeps the best (t, segment, u, v) with a strict
// t < best, ties to the earlier piece, as the serial walk; any hit
// leaves at its first hit.  A ray whose far limit is not above t_min
// cannot hit and does not walk.  On request (null pointers otherwise, so
// a render stores nothing it does not read) the walk counts per ray its
// node visits and piece tests and marks the node and piece rows it
// touched (the bound of chip_smoke.py counts the distinct rows a run
// needs).
//
// What bounds it.  Each visit is a dependent load chain (the next node
// depends on this one's test), so a lone ray is latency-bound; a wave of
// rays hides the latency across warps, and then the row loads (32 B a
// visit, 64 B a test, mostly from L2) and the test's ~100 f32 operations
// bound it.  Warps diverge where neighbouring rays walk different
// subtrees.
//
// Left for later: a walk per warp over a shared node stream (the wave
// kernels' cluster front), a wider BVH or quantized boxes to cut visits,
// and a compacted work list for mostly dead waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CTA_RAYS = 128;
constexpr int CRV_ROW = 16;   // floats a piece row
constexpr int CBVH_ROW = 8;   // floats a node row
constexpr int MODE_RIBBON = 3;

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

struct Best {
    float t, u, v;
    int seg;
    bool hit;
};

// One piece against the ray; updates best where the piece wins.
__device__ __forceinline__ void piece_test(const Ray &r, const float4 *row,
                                           Best &b) {
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
        ok = (dist <= width) && (seg_t2 >= 0.0f) && (t0 < b.t) &&
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
        ok = (t0r >= r.tmin) && (t0r < b.t) && (seg_tr >= 0.0f) &&
             (seg_tr <= 1.0f) && (dist_sq <= width_r * width_r) &&
             (new_tr >= 0.0f) && (new_tr <= 1.0f);
        t_hit = t0r;
        u_hit = new_tr;
        v_hit = 0.0f;
    }
    if (ok) {
        b.t = t_hit;
        b.seg = seg;
        b.u = u_hit;
        b.v = v_hit;
        b.hit = true;
    }
}

__device__ __forceinline__ float safe_inv(float x) {
    return 1.0f / (fabsf(x) < 1e-20f ? (x >= 0.0f ? 1e-20f : -1e-20f) : x);
}

__global__ void __launch_bounds__(CTA_RAYS)
curve_trace_kernel(const float *__restrict__ o, const float *__restrict__ d,
                   const float *__restrict__ t_min,
                   const float *__restrict__ t_max,
                   const float *__restrict__ pieces,
                   const float *__restrict__ nodes, int n_rays, int n_nodes,
                   int any_hit, float *__restrict__ t_out,
                   int *__restrict__ seg_out, float *__restrict__ u_out,
                   float *__restrict__ v_out, uint8_t *__restrict__ hit_out,
                   int *__restrict__ counts, uint8_t *__restrict__ node_mark,
                   uint8_t *__restrict__ piece_mark) {
    const int i = blockIdx.x * CTA_RAYS + threadIdx.x;
    if (i >= n_rays) return;
    Ray r;
    r.o = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    r.d = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    r.tmin = t_min[i];
    Best b = {t_max[i], 0.0f, 0.0f, -1, false};
    int visits = 0, tests = 0;
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
        int node = 0;
        while (node < n_nodes) {
            const float4 lo = __ldg(N + (CBVH_ROW / 4) * node);
            const float4 hi = __ldg(N + (CBVH_ROW / 4) * node + 1);
            ++visits;
            if (node_mark) node_mark[node] = 1;
            // slab test against the best t (ops/intersect.py::ray_box)
            const float t0x = (lo.x - r.o.x) * r.inv.x;
            const float t0y = (lo.y - r.o.y) * r.inv.y;
            const float t0z = (lo.z - r.o.z) * r.inv.z;
            const float t1x = (hi.x - r.o.x) * r.inv.x;
            const float t1y = (hi.y - r.o.y) * r.inv.y;
            const float t1z = (hi.z - r.o.z) * r.inv.z;
            const float t_near = fmaxf(
                fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)),
                0.0f);
            const float t_far = fminf(
                fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)),
                b.t);
            const bool box_hit = t_near <= t_far * 1.00000024f;
            // lo.w: first_piece * 8 + count (0: interior); hi.w: skip
            const int meta = __float_as_int(lo.w);
            const int count = meta & 7;
            const int skip = __float_as_int(hi.w);
            if (box_hit && count > 0) {
                const int first = meta >> 3;
                for (int k = 0; k < count; ++k) {
                    ++tests;
                    if (piece_mark) piece_mark[first + k] = 1;
                    piece_test(r, P + (CRV_ROW / 4) * (first + k), b);
                    if (any_hit && b.hit) break;
                }
            }
            if (any_hit && b.hit) break;
            node = (box_hit && count == 0) ? node + 1 : skip;
        }
    }
    t_out[i] = b.t;
    seg_out[i] = b.seg;
    u_out[i] = b.u;
    v_out[i] = b.v;
    hit_out[i] = b.hit ? 1 : 0;
    if (counts) {
        counts[i] = visits;
        counts[n_rays + i] = tests;
    }
}

}  // namespace

extern "C" {

// Launches C1 on `stream` over n_rays rays: o, d (n_rays, 3), t_min and
// t_max (n_rays,) f32; pieces (Cp, 16) and nodes (n_nodes, 8) the packed
// rows; outputs t, seg, u, v, hit (n_rays,); counts (2, n_rays) (node
// visits, piece tests) and node_mark / piece_mark (n_nodes,) / (Cp,)
// bytes set to 1 where a row was read, each or null.  Returns cudaGetLastError()
// (0 = ok).
int curve_trace_launch(const void *o, const void *d, const void *t_min,
                       const void *t_max, const void *pieces,
                       const void *nodes, int n_rays, int n_nodes, int any_hit,
                       void *t_out, void *seg_out, void *u_out, void *v_out,
                       void *hit_out, void *counts, void *node_mark,
                       void *piece_mark, void *stream) {
    if (n_rays <= 0) return 0;
    if (n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int grid = (n_rays + CTA_RAYS - 1) / CTA_RAYS;
    curve_trace_kernel<<<grid, CTA_RAYS, 0, st>>>(
        static_cast<const float *>(o), static_cast<const float *>(d),
        static_cast<const float *>(t_min), static_cast<const float *>(t_max),
        static_cast<const float *>(pieces), static_cast<const float *>(nodes),
        n_rays, n_nodes, any_hit, static_cast<float *>(t_out),
        static_cast<int *>(seg_out), static_cast<float *>(u_out),
        static_cast<float *>(v_out), static_cast<uint8_t *>(hit_out),
        static_cast<int *>(counts), static_cast<uint8_t *>(node_mark),
        static_cast<uint8_t *>(piece_mark));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
