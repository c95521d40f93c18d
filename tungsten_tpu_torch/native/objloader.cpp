// Fast Wavefront OBJ triangle loader (C ABI for ctypes) — the runtime
// counterpart of the reference's ObjLoader (ref src/core/io/
// ObjLoader.cpp): v/vn/vt/f statements, negative indices, polygon fan
// triangulation, per-corner v/vt/vn splitting into unified vertices.
// Two-pass: parse into growable buffers, then hand out copies.
//
// A face corner is resolved to absolute (v, vt, vn) indices before it is
// looked up, so a relative corner (`f -3 -2 -1`) names the vertices
// written just before its face.  The lookup key holds the three resolved
// indices whole, so two corners share a unified vertex only when all
// three are equal, however many v / vt / vn lines the file has.  A
// corner that does not start with an integer ends its face (a trailing
// comment, say); the corners read before it are kept.
// io/mesh.py::load_obj_python parses the same way in Python.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct LoadState {
    std::vector<float> pos, nrm, uv;     // unified vertex streams
    std::vector<int32_t> idx;            // triangle indices
};

struct CornerKey {
    long v, t, n;                        // resolved; -1 where absent
    bool operator==(const CornerKey &o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};

struct CornerHash {
    size_t operator()(const CornerKey &k) const {
        uint64_t h = (uint64_t)k.v * 0x9E3779B97F4A7C15ull;
        h ^= (uint64_t)k.t + 0x7F4A7C159E3779B9ull + (h << 6) + (h >> 2);
        h ^= (uint64_t)k.n + 0x94D049BB133111EBull + (h << 6) + (h >> 2);
        return (size_t)h;
    }
};

// Staged between trt_load_obj and trt_obj_fetch; the Python binding
// holds one lock across the pair.
static LoadState *g_state = nullptr;

static inline const char *skip_ws(const char *p) {
    while (*p == ' ' || *p == '\t') ++p;
    return p;
}

}  // namespace

extern "C" {

// Parses the file; returns 0 on success.  Results are staged in a
// global until trt_obj_fetch copies them out.
int trt_load_obj(const char *path, int64_t *n_verts, int64_t *n_tris) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;

    std::vector<float> vs, vns, vts;
    delete g_state;
    g_state = new LoadState();
    LoadState &st = *g_state;
    // corner (v,vt,vn) -> unified index
    std::unordered_map<CornerKey, int32_t, CornerHash> corner_map;
    corner_map.reserve(1 << 16);

    char line[8192];
    std::vector<int32_t> face;
    while (fgets(line, sizeof(line), f)) {
        const char *p = skip_ws(line);
        if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            float x, y, z;
            if (sscanf(p + 2, "%f %f %f", &x, &y, &z) == 3) {
                vs.push_back(x); vs.push_back(y); vs.push_back(z);
            }
        } else if (p[0] == 'v' && p[1] == 'n') {
            float x, y, z;
            if (sscanf(p + 2, "%f %f %f", &x, &y, &z) == 3) {
                vns.push_back(x); vns.push_back(y); vns.push_back(z);
            }
        } else if (p[0] == 'v' && p[1] == 't') {
            float x, y;
            if (sscanf(p + 2, "%f %f", &x, &y) == 2) {
                vts.push_back(x); vts.push_back(y);
            }
        } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            face.clear();
            const char *q = p + 1;
            while (*q) {
                q = skip_ws(q);
                if (*q == '\0' || *q == '\n' || *q == '\r') break;
                const char *start = q;
                long vi = strtol(q, (char **)&q, 10);
                if (q == start) break;   // not a corner: the face ends
                long ti = 0, ni = 0;
                if (*q == '/') {
                    ++q;
                    if (*q != '/') ti = strtol(q, (char **)&q, 10);
                    if (*q == '/') { ++q; ni = strtol(q, (char **)&q, 10); }
                }
                long nv = (long)vs.size() / 3;
                long nt = (long)vts.size() / 2;
                long nn = (long)vns.size() / 3;
                long v = vi > 0 ? vi - 1 : nv + vi;
                long t = ti > 0 ? ti - 1 : (ti < 0 ? nt + ti : -1);
                long nrm = ni > 0 ? ni - 1 : (ni < 0 ? nn + ni : -1);
                if (v < 0 || v >= nv) continue;
                const CornerKey key{v, t, nrm};
                auto it = corner_map.find(key);
                int32_t uni;
                if (it == corner_map.end()) {
                    uni = (int32_t)(st.pos.size() / 3);
                    st.pos.push_back(vs[v * 3 + 0]);
                    st.pos.push_back(vs[v * 3 + 1]);
                    st.pos.push_back(vs[v * 3 + 2]);
                    if (nrm >= 0 && nrm < nn) {
                        st.nrm.push_back(vns[nrm * 3 + 0]);
                        st.nrm.push_back(vns[nrm * 3 + 1]);
                        st.nrm.push_back(vns[nrm * 3 + 2]);
                    } else {
                        st.nrm.push_back(0); st.nrm.push_back(0);
                        st.nrm.push_back(0);
                    }
                    if (t >= 0 && t < nt) {
                        st.uv.push_back(vts[t * 2 + 0]);
                        st.uv.push_back(vts[t * 2 + 1]);
                    } else {
                        st.uv.push_back(0); st.uv.push_back(0);
                    }
                    corner_map.emplace(key, uni);
                } else {
                    uni = it->second;
                }
                face.push_back(uni);
            }
            for (size_t k = 2; k < face.size(); ++k) {  // fan
                st.idx.push_back(face[0]);
                st.idx.push_back(face[k - 1]);
                st.idx.push_back(face[k]);
            }
        }
    }
    fclose(f);
    *n_verts = (int64_t)(st.pos.size() / 3);
    *n_tris = (int64_t)(st.idx.size() / 3);
    return 0;
}

int trt_obj_fetch(float *pos, float *nrm, float *uv, int32_t *idx) {
    if (!g_state) return -1;
    LoadState &st = *g_state;
    std::memcpy(pos, st.pos.data(), st.pos.size() * sizeof(float));
    std::memcpy(nrm, st.nrm.data(), st.nrm.size() * sizeof(float));
    std::memcpy(uv, st.uv.data(), st.uv.size() * sizeof(float));
    std::memcpy(idx, st.idx.data(), st.idx.size() * sizeof(int32_t));
    delete g_state;
    g_state = nullptr;
    return 0;
}

}  // extern "C"
