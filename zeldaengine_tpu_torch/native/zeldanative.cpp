// Native runtime components for ZeldaEngine-TPU.
//
// The reference keeps its hot CPU-side tooling in C++ (ZeldaMeshlet's
// meshoptimizer clusterizer, tinyobjloader parsing); this library is the
// equivalent for the TPU engine's host side:
//   - ze_build_meshlets: greedy Morton-ordered meshlet clusterizer with
//     bounding-sphere + backface-cone computation (semantics of
//     meshopt_buildMeshlets / meshopt_computeMeshletBounds as used in
//     ZeldaMeshlet.cpp:132-171), fast enough for multi-million-triangle
//     bakes.
//   - ze_load_obj: OBJ parser with vertex dedup matching LoadMeshAsset
//     (ZeldaEngine.cpp:6899-6948): color=white, v-flip, normals addressed
//     by position index.
//   - ze_morton_sort_triangles: spatial sort used by the rasterizer's
//     chunk binning.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- utilities

static inline uint64_t spread3(uint64_t x) {
    x &= 0x3ffull;
    x = (x | (x << 16)) & 0x030000FFull;
    x = (x | (x << 8)) & 0x0300F00Full;
    x = (x | (x << 4)) & 0x030C30C3ull;
    x = (x | (x << 2)) & 0x09249249ull;
    return x;
}

// Sort triangle indices by Morton code of their centroid. In-place on a
// copy: writes the permuted index buffer to out_indices (n_tris * 3).
void ze_morton_sort_triangles(const float* positions, int64_t n_verts,
                              const uint32_t* indices, int64_t n_tris,
                              uint32_t* out_indices) {
    (void)n_verts;
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    std::vector<float> cent(n_tris * 3);
    for (int64_t t = 0; t < n_tris; ++t) {
        for (int a = 0; a < 3; ++a) {
            float c = (positions[indices[t * 3 + 0] * 3 + a] +
                       positions[indices[t * 3 + 1] * 3 + a] +
                       positions[indices[t * 3 + 2] * 3 + a]) / 3.0f;
            cent[t * 3 + a] = c;
            lo[a] = std::min(lo[a], c);
            hi[a] = std::max(hi[a], c);
        }
    }
    std::vector<std::pair<uint64_t, int64_t>> keys(n_tris);
    for (int64_t t = 0; t < n_tris; ++t) {
        uint64_t m = 0;
        for (int a = 0; a < 3; ++a) {
            float range = std::max(hi[a] - lo[a], 1e-12f);
            uint64_t q = (uint64_t)((cent[t * 3 + a] - lo[a]) / range * 1023.0f);
            m |= spread3(q) << a;
        }
        keys[t] = {m, t};
    }
    std::sort(keys.begin(), keys.end());
    for (int64_t t = 0; t < n_tris; ++t) {
        int64_t src = keys[t].second;
        out_indices[t * 3 + 0] = indices[src * 3 + 0];
        out_indices[t * 3 + 1] = indices[src * 3 + 1];
        out_indices[t * 3 + 2] = indices[src * 3 + 2];
    }
}

// --------------------------------------------------------------- meshlets

struct ZeMeshletRecord {  // matches ZeldaMeshlet.cpp:39-49 (64 bytes)
    uint32_t vertex_offset;
    uint32_t vertex_count;
    uint32_t triangle_offset;
    uint32_t triangle_count;
    float bounds_center[3];
    float bounds_radius;
    float cone_apex[3];
    float cone_axis[3];
    float cone_cutoff;
    float pad;
};

// Greedy clusterizer. Returns number of meshlets. Caller passes output
// buffers sized for the worst case:
//   out_meshlets:  n_tris records (upper bound)
//   out_mv:        n_tris * 3 uint32
//   out_mt:        n_tris * 3 uint8
int64_t ze_build_meshlets(const float* positions, int64_t n_verts,
                          const uint32_t* indices, int64_t n_tris,
                          int32_t max_vertices, int32_t max_triangles,
                          int32_t spatial_sort,
                          ZeMeshletRecord* out_meshlets,
                          uint32_t* out_mv, uint8_t* out_mt,
                          int64_t* out_mv_count, int64_t* out_mt_count) {
    std::vector<uint32_t> sorted(n_tris * 3);
    if (spatial_sort) {
        ze_morton_sort_triangles(positions, n_verts, indices, n_tris,
                                 sorted.data());
    } else {
        std::memcpy(sorted.data(), indices, n_tris * 3 * sizeof(uint32_t));
    }

    std::unordered_map<uint32_t, uint8_t> cur;
    cur.reserve(max_vertices * 2);
    int64_t mv_len = 0, mt_len = 0, n_meshlets = 0;
    int64_t cur_voff = 0, cur_toff = 0;
    int32_t cur_tris = 0;

    auto flush = [&]() {
        if (cur_tris == 0) return;
        ZeMeshletRecord& m = out_meshlets[n_meshlets++];
        m.vertex_offset = (uint32_t)cur_voff;
        m.vertex_count = (uint32_t)cur.size();
        m.triangle_offset = (uint32_t)cur_toff;
        m.triangle_count = (uint32_t)cur_tris;

        // Bounding sphere (Ritter) over the meshlet's vertices.
        const uint32_t* mv = out_mv + cur_voff;
        int64_t nv = (int64_t)cur.size();
        float c[3], r;
        {
            // extreme pair along the largest-extent axis
            int64_t lo_i[3] = {0, 0, 0}, hi_i[3] = {0, 0, 0};
            for (int64_t i = 1; i < nv; ++i)
                for (int a = 0; a < 3; ++a) {
                    if (positions[mv[i] * 3 + a] <
                        positions[mv[lo_i[a]] * 3 + a])
                        lo_i[a] = i;
                    if (positions[mv[i] * 3 + a] >
                        positions[mv[hi_i[a]] * 3 + a])
                        hi_i[a] = i;
                }
            int best = 0;
            float best_d = -1.0f;
            for (int a = 0; a < 3; ++a) {
                float d = 0;
                for (int b = 0; b < 3; ++b) {
                    float diff = positions[mv[hi_i[a]] * 3 + b] -
                                 positions[mv[lo_i[a]] * 3 + b];
                    d += diff * diff;
                }
                if (d > best_d) { best_d = d; best = a; }
            }
            const float* p1 = positions + mv[lo_i[best]] * 3;
            const float* p2 = positions + mv[hi_i[best]] * 3;
            for (int a = 0; a < 3; ++a) c[a] = (p1[a] + p2[a]) * 0.5f;
            r = std::sqrt(best_d) * 0.5f;
            for (int64_t i = 0; i < nv; ++i) {
                const float* p = positions + mv[i] * 3;
                float d2 = 0;
                for (int a = 0; a < 3; ++a) {
                    float diff = p[a] - c[a];
                    d2 += diff * diff;
                }
                float d = std::sqrt(d2);
                if (d > r) {
                    float nr = (r + d) * 0.5f;
                    float k = (nr - r) / d;
                    for (int a = 0; a < 3; ++a) c[a] += (p[a] - c[a]) * k;
                    r = nr;
                }
            }
        }
        for (int a = 0; a < 3; ++a) m.bounds_center[a] = c[a];
        m.bounds_radius = r;

        // Backface cone from triangle normals.
        float axis[3] = {0, 0, 0};
        const uint8_t* mt = out_mt + cur_toff;
        std::vector<float> normals(cur_tris * 3);
        for (int32_t t = 0; t < cur_tris; ++t) {
            const float* a0 = positions + mv[mt[t * 3 + 0]] * 3;
            const float* a1 = positions + mv[mt[t * 3 + 1]] * 3;
            const float* a2 = positions + mv[mt[t * 3 + 2]] * 3;
            float e1[3], e2[3], n[3];
            for (int a = 0; a < 3; ++a) {
                e1[a] = a1[a] - a0[a];
                e2[a] = a2[a] - a0[a];
            }
            n[0] = e1[1] * e2[2] - e1[2] * e2[1];
            n[1] = e1[2] * e2[0] - e1[0] * e2[2];
            n[2] = e1[0] * e2[1] - e1[1] * e2[0];
            float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
            len = std::max(len, 1e-20f);
            for (int a = 0; a < 3; ++a) {
                normals[t * 3 + a] = n[a] / len;
                axis[a] += n[a] / len;
            }
        }
        float alen = std::sqrt(axis[0] * axis[0] + axis[1] * axis[1] +
                               axis[2] * axis[2]);
        float cutoff = 1.0f;
        if (alen > 1e-12f) {
            for (int a = 0; a < 3; ++a) axis[a] /= alen;
            float mindot = 1.0f;
            for (int32_t t = 0; t < cur_tris; ++t) {
                float d = normals[t * 3 + 0] * axis[0] +
                          normals[t * 3 + 1] * axis[1] +
                          normals[t * 3 + 2] * axis[2];
                mindot = std::min(mindot, d);
            }
            cutoff = mindot > 0.0f
                         ? std::sqrt(std::max(0.0f, 1.0f - mindot * mindot))
                         : 1.0f;
        } else {
            axis[0] = axis[1] = axis[2] = 0.0f;
        }
        for (int a = 0; a < 3; ++a) {
            m.cone_apex[a] = c[a];
            m.cone_axis[a] = axis[a];
        }
        m.cone_cutoff = cutoff;
        m.pad = 0.0f;

        cur_voff = mv_len;
        cur_toff = mt_len;
        cur.clear();
        cur_tris = 0;
    };

    for (int64_t t = 0; t < n_tris; ++t) {
        const uint32_t* tri = sorted.data() + t * 3;
        int new_verts = 0;
        for (int k = 0; k < 3; ++k)
            if (cur.find(tri[k]) == cur.end()) ++new_verts;
        if ((int64_t)cur.size() + new_verts > max_vertices ||
            cur_tris + 1 > max_triangles) {
            flush();
        }
        for (int k = 0; k < 3; ++k) {
            auto it = cur.find(tri[k]);
            uint8_t local;
            if (it == cur.end()) {
                local = (uint8_t)cur.size();
                cur.emplace(tri[k], local);
                out_mv[mv_len++] = tri[k];
            } else {
                local = it->second;
            }
            out_mt[mt_len++] = local;
        }
        ++cur_tris;
    }
    flush();

    *out_mv_count = mv_len;
    *out_mt_count = mt_len;
    return n_meshlets;
}

// -------------------------------------------------------------------- OBJ

struct ZeObjData {
    float* positions;  // (V, 3)
    float* normals;    // (V, 3)
    float* uvs;        // (V, 2)
    uint32_t* indices; // (T, 3)
    int64_t n_verts;
    int64_t n_tris;
};

struct VertKey {
    int p, t, n;
    bool operator==(const VertKey& o) const {
        return p == o.p && t == o.t && n == o.n;
    }
};
struct VertKeyHash {
    size_t operator()(const VertKey& k) const {
        return ((size_t)k.p * 73856093u) ^ ((size_t)k.t * 19349663u) ^
               ((size_t)k.n * 83492791u);
    }
};

// Parses a (triangulated-on-load) OBJ. Returns 0 on success.
int32_t ze_load_obj(const char* path, ZeObjData* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::vector<float> vs, vns, vts;
    std::vector<VertKey> corners;
    std::vector<int> face_sizes;
    char line[4096];
    while (std::fgets(line, sizeof(line), f)) {
        if (line[0] == 'v' && line[1] == ' ') {
            float x, y, z;
            if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                vs.push_back(x); vs.push_back(y); vs.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 'n') {
            float x, y, z;
            if (std::sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
                vns.push_back(x); vns.push_back(y); vns.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 't') {
            float u, v;
            if (std::sscanf(line + 3, "%f %f", &u, &v) == 2) {
                vts.push_back(u); vts.push_back(v);
            }
        } else if (line[0] == 'f' && line[1] == ' ') {
            int count = 0;
            char* s = line + 2;
            while (*s) {
                while (*s == ' ' || *s == '\t') ++s;
                if (*s == '\0' || *s == '\n' || *s == '\r') break;
                int p = 0, t = 0, n = 0;
                p = (int)std::strtol(s, &s, 10);
                if (*s == '/') {
                    ++s;
                    if (*s != '/') t = (int)std::strtol(s, &s, 10);
                    if (*s == '/') { ++s; n = (int)std::strtol(s, &s, 10); }
                }
                corners.push_back({p, t, n});
                ++count;
            }
            face_sizes.push_back(count);
        }
    }
    std::fclose(f);

    int64_t nv_in = (int64_t)vs.size() / 3;
    auto resolve = [](int idx, int64_t count) -> int64_t {
        return idx > 0 ? idx - 1 : count + idx;
    };

    std::unordered_map<VertKey, uint32_t, VertKeyHash> unique;
    std::vector<float> opos, onrm, ouv;
    std::vector<uint32_t> oidx;
    size_t ci = 0;
    for (int fs : face_sizes) {
        std::vector<uint32_t> local(fs);
        for (int k = 0; k < fs; ++k) {
            VertKey key = corners[ci + k];
            int64_t p_i = resolve(key.p, nv_in);
            VertKey canon = {(int)p_i,
                             key.t ? (int)resolve(key.t, (int64_t)vts.size() / 2) : -1,
                             0 /* normals by position index (ref quirk) */};
            auto it = unique.find(canon);
            if (it == unique.end()) {
                uint32_t id = (uint32_t)(opos.size() / 3);
                unique.emplace(canon, id);
                opos.push_back(vs[p_i * 3 + 0]);
                opos.push_back(vs[p_i * 3 + 1]);
                opos.push_back(vs[p_i * 3 + 2]);
                if ((int64_t)vns.size() / 3 > p_i) {
                    onrm.push_back(vns[p_i * 3 + 0]);
                    onrm.push_back(vns[p_i * 3 + 1]);
                    onrm.push_back(vns[p_i * 3 + 2]);
                } else {
                    onrm.push_back(0); onrm.push_back(0); onrm.push_back(0);
                }
                if (canon.t >= 0) {
                    ouv.push_back(vts[canon.t * 2 + 0]);
                    ouv.push_back(1.0f - vts[canon.t * 2 + 1]);
                } else {
                    ouv.push_back(0); ouv.push_back(0);
                }
                local[k] = id;
            } else {
                local[k] = it->second;
            }
        }
        for (int k = 1; k + 1 < fs; ++k) {
            oidx.push_back(local[0]);
            oidx.push_back(local[k]);
            oidx.push_back(local[k + 1]);
        }
        ci += fs;
    }

    out->n_verts = (int64_t)opos.size() / 3;
    out->n_tris = (int64_t)oidx.size() / 3;
    out->positions = (float*)std::malloc(opos.size() * sizeof(float));
    out->normals = (float*)std::malloc(onrm.size() * sizeof(float));
    out->uvs = (float*)std::malloc(ouv.size() * sizeof(float));
    out->indices = (uint32_t*)std::malloc(oidx.size() * sizeof(uint32_t));
    std::memcpy(out->positions, opos.data(), opos.size() * sizeof(float));
    std::memcpy(out->normals, onrm.data(), onrm.size() * sizeof(float));
    std::memcpy(out->uvs, ouv.data(), ouv.size() * sizeof(float));
    std::memcpy(out->indices, oidx.data(), oidx.size() * sizeof(uint32_t));
    return 0;
}

void ze_free_obj(ZeObjData* d) {
    std::free(d->positions);
    std::free(d->normals);
    std::free(d->uvs);
    std::free(d->indices);
    d->positions = d->normals = d->uvs = nullptr;
    d->indices = nullptr;
}

}  // extern "C"
