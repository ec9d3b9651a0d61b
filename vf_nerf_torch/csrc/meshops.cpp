// Host mesh operations of the marching-cubes tail: triangle emission and
// vertex deduplication (the port's copy of the root csrc/meshops.cpp, built
// by vf_nerf_torch/kernels/host.py and called from
// vf_nerf_torch/evaluation/mc/contrastive.py).
//
// Both are ragged scalar loops over the surface cells and run on the host,
// as in the JAX package. The dedup is a hash map keyed on the exact bits of
// the 3 doubles (the identity the reference's python-dict dedup used,
// marching_cubes_vt.py:246-253): O(n), where numpy's sort-based
// np.unique(rows) is O(n log n) and orders the vertices otherwise.

#include <cstdint>
#include <cstring>
#include <unordered_map>

namespace {

struct Key {
    double x, y, z;
    bool operator==(const Key& o) const {
        return std::memcmp(this, &o, sizeof(Key)) == 0;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        // FNV-1a over the 24 raw bytes.
        const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
        size_t h = 1469598103934665603ull;
        for (size_t i = 0; i < sizeof(Key); ++i) {
            h ^= p[i];
            h *= 1099511628211ull;
        }
        return h;
    }
};

}  // namespace

extern "C" {

// verts: (n, 3) float64 rows. Writes first-occurrence unique rows into
// out_verts (capacity n rows) and per-row indices into inverse (n).
// Returns the unique count.
int64_t dedup_vertices(const double* verts, int64_t n,
                       double* out_verts, int32_t* inverse) {
    std::unordered_map<Key, int32_t, KeyHash> seen;
    seen.reserve(static_cast<size_t>(n));
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        Key k;
        std::memcpy(&k, verts + 3 * i, sizeof(Key));
        auto it = seen.find(k);
        if (it == seen.end()) {
            seen.emplace(k, static_cast<int32_t>(count));
            std::memcpy(out_verts + 3 * count, verts + 3 * i, sizeof(Key));
            inverse[i] = static_cast<int32_t>(count);
            ++count;
        } else {
            inverse[i] = it->second;
        }
    }
    return count;
}

// Classic table-based MC triangle emission. Bit-exact with the numpy
// version (evaluation/mc/contrastive.py::emit_triangles_numpy, the tests'
// oracle): same f64 operation order for the edge interpolation
// (pa + t*(pb-pa), t = (iso-va)/(vb-va), degenerate |vb-va| <= 1e-5 -> pa),
// same corner-offset-based endpoint swap (reference
// marching_cubes_vt.py::vertex_interpolate).
//
// grid_verts: (m, 8, 3) f64; vert_values: (m, 8) f64;
// edge_table: (256) i32 bitmasks; edge_vertex: (12, 2) i32;
// edge_swap: (12) i32 0/1; tri_table: (256, 16) i32 (-1 terminated);
// out_tris: capacity (5*m, 3, 3) f64. Returns the triangle count.
int64_t emit_mc_triangles(const double* grid_verts,
                          const double* vert_values,
                          int64_t m, double isovalue,
                          const int32_t* edge_table,
                          const int32_t* edge_vertex,
                          const int32_t* edge_swap,
                          const int32_t* tri_table,
                          double* out_tris) {
    int64_t n_tris = 0;
    double edge_cut[12][3];
    for (int64_t c = 0; c < m; ++c) {
        const double* v = vert_values + 8 * c;
        int config = 0;
        for (int i = 0; i < 8; ++i) {
            if (v[i] < isovalue) config |= 1 << i;
        }
        const int edges = edge_table[config];
        if (edges == 0) continue;
        const double* p = grid_verts + 24 * c;
        for (int e = 0; e < 12; ++e) {
            if (!(edges & (1 << e))) continue;
            int a = edge_vertex[2 * e];
            int b = edge_vertex[2 * e + 1];
            if (edge_swap[e]) {
                int tmp = a; a = b; b = tmp;
            }
            const double va = v[a], vb = v[b];
            const double* pa = p + 3 * a;
            const double* pb = p + 3 * b;
            const double denom = vb - va;
            const double t =
                (denom <= 1e-5 && denom >= -1e-5) ? 0.0
                                                  : (isovalue - va) / denom;
            for (int k = 0; k < 3; ++k) {
                edge_cut[e][k] = pa[k] + t * (pb[k] - pa[k]);
            }
        }
        const int32_t* tri = tri_table + 16 * config;
        for (int t3 = 0; t3 < 15 && tri[t3] >= 0; t3 += 3) {
            double* out = out_tris + 9 * n_tris;
            for (int k = 0; k < 3; ++k) {
                std::memcpy(out + 3 * k, edge_cut[tri[t3 + k]],
                            3 * sizeof(double));
            }
            ++n_tris;
        }
    }
    return n_tris;
}

}  // extern "C"
