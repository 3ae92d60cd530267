// Marching-tetrahedra isosurface extraction (C, host-side).
//
// Stands in for the reference's pymcubes dependency
// (projects/neuralangelo/utils/mesh.py:121): the SDF lattice is evaluated
// in blocks on the GPU; this host library triangulates each block. It is a
// plain C++ shared library (g++, no CUDA), built into build/ by
// mlinerf_tpu_torch/ops/cuda_build.py and loaded by ops/mesh.py.
// Marching tets (6 tets per cube) needs no 256-case lookup tables, has no
// ambiguous cases, and parallelizes trivially.
//
// C ABI (ctypes):
//   int marching_tets(const float* field, int nx, int ny, int nz,
//                     float iso,
//                     float* verts_out, long max_verts,
//                     long* n_verts_out);
// Emits soup triangles: every 3 consecutive vertices form one triangle.
// Vertex coordinates are in grid-index units (caller rescales).
// Returns 0 on success, 1 if the buffer was too small (output truncated).

#include <cstdint>
#include <cstdlib>

namespace {

struct V3 {
    float x, y, z;
};

inline V3 interp(float iso, const V3 &p1, const V3 &p2, float v1, float v2) {
    float denom = v2 - v1;
    float t = (denom > 1e-12f || denom < -1e-12f) ? (iso - v1) / denom : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    return V3{p1.x + t * (p2.x - p1.x), p1.y + t * (p2.y - p1.y), p1.z + t * (p2.z - p1.z)};
}

// The 6-tetrahedra decomposition of a cube (indices into the cube's 8
// corners, consistent orientation).
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

struct Emitter {
    float *out;
    long max_verts;
    long n;
    bool overflow;
    void tri(const V3 &a, const V3 &b, const V3 &c) {
        if (n + 3 > max_verts) {
            overflow = true;
            return;
        }
        out[3 * n + 0] = a.x; out[3 * n + 1] = a.y; out[3 * n + 2] = a.z; n++;
        out[3 * n + 0] = b.x; out[3 * n + 1] = b.y; out[3 * n + 2] = b.z; n++;
        out[3 * n + 0] = c.x; out[3 * n + 1] = c.y; out[3 * n + 2] = c.z; n++;
    }
};

// March one tetrahedron: corners p[4], values v[4], iso level.
void march_tet(Emitter &em, const V3 p[4], const float v[4], float iso) {
    int code = 0;
    if (v[0] < iso) code |= 1;
    if (v[1] < iso) code |= 2;
    if (v[2] < iso) code |= 4;
    if (v[3] < iso) code |= 8;
    switch (code) {
        case 0x0:
        case 0xF:
            return;
        case 0x1: em.tri(interp(iso, p[0], p[1], v[0], v[1]),
                         interp(iso, p[0], p[2], v[0], v[2]),
                         interp(iso, p[0], p[3], v[0], v[3])); return;
        case 0xE: em.tri(interp(iso, p[0], p[1], v[0], v[1]),
                         interp(iso, p[0], p[3], v[0], v[3]),
                         interp(iso, p[0], p[2], v[0], v[2])); return;
        case 0x2: em.tri(interp(iso, p[1], p[0], v[1], v[0]),
                         interp(iso, p[1], p[3], v[1], v[3]),
                         interp(iso, p[1], p[2], v[1], v[2])); return;
        case 0xD: em.tri(interp(iso, p[1], p[0], v[1], v[0]),
                         interp(iso, p[1], p[2], v[1], v[2]),
                         interp(iso, p[1], p[3], v[1], v[3])); return;
        case 0x4: em.tri(interp(iso, p[2], p[0], v[2], v[0]),
                         interp(iso, p[2], p[1], v[2], v[1]),
                         interp(iso, p[2], p[3], v[2], v[3])); return;
        case 0xB: em.tri(interp(iso, p[2], p[0], v[2], v[0]),
                         interp(iso, p[2], p[3], v[2], v[3]),
                         interp(iso, p[2], p[1], v[2], v[1])); return;
        case 0x8: em.tri(interp(iso, p[3], p[0], v[3], v[0]),
                         interp(iso, p[3], p[2], v[3], v[2]),
                         interp(iso, p[3], p[1], v[3], v[1])); return;
        case 0x7: em.tri(interp(iso, p[3], p[0], v[3], v[0]),
                         interp(iso, p[3], p[1], v[3], v[1]),
                         interp(iso, p[3], p[2], v[3], v[2])); return;
        case 0x3: {  // 0,1 inside
            V3 a = interp(iso, p[0], p[2], v[0], v[2]);
            V3 b = interp(iso, p[0], p[3], v[0], v[3]);
            V3 c = interp(iso, p[1], p[3], v[1], v[3]);
            V3 d = interp(iso, p[1], p[2], v[1], v[2]);
            em.tri(a, b, c);
            em.tri(a, c, d);
            return;
        }
        case 0xC: {
            V3 a = interp(iso, p[0], p[2], v[0], v[2]);
            V3 b = interp(iso, p[0], p[3], v[0], v[3]);
            V3 c = interp(iso, p[1], p[3], v[1], v[3]);
            V3 d = interp(iso, p[1], p[2], v[1], v[2]);
            em.tri(a, c, b);
            em.tri(a, d, c);
            return;
        }
        case 0x5: {  // 0,2 inside
            V3 a = interp(iso, p[0], p[1], v[0], v[1]);
            V3 b = interp(iso, p[0], p[3], v[0], v[3]);
            V3 c = interp(iso, p[2], p[3], v[2], v[3]);
            V3 d = interp(iso, p[2], p[1], v[2], v[1]);
            em.tri(a, c, b);
            em.tri(a, d, c);
            return;
        }
        case 0xA: {
            V3 a = interp(iso, p[0], p[1], v[0], v[1]);
            V3 b = interp(iso, p[0], p[3], v[0], v[3]);
            V3 c = interp(iso, p[2], p[3], v[2], v[3]);
            V3 d = interp(iso, p[2], p[1], v[2], v[1]);
            em.tri(a, b, c);
            em.tri(a, c, d);
            return;
        }
        case 0x6: {  // 1,2 inside
            V3 a = interp(iso, p[1], p[0], v[1], v[0]);
            V3 b = interp(iso, p[1], p[3], v[1], v[3]);
            V3 c = interp(iso, p[2], p[3], v[2], v[3]);
            V3 d = interp(iso, p[2], p[0], v[2], v[0]);
            em.tri(a, b, c);
            em.tri(a, c, d);
            return;
        }
        case 0x9: {
            V3 a = interp(iso, p[1], p[0], v[1], v[0]);
            V3 b = interp(iso, p[1], p[3], v[1], v[3]);
            V3 c = interp(iso, p[2], p[3], v[2], v[3]);
            V3 d = interp(iso, p[2], p[0], v[2], v[0]);
            em.tri(a, c, b);
            em.tri(a, d, c);
            return;
        }
    }
}

}  // namespace

extern "C" int marching_tets(const float *field, int nx, int ny, int nz, float iso,
                             float *verts_out, long max_verts, long *n_verts_out) {
    Emitter em{verts_out, max_verts, 0, false};
    const long sy = nz;        // index stride for y
    const long sx = (long)ny * nz;  // index stride for x
    for (int i = 0; i + 1 < nx; ++i) {
        for (int j = 0; j + 1 < ny; ++j) {
            for (int k = 0; k + 1 < nz; ++k) {
                // cube corners in binary (dx,dy,dz) order 0..7:
                // 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
                // 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
                const int dx[8] = {0, 1, 1, 0, 0, 1, 1, 0};
                const int dy[8] = {0, 0, 1, 1, 0, 0, 1, 1};
                const int dz[8] = {0, 0, 0, 0, 1, 1, 1, 1};
                V3 pc[8];
                float vc[8];
                bool all_lo = true, all_hi = true;
                for (int c = 0; c < 8; ++c) {
                    int x = i + dx[c], y = j + dy[c], z = k + dz[c];
                    pc[c] = V3{(float)x, (float)y, (float)z};
                    vc[c] = field[(long)x * sx + (long)y * sy + z];
                    if (vc[c] < iso) all_hi = false; else all_lo = false;
                }
                if (all_lo || all_hi) continue;
                for (int t = 0; t < 6; ++t) {
                    V3 p[4];
                    float v[4];
                    for (int c = 0; c < 4; ++c) {
                        p[c] = pc[TETS[t][c]];
                        v[c] = vc[TETS[t][c]];
                    }
                    march_tet(em, p, v, iso);
                }
            }
        }
    }
    *n_verts_out = em.n;
    return em.overflow ? 1 : 0;
}
