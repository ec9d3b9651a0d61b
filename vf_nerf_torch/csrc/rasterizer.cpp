// Z-buffer triangle depth rasterizer (the port's copy of the root
// csrc/rasterizer.cpp, built by vf_nerf_torch/kernels/host.py and called
// from vf_nerf_torch/evaluation/renderer.py).
//
// The reference re-renders meshes into the training views with pyrender's
// EGL offscreen renderer for the "refuse" TSDF pass
// (evaluation/utils/renderer.py:11-71, evaluation/methods.py:33-72). This is
// a barycentric scanline loop over each triangle's bounding box on the host,
// as in the JAX package; the views are small and the work is ragged.
//
// Inputs are camera-space vertices (standard pinhole: x right, y down,
// z forward); output is a z-depth map with 0 = no hit.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

void rasterize_depth(const float* verts_cam,   // (n_verts, 3) camera space
                     int64_t n_verts,
                     const int32_t* faces,     // (n_faces, 3)
                     int64_t n_faces,
                     float fx, float fy, float cx, float cy,
                     int32_t height, int32_t width,
                     float near_clip,
                     float* depth_out)         // (height, width), init 0
{
    const float INF = 1e30f;
    // working buffer: +inf = empty
    for (int64_t i = 0; i < (int64_t)height * width; ++i)
        depth_out[i] = INF;

    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t ia = faces[3 * f + 0];
        const int32_t ib = faces[3 * f + 1];
        const int32_t ic = faces[3 * f + 2];
        if (ia < 0 || ib < 0 || ic < 0 ||
            ia >= n_verts || ib >= n_verts || ic >= n_verts)
            continue;

        const float* A = verts_cam + 3 * ia;
        const float* B = verts_cam + 3 * ib;
        const float* C = verts_cam + 3 * ic;
        const float za = A[2], zb = B[2], zc = C[2];
        // Skip triangles not fully in front of the near plane (no clipping —
        // matches typical offscreen use where the mesh is well inside view).
        if (za < near_clip || zb < near_clip || zc < near_clip)
            continue;

        const float ax = A[0] / za * fx + cx, ay = A[1] / za * fy + cy;
        const float bx = B[0] / zb * fx + cx, by = B[1] / zb * fy + cy;
        const float cx_ = C[0] / zc * fx + cx, cy_ = C[1] / zc * fy + cy;

        int x0 = (int)std::floor(std::min({ax, bx, cx_}));
        int x1 = (int)std::ceil(std::max({ax, bx, cx_}));
        int y0 = (int)std::floor(std::min({ay, by, cy_}));
        int y1 = (int)std::ceil(std::max({ay, by, cy_}));
        x0 = std::max(x0, 0);
        y0 = std::max(y0, 0);
        x1 = std::min(x1, width - 1);
        y1 = std::min(y1, height - 1);
        if (x0 > x1 || y0 > y1)
            continue;

        const float d = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_);
        if (std::fabs(d) < 1e-12f)
            continue;
        const float inv_d = 1.0f / d;
        // Perspective-correct depth: interpolate 1/z with barycentrics.
        const float iza = 1.0f / za, izb = 1.0f / zb, izc = 1.0f / zc;

        for (int y = y0; y <= y1; ++y) {
            const float py = y + 0.0f;   // pixel centers at integer coords
            for (int x = x0; x <= x1; ++x) {
                const float px = x + 0.0f;
                float w0 = ((by - cy_) * (px - cx_) +
                            (cx_ - bx) * (py - cy_)) * inv_d;
                float w1 = ((cy_ - ay) * (px - cx_) +
                            (ax - cx_) * (py - cy_)) * inv_d;
                float w2 = 1.0f - w0 - w1;
                const float eps = -1e-6f;
                if (w0 < eps || w1 < eps || w2 < eps)
                    continue;
                const float inv_z = w0 * iza + w1 * izb + w2 * izc;
                const float z = 1.0f / inv_z;
                float* cell = depth_out + (int64_t)y * width + x;
                if (z < *cell)
                    *cell = z;
            }
        }
    }

    for (int64_t i = 0; i < (int64_t)height * width; ++i)
        if (depth_out[i] >= INF)
            depth_out[i] = 0.0f;
}

}  // extern "C"
