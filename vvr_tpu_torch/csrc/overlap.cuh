// Overlap AO's occupancy densities as __device__ functions: K20
// (overlap.cu) runs them per position, and K15 (bounce.cu) runs
// `vvr_overlap_ao` inline for the frame's overlap AO, through its grid
// view's `solid` (grid_view.cuh).
//
// Port of vvr_tpu/ops/overlap.py (:39 volume_aabb_aabb_overlap, quirk
// included; :50 pyramid_is_solid; :62 cube and :81 planar density; :117
// overlap_ao), the sums in the JAX loop order. Rounding as XLA's jit
// computes them (ops/overlap.py): a density is its sum times the float32
// reciprocal of the box's volume or area; overlap_ao adds each sum times
// that reciprocal with an FMA, and 1 - clip(ao, 0, 2) * 0.2 is an FMA;
// the rest under -fmad=false.
#pragma once

#include "common.cuh"

// the planes' axes across each axis (overlap.py _AXIS_UV)
static __device__ __forceinline__ void vvr_axis_uv(int axis, int* ua,
                                                   int* va) {
    *ua = axis == 0 ? 1 : 0;
    *va = axis == 2 ? 1 : 2;
}

// the overlap volume of voxel [p, p + 1] with the box (c, h), or 0 where
// the voxel is empty or outside the world
template <class View>
static __device__ __forceinline__ float vvr_overlap_cell(
        const View& V, float cx, float cy, float cz, float ox, float oy,
        float oz, float h) {
    const int px = (int)(cx + ox), py = (int)(cy + oy), pz = (int)(cz + oz);
    if ((unsigned)px >= (unsigned)V.size || (unsigned)py >= (unsigned)V.size
        || (unsigned)pz >= (unsigned)V.size || !V.solid(px, py, pz)) {
        return 0.0f;
    }
    const float vx = fmaxf((float)px, cx - h) - fminf((float)(px + 1), cx + h);
    const float vy = fmaxf((float)py, cy - h) - fminf((float)(py + 1), cy + h);
    const float vz = fmaxf((float)pz, cz - h) - fminf((float)(pz + 1), cz + h);
    return fmaxf(-vx * vy * vz, 0.0f);
}

// the cube's sum over offsets -k .. k (x, then y, then z)
template <class View>
static __device__ float vvr_cube_overlap_sum(const View& V, float cx,
                                             float cy, float cz, float h,
                                             int k) {
    float s = 0.0f;
    for (int x = -k; x <= k; ++x)
        for (int y = -k; y <= k; ++y)
            for (int z = -k; z <= k; ++z)
                s = s + vvr_overlap_cell(V, cx, cy, cz, (float)x, (float)y,
                                         (float)z, h);
    return s;
}

// the square's sum across `axis` (u, then v)
template <class View>
static __device__ float vvr_planar_overlap_sum(const View& V, float cx,
                                               float cy, float cz, float h,
                                               int k, int axis) {
    int ua, va;
    vvr_axis_uv(axis, &ua, &va);
    float s = 0.0f;
    for (int u = -k; u <= k; ++u) {
        for (int v = -k; v <= k; ++v) {
            const float ox = ua == 0 ? (float)u : 0.0f;
            const float oy = ua == 1 ? (float)u : (va == 1 ? (float)v : 0.0f);
            const float oz = va == 2 ? (float)v : 0.0f;
            s = s + vvr_overlap_cell(V, cx, cy, cz, ox, oy, oz, h);
        }
    }
    return s;
}

// overlap_ao: 1 plus the planar densities at w + n * 0.5 (half 0.8) and
// w + n * 2.5 (half 2.4) across the face axis, clipped, scaled, inverted
template <class View>
static __device__ float vvr_overlap_ao(const View& V, float wx, float wy,
                                       float wz, float nx, float ny,
                                       float nz, int face) {
    float ao = 1.0f;
    ao = __fmaf_rn(vvr_planar_overlap_sum(V, wx + nx * 0.5f, wy + ny * 0.5f,
                                          wz + nz * 0.5f, 0.8f, 1, face),
                   1.0f / 2.56f, ao);
    ao = __fmaf_rn(vvr_planar_overlap_sum(V, wx + nx * 2.5f, wy + ny * 2.5f,
                                          wz + nz * 2.5f, 2.4f, 3, face),
                   1.0f / 23.04f, ao);
    return vvr_clamp(__fmaf_rn(-vvr_clamp(ao, 0.0f, 2.0f), 0.2f, 1.0f), 0.0f,
                     1.0f);
}
