// The sun classifier's pieces shared by K12 (sunshadow.cu, hard shadows)
// and K14 (softshadow.cu, the cone gate of soft shadows): the sun basis,
// the grid's placement, its margin, the texel of a point, and the exact
// near walk of the first voxel crossings (vvr_tpu/ops/sunshadow.py
// `_near_segment`, :536).
#pragma once

#include "items.cuh"
#include "jump_dda.cuh"

#define VVR_SAFE 0.02f
#define VVR_NEAR_K 6

struct VvrSunBasis {
    float e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz;
};

struct VvrSunFrame {  // the grid's placement: texel (i, j) starts at
    float a0, b0, ts;  // (a0 + i*ts, b0 + j*ts)
    int grid;
};

// A point's depth along the sun, whether its texel lies on the grid, and
// that texel's gBC row (row 0 off the grid); each projection summed left
// to right (vvr_tpu/ops/sunshadow.py `_certain`, `soft_shadow_gate`)
struct VvrSunRow {
    float qz;
    bool ing;
    float2 row;
};

static __device__ __forceinline__ VvrSunRow vvr_sun_row(
        float x, float y, float z, const VvrSunBasis& B,
        const float2* __restrict__ gbc, const VvrSunFrame& G) {
    const float qa = (x * B.e1x + y * B.e1y) + z * B.e1z;
    const float qb = (x * B.e2x + y * B.e2y) + z * B.e2z;
    VvrSunRow r;
    r.qz = (x * B.sx + y * B.sy) + z * B.sz;
    const int i = vvr_floor_int((qa - G.a0) / G.ts);
    const int j = vvr_floor_int((qb - G.b0) / G.ts);
    r.ing = i >= 0 && i < G.grid && j >= 0 && j < G.grid;
    r.row = gbc[r.ing ? (long long)j * G.grid + i : 0];
    return r;
}

// first VVR_NEAR_K voxel crossings from o along d (`_near_segment`, the
// sun's direction for K12, a jittered sample's for K14): hit = entered
// solid; exited = left the world; t_end = entry parameter of the last cell
// tested empty
static __device__ void vvr_near_segment(const uint32_t* __restrict__ rows,
                                        int size, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, bool* hit, bool* exited,
                                        float* t_end) {
    const int g = size >> 3;
    const float big = 3e38f;
    const float ix = dx == 0.0f ? big : 1.0f / dx;
    const float iy = dy == 0.0f ? big : 1.0f / dy;
    const float iz = dz == 0.0f ? big : 1.0f / dz;
    const int px = dx > 0.0f, py = dy > 0.0f, pz = dz > 0.0f;
    int vx = vvr_floor_clip(ox, 0, size - 1);
    int vy = vvr_floor_clip(oy, 0, size - 1);
    int vz = vvr_floor_clip(oz, 0, size - 1);
    float t = 0.0f;
    *hit = false;
    *exited = false;
    *t_end = 0.0f;
    for (int k = 0; k < VVR_NEAR_K; ++k) {
        const uint32_t* row = rows
            + (size_t)((vx >> 3) + (vy >> 3) * g + (vz >> 3) * g * g) * 32;
        if (vvr_brick_solid(row, vx & 7, vy & 7, vz & 7)) {
            *hit = true;
            return;
        }
        *t_end = t;
        const int bx = vx + px, by = vy + py, bz = vz + pz;
        const float tx = dx == 0.0f ? big : ((float)bx - ox) * ix;
        const float ty = dy == 0.0f ? big : ((float)by - oy) * iy;
        const float tz = dz == 0.0f ? big : ((float)bz - oz) * iz;
        const float te = fminf(tx, fminf(ty, tz));
        const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
        const int nvx = nf == 0 ? (px ? bx : bx - 1) : vx;
        const int nvy = nf == 1 ? (py ? by : by - 1) : vy;
        const int nvz = nf == 2 ? (pz ? bz : bz - 1) : vz;
        if (nvx < 0 || nvx >= size || nvy < 0 || nvy >= size || nvz < 0
            || nvz >= size) {
            *exited = true;
            return;
        }
        vx = nvx;
        vy = nvy;
        vz = nvz;
        t = te;
    }
}
