// The primary hit's surface and the shadow ray's start, shared by K2
// (shade.cu: `shade_surface` writes the start, `shade_pixel` shades the
// surface) and K12 (sunshadow.cu: the main path's entry computes the start
// in registers instead of reading it back). One copy of the arithmetic,
// compiled with -fmad=false in both files, so the start is the same float
// in every kernel.
#pragma once

#include "common.cuh"

struct Surface {
    float nx, ny, nz;   // entry-face normal
    float wx, wy, wz;   // exact hit point
    int bx, by, bz;     // hit voxel
};

// hit reconstruction (frame.py:212-238): the entry plane sits at
// axis_coord, +1 when entering from the high side
static __device__ __forceinline__ Surface vvr_reconstruct(
        float ox, float oy, float oz, float dx, float dy, float dz, int face,
        int axis_coord) {
    const float sgx = dx >= 0.0f ? 1.0f : -1.0f;
    const float sgy = dy >= 0.0f ? 1.0f : -1.0f;
    const float sgz = dz >= 0.0f ? 1.0f : -1.0f;
    Surface s;
    s.nx = face == 0 ? -sgx : 0.0f;
    s.ny = face == 1 ? -sgy : 0.0f;
    s.nz = face == 2 ? -sgz : 0.0f;
    const float sg = face == 0 ? sgx : (face == 1 ? sgy : sgz);
    const float plane = (float)axis_coord + (sg < 0.0f ? 1.0f : 0.0f);
    const float df = face == 0 ? dx : (face == 1 ? dy : dz);
    const float of = face == 0 ? ox : (face == 1 ? oy : oz);
    const float dist = (plane - of) / (fabsf(df) < 1e-12f ? 1e-12f : df);
    s.wx = face == 0 ? plane : ox + dx * dist;
    s.wy = face == 1 ? plane : oy + dy * dist;
    s.wz = face == 2 ? plane : oz + dz * dist;
    s.bx = face == 0 ? axis_coord : (int)floorf(s.wx);
    s.by = face == 1 ? axis_coord : (int)floorf(s.wy);
    s.bz = face == 2 ? axis_coord : (int)floorf(s.wz);
    return s;
}

// the shadow ray of a surface: its start, surface + 0.05 along the sun,
// and whether it is traced, a hit whose face turns toward the sun
// (frame.py:310-311, :466-467)
struct VvrShadowStart {
    float x, y, z;
    bool active;
};

static __device__ __forceinline__ VvrShadowStart vvr_shadow_start(
        const Surface& s, bool hit, float sx, float sy, float sz) {
    VvrShadowStart r;
    r.x = s.wx + sx * 0.05f;
    r.y = s.wy + sy * 0.05f;
    r.z = s.wz + sz * 0.05f;
    r.active = hit && ((s.nx * sx + s.ny * sy) + s.nz * sz) > 0.0f;
    return r;
}
