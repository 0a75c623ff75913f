// The jump-grid DDA of one ray, as a __device__ function: K1
// (jump_trace.cu) runs it per primary or shadow ray, and a later kernel can
// run it inline (a shadow trace fused into the shade kernel) without a
// second copy.
//
// Port of vvr_tpu/ops/jump.py `_make_stepper` (fetch :94-165, in-brick
// step :167-235), `_make_ray` :240, `_init_state` :255 and `_outputs` :275,
// one thread per ray. Every float expression keeps the JAX op order and the
// file is compiled with -fmad=false: `floor(o + d*te)` and
// `(bound - o) * inv` must round as the oracle's (render/oracle.py) do.
#pragma once

#include "common.cuh"

struct JumpHit {
    bool hit;
    int face;
    int axis_coord;
    float t;
    int iterations;
    int fetches;
    int missed_pops;
};

// clip(int(floor(x)), lo, hi), clamped in float first
static __device__ __forceinline__ int vvr_floor_clip(float x, int lo,
                                                     int hi) {
    return (int)vvr_clamp(floorf(x), (float)lo, (float)hi);
}

static __device__ __forceinline__ float vvr_axis_t(float bound, float o,
                                                   float d, float inv) {
    return d == 0.0f ? VVR_BIG_T : (bound - o) * inv;
}

// brick occupancy bit: word = 2*lz + (ly>>2), bit = lx + 8*(ly&3)
// (world/occupancy.py)
static __device__ __forceinline__ bool vvr_brick_solid(
        const uint32_t* __restrict__ row, int lx, int ly, int lz) {
    uint32_t w = __ldg(row + 2 * lz + (ly >> 2));
    return ((w >> (lx + ((ly & 3) << 3))) & 1u) != 0u;
}

static __device__ JumpHit vvr_jump_trace_ray(
        const uint32_t* __restrict__ rows, int size, float ox, float oy,
        float oz, float dx, float dy, float dz, bool active, int max_steps) {
    const int g = size >> 3;
    const float fs = (float)size;
    const float ix = dx == 0.0f ? VVR_BIG_T : 1.0f / dx;
    const float iy = dy == 0.0f ? VVR_BIG_T : 1.0f / dy;
    const float iz = dz == 0.0f ? VVR_BIG_T : 1.0f / dz;
    const int px = dx > 0.0f, py = dy > 0.0f, pz = dz > 0.0f;
    const int oct = px | (py << 1) | (pz << 2);

    bool act = active && ox >= 0.0f && ox < fs && oy >= 0.0f && oy < fs
               && oz >= 0.0f && oz < fs;
    int vx = vvr_floor_clip(ox, 0, size - 1);
    int vy = vvr_floor_clip(oy, 0, size - 1);
    int vz = vvr_floor_clip(oz, 0, size - 1);
    bool hit = false, pend = act;
    float t = 0.0f;
    int face = 0, it = 0, fe = 0, em = 0;
    int addr = (vx >> 3) + (vy >> 3) * g + (vz >> 3) * g * g;
    const uint32_t* row = rows;  // the brick the ray is in (in-brick mode)
    uint32_t slo = 0u, shi = 0u;

    while (act) {
        if (pend) {
            // fetch: jump across an all-empty box, or enter the brick
            const uint32_t* r = rows + (size_t)addr * 32;
            const int dval = (int)__ldg(r + 24 + oct);
            ++it;
            ++fe;
            if (dval == 0) {
                row = r;
                slo = __ldg(r + 17);
                shi = __ldg(r + 18);
                pend = false;
            } else {
                const int bx = vx >> 3, by = vy >> 3, bz = vz >> 3;
                const int exx = px ? (bx + dval) * 8 : (bx - dval + 1) * 8;
                const int exy = py ? (by + dval) * 8 : (by - dval + 1) * 8;
                const int exz = pz ? (bz + dval) * 8 : (bz - dval + 1) * 8;
                const float tx = vvr_axis_t((float)exx, ox, dx, ix);
                const float ty = vvr_axis_t((float)exy, oy, dy, iy);
                const float tz = vvr_axis_t((float)exz, oz, dz, iz);
                const float te = fminf(tx, fminf(ty, tz));
                const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
                int nvx, nvy, nvz;
                if (nf == 0) {
                    nvx = px ? exx : exx - 1;
                } else {
                    nvx = vvr_floor_clip(ox + dx * te,
                                         px ? bx * 8 : (bx - dval + 1) * 8,
                                         px ? (bx + dval) * 8 - 1 : bx * 8 + 7);
                }
                if (nf == 1) {
                    nvy = py ? exy : exy - 1;
                } else {
                    nvy = vvr_floor_clip(oy + dy * te,
                                         py ? by * 8 : (by - dval + 1) * 8,
                                         py ? (by + dval) * 8 - 1 : by * 8 + 7);
                }
                if (nf == 2) {
                    nvz = pz ? exz : exz - 1;
                } else {
                    nvz = vvr_floor_clip(oz + dz * te,
                                         pz ? bz * 8 : (bz - dval + 1) * 8,
                                         pz ? (bz + dval) * 8 - 1 : bz * 8 + 7);
                }
                vx = nvx;
                vy = nvy;
                vz = nvz;
                t = te;
                face = nf;
                addr = (nvx >> 3) + (nvy >> 3) * g + (nvz >> 3) * g * g;
                if (nvx < 0 || nvx >= size || nvy < 0 || nvy >= size
                    || nvz < 0 || nvz >= size) {
                    act = false;
                }
            }
        } else {
            // in-brick step: solid test, then a voxel or 2^3-subcell step
            const int lx = vx & 7, ly = vy & 7, lz = vz & 7;
            ++it;
            if (vvr_brick_solid(row, lx, ly, lz)) {
                hit = true;
                act = false;
            } else {
                const int sbit = (lx >> 1) | ((ly >> 1) << 2)
                                 | ((lz >> 1) << 4);
                const uint32_t sword = sbit >= 32 ? shi : slo;
                const bool big = ((sword >> (sbit & 31)) & 1u) == 0u;
                const int bxi = big ? (((vx >> 1) + px) << 1) : vx + px;
                const int byi = big ? (((vy >> 1) + py) << 1) : vy + py;
                const int bzi = big ? (((vz >> 1) + pz) << 1) : vz + pz;
                const float tx = vvr_axis_t((float)bxi, ox, dx, ix);
                const float ty = vvr_axis_t((float)byi, oy, dy, iy);
                const float tz = vvr_axis_t((float)bzi, oz, dz, iz);
                const float te = fminf(tx, fminf(ty, tz));
                const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
                int nvx = vx, nvy = vy, nvz = vz;
                if (nf == 0) {
                    nvx = px ? bxi : bxi - 1;
                } else if (big) {
                    const int b0 = (vx >> 1) << 1;
                    nvx = vvr_floor_clip(ox + dx * te, b0, b0 + 1);
                }
                if (nf == 1) {
                    nvy = py ? byi : byi - 1;
                } else if (big) {
                    const int b0 = (vy >> 1) << 1;
                    nvy = vvr_floor_clip(oy + dy * te, b0, b0 + 1);
                }
                if (nf == 2) {
                    nvz = pz ? bzi : bzi - 1;
                } else if (big) {
                    const int b0 = (vz >> 1) << 1;
                    nvz = vvr_floor_clip(oz + dz * te, b0, b0 + 1);
                }
                const int moved = nf == 0 ? nvx : (nf == 1 ? nvy : nvz);
                const int stayed = nf == 0 ? vx : (nf == 1 ? vy : vz);
                const bool exited = (moved >> 3) != (stayed >> 3);
                vx = nvx;
                vy = nvy;
                vz = nvz;
                t = te;
                face = nf;
                if (exited) ++em;
                if (moved < 0 || moved >= size) {
                    act = false;
                } else if (exited) {
                    pend = true;
                    addr = (nvx >> 3) + (nvy >> 3) * g + (nvz >> 3) * g * g;
                }
            }
        }
        if (it >= max_steps) act = false;
    }

    JumpHit res;
    res.hit = hit;
    res.face = face;
    res.axis_coord = hit ? (face == 0 ? vx : (face == 1 ? vy : vz)) : 0;
    res.t = hit ? t : VVR_BIG_T;
    res.iterations = it;
    res.fetches = fe;
    res.missed_pops = em;
    return res;
}
