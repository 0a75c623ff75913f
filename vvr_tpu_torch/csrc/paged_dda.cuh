// The paged-grid DDA of one ray, as a __device__ function: K16
// (trace.cu) runs it per primary or shadow ray, and the paged views
// of K12, K14 and K15 (grid_view.cuh) run it inline.
//
// Port of vvr_tpu/ops/paged.py `_make_stepper` (fetch slot :79-150, step
// :152-267), `_make_ray`, `_init_state` and `_outputs`, one thread per ray
// (ops/paged.py describes the four modes). Every float expression keeps
// the JAX op order and the file is compiled with -fmad=false: `(bound - o)
// * inv` and `floor(o + d*te)` round as the JAX tracer's and the oracle's.
//
// A trip of the loop runs the ray's events in the JAX stepper's order
// until it moves: a page row (a jump moves it; a radius of 0 latches the
// mask and base), the page walk's test of the current superbrick (an empty
// one moves it 8 voxels; an occupied one sends it to its pool row), the
// pool row's load (its subcell mask; the voxel words are read on demand
// through __ldg), the in-brick test and step. Each event counts one
// iteration and the cap is checked after each, so the counters equal the
// JAX stepper's per ray. The page's mask, base and the pool row's address
// stay in registers; the page row is one 16 B load, the subcell mask one
// 8 B load.
#pragma once

#include "jump_dda.cuh"

#define VVR_PG_PEND_PAGE 0
#define VVR_PG_PAGE 1
#define VVR_PG_PEND_POOL 2
#define VVR_PG_BRICK 3

// bit `bit` (0..63) of the 64-bit mask (lo, hi)
static __device__ __forceinline__ bool vvr_mask_bit(uint32_t lo, uint32_t hi,
                                                    int bit) {
    const uint32_t w = bit >= 32 ? hi : lo;
    return ((w >> (bit & 31)) & 1u) != 0u;
}

// popcount(mask & ((1 << bit) - 1)) of the 64-bit mask (lo, hi), with
// shifts below 32 only: the pool row of superbrick `bit` past the base
static __device__ __forceinline__ int vvr_pool_offset(uint32_t lo,
                                                      uint32_t hi, int bit) {
    return bit >= 32 ? __popc(lo) + __popc(hi & ((1u << (bit - 32)) - 1u))
                     : __popc(lo & ((1u << bit) - 1u));
}

static __device__ __forceinline__ int vvr_superbrick_bit(int vx, int vy,
                                                         int vz) {
    return ((vx >> 3) & 3) | (((vy >> 3) & 3) << 2) | (((vz >> 3) & 3) << 4);
}

// whether voxel (vx, vy, vz) of the world is solid: its page's mask, then
// its pool row's voxel bit
static __device__ __forceinline__ bool vvr_paged_solid(
        const uint32_t* __restrict__ prows,
        const uint32_t* __restrict__ brows, int psize, int vx, int vy,
        int vz) {
    const uint4 pr = __ldg(reinterpret_cast<const uint4*>(
        prows + (size_t)((vx >> 5) + (vy >> 5) * psize
                         + (vz >> 5) * psize * psize) * 8));
    const int bit = vvr_superbrick_bit(vx, vy, vz);
    if (!vvr_mask_bit(pr.x, pr.y, bit)) return false;
    const uint32_t* row =
        brows + (size_t)((int)pr.z + vvr_pool_offset(pr.x, pr.y, bit)) * 20;
    return vvr_brick_solid(row, vx & 7, vy & 7, vz & 7);
}

// STATS: count fetches and missed_pops (the iterations are counted for the
// cap either way, and returned only with STATS).
template <bool STATS>
static __device__ JumpHit vvr_paged_trace_ray(
        const uint32_t* __restrict__ prows,
        const uint32_t* __restrict__ brows, int size, int psize, float ox,
        float oy, float oz, float dx, float dy, float dz, bool active,
        int max_steps) {
    const float fs = (float)size;
    const float ix = dx == 0.0f ? VVR_BIG_T : 1.0f / dx;
    const float iy = dy == 0.0f ? VVR_BIG_T : 1.0f / dy;
    const float iz = dz == 0.0f ? VVR_BIG_T : 1.0f / dz;
    const int px = dx > 0.0f, py = dy > 0.0f, pz = dz > 0.0f;
    const int oct_sh = 4 * (px | (py << 1) | (pz << 2));

    const bool act = active && ox >= 0.0f && ox < fs && oy >= 0.0f
                     && oy < fs && oz >= 0.0f && oz < fs;
    int vx = vvr_floor_clip(ox, 0, size - 1);
    int vy = vvr_floor_clip(oy, 0, size - 1);
    int vz = vvr_floor_clip(oz, 0, size - 1);
    bool hit = false;
    float t = 0.0f;
    int face = 0, it = 0, fe = 0, em = 0;
    int mode = VVR_PG_PEND_PAGE;
    uint32_t mlo = 0u, mhi = 0u, slo = 0u, shi = 0u;
    int base = 0;
    const uint32_t* brick = brows;   // the pool row of the ray's brick

    while (act) {
        int lox, hix, loy, hiy, loz, hiz;
        bool jump = false;
        if (mode == VVR_PG_PEND_PAGE) {
            const uint4 pr = __ldg(reinterpret_cast<const uint4*>(
                prows + (size_t)((vx >> 5) + (vy >> 5) * psize
                                 + (vz >> 5) * psize * psize) * 8));
            ++it;
            if (STATS) ++fe;
            const int dval = (int)((pr.w >> oct_sh) & 15u);
            if (dval > 0) {
                // the all-empty box of pages b .. b +- (dval - 1)
                jump = true;
                const int bx = vx >> 5, by = vy >> 5, bz = vz >> 5;
                lox = px ? bx * 32 : (bx - dval + 1) * 32;
                hix = px ? (bx + dval) * 32 - 1 : bx * 32 + 31;
                loy = py ? by * 32 : (by - dval + 1) * 32;
                hiy = py ? (by + dval) * 32 - 1 : by * 32 + 31;
                loz = pz ? bz * 32 : (bz - dval + 1) * 32;
                hiz = pz ? (bz + dval) * 32 - 1 : bz * 32 + 31;
            } else {
                mlo = pr.x;
                mhi = pr.y;
                base = (int)pr.z;
                mode = VVR_PG_PAGE;
                if (it >= max_steps) break;
            }
        }
        if (mode == VVR_PG_PAGE) {
            // the page walk: the current superbrick's bit
            ++it;
            const int bit = vvr_superbrick_bit(vx, vy, vz);
            if (vvr_mask_bit(mlo, mhi, bit)) {
                brick = brows
                        + (size_t)(base + vvr_pool_offset(mlo, mhi, bit))
                          * 20;
                mode = VVR_PG_PEND_POOL;
                if (it >= max_steps) break;
            } else {
                lox = (vx >> 3) << 3;
                hix = lox + 7;
                loy = (vy >> 3) << 3;
                hiy = loy + 7;
                loz = (vz >> 3) << 3;
                hiz = loz + 7;
            }
        }
        if (mode == VVR_PG_PEND_POOL) {
            const uint2 sub = __ldg(reinterpret_cast<const uint2*>(brick + 16));
            slo = sub.x;
            shi = sub.y;
            ++it;
            if (STATS) ++fe;
            mode = VVR_PG_BRICK;
            if (it >= max_steps) break;
        }
        const bool in_brick = mode == VVR_PG_BRICK;
        if (in_brick) {
            // the solid test, then the box of the ray's 2^3 subcell if the
            // row's mask says it is empty, else of its voxel
            const int lx = vx & 7, ly = vy & 7, lz = vz & 7;
            ++it;
            if (vvr_brick_solid(brick, lx, ly, lz)) {
                hit = true;
                break;
            }
            const int sbit = (lx >> 1) | ((ly >> 1) << 2) | ((lz >> 1) << 4);
            const uint32_t sword = sbit >= 32 ? shi : slo;
            const bool big = ((sword >> (sbit & 31)) & 1u) == 0u;
            lox = big ? (vx >> 1) << 1 : vx;
            hix = big ? lox + 1 : vx;
            loy = big ? (vy >> 1) << 1 : vy;
            hiy = big ? loy + 1 : vy;
            loz = big ? (vz >> 1) << 1 : vz;
            hiz = big ? loz + 1 : vz;
        }
        // the exit from the box: its plane is hi + 1 on a positive axis and
        // lo on a negative one
        const int bx = px ? hix + 1 : lox;
        const int by = py ? hiy + 1 : loy;
        const int bz = pz ? hiz + 1 : loz;
        const float tx = vvr_axis_t((float)bx, ox, dx, ix);
        const float ty = vvr_axis_t((float)by, oy, dy, iy);
        const float tz = vvr_axis_t((float)bz, oz, dz, iz);
        const float te = fminf(tx, fminf(ty, tz));
        const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
        const int nvx = nf == 0 ? (px ? bx : bx - 1)
                                : vvr_floor_clip(ox + dx * te, lox, hix);
        const int nvy = nf == 1 ? (py ? by : by - 1)
                                : vvr_floor_clip(oy + dy * te, loy, hiy);
        const int nvz = nf == 2 ? (pz ? bz : bz - 1)
                                : vvr_floor_clip(oz + dz * te, loz, hiz);
        const int moved = nf == 0 ? nvx : (nf == 1 ? nvy : nvz);
        const int stayed = nf == 0 ? vx : (nf == 1 ? vy : vz);
        const bool left_brick = (moved >> 3) != (stayed >> 3);
        const bool left_page = (moved >> 5) != (stayed >> 5);
        if (STATS && in_brick && left_brick) ++em;
        vx = nvx;
        vy = nvy;
        vz = nvz;
        t = te;
        face = nf;
        if (jump) {
            // a page jump tests every axis; the ray waits on the next row
            if ((unsigned)nvx >= (unsigned)size
                || (unsigned)nvy >= (unsigned)size
                || (unsigned)nvz >= (unsigned)size) {
                break;
            }
        } else {
            if ((unsigned)moved >= (unsigned)size) break;   // left the world
            if (left_page) {
                mode = VVR_PG_PEND_PAGE;
            } else if (in_brick && left_brick) {
                // the next brick of the page: its pool row, or the walk
                const int bit = vvr_superbrick_bit(nvx, nvy, nvz);
                if (vvr_mask_bit(mlo, mhi, bit)) {
                    brick = brows
                            + (size_t)(base + vvr_pool_offset(mlo, mhi, bit))
                              * 20;
                    mode = VVR_PG_PEND_POOL;
                } else {
                    mode = VVR_PG_PAGE;
                }
            }
        }
        if (it >= max_steps) break;
    }

    JumpHit res;
    res.hit = hit;
    res.face = face;
    res.axis_coord = hit ? (face == 0 ? vx : (face == 1 ? vy : vz)) : 0;
    res.t = hit ? t : VVR_BIG_T;
    res.iterations = STATS ? it : 0;
    res.fetches = fe;
    res.missed_pops = em;
    return res;
}
