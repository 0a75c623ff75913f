// The jump-grid DDA of one ray, as a __device__ function: K1
// (trace.cu) runs it per primary or shadow ray, and K12
// (sunshadow.cu) runs it inline for its residue, without a second copy.
//
// Port of vvr_tpu/ops/jump.py `_make_stepper` (fetch :94-165, in-brick
// step :167-235), `_make_ray` :240, `_init_state` :255 and `_outputs` :275,
// one thread per ray. Every float expression keeps the JAX op order and the
// file is compiled with -fmad=false: `floor(o + d*te)` and
// `(bound - o) * inv` must round as the oracle's (render/oracle.py) do.
//
// Every sub-step is the exit from a box [lo, hi] per axis (ops/jump.py):
// the jump box of a row whose octant distance is > 0, an empty 2^3 subcell,
// or one voxel. A trip of the loop loads the row if the ray waits for one,
// then takes one box exit, so a warp whose lanes jump and lanes step in a
// brick runs one body, not both; a load that enters a brick goes on to its
// in-brick test in the same trip.
#pragma once

#include "common.cuh"

struct JumpHit {
    bool hit;
    int face;
    int axis_coord;
    float t;
    int iterations;   // the counters are 0 unless STATS
    int fetches;
    int missed_pops;
};

// clip(int(floor(x)), lo, hi): floor and convert in one instruction, which
// saturates at the int range (a NaN gives 0), then an integer clamp; three
// instructions where a float clamp takes six (faster on the H100, PERF.md)
static __device__ __forceinline__ int vvr_floor_clip(float x, int lo,
                                                     int hi) {
    return min(max(__float2int_rd(x), lo), hi);
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

// STATS: count fetches and missed_pops (the iterations are counted for the
// cap either way, and returned only with STATS).
template <bool STATS>
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

    const bool act = active && ox >= 0.0f && ox < fs && oy >= 0.0f
                     && oy < fs && oz >= 0.0f && oz < fs;
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
        int lox, hix, loy, hiy, loz, hiz;
        bool jump = false;
        if (pend) {
            // the row: its subcell masks (words 17-18) and octant distance
            // (word 24 + oct), two 16 B loads issued together
            const uint32_t* r = rows + (size_t)addr * 32;
            const uint4 sub = __ldg(reinterpret_cast<const uint4*>(r + 16));
            const uint4 dist =
                __ldg(reinterpret_cast<const uint4*>(r + 24 + (oct & 4)));
            const int o3 = oct & 3;
            const int dval = (int)(o3 == 0 ? dist.x
                                   : o3 == 1 ? dist.y
                                   : o3 == 2 ? dist.z : dist.w);
            ++it;
            if (STATS) ++fe;
            if (dval > 0) {
                // the all-empty box of superbricks b .. b +- (dval - 1)
                jump = true;
                const int bx = vx >> 3, by = vy >> 3, bz = vz >> 3;
                lox = px ? bx * 8 : (bx - dval + 1) * 8;
                hix = px ? (bx + dval) * 8 - 1 : bx * 8 + 7;
                loy = py ? by * 8 : (by - dval + 1) * 8;
                hiy = py ? (by + dval) * 8 - 1 : by * 8 + 7;
                loz = pz ? bz * 8 : (bz - dval + 1) * 8;
                hiz = pz ? (bz + dval) * 8 - 1 : bz * 8 + 7;
            } else {
                row = r;
                slo = sub.y;
                shi = sub.z;
                pend = false;
                if (it >= max_steps) break;  // the cap, between load and step
            }
        }
        if (!jump) {
            // in-brick: the solid test, then the box of the ray's 2^3
            // subcell if the row's mask says it is empty, else of its voxel
            const int lx = vx & 7, ly = vy & 7, lz = vz & 7;
            ++it;
            if (vvr_brick_solid(row, lx, ly, lz)) {
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
        const bool exited = (moved >> 3) != (stayed >> 3);  // every jump
        if (STATS && exited && !jump) ++em;
        vx = nvx;
        vy = nvy;
        vz = nvz;
        t = te;
        face = nf;
        if ((unsigned)nvx >= (unsigned)size || (unsigned)nvy >= (unsigned)size
            || (unsigned)nvz >= (unsigned)size) {
            break;  // left the world
        }
        if (exited) {
            pend = true;
            addr = (nvx >> 3) + (nvy >> 3) * g + (nvz >> 3) * g * g;
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
