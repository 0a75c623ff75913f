// The brick pyramid's hierarchical DDA (HDDA) of one ray, as a __device__
// function: K19 (trace.cu) runs it per primary or shadow ray, and the
// pyramid views of K12, K14 and K15 (grid_view.cuh) and K23
// (meshraster.cu) run it inline.
//
// Port of vvr_tpu/ops/traverse.py `_make_stepper` (fetch :179, ALU step
// :204), `_addr_fns` :131, `_init_state` :361 and `outputs` :495, one
// thread per ray (ops/traverse.py describes the walk). A trip of the loop
// loads the node row if the ray waits for one (8 B of any masks, or the
// whole 16 B row with the FULL early-out), then takes one step: a hit, a
// descend, or a step to the next child cell, which may leave the node
// (an ascend to the coarsest level whose boundary it crossed) or the
// world. The counters equal the JAX stepper's per ray (a step counts one
// iteration, a load one fetch, a node exit its levels).
//
// On an H100 the walk's time follows the instructions a warp issues a
// trip, the union of the paths its lanes take, more than its row loads,
// and at the bench view the in-node step is in most warp-trips, a node
// exit or a descend in fewer (tools/lane_use.py counts them; PERF.md
// section 6, the HDDA's redesign). So the in-node step does the least:
// it skips the world-bounds test (a cell of a node lies in the world),
// and a row's address comes from the level's first row and grid edge
// kept as state (a descend updates them, only an exit that ascends
// recomputes them).
// Measured slower there: answering the fetches of empty nodes from the
// any masks of the ancestors the ray descended through, 10-12% (it skips
// 25% of the primary rays' loads and 59% of the shadow rays', but a warp
// still waits for its other lanes' loads, and the test lengthens the exit
// path); the row address computed at the load; one straight-line path for
// in-node steps and node exits; the ray's cell kept in child units.
//
// Rounding: every float expression keeps the JAX op order and the file
// is compiled with -fmad=false, but for the descend's point o + d*t,
// which XLA's jit contracts into an FMA: __fmaf_rn there. Per-level
// constants (child size, grandchild reciprocal, grid edge, row base) are
// powers of two and a closed form, not tables: a table indexed by the
// level at run time would sit in local memory.
#pragma once

#include "jump_dda.cuh"

// test bit `bit` (0..63) of the 64-bit mask (lo, hi)
static __device__ __forceinline__ bool vvr_bit64(uint32_t lo, uint32_t hi,
                                                 int bit) {
    const uint32_t w = bit >= 32 ? hi : lo;
    return ((w >> (bit & 31)) & 1u) != 0u;
}

// first row of level lvl (1..depth): levels 1..lvl-1 hold 64^(depth-k)
// rows each, so the sum is (64^depth - 64^(depth-lvl+1)) / 63
static __device__ __forceinline__ int vvr_pyr_base(int depth, int lvl) {
    return (int)(((1u << (6 * depth)) - (1u << (6 * (depth - lvl + 1))))
                 / 63u);
}

// whether voxel (vx, vy, vz) of the world is solid: its level-1 node's
// any bit
static __device__ __forceinline__ bool vvr_pyramid_solid(
        const uint32_t* __restrict__ rows, int size, int vx, int vy,
        int vz) {
    const int g = size >> 2;
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(
        rows + (size_t)((vx >> 2) + (vy >> 2) * g + (vz >> 2) * g * g) * 4));
    return vvr_bit64(r.x, r.y,
                     (vx & 3) | ((vy & 3) << 2) | ((vz & 3) << 4));
}

// FULL: the FULL-node early-out (loads whole 16 B rows); STATS: count
// fetches and missed_pops (the iterations are counted for the cap either
// way, and returned only with STATS).
template <bool FULL, bool STATS>
static __device__ JumpHit vvr_pyramid_trace_ray(
        const uint32_t* __restrict__ rows, int size, int depth, float ox,
        float oy, float oz, float dx, float dy, float dz, bool active,
        int max_steps) {
    const float fs = (float)size;
    const float ix = dx == 0.0f ? VVR_BIG_T : 1.0f / dx;
    const float iy = dy == 0.0f ? VVR_BIG_T : 1.0f / dy;
    const float iz = dz == 0.0f ? VVR_BIG_T : 1.0f / dz;
    const int sx = dx > 0.0f ? 1 : -1, sy = dy > 0.0f ? 1 : -1,
              sz = dz > 0.0f ? 1 : -1;
    const int px = dx > 0.0f, py = dy > 0.0f, pz = dz > 0.0f;

    const bool act = active && ox >= 0.0f && ox < fs && oy >= 0.0f
                     && oy < fs && oz >= 0.0f && oz < fs;
    // the root node, its local cell the origin's (truncated, clipped)
    int lvl = depth, nx = 0, ny = 0, nz = 0;
    const float inv_root = __int_as_float((127 - 2 * (depth - 1)) << 23);
    int lx = min(max((int)(ox * inv_root), 0), 3);
    int ly = min(max((int)(oy * inv_root), 0), 3);
    int lz = min(max((int)(oz * inv_root), 0), 3);
    uint32_t alo = 0u, ahi = 0u, flo = 0u, fhi = 0u;
    bool hit = false, pend = act;
    float t = 0.0f;
    int face = 0, hlvl = 1, it = 0, fe = 0, em = 0;
    // the node's level: its first row and its grid's edge
    int base = vvr_pyr_base(depth, lvl), g = 1;
    int addr = base;

    while (act) {
        if (pend) {
            const uint32_t* r = rows + (size_t)addr * 4;
            if (FULL) {
                const uint4 w = __ldg(reinterpret_cast<const uint4*>(r));
                alo = w.x;
                ahi = w.y;
                flo = w.z;
                fhi = w.w;
            } else {
                const uint2 w = __ldg(reinterpret_cast<const uint2*>(r));
                alo = w.x;
                ahi = w.y;
            }
            if (STATS) ++fe;
            pend = false;
        }
        ++it;
        const int bit = lx | (ly << 2) | (lz << 4);
        const bool abit = vvr_bit64(alo, ahi, bit);
        if (abit && (lvl == 1 || (FULL && vvr_bit64(flo, fhi, bit)))) {
            hit = true;
            hlvl = lvl;
            break;
        }
        const int cx = nx * 4 + lx, cy = ny * 4 + ly, cz = nz * 4 + lz;
        if (abit) {
            // descend: the child cell becomes the node; the local cell of
            // the present point in grandchild units
            const float inv_g =
                __int_as_float((127 - 2 * max(lvl - 2, 0)) << 23);
            lx = min(max((int)(__fmaf_rn(dx, t, ox) * inv_g) - cx * 4, 0),
                     3);
            ly = min(max((int)(__fmaf_rn(dy, t, oy) * inv_g) - cy * 4, 0),
                     3);
            lz = min(max((int)(__fmaf_rn(dz, t, oz) * inv_g) - cz * 4, 0),
                     3);
            nx = cx;
            ny = cy;
            nz = cz;
            lvl = lvl - 1;   // >= 1: a set bit at level 1 is a hit
            g <<= 2;
            base -= g * g * g;
            addr = base + nx + (ny + nz * g) * g;
            pend = true;
        } else {
            // step out of the child cell: its exit plane per axis, the
            // child size times the plane's cell index, exact in integers
            // (at most the world's edge)
            const int cs = 2 * (lvl - 1);
            const float tx = vvr_axis_t((float)((cx + px) << cs), ox, dx, ix);
            const float ty = vvr_axis_t((float)((cy + py) << cs), oy, dy, iy);
            const float tz = vvr_axis_t((float)((cz + pz) << cs), oz, dz, iz);
            const float te = fminf(tx, fminf(ty, tz));
            const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
            const int slx = lx + (nf == 0 ? sx : 0);
            const int sly = ly + (nf == 1 ? sy : 0);
            const int slz = lz + (nf == 2 ? sz : 0);
            t = te;
            face = nf;
            if ((unsigned)slx <= 3u && (unsigned)sly <= 3u
                && (unsigned)slz <= 3u) {
                // a step within the node, which lies in the world
                lx = slx;
                ly = sly;
                lz = slz;
            } else {
                const int gcx = nx * 4 + slx, gcy = ny * 4 + sly,
                          gcz = nz * 4 + slz;
                const int gsz = size >> (2 * (lvl - 1));
                if ((unsigned)gcx >= (unsigned)gsz
                    || (unsigned)gcy >= (unsigned)gsz
                    || (unsigned)gcz >= (unsigned)gsz) {
                    break;   // left the world
                }
                // node exit: ascend `a` levels, the trailing base-4 zero
                // digits of the crossed coordinate (32 zeros for 0),
                // capped at the root
                const int crossed = nf == 0 ? gcx : (nf == 1 ? gcy : gcz);
                const int sgn = nf == 0 ? sx : (nf == 1 ? sy : sz);
                const uint32_t cur =
                    (uint32_t)((sgn > 0 ? crossed : crossed + 1) >> 2);
                const int ctz = __popc((cur & (~cur + 1u)) - 1u);
                const int a = min(ctz >> 1, depth - lvl);
                if (STATS) em += a + 1;
                lvl += a;
                nx = gcx >> (2 * (a + 1));
                ny = gcy >> (2 * (a + 1));
                nz = gcz >> (2 * (a + 1));
                lx = (gcx >> (2 * a)) & 3;
                ly = (gcy >> (2 * a)) & 3;
                lz = (gcz >> (2 * a)) & 3;
                if (a > 0) {
                    base = vvr_pyr_base(depth, lvl);
                    g = size >> (2 * lvl);
                }
                addr = base + nx + (ny + nz * g) * g;
                pend = true;
            }
        }
        if (it >= max_steps) break;
    }

    JumpHit res;
    res.hit = hit;
    res.face = face;
    if (hit) {
        // the hit cell's entry-plane block coordinate at its level; the
        // origin's voxel for a hit at t = 0
        const int hl = max(hlvl - 1, 0);
        const int vsz = 1 << (2 * hl);
        const int cc = face == 0 ? nx * 4 + lx
                                 : (face == 1 ? ny * 4 + ly : nz * 4 + lz);
        const int sg = face == 0 ? sx : (face == 1 ? sy : sz);
        res.axis_coord = cc * vsz + (sg < 0 ? vsz - 1 : 0);
        if (t == 0.0f) {
            const float of = face == 0 ? ox : (face == 1 ? oy : oz);
            res.axis_coord = min(max((int)of, 0), size - 1);
        }
    } else {
        res.axis_coord = 0;
    }
    res.t = hit ? t : VVR_BIG_T;
    res.iterations = STATS ? it : 0;
    res.fetches = fe;
    res.missed_pops = em;
    return res;
}
