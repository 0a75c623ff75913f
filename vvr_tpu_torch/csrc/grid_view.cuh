// One tracer interface for the three grids: the kernels that trace inline
// (K12's residue, K14's samples, K15's lights and overlap AO) take a grid
// view as a template parameter and get a flat, a paged and a pyramid
// instantiation from one body.
//
//   VvrFlatView {rows, size}: the jump grid (jump_dda.cuh, K1's DDA); its
//     kernels walk the first crossings near a shadow ray's start
//     (sunmask.cuh vvr_near_segment) before the DDA;
//   VvrPagedView {prows, brows, size, psize}: the paged grid
//     (paged_dda.cuh, K16's DDA); no near walk, as the JAX frame sends
//     those lanes straight to `trace_paged` (vvr_tpu/render/frame.py:388,
//     :475);
//   VvrPyramidViewT<FULL> {rows, size, depth}: the brick pyramid
//     (pyramid_dda.cuh, K19's HDDA; FULL: the FULL-node early-out, which
//     only K19 offers: the JAX frame walks the any masks, frame.py:114);
//     no near walk either (frame.py:389, :475); `solid` is the level-1
//     any bit.
//
// Each has `trace<STATS>` (a ray's JumpHit) and `solid` (a voxel of the
// world); NEAR_WALK says whether the kernels walk first.
#pragma once

#include "jump_dda.cuh"
#include "paged_dda.cuh"
#include "pyramid_dda.cuh"

struct VvrFlatView {
    static constexpr bool NEAR_WALK = true;
    const uint32_t* rows;
    int size;

    template <bool STATS>
    __device__ __forceinline__ JumpHit trace(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             bool active,
                                             int max_steps) const {
        return vvr_jump_trace_ray<STATS>(rows, size, ox, oy, oz, dx, dy, dz,
                                         active, max_steps);
    }

    __device__ __forceinline__ bool solid(int vx, int vy, int vz) const {
        const int g = size >> 3;
        return vvr_brick_solid(
            rows + (size_t)((vx >> 3) + (vy >> 3) * g + (vz >> 3) * g * g)
                       * 32,
            vx & 7, vy & 7, vz & 7);
    }
};

struct VvrPagedView {
    static constexpr bool NEAR_WALK = false;
    const uint32_t* prows;
    const uint32_t* brows;
    int size, psize;

    template <bool STATS>
    __device__ __forceinline__ JumpHit trace(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             bool active,
                                             int max_steps) const {
        return vvr_paged_trace_ray<STATS>(prows, brows, size, psize, ox, oy,
                                          oz, dx, dy, dz, active, max_steps);
    }

    __device__ __forceinline__ bool solid(int vx, int vy, int vz) const {
        return vvr_paged_solid(prows, brows, psize, vx, vy, vz);
    }
};

template <bool FULL>
struct VvrPyramidViewT {
    static constexpr bool NEAR_WALK = false;
    const uint32_t* rows;
    int size, depth;

    template <bool STATS>
    __device__ __forceinline__ JumpHit trace(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             bool active,
                                             int max_steps) const {
        return vvr_pyramid_trace_ray<FULL, STATS>(rows, size, depth, ox, oy,
                                                  oz, dx, dy, dz, active,
                                                  max_steps);
    }

    __device__ __forceinline__ bool solid(int vx, int vy, int vz) const {
        return vvr_pyramid_solid(rows, size, vx, vy, vz);
    }
};

// the frame's view of the pyramid: the any-only walk
using VvrPyramidView = VvrPyramidViewT<false>;
