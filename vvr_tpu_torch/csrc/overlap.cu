// K20 overlap_density: the overlap AO library's densities on the brick
// pyramid, one thread a position (ops/overlap.py wraps it and holds the
// plain version). Replaces vvr_tpu/ops/overlap.py:62
// `cube_overlap_density`, :81 `planar_overlap_density` and :117
// `overlap_ao`; the device functions are overlap.cuh's, which K15 also
// runs for the frame's overlap AO.
//
// What bounds it on an H100: its operations, not bytes: a position reads
// 12 B (16 with an axis, 28 for the AO) and writes 4, while its cells
// ((2k+1)^3 or (2k+1)^2; 58 for the AO) each cost about 25 operations and
// one 8 B row load of the pyramid's level 1, neighbouring positions'
// rows shared through L1. One thread a position, no shared memory.
#include "grid_view.cuh"
#include "overlap.cuh"

#define VVR_K20_BLOCK 128

// mode 0: the cube density at pos; 1: the planar density across axis;
// 2: overlap_ao at (pos, normal, axis as the face)
__global__ void __launch_bounds__(VVR_K20_BLOCK) vvr_overlap_density_kernel(
        const VvrPyramidView V, const float* __restrict__ pos,
        const float* __restrict__ normal, const int* __restrict__ axis,
        int n, int mode, float half, int k, float scale,
        float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float cx = pos[3 * i], cy = pos[3 * i + 1], cz = pos[3 * i + 2];
    float r;
    if (mode == 0) {
        r = vvr_cube_overlap_sum(V, cx, cy, cz, half, k) * scale;
    } else if (mode == 1) {
        r = vvr_planar_overlap_sum(V, cx, cy, cz, half, k, axis[i]) * scale;
    } else {
        r = vvr_overlap_ao(V, cx, cy, cz, normal[3 * i], normal[3 * i + 1],
                           normal[3 * i + 2], axis[i]);
    }
    out[i] = r;
}

// K20 over n positions (n, 3) float32 on the pyramid (rows, size, depth):
// mode 0 the cube of half-edge `half`, 1 the square across axis (n,)
// int32, both over offsets -k .. k and times `scale` (the float32
// reciprocal of the box's float32 volume or area); mode 2 overlap_ao with
// normal (n, 3) and the face axis (half, k, scale unused)
extern "C" int vvr_overlap_density(const void* rows, int size, int depth,
                                   const void* pos, const void* normal,
                                   const void* axis, int n, int mode,
                                   float half, int k, float scale, void* out,
                                   void* stream) {
    if (mode < 0 || mode > 2 || (mode > 0 && axis == nullptr)
        || (mode == 2 && normal == nullptr) || k < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (n > 0) {
        const VvrPyramidView V = {(const uint32_t*)rows, size, depth};
        vvr_overlap_density_kernel<<<vvr_blocks(n, VVR_K20_BLOCK),
                                     VVR_K20_BLOCK, 0,
                                     (cudaStream_t)stream>>>(
            V, (const float*)pos, (const float*)normal, (const int*)axis, n,
            mode, half, k, scale, (float*)out);
    }
    return (int)cudaGetLastError();
}
