// K17 svt_update_brick: the dynamic world's per-frame pass over one 64^3
// RGBA8 brick of the sparse voxel texture. Replaces
// vvr_tpu/world/bricks.py:94-124 `svt_update_brick` (world/bricks.py wraps
// it); one thread a voxel, all four channels.
//
// A voxel whose alpha is 255 takes the hash colour of its world position
// (vvr_block_colour, shading.cuh) with alpha 1; any other the mean of its
// 3x3x3 neighbourhood, clamped to the brick, times 254/255; each channel is
// stored as clip(v * 255 + 0.5, 0, 255) cut to u8. The bytes are those of
// the jitted JAX pass, whose rounding XLA decides (world/bricks.py): the
// taps are u8 * float32(1/255), summed in (dz, dy, dx) order from zero, the
// three taps with dy = dx = 1 contracted into the sum (acc = fma(u, 1/255,
// acc)), the sum times float32(float32(1/27) * float32(254/255)) in one
// multiply, and v * 255 + 0.5 one FMA. The file is built with -fmad=false,
// so __fmaf_rn stands exactly where XLA contracts and nowhere else.
//
// The JAX pass is functional: a voxel's neighbours are read before any is
// written. The kernel writes into a scratch brick and the entry point then
// copies it into the slot on the same stream, so no block reads a voxel
// another block has already replaced.
//
// What bounds it on an H100: the brick's 1 MiB read and 1 MiB written, and
// the copy's 1 MiB each way; the 27 neighbour loads of a voxel hit L1.
#include "shading.cuh"

#define VVR_SVT_EDGE 64

static __device__ __forceinline__ int vvr_svt_clamp(int v) {
    return v < 0 ? 0 : (v > VVR_SVT_EDGE - 1 ? VVR_SVT_EDGE - 1 : v);
}

static __device__ __forceinline__ unsigned char vvr_svt_u8(float v) {
    const float y = __fmaf_rn(v, 255.0f, 0.5f);
    return (unsigned char)fminf(fmaxf(y, 0.0f), 255.0f);
}

// block (64, 4): x along the brick's row, 4 rows of y; grid (16, 64): the
// rows of y by 4, z
__global__ void __launch_bounds__(256)
vvr_svt_update_kernel(const uchar4* __restrict__ src,
                      uchar4* __restrict__ dst, int ox, int oy, int oz) {
    const int x = threadIdx.x;
    const int y = blockIdx.x * 4 + threadIdx.y;
    const int z = blockIdx.y;
    const int i = (z * VVR_SVT_EDGE + y) * VVR_SVT_EDGE + x;
    const uchar4 c = src[i];
    uchar4 out;
    if (c.w == 255) {
        float r, g, b;
        vvr_block_colour(x + ox, y + oy, z + oz, &r, &g, &b);
        out = make_uchar4(vvr_svt_u8(r), vvr_svt_u8(g), vvr_svt_u8(b),
                          vvr_svt_u8(1.0f));
    } else {
        const float k255 = 0x1.010102p-8f;       // float32(1/255)
        const float kblur = 0x1.2e37b4p-5f;      // (1/27)(254/255) folded
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
            const int zz = vvr_svt_clamp(z + dz - 1);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                const int yy = vvr_svt_clamp(y + dy - 1);
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const int xx = vvr_svt_clamp(x + dx - 1);
                    const uchar4 t =
                        src[(zz * VVR_SVT_EDGE + yy) * VVR_SVT_EDGE + xx];
                    if (dy == 1 && dx == 1) {
                        a0 = __fmaf_rn((float)t.x, k255, a0);
                        a1 = __fmaf_rn((float)t.y, k255, a1);
                        a2 = __fmaf_rn((float)t.z, k255, a2);
                        a3 = __fmaf_rn((float)t.w, k255, a3);
                    } else {
                        a0 = a0 + (float)t.x * k255;
                        a1 = a1 + (float)t.y * k255;
                        a2 = a2 + (float)t.z * k255;
                        a3 = a3 + (float)t.w * k255;
                    }
                }
            }
        }
        out = make_uchar4(vvr_svt_u8(a0 * kblur), vvr_svt_u8(a1 * kblur),
                          vvr_svt_u8(a2 * kblur), vvr_svt_u8(a3 * kblur));
    }
    dst[i] = out;
}

// bricks: u8 (num_bricks, 64, 64, 64, 4); slot: the brick to update;
// (ox, oy, oz): its world origin; scratch: one brick (1 MiB)
extern "C" int vvr_svt_update_brick(void* bricks, int num_bricks, int slot,
                                    int ox, int oy, int oz, void* scratch,
                                    void* stream) {
    if (slot < 0 || slot >= num_bricks) return (int)cudaErrorInvalidValue;
    const size_t voxels = (size_t)VVR_SVT_EDGE * VVR_SVT_EDGE * VVR_SVT_EDGE;
    uchar4* brick = (uchar4*)bricks + (size_t)slot * voxels;
    cudaStream_t s = (cudaStream_t)stream;
    vvr_svt_update_kernel<<<dim3(VVR_SVT_EDGE / 4, VVR_SVT_EDGE),
                            dim3(VVR_SVT_EDGE, 4), 0, s>>>(
        brick, (uchar4*)scratch, ox, oy, oz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyAsync(brick, scratch, voxels * sizeof(uchar4),
                                cudaMemcpyDeviceToDevice, s);
}
