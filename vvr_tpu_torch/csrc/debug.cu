// K21 debug_image: the debug heatmaps of a frame, one thread a pixel
// (ops/debug.py wraps it and holds the plain version). Replaces
// vvr_tpu/render/frame.py:701 `_debug_image` with `heatmap` (:124) over
// bounce 0's record (:252-255): types 1, 2 and 5 map a counter of the
// primary trace (iterations / 256, fetches / 32, missed_pops / 64) blue
// -> green -> red; type 3 the entry face's normal clipped to [0, 1]; type
// 4 the block coordinates of the hit reconstruction (surface.cuh),
// floor-mod 16, over 16 (b & 15 is the floor-mod for every int32, the
// saturated ones of a miss's far point included). It writes the HDR
// frame's rgb planes in place; alpha stays.
//
// What bounds it on an H100: bytes. A pixel reads 24 B of rays and 8 B of
// face and axis_coord (types 3, 4) or 4 B of a counter (1, 2, 5), and
// writes 12 B; a few dozen operations.
#include "surface.cuh"

#define VVR_K21_BLOCK 256

static __device__ __forceinline__ float3 vvr_heatmap(float v) {
    const float x = vvr_clamp(v, 0.0f, 1.0f);
    return make_float3(vvr_clamp(2.0f * x - 1.0f, 0.0f, 1.0f),
                       1.0f - fabsf(2.0f * x - 1.0f),
                       vvr_clamp(1.0f - 2.0f * x, 0.0f, 1.0f));
}

__global__ void __launch_bounds__(VVR_K21_BLOCK) vvr_debug_image_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const int* __restrict__ face, const int* __restrict__ axis_coord,
        const int* __restrict__ counter, float* __restrict__ out, int n,
        int debug_type) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float3 c;
    if (debug_type == 1 || debug_type == 2 || debug_type == 5) {
        const float scale = debug_type == 1   ? 256.0f
                            : debug_type == 2 ? 32.0f : 64.0f;
        c = vvr_heatmap((float)counter[i] / scale);
    } else {
        const Surface s = vvr_reconstruct(o[3 * i], o[3 * i + 1],
                                          o[3 * i + 2], d[3 * i],
                                          d[3 * i + 1], d[3 * i + 2],
                                          face[i], axis_coord[i]);
        if (debug_type == 3) {
            c = make_float3(vvr_clamp(s.nx, 0.0f, 1.0f),
                            vvr_clamp(s.ny, 0.0f, 1.0f),
                            vvr_clamp(s.nz, 0.0f, 1.0f));
        } else {
            c = make_float3((float)(s.bx & 15) / 16.0f,
                            (float)(s.by & 15) / 16.0f,
                            (float)(s.bz & 15) / 16.0f);
        }
    }
    const size_t m = (size_t)n;
    out[i] = c.x;
    out[m + i] = c.y;
    out[2 * m + i] = c.z;
}

// K21 over n pixels: o, d (n, 3) float32, face and axis_coord (n,) int32,
// counter (n,) int32 for types 1, 2 and 5 (else unread, may be null),
// out the planar HDR frame (>= 3, n) float32, its rgb planes written
extern "C" int vvr_debug_image(const void* o, const void* d,
                               const void* face, const void* axis_coord,
                               const void* counter, void* out, int n,
                               int debug_type, void* stream) {
    const bool heat = debug_type == 1 || debug_type == 2 || debug_type == 5;
    if (debug_type < 1 || debug_type > 5 || (heat && counter == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n > 0) {
        vvr_debug_image_kernel<<<vvr_blocks(n, VVR_K21_BLOCK), VVR_K21_BLOCK,
                                 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const int*)face,
            (const int*)axis_coord, (const int*)counter, (float*)out, n,
            debug_type);
    }
    return (int)cudaGetLastError();
}
