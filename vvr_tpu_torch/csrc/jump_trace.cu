// K1: the jump-grid trace, one thread per ray (ops/jump.py wraps it).
// Replaces vvr_tpu/ops/jump.py:289 `trace_jump`; the per-ray DDA is
// vvr_jump_trace_ray in jump_dda.cuh.
//
// Bound on an H100 by each ray's chain of dependent row loads and by warps
// whose lanes walk apart, not by bytes (ops/jump.py). Given the image width,
// warp w traces the 8x4 pixel tile w (row-major over the tiles; lane l the
// pixel (l % 8, l / 8)), whose rays stay closer together than a 32x1 row's;
// the outputs stay in the rays' row-major order. The counters are written
// only when the caller asks for them (STATS), and one direction for every
// ray (d_stride 0) replaces a materialized (N, 3) copy.
#include "jump_dda.cuh"

// threads per block: 64, 128 and 256 measured about equal on the H100
#define VVR_K1_BLOCK 128

template <bool STATS>
__global__ void __launch_bounds__(VVR_K1_BLOCK) vvr_jump_trace_kernel(
        const uint32_t* __restrict__ rows, int size,
        const float* __restrict__ o, const float* __restrict__ d,
        int d_stride, const uint8_t* __restrict__ active, int n, int width,
        int max_steps, uint8_t* __restrict__ hit, int* __restrict__ face,
        int* __restrict__ axis_coord, float* __restrict__ t,
        int* __restrict__ iterations, int* __restrict__ fetches,
        int* __restrict__ missed_pops) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    int ray = i;
    if (width > 0) {
        const int tiles_x = (width + 7) >> 3;
        const int tile = i >> 5, lane = i & 31;
        const int x = (tile % tiles_x) * 8 + (lane & 7);
        const int y = (tile / tiles_x) * 4 + (lane >> 3);
        if (x >= width) return;
        ray = y * width + x;
    }
    if (ray >= n) return;
    const bool act = active == nullptr || active[ray] != 0;
    const float* dr = d + (size_t)d_stride * ray;
    const JumpHit r = vvr_jump_trace_ray<STATS>(
        rows, size, o[3 * ray], o[3 * ray + 1], o[3 * ray + 2], dr[0], dr[1],
        dr[2], act, max_steps);
    hit[ray] = r.hit ? 1 : 0;
    face[ray] = r.face;
    axis_coord[ray] = r.axis_coord;
    t[ray] = r.t;
    if (STATS) {
        iterations[ray] = r.iterations;
        fetches[ray] = r.fetches;
        missed_pops[ray] = r.missed_pops;
    }
}

// K1 over n rays: d_stride 3 for (n, 3) directions, 0 for one direction of
// every ray; width > 0: the rays are an image's pixels, width to a row,
// traced by 8x4 tiles; null counter pointers: the counters are not written.
extern "C" int vvr_jump_trace(const void* rows, int size, const void* o,
                              const void* d, int d_stride,
                              const void* active, int n, int width,
                              int max_steps, void* hit, void* face,
                              void* axis_coord, void* t, void* iterations,
                              void* fetches, void* missed_pops,
                              void* stream) {
    if (n > 0) {
        const int threads =
            width > 0 ? ((width + 7) >> 3) * ((n / width + 3) >> 2) * 32 : n;
        const dim3 grid(vvr_blocks(threads, VVR_K1_BLOCK));
        auto kernel = iterations != nullptr ? vvr_jump_trace_kernel<true>
                                            : vvr_jump_trace_kernel<false>;
        kernel<<<grid, VVR_K1_BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)rows, size, (const float*)o, (const float*)d,
            d_stride, (const uint8_t*)active, n, width, max_steps,
            (uint8_t*)hit, (int*)face, (int*)axis_coord, (float*)t,
            (int*)iterations, (int*)fetches, (int*)missed_pops);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* vvr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
