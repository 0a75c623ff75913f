// K1, K16 and K19: a grid's trace, one thread per ray (ops/jump.py,
// ops/paged.py and ops/traverse.py wrap them). K1 replaces
// vvr_tpu/ops/jump.py:289 `trace_jump` on the jump grid, K16
// vvr_tpu/ops/paged.py:322 `trace_paged` on the paged grid, K19
// vvr_tpu/ops/traverse.py:406 `trace` (the HDDA) on the brick pyramid; one
// kernel body serves all three through the grid view of grid_view.cuh,
// whose `trace` is the per-ray DDA (vvr_jump_trace_ray in jump_dda.cuh,
// vvr_paged_trace_ray in paged_dda.cuh, vvr_pyramid_trace_ray in
// pyramid_dda.cuh).
//
// Bound on an H100 by each ray's chain of dependent row loads and by warps
// whose lanes walk apart, not by bytes (ops/jump.py). The page table and
// the pool of the 1024^3 world (41 MiB) fit in the 50 MB L2, the jump
// grid's rows (256 MiB) do not; yet at config 5's view K1 on the jump grid
// of that world is the faster of the two (PERF.md section 6). Given the
// image width, warp w traces the 8x4 pixel tile w (row-major over the
// tiles; lane l the pixel (l % 8, l / 8)), whose rays stay closer together
// than a 32x1 row's; the outputs stay in the rays' row-major order. The
// counters are written only when the caller asks for them (STATS), and one
// direction for every ray (d_stride 0) replaces a materialized (N, 3) copy.
#include "grid_view.cuh"

// threads per block: 64, 128 and 256 measured about equal on the H100
#define VVR_TRACE_BLOCK 128

template <class View, bool STATS>
__global__ void __launch_bounds__(VVR_TRACE_BLOCK) vvr_trace_kernel(
        const View grid, const float* __restrict__ o,
        const float* __restrict__ d, int d_stride,
        const uint8_t* __restrict__ active, int n, int width, int max_steps,
        uint8_t* __restrict__ hit, int* __restrict__ face,
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
    const JumpHit r = grid.template trace<STATS>(
        o[3 * ray], o[3 * ray + 1], o[3 * ray + 2], dr[0], dr[1], dr[2], act,
        max_steps);
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

// The trace of n rays on a grid view: d_stride 3 for (n, 3) directions, 0
// for one direction of every ray; width > 0: the rays are an image's
// pixels, width to a row, traced by 8x4 tiles; null counter pointers: the
// counters are not written.
template <class View>
static int vvr_trace(const View grid, const void* o, const void* d,
                     int d_stride, const void* active, int n, int width,
                     int max_steps, void* hit, void* face, void* axis_coord,
                     void* t, void* iterations, void* fetches,
                     void* missed_pops, void* stream) {
    if (n > 0) {
        const int threads =
            width > 0 ? ((width + 7) >> 3) * ((n / width + 3) >> 2) * 32 : n;
        const dim3 blocks(vvr_blocks(threads, VVR_TRACE_BLOCK));
        auto kernel = iterations != nullptr ? vvr_trace_kernel<View, true>
                                            : vvr_trace_kernel<View, false>;
        kernel<<<blocks, VVR_TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
            grid, (const float*)o, (const float*)d, d_stride,
            (const uint8_t*)active, n, width, max_steps, (uint8_t*)hit,
            (int*)face, (int*)axis_coord, (float*)t, (int*)iterations,
            (int*)fetches, (int*)missed_pops);
    }
    return (int)cudaGetLastError();
}

// K1: the jump grid's rows and size.
extern "C" int vvr_jump_trace(const void* rows, int size, const void* o,
                              const void* d, int d_stride,
                              const void* active, int n, int width,
                              int max_steps, void* hit, void* face,
                              void* axis_coord, void* t, void* iterations,
                              void* fetches, void* missed_pops,
                              void* stream) {
    return vvr_trace(VvrFlatView{(const uint32_t*)rows, size}, o, d,
                     d_stride, active, n, width, max_steps, hit, face,
                     axis_coord, t, iterations, fetches, missed_pops, stream);
}

// K16: the paged grid's page table and pool, its true size and its
// page-table edge.
extern "C" int vvr_paged_trace(const void* prows, const void* brows,
                               int size, int psize, const void* o,
                               const void* d, int d_stride,
                               const void* active, int n, int width,
                               int max_steps, void* hit, void* face,
                               void* axis_coord, void* t, void* iterations,
                               void* fetches, void* missed_pops,
                               void* stream) {
    return vvr_trace(VvrPagedView{(const uint32_t*)prows,
                                  (const uint32_t*)brows, size, psize},
                     o, d, d_stride, active, n, width, max_steps, hit, face,
                     axis_coord, t, iterations, fetches, missed_pops, stream);
}

// K19: the brick pyramid's rows, size and depth; use_full: the FULL-node
// early-out (16 B rows), else the any-only walk (8 B of each row). On the
// H100 its time follows the instructions its warps issue a trip more than
// its row loads (pyramid_dda.cuh).
extern "C" int vvr_pyramid_trace(const void* rows, int size, int depth,
                                 int use_full, const void* o, const void* d,
                                 int d_stride, const void* active, int n,
                                 int width, int max_steps, void* hit,
                                 void* face, void* axis_coord, void* t,
                                 void* iterations, void* fetches,
                                 void* missed_pops, void* stream) {
    if (depth < 1 || depth > 5 || size != 1 << (2 * depth)) {
        return (int)cudaErrorInvalidValue;
    }
    if (use_full) {
        return vvr_trace(VvrPyramidViewT<true>{(const uint32_t*)rows, size,
                                               depth},
                         o, d, d_stride, active, n, width, max_steps, hit,
                         face, axis_coord, t, iterations, fetches,
                         missed_pops, stream);
    }
    return vvr_trace(VvrPyramidView{(const uint32_t*)rows, size, depth}, o,
                     d, d_stride, active, n, width, max_steps, hit, face,
                     axis_coord, t, iterations, fetches, missed_pops,
                     stream);
}

extern "C" const char* vvr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
