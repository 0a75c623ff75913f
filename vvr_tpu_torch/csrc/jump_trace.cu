// K1: the jump-grid trace, one thread per ray (ops/jump.py wraps it).
// Replaces vvr_tpu/ops/jump.py:289 `trace_jump`; the per-ray DDA is
// vvr_jump_trace_ray in jump_dda.cuh.
#include "jump_dda.cuh"

__global__ void vvr_jump_trace_kernel(
        const uint32_t* __restrict__ rows, int size,
        const float* __restrict__ o, const float* __restrict__ d,
        const uint8_t* __restrict__ active, int n, int max_steps,
        uint8_t* __restrict__ hit, int* __restrict__ face,
        int* __restrict__ axis_coord, float* __restrict__ t,
        int* __restrict__ iterations, int* __restrict__ fetches,
        int* __restrict__ missed_pops) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const bool act = active == nullptr || active[i] != 0;
    const JumpHit r = vvr_jump_trace_ray(
        rows, size, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
        d[3 * i + 1], d[3 * i + 2], act, max_steps);
    hit[i] = r.hit ? 1 : 0;
    face[i] = r.face;
    axis_coord[i] = r.axis_coord;
    t[i] = r.t;
    iterations[i] = r.iterations;
    fetches[i] = r.fetches;
    missed_pops[i] = r.missed_pops;
}

extern "C" int vvr_jump_trace(const void* rows, int size, const void* o,
                              const void* d, const void* active, int n,
                              int max_steps, void* hit, void* face,
                              void* axis_coord, void* t, void* iterations,
                              void* fetches, void* missed_pops,
                              void* stream) {
    if (n > 0) {
        vvr_jump_trace_kernel<<<vvr_blocks(n, 128), 128, 0,
                                (cudaStream_t)stream>>>(
            (const uint32_t*)rows, size, (const float*)o, (const float*)d,
            (const uint8_t*)active, n, max_steps, (uint8_t*)hit, (int*)face,
            (int*)axis_coord, (float*)t, (int*)iterations, (int*)fetches,
            (int*)missed_pops);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* vvr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
