// What K9 (raster.cu), K11 (sunshadow.cu) and K22 (meshraster.cu) share:
// the face table, the float-to-int helpers, their tile CTAs' scan, and an
// exclusive scan in int64 of counts into offsets (K9 and K22 scan their
// tile counts in one block, K11 its (list, block) counts in two launches
// whose users add each block's carry), whose total stays on the device, so
// no capacity is fixed and nothing is read back.
#pragma once

#include "common.cuh"

// vvr_tpu_torch/world/faces.py FaceSet.device_tuple(), int32 each
struct VvrFaces {
    const int* vx;
    const int* vy;
    const int* vz;
    const int* axis;
    const int* sgn;
    const int* eu;
    const int* ev;
    const int* einfo;
    int n;
};

// int(floor(x)) and int(ceil(x)), clamped to +-1e9 in float first so that
// no huge value reaches the conversion
static __device__ __forceinline__ int vvr_floor_int(float x) {
    return (int)vvr_clamp(floorf(x), -1e9f, 1e9f);
}

static __device__ __forceinline__ int vvr_ceil_int(float x) {
    return (int)vvr_clamp(ceilf(x), -1e9f, 1e9f);
}

// inclusive sum of x over the 1024 threads of the block; `ws` is 32 words
// of shared memory, free again when this returns
static __device__ long long vvr_block_scan(long long x, long long* ws) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    long long s = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
    }
    if (lane == 31) ws[w] = s;
    __syncthreads();
    if (w == 0) {
        long long v = ws[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += y;
        }
        ws[lane] = v;
    }
    __syncthreads();
    const long long r = (w > 0 ? ws[w - 1] : 0) + s;
    __syncthreads();
    return r;
}

// inclusive sum of x over the CTA's threads (the tile CTAs of K9, K11
// and K22);
// `ws` holds one int per warp
static __device__ int vvr_tile_scan(int x, int* ws) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int s = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
    }
    if (lane == 31) ws[w] = s;
    __syncthreads();
    for (int k = 0; k < w; ++k) s += ws[k];
    return s;
}

static __global__ void vvr_scan_blocks_kernel(long long* v, int n,
                                              long long* bsum) {
    __shared__ long long ws[32];
    const int i = blockIdx.x * 1024 + threadIdx.x;
    const long long x = i < n ? v[i] : 0;
    const long long incl = vvr_block_scan(x, ws);
    if (i < n) v[i] = incl - x;
    if (threadIdx.x == 1023) bsum[blockIdx.x] = incl;
}

// exclusive scan of bsum[0..nb) in place by one block of 1024 threads,
// their sum to *total; `ws` (32 words) and `carry` are shared memory
static __device__ void vvr_scan_top(long long* bsum, int nb,
                                    long long* total, long long* ws,
                                    long long* carry) {
    if (threadIdx.x == 0) *carry = 0;
    __syncthreads();
    for (int base = 0; base < nb; base += 1024) {
        const int i = base + threadIdx.x;
        const long long x = i < nb ? bsum[i] : 0;
        const long long incl = vvr_block_scan(x, ws);
        const long long c = *carry;
        __syncthreads();
        if (i < nb) bsum[i] = c + incl - x;
        if (threadIdx.x == 1023) *carry = c + incl;
        __syncthreads();
    }
    if (threadIdx.x == 0) *total = *carry;
}

static __global__ void vvr_scan_top_kernel(long long* bsum, int nb,
                                           long long* total) {
    __shared__ long long ws[32];
    __shared__ long long carry;
    vvr_scan_top(bsum, nb, total, ws, &carry);
}

// v[0..n) counts -> partial sums: v[i] + bsum[i / 1024] is the exclusive
// prefix of count i, and *total their sum (the users add the carry, so the
// scan takes two launches). `bsum` holds ceil(n / 1024) words.
static inline void vvr_scan_partial(long long* v, int n, long long* bsum,
                                    long long* total, cudaStream_t st) {
    const int nb = (n + 1023) / 1024;
    if (nb > 0) vvr_scan_blocks_kernel<<<nb, 1024, 0, st>>>(v, n, bsum);
    vvr_scan_top_kernel<<<1, 1024, 0, st>>>(bsum, nb, total);
}
