// Work items over a face set, for K11 (sunshadow.cu): the face table, an
// exclusive scan of the per-face item counts, and the lookup from an item
// to its face. K9 (raster.cu) takes the face table, the float-to-int
// helpers and the one-block scan (of its tile counts).
//
// A face that covers a large area (a wall next to the camera, a long
// merged rectangle in sun space) makes many items, a small one few. Each
// face's count goes through an in-place exclusive scan, and a persistent
// grid of warps then walks the items 0..total-1, one warp per item; a
// warp finds its face by a binary search over the offsets. No face is
// ever given to one thread whole, and no capacity is fixed: the scan runs
// in int64 and the item loop reads the total on the device.
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

static __global__ void vvr_scan_blocks_kernel(long long* v, int n,
                                              long long* bsum) {
    __shared__ long long ws[32];
    const int i = blockIdx.x * 1024 + threadIdx.x;
    const long long x = i < n ? v[i] : 0;
    const long long incl = vvr_block_scan(x, ws);
    if (i < n) v[i] = incl - x;
    if (threadIdx.x == 1023) bsum[blockIdx.x] = incl;
}

static __global__ void vvr_scan_top_kernel(long long* bsum, int nb,
                                           long long* total) {
    __shared__ long long ws[32];
    __shared__ long long carry;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < nb; base += 1024) {
        const int i = base + threadIdx.x;
        const long long x = i < nb ? bsum[i] : 0;
        const long long incl = vvr_block_scan(x, ws);
        const long long c = carry;
        __syncthreads();
        if (i < nb) bsum[i] = c + incl - x;
        if (threadIdx.x == 1023) carry = c + incl;
        __syncthreads();
    }
    if (threadIdx.x == 0) *total = carry;
}

static __global__ void vvr_scan_add_kernel(long long* v, int n,
                                           const long long* bsum) {
    const int i = blockIdx.x * 1024 + threadIdx.x;
    if (i < n && blockIdx.x > 0) v[i] += bsum[blockIdx.x];
}

// v[0..n) counts -> exclusive offsets in place; *total = their sum.
// `bsum` holds ceil(n / 1024) words.
static inline void vvr_exclusive_scan(long long* v, int n, long long* bsum,
                                      long long* total, cudaStream_t st) {
    const int nb = (n + 1023) / 1024;
    if (nb > 0) vvr_scan_blocks_kernel<<<nb, 1024, 0, st>>>(v, n, bsum);
    vvr_scan_top_kernel<<<1, 1024, 0, st>>>(bsum, nb, total);
    if (nb > 1) vvr_scan_add_kernel<<<nb, 1024, 0, st>>>(v, n, bsum);
}

// the face whose items hold `item`: the last f with off[f] <= item (a face
// with no items shares its offset with the next face and is never found)
static __device__ __forceinline__ int vvr_item_face(
        const long long* __restrict__ off, int n, long long item) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(off + mid) <= item) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo - 1;
}

// blocks of 256 threads for a persistent warp loop over the items
static inline unsigned vvr_item_blocks() {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return (unsigned)(sms * 8);
}
