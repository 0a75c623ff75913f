// Screen-tile binning of pixel boxes, shared by K9 (raster.cu, a box a
// face) and K22 (meshraster.cu, a box a triangle). An item whose box spans
// at most VVR_BIN_MAX 32x32 tiles goes on the list of each of its tiles; a
// larger one goes on the big list, which every tile reads. The steps:
//  1. count, in the caller's per-item kernel (vvr_bin_count, called by
//     every lane of each warp): one atomic per warp and tile, since items
//     of neighbouring indices lie close together and share tiles;
//  2. one block scans the tile counts into offsets (vvr_scan_top,
//     items.cuh);
//  3. vvr_bin_kernel, one thread an item: its index into the list of each
//     of its tiles, one atomic per warp and tile, all of a warp's atomics
//     issued before the first result is used (the order within a list is
//     free: the users' keys are minima);
//  4. the caller's tile CTA reads its items in batches of one a thread
//     (vvr_tile_items), flattens the batch's fragments (the box pixels in
//     the tile) by a CTA scan (vvr_tile_scan), and finds a fragment's item
//     by binary search over the scan (vvr_batch_slot), narrowed by a map
//     of every 32nd fragment's slot (vvr_batch_coarse).
// The lists hold at most VVR_BIN_MAX entries an item and the big list
// one, so the scratch is sized from the item count and nothing overflows.
#pragma once

#include "items.cuh"

#define VVR_TILE 32
#define VVR_TILE_PIX (VVR_TILE * VVR_TILE)
#define VVR_BIN_MAX 16
// a batch's coarse map: the slot of every 32nd fragment, for batches of at
// most 32 * VVR_COARSE fragments
#define VVR_COARSE 512

// the scratch of the binning, at p (vvr_bins_at): per tile its count, then
// exclusive offset (int64), their total, per tile its list's fill, the big
// count, the big list (n_items) and the tile lists (VVR_BIN_MAX * n_items);
// 12 * (n_tiles + 1) + 4 * (1 + VVR_BIN_MAX) * n_items bytes
// (ops/rastertrace.py _raster_scratch_words, render/raster.py
// raster_scratch_words)
struct VvrBins {
    long long* tile_off;
    long long* total;
    int* fill;
    int* n_big;
    int* big;
    int* list;
};

static inline VvrBins vvr_bins_at(void* p, int n_tiles, int n_items) {
    VvrBins b;
    b.tile_off = (long long*)p;
    b.total = b.tile_off + n_tiles;
    b.fill = (int*)(b.total + 1);
    b.n_big = b.fill + n_tiles;
    b.big = b.n_big + 1;
    b.list = b.big + n_items;
    return b;
}

// the first byte after the scratch
static inline void* vvr_bins_end(const VvrBins& b, int n_items) {
    return b.list + (size_t)VVR_BIN_MAX * n_items;
}

// zeroes the counts, total, fills and big count (before step 1)
static inline void vvr_bins_clear(const VvrBins& b, int n_tiles,
                                  cudaStream_t st) {
    cudaMemsetAsync(b.tile_off, 0, (size_t)(n_tiles + 1) * 12, st);
}

// the tiles of box b (x0, x1, y0, y1; x0 > x1 when empty): their count,
// and the rectangle's first tile column tx0, row ty0 and width rw
static __device__ __forceinline__ int vvr_bin_rect(int4 b, int* tx0,
                                                   int* ty0, int* rw) {
    if (b.x > b.y) return 0;
    *tx0 = b.x / VVR_TILE;
    *ty0 = b.z / VVR_TILE;
    *rw = b.y / VVR_TILE - *tx0 + 1;
    return *rw * (b.w / VVR_TILE - *ty0 + 1);
}

// tile k of a box's rectangle, row-major
static __device__ __forceinline__ int vvr_bin_tile(int k, int ty0, int tx0,
                                                   int rw, int tiles_x) {
    return (ty0 + k / rw) * tiles_x + tx0 + k % rw;
}

// step 1 for item i with box b; every lane of the warp calls it, a lane
// without an item with an empty box
static __device__ void vvr_bin_count(int4 b, int i, int tiles_x,
                                     const VvrBins& bins) {
    const int lane = threadIdx.x & 31;
    int tx0 = 0, ty0 = 0, rw = 1;
    int n = vvr_bin_rect(b, &tx0, &ty0, &rw);
    if (n > VVR_BIN_MAX) {
        bins.big[atomicAdd(bins.n_big, 1)] = i;
        n = 0;
    }
    const int n_max = __reduce_max_sync(0xffffffffu, n);
    for (int k = 0; k < n_max; ++k) {
        const int t = k < n ? vvr_bin_tile(k, ty0, tx0, rw, tiles_x) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, t);
        if (t >= 0 && lane == __ffs(peers) - 1) {
            atomicAdd((unsigned long long*)bins.tile_off + t,
                      (unsigned long long)__popc(peers));
        }
    }
}

// step 3: item f's box is boxes[stride * f]
static __global__ void __launch_bounds__(256)
vvr_bin_kernel(int n_items, int tiles_x, const int4* __restrict__ boxes,
               int stride, VvrBins bins) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int n = 0, tx0 = 0, ty0 = 0, rw = 1;
    if (f < n_items) {
        n = vvr_bin_rect(boxes[(size_t)stride * f], &tx0, &ty0, &rw);
        if (n > VVR_BIN_MAX) n = 0;
    }
    const int n_max = __reduce_max_sync(0xffffffffu, n);
    int tk[VVR_BIN_MAX], base[VVR_BIN_MAX];
    unsigned peers[VVR_BIN_MAX];
#pragma unroll
    for (int k = 0; k < VVR_BIN_MAX; ++k) {
        if (k >= n_max) break;
        tk[k] = k < n ? vvr_bin_tile(k, ty0, tx0, rw, tiles_x) : -1;
        peers[k] = __match_any_sync(0xffffffffu, tk[k]);
        base[k] = 0;
        if (tk[k] >= 0 && lane == __ffs(peers[k]) - 1) {
            base[k] = atomicAdd(bins.fill + tk[k], __popc(peers[k]));
        }
    }
#pragma unroll
    for (int k = 0; k < VVR_BIN_MAX; ++k) {
        if (k >= n_max) break;
        const int b =
            __shfl_sync(0xffffffffu, base[k], __ffs(peers[k]) - 1);
        if (tk[k] >= 0) {
            bins.list[bins.tile_off[tk[k]] + b
                      + __popc(peers[k] & ((1u << lane) - 1u))] = f;
        }
    }
}

static inline void vvr_bins_fill(const VvrBins& b, int n_items, int tiles_x,
                                 const int4* boxes, int stride,
                                 cudaStream_t st) {
    if (n_items > 0) {
        vvr_bin_kernel<<<vvr_blocks(n_items, 256), 256, 0, st>>>(
            n_items, tiles_x, boxes, stride, b);
    }
}

// step 4: a tile's items, its own list's then the big list's
struct VvrTileItems {
    const int* list;
    const int* big;
    int n_binned;
    int n;
};

static __device__ __forceinline__ VvrTileItems
vvr_tile_items(const VvrBins& b, int tile) {
    VvrTileItems t;
    t.list = b.list + b.tile_off[tile];
    t.big = b.big;
    t.n_binned = b.fill[tile];
    t.n = t.n_binned + *b.n_big;
    return t;
}

static __device__ __forceinline__ int vvr_tile_item(const VvrTileItems& t,
                                                    int k) {
    return k < t.n_binned ? __ldg(t.list + k)
                          : __ldg(t.big + (k - t.n_binned));
}

// the coarse map of a batch: s_pre holds the batch's inclusive fragment
// prefix (visible to every thread), the calling thread's slot holds cnt
// fragments of `total`; a __syncthreads must follow before the search
static __device__ __forceinline__ void vvr_batch_coarse(
        int cnt, const int* s_pre, int total, unsigned short* s_coarse) {
    if (total > 32 * VVR_COARSE || cnt == 0) return;
    const int end = s_pre[threadIdx.x];
    for (int m = (end - cnt + 31) >> 5; m <= (end - 1) >> 5; ++m) {
        s_coarse[m] = (unsigned short)threadIdx.x;
    }
}

// fragment q's slot, the first of slots [0, last] whose inclusive prefix
// passes q, between the coarse map's two entries around it
static __device__ __forceinline__ int vvr_batch_slot(
        int q, const int* s_pre, int last, int total,
        const unsigned short* s_coarse) {
    int lo = 0, hi = last;
    if (total <= 32 * VVR_COARSE) {
        const int m = q >> 5;
        lo = s_coarse[m];
        if (m + 1 < (total + 31) >> 5) hi = s_coarse[m + 1];
    }
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_pre[mid] > q) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo;
}
