// K4: the bloom pyramid, one cooperative launch, and the compositor, one
// thread per output texel (ops/post.py wraps both entry points). Replace
// vvr_tpu/ops/post.py:146 `bloom_pyramid_p` (its passes `bloom_downsample`
// :92 and `bloom_upsample` :127) and :205 `composite_p`. Images are planar
// (C, H, W) float32.
//
// The pyramid runs in one launch: a grid of as many CTAs as fit on the card
// at once, cooperative_groups' grid sync between levels, the mips in one
// scratch buffer.
//  - A downsample level takes a thread per output texel: its 4 x 4 texels
//    of each channel (rows 2j-1 .. 2j+2, columns 2i-1 .. 2i+2, clamped) are
//    loaded at once, the 9 half-texel grid entries and their `length >
//    0.6` thresholds computed from them, then the 3 x 3 sums. Neighbouring
//    outputs share texels, which L1 serves: each texel of the HDR image is
//    read from device memory about once, and a small level costs one round
//    trip.
//  - The upsample levels run as one stage: a CTA takes a tile of mip 2
//    and finds, level by level, the region of each coarser mip that the
//    tile depends on (a 2x2 tent reads a texel's two neighbours along each
//    axis); it loads that region of the coarsest mip and upsamples it
//    level by level in shared memory, writing only mip 2. The few coarse
//    texels that neighbouring tiles share are computed again by each.
// Sums keep the plain version's order and its / 9, and every upsampled
// texel the plain version's formula, so the results do not depend on the
// tiling.
//
// What bounds it on an H100: the 33 MB HDR read of level 1, then the
// latency of each dependent level (a grid sync, an L2 round trip and a
// little arithmetic; 7 stages at 1080p). One launch replaces the twelve
// of the per-level design.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define VVR_BLOOM_THREADS 256
// a tile of mip 2 in the upsample stage; the region of a coarser mip that
// it reads never exceeds it (rows 16 -> 10 -> 7 -> 6 -> 5 ..., columns
// 32 -> 18 -> 11 -> ...)
#define VVR_BLOOM_TH 16
#define VVR_BLOOM_TW 32
#define VVR_BLOOM_UPB (4 * VVR_BLOOM_TH * VVR_BLOOM_TW)

namespace {

__device__ __forceinline__ int mip_side(int size, int m) {
    return max(size >> m, 1);
}

// offset of mip m >= 1 in the scratch buffer: mips 1, 2, ... back to back
// (ops/post.py _mip_offsets)
__device__ size_t mip_offset(int h, int w, int m) {
    size_t off = 0;
    for (int k = 1; k < m; ++k) {
        off += 4 * (size_t)mip_side(h, k) * mip_side(w, k);
    }
    return off;
}

// downsample prev (4, h, w) -> out (4, nh, nw): out[j, i] = sum over the
// 3x3 window at (2j, 2i) of the thresholded half-texel grid, / 9
// (post.py:92-114). Half-grid entry (a, b), a in [0, h], b in [0, w], is
// the mean of the edge-clamped texels (a-1..a, b-1..b); an entry past the
// grid (a > h) repeats the last one, which the clamped rows give too. All
// 64 texels are loaded before the first is used.
__device__ void downsample_level(const float* prev, int h, int w,
                                 float* out, int nh, int nw) {
    const long long n = (long long)nh * nw;
    const size_t plane = (size_t)h * w;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < n; idx += (long long)gridDim.x * blockDim.x) {
        const int j = (int)(idx / nw), i = (int)(idx - (long long)j * nw);
        int ys[4], xs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            ys[k] = min(max(2 * j - 1 + k, 0), h - 1);
            xs[k] = min(max(2 * i - 1 + k, 0), w - 1);
        }
        float v[4][4][4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    v[ch][r][q] =
                        prev[ch * plane + (size_t)ys[r] * w + xs[q]];
                }
            }
        }
        float s[4];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const int dy = t / 3, dx = t % 3;
            float hg[4];
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
                const float l = 0.5f * (v[ch][dy][dx] + v[ch][dy + 1][dx]);
                const float rr =
                    0.5f * (v[ch][dy][dx + 1] + v[ch][dy + 1][dx + 1]);
                hg[ch] = 0.5f * (l + rr);
            }
            const bool keep = sqrtf(((hg[0] * hg[0] + hg[1] * hg[1])
                                     + hg[2] * hg[2]) + hg[3] * hg[3]) > 0.6f;
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) {
                const float k = keep ? vvr_clamp(hg[ch], 0.0f, 1000.0f) : 0.0f;
                s[ch] = t == 0 ? k : s[ch] + k;
            }
        }
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
            out[ch * (size_t)nh * nw + idx] = s[ch] / 9.0f;
        }
    }
}

// A region of one channel of a mip: rows [r0, ...) and columns
// [c0, ...) stored with row stride ld.
struct Region {
    const float* p;
    int r0, c0, ld;
    __device__ float at(int r, int c) const {
        return p[(r - r0) * ld + (c - c0)];
    }
};

// 2x tent upsample along rows: row r of the upsampled image at column q,
// from a mip of h rows (post.py:117-124)
__device__ __forceinline__ float up2_rows(const Region& p, int h, int r,
                                          int q) {
    const int k = r >> 1;
    const float cur = p.at(k, q);
    if ((r & 1) == 0) {
        const float mid = 0.5f * (p.at(max(k - 1, 0), q) + cur);
        return 0.5f * (mid + cur);
    }
    const float mid = 0.5f * (cur + p.at(min(k + 1, h - 1), q));
    return 0.5f * (cur + mid);
}

// upsampled texel (y, x) from a mip of h x w: the 2x2 tent, rows then
// columns, edge-extended past 2h x 2w, NaN-guarded (post.py:127-143)
__device__ float up2(const Region& p, int h, int w, int y, int x) {
    y = min(y, 2 * h - 1);
    x = min(x, 2 * w - 1);
    const int k = x >> 1;
    const float cur = up2_rows(p, h, y, k);
    float v;
    if ((x & 1) == 0) {
        const float mid = 0.5f * (up2_rows(p, h, y, max(k - 1, 0)) + cur);
        v = 0.5f * (mid + cur);
    } else {
        const float mid =
            0.5f * (cur + up2_rows(p, h, y, min(k + 1, w - 1)));
        v = 0.5f * (cur + mid);
    }
    return isnan(v) ? 0.0f : v;
}

// the rows [lo, hi] of a mip of n rows that upsampled rows [a, b] read
__device__ __forceinline__ void up_source(int a, int b, int n, int* lo,
                                          int* hi) {
    *lo = max((min(a, 2 * n - 1) >> 1) - 1, 0);
    *hi = min((min(b, 2 * n - 1) >> 1) + 1, n - 1);
}

// region [y0, y1] x [x0, x1] of mip m that a tile [ty0, ty1] x [tx0, tx1]
// of mip 2 depends on through the upsample levels 2 .. m-1
__device__ void up_region(int h, int w, int m, int ty0, int ty1, int tx0,
                          int tx1, int* y0, int* y1, int* x0, int* x1) {
    int a = ty0, b = ty1, c = tx0, d = tx1;
    for (int k = 3; k <= m; ++k) {
        up_source(a, b, mip_side(h, k), &a, &b);
        up_source(c, d, mip_side(w, k), &c, &d);
    }
    *y0 = a;
    *y1 = b;
    *x0 = c;
    *x1 = d;
}

// mips n_mips-2 .. 2 upsampled from mip n_mips-1 (post.py:155-157), one
// tile of mip 2 per CTA, the intermediate regions in shared memory
__device__ void upsample_levels(const float* coarse, int h, int w,
                                int n_mips, float* out, float* buf) {
    const int tid = threadIdx.x;
    const int h2 = mip_side(h, 2), w2 = mip_side(w, 2);
    const int tiles_x = (w2 + VVR_BLOOM_TW - 1) / VVR_BLOOM_TW;
    const int n_tiles = tiles_x * ((h2 + VVR_BLOOM_TH - 1) / VVR_BLOOM_TH);
    const int top = n_mips - 1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int ty0 = (tile / tiles_x) * VVR_BLOOM_TH;
        const int tx0 = (tile % tiles_x) * VVR_BLOOM_TW;
        const int ty1 = min(ty0 + VVR_BLOOM_TH, h2) - 1;
        const int tx1 = min(tx0 + VVR_BLOOM_TW, w2) - 1;
        int y0, y1, x0, x1;
        up_region(h, w, top, ty0, ty1, tx0, tx1, &y0, &y1, &x0, &x1);
        float* src = buf;
        float* dst = buf + VVR_BLOOM_UPB;
        __syncthreads();  // the last tile's stage is done with `buf`
        {
            const int rows = y1 - y0 + 1, cols = x1 - x0 + 1;
            const int th = mip_side(h, top), tw = mip_side(w, top);
            for (int e = tid; e < 4 * rows * cols; e += VVR_BLOOM_THREADS) {
                const int ch = e / (rows * cols), rc = e - ch * rows * cols;
                const int r = rc / cols, c = rc - r * cols;
                src[e] = coarse[(size_t)ch * th * tw + (size_t)(y0 + r) * tw
                                + x0 + c];
            }
        }
        for (int m = top - 1; m >= 2; --m) {
            __syncthreads();  // the source region is complete
            const int hs = mip_side(h, m + 1), ws = mip_side(w, m + 1);
            int ny0, ny1, nx0, nx1;
            up_region(h, w, m, ty0, ty1, tx0, tx1, &ny0, &ny1, &nx0, &nx1);
            const int rows = ny1 - ny0 + 1, cols = nx1 - nx0 + 1;
            const int src_plane = (y1 - y0 + 1) * (x1 - x0 + 1);
            for (int e = tid; e < 4 * rows * cols; e += VVR_BLOOM_THREADS) {
                const int ch = e / (rows * cols), rc = e - ch * rows * cols;
                const int r = rc / cols, c = rc - r * cols;
                const Region p = {src + ch * src_plane, y0, x0,
                                  x1 - x0 + 1};
                const float v = up2(p, hs, ws, ny0 + r, nx0 + c);
                if (m == 2) {
                    out[(size_t)ch * h2 * w2 + (size_t)(ny0 + r) * w2 + nx0
                        + c] = v;
                } else {
                    dst[e] = v;
                }
            }
            float* t = src;
            src = dst;
            dst = t;
            y0 = ny0;
            y1 = ny1;
            x0 = nx0;
            x1 = nx1;
        }
    }
}

// mip 1 down from the HDR image in tiles, mips 2 .. n_mips-1 down a texel
// per thread, then mip 2 up from mip n_mips-1 (post.py:146-159); a grid
// sync between stages
__global__ void __launch_bounds__(VVR_BLOOM_THREADS)
vvr_bloom_pyramid_kernel(const float* hdr, int h, int w, int n_mips,
                         float* scratch) {
    __shared__ float buf[2 * VVR_BLOOM_UPB];
    cg::grid_group grid = cg::this_grid();
    for (int m = 1; m < n_mips; ++m) {
        if (m > 1) grid.sync();
        downsample_level(m == 1 ? hdr : scratch + mip_offset(h, w, m - 1),
                         mip_side(h, m - 1), mip_side(w, m - 1),
                         scratch + mip_offset(h, w, m), mip_side(h, m),
                         mip_side(w, m));
    }
    if (n_mips > 3) {
        grid.sync();
        upsample_levels(scratch + mip_offset(h, w, n_mips - 1), h, w, n_mips,
                        scratch + mip_offset(h, w, 2), buf);
    }
}

// 4x bilinear upsample at texel-center phases along rows (post.py:169-184)
__device__ __forceinline__ float up4_rows(const float* __restrict__ p, int h,
                                          int w, int r, int q) {
    const int k = r >> 2;
    const float prev = p[(size_t)max(k - 1, 0) * w + q];
    const float cur = p[(size_t)k * w + q];
    const float nxt = p[(size_t)min(k + 1, h - 1) * w + q];
    switch (r & 3) {
        case 0: return 0.375f * prev + 0.625f * cur;
        case 1: return 0.125f * prev + 0.875f * cur;
        case 2: return 0.875f * cur + 0.125f * nxt;
        default: return 0.625f * cur + 0.375f * nxt;
    }
}

__device__ __forceinline__ float up4(const float* __restrict__ p, int h,
                                     int w, int y, int x) {
    y = min(y, 4 * h - 1);
    x = min(x, 4 * w - 1);
    const int k = x >> 2;
    const float prev = up4_rows(p, h, w, y, max(k - 1, 0));
    const float cur = up4_rows(p, h, w, y, k);
    const float nxt = up4_rows(p, h, w, y, min(k + 1, w - 1));
    switch (x & 3) {
        case 0: return 0.375f * prev + 0.625f * cur;
        case 1: return 0.125f * prev + 0.875f * cur;
        case 2: return 0.875f * cur + 0.125f * nxt;
        default: return 0.625f * cur + 0.375f * nxt;
    }
}

// ACES filmic tonemap (lighting.slang:7-14)
__device__ __forceinline__ float aces(float x) {
    return vvr_clamp((x * (2.51f * x + 0.03f)) / (x * (2.43f * x + 0.59f)
                                                  + 0.14f), 0.0f, 1.0f);
}

// composite: upscale + bloom + ACES + gamma -> u8 (post.py:205-227)
__global__ void composite_kernel(const float* __restrict__ hdr, int rh,
                                 int rw, const float* __restrict__ bloom,
                                 int bh, int bw, float strength,
                                 int bloom_on, uint8_t* __restrict__ out,
                                 int out_h, int out_w) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= out_h * out_w) return;
    const int y = idx / out_w;
    const int x = idx % out_w;
    const int sy = max(out_h / rh, 1);
    const int sx = max(out_w / rw, 1);
    const int ry = min(y / sy, rh - 1);
    const int rx = min(x / sx, rw - 1);
    const float gamma = (float)(1.0 / 2.2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float col = hdr[(size_t)c * rh * rw + (size_t)ry * rw + rx];
        if (bloom_on) {
            col = col + up4(bloom + (size_t)c * bh * bw, bh, bw, ry, rx)
                        * strength;
        }
        const float ldr = powf(aces(col), gamma);
        out[3 * (size_t)idx + c] =
            (uint8_t)(vvr_clamp(ldr, 0.0f, 1.0f) * 255.0f + 0.5f);
    }
}

}  // namespace

// the pyramid of a (4, h, w) image into `scratch` (mips 1 .. n_mips-1);
// a cooperative launch of as many CTAs as fit on the card at once. A
// refused launch returns its error.
extern "C" int vvr_bloom_pyramid(const void* hdr, int h, int w, int n_mips,
                                 void* scratch, void* stream) {
    static int blocks_of[64];  // co-resident CTAs, by device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (blocks_of[dev] == 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, vvr_bloom_pyramid_kernel, VVR_BLOOM_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        blocks_of[dev] = per_sm * sms;
    }
    const float* hdr_f = (const float*)hdr;
    float* scratch_f = (float*)scratch;
    void* args[] = {(void*)&hdr_f, (void*)&h, (void*)&w, (void*)&n_mips,
                    (void*)&scratch_f};
    e = cudaLaunchCooperativeKernel((const void*)vvr_bloom_pyramid_kernel,
                                    blocks_of[dev], VVR_BLOOM_THREADS, args,
                                    0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" int vvr_composite(const void* hdr, int rh, int rw,
                             const void* bloom, int bh, int bw,
                             float strength, int bloom_on, void* out,
                             int out_h, int out_w, void* stream) {
    composite_kernel<<<vvr_blocks((long long)out_h * out_w, 256), 256, 0,
                       (cudaStream_t)stream>>>(
        (const float*)hdr, rh, rw, (const float*)bloom, bh, bw, strength,
        bloom_on, (uint8_t*)out, out_h, out_w);
    return (int)cudaGetLastError();
}
