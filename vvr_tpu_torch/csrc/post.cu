// K4: the bloom pyramid, one cooperative launch, and the compositor, one
// thread per 4 render texels (ops/post.py wraps both entry points). Replace
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
//
// The compositor reads 3 of the HDR image's 4 channels and writes 3 bytes
// a texel, but it is bound by its instructions: the tonemap (an IEEE
// division in ACES, an accurate `powf`) is the larger share, the indexing
// and the bloom's loads the rest. Its design below cuts the second share.
// A 256-entry threshold table in place of `powf` (8 comparisons give the
// u8, were it to grow with the ACES value) does not give powf's bytes on
// every float in [0, 1]: the u8 of powf drops by one from one float to the
// next at one point of the range. Deferring to powf within 16 float steps
// of each threshold made the table exact over all of [0, 1] on the card,
// and slower than powf alone, so the compositor keeps powf.
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

// The composite, one thread per 4 horizontally adjacent texels of one
// render row (columns 4g .. 4g+3), on a 2D grid: no division by a runtime
// width. The group's 4 texels read the same 3 bloom columns (x >> 2 and
// its neighbours; the edge clamp keeps a group's columns together, since
// 4w - 1 ends a group), so each channel loads the 3 x 3 bloom texels once,
// interpolates each column along the rows once, and gives each texel its
// phase (post.py:169-184): 9 loads where a thread per texel makes 36. The
// HDR values of a channel are one float4 load and the 12 bytes of output
// three aligned 32-bit stores; an output larger than the render repeats
// each texel's bytes over its integer upscale block. Every float keeps
// the per-texel formula's operations and order, so the bytes do not
// depend on the grouping.
#define VVR_COMP_TX 32
#define VVR_COMP_TY 4

// the 4x bilinear row interpolation of bloom column q at render row y
// (clamped to 4h - 1) of a mip of h rows and w columns
__device__ __forceinline__ float up4_rows(const float* __restrict__ p, int h,
                                          int w, int y, int q) {
    const int k = y >> 2;
    const float prev = __ldg(p + (size_t)max(k - 1, 0) * w + q);
    const float cur = __ldg(p + (size_t)k * w + q);
    const float nxt = __ldg(p + (size_t)min(k + 1, h - 1) * w + q);
    switch (y & 3) {
        case 0: return 0.375f * prev + 0.625f * cur;
        case 1: return 0.125f * prev + 0.875f * cur;
        case 2: return 0.875f * cur + 0.125f * nxt;
        default: return 0.625f * cur + 0.375f * nxt;
    }
}

__device__ __forceinline__ float up4_phase(float prev, float cur, float nxt,
                                           int phase) {
    switch (phase) {
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

// gamma 1/2.2 and the u8 quantization of a tonemapped value
__device__ __forceinline__ unsigned quantize(float a) {
    const float ldr = powf(a, (float)(1.0 / 2.2));
    return (unsigned)(uint8_t)(vvr_clamp(ldr, 0.0f, 1.0f) * 255.0f + 0.5f);
}

// composite: upscale + bloom + ACES + gamma -> u8 (post.py:205-227)
__global__ void __launch_bounds__(VVR_COMP_TX * VVR_COMP_TY)
composite_kernel(const float* __restrict__ hdr, int rh, int rw,
                 const float* __restrict__ bloom, int bh, int bw,
                 float strength, int bloom_on, uint8_t* __restrict__ out,
                 int out_h, int out_w) {
    const int x0 = 4 * (blockIdx.x * VVR_COMP_TX + threadIdx.x);
    const int ry = blockIdx.y * VVR_COMP_TY + threadIdx.y;
    if (ry >= rh || x0 >= rw) return;
    // a float4 per channel and 4 texels a group
    const bool whole = (rw & 3) == 0 && ((uintptr_t)hdr & 15) == 0;
    const size_t plane = (size_t)rh * rw;
    const size_t at = (size_t)ry * rw + x0;
    unsigned q[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float col[4];
        if (whole) {
            const float4 v = __ldg(
                reinterpret_cast<const float4*>(hdr + c * plane + at));
            col[0] = v.x;
            col[1] = v.y;
            col[2] = v.z;
            col[3] = v.w;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                col[i] = x0 + i < rw ? __ldg(hdr + c * plane + at + i)
                                     : 0.0f;
            }
        }
        if (bloom_on) {
            const float* p = bloom + (size_t)c * bh * bw;
            const int y = min(ry, 4 * bh - 1);
            const int k = min(x0, 4 * bw - 1) >> 2;
            const float prev = up4_rows(p, bh, bw, y, max(k - 1, 0));
            const float cur = up4_rows(p, bh, bw, y, k);
            const float nxt = up4_rows(p, bh, bw, y, min(k + 1, bw - 1));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int phase = min(x0 + i, 4 * bw - 1) & 3;
                col[i] = col[i] + up4_phase(prev, cur, nxt, phase)
                                  * strength;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) q[c][i] = quantize(aces(col[i]));
    }
    if (whole && out_h == rh && out_w == rw) {
        // bytes r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3, little-endian
        uint32_t* o = reinterpret_cast<uint32_t*>(out + 3 * at);
        o[0] = q[0][0] | (q[1][0] << 8) | (q[2][0] << 16) | (q[0][1] << 24);
        o[1] = q[1][1] | (q[2][1] << 8) | (q[0][2] << 16) | (q[1][2] << 24);
        o[2] = q[2][2] | (q[0][3] << 8) | (q[1][3] << 16) | (q[2][3] << 24);
        return;
    }
    // output texel (y, x) shows render texel (min(y / sy, rh - 1),
    // min(x / sx, rw - 1)): the rows and columns that show this group's
    const int sy = max(out_h / rh, 1), sx = max(out_w / rw, 1);
    const int y_end = ry == rh - 1 ? out_h : min((ry + 1) * sy, out_h);
    for (int y = ry * sy; y < y_end; ++y) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int rx = x0 + i;
            if (rx >= rw) break;
            const int x_end = rx == rw - 1 ? out_w : min((rx + 1) * sx, out_w);
            for (int x = rx * sx; x < x_end; ++x) {
                uint8_t* o = out + 3 * ((size_t)y * out_w + x);
                o[0] = (uint8_t)q[0][i];
                o[1] = (uint8_t)q[1][i];
                o[2] = (uint8_t)q[2][i];
            }
        }
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
    const dim3 block(VVR_COMP_TX, VVR_COMP_TY);
    const dim3 blocks(vvr_blocks((rw + 3) / 4, VVR_COMP_TX),
                      vvr_blocks(rh, VVR_COMP_TY));
    composite_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
        (const float*)hdr, rh, rw, (const float*)bloom, bh, bw, strength,
        bloom_on, (uint8_t*)out, out_h, out_w);
    return (int)cudaGetLastError();
}
