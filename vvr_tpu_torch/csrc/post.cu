// K4: bloom chain and compositor, one thread per output texel
// (ops/post.py wraps the three entry points). Replaces
// vvr_tpu/ops/post.py:92 `bloom_downsample`, :127 `bloom_upsample` and
// :205 `composite_p`. Images are planar (C, H, W) float32.
//
// Each thread computes its taps straight from the finer (or coarser)
// image with clamped indices; the JAX version's edge-padded half-texel
// grid and upsample planes are never stored.
#include "common.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// downsample: out[j, i] = sum over the 3x3 window at (2j, 2i) of the
// thresholded half-texel grid, / 9 (post.py:92-114)
__global__ void downsample_kernel(const float* __restrict__ prev, int h,
                                  int w, float* __restrict__ out, int nh,
                                  int nw) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= nh * nw) return;
    const int j = idx / nw;
    const int i = idx % nw;
    const size_t plane = (size_t)h * w;
    float s[4];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
            // half-grid entry (a, b), a in [0, h], b in [0, w]: the mean of
            // the edge-clamped texels (a-1..a, b-1..b)
            const int a = min(2 * j + dy, h);
            const int b = min(2 * i + dx, w);
            const int y0 = clampi(a - 1, 0, h - 1), y1 = clampi(a, 0, h - 1);
            const int x0 = clampi(b - 1, 0, w - 1), x1 = clampi(b, 0, w - 1);
            float hg[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float* p = prev + c * plane;
                const float l = 0.5f * (p[(size_t)y0 * w + x0]
                                        + p[(size_t)y1 * w + x0]);
                const float r = 0.5f * (p[(size_t)y0 * w + x1]
                                        + p[(size_t)y1 * w + x1]);
                hg[c] = 0.5f * (l + r);
            }
            const bool keep = sqrtf(((hg[0] * hg[0] + hg[1] * hg[1])
                                     + hg[2] * hg[2]) + hg[3] * hg[3]) > 0.6f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float k = keep ? vvr_clamp(hg[c], 0.0f, 1000.0f) : 0.0f;
                s[c] = (dy == 0 && dx == 0) ? k : s[c] + k;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        out[c * (size_t)nh * nw + idx] = s[c] / 9.0f;
    }
}

// 2x tent upsample along rows of one plane: row r of the upsampled
// image at column q (post.py:117-124)
__device__ __forceinline__ float up2_rows(const float* __restrict__ p,
                                          int h, int w, int r, int q) {
    const int k = r >> 1;
    const float cur = p[(size_t)k * w + q];
    if ((r & 1) == 0) {
        const float mid = 0.5f * (p[(size_t)max(k - 1, 0) * w + q] + cur);
        return 0.5f * (mid + cur);
    }
    const float mid = 0.5f * (cur + p[(size_t)min(k + 1, h - 1) * w + q]);
    return 0.5f * (cur + mid);
}

// upsample: the 2x2 tent, rows then columns, edge-extended to the target
// size, NaN-guarded (post.py:127-143)
__global__ void upsample_kernel(const float* __restrict__ prev, int h, int w,
                                float* __restrict__ out, int nh, int nw) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= 4 * nh * nw) return;
    const int c = idx / (nh * nw);
    const int y = min((idx / nw) % nh, 2 * h - 1);
    const int x = min(idx % nw, 2 * w - 1);
    const float* p = prev + (size_t)c * h * w;
    const int k = x >> 1;
    const float cur = up2_rows(p, h, w, y, k);
    float v;
    if ((x & 1) == 0) {
        const float mid = 0.5f * (up2_rows(p, h, w, y, max(k - 1, 0)) + cur);
        v = 0.5f * (mid + cur);
    } else {
        const float mid = 0.5f * (cur + up2_rows(p, h, w, y, min(k + 1, w - 1)));
        v = 0.5f * (cur + mid);
    }
    out[idx] = isnan(v) ? 0.0f : v;
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

extern "C" int vvr_bloom_downsample(const void* prev, int h, int w,
                                    void* out, int nh, int nw,
                                    void* stream) {
    downsample_kernel<<<vvr_blocks((long long)nh * nw, 256), 256, 0,
                        (cudaStream_t)stream>>>((const float*)prev, h, w,
                                                (float*)out, nh, nw);
    return (int)cudaGetLastError();
}

extern "C" int vvr_bloom_upsample(const void* prev, int h, int w, void* out,
                                  int nh, int nw, void* stream) {
    upsample_kernel<<<vvr_blocks(4LL * nh * nw, 256), 256, 0,
                      (cudaStream_t)stream>>>((const float*)prev, h, w,
                                              (float*)out, nh, nw);
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
