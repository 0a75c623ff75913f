// Shared device helpers of the port's kernels: constants, hash12
// (vvr_tpu/utils/hash.py) and the uint32 lattice noise
// (vvr_tpu/ops/noise.py).
//
// Every formula keeps the JAX op order. The library is compiled with
// -fmad=false, so no multiply-add here is contracted into an FMA: the hash
// chains amplify one ulp to O(1) through fract().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VVR_BIG_T 1e30f

static __device__ __forceinline__ float vvr_fract(float x) {
    return x - floorf(x);
}

static __device__ __forceinline__ float vvr_clamp(float x, float lo,
                                                  float hi) {
    return fminf(fmaxf(x, lo), hi);
}

static __device__ __forceinline__ float vvr_smooth01(float t) {
    return t * t * (3.0f - 2.0f * t);
}

// clip(int(x), lo, hi) with truncation toward zero, clamping in float
// first so an out-of-range float never reaches the conversion
static __device__ __forceinline__ int vvr_trunc_clip(float x, int lo,
                                                     int hi) {
    return (int)vvr_clamp(truncf(x), (float)lo, (float)hi);
}

// hash12 (hash.py:27-32): p3 = fract(p.xyx * .1031); p3 += dot(p3,
// p3.yzx + 33.33); fract((p3.x + p3.y) * p3.z)
static __device__ __forceinline__ float vvr_hash12(float px, float py) {
    float a = vvr_fract(px * 0.1031f);
    float b = vvr_fract(py * 0.1031f);
    float c = vvr_fract(px * 0.1031f);
    float d = (a * (b + 33.33f) + b * (c + 33.33f)) + c * (a + 33.33f);
    a = a + d;
    b = b + d;
    c = c + d;
    return vvr_fract((a + b) * c);
}

// ---- uint32 lattice noise (noise.py) ----

static __device__ __forceinline__ uint32_t vvr_hash_u32(uint32_t s) {
    s = s ^ 2747636419u;
    s = s * 2654435769u;
    s = s ^ (s >> 16);
    s = s * 2654435769u;
    s = s ^ (s >> 16);
    s = s * 2654435769u;
    return s;
}

static __device__ __forceinline__ uint32_t vvr_lattice_hash2(int ix, int iy,
                                                             uint32_t sk) {
    return vvr_hash_u32(((uint32_t)ix * 0x9E3779B1u)
                        ^ ((uint32_t)iy * 0x85EBCA77u) ^ sk);
}

static __host__ __device__ __forceinline__ uint32_t vvr_seed_key(int seed) {
    return (uint32_t)(((long long)seed * 0x27D4EB2FLL + 0x165667B1LL)
                      & 0xFFFFFFFFLL);
}

// the gradient table of noise.py, {(+-1, +-s)} then {(+-s, +-1)}, by
// selects: a table indexed at run time sits in local memory
static __device__ __forceinline__ void vvr_grad2(uint32_t h, float* gx,
                                                 float* gy) {
    const int idx = (int)(h >> 28) & 7;
    const float s = 0.70710678f;
    const float mx = (idx & 4) ? s : 1.0f;
    const float my = (idx & 4) ? 1.0f : s;
    *gx = (idx & 1) ? -mx : mx;
    *gy = (idx & 2) ? -my : my;
}

// sdnoise2 (noise.py:116-165): simplex noise value and derivatives
static __device__ __forceinline__ void vvr_sdnoise2(float x, float y,
                                                    uint32_t sk, float* val,
                                                    float* ddx, float* ddy) {
    const float F2 = 0.36602540378f;
    const float G2 = 0.21132486540f;
    const float G2x2 = (float)(2.0 * 0.21132486540);
    float s = (x + y) * F2;
    float i = floorf(x + s);
    float j = floorf(y + s);
    float t = (i + j) * G2;
    float x0 = x - (i - t);
    float y0 = y - (j - t);
    float i1 = x0 > y0 ? 1.0f : 0.0f;
    float j1 = 1.0f - i1;
    float cxs[3] = {x0, x0 - i1 + G2, x0 - 1.0f + G2x2};
    float cys[3] = {y0, y0 - j1 + G2, y0 - 1.0f + G2x2};
    int ois[3] = {0, (int)i1, 1};
    int ojs[3] = {0, (int)j1, 1};
    int ii = (int)i;
    int jj = (int)j;
    float v = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float cx = cxs[c], cy = cys[c];
        float tt = fmaxf(0.5f - cx * cx - cy * cy, 0.0f);
        float t2 = tt * tt;
        float t4 = t2 * t2;
        float gx, gy;
        vvr_grad2(vvr_lattice_hash2(ii + ois[c], jj + ojs[c], sk), &gx, &gy);
        float gdot = gx * cx + gy * cy;
        v = v + t4 * gdot;
        float t3 = t2 * tt;
        dx = dx + (-8.0f * t3 * cx * gdot + t4 * gx);
        dy = dy + (-8.0f * t3 * cy * gdot + t4 * gy);
    }
    *val = 40.0f * v;
    *ddx = 40.0f * dx;
    *ddy = 40.0f * dy;
}

static inline unsigned vvr_blocks(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}
