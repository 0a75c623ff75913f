// The shading of a hit and the sky of a miss, shared by K2 (shade.cu,
// bounce 0 of the frames without mirrors, AO or point lights) and K15
// (bounce.cu, every bounce of the others): the block colour, the nearest
// skybox texel and Cook-Torrance `lighting_soa` (vvr_tpu/ops/shade.py). One
// copy of the arithmetic, compiled with -fmad=false in both files.
#pragma once

#include "common.cuh"

#define VVR_PI_F 3.1415926538f

// per_block_unique_colour (utils/hash.py): hash33 of block * k, then
// normalized, rounded where the JAX package's jitted frame rounds (XLA
// contracts the dot product's and the norm's sums into FMAs)
static __device__ __forceinline__ void vvr_block_colour(int bx, int by,
                                                        int bz, float* r,
                                                        float* g, float* b) {
    float px = vvr_fract(((float)bx * 23.231f) * 0.1031f);
    float py = vvr_fract(((float)by * -435.4354f) * 0.1030f);
    float pz = vvr_fract(((float)bz * 9412.1f) * 0.0973f);
    const float d = __fmaf_rn(pz, pz + 33.33f,
                              __fmaf_rn(py, px + 33.33f, px * (py + 33.33f)));
    px = px + d;
    py = py + d;
    pz = pz + d;
    const float c0 = vvr_fract((px + py) * pz);
    const float c1 = vvr_fract((px + px) * py);
    const float c2 = vvr_fract((py + px) * px);
    const float n = fmaxf(sqrtf(__fmaf_rn(c2, c2, __fmaf_rn(c1, c1, c0 * c0))),
                          1e-12f);
    *r = c0 / n;
    *g = c1 / n;
    *b = c2 / n;
}

// nearest cubemap texel, the inverse of the write_skybox face mapping
// (sky.py:300-327)
static __device__ __forceinline__ float3 vvr_sample_skybox(
        const float* __restrict__ skybox, int r, float dx, float dy,
        float dz) {
    const float x = dx * -1.0f, y = dy, z = dz * -1.0f;
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    const bool is_x = ax >= ay && ax >= az;
    const bool is_y = !is_x && ay >= az;
    const int face = is_x ? (x >= 0.0f ? 1 : 0)
                          : (is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 5 : 4));
    const float m = fmaxf(is_x ? ax : (is_y ? ay : az), 1e-12f);
    const float xn = x / m, yn = y / m, zn = z / m;
    const float u = face == 0 ? zn
                    : (face == 1 ? -zn : (face == 5 ? xn : -xn));
    const float v = face == 2 ? -zn : (face == 3 ? zn : -yn);
    const int iu = vvr_trunc_clip((u * 0.5f + 0.5f) * (float)r, 0, r - 1);
    const int iv = vvr_trunc_clip((v * 0.5f + 0.5f) * (float)r, 0, r - 1);
    const float* t = skybox + ((size_t)(face * r + iv) * r + iu) * 3;
    return make_float3(__ldg(t), __ldg(t + 1), __ldg(t + 2));
}

// lighting_soa (shade.py:110-159) for the uniform terrain material:
// roughness 0.8, metallic 0; `visibility` is the AO term pow(ao, 1.4), 1
// without AO
static __device__ __forceinline__ float3 vvr_lighting(
        float ar, float ag, float ab, float nx, float ny, float nz, float vx,
        float vy, float vz, float sx, float sy, float sz, float shadow,
        float cr, float cg, float cb, float visibility) {
    const float rough = 0.8f, f0 = 0.04f;
    float hx = vx + sx, hy = vy + sy, hz = vz + sz;
    const float hn = fmaxf(sqrtf((hx * hx + hy * hy) + hz * hz), 1e-12f);
    hx = hx / hn;
    hy = hy / hn;
    hz = hz / hn;
    const float hv = vvr_clamp((hx * vx + hy * vy) + hz * vz, 0.0f, 1.0f);
    const float cos_t = vvr_clamp(1.0f - fmaxf(hv, 0.0f), 0.0f, 1.0f);
    const float ks = f0 + (fmaxf(1.0f - rough, f0) - f0) * powf(cos_t, 5.0f);
    const float kd = 1.0f - ks;
    const float a = rough * rough;
    const float a2 = a * a;
    const float n_dot_h = fmaxf((nx * hx + ny * hy) + nz * hz, 0.0f);
    const float semi = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
    const float nd = a2 / (VVR_PI_F * semi * semi);
    const float r1 = rough + 1.0f;
    const float k = (r1 * r1) / 8.0f;
    const float nv = fmaxf((nx * vx + ny * vy) + nz * vz, 0.0f);
    const float nl = fmaxf((nx * sx + ny * sy) + nz * sz, 0.0f);
    const float g = (nv / (nv * (1.0f - k) + k)) * (nl / (nl * (1.0f - k) + k));
    const float fr = f0 + (1.0f - f0) * powf(1.0f - hv, 5.0f);
    const float denom = fmaxf(4.0f * nv * nl, 1e-4f);
    const float tmp = nd * g * fr / denom;
    const float spec = isinf(tmp) ? 1000.0f : vvr_clamp(tmp, 0.0f, 1000.0f);
    const float n_dot_l = fmaxf((sx * nx + sy * ny) + sz * nz, 0.0f);
    const float w = n_dot_l * shadow;
    const float amb = 0.2f * kd * visibility * 0.2f;
    return make_float3((kd * ar / VVR_PI_F + spec) * cr * w + amb * ar,
                       (kd * ag / VVR_PI_F + spec) * cg * w + amb * ag,
                       (kd * ab / VVR_PI_F + spec) * cb * w + amb * ab);
}
