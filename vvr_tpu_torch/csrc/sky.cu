// K3: the sky textures, one thread per texel (ops/sky.py wraps both entry
// points). Replaces vvr_tpu/ops/sky.py:285 `write_skybox` and :193
// `write_clouds`, with `sky`, `scatter`, `optical_depth`, `stars` and
// `sun_colour` (sky.py:58-185) as device functions.
#include <cmath>

#include "common.cuh"

namespace {

struct V3 {
    float x, y, z;
};

__host__ __device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
    return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 normalize(V3 a) {
    const float n = sqrtf(dot(a, a));
    return v3(a.x / n, a.y / n, a.z / n);
}

constexpr double kBottomRadius = 6360.0;
constexpr double kRayExpScaleB = -0.125;
constexpr double kMieExpScaleB = -0.833333;
constexpr double kMieG = 0.8;
constexpr double kAbsorbWidthA = 25.0;
constexpr double kAbsorbLinearA = 0.066667;
constexpr double kAbsorbConstA = -0.666667;
constexpr double kAbsorbLinearB = -0.66667;
constexpr double kAbsorbConstB = 2.666667;
constexpr double kPi = 3.14159265358979;

__constant__ float kRayScattering[3] = {0.005802f, 0.013558f, 0.033100f};
__constant__ float kMieScattering[3] = {0.003996f, 0.003996f, 0.003996f};
__constant__ float kMieExtinction[3] = {0.004440f, 0.004440f, 0.004440f};
__constant__ float kAbsorbExtinction[3] = {0.000650f, 0.001881f, 0.000085f};

// closed-form optical depth (sky.slang:95-118): rayleigh, mie, ozone
__device__ V3 scaled_depth(V3 ray, V3 dir) {
    const float R = (float)kBottomRadius;
    const float b = dot(ray, dir);
    const float c = dot(ray, ray);
    const float h = sqrtf(c);
    const float r0 = fmaxf(h - (float)(1.0 / kRayExpScaleB), R);
    const float r1 = fmaxf(h - (float)(1.0 / kMieExpScaleB), R);
    const float r2 = fmaxf(h, (float)(kBottomRadius + 1.5 * kAbsorbWidthA
                                      + 0.5 * kAbsorbConstB / kAbsorbLinearB));
    const float r3 = fmaxf(h, (float)(kBottomRadius + 1.5 * kAbsorbWidthA
                                      + 0.5 * kAbsorbConstA / kAbsorbLinearA));
    const float above = fmaxf(h - R, 0.0f);
    const float s0 = expf(above * (float)kRayExpScaleB);
    const float s1 = expf(above * (float)kMieExpScaleB);
    const float bb = b * b;
    const float d0 = sqrtf(fmaxf(bb + r0 * r0 - c, 0.0f));
    const float d1 = sqrtf(fmaxf(bb + r1 * r1 - c, 0.0f));
    const float d2 = sqrtf(fmaxf(bb + r2 * r2 - c, 0.0f));
    const float d3 = sqrtf(fmaxf(bb + r3 * r3 - c, 0.0f));
    return v3(s0 * (d0 - b), s1 * (d1 - b), d3 - d2);
}

// (sky.slang:120-131)
__device__ V3 optical_depth(V3 ray, V3 dir) {
    const float mid = dot(ray, dir);
    if (mid > 0.0f) return scaled_depth(ray, dir);
    const V3 a = scaled_depth(sub(ray, scale(dir, mid)), dir);
    const V3 b = scaled_depth(ray, scale(dir, -1.0f));
    return sub(scale(a, 2.0f), b);
}

// (sky.slang:134-140), NaN-safe
__device__ __forceinline__ float attenuate(float a, float b) {
    const float denom = b - a;
    const float fst = (expf(-a) - expf(-b))
                      / (fabsf(denom) < 1e-5f ? 1.0f : denom);
    return fabsf(a - b) < 1e-5f ? expf(-a) : fst;
}

__device__ __forceinline__ float extinct(V3 x, int j) {
    return (x.x * kRayScattering[j] + x.y * kMieExtinction[j])
           + x.z * kAbsorbExtinction[j];
}

// combined single scattering (sky.slang:143-169)
__device__ V3 scatter(V3 ray, V3 dir, V3 light, float depth) {
    const V3 view_start = optical_depth(ray, dir);
    const V3 light_start = optical_depth(ray, light);
    V3 view_end = v3(0.0f, 0.0f, 0.0f), light_end = v3(0.0f, 0.0f, 0.0f);
    if (depth >= 0.0f) {
        const V3 end = add(ray, scale(dir, depth));
        view_end = optical_depth(end, dir);
        light_end = optical_depth(end, light);
    }
    const V3 path = sub(add(light_end, view_start), view_end);
    const V3 dv = sub(view_start, view_end);
    const float cg = dot(dir, light);
    const float pr = (float)(3.0 / (16.0 * kPi)) * (1.0f + cg * cg);
    const float k_mie = (float)(3.0 / (8.0 * kPi) * (1.0 - kMieG * kMieG)
                                / (2.0 + kMieG * kMieG));
    const float pm = k_mie * (1.0f + cg * cg)
                     / powf((float)(1.0 + kMieG * kMieG)
                            - (float)(2.0 * kMieG) * cg, 1.5f);
    float out[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float attn = attenuate(extinct(light_start, j),
                                     extinct(path, j));
        out[j] = 4.0f * (attn * dv.x * kRayScattering[j] * pr
                         + attn * dv.y * kMieScattering[j] * pm);
    }
    return v3(out[0], out[1], out[2]);
}

// night stars (sky.slang:171-183)
__device__ float stars(V3 rd) {
    const float y = rd.y;
    const float cx = floorf(rd.x / (y + 1.0f) * 700.0f + 234.0f);
    const float cz = floorf(rd.z / (y + 1.0f) * 700.0f + 234.0f);
    const float br = vvr_smooth01(vvr_clamp((vvr_hash12(cx, cz) - 0.98f)
                                            / 0.02f, 0.0f, 1.0f));
    return y <= 0.0f ? 0.0f : br * 0.5f * y;
}

// sunset <-> midday lerp by sun height (sky.slang:189-195)
__device__ V3 sun_colour(V3 sun) {
    const float e = (float)(1.0 / 2.2);
    const V3 midday = v3(powf(252.0f / 255.0f, e), powf(232.0f / 255.0f, e),
                         powf(212.0f / 255.0f, e));
    const V3 sunset = v3(powf(249.0f / 255.0f, e), powf(128.0f / 255.0f, e),
                         powf(7.0f / 255.0f, e));
    const float t = vvr_smooth01(vvr_clamp(sun.y / 0.2f, 0.0f, 1.0f));
    return add(sunset, scale(sub(midday, sunset), t));
}

// sky radiance along rd (sky.slang:198-222)
__device__ V3 sky(V3 sun, V3 rd, bool extra_light) {
    const float day = vvr_smooth01(vvr_clamp((sun.y + 0.1f) / 0.2f, 0.0f,
                                             1.0f));
    const float night = 1.0f - vvr_smooth01(vvr_clamp((sun.y + 0.3f) / 0.3f,
                                                      0.0f, 1.0f));
    const V3 start = v3(0.0f, (float)(0.8 + kBottomRadius), 0.0f);
    const float pb = dot(start, rd);
    const float pc = dot(start, start) - (float)(kBottomRadius * kBottomRadius);
    const float ph = pb * pb - pc;
    const float planet = ph < 0.0f ? -1.0f : -pb - sqrtf(fmaxf(ph, 0.0f));
    const V3 sd = normalize(sun);
    V3 res = scale(scale(scatter(start, rd, sd, planet), 4.0f), day);
    if (extra_light) {
        const float disc = vvr_smooth01(vvr_clamp(
            (dot(rd, sun) - 0.9999f) / (float)(0.999935 - 0.9999), 0.0f,
            1.0f));
        res = add(res, scale(sun_colour(sun), disc * day * 500.0f));
        const float st = stars(rd) * 0.3f * night;
        res = add(res, v3(st, st, st));
    }
    return res;
}

__global__ void skybox_kernel(V3 sun, int r, float* __restrict__ out) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= 6 * r * r) return;
    const int face = idx / (r * r);
    const int row = (idx / r) % r;
    const int col = idx % r;
    const float u = ((float)col / (float)r) * 2.0f - 1.0f;
    const float v = ((float)row / (float)r) * 2.0f - 1.0f;
    V3 d;
    switch (face) {  // sky_compute.slang:62-97
        case 0: d = v3(-1.0f, -v, u); break;
        case 1: d = v3(1.0f, -v, -u); break;
        case 2: d = v3(-u, 1.0f, -v); break;
        case 3: d = v3(-u, -1.0f, v); break;
        case 4: d = v3(-u, -v, -1.0f); break;
        default: d = v3(u, -v, 1.0f); break;
    }
    d = normalize(d);
    d = v3(d.x * -1.0f, d.y, d.z * -1.0f);
    const V3 c = sky(sun, d, true);
    out[3 * (size_t)idx] = c.x;
    out[3 * (size_t)idx + 1] = c.y;
    out[3 * (size_t)idx + 2] = c.z;
}

struct Octaves {
    float freq[4];
    float amp[4];
};

__global__ void clouds_kernel(V3 sun, float time, int r, Octaves oct,
                              float* __restrict__ out) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= r * r) return;
    const int row = idx / r;
    const int col = idx % r;
    const float px = ((float)col / (float)r - 0.5f) * 8000.0f;
    const float pz = ((float)row / (float)r - 0.5f) * 8000.0f;
    const float drift = time * 0.03f;
    float value = 0.0f, dx = 0.0f, dy = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float v, gx, gy;
        vvr_sdnoise2(px * oct.freq[i] + drift, pz * oct.freq[i] + drift,
                     vvr_seed_key(17 + i), &v, &gx, &gy);
        value = value + v * oct.amp[i];
        dx = dx + gx * oct.amp[i];
        dy = dy + gy * oct.amp[i];
    }
    float mod, unused_x, unused_y;
    vvr_sdnoise2(px * 0.0005f, pz * 0.0005f, vvr_seed_key(3), &mod,
                 &unused_x, &unused_y);
    mod = vvr_smooth01(vvr_clamp(mod * 1.5f - 0.2f, 0.0f, 1.0f));
    const float opacity = value * mod * 6.0f;

    const V3 ray_dir = normalize(v3(px, 800.0f, pz));
    const V3 bottom_n = normalize(v3(dx, -1.0f, dy));
    const V3 top_n = scale(bottom_n, -1.0f);
    const float ss = vvr_smooth01(vvr_clamp(sun.y / 0.2f, 0.0f, 1.0f));
    const float scattered = vvr_clamp(
        powf(vvr_clamp(dot(ray_dir, sun), 0.0f, 1.0f) + 0.3f, 4.0f), 0.0f,
        1.0f) * ss;
    const V3 reflected = sub(sun, scale(bottom_n, 2.0f * dot(bottom_n, sun)));
    const float silver = sqrtf(vvr_clamp(dot(ray_dir, reflected), 0.0f, 1.0f))
                         * ss;
    const V3 amb = sky(sun, top_n, false);
    const float base = (silver * 0.3f) * (1.0f - scattered) + 1.4f * scattered
                       + 0.4f;
    float* o = out + 4 * (size_t)idx;
    o[0] = base * (amb.x + 0.3f);
    o[1] = base * (amb.y + 0.3f);
    o[2] = base * (amb.z + 0.3f);
    o[3] = vvr_clamp(opacity, 0.0f, 1.0f);
}

}  // namespace

extern "C" int vvr_write_skybox(float sx, float sy, float sz, int r,
                                void* out, void* stream) {
    const long long n = 6LL * r * r;
    skybox_kernel<<<vvr_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
        v3(sx, sy, sz), r, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int vvr_write_clouds(float sx, float sy, float sz, float time,
                                int r, void* out, void* stream) {
    // per-octave frequency and amplitude as the JAX loop forms them in
    // doubles: (2.3 ** i) * 0.0015 and 0.7 ** i, rounded to float32
    Octaves oct;
    for (int i = 0; i < 4; ++i) {
        oct.freq[i] = (float)(std::pow(2.3, i) * 0.0015);
        oct.amp[i] = (float)std::pow(0.7, i);
    }
    const long long n = (long long)r * r;
    clouds_kernel<<<vvr_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
        v3(sx, sy, sz), time, r, oct, (float*)out);
    return (int)cudaGetLastError();
}
