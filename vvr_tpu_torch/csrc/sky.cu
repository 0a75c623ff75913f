// K3: the sky textures, both in one launch per sky bucket (ops/sky.py
// wraps it). Replaces vvr_tpu/ops/sky.py:285 `write_skybox` and :193
// `write_clouds`, with `sky`, `scatter`, `optical_depth`, `stars` and
// `sun_colour` (sky.py:58-185) as device functions.
//
// One thread per texel. The grid's first blocks cover the 6 faces of the
// skybox, the rest the cloud texture; a null output skips its texture.
// Each warp takes a kTileW x kTileH tile of one face, so the branches that
// follow the direction (optical_depth's `mid > 0`, scatter's planet hit)
// split fewer warps than a row of 32 would where a branch boundary crosses
// rows. What is the same for every texel of a launch (the normalized sun,
// the light path's optical depth from the camera and its extinction, the
// sun colour, day, night and the clouds' sun strength) is computed once
// per block, by the same device functions, into shared memory: the texels
// read the same bits they used to compute for themselves.
//
// What bounds it on the H100: issue. A texel is about 2,000 instructions
// (closed-form optical depths: IEEE sqrt, exp and division; the clouds'
// five simplex-noise octaves), some 30 of them special-function (MUFU)
// operations; the outputs are 4.7 MB. PERF.md gives the SFU, FMA and byte
// terms of its bound.
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

// a warp's tile of texels (kTileW x kTileH = 32) and the block size
// (tile shapes measured equal; 256 threads beat 64, 128 and 512: PERF.md)
constexpr int kTileW = 4;
constexpr int kTileH = 32 / kTileW;
constexpr int kSkyThreads = 256;

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

// (sky.slang:134-140), NaN-safe; ea = expf(-a), a constant of the launch
__device__ __forceinline__ float attenuate(float a, float ea, float b) {
    const float denom = b - a;
    const float fst = (ea - expf(-b)) / (fabsf(denom) < 1e-5f ? 1.0f : denom);
    return fabsf(a - b) < 1e-5f ? ea : fst;
}

__device__ __forceinline__ float extinct(V3 x, int j) {
    return (x.x * kRayScattering[j] + x.y * kMieExtinction[j])
           + x.z * kAbsorbExtinction[j];
}

// the camera's position over the planet (sky's ray start)
__host__ __device__ __forceinline__ V3 sky_start() {
    return v3(0.0f, (float)(0.8 + kBottomRadius), 0.0f);
}

// What every texel of a launch shares, computed once per block.
struct SkyConst {
    V3 sun;           // as given
    V3 sd;            // normalize(sun)
    V3 light_start;   // optical_depth(sky_start(), sd)
    float ext[3];     // extinct(light_start, j)
    float ext_exp[3]; // expf(-ext[j])
    V3 sun_col;       // sun_colour(sun)
    float day, night; // sky's day and night weights
    float ss;         // the clouds' sun strength
};

// combined single scattering (sky.slang:143-169) from sky_start()
__device__ V3 scatter(const SkyConst& k, V3 dir, float depth) {
    const V3 ray = sky_start();
    const V3 view_start = optical_depth(ray, dir);
    V3 view_end = v3(0.0f, 0.0f, 0.0f), light_end = v3(0.0f, 0.0f, 0.0f);
    if (depth >= 0.0f) {
        const V3 end = add(ray, scale(dir, depth));
        view_end = optical_depth(end, dir);
        light_end = optical_depth(end, k.sd);
    }
    const V3 path = sub(add(light_end, view_start), view_end);
    const V3 dv = sub(view_start, view_end);
    const float cg = dot(dir, k.sd);
    const float pr = (float)(3.0 / (16.0 * kPi)) * (1.0f + cg * cg);
    const float k_mie = (float)(3.0 / (8.0 * kPi) * (1.0 - kMieG * kMieG)
                                / (2.0 + kMieG * kMieG));
    const float pm = k_mie * (1.0f + cg * cg)
                     / powf((float)(1.0 + kMieG * kMieG)
                            - (float)(2.0 * kMieG) * cg, 1.5f);
    float out[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float attn = attenuate(k.ext[j], k.ext_exp[j],
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
__device__ V3 sky(const SkyConst& k, V3 rd, bool extra_light) {
    const V3 start = sky_start();
    const float pb = dot(start, rd);
    const float pc = dot(start, start) - (float)(kBottomRadius * kBottomRadius);
    const float ph = pb * pb - pc;
    const float planet = ph < 0.0f ? -1.0f : -pb - sqrtf(fmaxf(ph, 0.0f));
    V3 res = scale(scale(scatter(k, rd, planet), 4.0f), k.day);
    if (extra_light) {
        const float disc = vvr_smooth01(vvr_clamp(
            (dot(rd, k.sun) - 0.9999f) / (float)(0.999935 - 0.9999), 0.0f,
            1.0f));
        res = add(res, scale(k.sun_col, disc * k.day * 500.0f));
        const float st = stars(rd) * 0.3f * k.night;
        res = add(res, v3(st, st, st));
    }
    return res;
}

// The launch's constants, three independent chains, each on its own warp
// where the block has three (the light path's is the longest).
__device__ void sky_constants(V3 sun, SkyConst* k) {
    constexpr int kWarps = kSkyThreads / 32;
    const int t = threadIdx.x;
    if (t == 0) {
        k->sun = sun;
        k->sd = normalize(sun);
        k->light_start = optical_depth(sky_start(), k->sd);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            k->ext[j] = extinct(k->light_start, j);
            k->ext_exp[j] = expf(-k->ext[j]);
        }
    }
    if (t == 32 * (1 % kWarps)) k->sun_col = sun_colour(sun);
    if (t == 32 * (2 % kWarps)) {
        k->day = vvr_smooth01(vvr_clamp((sun.y + 0.1f) / 0.2f, 0.0f, 1.0f));
        k->night = 1.0f - vvr_smooth01(vvr_clamp((sun.y + 0.3f) / 0.3f,
                                                 0.0f, 1.0f));
        k->ss = vvr_smooth01(vvr_clamp(sun.y / 0.2f, 0.0f, 1.0f));
    }
}

__device__ void skybox_texel(const SkyConst& k, int r, int face, int row,
                             int col, float* __restrict__ out) {
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
    const V3 c = sky(k, d, true);
    float* o = out + 3 * (((size_t)face * r + row) * r + col);
    o[0] = c.x;
    o[1] = c.y;
    o[2] = c.z;
}

struct Octaves {
    float freq[4];
    float amp[4];
};

__device__ void cloud_texel(const SkyConst& k, float time, Octaves oct,
                            int r, int row, int col,
                            float4* __restrict__ out) {
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

    const V3 sun = k.sun;
    const V3 ray_dir = normalize(v3(px, 800.0f, pz));
    const V3 bottom_n = normalize(v3(dx, -1.0f, dy));
    const V3 top_n = scale(bottom_n, -1.0f);
    const float scattered = vvr_clamp(
        powf(vvr_clamp(dot(ray_dir, sun), 0.0f, 1.0f) + 0.3f, 4.0f), 0.0f,
        1.0f) * k.ss;
    const V3 reflected = sub(sun, scale(bottom_n, 2.0f * dot(bottom_n, sun)));
    const float silver = sqrtf(vvr_clamp(dot(ray_dir, reflected), 0.0f, 1.0f))
                         * k.ss;
    const V3 amb = sky(k, top_n, false);
    const float base = (silver * 0.3f) * (1.0f - scattered) + 1.4f * scattered
                       + 0.4f;
    out[(size_t)row * r + col] = make_float4(
        base * (amb.x + 0.3f), base * (amb.y + 0.3f), base * (amb.z + 0.3f),
        vvr_clamp(opacity, 0.0f, 1.0f));
}

// Blocks [0, sky_blocks) hold the skybox's tiles, face by face, the rest
// the clouds'; each warp one tile, row-major over a face's tiles.
__global__ void __launch_bounds__(kSkyThreads)
vvr_sky_kernel(V3 sun, float time, Octaves oct, int r_sky, int sky_blocks,
               float* __restrict__ skybox, int r_clouds,
               float4* __restrict__ clouds) {
    __shared__ SkyConst k;
    sky_constants(sun, &k);
    __syncthreads();
    const bool is_sky = (int)blockIdx.x < sky_blocks;
    const int r = is_sky ? r_sky : r_clouds;
    const int w = ((int)blockIdx.x - (is_sky ? 0 : sky_blocks))
                  * (kSkyThreads / 32) + (int)threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    const int tiles_x = (r + kTileW - 1) / kTileW;
    const int per_face = tiles_x * ((r + kTileH - 1) / kTileH);
    const int face = w / per_face;
    const int tile = w - face * per_face;
    const int row = (tile / tiles_x) * kTileH + lane / kTileW;
    const int col = (tile % tiles_x) * kTileW + lane % kTileW;
    if (face >= (is_sky ? 6 : 1) || row >= r || col >= r) return;
    if (is_sky) {
        skybox_texel(k, r, face, row, col, skybox);
    } else {
        cloud_texel(k, time, oct, r, row, col, clouds);
    }
}

// blocks that cover `faces` faces of r x r texels, a warp a tile
long long sky_grid_blocks(int r, int faces) {
    const long long tiles = (long long)((r + kTileW - 1) / kTileW)
                            * ((r + kTileH - 1) / kTileH) * faces;
    return (tiles + kSkyThreads / 32 - 1) / (kSkyThreads / 32);
}

}  // namespace

// Both sky textures in one launch: skybox (6, r_sky, r_sky, 3) and clouds
// (r_clouds, r_clouds, 4), float32; a null pointer skips its texture, and
// clouds is 16-byte aligned (written as float4).
extern "C" int vvr_write_sky(float sx, float sy, float sz, float time,
                             int r_sky, int r_clouds, void* skybox,
                             void* clouds, void* stream) {
    // per-octave frequency and amplitude as the JAX loop forms them in
    // doubles: (2.3 ** i) * 0.0015 and 0.7 ** i, rounded to float32
    Octaves oct;
    for (int i = 0; i < 4; ++i) {
        oct.freq[i] = (float)(std::pow(2.3, i) * 0.0015);
        oct.amp[i] = (float)std::pow(0.7, i);
    }
    const long long sky_blocks = skybox ? sky_grid_blocks(r_sky, 6) : 0;
    const long long blocks = sky_blocks
                             + (clouds ? sky_grid_blocks(r_clouds, 1) : 0);
    if (blocks == 0) return (int)cudaSuccess;
    vvr_sky_kernel<<<(unsigned)blocks, kSkyThreads, 0,
                     (cudaStream_t)stream>>>(
        v3(sx, sy, sz), time, oct, r_sky, (int)sky_blocks, (float*)skybox,
        r_clouds, (float4*)clouds);
    return (int)cudaGetLastError();
}
