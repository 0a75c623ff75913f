// K2: bounce-0 surface reconstruction and shading, one thread per pixel
// (ops/shade.py wraps both entry points). Replaces the bounce-0 body of
// vvr_tpu/render/frame.py:192-570 for the slice configuration, with
// vvr_tpu/ops/shade.py `material_at_soa`, `get_face_normal_soa`,
// `lighting_soa` and the nearest cloud/skybox lookups of
// vvr_tpu/ops/sky.py:243-330. `shade_surface` writes the shadow rays'
// starts for K1 in the DDA frame; the default frame's K12 computes them in
// registers from the same surface.cuh.
#include "surface.cuh"

#define VVR_PI_F 3.1415926538f
#define VVR_CLOUD_HEIGHT 800.0f
#define VVR_CLOUD_EXTENT 8000.0f

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

// nearest cloud texel along (d from p) on the cloud plane
// (sky.py:243-258); rgba = 0 where the plane is not ahead or off-texture
static __device__ __forceinline__ float4 vvr_sample_clouds(
        const float* __restrict__ clouds, int r, float dx, float dy, float dz,
        float px, float py, float pz) {
    const float denom = -dy;
    const float t = -(VVR_CLOUD_HEIGHT - py)
                    / (fabsf(denom) < 1e-4f ? 1.0f : denom);
    const float u = (px + t * dx) / VVR_CLOUD_EXTENT + 0.5f;
    const float v = (pz + t * dz) / VVR_CLOUD_EXTENT + 0.5f;
    const bool valid = fabsf(denom) > 1e-4f && t >= 0.0f && u >= 0.0f
                       && u <= 1.0f && v >= 0.0f && v <= 1.0f;
    if (!valid) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int iu = vvr_trunc_clip(u * (float)r, 0, r - 1);
    const int iv = vvr_trunc_clip(v * (float)r, 0, r - 1);
    return __ldg(reinterpret_cast<const float4*>(clouds) + iv * r + iu);
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
// roughness 0.8, metallic 0, visibility 1
static __device__ __forceinline__ float3 vvr_lighting(
        float ar, float ag, float ab, float nx, float ny, float nz, float vx,
        float vy, float vz, float sx, float sy, float sz, float shadow,
        float cr, float cg, float cb) {
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
    const float amb = 0.2f * kd * 1.0f * 0.2f;
    return make_float3((kd * ar / VVR_PI_F + spec) * cr * w + amb * ar,
                       (kd * ag / VVR_PI_F + spec) * cg * w + amb * ag,
                       (kd * ab / VVR_PI_F + spec) * cb * w + amb * ab);
}

__global__ void vvr_shade_surface_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const uint8_t* __restrict__ hit, const int* __restrict__ face,
        const int* __restrict__ axis_coord, int n, float sx, float sy,
        float sz, float* __restrict__ s_o, uint8_t* __restrict__ s_act) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Surface s = vvr_reconstruct(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                      d[3 * i], d[3 * i + 1], d[3 * i + 2],
                                      face[i], axis_coord[i]);
    const VvrShadowStart st = vvr_shadow_start(s, hit[i] != 0, sx, sy, sz);
    s_o[3 * i] = st.x;
    s_o[3 * i + 1] = st.y;
    s_o[3 * i + 2] = st.z;
    s_act[i] = st.active ? 1 : 0;
}

__global__ void vvr_shade_pixel_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const uint8_t* __restrict__ hit, const int* __restrict__ face,
        const int* __restrict__ axis_coord,
        const uint8_t* __restrict__ shadow_hit, int n, int size,
        const float* __restrict__ skybox, int sky_res,
        const float* __restrict__ clouds, int cl_res, float sx, float sy,
        float sz, float cr, float cg, float cb, float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    float r, g, b, alpha;
    if (hit[i] != 0) {
        const Surface s = vvr_reconstruct(ox, oy, oz, dx, dy, dz, face[i],
                                          axis_coord[i]);
        float shadow = 1.0f;
        if (shadow_hit != nullptr) {
            // hit lanes sample the clouds toward the sun from the surface
            const float4 cl = vvr_sample_clouds(clouds, cl_res, sx, sy, sz,
                                                s.wx, s.wy, s.wz);
            shadow = shadow_hit[i] != 0 ? 0.0f : 1.0f - cl.w;
        }
        float ar = 1.0f, ag = 1.0f, ab = 1.0f;
        if (s.bx > size / 2) {
            float c0, c1, c2;
            vvr_block_colour(s.bx, s.by, s.bz, &c0, &c1, &c2);
            ar = c0 + (1.0f - c0) * 0.5f;
            ag = c1 + (1.0f - c1) * 0.5f;
            ab = c2 + (1.0f - c2) * 0.5f;
        }
        const float3 lit = vvr_lighting(ar, ag, ab, s.nx, s.ny, s.nz, -dx,
                                        -dy, -dz, sx, sy, sz, shadow, cr, cg,
                                        cb);
        r = lit.x;
        g = lit.y;
        b = lit.z;
        alpha = 0.0f;
    } else {
        // miss: skybox blended with the clouds along the camera ray
        const float4 cl = vvr_sample_clouds(clouds, cl_res, dx, dy, dz, ox,
                                            oy, oz);
        const float3 sb = vvr_sample_skybox(skybox, sky_res, dx, dy, dz);
        r = sb.x + (cl.x - sb.x) * cl.w;
        g = sb.y + (cl.y - sb.y) * cl.w;
        b = sb.z + (cl.z - sb.z) * cl.w;
        alpha = 10.0f;
    }
    out[i] = r;
    out[n + i] = g;
    out[2 * (size_t)n + i] = b;
    out[3 * (size_t)n + i] = alpha;
}

extern "C" int vvr_shade_surface(const void* o, const void* d,
                                 const void* hit, const void* face,
                                 const void* axis_coord, int n, float sx,
                                 float sy, float sz, void* s_o, void* s_act,
                                 void* stream) {
    if (n > 0) {
        vvr_shade_surface_kernel<<<vvr_blocks(n, 256), 256, 0,
                                   (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord, n, sx, sy, sz,
            (float*)s_o, (uint8_t*)s_act);
    }
    return (int)cudaGetLastError();
}

extern "C" int vvr_shade_pixel(const void* o, const void* d, const void* hit,
                               const void* face, const void* axis_coord,
                               const void* shadow_hit, int n, int size,
                               const void* skybox, int sky_res,
                               const void* clouds, int cl_res, float sx,
                               float sy, float sz, float cr, float cg,
                               float cb, void* out, void* stream) {
    if (n > 0) {
        vvr_shade_pixel_kernel<<<vvr_blocks(n, 256), 256, 0,
                                 (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord,
            (const uint8_t*)shadow_hit, n, size, (const float*)skybox,
            sky_res, (const float*)clouds, cl_res, sx, sy, sz, cr, cg, cb,
            (float*)out);
    }
    return (int)cudaGetLastError();
}
