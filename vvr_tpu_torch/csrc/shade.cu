// K2: bounce-0 surface reconstruction and shading, one thread per pixel
// (ops/shade.py wraps both entry points). Replaces the bounce-0 body of
// vvr_tpu/render/frame.py:192-570 for the slice configuration, with
// vvr_tpu/ops/shade.py `material_at_soa`, `get_face_normal_soa`,
// `lighting_soa` and the nearest cloud/skybox lookups of
// vvr_tpu/ops/sky.py:243-330. `shade_surface` writes the hard shadow rays'
// starts for K1 in the DDA frame (from the quarter-voxel floor of the
// surface with pixelated shadows); the default frame's K12 computes them
// in registers from the same surface.cuh. `shade_pixel` takes the hard
// shadow rays' hits (the factor is then 1 - the cloud alpha toward the sun
// from the surface, or 0), K14's soft-shadow factor, or neither.
#include "clouds.cuh"
#include "shading.cuh"
#include "surface.cuh"

__global__ void vvr_shade_surface_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const uint8_t* __restrict__ hit, const int* __restrict__ face,
        const int* __restrict__ axis_coord, int n, float sx, float sy,
        float sz, bool pixelated, float* __restrict__ s_o,
        uint8_t* __restrict__ s_act) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Surface s = vvr_reconstruct(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                d[3 * i], d[3 * i + 1], d[3 * i + 2],
                                face[i], axis_coord[i]);
    if (pixelated) vvr_pixelate(&s);
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
        const uint8_t* __restrict__ shadow_hit,
        const float* __restrict__ shadow_factor, int n, int size,
        const float* __restrict__ skybox, int sky_res,
        const float* __restrict__ clouds, int cl_res, float sx, float sy,
        float sz, float cr, float cg, float cb, bool pixelated,
        float* __restrict__ out) {
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
            // (its quarter-voxel floor with pixelated shadows)
            Surface q = s;
            if (pixelated) vvr_pixelate(&q);
            const float4 cl = vvr_sample_clouds(clouds, cl_res, sx, sy, sz,
                                                q.wx, q.wy, q.wz);
            shadow = shadow_hit[i] != 0 ? 0.0f : 1.0f - cl.w;
        } else if (shadow_factor != nullptr) {
            shadow = shadow_factor[i];
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
                                        cb, 1.0f);
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
                                 float sy, float sz, int pixelated,
                                 void* s_o, void* s_act, void* stream) {
    if (n > 0) {
        vvr_shade_surface_kernel<<<vvr_blocks(n, 256), 256, 0,
                                   (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord, n, sx, sy, sz,
            pixelated != 0, (float*)s_o, (uint8_t*)s_act);
    }
    return (int)cudaGetLastError();
}

extern "C" int vvr_shade_pixel(const void* o, const void* d, const void* hit,
                               const void* face, const void* axis_coord,
                               const void* shadow_hit,
                               const void* shadow_factor, int n, int size,
                               const void* skybox, int sky_res,
                               const void* clouds, int cl_res, float sx,
                               float sy, float sz, float cr, float cg,
                               float cb, int pixelated, void* out,
                               void* stream) {
    if (n > 0) {
        vvr_shade_pixel_kernel<<<vvr_blocks(n, 256), 256, 0,
                                 (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord,
            (const uint8_t*)shadow_hit, (const float*)shadow_factor, n,
            size, (const float*)skybox, sky_res, (const float*)clouds,
            cl_res, sx, sy, sz, cr, cg, cb, pixelated != 0, (float*)out);
    }
    return (int)cudaGetLastError();
}
