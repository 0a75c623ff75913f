// K14 soft_shadow: soft and pixelated sun shadows, one thread per pixel
// from the primary hits (ops/softshadow.py wraps it). Replaces the soft
// branch of vvr_tpu/render/frame.py's bounce body (`shadow_samples > 1`,
// :308-464, with `soft_shadow_gate` and `near_walk_classify` of
// vvr_tpu/ops/sunshadow.py:771, :617) and the pixelated query point
// (:283-286). A thread:
//  1. reconstructs its hit's surface (surface.cuh, as K2 and K12 do) and,
//     with pixelated shadows, floors it to quarter voxels: the query p;
//  2. traces only if its face turns toward the sun; with the cone grids
//     (gate mode) it first reads p's cone gBC row once for all samples:
//     certain shadow (kh) or certain light (km) answers every sample;
//  3. per sample s: the jittered direction and its strength, the start
//     p + sun * 0.004 + d_s * 0.05, and the sample's hit: in gate mode the
//     exact walk of its first crossings (sunmask.cuh vvr_near_segment), a
//     world exit or a lift above p's cone gridC, then the jump-grid DDA of
//     what is left (jump_dda.cuh, K12's shadow semantics); in DDA mode
//     the DDA of every sample;
//  4. adds where(hit, 0, strength * (1 - cloud alpha along d_s)) / S, in
//     sample order, and writes the factor (0 on a miss) and, if asked, each
//     sample's hit.
// The jitter rounds as the JAX package's jitted frame does (XLA's FMAs at
// the points ops/softshadow.py lists, here __fmaf_rn; the file is built
// with -fmad=false otherwise), so a sample's direction and start equal the
// plain version's bit for bit; its strength's powf may differ from the
// CPU's pow by an ulp or two. The TPU design's packed residue, its waves
// and its overflow net are not ported: a thread runs its lane's samples in
// turn (a compacted residue measured slower for K12).
//
// What bounds it on an H100: per pixel 33 bytes of primary hit in and 4 out;
// per traced sample the DDA's chain of dependent row loads (latency-bound
// like K1) and one cloud texel (L2-resident).
#include "clouds.cuh"
#include "jump_dda.cuh"
#include "sunmask.cuh"
#include "surface.cuh"

struct VvrSoftArgs {
    const uint32_t* rows;
    int size, samples, max_steps, cl_res;
    bool pixelated;
    float sx, sy, sz;
    const float* clouds;
    VvrSunBasis B;           // gate mode: the cone grids
    const float2* gbc;       // null in DDA mode
    VvrSunFrame G;
};

// the hash's three channels from x, y, z and its dot product d, each
// turned into the sun plus its jitter
static __device__ __forceinline__ void vvr_jitter(float x, float y, float z,
                                                  float d, float sx, float sy,
                                                  float sz, float* j) {
    const float ax = x + d, ay = y + d, az = z + d;
    const float r0 = vvr_fract((ax + ay) * az);
    const float r1 = vvr_fract((ax + ax) * ay);
    const float r2 = vvr_fract((ay + ax) * ax);
    j[0] = __fmaf_rn(r0 * 2.0f - 1.0f, 0.005f, sx);
    j[1] = __fmaf_rn(r1 * 2.0f - 1.0f, 0.005f, sy);
    j[2] = __fmaf_rn(r2 * 2.0f - 1.0f, 0.005f, sz);
}

// sample s's jittered unit direction and strength at p (`sample_dir`,
// frame.py:339-354), with XLA's contractions
static __device__ __forceinline__ float vvr_sample_dir(
        int s, float px, float py, float pz, float sx, float sy, float sz,
        float* dx, float* dy, float* dz) {
    const float c1 = 23.12123545f;
    float hx, hy, hz;
    if (s == 0) {   // p * c1 + 0, the two constants folded
        hx = px * (c1 * 0.1031f);
        hy = py * (c1 * 0.1030f);
        hz = pz * (c1 * 0.0973f);
    } else {
        const float c2 = (float)((double)s * 30.43324);
        hx = __fmaf_rn(px, c1, c2) * 0.1031f;
        hy = __fmaf_rn(py, c1, c2) * 0.1030f;
        hz = __fmaf_rn(pz, c1, c2) * 0.0973f;
    }
    const float x = vvr_fract(hx), y = vvr_fract(hy), z = vvr_fract(hz);
    // the dot product, its first sum fusing the y term onto the x term's
    // product (d_a) or the x term onto the y term's (d_b): the jitter's x
    // and y channels take d_a, its z channel d_b
    const float d_a = __fmaf_rn(z, z + 33.33f,
                                __fmaf_rn(y, x + 33.33f, x * (y + 33.33f)));
    const float d_b = __fmaf_rn(z, z + 33.33f,
                                __fmaf_rn(x, y + 33.33f, y * (x + 33.33f)));
    float ja[3], jb[3];
    vvr_jitter(x, y, z, d_a, sx, sy, sz, ja);
    vvr_jitter(x, y, z, d_b, sx, sy, sz, jb);
    const float jx = ja[0], jy = ja[1], jz = jb[2];
    const float sn = fmaxf(sqrtf(__fmaf_rn(jz, jz, __fmaf_rn(jx, jx, jy * jy))),
                           1e-12f);
    *dx = jx / sn;
    *dy = jy / sn;
    *dz = jz / sn;
    const float c = __fmaf_rn(*dz, sz, __fmaf_rn(*dx, sx, *dy * sy));
    return powf(vvr_clamp(c, 0.0f, 1.0f), 40.0f);
}

__global__ void __launch_bounds__(128)
vvr_soft_shadow_kernel(VvrSoftArgs A, const float* __restrict__ o,
                       const float* __restrict__ d,
                       const uint8_t* __restrict__ hit,
                       const int* __restrict__ face,
                       const int* __restrict__ axis_coord, int n,
                       float* __restrict__ factor,
                       uint8_t* __restrict__ hits) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    if (hit[p] == 0) {
        factor[p] = 0.0f;
        if (hits != nullptr) {
            for (int s = 0; s < A.samples; ++s) hits[(size_t)s * n + p] = 0;
        }
        return;
    }
    Surface q = vvr_reconstruct(o[3 * p], o[3 * p + 1], o[3 * p + 2],
                                d[3 * p], d[3 * p + 1], d[3 * p + 2],
                                face[p], axis_coord[p]);
    if (A.pixelated) vvr_pixelate(&q);
    const float px = q.wx, py = q.wy, pz = q.wz;
    const bool active = ((q.nx * A.sx + q.ny * A.sy) + q.nz * A.sz) > 0.0f;
    const float fs = (float)A.size;
    bool kh = false, km = false;
    float row_c = 3e38f;
    if (A.gbc != nullptr) {   // the cone gate (soft_shadow_gate)
        const bool inw = px >= 0.0f && px < fs && py >= 0.0f && py < fs
                         && pz >= 0.0f && pz < fs;
        const VvrSunRow r = vvr_sun_row(px, py, pz, A.B, A.gbc, A.G);
        const bool inb = inw && r.ing;
        kh = active && inb && r.qz + 0.06f < r.row.x - VVR_SAFE;
        km = active && !kh && ((inb && r.qz > r.row.y + VVR_SAFE) || !inw);
        if (r.ing) row_c = r.row.y;
    }
    const bool traced = active && !kh && !km;
    float shadow = 0.0f;
    for (int s = 0; s < A.samples; ++s) {
        float dx, dy, dz;
        const float strength = vvr_sample_dir(s, px, py, pz, A.sx, A.sy,
                                              A.sz, &dx, &dy, &dz);
        bool s_hit = kh;
        if (traced) {
            const float ox = __fmaf_rn(dx, 0.05f, px + A.sx * 0.004f);
            const float oy = __fmaf_rn(dy, 0.05f, py + A.sy * 0.004f);
            const float oz = __fmaf_rn(dz, 0.05f, pz + A.sz * 0.004f);
            bool run = true;
            if (A.gbc != nullptr) {   // near_walk_classify
                const bool inw = ox >= 0.0f && ox < fs && oy >= 0.0f
                                 && oy < fs && oz >= 0.0f && oz < fs;
                run = false;
                if (inw) {
                    bool nh, nexit;
                    float t_end;
                    vvr_near_segment(A.rows, A.size, ox, oy, oz, dx, dy, dz,
                                     &nh, &nexit, &t_end);
                    const float lift =
                        ((ox * A.sx + oy * A.sy) + oz * A.sz)
                        + t_end * ((dx * A.sx + dy * A.sy) + dz * A.sz);
                    s_hit = nh;
                    run = !nh && !nexit && !(lift > row_c + VVR_SAFE);
                }
            }
            if (run) {
                s_hit = vvr_jump_trace_ray<false>(A.rows, A.size, ox, oy, oz,
                                                  dx, dy, dz, true,
                                                  A.max_steps).hit;
            }
        }
        if (hits != nullptr) hits[(size_t)s * n + p] = s_hit ? 1 : 0;
        const float cl_a = vvr_sample_clouds(A.clouds, A.cl_res, dx, dy, dz,
                                             px, py, pz).w;
        shadow = shadow
                 + (s_hit ? 0.0f : strength * (1.0f - cl_a))
                       / (float)A.samples;
    }
    factor[p] = shadow;
}

extern "C" int vvr_soft_shadow(
        const void* rows, int size, const void* o, const void* d,
        const void* hit, const void* face, const void* axis_coord, int n,
        float sx, float sy, float sz, int samples, int pixelated,
        const void* clouds, int cl_res, int max_steps, float e1x, float e1y,
        float e1z, float e2x, float e2y, float e2z, const void* gbc,
        int grid, float a0, float b0, float ts, void* factor, void* hits,
        void* stream) {
    if (samples < 1 || cl_res < 1 || (gbc != nullptr && grid < 1)) {
        return (int)cudaErrorInvalidValue;
    }
    VvrSoftArgs A;
    A.rows = (const uint32_t*)rows;
    A.size = size;
    A.samples = samples;
    A.max_steps = max_steps;
    A.cl_res = cl_res;
    A.pixelated = pixelated != 0;
    A.sx = sx;
    A.sy = sy;
    A.sz = sz;
    A.clouds = (const float*)clouds;
    A.B = {e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz};
    A.gbc = (const float2*)gbc;
    A.G = {a0, b0, ts, grid};
    if (n > 0) {
        vvr_soft_shadow_kernel<<<vvr_blocks(n, 128), 128, 0,
                                 (cudaStream_t)stream>>>(
            A, (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord, n, (float*)factor,
            (uint8_t*)hits);
    }
    return (int)cudaGetLastError();
}
