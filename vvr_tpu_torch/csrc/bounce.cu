// K15 shade_bounce: one bounce of the frames with mirrors, filtered AO or
// point lights, one thread per lane over the whole image (ops/bounce.py
// wraps it and holds the plain version). Replaces the bounce body of
// vvr_tpu/render/frame.py:192-570 for what K2 shade_pixel does not cover,
// with the frame's write of its outputs (:615-621), the filtered AO of
// vvr_tpu/world/svt.py:26 and the point lights of frame.py:495-519. Per
// live lane: a miss shades the sky (as K2) times the lane's colour, alpha
// 10; a hit is a mirror when hash13 of its 8^3 block group is above 0.8;
// a shaded hit (no mirror) takes K2's shadow factor, the AO term, the
// lighting and the lights, times the lane's colour; a mirror writes its
// continuation (the reflected ray, the wavy normal's noise, the colour
// times the albedo) into the next bounce's buffers. AO, lights, mirrors
// and the wave are template flags, so a frame without one pays nothing
// for it. The frame launches it once per bounce over every lane; a lane
// that is not live exits at once.
//
// Rounding: the file is compiled with -fmad=false, and the mirror hash
// places __fmaf_rn where XLA's jit contracts it (utils/hash.py
// `hash13_soa`), so the mirror decision equals the JAX frame's. Everything
// else keeps the plain version's op order: the kernel equals it bit for
// bit but for powf (the lighting's and the AO's pow(ao, 1.4)).
//
// What bounds it on an H100: at bounce 0 the rays and hit flag of every
// lane, 16 B of HDR out and a flag byte, the hits' trace and the shaded
// hits' shadow, 36 B of continuation on mirror lanes, two L2-resident
// texture reads and, with AO, eight taps of the 16 MiB density field; at
// later bounces the live lanes' bytes and one flag byte of every lane.
// With lights, up to ten DDA walks a shaded lane, each a chain of
// dependent row loads like K1's. The grid is a template parameter
// (grid_view.cuh): the jump grid's DDA (K1's) or, past 512^3, the paged
// grid's (K16's), from one body.
#include "clouds.cuh"
#include "grid_view.cuh"
#include "overlap.cuh"
#include "shading.cuh"
#include "surface.cuh"

#define VVR_K15_BLOCK 128
#define VVR_MAX_LIGHTS 10

// the first ten lights of the frame: position and colour (hash33 * 0.3),
// passed by value in the launch's parameters
struct VvrLights {
    int count;
    float pos[VVR_MAX_LIGHTS][3];
    float col[VVR_MAX_LIGHTS][3];
};

template <class View>
struct VvrBounceArgs {
    View grid;                  // grid_view.cuh: the jump or the paged grid
    int n, sky_res, cl_res, max_steps;
    const float* o_in;
    const float* d_in;
    const float* col_in;        // null: every colour 1 (bounce 0)
    const uint8_t* active_in;   // null: every lane live (bounce 0)
    const uint8_t* hit;
    const int* face;
    const int* axis_coord;
    const uint8_t* shadow_hit;  // hard shadows' hits, or null
    const float* shadow_factor; // soft shadows' factor, or null
    const float* skybox;
    const float* clouds;
    const uint8_t* density;     // the filtered AO's field [z, y, x], or
                                // null for the overlap AO (with AO)
    float sx, sy, sz, cr, cg, cb, time;
    bool pixelated;
    float* out;                 // planar (4, n)
    float* o_out;               // the continuation, with mirrors; may be
    float* d_out;               // o_in, d_in, col_in, active_in
    float* col_out;
    uint8_t* active_out;
};

// hash13_soa (vvr_tpu/utils/hash.py:110), rounded as the jitted frame
static __device__ __forceinline__ float vvr_hash13(float x, float y,
                                                   float z) {
    float px = vvr_fract(x * 0.1031f);
    float py = vvr_fract(y * 0.1031f);
    float pz = vvr_fract(z * 0.1031f);
    const float d = __fmaf_rn(pz, px + 33.33f,
                              __fmaf_rn(py, py + 33.33f, px * (pz + 33.33f)));
    px = px + d;
    py = py + d;
    pz = pz + d;
    return vvr_fract((px + py) * pz);
}

static __device__ __forceinline__ uint32_t vvr_lattice_hash3(int ix, int iy,
                                                             int iz) {
    // seed 0: (0 * 0x27D4EB2F + 0x165667B1)
    return vvr_hash_u32(((uint32_t)ix * 0x9E3779B1u)
                        ^ ((uint32_t)iy * 0x85EBCA77u)
                        ^ ((uint32_t)iz * 0xC2B2AE3Du) ^ 0x165667B1u);
}

static __device__ __forceinline__ float vvr_fade(float t) {
    return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

// the corner (ox, oy, oz)'s gradient, one of 12 edge directions by selects
// (a table indexed at run time sits in local memory), dotted with the
// offset from that corner
static __device__ __forceinline__ float vvr_dot_grad3(int ix, int iy, int iz,
                                                      int ox, int oy, int oz,
                                                      float fx, float fy,
                                                      float fz) {
    const int idx = (int)((vvr_lattice_hash3(ix + ox, iy + oy, iz + oz)
                           >> 28) % 12u);
    const float a = (idx & 1) ? -1.0f : 1.0f;
    const float b = (idx & 2) ? -1.0f : 1.0f;
    const float gx = idx < 8 ? a : 0.0f;
    const float gy = idx < 4 ? b : (idx < 8 ? 0.0f : a);
    const float gz = idx < 4 ? 0.0f : b;
    return (gx * (fx - (float)ox) + gy * (fy - (float)oy))
           + gz * (fz - (float)oz);
}

// snoise3 (vvr_tpu/ops/noise.py:174): 3D Perlin noise, seed 0
static __device__ float vvr_snoise3(float x, float y, float z) {
    const float x0 = floorf(x), y0 = floorf(y), z0 = floorf(z);
    const float fx = x - x0, fy = y - y0, fz = z - z0;
    const int ix = (int)x0, iy = (int)y0, iz = (int)z0;
    const float u = vvr_fade(fx), v = vvr_fade(fy), w = vvr_fade(fz);
    const float n000 = vvr_dot_grad3(ix, iy, iz, 0, 0, 0, fx, fy, fz);
    const float n100 = vvr_dot_grad3(ix, iy, iz, 1, 0, 0, fx, fy, fz);
    const float n010 = vvr_dot_grad3(ix, iy, iz, 0, 1, 0, fx, fy, fz);
    const float n110 = vvr_dot_grad3(ix, iy, iz, 1, 1, 0, fx, fy, fz);
    const float n001 = vvr_dot_grad3(ix, iy, iz, 0, 0, 1, fx, fy, fz);
    const float n101 = vvr_dot_grad3(ix, iy, iz, 1, 0, 1, fx, fy, fz);
    const float n011 = vvr_dot_grad3(ix, iy, iz, 0, 1, 1, fx, fy, fz);
    const float n111 = vvr_dot_grad3(ix, iy, iz, 1, 1, 1, fx, fy, fz);
    const float nx00 = n000 + u * (n100 - n000);
    const float nx10 = n010 + u * (n110 - n010);
    const float nx01 = n001 + u * (n101 - n001);
    const float nx11 = n011 + u * (n111 - n011);
    const float nxy0 = nx00 + v * (nx10 - nx00);
    const float nxy1 = nx01 + v * (nx11 - nx01);
    return 1.1547f * (nxy0 + w * (nxy1 - nxy0));
}

// sample_density_trilinear (vvr_tpu/world/svt.py:26): texel centres at
// +0.5, clamp to edge, each tap's u8 over 255, along x, then y, then z
static __device__ __forceinline__ float vvr_density_trilinear(
        const uint8_t* __restrict__ dens, int s, float x, float y, float z) {
    const float px = x - 0.5f, py = y - 0.5f, pz = z - 0.5f;
    const float x0 = floorf(px), y0 = floorf(py), z0 = floorf(pz);
    const float fx = px - x0, fy = py - y0, fz = pz - z0;
    const int ix = (int)x0, iy = (int)y0, iz = (int)z0;
    const int xa = min(max(ix, 0), s - 1), xb = min(max(ix + 1, 0), s - 1);
    const int ya = min(max(iy, 0), s - 1), yb = min(max(iy + 1, 0), s - 1);
    const int za = min(max(iz, 0), s - 1), zb = min(max(iz + 1, 0), s - 1);
    auto tap = [&](int xx, int yy, int zz) {
        return (float)__ldg(dens + ((size_t)zz * s + yy) * s + xx) / 255.0f;
    };
    const float c00 = tap(xa, ya, za) * (1.0f - fx) + tap(xb, ya, za) * fx;
    const float c10 = tap(xa, yb, za) * (1.0f - fx) + tap(xb, yb, za) * fx;
    const float c01 = tap(xa, ya, zb) * (1.0f - fx) + tap(xb, ya, zb) * fx;
    const float c11 = tap(xa, yb, zb) * (1.0f - fx) + tap(xb, yb, zb) * fx;
    const float c0 = c00 * (1.0f - fy) + c10 * fy;
    const float c1 = c01 * (1.0f - fy) + c11 * fy;
    return c0 * (1.0f - fz) + c1 * fz;
}

template <class View, bool AO, bool LIGHTS, bool MIRROR, bool WAVY>
__global__ void __launch_bounds__(VVR_K15_BLOCK) vvr_shade_bounce_kernel(
        const VvrBounceArgs<View> A, const VvrLights L) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= A.n) return;
    const bool first = A.active_in == nullptr;
    if (!first && A.active_in[i] == 0) return;
    const float ox = A.o_in[3 * i], oy = A.o_in[3 * i + 1],
                oz = A.o_in[3 * i + 2];
    const float dx = A.d_in[3 * i], dy = A.d_in[3 * i + 1],
                dz = A.d_in[3 * i + 2];
    float kr = 1.0f, kg = 1.0f, kb = 1.0f;   // the lane's colour
    if (A.col_in != nullptr) {
        kr = A.col_in[3 * i];
        kg = A.col_in[3 * i + 1];
        kb = A.col_in[3 * i + 2];
    }
    const size_t n = (size_t)A.n;
    bool mirror = false;
    float r, g, b;
    if (A.hit[i] != 0) {
        const Surface s = vvr_reconstruct(ox, oy, oz, dx, dy, dz, A.face[i],
                                          A.axis_coord[i]);
        float ar = 1.0f, ag = 1.0f, ab = 1.0f;
        if (s.bx > A.grid.size / 2) {
            float c0, c1, c2;
            vvr_block_colour(s.bx, s.by, s.bz, &c0, &c1, &c2);
            ar = c0 + (1.0f - c0) * 0.5f;
            ag = c1 + (1.0f - c1) * 0.5f;
            ab = c2 + (1.0f - c2) * 0.5f;
        }
        if (MIRROR) {
            mirror = vvr_hash13(floorf((float)s.bx / 8.0f),
                                floorf((float)s.by / 8.0f),
                                floorf((float)s.bz / 8.0f)) > 0.8f;
        }
        if (mirror) {
            // the continuation: the reflected ray from just off the surface
            float nx = s.nx, ny = s.ny, nz = s.nz;
            if (WAVY) {
                const float sn = vvr_snoise3(s.wx * 0.85f + A.time,
                                             s.wy * 0.85f + A.time,
                                             s.wz * 0.85f + A.time) * 0.05f;
                nx = nx + sn;
                ny = ny + sn;
                nz = nz + sn;
                const float inv =
                    1.0f / fmaxf(sqrtf((nx * nx + ny * ny) + nz * nz),
                                 1e-12f);
                nx = nx * inv;
                ny = ny * inv;
                nz = nz * inv;
            }
            const float dd2 = 2.0f * ((dx * nx + dy * ny) + dz * nz);
            const float rx = dx - dd2 * nx, ry = dy - dd2 * ny,
                        rz = dz - dd2 * nz;
            A.o_out[3 * i] = s.wx + rx * 1e-3f;
            A.o_out[3 * i + 1] = s.wy + ry * 1e-3f;
            A.o_out[3 * i + 2] = s.wz + rz * 1e-3f;
            A.d_out[3 * i] = rx;
            A.d_out[3 * i + 1] = ry;
            A.d_out[3 * i + 2] = rz;
            A.col_out[3 * i] = kr * ar;
            A.col_out[3 * i + 1] = kg * ag;
            A.col_out[3 * i + 2] = kb * ab;
            A.active_out[i] = 1;
            if (first) {   // a mirror lane's output stays 0 until written
                A.out[i] = 0.0f;
                A.out[n + i] = 0.0f;
                A.out[2 * n + i] = 0.0f;
                A.out[3 * n + i] = 0.0f;
            }
            return;
        }
        // the shadow query point: the surface, floored to quarter voxels
        // with pixelated shadows
        Surface q = s;
        if (A.pixelated) vvr_pixelate(&q);
        float shadow = 1.0f;
        if (A.shadow_hit != nullptr) {
            const float4 cl = vvr_sample_clouds(A.clouds, A.cl_res, A.sx,
                                                A.sy, A.sz, q.wx, q.wy, q.wz);
            shadow = A.shadow_hit[i] != 0 ? 0.0f : 1.0f - cl.w;
        } else if (A.shadow_factor != nullptr) {
            shadow = A.shadow_factor[i];
        }
        float vis = 1.0f;
        if (AO) {
            float ao;
            if (A.density != nullptr) {
                // filtered: one voxel off the surface along the normal,
                // two on a negative axis
                ao = 1.0f - vvr_clamp(
                    vvr_density_trilinear(
                        A.density, A.grid.size,
                        s.wx + (s.nx < 0.0f ? -2.0f : s.nx),
                        s.wy + (s.ny < 0.0f ? -2.0f : s.ny),
                        s.wz + (s.nz < 0.0f ? -2.0f : s.nz)) * 0.5f,
                    0.0f, 1.0f);
            } else {
                // overlap (overlap.cuh) through the grid's voxels
                ao = vvr_overlap_ao(A.grid, s.wx, s.wy, s.wz, s.nx, s.ny,
                                    s.nz, A.face[i]);
            }
            vis = powf(ao, 1.4f);
        }
        float3 lit = vvr_lighting(ar, ag, ab, s.nx, s.ny, s.nz, -dx, -dy,
                                  -dz, A.sx, A.sy, A.sz, shadow, A.cr, A.cg,
                                  A.cb, vis);
        if (LIGHTS) {
            for (int li = 0; li < L.count; ++li) {
                const float lx = L.pos[li][0], ly = L.pos[li][1],
                            lz = L.pos[li][2];
                const float tx = q.wx - lx, ty = q.wy - ly, tz = q.wz - lz;
                const float dist = sqrtf((tx * tx + ty * ty) + tz * tz);
                if (!(dist < 10.0f)) continue;   // adds 0
                const float inv = 1.0f / fmaxf(dist, 1e-6f);
                const float ldx = tx * inv, ldy = ty * inv, ldz = tz * inv;
                const JumpHit h = A.grid.template trace<false>(
                    lx, ly, lz, ldx, ldy, ldz, true, A.max_steps);
                const bool unshadowed = (h.t + 0.1f) > dist;
                const float n_dot_l = vvr_clamp(
                    -((s.nx * ldx + s.ny * ldy) + s.nz * ldz), 0.0f, 1.0f);
                float sm = vvr_clamp(10.0f - dist, 0.0f, 1.0f);
                sm = sm * sm * (3.0f - 2.0f * sm);
                const float strength = sm / fmaxf(dist * dist, 1e-4f);
                const float add = (unshadowed ? 1.0f : 0.0f) * n_dot_l
                                  * strength;
                lit.x = lit.x + add * L.col[li][0];
                lit.y = lit.y + add * L.col[li][1];
                lit.z = lit.z + add * L.col[li][2];
            }
        }
        r = kr * lit.x;
        g = kg * lit.y;
        b = kb * lit.z;
        if (first) A.out[3 * n + i] = 0.0f;
    } else {
        // a miss: the skybox blended with the clouds along the ray
        const float4 cl = vvr_sample_clouds(A.clouds, A.cl_res, dx, dy, dz,
                                            ox, oy, oz);
        const float3 sb = vvr_sample_skybox(A.skybox, A.sky_res, dx, dy, dz);
        r = kr * (sb.x + (cl.x - sb.x) * cl.w);
        g = kg * (sb.y + (cl.y - sb.y) * cl.w);
        b = kb * (sb.z + (cl.z - sb.z) * cl.w);
        A.out[3 * n + i] = 10.0f;
    }
    A.out[i] = r;
    A.out[n + i] = g;
    A.out[2 * n + i] = b;
    // the lane ends here: only its flag is written (the later passes read
    // the rays of live lanes only)
    if (MIRROR) A.active_out[i] = 0;
}

template <class View, bool AO, bool LIGHTS>
static void vvr_launch_bounce(const VvrBounceArgs<View>& A,
                              const VvrLights& L, bool mirror, bool wavy,
                              cudaStream_t stream) {
    const unsigned blocks = vvr_blocks(A.n, VVR_K15_BLOCK);
    if (mirror && wavy) {
        vvr_shade_bounce_kernel<View, AO, LIGHTS, true, true>
            <<<blocks, VVR_K15_BLOCK, 0, stream>>>(A, L);
    } else if (mirror) {
        vvr_shade_bounce_kernel<View, AO, LIGHTS, true, false>
            <<<blocks, VVR_K15_BLOCK, 0, stream>>>(A, L);
    } else {
        vvr_shade_bounce_kernel<View, AO, LIGHTS, false, false>
            <<<blocks, VVR_K15_BLOCK, 0, stream>>>(A, L);
    }
}

// K15 over n lanes. col_in / active_in null: bounce 0 (every colour 1,
// every lane live; every lane's four output channels are written). density
// null: no AO. lights: n_lights (<= 10) rows of (x, y, z, r, g, b) floats
// in host memory, copied into the launch's parameters. mirror: the
// continuation is written to o_out, d_out, col_out, active_out: the
// mirror lanes' rays and colours and the live lanes' flags (every lane's
// at bounce 0); after bounce 0 the buffers are the bounce's own inputs;
// wavy only with mirror. overlap_ao: the AO is the overlap AO (with a null
// density). V: the grid's view (grid_view.cuh).
template <class View>
static int vvr_shade_bounce_launch(
        const View& V, const void* o_in, const void* d_in,
        const void* col_in, const void* active_in, const void* hit,
        const void* face, const void* axis_coord, const void* shadow_hit,
        const void* shadow_factor, int n, const void* skybox, int sky_res,
        const void* clouds, int cl_res, float sx, float sy, float sz,
        float cr, float cg, float cb, int pixelated, const void* density,
        int overlap_ao, const void* lights, int n_lights, int max_steps,
        int mirror,
        int wavy, float time, void* out, void* o_out, void* d_out,
        void* col_out, void* active_out, void* stream) {
    if (n_lights < 0 || n_lights > VVR_MAX_LIGHTS
        || (n_lights > 0 && lights == nullptr)
        || (mirror != 0 && (o_out == nullptr || d_out == nullptr
                            || col_out == nullptr || active_out == nullptr))
        || (wavy != 0 && mirror == 0)
        || (overlap_ao != 0 && density != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n <= 0) return (int)cudaGetLastError();
    VvrBounceArgs<View> A;
    A.grid = V;
    A.n = n;
    A.sky_res = sky_res;
    A.cl_res = cl_res;
    A.max_steps = max_steps;
    A.o_in = (const float*)o_in;
    A.d_in = (const float*)d_in;
    A.col_in = (const float*)col_in;
    A.active_in = (const uint8_t*)active_in;
    A.hit = (const uint8_t*)hit;
    A.face = (const int*)face;
    A.axis_coord = (const int*)axis_coord;
    A.shadow_hit = (const uint8_t*)shadow_hit;
    A.shadow_factor = (const float*)shadow_factor;
    A.skybox = (const float*)skybox;
    A.clouds = (const float*)clouds;
    A.density = (const uint8_t*)density;
    A.sx = sx;
    A.sy = sy;
    A.sz = sz;
    A.cr = cr;
    A.cg = cg;
    A.cb = cb;
    A.time = time;
    A.pixelated = pixelated != 0;
    A.out = (float*)out;
    A.o_out = (float*)o_out;
    A.d_out = (float*)d_out;
    A.col_out = (float*)col_out;
    A.active_out = (uint8_t*)active_out;
    VvrLights L;
    L.count = n_lights;
    const float* lf = (const float*)lights;
    for (int li = 0; li < VVR_MAX_LIGHTS; ++li) {
        for (int c = 0; c < 3; ++c) {
            L.pos[li][c] = li < n_lights ? lf[6 * li + c] : 0.0f;
            L.col[li][c] = li < n_lights ? lf[6 * li + 3 + c] : 0.0f;
        }
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const bool m = mirror != 0, w = wavy != 0;
    const bool ao = density != nullptr || overlap_ao != 0;
    if (ao && n_lights > 0) {
        vvr_launch_bounce<View, true, true>(A, L, m, w, st);
    } else if (ao) {
        vvr_launch_bounce<View, true, false>(A, L, m, w, st);
    } else if (n_lights > 0) {
        vvr_launch_bounce<View, false, true>(A, L, m, w, st);
    } else {
        vvr_launch_bounce<View, false, false>(A, L, m, w, st);
    }
    return (int)cudaGetLastError();
}

// K15 on the jump grid
extern "C" int vvr_shade_bounce(
        const void* rows, int size, const void* o_in, const void* d_in,
        const void* col_in, const void* active_in, const void* hit,
        const void* face, const void* axis_coord, const void* shadow_hit,
        const void* shadow_factor, int n, const void* skybox, int sky_res,
        const void* clouds, int cl_res, float sx, float sy, float sz,
        float cr, float cg, float cb, int pixelated, const void* density,
        int overlap_ao, const void* lights, int n_lights, int max_steps,
        int mirror,
        int wavy, float time, void* out, void* o_out, void* d_out,
        void* col_out, void* active_out, void* stream) {
    const VvrFlatView V = {(const uint32_t*)rows, size};
    return vvr_shade_bounce_launch(
        V, o_in, d_in, col_in, active_in, hit, face,
        axis_coord, shadow_hit, shadow_factor, n, skybox, sky_res, clouds,
        cl_res, sx, sy, sz, cr, cg, cb, pixelated, density, overlap_ao,
        lights, n_lights,
        max_steps, mirror, wavy, time, out, o_out, d_out, col_out,
        active_out, stream);
}

// K15 on the paged grid (its page table, pool, size and page edge)
extern "C" int vvr_shade_bounce_paged(
        const void* prows, const void* brows, int size, int psize,
        const void* o_in, const void* d_in,
        const void* col_in, const void* active_in, const void* hit,
        const void* face, const void* axis_coord, const void* shadow_hit,
        const void* shadow_factor, int n, const void* skybox, int sky_res,
        const void* clouds, int cl_res, float sx, float sy, float sz,
        float cr, float cg, float cb, int pixelated, const void* density,
        int overlap_ao, const void* lights, int n_lights, int max_steps,
        int mirror,
        int wavy, float time, void* out, void* o_out, void* d_out,
        void* col_out, void* active_out, void* stream) {
    const VvrPagedView V = {(const uint32_t*)prows, (const uint32_t*)brows,
                            size, psize};
    return vvr_shade_bounce_launch(
        V, o_in, d_in, col_in, active_in, hit, face,
        axis_coord, shadow_hit, shadow_factor, n, skybox, sky_res, clouds,
        cl_res, sx, sy, sz, cr, cg, cb, pixelated, density, overlap_ao,
        lights, n_lights,
        max_steps, mirror, wavy, time, out, o_out, d_out, col_out,
        active_out, stream);
}

// K15 on the brick pyramid (its rows, size and depth)
extern "C" int vvr_shade_bounce_pyramid(
        const void* rows, int size, int depth, const void* o_in,
        const void* d_in, const void* col_in, const void* active_in,
        const void* hit, const void* face, const void* axis_coord,
        const void* shadow_hit, const void* shadow_factor, int n,
        const void* skybox, int sky_res, const void* clouds, int cl_res,
        float sx, float sy, float sz, float cr, float cg, float cb,
        int pixelated, const void* density, int overlap_ao,
        const void* lights, int n_lights, int max_steps, int mirror,
        int wavy, float time, void* out,
        void* o_out, void* d_out, void* col_out, void* active_out,
        void* stream) {
    const VvrPyramidView V = {(const uint32_t*)rows, size, depth};
    return vvr_shade_bounce_launch(
        V, o_in, d_in, col_in, active_in, hit, face,
        axis_coord, shadow_hit, shadow_factor, n, skybox, sky_res, clouds,
        cl_res, sx, sy, sz, cr, cg, cb, pixelated, density, overlap_ao,
        lights, n_lights,
        max_steps, mirror, wavy, time, out, o_out, d_out, col_out,
        active_out, stream);
}
