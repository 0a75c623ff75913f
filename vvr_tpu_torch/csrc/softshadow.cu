// K14 soft_shadow: soft and pixelated sun shadows from the primary hits
// (ops/softshadow.py wraps it). Replaces the soft branch of
// vvr_tpu/render/frame.py's bounce body (`shadow_samples > 1`, :308-464,
// with `soft_shadow_gate` and `near_walk_classify` of
// vvr_tpu/ops/sunshadow.py:771, :617) and the pixelated query point
// (:283-286). For each pixel:
//  1. its hit's surface (surface.cuh, as K2 and K12 reconstruct it) and,
//     with pixelated shadows, its floor to quarter voxels: the query p;
//  2. it traces only if its face turns toward the sun; with the cone grids
//     (gate mode) p's cone gBC row first answers every sample at once:
//     certain shadow (kh) or certain light (km);
//  3. per sample s: the jittered direction, the start p + sun * 0.004 +
//     d_s * 0.05, and the sample's hit: in gate mode the exact walk of its
//     first crossings (sunmask.cuh vvr_near_segment), a world exit or a
//     lift above p's cone gridC, then the jump-grid DDA of what is left
//     (jump_dda.cuh, K12's shadow semantics); in DDA mode the DDA of every
//     sample. On the paged grid (grid_view.cuh's paged view, the 1024^3
//     world) gate mode skips the walk, as the JAX frame does
//     (frame.py:388), and every DDA is K16's (paged_dda.cuh);
//  4. the factor: where(hit, 0, strength * (1 - cloud alpha along d_s)) / S
//     added in sample order (0 on a miss), and, if asked, each sample's
//     hit.
// The jitter rounds as the JAX package's jitted frame does (XLA's FMAs at
// the points ops/softshadow.py lists, here __fmaf_rn; the file is built
// with -fmad=false otherwise), so a sample's direction and start equal the
// plain version's bit for bit; its strength's powf may differ from the
// CPU's pow by an ulp or two. The TPU design's packed residue, its waves
// and its overflow net are not ported.
//
// What bounds it on an H100: per pixel 33 bytes of primary hit in and 4 out;
// per traced sample the near walk's and the DDA's chains of dependent row
// loads (latency-bound like K1), then per unshadowed sample its jitter,
// powf and one cloud texel (L2-resident): 92-98 us at the bench view in
// every mode with the traces removed (tools/k14_split.py). One
// thread running its pixel's samples in turn chained the traces of a pixel
// end to end, and a warp of 32 pixels waited each sample for its slowest
// lane. The design gives each warp an 8x4 pixel tile: a lane a pixel takes
// the surface, the facing test and the gate, then the pixels with samples
// to add (those that trace first) are ranked through the warp's ballots,
// and rounds of a lane per (pixel, sample) take them, 8 pixels x 4 samples
// a round at four samples (G = the samples rounded up to a power of two,
// at most 32, lanes a pixel; several sub-rounds above 32). A pixel's
// samples are nearly parallel (the jitter is +-0.005 about one sun), so
// their chains run side by side in one warp and their row loads fall on
// the same bricks, and the rounds hold the traced pixels together
// (tools/lane_use.py: lanes busy per trip 0.91 in DDA mode and 0.80 with
// the gate, against 0.73 and 0.44 for 32-pixel rows in turn). Each term
// is formed as the plain version forms it, (hit ? 0 : strength * (1 -
// cloud alpha)) / S, and the group's first lane adds its G terms
// (__shfl_down_sync) in sample order, so the factor keeps its bits. A
// pixel in certain shadow writes 0 with no jitter or cloud (0 + 0/S summed
// in order is +0.0), and a sample that hits skips its powf and cloud.
// Tried and dropped: 8x4 tiles with a thread's samples in turn (cheaper
// outside the trace, slower in it), and a lane per (pixel, sample) in
// every phase (each lane then repeats its pixel's surface and gate, which
// cost more than the trace gained); 64 and 256 threads a block and fewer
// registers a thread (__launch_bounds__ minimum blocks) measured equal.
#include "clouds.cuh"
#include "grid_view.cuh"
#include "sunmask.cuh"
#include "surface.cuh"

#define VVR_K14_BLOCK 128

template <class View>
struct VvrSoftArgs {
    View grid;               // grid_view.cuh: the jump or the paged grid
    int samples, max_steps, cl_res;
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

// sample s's jittered unit direction at p (`sample_dir`, frame.py:339-354),
// with XLA's contractions; its strength is vvr_sample_strength
static __device__ __forceinline__ void vvr_sample_dir(
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
}

// the sample's strength, pow(clamp(cos(angle to the sun), 0, 1), 40)
static __device__ __forceinline__ float vvr_sample_strength(
        float dx, float dy, float dz, float sx, float sy, float sz) {
    const float c = __fmaf_rn(dz, sz, __fmaf_rn(dx, sx, dy * sy));
    return powf(vvr_clamp(c, 0.0f, 1.0f), 40.0f);
}

// the hit of the sample ray from p along d: in gate mode on the jump grid
// its near walk (a hit, a world exit or a lift above p's cone gridC row_c
// answers it) and the DDA of what is left, else the grid's DDA (the JAX
// frame walks only the jump grid, vvr_tpu/render/frame.py:388)
template <class View>
static __device__ __forceinline__ bool vvr_sample_hit(
        const VvrSoftArgs<View>& A, float px, float py, float pz, float dx,
        float dy, float dz, float row_c) {
    const float ox = __fmaf_rn(dx, 0.05f, px + A.sx * 0.004f);
    const float oy = __fmaf_rn(dy, 0.05f, py + A.sy * 0.004f);
    const float oz = __fmaf_rn(dz, 0.05f, pz + A.sz * 0.004f);
    if constexpr (View::NEAR_WALK) {
        if (A.gbc != nullptr) {   // near_walk_classify
            const float fs = (float)A.grid.size;
            if (!(ox >= 0.0f && ox < fs && oy >= 0.0f && oy < fs
                  && oz >= 0.0f && oz < fs)) {
                return false;
            }
            bool nh, nexit;
            float t_end;
            vvr_near_segment(A.grid.rows, A.grid.size, ox, oy, oz, dx, dy,
                             dz, &nh, &nexit, &t_end);
            const float lift = ((ox * A.sx + oy * A.sy) + oz * A.sz)
                               + t_end * ((dx * A.sx + dy * A.sy)
                                          + dz * A.sz);
            if (nh || nexit || lift > row_c + VVR_SAFE) return nh;
        }
    }
    return A.grid.template trace<false>(ox, oy, oz, dx, dy, dz, true,
                                        A.max_steps).hit;
}

// lanes that serve one pixel in the sample rounds: the samples rounded up
// to a power of two, at most a warp (ops/softshadow.py soft_lanes)
static inline int vvr_soft_lanes(int samples) {
    int g = 1;
    while (g < samples && g < 32) g <<= 1;
    return g;
}

// A warp serves 32 pixels: with the image's width, the 8x4 tile w
// (row-major over the tiles), lane l its pixel in Z order (x from the bits
// 0, 2, 4 of l, y from the bits 1, 3), so that any aligned power-of-two run
// of lanes is a tile as square as it can be; with width 0 the pixels
// 32 w ... 32 w + 31 (ops/softshadow.py soft_pixels).
//  1. Each lane takes its pixel's surface, facing test and gate.
//  2. The pixels with samples to add are ranked, those that trace first,
//     in lane order, and their state goes to shared memory by rank.
//  3. Rounds of 32 lanes take (pixel, sample) items in rank order: P = 32 /
//     G pixels a round, lane k of a pixel's group of G samples k, k + G,
//     ... (sub-rounds when S > G). Each lane traces its item and forms its
//     term, where(hit, 0, strength * (1 - cloud alpha)) / S.
//  4. The group's first lane adds the group's terms (__shfl_down_sync) in
//     sample order and writes the pixel's factor.
// G is a template parameter (the launch picks it from the samples), so
// the rounds' index arithmetic and the adds unroll.
struct VvrSoftRank {   // a pixel with samples to add, by rank
    float px, py, pz, row_c;
    int p;          // the pixel, its traced flag in the sign bit
};

template <int G, class View>
__global__ void __launch_bounds__(VVR_K14_BLOCK)
vvr_soft_shadow_kernel(VvrSoftArgs<View> A, const float* __restrict__ o,
                       const float* __restrict__ d,
                       const uint8_t* __restrict__ hit,
                       const int* __restrict__ face,
                       const int* __restrict__ axis_coord, int n, int width,
                       float* __restrict__ factor,
                       uint8_t* __restrict__ hits) {
    __shared__ VvrSoftRank s_rank[VVR_K14_BLOCK];
    const int lane = threadIdx.x & 31, wb = threadIdx.x & ~31;
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    long long p;
    if (width > 0) {
        const int tiles_x = (width + 7) >> 3;
        const int x = (int)(warp % tiles_x) * 8 + ((lane & 1)
                      | ((lane >> 1) & 2) | ((lane >> 2) & 4));
        const long long y = warp / tiles_x * 4 + (((lane >> 1) & 1)
                                                 | ((lane >> 2) & 2));
        p = x < width ? y * width + x : n;
    } else {
        p = warp * 32 + lane;
    }
    // 1. the pixel
    const bool valid = p < n;
    const bool lit = valid && hit[p] != 0;
    float px = 0.0f, py = 0.0f, pz = 0.0f, row_c = 3e38f;
    bool kh = false, traced = false;
    if (lit) {
        Surface q = vvr_reconstruct(o[3 * p], o[3 * p + 1], o[3 * p + 2],
                                    d[3 * p], d[3 * p + 1], d[3 * p + 2],
                                    face[p], axis_coord[p]);
        if (A.pixelated) vvr_pixelate(&q);
        px = q.wx;
        py = q.wy;
        pz = q.wz;
        const bool active =
            ((q.nx * A.sx + q.ny * A.sy) + q.nz * A.sz) > 0.0f;
        bool km = false;
        if (A.gbc != nullptr) {   // the cone gate (soft_shadow_gate)
            const float fs = (float)A.grid.size;
            const bool inw = px >= 0.0f && px < fs && py >= 0.0f && py < fs
                             && pz >= 0.0f && pz < fs;
            const VvrSunRow r = vvr_sun_row(px, py, pz, A.B, A.gbc, A.G);
            const bool inb = inw && r.ing;
            kh = active && inb && r.qz + 0.06f < r.row.x - VVR_SAFE;
            km = active && !kh && ((inb && r.qz > r.row.y + VVR_SAFE) || !inw);
            if (r.ing) row_c = r.row.y;
        }
        traced = active && !kh && !km;
    }
    // a pixel with no samples to add: its factor 0 (a certain shadow's
    // 0 + 0/S in sample order is +0.0) and its hits
    const bool adds = lit && !kh;
    if (valid && !adds) {
        factor[p] = 0.0f;
        if (hits != nullptr) {
            for (int s = 0; s < A.samples; ++s) {
                hits[(size_t)s * n + p] = kh ? 1 : 0;
            }
        }
    }
    // 2. ranks: the pixels that trace, then those that only add terms
    const unsigned below = (1u << lane) - 1u;
    const unsigned t_mask = __ballot_sync(0xffffffffu, adds && traced);
    const unsigned u_mask = __ballot_sync(0xffffffffu, adds && !traced);
    const int n_t = __popc(t_mask), n_w = n_t + __popc(u_mask);
    const int rank = traced ? __popc(t_mask & below)
                            : n_t + __popc(u_mask & below);
    if (adds) {
        s_rank[wb + rank] = VvrSoftRank{
            px, py, pz, row_c, (int)p | (traced ? (int)0x80000000 : 0)};
    }
    __syncwarp();
    // 3. and 4. the rounds
    constexpr int P = 32 / G;
    const int slot = lane & (G - 1), grp = lane / G;
    for (int base = 0; base < n_w; base += P) {
        const int k = base + grp;
        const VvrSoftRank it = s_rank[wb + min(k, n_w - 1)];
        const bool it_traced = it.p < 0;
        const long long ip = it.p & 0x7FFFFFFF;
        float shadow = 0.0f;
        for (int s0 = 0; s0 < A.samples; s0 += G) {
            const int s = s0 + slot;
            float term = 0.0f;
            if (k < n_w && s < A.samples) {
                float dx, dy, dz;
                vvr_sample_dir(s, it.px, it.py, it.pz, A.sx, A.sy, A.sz, &dx,
                               &dy, &dz);
                const bool s_hit =
                    it_traced && vvr_sample_hit(A, it.px, it.py, it.pz, dx,
                                                dy, dz, it.row_c);
                if (hits != nullptr) hits[(size_t)s * n + ip] = s_hit ? 1 : 0;
                if (!s_hit) {
                    term = vvr_sample_strength(dx, dy, dz, A.sx, A.sy, A.sz)
                           * (1.0f - vvr_sample_clouds(A.clouds, A.cl_res,
                                                       dx, dy, dz, it.px,
                                                       it.py, it.pz).w);
                }
                term = term / (float)A.samples;
            }
            // the group's first lane adds its samples s0 .. s0 + G - 1
#pragma unroll
            for (int i = 0; i < G; ++i) {
                const float t = __shfl_down_sync(0xffffffffu, term, i);
                if (s0 + i < A.samples) shadow = shadow + t;
            }
        }
        if (k < n_w && slot == 0) factor[ip] = shadow;
    }
}

template <class View>
static int vvr_soft_shadow_launch(
        const View& V, const void* o, const void* d, const void* hit,
        const void* face, const void* axis_coord, int n, int width, float sx,
        float sy, float sz, int samples, int pixelated, const void* clouds,
        int cl_res, int max_steps, float e1x, float e1y, float e1z,
        float e2x, float e2y, float e2z, const void* gbc, int grid, float a0,
        float b0, float ts, void* factor, void* hits, void* stream) {
    if (samples < 1 || cl_res < 1 || width < 0
        || (gbc != nullptr && grid < 1)) {
        return (int)cudaErrorInvalidValue;
    }
    VvrSoftArgs<View> A;
    A.grid = V;
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
        const long long warps =
            width > 0 ? (long long)((width + 7) / 8)
                            * ((((long long)n + width - 1) / width + 3) / 4)
                      : ((long long)n + 31) / 32;
        const int g = vvr_soft_lanes(samples);
        auto kernel = g == 1    ? vvr_soft_shadow_kernel<1, View>
                      : g == 2  ? vvr_soft_shadow_kernel<2, View>
                      : g == 4  ? vvr_soft_shadow_kernel<4, View>
                      : g == 8  ? vvr_soft_shadow_kernel<8, View>
                      : g == 16 ? vvr_soft_shadow_kernel<16, View>
                                : vvr_soft_shadow_kernel<32, View>;
        kernel<<<vvr_blocks(warps * 32, VVR_K14_BLOCK), VVR_K14_BLOCK, 0,
                 (cudaStream_t)stream>>>(
            A, (const float*)o, (const float*)d, (const uint8_t*)hit,
            (const int*)face, (const int*)axis_coord, n, width,
            (float*)factor, (uint8_t*)hits);
    }
    return (int)cudaGetLastError();
}

// K14 on the jump grid
extern "C" int vvr_soft_shadow(
        const void* rows, int size, const void* o, const void* d,
        const void* hit, const void* face, const void* axis_coord, int n,
        int width, float sx, float sy, float sz, int samples, int pixelated,
        const void* clouds, int cl_res, int max_steps, float e1x, float e1y,
        float e1z, float e2x, float e2y, float e2z, const void* gbc,
        int grid, float a0, float b0, float ts, void* factor, void* hits,
        void* stream) {
    const VvrFlatView V = {(const uint32_t*)rows, size};
    return vvr_soft_shadow_launch(V, o, d, hit, face, axis_coord, n, width,
                                  sx, sy, sz, samples, pixelated, clouds,
                                  cl_res, max_steps, e1x, e1y, e1z, e2x, e2y,
                                  e2z, gbc, grid, a0, b0, ts, factor, hits,
                                  stream);
}

// K14 on the paged grid (its page table, pool, size and page edge)
extern "C" int vvr_soft_shadow_paged(
        const void* prows, const void* brows, int size, int psize,
        const void* o, const void* d, const void* hit, const void* face,
        const void* axis_coord, int n, int width, float sx, float sy,
        float sz, int samples, int pixelated, const void* clouds, int cl_res,
        int max_steps, float e1x, float e1y, float e1z, float e2x, float e2y,
        float e2z, const void* gbc, int grid, float a0, float b0, float ts,
        void* factor, void* hits, void* stream) {
    const VvrPagedView V = {(const uint32_t*)prows, (const uint32_t*)brows,
                            size, psize};
    return vvr_soft_shadow_launch(V, o, d, hit, face, axis_coord, n, width,
                                  sx, sy, sz, samples, pixelated, clouds,
                                  cl_res, max_steps, e1x, e1y, e1z, e2x, e2y,
                                  e2z, gbc, grid, a0, b0, ts, factor, hits,
                                  stream);
}

// K14 on the brick pyramid (its rows, size and depth; the any-only HDDA)
extern "C" int vvr_soft_shadow_pyramid(
        const void* rows, int size, int depth, const void* o, const void* d,
        const void* hit, const void* face, const void* axis_coord, int n,
        int width, float sx, float sy, float sz, int samples, int pixelated,
        const void* clouds, int cl_res, int max_steps, float e1x, float e1y,
        float e1z, float e2x, float e2y, float e2z, const void* gbc,
        int grid, float a0, float b0, float ts, void* factor, void* hits,
        void* stream) {
    const VvrPyramidView V = {(const uint32_t*)rows, size, depth};
    return vvr_soft_shadow_launch(V, o, d, hit, face, axis_coord, n, width,
                                  sx, sy, sz, samples, pixelated, clouds,
                                  cl_res, max_steps, e1x, e1y, e1z, e2x, e2y,
                                  e2z, gbc, grid, a0, b0, ts, factor, hits,
                                  stream);
}
