// K11 sun_grids and K12 masked_shadow: the hard-shadow sun classifier.
// Replace vvr_tpu/ops/sunshadow.py:112 `build_sun_grids` (with cone_tan 0)
// and :654 `masked_shadow_hits` (ops/sunshadow.py wraps them).
//
// K11 builds, once per sun direction, two conservative depth grids over the
// world's projection along the sun s, from the anti-sun faces (the only
// faces a sun-bound ray can enter solid through): gridB, the max over faces
// that fully cover a texel (quad shrunk by SAFE, extended across internal v
// edges, FaceSet.einfo) of the face's affine min depth there, and gridC, the
// max over faces that may touch it (bbox grown by SAFE) of its affine max
// depth plus the growth margin. A per-face kernel computes each occluder's
// texel bbox and its count of 8x4-texel tiles, the counts go through an
// exclusive scan (items.cuh), and one warp per (face, tile) item evaluates
// its 32 texels (sunshadow.py:143-241, :340-442). Depths along s are
// negative over part of the world, so the float max goes through an
// order-preserving u32 map (negative floats bit-inverted) and atomicMax;
// the grids start at NEG = -3e38 and are decoded in place at the end,
// interleaved as gBC (G^2, 2).
//
// K12 answers one shadow lane per thread. On the frame's path it takes the
// primary hits and computes the lane's start (surface + 0.05 along the sun)
// and its mask (the face turns toward the sun) in registers with K2
// `shade_surface`'s own code (surface.cuh), so the starts never make the
// round trip through device memory and the frame launches one kernel
// fewer; `masked_shadow_hits` hands it the starts instead. It projects the
// start onto (e1, e2, s), reads one gBC row, then tests certain shadow
// (depth below B - SAFE) or certain light (surface depth above C + SAFE)
// (`_certain`, :525); an ambiguous lane walks its first 6 voxel crossings
// (`_near_segment`, :536) and re-tests light at the lifted depth (:739);
// only a lane still ambiguous runs the jump-grid DDA inline
// (jump_dda.cuh). A start whose own voxel is solid is a hit first, as in
// the DDA: the grids' light claim holds only for starts in empty space,
// and the JAX version's surface-depth margin does not cover a start buried
// deeper than 0.05 (a camera inside solid, whose primary hits sit at
// t = 0). The TPU design's two-stage pack of the ambiguous lanes, its
// lax.cond overflow net, the build's fixed entry capacity with its retry
// flag, and the coarse level cBC that no query reads are not ported.
//
// What bounds them on an H100: K11 is a scatter of about 8 B of atomics per
// covered texel into a 32 MiB table that sits in L2. K12 reads 33 B of
// primary hit per lane (o, d, hit, face, axis_coord) and writes 1 B, plus
// one 8 B gBC row and a brick word per lit lane; a lane of the residue
// (0.4% at the bench view) runs the DDA, which is latency-bound like K1 and
// keeps its CTA's slot for up to tens of microseconds. Appending the
// residue to a queue and draining it in full warps after a grid sync (one
// cooperative launch) was measured slower: the drain starts only when the
// last lane is classified, and its longest DDA then runs alone.
#include "items.cuh"
#include "jump_dda.cuh"
#include "surface.cuh"

#define VVR_SAFE 0.02f
#define VVR_NEG (-3e38f)
#define VVR_STX 8
#define VVR_STY 4
#define VVR_NEAR_K 6

struct VvrSunBasis {
    float e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz;
};

struct VvrSunFrame {  // the grid's placement: texel (i, j) starts at
    float a0, b0, ts;  // (a0 + i*ts, b0 + j*ts)
    int grid;
};

// per-face quantities of the hard-shadow build (cone_tan 0, so the
// cone's lowering of gridB is zero and is left out)
struct VvrSunFace {
    bool occl, deg;
    int oi0, oi1, oj0, oj1;
    float p0a, p0b, ua, ub, va, vb, inv_det;
    float z00, g_a, g_b, zmax, mu, mv, g_m, xv0, xv1;
};

static __device__ __forceinline__ int vvr_texel(float x, float lo, float ts,
                                                int grid) {
    return min(max(vvr_floor_int((x - lo) / ts), 0), grid - 1);
}

static __device__ VvrSunFace vvr_sun_face(const VvrFaces& F, int f,
                                          const VvrSunBasis& B,
                                          const VvrSunFrame& G) {
    VvrSunFace r;
    const int ax = __ldg(F.axis + f), sg = __ldg(F.sgn + f);
    const int eu = __ldg(F.eu + f), ev = __ldg(F.ev + f);
    const int vx = __ldg(F.vx + f), vy = __ldg(F.vy + f),
              vz = __ldg(F.vz + f), einfo = __ldg(F.einfo + f);
    const float s_a = ax == 0 ? B.sx : (ax == 1 ? B.sy : B.sz);
    r.occl = (sg == 1 ? s_a < 0.0f : s_a > 0.0f) && eu > 0;
    const float pc = (float)((ax == 0 ? vx : (ax == 1 ? vy : vz)) + sg);
    const float euf = (float)eu, evf = (float)ev;
    float ca[4], cb[4], cz[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // (du, dv) = (0,0), (0,1), (1,0), (1,1)
        const float du = (float)(k >> 1), dv = (float)(k & 1);
        const float x = ax == 0 ? pc : (float)vx + du * euf;
        const float y = ax == 1 ? pc
                                : (float)vy + (ax == 0 ? du * euf : dv * evf);
        const float z = ax == 2 ? pc : (float)vz + dv * evf;
        ca[k] = (x * B.e1x + y * B.e1y) + z * B.e1z;
        cb[k] = (x * B.e2x + y * B.e2y) + z * B.e2z;
        cz[k] = (x * B.sx + y * B.sy) + z * B.sz;
    }
    const float amin = fminf(fminf(ca[0], ca[1]), fminf(ca[2], ca[3]));
    const float amax = fmaxf(fmaxf(ca[0], ca[1]), fmaxf(ca[2], ca[3]));
    const float bmin = fminf(fminf(cb[0], cb[1]), fminf(cb[2], cb[3]));
    const float bmax = fmaxf(fmaxf(cb[0], cb[1]), fmaxf(cb[2], cb[3]));
    r.zmax = fmaxf(fmaxf(cz[0], cz[1]), fmaxf(cz[2], cz[3]));
    const float grow = VVR_SAFE;
    r.oi0 = vvr_texel(amin - grow, G.a0, G.ts, G.grid);
    r.oi1 = vvr_texel(amax + grow, G.a0, G.ts, G.grid);
    r.oj0 = vvr_texel(bmin - grow, G.b0, G.ts, G.grid);
    r.oj1 = vvr_texel(bmax + grow, G.b0, G.ts, G.grid);
    // half-plane form of the projected parallelogram: edges along
    // u = c2 - c0 and v = c1 - c0
    r.p0a = ca[0];
    r.p0b = cb[0];
    r.ua = ca[2] - r.p0a;
    r.ub = cb[2] - r.p0b;
    r.va = ca[1] - r.p0a;
    r.vb = cb[1] - r.p0b;
    const float det = r.ua * r.vb - r.ub * r.va;
    r.deg = fabsf(det) < 1e-12f;
    r.inv_det = r.deg ? 0.0f : 1.0f / det;
    const float adet = fmaxf(fabsf(det), 1e-12f);
    r.mu = grow * (sqrtf(r.va * r.va + r.vb * r.vb) / adet);
    r.mv = grow * (sqrtf(r.ua * r.ua + r.ub * r.ub) / adet);
    // affine depth z(a, b) = z00 + g_a (a - p0a) + g_b (b - p0b)
    r.z00 = cz[0];
    const float zu = cz[2] - r.z00, zv = cz[1] - r.z00;
    r.g_a = (r.vb * zu - r.ub * zv) * r.inv_det;
    r.g_b = (r.ua * zv - r.va * zu) * r.inv_det;
    r.g_m = grow * (fabsf(r.g_a) + fabsf(r.g_b));
    r.xv0 = (float)(einfo & 1) / evf;
    r.xv1 = (float)((einfo >> 1) & 1) / evf;
    return r;
}

// order-preserving float <-> u32 map for atomicMax on signed floats
static __device__ __forceinline__ unsigned vvr_ord(float x) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float vvr_unord(unsigned u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

static __global__ void vvr_sun_fill_kernel(unsigned* __restrict__ g,
                                           long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) g[i] = vvr_ord(VVR_NEG);
}

static __global__ void vvr_sun_decode_kernel(unsigned* __restrict__ g,
                                             long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) g[i] = __float_as_uint(vvr_unord(g[i]));
}

static __global__ void vvr_sun_count_kernel(VvrFaces F, VvrSunBasis B,
                                            VvrSunFrame G,
                                            long long* __restrict__ cnt) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F.n) return;
    const VvrSunFace s = vvr_sun_face(F, f, B, G);
    cnt[f] = s.occl ? (long long)((s.oi1 - s.oi0) / VVR_STX + 1)
                          * (long long)((s.oj1 - s.oj0) / VVR_STY + 1)
                    : 0;
}

static __global__ void vvr_sun_texel_kernel(
        VvrFaces F, VvrSunBasis B, VvrSunFrame G,
        const long long* __restrict__ off,
        const long long* __restrict__ total_p, unsigned* __restrict__ gbc) {
    const long long total = *total_p;
    const int lane = threadIdx.x & 31;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long item = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                          >> 5;
         item < total; item += nwarps) {
        const int f = vvr_item_face(off, F.n, item);
        const VvrSunFace s = vvr_sun_face(F, f, B, G);
        const long long li = item - off[f];
        const int tw = (s.oi1 - s.oi0) / VVR_STX + 1;
        const int i = s.oi0 + VVR_STX * (int)(li % tw) + (lane & 7);
        const int j = s.oj0 + VVR_STY * (int)(li / tw) + (lane >> 3);
        if (i > s.oi1 || j > s.oj1) continue;
        const float ta0 = G.a0 + (float)i * G.ts;
        const float tb0 = G.b0 + (float)j * G.ts;
        bool fully = !s.deg;
        float zc_min = 3e38f, zc_max = VVR_NEG;
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the texel's corners
            const float da = (ta0 + (float)(k >> 1) * G.ts) - s.p0a;
            const float db = (tb0 + (float)(k & 1) * G.ts) - s.p0b;
            const float uu = (da * s.vb - db * s.va) * s.inv_det;
            const float vv = (s.ua * db - s.ub * da) * s.inv_det;
            fully = fully && uu > s.mu && uu < 1.0f - s.mu
                    && vv > s.mv - s.xv0 && vv < 1.0f - s.mv + s.xv1;
            const float zc = (s.z00 + da * s.g_a) + db * s.g_b;
            zc_min = fminf(zc_min, zc);
            zc_max = fmaxf(zc_max, zc);
        }
        const long long tex = (long long)j * G.grid + i;
        // gridC: possibly touching -> affine max over the grown texel,
        // capped by the face's max; edge-on faces use the face's max
        const float zc_val = s.deg ? s.zmax : fminf(s.zmax, zc_max + s.g_m);
        atomicMax(gbc + 2 * tex + 1, vvr_ord(zc_val));
        // gridB: fully covered -> affine min over the texel, capped
        if (fully) atomicMax(gbc + 2 * tex, vvr_ord(fminf(zc_min, s.zmax)));
    }
}

extern "C" int vvr_sun_grids(
        const void* vx, const void* vy, const void* vz, const void* axis,
        const void* sgn, const void* eu, const void* ev, const void* einfo,
        int n_faces, float e1x, float e1y, float e1z, float e2x, float e2y,
        float e2z, float sx, float sy, float sz, float a0, float b0, float ts,
        int grid, void* scratch, void* gbc, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const VvrFaces F = {(const int*)vx, (const int*)vy, (const int*)vz,
                        (const int*)axis, (const int*)sgn, (const int*)eu,
                        (const int*)ev, (const int*)einfo, n_faces};
    const VvrSunBasis B = {e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz};
    const VvrSunFrame G = {a0, b0, ts, grid};
    // scratch: offsets (n_faces), block sums (ceil(n_faces/1024)), total
    long long* off = (long long*)scratch;
    long long* bsum = off + n_faces;
    long long* total = bsum + (n_faces + 1023) / 1024;
    const long long words = 2LL * grid * grid;
    vvr_sun_fill_kernel<<<vvr_blocks(words, 256), 256, 0, st>>>(
        (unsigned*)gbc, words);
    if (n_faces > 0) {
        vvr_sun_count_kernel<<<vvr_blocks(n_faces, 256), 256, 0, st>>>(
            F, B, G, off);
    }
    vvr_exclusive_scan(off, n_faces, bsum, total, st);
    vvr_sun_texel_kernel<<<vvr_item_blocks(), 256, 0, st>>>(
        F, B, G, off, total, (unsigned*)gbc);
    vvr_sun_decode_kernel<<<vvr_blocks(words, 256), 256, 0, st>>>(
        (unsigned*)gbc, words);
    return (int)cudaGetLastError();
}

// ---- K12

// first K voxel crossings from p along the sun (`_near_segment`): hit =
// entered solid; exited = left the world; t_end = entry parameter of the
// last cell tested empty
static __device__ void vvr_near_segment(const uint32_t* __restrict__ rows,
                                        int size, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, bool* hit, bool* exited,
                                        float* t_end) {
    const int g = size >> 3;
    const float big = 3e38f;
    const float ix = dx == 0.0f ? big : 1.0f / dx;
    const float iy = dy == 0.0f ? big : 1.0f / dy;
    const float iz = dz == 0.0f ? big : 1.0f / dz;
    const int px = dx > 0.0f, py = dy > 0.0f, pz = dz > 0.0f;
    int vx = vvr_floor_clip(ox, 0, size - 1);
    int vy = vvr_floor_clip(oy, 0, size - 1);
    int vz = vvr_floor_clip(oz, 0, size - 1);
    float t = 0.0f;
    *hit = false;
    *exited = false;
    *t_end = 0.0f;
    for (int k = 0; k < VVR_NEAR_K; ++k) {
        const uint32_t* row = rows
            + (size_t)((vx >> 3) + (vy >> 3) * g + (vz >> 3) * g * g) * 32;
        if (vvr_brick_solid(row, vx & 7, vy & 7, vz & 7)) {
            *hit = true;
            return;
        }
        *t_end = t;
        const int bx = vx + px, by = vy + py, bz = vz + pz;
        const float tx = dx == 0.0f ? big : ((float)bx - ox) * ix;
        const float ty = dy == 0.0f ? big : ((float)by - oy) * iy;
        const float tz = dz == 0.0f ? big : ((float)bz - oz) * iz;
        const float te = fminf(tx, fminf(ty, tz));
        const int nf = tz <= te ? 2 : (ty <= te ? 1 : 0);
        const int nvx = nf == 0 ? (px ? bx : bx - 1) : vx;
        const int nvy = nf == 1 ? (py ? by : by - 1) : vy;
        const int nvz = nf == 2 ? (pz ? bz : bz - 1) : vz;
        if (nvx < 0 || nvx >= size || nvy < 0 || nvy >= size || nvz < 0
            || nvz >= size) {
            *exited = true;
            return;
        }
        vx = nvx;
        vy = nvy;
        vz = nvz;
        t = te;
    }
}

// whether the voxel of an in-world start is solid (the DDA then hits at
// t = 0)
static __device__ __forceinline__ bool vvr_start_solid(
        const uint32_t* __restrict__ rows, int size, float ox, float oy,
        float oz) {
    const int g = size >> 3;
    const int vx = vvr_floor_clip(ox, 0, size - 1);
    const int vy = vvr_floor_clip(oy, 0, size - 1);
    const int vz = vvr_floor_clip(oz, 0, size - 1);
    return vvr_brick_solid(
        rows + (size_t)((vx >> 3) + (vy >> 3) * g + (vz >> 3) * g * g) * 32,
        vx & 7, vy & 7, vz & 7);
}

// The lanes' inputs: the shadow rays' starts and their mask
// (`masked_shadow_hits`), or, with s_o null, the primary hits they come
// from (the frame's entry), whose starts are computed here as K2
// `shade_surface` computes them (surface.cuh).
struct VvrShadowLanes {
    const float* s_o;
    const uint8_t* active;
    const float* o;
    const float* d;
    const uint8_t* hit;
    const int* face;
    const int* axis_coord;
};

// lane p's start; false for a lane that casts no shadow ray
static __device__ __forceinline__ bool vvr_lane_start(
        const VvrShadowLanes& L, int p, const VvrSunBasis& B, float* ox,
        float* oy, float* oz) {
    if (L.s_o != nullptr) {
        if (L.active[p] == 0) return false;
        *ox = L.s_o[3 * p];
        *oy = L.s_o[3 * p + 1];
        *oz = L.s_o[3 * p + 2];
        return true;
    }
    if (L.hit[p] == 0) return false;
    const Surface s = vvr_reconstruct(
        L.o[3 * p], L.o[3 * p + 1], L.o[3 * p + 2], L.d[3 * p],
        L.d[3 * p + 1], L.d[3 * p + 2], L.face[p], L.axis_coord[p]);
    const VvrShadowStart st = vvr_shadow_start(s, true, B.sx, B.sy, B.sz);
    *ox = st.x;
    *oy = st.y;
    *oz = st.z;
    return st.active;
}

#define VVR_K12_LIGHT 0
#define VVR_K12_SHADOW 1
#define VVR_K12_RESIDUE 2

// the answer for one start without the DDA, or VVR_K12_RESIDUE
static __device__ int vvr_classify_start(
        const uint32_t* __restrict__ rows, int size, float ox, float oy,
        float oz, const VvrSunBasis& B, const float2* __restrict__ gbc,
        const VvrSunFrame& G, float back) {
    const float fs = (float)size;
    const bool inw = ox >= 0.0f && ox < fs && oy >= 0.0f && oy < fs
                     && oz >= 0.0f && oz < fs;
    if (!inw) return VVR_K12_LIGHT;           // the DDA's origin-outside rule
    const float qa = (ox * B.e1x + oy * B.e1y) + oz * B.e1z;
    const float qb = (ox * B.e2x + oy * B.e2y) + oz * B.e2z;
    const float qz = (ox * B.sx + oy * B.sy) + oz * B.sz;
    const int i = vvr_floor_int((qa - G.a0) / G.ts);
    const int j = vvr_floor_int((qb - G.b0) / G.ts);
    const bool inb = i >= 0 && i < G.grid && j >= 0 && j < G.grid;
    const float2 row = gbc[inb ? (long long)j * G.grid + i : 0];
    if (vvr_start_solid(rows, size, ox, oy, oz)) {
        return VVR_K12_SHADOW;                // the DDA's start-in-solid hit
    }
    if (inb && qz < row.x - VVR_SAFE) return VVR_K12_SHADOW;  // certain
    if (inb && qz - back > row.y + VVR_SAFE) return VVR_K12_LIGHT;
    bool nh, nexit;
    float t_end;
    vvr_near_segment(rows, size, ox, oy, oz, B.sx, B.sy, B.sz, &nh, &nexit,
                     &t_end);
    if (nh) return VVR_K12_SHADOW;
    if (nexit || qz + t_end > row.y + VVR_SAFE) {
        return VVR_K12_LIGHT;                 // left the world, or lifted
    }
    return VVR_K12_RESIDUE;
}

// One thread per lane: its start (read, or computed from its primary
// hit), the tests above, and, for a residue lane, the jump-grid DDA inline.
static __global__ void __launch_bounds__(128)
vvr_masked_shadow_kernel(const uint32_t* __restrict__ rows, int size,
                         VvrShadowLanes L, int n, VvrSunBasis B,
                         const float2* __restrict__ gbc, VvrSunFrame G,
                         float back, int max_steps,
                         uint8_t* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    int r = VVR_K12_LIGHT;
    float ox, oy, oz;
    if (vvr_lane_start(L, p, B, &ox, &oy, &oz)) {
        r = vvr_classify_start(rows, size, ox, oy, oz, B, gbc, G, back);
        if (r == VVR_K12_RESIDUE) {
            r = vvr_jump_trace_ray<false>(rows, size, ox, oy, oz, B.sx,
                                          B.sy, B.sz, true, max_steps).hit
                    ? VVR_K12_SHADOW : VVR_K12_LIGHT;
        }
    }
    out[p] = (uint8_t)r;
}

// K12 over n lanes given as starts (s_o, active) or, with s_o null, as
// the primary hits (o, d, hit, face, axis_coord)
extern "C" int vvr_masked_shadow(
        const void* rows, int size, const void* s_o, const void* active,
        const void* o, const void* d, const void* hit, const void* face,
        const void* axis_coord, int n, float sx, float sy, float sz,
        float e1x, float e1y, float e1z, float e2x, float e2y, float e2z,
        const void* gbc, int grid, float a0, float b0, float ts, float back,
        int max_steps, void* out, void* stream) {
    const VvrShadowLanes L = {(const float*)s_o, (const uint8_t*)active,
                              (const float*)o, (const float*)d,
                              (const uint8_t*)hit, (const int*)face,
                              (const int*)axis_coord};
    const VvrSunBasis B = {e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz};
    const VvrSunFrame G = {a0, b0, ts, grid};
    if (n > 0) {
        vvr_masked_shadow_kernel<<<vvr_blocks(n, 128), 128, 0,
                                   (cudaStream_t)stream>>>(
            (const uint32_t*)rows, size, L, n, B, (const float2*)gbc, G,
            back, max_steps, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
