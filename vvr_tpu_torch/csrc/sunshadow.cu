// K11 sun_grids, K12 masked_shadow and K18 invalidate_texels: the sun
// classifier. Replace vvr_tpu/ops/sunshadow.py:112 `build_sun_grids` (with
// cone_tan 0, and with cone_tan > 0 for soft shadows), :654
// `masked_shadow_hits` and :460 `invalidate_sun_texels` (ops/sunshadow.py
// wraps them; K18 is at the end of the file).
//
// K11 builds, once per sun direction (every frame while the sun is
// dragged, at 512^2), two conservative depth grids over the world's
// projection along the sun s, from the anti-sun faces (the only faces a
// sun-bound ray can enter solid through): gridB, the max over faces that
// fully cover a texel (quad shrunk by SAFE, extended across internal v
// edges, FaceSet.einfo) of the face's affine min depth there, and gridC,
// the max over faces that may touch it (bbox grown by SAFE) of its affine
// max depth plus the growth margin (sunshadow.py:143-241, :340-442),
// interleaved as gBC (G^2, 2). One C entry point, five kernels, no atomic
// on device memory:
//  1. setup, one thread per face: vvr_sun_face once, into the face's texel
//     box and, for an occluder, the 64-byte record its texel test reads;
//     each block counts in shared memory its faces' entries per list. A
//     face goes on each bin (a square of bin_side texels) its box spans,
//     or, past VVR_SUN_BIN_MAX bins, on each coarse bin (VVR_SUN_COARSE
//     bins a side) it spans, or, past that, on the global list that every
//     tile reads.
//  2. a scan of the counts, list-major (items.cuh, two launches), gives
//     each (list, block) its place: each list is contiguous;
//  3. bin, the same blocks over the same faces: each entry (face, box) at
//     its block's place plus a slot taken with a shared-memory atomic (the
//     order within a list is free: the grids are maxima); one more block
//     orders the bins for the tile CTAs, those whose tiles read the most
//     entries first, so the busiest tiles start in the first wave;
//  4. tile, one CTA per tile of texels, which it owns in shared memory:
//     it starts every texel at NEG, stages the entries of its bin, coarse
//     bin and the global list whose boxes meet the tile, flattens their
//     (face, texel) pairs over the CTA (a CTA scan), evaluates each
//     thread's equal run of them with shared-memory atomicMax on each
//     pair's two values, then writes each texel once, coalesced, including
//     those no face touched.
// The cone grids of soft shadows (cone_tan > 0) take two passes in the
// same entry point. First the support grid S (cs x cs coarse texels, cs =
// min(256, grid)): each face of the set, occluder or not, with its box
// grown by S_PAD, takes the least of its affine depth at a coarse texel's
// corners (held at or above its least depth); one thread sets up one face,
// the block flattens its faces' (face, coarse texel) pairs and SLICES
// blocks of the same faces share them, an atomicMin per pair on the
// order-mapped u32 in S, which a memset starts at all ones (no face). S is
// 256 KB and stays in L2, and a least value does not depend on the order
// the faces arrive in, so S keeps its bytes; the no-atomic rule holds for
// the 32 MiB grids. Then the cone build, whose tile threads grow each
// (face, texel) pair's margins by the cone's reach above that texel's S
// (sunshadow.py:243-320, :373-441), staged per tile in shared memory. Its
// setup takes each occluder's tight box (vvr_sun_tight_box): where the box
// grown by the reach above the world's least depth spans at most
// VVR_SUN_TIGHT_SPAN coarse texels, the least S over them, S_lo, gives the
// largest margin any of its texels can take, and the box is cut to the
// texels whose test can pass at that margin. Every texel dropped fails its
// test at its own margin, and the grids are maxima over the pairs that
// pass, so they keep the loose boxes' bytes with fewer pairs. The bbox
// grown by that margin would not do: a skewed parallelogram grown by a
// distance g reaches past its bbox grown by g at its acute corners, and the
// test compares the texel's (u, v) interval, not its corner points (on the
// 64^3 world that bbox misses pairs that mark the grids,
// tests/test_torch_sunshadow.py).
// Depths along s are negative over part of the world, so the float max goes
// through an order-preserving u32 map (negative floats bit-inverted): a
// total order on bits, so the grids do not depend on the order in which
// faces are taken, and each (face, texel) value keeps the expressions of
// the per-texel build it replaces, bit for bit (-fmad=false). No capacity
// can overflow: a face takes at most VVR_SUN_BIN_MAX + 1 list entries and
// the wrapper sizes the scratch from the face count and the grid alone,
// reading nothing back. The JAX build's fixed entry capacity, its
// overflow flag and retry and the coarse level cBC that no query reads
// are not ported.
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
// (jump_dda.cuh). On the paged grid (the 1024^3 world) the same kernel
// body takes grid_view.cuh's paged view: no near walk, as the JAX frame
// skips it there (vvr_tpu/render/frame.py:475), and the residue runs
// K16's DDA (paged_dda.cuh). A start whose own voxel is solid is a hit
// first, as in the DDA: the grids' light claim holds only for starts in empty space,
// and the JAX version's surface-depth margin does not cover a start buried
// deeper than 0.05 (a camera inside solid, whose primary hits sit at
// t = 0). The TPU design's two-stage pack of the ambiguous lanes, its
// lax.cond overflow net, the build's fixed entry capacity with its retry
// flag, and the coarse level cBC that no query reads are not ported.
//
// What bounds them on an H100: K11 must write its G^2 x 8 B table once
// (32 MiB at 2048^2) and evaluate each (face, texel) pair (about 90
// operations, 3.76 million pairs at 2048^2 on the bench world), but its
// time goes to the tile CTAs' chains of dependent loads (job, entries,
// records) and to the busiest tiles (up to 17,000 pairs in one 32^2
// tile), which run for most of the kernel even when they start first;
// the hard build's setup, scan and bin launches cost about a third. The
// cone build's busiest 32^2 tiles hold 28-35 times the mean tile's pairs
// (tools/profile_frame.py), so it takes 16^2 tiles at every size
// (sun_tiling); its S stays in L2, where the support pass's own binned
// build (setup, scans, bin, tiles) cost about 51-54 us at 512^2 and 2048^2
// alike. Tried and dropped: a warp flattening its 32 faces' support pairs
// (the largest face's pairs then ran in one warp), and cutting each row of
// a tight box to the texels the test can reach (each CTA computed the cut
// of every row of every staged face, more than the pairs it saved). K12
// reads 33 B of primary hit per lane (o, d, hit, face, axis_coord) and
// writes 1 B, plus one 8 B gBC row and a brick word per lit lane; a lane
// of the residue (0.4% at the bench view) runs the DDA, which is
// latency-bound like K1 and keeps its CTA's slot for up to tens of
// microseconds. Appending the
// residue to a queue and draining it in full warps after a grid sync (one
// cooperative launch) was measured slower: the drain starts only when the
// last lane is classified, and its longest DDA then runs alone.
#include "grid_view.cuh"
#include "items.cuh"
#include "sunmask.cuh"
#include "surface.cuh"

#include <algorithm>
#include <numeric>
#include <vector>

#define VVR_NEG (-3e38f)
// K11 (ops/sunshadow.py SUN_FPB, SUN_MAX_BINS, SUN_COARSE, SUN_BIN_MAX):
// faces per block (one a thread) of its setup and bin kernels; the most
// bins; bins a side of a coarse bin; the most lists (the bins, the coarse
// bins, at most 4 x 4 when the bins are at most 32 x 32, and the global
// list); the most bins, or coarse bins, a face's entries span; threads of
// a tile's CTA
#define VVR_SUN_FPB 1024
#define VVR_SUN_MAX_BINS 1024
#define VVR_SUN_COARSE 8
#define VVR_SUN_MAX_LISTS (VVR_SUN_MAX_BINS + 16 + 1)
#define VVR_SUN_BIN_MAX 16
#define VVR_SUN_TILE_THREADS 256
// the cone build's setup takes an occluder's least support depth over at
// most this many coarse texels (ops/sunshadow.py TIGHT_SPAN); threads of a
// block of the support pass
#define VVR_SUN_TIGHT_SPAN 64
#define VVR_SUN_SUPPORT_THREADS 512
#define VVR_SUN_SUPPORT_SLICES 8

// What a face's setup computes: the hard-shadow grids' quantities, the
// cone grids' (cone_tan > 0, their margins grown per texel from the
// support grid S), or those of S itself (the least surface depth per
// coarse texel, build_sun_grids :243-320)
#define VVR_SUN_HARD 0
#define VVR_SUN_CONE 1
#define VVR_SUN_SUPPORT 2
#define VVR_S_PAD 0.5f
#define VVR_S_SLACK 0.5f

struct VvrSunMode {
    int mode;
    float cone_tan, wzmin;   // the cone's tan, the world's least depth
    const unsigned* S;       // the support grid (cone), cs x cs, order-mapped
    int cs, bfc;             // its side, and fine texels a side of each
};

// per-face quantities of the build
struct VvrSunFace {
    bool occl, deg;
    int oi0, oi1, oj0, oj1;
    float p0a, p0b, ua, ub, va, vb, inv_det;
    float z00, g_a, g_b, zmin, zmax, mu, mv, g_m, xv0, xv1, rmu, rmv, gsum;
};

static __device__ __forceinline__ int vvr_texel(float x, float lo, float ts,
                                                int grid) {
    return min(max(vvr_floor_int((x - lo) / ts), 0), grid - 1);
}

// the rest is computed for an occluder only, or for every face of the
// support pass (whose frame G is the coarse grid's and whose box grows by
// S_PAD); the hard build's box grows by SAFE, the cone build's by SAFE
// plus the cone's reach above the world's least depth
static __device__ VvrSunFace vvr_sun_face(const VvrFaces& F, int f,
                                          const VvrSunBasis& B,
                                          const VvrSunFrame& G,
                                          const VvrSunMode& M) {
    VvrSunFace r;
    const int ax = __ldg(F.axis + f), sg = __ldg(F.sgn + f);
    const int eu = __ldg(F.eu + f), ev = __ldg(F.ev + f);
    const int vx = __ldg(F.vx + f), vy = __ldg(F.vy + f),
              vz = __ldg(F.vz + f), einfo = __ldg(F.einfo + f);
    const float s_a = ax == 0 ? B.sx : (ax == 1 ? B.sy : B.sz);
    r.occl = (sg == 1 ? s_a < 0.0f : s_a > 0.0f) && eu > 0;
    if (!r.occl && M.mode != VVR_SUN_SUPPORT) return r;
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
    r.zmin = fminf(fminf(cz[0], cz[1]), fminf(cz[2], cz[3]));
    r.zmax = fmaxf(fmaxf(cz[0], cz[1]), fmaxf(cz[2], cz[3]));
    const float grow =
        M.mode == VVR_SUN_SUPPORT ? VVR_S_PAD
        : M.mode == VVR_SUN_CONE
            ? VVR_SAFE + M.cone_tan * fmaxf((r.zmax - M.wzmin) + VVR_S_SLACK,
                                            0.0f)
            : VVR_SAFE;
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
    r.rmu = sqrtf(r.va * r.va + r.vb * r.vb) / adet;
    r.rmv = sqrtf(r.ua * r.ua + r.ub * r.ub) / adet;
    r.mu = grow * r.rmu;
    r.mv = grow * r.rmv;
    // affine depth z(a, b) = z00 + g_a (a - p0a) + g_b (b - p0b)
    r.z00 = cz[0];
    const float zu = cz[2] - r.z00, zv = cz[1] - r.z00;
    r.g_a = (r.vb * zu - r.ub * zv) * r.inv_det;
    r.g_b = (r.ua * zv - r.va * zu) * r.inv_det;
    r.gsum = fabsf(r.g_a) + fabsf(r.g_b);
    r.g_m = grow * r.gsum;
    r.xv0 = (float)(einfo & 1) / evf;
    r.xv1 = (float)((einfo >> 1) & 1) / evf;
    return r;
}

// order-preserving float <-> u32 map for the max on signed floats
static __device__ __forceinline__ unsigned vvr_ord(float x) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float vvr_unord(unsigned u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// coarse texel k of the support grid: 3e38 where no face reached (the
// memset's all ones, above every mapped depth)
static __device__ __forceinline__ float vvr_support_at(
        const unsigned* __restrict__ S, int k) {
    const unsigned u = __ldg(S + k);
    return u == 0xFFFFFFFFu ? 3e38f : vvr_unord(u);
}

// The cone build's box of an occluder (ops/sunshadow.py cone_boxes_plain,
// the same expressions in the same order): its present box, grown by the
// cone's reach above the world's least depth, cut to the texels whose test
// can pass at the margin grown from S_lo, the least S over the coarse
// texels that box spans; the present box for an edge-on face or one that
// spans more than VVR_SUN_TIGHT_SPAN coarse texels.
static __device__ int4 vvr_sun_tight_box(const VvrSunFace& s,
                                         const VvrSunFrame& G,
                                         const VvrSunMode& M) {
    const int4 box = make_int4(s.oi0, s.oi1, s.oj0, s.oj1);
    const int ci0 = min(s.oi0 / M.bfc, M.cs - 1);
    const int ci1 = min(s.oi1 / M.bfc, M.cs - 1);
    const int cj0 = min(s.oj0 / M.bfc, M.cs - 1);
    const int cj1 = min(s.oj1 / M.bfc, M.cs - 1);
    if (s.deg || (ci1 - ci0 + 1) * (cj1 - cj0 + 1) > VVR_SUN_TIGHT_SPAN) {
        return box;
    }
    float s_lo = 3e38f;
    for (int cj = cj0; cj <= cj1; ++cj) {
        for (int ci = ci0; ci <= ci1; ++ci) {
            s_lo = fminf(s_lo, vvr_support_at(M.S, cj * M.cs + ci));
        }
    }
    const float grow =
        VVR_SAFE + M.cone_tan * fmaxf(s.zmax - (s_lo - VVR_S_SLACK), 0.0f);
    // the corner (i, j) of a texel whose test passes lies, in (u, v), in
    // the quad grown by the margin, by the texel's own (u, v) extent
    // (hu, hv) and, for gridB, across the internal v edges
    const float inv = fabsf(s.inv_det);
    const float hu = (G.ts * (fabsf(s.va) + fabsf(s.vb))) * inv;
    const float hv = (G.ts * (fabsf(s.ua) + fabsf(s.ub))) * inv;
    const float mu = grow * s.rmu, mv = grow * s.rmv;
    const float u_lo = -(mu + hu), u_hi = (1.0f + mu) + hu;
    const float v_lo = -((mv + s.xv0) + hv);
    const float v_hi = ((1.0f + mv) + s.xv1) + hv;
    const float a_lo = (s.p0a + fminf(u_lo * s.ua, u_hi * s.ua))
                       + fminf(v_lo * s.va, v_hi * s.va);
    const float a_hi = (s.p0a + fmaxf(u_lo * s.ua, u_hi * s.ua))
                       + fmaxf(v_lo * s.va, v_hi * s.va);
    const float b_lo = (s.p0b + fminf(u_lo * s.ub, u_hi * s.ub))
                       + fminf(v_lo * s.vb, v_hi * s.vb);
    const float b_hi = (s.p0b + fmaxf(u_lo * s.ub, u_hi * s.ub))
                       + fmaxf(v_lo * s.vb, v_hi * s.vb);
    const int4 t =
        make_int4(max(box.x, vvr_floor_int((a_lo - G.a0) / G.ts) - 1),
                  min(box.y, vvr_floor_int((a_hi - G.a0) / G.ts) + 1),
                  max(box.z, vvr_floor_int((b_lo - G.b0) / G.ts) - 1),
                  min(box.w, vvr_floor_int((b_hi - G.b0) / G.ts) + 1));
    return t.x > t.y || t.z > t.w ? make_int4(0, -1, 0, -1) : t;
}

// The face lists: n_bins bins, squares of bin_side texels (bins_x a side),
// then the coarse bins, squares of VVR_SUN_COARSE bins (coarse_x a side),
// then the global list that every tile reads
struct VvrSunLists {
    int bin_side, bins_x, n_bins, coarse_x;
};

static __device__ __forceinline__ int vvr_sun_n_lists(const VvrSunLists& L) {
    return L.n_bins + L.coarse_x * L.coarse_x + 1;
}

// A face's entries: none for an empty box; else one on each bin its box
// spans, if at most VVR_SUN_BIN_MAX; else one on each coarse bin, if at
// most VVR_SUN_BIN_MAX; else one on the global list. Entry k = kx + ky * w
// goes on list base + ky * stride + kx.
struct VvrSunEntries {
    int base, stride, w, n;
};

static __device__ VvrSunEntries vvr_sun_entries(int4 box,
                                                const VvrSunLists& L) {
    VvrSunEntries r = {0, 0, 1, 0};
    if (box.x > box.y) return r;
    for (int level = 0; level < 2; ++level) {
        const int side = level == 0 ? L.bin_side
                                    : L.bin_side * VVR_SUN_COARSE;
        const int x0 = box.x / side, y0 = box.z / side;
        const int w = box.y / side - x0 + 1;
        const int n = w * (box.w / side - y0 + 1);
        if (n <= VVR_SUN_BIN_MAX) {
            const int stride = level == 0 ? L.bins_x : L.coarse_x;
            r.base = (level == 0 ? 0 : L.n_bins) + y0 * stride + x0;
            r.stride = stride;
            r.w = w;
            r.n = n;
            return r;
        }
    }
    r.base = vvr_sun_n_lists(L) - 1;
    r.n = 1;
    return r;
}

// The place of (list k, block b) in the lists: the scan's partial sum at
// k * nb + b plus its block's carry (vvr_scan_partial)
static __device__ __forceinline__ long long vvr_sun_place(
        const long long* __restrict__ cnt, const long long* __restrict__ bsum,
        long long i) {
    return cnt[i] + bsum[i >> 10];
}

// Per face f: its texel box boxes[f] = (oi0, oi1, oj0, oj1) (in the cone
// build the tight box), empty (0, -1, 0, -1) for a face that occludes
// nothing, and recs[4f..4f+3], the 16 floats of its texel test: in the
// hard build with the comparisons' bounds 1 - mu, mv - xv0 and
// 1 - mv + xv1 formed as the texel test formed them; in the cone build
// with the margins' factors rmu, rmv and gsum instead, the margins being
// formed per texel. Per block: cnt[k * nb + block], its faces' entries in
// list k (VvrSunLists); a warp adds once per list its lanes share
// (neighbouring faces lie close together).
static __global__ void __launch_bounds__(VVR_SUN_FPB)
vvr_sun_setup_kernel(VvrFaces F, VvrSunBasis B, VvrSunFrame G, VvrSunLists L,
                     VvrSunMode M, int nb, int4* __restrict__ boxes,
                     float4* __restrict__ recs, long long* __restrict__ cnt) {
    __shared__ unsigned s_cnt[VVR_SUN_MAX_LISTS];
    const int n_lists = vvr_sun_n_lists(L);
    for (int k = threadIdx.x; k < n_lists; k += blockDim.x) s_cnt[k] = 0;
    __syncthreads();
    const int f = blockIdx.x * VVR_SUN_FPB + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int4 box = make_int4(0, -1, 0, -1);
    if (f < F.n) {
        const VvrSunFace s = vvr_sun_face(F, f, B, G, M);
        float4* r = recs + 4 * (size_t)f;
        if (s.occl) {
            r[0] = make_float4(s.p0a, s.p0b, s.ua, s.ub);
            if (M.mode == VVR_SUN_CONE) {
                box = vvr_sun_tight_box(s, G, M);
                r[1] = make_float4(s.va, s.vb, s.inv_det, s.rmu);
                r[2] = make_float4(s.rmv, s.xv0, s.xv1, s.z00);
                r[3] = make_float4(s.g_a, s.g_b, s.zmax, s.gsum);
            } else {
                box = make_int4(s.oi0, s.oi1, s.oj0, s.oj1);
                r[1] = make_float4(s.va, s.vb, s.inv_det, s.mu);
                r[2] = make_float4(1.0f - s.mu, s.mv - s.xv0,
                                   1.0f - s.mv + s.xv1, s.z00);
                r[3] = make_float4(s.g_a, s.g_b, s.zmax, s.g_m);
            }
        }
        boxes[f] = box;
    }
    const VvrSunEntries en = vvr_sun_entries(box, L);
    const int n_max = __reduce_max_sync(0xffffffffu, en.n);
    for (int k = 0, kx = 0, ky = 0; k < n_max; ++k) {
        const int l = k < en.n ? en.base + ky * en.stride + kx : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, l);
        if (l >= 0 && lane == __ffs(peers) - 1) {
            atomicAdd(s_cnt + l, (unsigned)__popc(peers));
        }
        if (++kx == en.w) {
            kx = 0;
            ++ky;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_lists; k += blockDim.x) {
        cnt[(long long)k * nb + blockIdx.x] = s_cnt[k];
    }
}

// The bins in the order their tiles' CTAs start: for each, two int4, (bin,
// its list's place, its length, its coarse bin's list's place) and (that
// one's length, the global list's place, its length, 0), by the number of
// entries their tiles read, most first (in classes of equal bit length;
// within a class in any order, as the grids do not depend on it), so the
// busiest tiles start in the first wave rather than the last. One thread
// per bin finds its place, with one shared-memory atomic per warp and
// class; the jobs are then written in order, coalesced.
static __device__ void vvr_sun_order(const VvrSunLists& L, int nb,
                                     const long long* __restrict__ cnt,
                                     const long long* __restrict__ bsum,
                                     const long long* __restrict__ total,
                                     int4* __restrict__ jobs) {
    __shared__ int s_lo[VVR_SUN_MAX_LISTS], s_len[VVR_SUN_MAX_LISTS];
    __shared__ unsigned s_n[33];   // bins per class, then each one's place
    __shared__ short s_ord[VVR_SUN_MAX_BINS];   // the bins in order
    const int n_lists = vvr_sun_n_lists(L);
    for (int k = threadIdx.x; k < n_lists; k += blockDim.x) {
        const long long lo = vvr_sun_place(cnt, bsum, (long long)k * nb);
        s_lo[k] = (int)lo;
        const long long hi =
            k + 1 < n_lists
                ? vvr_sun_place(cnt, bsum, (long long)(k + 1) * nb)
                : *total;
        s_len[k] = (int)(hi - lo);
    }
    if (threadIdx.x < 33) s_n[threadIdx.x] = 0;
    __syncthreads();
    const int g = n_lists - 1, lane = threadIdx.x & 31;
    for (int pass = 0; pass < 2; ++pass) {
        // whole warps, so that a warp takes one slot per class it holds
        for (int b0 = threadIdx.x & ~31; b0 < L.n_bins; b0 += blockDim.x) {
            const int bin = b0 + lane;
            const int bx = bin % L.bins_x, by = bin / L.bins_x;
            const int cb = L.n_bins + by / VVR_SUN_COARSE * L.coarse_x
                           + bx / VVR_SUN_COARSE;
            const int c = bin < L.n_bins
                              ? __clz(s_len[bin] + s_len[cb] + s_len[g])
                              : -1;
            const unsigned peers = __match_any_sync(0xffffffffu, c);
            const int leader = __ffs(peers) - 1;
            unsigned i = 0;
            if (c >= 0 && lane == leader) {
                i = atomicAdd(s_n + c, (unsigned)__popc(peers));
            }
            i = __shfl_sync(0xffffffffu, i, leader)
                + __popc(peers & ((1u << lane) - 1u));
            if (pass == 1 && c >= 0) s_ord[i] = (short)bin;
        }
        __syncthreads();
        if (pass == 0 && threadIdx.x == 0) {
            unsigned run = 0;
            for (int c = 0; c < 33; ++c) {
                const unsigned k = s_n[c];
                s_n[c] = run;
                run += k;
            }
        }
        __syncthreads();
    }
    for (int q = threadIdx.x; q < L.n_bins; q += blockDim.x) {
        const int bin = s_ord[q];
        const int bx = bin % L.bins_x, by = bin / L.bins_x;
        const int cb = L.n_bins + by / VVR_SUN_COARSE * L.coarse_x
                       + bx / VVR_SUN_COARSE;
        jobs[2 * q] = make_int4(bin, s_lo[bin], s_len[bin], s_lo[cb]);
        jobs[2 * q + 1] = make_int4(s_len[cb], s_lo[g], s_len[g], 0);
    }
}

// Blocks 0..nb-1: each occluder's entry (f, oi0 | oi1 << 16, oj0 | oj1 <<
// 16) in its lists, at its block's place (read into shared memory first)
// plus a slot in the block's part of the list, one shared-memory atomic per
// warp and list. Block nb: the tiles' jobs (vvr_sun_order).
static __global__ void __launch_bounds__(VVR_SUN_FPB)
vvr_sun_bin_kernel(int n_faces, VvrSunLists L, int nb,
                   const int4* __restrict__ boxes,
                   const long long* __restrict__ cnt,
                   const long long* __restrict__ bsum,
                   const long long* __restrict__ total,
                   int4* __restrict__ list, int4* __restrict__ jobs) {
    if (blockIdx.x == nb) {
        vvr_sun_order(L, nb, cnt, bsum, total, jobs);
        return;
    }
    __shared__ unsigned s_cnt[VVR_SUN_MAX_LISTS];
    __shared__ long long s_off[VVR_SUN_MAX_LISTS];
    const int f = blockIdx.x * VVR_SUN_FPB + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int4 box = f < n_faces ? boxes[f] : make_int4(0, -1, 0, -1);
    const int n_lists = vvr_sun_n_lists(L);
    for (int k = threadIdx.x; k < n_lists; k += blockDim.x) {
        s_cnt[k] = 0;
        s_off[k] = vvr_sun_place(cnt, bsum, (long long)k * nb + blockIdx.x);
    }
    __syncthreads();
    const int4 entry = make_int4(f, box.x | (box.y << 16),
                                 box.z | (box.w << 16), 0);
    const VvrSunEntries en = vvr_sun_entries(box, L);
    const int n_max = __reduce_max_sync(0xffffffffu, en.n);
    for (int k = 0, kx = 0, ky = 0; k < n_max; ++k) {
        const int l = k < en.n ? en.base + ky * en.stride + kx : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, l);
        const int leader = __ffs(peers) - 1;
        unsigned base = 0;
        if (l >= 0 && lane == leader) {
            base = atomicAdd(s_cnt + l, (unsigned)__popc(peers));
        }
        base = __shfl_sync(0xffffffffu, base, leader);
        if (l >= 0) {
            list[s_off[l] + base + __popc(peers & ((1u << lane) - 1u))] =
                entry;
        }
        if (++kx == en.w) {
            kx = 0;
            ++ky;
        }
    }
}

// One CTA owns a TILE x TILE tile of texels in shared memory, as (B, C)
// u32 pairs in the order map. It takes the entries of its bin's list, its
// coarse bin's and the global list in batches of THREADS, one per thread
// (the CTA's tile and lists come from its bin's job): the thread clips
// the entry's box to the tile and, where they meet, stages the face's
// record and clipped box in its slot; a CTA scan of the clipped texel
// counts flattens the batch's (face, texel) pairs, and thread t then
// evaluates the t-th of THREADS equal runs of them, walking its slots'
// boxes row by row with the record of the slot in registers, as the
// per-texel build evaluated each texel. All the CTA's threads thus share
// a tile's pairs, however few faces hold them. MODE: the hard grids or
// the cone grids (each texel's margins from the support grid M.S).
template <int TILE, int THREADS, int MODE>
static __global__ void __launch_bounds__(THREADS)
vvr_sun_tile_kernel(VvrSunFrame G, VvrSunMode M, int bins_x,
                    int tiles_per_bin, const int4* __restrict__ jobs,
                    const float4* __restrict__ recs,
                    const int4* __restrict__ list, float* __restrict__ out) {
    // a slot: the record (4 float4) and the clipped box (i0, j0, i1, j1)
    // in the tile
    __shared__ float4 s_slot[THREADS][5];
    __shared__ int s_pre[THREADS];
    __shared__ int s_ws[THREADS / 32];
    __shared__ unsigned s_tex[2 * TILE * TILE];
    // the cone build: each texel's support depth
    __shared__ float s_st[MODE == VVR_SUN_CONE ? TILE * TILE : 1];
    const int tid = threadIdx.x;
    const int tiles_x = (G.grid + TILE - 1) / TILE;
    // the bin's job (vvr_sun_order) and this CTA's tile of the bin's
    const int per_bin = tiles_per_bin * tiles_per_bin;
    const int q = blockIdx.x / per_bin, sub = blockIdx.x - q * per_bin;
    const int4 job = jobs[2 * q], job2 = jobs[2 * q + 1];
    const int tx = job.x % bins_x * tiles_per_bin + sub % tiles_per_bin;
    const int ty = job.x / bins_x * tiles_per_bin + sub / tiles_per_bin;
    if (tx >= tiles_x || ty >= tiles_x) return;   // past the grid's edge
    const int x0 = tx * TILE, y0 = ty * TILE;
    const int x1 = min(x0 + TILE, G.grid) - 1, y1 = min(y0 + TILE, G.grid) - 1;
    const unsigned neg = vvr_ord(VVR_NEG);
    for (int k = tid; k < 2 * TILE * TILE; k += THREADS) s_tex[k] = neg;
    if (MODE == VVR_SUN_CONE) {
        for (int k = tid; k < TILE * TILE; k += THREADS) {
            const int gi = min(x0 + k % TILE, x1), gj = min(y0 + k / TILE, y1);
            s_st[k] = vvr_support_at(M.S, min(gj / M.bfc, M.cs - 1) * M.cs
                                              + min(gi / M.bfc, M.cs - 1));
        }
    }
    // the entries: the bin list's, the coarse list's, the global list's
    const int n_bin = job.z, n_two = job.z + job2.x;
    const int n_all = n_two + job2.z;
    const float ts0 = 0.0f * G.ts, ts1 = 1.0f * G.ts;   // the corners' steps
    for (int base = 0; base < n_all; base += THREADS) {
        __syncthreads();   // the tile's start, or the last batch, is done
        const int e = base + tid;
        int cnt = 0;
        if (e < n_all) {
            const int4 ent = list[e < n_bin   ? job.y + e
                                  : e < n_two ? job.w + (e - n_bin)
                                              : job2.y + (e - n_two)];
            const int i0 = max(ent.y & 0xFFFF, x0), i1 = min(ent.y >> 16, x1);
            const int j0 = max(ent.z & 0xFFFF, y0), j1 = min(ent.z >> 16, y1);
            if (i0 <= i1 && j0 <= j1) {
                const float4* r = recs + 4 * (size_t)ent.x;
#pragma unroll
                for (int k = 0; k < 4; ++k) s_slot[tid][k] = __ldg(r + k);
                s_slot[tid][4] = make_float4(
                    __int_as_float(i0 - x0), __int_as_float(j0 - y0),
                    __int_as_float(i1 - x0), __int_as_float(j1 - y0));
                cnt = (i1 - i0 + 1) * (j1 - j0 + 1);
            }
        }
        s_pre[tid] = vvr_tile_scan(cnt, s_ws);
        __syncthreads();
        const int pairs = s_pre[THREADS - 1];
        const int per = (pairs + THREADS - 1) / THREADS;
        int q = tid * per;
        const int q_end = min(q + per, pairs);
        if (q >= q_end) continue;
        int a = 0, z = min(n_all - base, THREADS) - 1;
        // the slot of pair q: the first whose prefix passes q
        while (a < z) {
            const int mid = (a + z) >> 1;
            if (s_pre[mid] > q) {
                z = mid;
            } else {
                a = mid + 1;
            }
        }
        float4 r0 = s_slot[a][0], r1 = s_slot[a][1];
        float4 r2 = s_slot[a][2], r3 = s_slot[a][3], geo = s_slot[a][4];
        int bi0 = __float_as_int(geo.x), bi1 = __float_as_int(geo.z);
        int a_end = s_pre[a];   // the pairs before the slot's end
        const int idx = q - (a > 0 ? s_pre[a - 1] : 0);
        const int bw = bi1 - bi0 + 1;
        int lj = __float_as_int(geo.y) + idx / bw;
        int li = bi0 + idx % bw;
        for (;;) {
            // Corner k of the texel lies at (ta0 + (k >> 1) * ts, tb0 +
            // (k & 1) * ts), each offset rounded as the per-texel build
            // rounds it.
            const float ta0 = G.a0 + (float)(x0 + li) * G.ts;
            const float tb0 = G.b0 + (float)(y0 + lj) * G.ts;
            const float da[2] = {(ta0 + ts0) - r0.x, (ta0 + ts1) - r0.x};
            const float db[2] = {(tb0 + ts0) - r0.y, (tb0 + ts1) - r0.y};
            unsigned* t = s_tex + 2 * (lj * TILE + li);
            // the texel test: r0 = (p0a, p0b, ua, ub), r1 = (va, vb,
            // inv_det, mu), r2 = (1 - mu, mv - xv0, 1 - mv + xv1, z00),
            // r3 = (g_a, g_b, zmax, g_m); in the cone build r1.w = rmu,
            // r2 = (rmv, xv0, xv1, z00), r3.w = gsum and the margins
            // grow with the cone's reach above the texel's support
            // depth. An edge-on face (deg) is the one whose inv_det is
            // 0. The comparisons are combined without branches.
            const bool deg = r1.z == 0.0f;
            float mu = r1.w, lo_v = r2.y, hi_v = r2.z, hi_u = r2.x;
            float g_m = r3.w, g_bm = 0.0f, mv = 0.0f;
            if (MODE == VVR_SUN_CONE) {
                const float s_t = s_st[lj * TILE + li];
                const float grow_t =
                    VVR_SAFE + M.cone_tan * fmaxf(r3.z - (s_t
                                                          - VVR_S_SLACK),
                                                  0.0f);
                mu = grow_t * r1.w;
                mv = grow_t * r2.x;
                g_m = grow_t * r3.w;
                g_bm = (grow_t - VVR_SAFE) * r3.w;
                hi_u = 1.0f - mu;
                lo_v = mv - r2.y;
                hi_v = (1.0f - mv) + r2.z;
            }
            bool fully = !deg;
            float zc_min = 3e38f, zc_max = VVR_NEG;
            float uu_min = 3e38f, uu_max = -3e38f;
            float vv_min = 3e38f, vv_max = -3e38f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // the texel's corners
                const float a_ = da[k >> 1], b_ = db[k & 1];
                const float uu = (a_ * r1.y - b_ * r1.x) * r1.z;
                const float vv = (r0.z * b_ - r0.w * a_) * r1.z;
                fully = fully & (uu > mu) & (uu < hi_u) & (vv > lo_v)
                        & (vv < hi_v);
                const float zc = (r2.w + a_ * r3.x) + b_ * r3.y;
                zc_min = fminf(zc_min, zc);
                zc_max = fmaxf(zc_max, zc);
                if (MODE == VVR_SUN_CONE) {
                    uu_min = fminf(uu_min, uu);
                    uu_max = fmaxf(uu_max, uu);
                    vv_min = fminf(vv_min, vv);
                    vv_max = fmaxf(vv_max, vv);
                }
            }
            // gridC: possibly touching -> affine max over the grown
            // texel, capped by the face's max; edge-on faces use the
            // face's max. The cone build counts a face as touching
            // only where the texel's corner interval meets its quad
            // grown by the texel's reach.
            const bool poss =
                MODE != VVR_SUN_CONE || deg
                || (uu_max > -mu && uu_min < 1.0f + mu && vv_max > -mv
                    && vv_min < 1.0f + mv);
            if (poss) {
                atomicMax(t + 1, vvr_ord(deg ? r3.z
                                             : fminf(r3.z, zc_max + g_m)));
            }
            // gridB: fully covered -> affine min over the texel
            // (lowered by the cone's reach), capped
            if (fully) atomicMax(t, vvr_ord(fminf(zc_min - g_bm, r3.z)));
            if (++q == q_end) break;
            if (q < a_end) {   // the next texel of this box
                if (++li > bi1) {
                    li = bi0;
                    ++lj;
                }
                continue;
            }
            do {   // the next slot with pairs
                a_end = s_pre[++a];
            } while (a_end <= q);
            r0 = s_slot[a][0];
            r1 = s_slot[a][1];
            r2 = s_slot[a][2];
            r3 = s_slot[a][3];
            geo = s_slot[a][4];
            bi0 = li = __float_as_int(geo.x);
            lj = __float_as_int(geo.y);
            bi1 = __float_as_int(geo.z);
        }
    }
    __syncthreads();
    for (int k = tid; k < TILE * TILE; k += THREADS) {
        const int li = k % TILE, lj = k / TILE;
        if (x0 + li <= x1 && y0 + lj <= y1) {
            const long long tex = (long long)(y0 + lj) * G.grid + x0 + li;
            reinterpret_cast<float2*>(out)[tex] = make_float2(
                vvr_unord(s_tex[2 * k]), vvr_unord(s_tex[2 * k + 1]));
        }
    }
}

template <int TILE>
static void vvr_sun_tiles(int mode, int n_ctas, const VvrSunFrame& G,
                          const VvrSunMode& M, int bins_x, int per,
                          const int4* jobs, const float4* recs,
                          const int4* list, float* out, cudaStream_t st) {
    if constexpr (TILE == 16) {   // the cone build's tiles (sun_tiling)
        if (mode == VVR_SUN_CONE) {
            vvr_sun_tile_kernel<TILE, VVR_SUN_TILE_THREADS, VVR_SUN_CONE>
                <<<n_ctas, VVR_SUN_TILE_THREADS, 0, st>>>(
                    G, M, bins_x, per, jobs, recs, list, out);
            return;
        }
    }
    vvr_sun_tile_kernel<TILE, VVR_SUN_TILE_THREADS, VVR_SUN_HARD>
        <<<n_ctas, VVR_SUN_TILE_THREADS, 0, st>>>(G, M, bins_x, per, jobs,
                                                  recs, list, out);
}

// One build over grid G with the given tiling: setup, scan, bin, tiles
// (four launches and the scan's two). scratch (ops/sunshadow.py
// sun_scratch_bytes): boxes (n_faces int4), records (4 n_faces float4), the
// lists (n_faces * (VVR_SUN_BIN_MAX + 1) int4), the tiles' jobs (int4
// each), the counts ((n_bins + 1) * nb int64) and the scan's block sums
// and total.
static int vvr_sun_build(const VvrFaces& F, const VvrSunBasis& B,
                         const VvrSunFrame& G, int tile, int bin_side,
                         const VvrSunMode& M, void* scratch, float* out,
                         cudaStream_t st) {
    const int bins_x = (G.grid + bin_side - 1) / bin_side;
    const VvrSunLists L = {bin_side, bins_x, bins_x * bins_x,
                           (bins_x + VVR_SUN_COARSE - 1) / VVR_SUN_COARSE};
    if ((tile != 16 && tile != 32) || bin_side % tile != 0
        || (M.mode == VVR_SUN_CONE && tile != 16)
        || L.n_bins > VVR_SUN_MAX_BINS || G.grid <= 0 || G.grid > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_faces = F.n;
    const int nb = max((n_faces + VVR_SUN_FPB - 1) / VVR_SUN_FPB, 1);
    const int n_lists = L.n_bins + L.coarse_x * L.coarse_x + 1;
    const int n_cnt = n_lists * nb;
    // a CTA per tile of each bin, including the tiles past the grid's edge
    const int per = bin_side / tile;
    const int n_ctas = L.n_bins * per * per;
    int4* boxes = (int4*)scratch;
    float4* recs = (float4*)(boxes + n_faces);
    int4* list = (int4*)(recs + 4 * (size_t)n_faces);
    int4* jobs = list + (size_t)n_faces * (VVR_SUN_BIN_MAX + 1);
    long long* cnt = (long long*)(jobs + 2 * (size_t)L.n_bins);
    long long* bsum = cnt + n_cnt;
    long long* total = bsum + (n_cnt + 1023) / 1024;
    vvr_sun_setup_kernel<<<nb, VVR_SUN_FPB, 0, st>>>(F, B, G, L, M, nb, boxes,
                                                      recs, cnt);
    vvr_scan_partial(cnt, n_cnt, bsum, total, st);
    vvr_sun_bin_kernel<<<nb + 1, VVR_SUN_FPB, 0, st>>>(
        n_faces, L, nb, boxes, cnt, bsum, total, list, jobs);
    if (tile == 16) {
        vvr_sun_tiles<16>(M.mode, n_ctas, G, M, bins_x, per, jobs, recs,
                          list, out, st);
    } else {
        vvr_sun_tiles<32>(M.mode, n_ctas, G, M, bins_x, per, jobs, recs,
                          list, out, st);
    }
    return (int)cudaGetLastError();
}

// The support pass: S[k], the least over the faces whose box grown by
// S_PAD covers coarse texel k of the affine depth at its corners, held at
// or above the face's least depth (that depth for an edge-on face), as
// order-mapped u32 (S starts at all ones). One thread sets up one face
// (every face of the set, occluder or not); the block flattens its faces'
// (face, coarse texel) pairs (a CTA scan), and each of SLICES blocks of
// the same faces (blockIdx.y) takes every SLICES-th run of THREADS of
// them, one atomicMin a pair, so a large face's pairs spread over SLICES
// blocks. The expressions are the per-texel build's
// (support_grid_plain).
static __global__ void __launch_bounds__(VVR_SUN_SUPPORT_THREADS)
vvr_sun_support_kernel(VvrFaces F, VvrSunBasis B, VvrSunFrame GS,
                       VvrSunMode M, unsigned* __restrict__ S) {
    // each face's (p0a, p0b, g_a, g_b) and (z00, zmin, deg), its box's
    // corner (i0, j0), its width and the block's running pair count
    __shared__ float4 s_rec[VVR_SUN_SUPPORT_THREADS][2];
    __shared__ int4 s_box[VVR_SUN_SUPPORT_THREADS];
    __shared__ int s_ws[VVR_SUN_SUPPORT_THREADS / 32];
    const int tid = threadIdx.x;
    const int f = blockIdx.x * VVR_SUN_SUPPORT_THREADS + tid;
    int cnt = 0, i0 = 0, j0 = 0, w = 1;
    if (f < F.n) {
        const VvrSunFace s = vvr_sun_face(F, f, B, GS, M);
        s_rec[tid][0] = make_float4(s.p0a, s.p0b, s.g_a, s.g_b);
        s_rec[tid][1] = make_float4(s.z00, s.zmin, s.deg ? 1.0f : 0.0f,
                                    0.0f);
        i0 = s.oi0;
        j0 = s.oj0;
        w = s.oi1 - s.oi0 + 1;
        cnt = w * (s.oj1 - s.oj0 + 1);
    }
    s_box[tid] = make_int4(i0, j0, w, vvr_tile_scan(cnt, s_ws));
    __syncthreads();
    const int total = s_box[VVR_SUN_SUPPORT_THREADS - 1].w;
    const float ts0 = 0.0f * GS.ts, ts1 = 1.0f * GS.ts;   // corners' steps
    for (int q = tid + blockIdx.y * VVR_SUN_SUPPORT_THREADS; q < total;
         q += VVR_SUN_SUPPORT_SLICES * VVR_SUN_SUPPORT_THREADS) {
        int a = 0, z = VVR_SUN_SUPPORT_THREADS - 1;
        while (a < z) {   // the face of pair q: the first prefix past q
            const int mid = (a + z) >> 1;
            if (s_box[mid].w > q) {
                z = mid;
            } else {
                a = mid + 1;
            }
        }
        const int4 bx = s_box[a];
        const int idx = q - (a > 0 ? s_box[a - 1].w : 0);
        const int ci = bx.x + idx % bx.z, cj = bx.y + idx / bx.z;
        const float4 r0 = s_rec[a][0], r1 = s_rec[a][1];
        const float ta0 = GS.a0 + (float)ci * GS.ts;
        const float tb0 = GS.b0 + (float)cj * GS.ts;
        const float da[2] = {(ta0 + ts0) - r0.x, (ta0 + ts1) - r0.x};
        const float db[2] = {(tb0 + ts0) - r0.y, (tb0 + ts1) - r0.y};
        float zmn = 3e38f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            zmn = fminf(zmn, (r1.x + da[k >> 1] * r0.z) + db[k & 1] * r0.w);
        }
        atomicMin(S + cj * M.cs + ci,
                  vvr_ord(r1.z != 0.0f ? r1.y : fmaxf(zmn, r1.y)));
    }
}

// K11: with cone_tan 0 the hard grids (one build); with cone_tan > 0 the
// cone grids: first the support grid S over cs x cs coarse texels (cs =
// min(256, grid), each bfc = grid / cs texels a side; a memset and the
// support pass) at the front of scratch, then the cone build, whose setup
// and tiles read S, in the rest of scratch.
extern "C" int vvr_sun_grids(
        const void* vx, const void* vy, const void* vz, const void* axis,
        const void* sgn, const void* eu, const void* ev, const void* einfo,
        int n_faces, float e1x, float e1y, float e1z, float e2x, float e2y,
        float e2z, float sx, float sy, float sz, float a0, float b0, float ts,
        int grid, int tile, int bin_side, float cone_tan, float wzmin,
        void* scratch, void* gbc, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const VvrFaces F = {(const int*)vx, (const int*)vy, (const int*)vz,
                        (const int*)axis, (const int*)sgn, (const int*)eu,
                        (const int*)ev, (const int*)einfo, n_faces};
    const VvrSunBasis B = {e1x, e1y, e1z, e2x, e2y, e2z, sx, sy, sz};
    const VvrSunFrame G = {a0, b0, ts, grid};
    VvrSunMode M = {VVR_SUN_HARD, cone_tan, wzmin, nullptr, 0, 1};
    if (cone_tan > 0.0f) {
        if (grid <= 0) return (int)cudaErrorInvalidValue;
        M.cs = min(256, grid);
        M.bfc = grid / M.cs;
        unsigned* sgrid = (unsigned*)scratch;
        const size_t s_bytes = (size_t)M.cs * M.cs * sizeof(unsigned);
        scratch = (char*)scratch + (s_bytes + 15) / 16 * 16;
        const cudaError_t err = cudaMemsetAsync(sgrid, 0xFF, s_bytes, st);
        if (err != cudaSuccess) return (int)err;
        const VvrSunFrame GS = {a0, b0, ts * (float)M.bfc, M.cs};
        VvrSunMode MS = M;
        MS.mode = VVR_SUN_SUPPORT;
        if (n_faces > 0) {
            const dim3 blocks(vvr_blocks(n_faces, VVR_SUN_SUPPORT_THREADS),
                              VVR_SUN_SUPPORT_SLICES);
            vvr_sun_support_kernel<<<blocks, VVR_SUN_SUPPORT_THREADS, 0,
                                     st>>>(
                F, B, GS, MS, sgrid);
        }
        M.mode = VVR_SUN_CONE;
        M.S = sgrid;
    }
    return vvr_sun_build(F, B, G, tile, bin_side, M, scratch, (float*)gbc,
                         st);
}

// ---- K12

// whether the voxel of an in-world start is solid (the DDA then hits at
// t = 0)
template <class View>
static __device__ __forceinline__ bool vvr_start_solid(const View& V,
                                                       float ox, float oy,
                                                       float oz) {
    return V.solid(vvr_floor_clip(ox, 0, V.size - 1),
                   vvr_floor_clip(oy, 0, V.size - 1),
                   vvr_floor_clip(oz, 0, V.size - 1));
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

// the answer for one start without the DDA, or VVR_K12_RESIDUE; the
// near walk only on the flat grid (grid_view.cuh)
template <class View>
static __device__ int vvr_classify_start(
        const View& V, float ox, float oy, float oz, const VvrSunBasis& B,
        const float2* __restrict__ gbc, const VvrSunFrame& G, float back) {
    const float fs = (float)V.size;
    const bool inw = ox >= 0.0f && ox < fs && oy >= 0.0f && oy < fs
                     && oz >= 0.0f && oz < fs;
    if (!inw) return VVR_K12_LIGHT;           // the DDA's origin-outside rule
    const VvrSunRow r = vvr_sun_row(ox, oy, oz, B, gbc, G);
    const float qz = r.qz;
    const bool inb = r.ing;
    const float2 row = r.row;
    if (vvr_start_solid(V, ox, oy, oz)) {
        return VVR_K12_SHADOW;                // the DDA's start-in-solid hit
    }
    if (inb && qz < row.x - VVR_SAFE) return VVR_K12_SHADOW;  // certain
    if (inb && qz - back > row.y + VVR_SAFE) return VVR_K12_LIGHT;
    if constexpr (View::NEAR_WALK) {
        bool nh, nexit;
        float t_end;
        vvr_near_segment(V.rows, V.size, ox, oy, oz, B.sx, B.sy, B.sz, &nh,
                         &nexit, &t_end);
        if (nh) return VVR_K12_SHADOW;
        if (nexit || qz + t_end > row.y + VVR_SAFE) {
            return VVR_K12_LIGHT;             // left the world, or lifted
        }
    }
    return VVR_K12_RESIDUE;
}

// One thread per lane: its start (read, or computed from its primary
// hit), the tests above, and, for a residue lane, the grid's DDA inline.
template <class View>
static __global__ void __launch_bounds__(128)
vvr_masked_shadow_kernel(const View V, VvrShadowLanes L, int n,
                         VvrSunBasis B, const float2* __restrict__ gbc,
                         VvrSunFrame G, float back, int max_steps,
                         uint8_t* __restrict__ out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    int r = VVR_K12_LIGHT;
    float ox, oy, oz;
    if (vvr_lane_start(L, p, B, &ox, &oy, &oz)) {
        r = vvr_classify_start(V, ox, oy, oz, B, gbc, G, back);
        if (r == VVR_K12_RESIDUE) {
            r = V.template trace<false>(ox, oy, oz, B.sx, B.sy, B.sz, true,
                                        max_steps).hit
                    ? VVR_K12_SHADOW : VVR_K12_LIGHT;
        }
    }
    out[p] = (uint8_t)r;
}

template <class View>
static int vvr_masked_shadow_launch(
        const View& V, const void* s_o, const void* active, const void* o,
        const void* d, const void* hit, const void* face,
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
        vvr_masked_shadow_kernel<View><<<vvr_blocks(n, 128), 128, 0,
                                         (cudaStream_t)stream>>>(
            V, L, n, B, (const float2*)gbc, G, back, max_steps,
            (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}

// K12 over n lanes given as starts (s_o, active) or, with s_o null, as
// the primary hits (o, d, hit, face, axis_coord), on the jump grid
extern "C" int vvr_masked_shadow(
        const void* rows, int size, const void* s_o, const void* active,
        const void* o, const void* d, const void* hit, const void* face,
        const void* axis_coord, int n, float sx, float sy, float sz,
        float e1x, float e1y, float e1z, float e2x, float e2y, float e2z,
        const void* gbc, int grid, float a0, float b0, float ts, float back,
        int max_steps, void* out, void* stream) {
    const VvrFlatView V = {(const uint32_t*)rows, size};
    return vvr_masked_shadow_launch(V, s_o, active, o, d, hit, face,
                                    axis_coord, n, sx, sy, sz, e1x, e1y, e1z,
                                    e2x, e2y, e2z, gbc, grid, a0, b0, ts,
                                    back, max_steps, out, stream);
}

// the same on the paged grid (its page table, pool, size and page edge)
extern "C" int vvr_masked_shadow_paged(
        const void* prows, const void* brows, int size, int psize,
        const void* s_o, const void* active, const void* o, const void* d,
        const void* hit, const void* face, const void* axis_coord, int n,
        float sx, float sy, float sz, float e1x, float e1y, float e1z,
        float e2x, float e2y, float e2z, const void* gbc, int grid, float a0,
        float b0, float ts, float back, int max_steps, void* out,
        void* stream) {
    const VvrPagedView V = {(const uint32_t*)prows, (const uint32_t*)brows,
                            size, psize};
    return vvr_masked_shadow_launch(V, s_o, active, o, d, hit, face,
                                    axis_coord, n, sx, sy, sz, e1x, e1y, e1z,
                                    e2x, e2y, e2z, gbc, grid, a0, b0, ts,
                                    back, max_steps, out, stream);
}

// the same on the brick pyramid (its rows, size and depth)
extern "C" int vvr_masked_shadow_pyramid(
        const void* rows, int size, int depth, const void* s_o,
        const void* active, const void* o, const void* d, const void* hit,
        const void* face, const void* axis_coord, int n, float sx, float sy,
        float sz, float e1x, float e1y, float e1z, float e2x, float e2y,
        float e2z, const void* gbc, int grid, float a0, float b0, float ts,
        float back, int max_steps, void* out, void* stream) {
    const VvrPyramidView V = {(const uint32_t*)rows, size, depth};
    return vvr_masked_shadow_launch(V, s_o, active, o, d, hit, face,
                                    axis_coord, n, sx, sy, sz, e1x, e1y, e1z,
                                    e2x, e2y, e2z, gbc, grid, a0, b0, ts,
                                    back, max_steps, out, stream);
}

// K18 invalidate_texels: the sun grids' repair after a world edit. Replaces
// vvr_tpu/ops/sunshadow.py:460 `invalidate_sun_texels` (ops/sunshadow.py
// wraps it): every texel of each edited superbrick's rectangle takes
// (NEG, 3e38), certain of neither shadow nor light, so the lanes landing
// there run the exact DDA against the patched grid.
//
// The card forms the rectangles itself, from the edited positions. The
// entry point groups the (K, 3) positions by 8^3 superbrick on the host in
// C++ (a stable sort by the superbrick's key, as ops/sunshadow.py
// superbrick_groups orders them in numpy), writes the R + 1 CSR offsets
// and the positions in group order as int32 into a pinned staging buffer,
// makes one non-blocking copy of it to the card's buffer and one launch;
// both buffers are kept, per device, from call to call, in a ring of
// VVR_INV_SLOTS pairs, so a call waits for none of the launches before it
// unless the ring is full of launches still queued. One block
// a superbrick: its threads project their voxels' eight cube corners on e1
// and e2 in float64, each as (x e_x + y e_y) + z e_z with every product and
// sum rounded on its own (__dmul_rn, __dadd_rn: no contraction, whatever
// the flags), and reduce the min and max of both (warp shuffles, then
// shared memory; min and max are exact, so the order does not matter). One
// thread forms the rectangle (i0, i1, j0, j1), inclusive, with texel_rects'
// formula, floor((p -/+ grow - a0) / ts) -/+ 1 in float64, clamped into the
// grid (a rectangle off the grid comes out empty), and writes it to
// `rects` where given; then the block fills it, its threads striding over
// the texels, rows of i adjacent in memory. Rectangles may overlap: both
// write the same values. The host's plain version (texel_rects) computes
// the same expressions in numpy float64, so the rectangles are equal bit
// for bit.
//
// What bounds it on an H100: nothing of the card's; its few kilobytes are
// a launch's worth of work (1.37-1.50 us of device time before this
// design, H100 80GB HBM3 at 700 W, PERF.md section 6), while the host's
// rectangles took 0.5-0.7 ms an edit. The design takes that host work off
// the edit: no per-superbrick Python loop, no BLAS product (whose rounding
// depended on the slice it was given), and no numpy or torch call between
// the positions and the launch, whose per-call costs (tens of us a call on
// that machine's host) would outweigh the kernel.

#define VVR_INV_THREADS 128

struct VvrTexelFrame {
    double e1x, e1y, e1z, e2x, e2y, e2z;   // the sun basis
    double a0, b0, ts;                     // the grid's origin and texel
    double grow;                           // the build's largest margin
    int grid;
};

static __device__ __forceinline__ double vvr_proj64(double x, double y,
                                                    double z, double ex,
                                                    double ey, double ez) {
    return __dadd_rn(__dadd_rn(__dmul_rn(x, ex), __dmul_rn(y, ey)),
                     __dmul_rn(z, ez));
}

// floor(q) + off clamped into [lo, hi], as texel_rects clips it
static __device__ __forceinline__ int vvr_texel_edge(double q, double off,
                                                     int lo, int hi) {
    return (int)fmin(fmax(floor(q) + off, (double)lo), (double)hi);
}

__global__ void __launch_bounds__(VVR_INV_THREADS)
vvr_invalidate_texels_kernel(float2* __restrict__ gbc, VvrTexelFrame f,
                             const int* __restrict__ offs,
                             const int* __restrict__ pos,
                             int4* __restrict__ rects) {
    __shared__ double red[4][VVR_INV_THREADS / 32];
    __shared__ int4 rect;
    const int lo = offs[blockIdx.x], hi = offs[blockIdx.x + 1];
    // (min, -max) of the projections on e1, then on e2
    double m[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    for (int v = lo + (int)threadIdx.x; v < hi; v += VVR_INV_THREADS) {
        const double x = pos[3 * v], y = pos[3 * v + 1], z = pos[3 * v + 2];
        for (int c = 0; c < 8; ++c) {
            const double cx = x + (c >> 2), cy = y + ((c >> 1) & 1),
                         cz = z + (c & 1);
            const double pa = vvr_proj64(cx, cy, cz, f.e1x, f.e1y, f.e1z);
            const double pb = vvr_proj64(cx, cy, cz, f.e2x, f.e2y, f.e2z);
            m[0] = fmin(m[0], pa);
            m[1] = fmin(m[1], -pa);
            m[2] = fmin(m[2], pb);
            m[3] = fmin(m[3], -pb);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < 4; ++k) {
        for (int s = 16; s > 0; s >>= 1) {
            m[k] = fmin(m[k], __shfl_xor_sync(0xffffffffu, m[k], s));
        }
        if (lane == 0) red[k][warp] = m[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 0; k < 4; ++k) {
            for (int w = 1; w < VVR_INV_THREADS / 32; ++w) {
                m[k] = fmin(m[k], red[k][w]);
            }
        }
        const double g = f.grow;
        const int4 r = make_int4(
            vvr_texel_edge(__ddiv_rn(__dsub_rn(__dsub_rn(m[0], g), f.a0),
                                     f.ts), -1.0, 0, f.grid),
            vvr_texel_edge(__ddiv_rn(__dsub_rn(__dadd_rn(-m[1], g), f.a0),
                                     f.ts), 1.0, -1, f.grid - 1),
            vvr_texel_edge(__ddiv_rn(__dsub_rn(__dsub_rn(m[2], g), f.b0),
                                     f.ts), -1.0, 0, f.grid),
            vvr_texel_edge(__ddiv_rn(__dsub_rn(__dadd_rn(-m[3], g), f.b0),
                                     f.ts), 1.0, -1, f.grid - 1));
        if (rects != nullptr) rects[blockIdx.x] = r;
        rect = r;
    }
    __syncthreads();
    const int4 r = rect;
    const int w = r.y - r.x + 1, h = r.w - r.z + 1;
    const int n = (w > 0 && h > 0) ? w * h : 0;   // empty off the grid
    for (int k = threadIdx.x; k < n; k += VVR_INV_THREADS) {
        const int j = r.z + k / w;
        const int i = r.x + k - (k / w) * w;
        gbc[(size_t)j * f.grid + i] = make_float2(-3e38f, 3e38f);
    }
}

// the groups' buffers of a device, in a ring of slots: each a pinned
// buffer on the host and one on the card (offsets, then positions, int32)
// and the event after the last launch that read them; a call takes the
// next slot and writes it only once that launch is done (a wait only when
// VVR_INV_SLOTS calls in a row are still queued on the card), so no launch
// reads a buffer while it changes. The buffers live as long as the process
#define VVR_INV_DEVICES 64
#define VVR_INV_SLOTS 3
struct VvrInvSlot {
    int* host = nullptr;
    int* card = nullptr;
    size_t cap = 0;                     // ints
    cudaEvent_t done = nullptr;
};
struct VvrInvStage {
    VvrInvSlot slot[VVR_INV_SLOTS];
    int next = 0;
};
static VvrInvStage vvr_inv_stage[VVR_INV_DEVICES];

// gbc: (grid^2, 2) float32; positions: (k, 3) int64 on the host, each
// coordinate of magnitude below 2^23; rects: (k, 4) int32 on the card, or
// null: the first R rows take the rectangles; n_rects: one int on the
// host that takes R, or null; the sun basis (e1, e2), the grid frame (a0,
// b0, ts) and the margin grow in float64
extern "C" int vvr_invalidate_texels(void* gbc, int grid,
                                     const void* positions, int k,
                                     double e1x, double e1y,
                                     double e1z, double e2x, double e2y,
                                     double e2z, double a0, double b0,
                                     double ts, double grow, void* rects,
                                     void* n_rects, void* stream) {
    if (grid <= 0 || grid > 46340 || k < 0 || !(ts > 0.0)
            || (k > 0 && positions == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_rects != nullptr) *(int*)n_rects = 0;
    if (k == 0) return (int)cudaSuccess;
    const long long* p = (const long long*)positions;
    // the superbrick keys, ordered as (x, y, z); a stable order by key
    std::vector<long long> key(k);
    for (int v = 0; v < k; ++v) {
        for (int c = 0; c < 3; ++c) {
            if (p[3 * v + c] <= -(1LL << 23) || p[3 * v + c] >= (1LL << 23)) {
                return (int)cudaErrorInvalidValue;
            }
        }
        key[v] = (p[3 * v] >> 3) * (1LL << 42) + (p[3 * v + 1] >> 3)
                 * (1LL << 21) + (p[3 * v + 2] >> 3);
    }
    std::vector<int> order(k);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&key](int a, int b) { return key[a] < key[b]; });
    int r = 1;
    for (int v = 1; v < k; ++v) r += key[order[v]] != key[order[v - 1]];
    const size_t need = (size_t)r + 1 + 3 * (size_t)k;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= VVR_INV_DEVICES) return (int)cudaErrorInvalidDevice;
    VvrInvStage& ring = vvr_inv_stage[dev];
    VvrInvSlot& st = ring.slot[ring.next];
    ring.next = (ring.next + 1) % VVR_INV_SLOTS;
    if (st.done == nullptr) {
        err = cudaEventCreateWithFlags(&st.done, cudaEventDisableTiming);
        if (err != cudaSuccess) {
            st.done = nullptr;
            return (int)err;
        }
    } else {                            // the last launch that read them
        err = cudaEventQuery(st.done);
        if (err == cudaErrorNotReady) {  // not an error: clear, then wait
            (void)cudaGetLastError();
            err = cudaEventSynchronize(st.done);
        }
        if (err != cudaSuccess) return (int)err;
    }
    if (need > st.cap) {
        cudaFreeHost(st.host);
        cudaFree(st.card);
        st.host = nullptr;
        st.card = nullptr;
        st.cap = 0;
        const size_t cap = std::max(need, (size_t)4096);
        err = cudaHostAlloc((void**)&st.host, cap * sizeof(int),
                            cudaHostAllocPortable);
        if (err == cudaSuccess) {
            err = cudaMalloc((void**)&st.card, cap * sizeof(int));
        }
        if (err != cudaSuccess) {
            cudaFreeHost(st.host);
            st.host = nullptr;
            return (int)err;
        }
        st.cap = cap;
    }
    int* offs = st.host;
    int* pos = st.host + r + 1;
    int g = 0;
    offs[0] = 0;
    for (int v = 0; v < k; ++v) {
        if (v > 0 && key[order[v]] != key[order[v - 1]]) offs[++g] = v;
        for (int c = 0; c < 3; ++c) {
            pos[3 * v + c] = (int)p[3 * order[v] + c];
        }
    }
    offs[r] = k;
    const cudaStream_t s = (cudaStream_t)stream;
    err = cudaMemcpyAsync(st.card, st.host, need * sizeof(int),
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const VvrTexelFrame f = {e1x, e1y, e1z, e2x, e2y, e2z,
                             a0,  b0,  ts,  grow, grid};
    vvr_invalidate_texels_kernel<<<r, VVR_INV_THREADS, 0, s>>>(
        (float2*)gbc, f, st.card, st.card + r + 1, (int4*)rects);
    const cudaError_t launched = cudaGetLastError();
    err = cudaEventRecord(st.done, s);   // after the copy, launched or not
    if (launched != cudaSuccess) return (int)launched;
    if (err == cudaSuccess && n_rects != nullptr) *(int*)n_rects = r;
    return (int)err;
}
