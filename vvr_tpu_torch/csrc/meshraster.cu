// K22 raster_triangles and K23 shade_raster: the raster debug view
// (debug_type 0) of the surface-nets world mesh. render/raster.py wraps
// both and holds their plain versions.
//
// K22 replaces vvr_tpu/render/raster.py:118 `project_verts` and :234
// `_raster_slab` (`_grid_pass` :147, `_fullscreen_pass` :190): per pixel,
// the least depth over the triangles covering its centre, and the least
// triangle id among the fragments with depth <= that * (1 + 1e-6). One C
// entry point, five launches and a memset, the binning K9's (tilebin.cuh):
//  1. project, one thread a vertex: screen x, y and the view depth w;
//  2. setup, one thread a triangle: its corners, 1 / area, whether it
//     draws (every w > 1e-3, a non-zero area), its pixel box clipped to
//     the screen, its tile counts (or its place on the big list), and per
//     warp two bit masks: its triangles wider than 16 pixels, and those
//     of them that fit 128;
//  3. one block scans the tile counts into offsets while one block a
//     32,768-triangle slab turns the masks into `contract`: whether the
//     JAX 128-sample pass draws the triangle (wider than 16 pixels, one of
//     its slab's first 2048 such, no wider than 128), whose edge
//     functions round with an FMA (render/raster.py);
//  4. bin, one thread a triangle: its index into each of its tiles' lists;
//  5. tile, one CTA a tile: its triangles come in batches of one a thread,
//     their records in shared memory, the batch's fragments (box pixels
//     inside the tile) flattened and searched as tilebin.cuh says. Two
//     sweeps over the tile's triangles: the least depth (float bits,
//     positive, as u32 atomicMin in shared memory), then the least id
//     within the band. The tile's z-buffer and winners go to device
//     memory once.
// Every float expression keeps the plain version's op order (the library
// is built with -fmad=false); __fmaf_rn stands where XLA's jit contracts
// (render/raster.py's module docstring).
//
// K23 replaces vvr_tpu/render/raster.py:262 `_shade_raster`: one thread a
// pixel intersects its ray (K13's direction) with the winning triangle's
// plane, starts the shadow ray at world + 0.5 + sun * 0.1 and runs the
// brick pyramid's HDDA inline (pyramid_dda.cuh, the any masks, as K19 in
// the frame), white on a hit and black on a miss; a pixel no triangle won
// takes the skybox blended with the clouds along its ray (shading.cuh,
// clouds.cuh). It writes the planar (4, H, W) HDR that K4 composites,
// alpha 0.
//
// What bounds them on an H100. K22: instructions and shared-memory
// atomics over the fragments (each box pixel is tested in both sweeps),
// and at the horizon the busiest tile's CTA; its bytes are the mesh (a
// 12-byte vertex, a 12-byte triangle), a 64-byte record a triangle and 8
// bytes a pixel out. K23: the shadow walks (a chain of dependent row loads
// a covered pixel) and 16 bytes a pixel out. Both are first versions:
// right and simple, not tuned.
#include "tilebin.cuh"
#include "clouds.cuh"
#include "pyramid_dda.cuh"
#include "shading.cuh"

#define VVR_MR_THREADS 256
// the JAX rasterizer's slab and its 128-sample pass's capacity
// (render/raster.py SLAB and BIG_CAP), read only for `contract`
#define VVR_MR_SLAB 32768
#define VVR_MR_BIG_CAP 2048
#define VVR_NO_TRI 0x7FFFFFFF
#define VVR_INF_BITS 0x7F800000u

// the three rows of proj @ view the projection reads (x, y and w)
struct VvrViewProj {
    float m[12];
};

// a triangle's record: (ax, ay, bx, by), (cx, cy, wa, wb), (wc, 1 / area,
// 0, 0), and its pixel box (x0, x1, y0, y1) clipped to the screen, x0 > x1
// when it draws nothing
struct VvrTriRec {
    float4 r0, r1, r2;
    int4 box;
};

static __device__ __forceinline__ float3 vvr_vertex(
        const float* __restrict__ v, int nv, const float* __restrict__ ev,
        int i) {
    const float* p = i < nv ? v + 3 * (size_t)i : ev + 3 * (size_t)(i - nv);
    return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

static __device__ __forceinline__ int3 vvr_triangle(
        const int* __restrict__ t, int nt, const int* __restrict__ et,
        int i) {
    const int* p = i < nt ? t + 3 * (size_t)i : et + 3 * (size_t)(i - nt);
    return make_int3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// 1. screen coordinates: clip = (x m0 + y m1) + (z m2 + m3) per row, the
// pixel-centre frame of `project_verts` rounded as XLA's jit rounds it
__global__ void __launch_bounds__(256)
vvr_mesh_project_kernel(const float* __restrict__ verts, int nv,
                        const float* __restrict__ extra, int ne,
                        VvrViewProj M, int width, int height,
                        float* __restrict__ sx, float* __restrict__ sy,
                        float* __restrict__ sw) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nv + ne) return;
    const float3 p = vvr_vertex(verts, nv, extra, i);
    const float* m = M.m;
    const float cx = (p.x * m[0] + p.y * m[1]) + (p.z * m[2] + m[3]);
    const float cy = (p.x * m[4] + p.y * m[5]) + (p.z * m[6] + m[7]);
    const float w = (p.x * m[8] + p.y * m[9]) + (p.z * m[10] + m[11]);
    const float safe = fabsf(w) < 1e-6f ? 1e-6f : w;
    sx[i] = __fmaf_rn((cx / safe + 1.0f) * 0.5f, (float)width, -0.5f);
    sy[i] = __fmaf_rn((1.0f - cy / safe) * 0.5f, (float)height, -0.5f);
    sw[i] = w;
}

// 2. one thread a triangle: its record, its tile counts or its place on
// the big list, and its warp's words of the two masks (bit k: triangle
// 32 * word + k)
__global__ void __launch_bounds__(256)
vvr_tri_setup_kernel(const int* __restrict__ tris, int nt,
                     const int* __restrict__ extra, int nx,
                     const float* __restrict__ sx,
                     const float* __restrict__ sy,
                     const float* __restrict__ sw, int width, int height,
                     int tiles_x, VvrTriRec* __restrict__ recs, VvrBins bins,
                     unsigned* __restrict__ wide_bits,
                     unsigned* __restrict__ fits_bits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < nt + nx;
    int4 box = make_int4(0, -1, 0, -1);
    bool wide = false, fits = false;
    if (live) {
        const int3 t = vvr_triangle(tris, nt, extra, i);
        const float ax = sx[t.x], ay = sy[t.x], bx = sx[t.y], by = sy[t.y];
        const float cx = sx[t.z], cy = sy[t.z];
        const float wa = sw[t.x], wb = sw[t.y], wc = sw[t.z];
        const float area =
            __fmaf_rn(bx - ax, cy - ay, -((by - ay) * (cx - ax)));
        const float inv = fabsf(area) < 1e-9f ? 0.0f : 1.0f / area;
        const bool draws =
            wa > 1e-3f && wb > 1e-3f && wc > 1e-3f && inv != 0.0f;
        const float x0 = floorf(fminf(ax, fminf(bx, cx)));
        const float x1 = ceilf(fmaxf(ax, fmaxf(bx, cx)));
        const float y0 = floorf(fminf(ay, fminf(by, cy)));
        const float y1 = ceilf(fmaxf(ay, fmaxf(by, cy)));
        wide = !(x1 - x0 <= 16.0f && y1 - y0 <= 16.0f);
        fits = x1 - x0 <= 128.0f && y1 - y0 <= 128.0f;
        if (draws && x1 >= 0.0f && x0 <= (float)(width - 1) && y1 >= 0.0f
            && y0 <= (float)(height - 1)) {
            box = make_int4((int)fmaxf(x0, 0.0f),
                            (int)fminf(x1, (float)(width - 1)),
                            (int)fmaxf(y0, 0.0f),
                            (int)fminf(y1, (float)(height - 1)));
        }
        VvrTriRec r;
        r.r0 = make_float4(ax, ay, bx, by);
        r.r1 = make_float4(cx, cy, wa, wb);
        r.r2 = make_float4(wc, inv, 0.0f, 0.0f);
        r.box = box;
        recs[i] = r;
    }
    const unsigned wide_w = __ballot_sync(0xffffffffu, wide);
    const unsigned fits_w = __ballot_sync(0xffffffffu, wide && fits);
    if ((threadIdx.x & 31) == 0 && live) {
        wide_bits[i >> 5] = wide_w;
        fits_bits[i >> 5] = fits_w;
    }
    vvr_bin_count(box, i, tiles_x, bins);
}

// 3. block 0 scans the tile counts; block 1 + s, 1024 threads, ranks slab
// s's wide triangles, a mask word a thread, and leaves in fits_bits the
// wide triangles that fit and rank below VVR_MR_BIG_CAP: `contract`
__global__ void __launch_bounds__(1024)
vvr_tri_scan_kernel(VvrBins bins, int n_tiles,
                    const unsigned* __restrict__ wide_bits,
                    unsigned* __restrict__ fits_bits, int n_words) {
    __shared__ long long ws[32];
    __shared__ long long carry;
    if (blockIdx.x == 0) {
        vvr_scan_top(bins.tile_off, n_tiles, bins.total, ws, &carry);
        return;
    }
    const int word = (blockIdx.x - 1) * (VVR_MR_SLAB / 32) + threadIdx.x;
    unsigned wide = word < n_words ? wide_bits[word] : 0u;
    const long long cnt = __popc(wide);
    const long long before = vvr_block_scan(cnt, ws) - cnt;
    if (word >= n_words) return;
    // the word's wide triangles ranked below the cap: its first
    // VVR_MR_BIG_CAP - before (the highest bits go first)
    const long long room = VVR_MR_BIG_CAP - before;
    for (long long r = cnt; r > room && wide != 0u; --r) {
        wide &= ~(1u << (31 - __clz(wide)));
    }
    fits_bits[word] &= wide;
}

// a fragment's coverage and depth (`_edge_cover` :131-144 and the depth
// :172-174), the edge functions rounded as the triangle's JAX pass does
static __device__ __forceinline__ bool vvr_fragment(
        float4 r0, float4 r1, float2 r2, bool contract, float px, float py,
        float* depth) {
    const float ax = r0.x, ay = r0.y, bx = r0.z, by = r0.w;
    const float cx = r1.x, cy = r1.y, wa = r1.z, wb = r1.w;
    const float wc = r2.x, inv = r2.y;
    float e0, e1;
    if (contract) {
        e0 = __fmaf_rn(-(cy - by), px - bx, (cx - bx) * (py - by));
        e1 = __fmaf_rn(-(ay - cy), px - cx, (ax - cx) * (py - cy));
    } else {
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
    }
    const float l0 = e0 * inv;
    const float l1 = e1 * inv;
    const float l2 = (1.0f - l0) - l1;
    const float inv_w = (l0 / wa + l1 / wb) + l2 / wc;
    *depth = 1.0f / fmaxf(inv_w, 1e-9f);
    return l0 >= -1e-6f && l1 >= -1e-6f && l2 >= -1e-6f;
}

// 5. one CTA a 32x32 tile
__global__ void __launch_bounds__(VVR_MR_THREADS)
vvr_tri_tile_kernel(int width, int height,
                    const VvrTriRec* __restrict__ recs, VvrBins bins,
                    const unsigned* __restrict__ contract_bits,
                    float* __restrict__ zbuf, int* __restrict__ winner) {
    __shared__ unsigned s_z[VVR_TILE_PIX];
    __shared__ int s_win[VVR_TILE_PIX];
    __shared__ float4 s_r0[VVR_MR_THREADS], s_r1[VVR_MR_THREADS];
    __shared__ float2 s_r2[VVR_MR_THREADS];
    __shared__ int s_id[VVR_MR_THREADS], s_geo[VVR_MR_THREADS];
    __shared__ int s_pre[VVR_MR_THREADS];
    __shared__ int s_ws[VVR_MR_THREADS / 32];
    __shared__ unsigned short s_coarse[VVR_COARSE];
    const int tid = threadIdx.x;
    const int tiles_x = (width + VVR_TILE - 1) / VVR_TILE;
    const int tile = blockIdx.x;
    const int x0 = (tile % tiles_x) * VVR_TILE;
    const int y0 = (tile / tiles_x) * VVR_TILE;
    const int tw = min(VVR_TILE, width - x0);
    const int th = min(VVR_TILE, height - y0);
    for (int p = tid; p < VVR_TILE_PIX; p += VVR_MR_THREADS) {
        s_z[p] = VVR_INF_BITS;
        s_win[p] = VVR_NO_TRI;
    }
    const VvrTileItems items = vvr_tile_items(bins, tile);
    for (int sweep = 0; sweep < 2; ++sweep) {
        for (int base = 0; base < items.n; base += VVR_MR_THREADS) {
            __syncthreads();  // the last batch (or sweep) is done
            const int k = base + tid;
            int cnt = 0;
            if (k < items.n) {
                const int i = vvr_tile_item(items, k);
                const VvrTriRec r = recs[i];
                const int i0 = max(r.box.x, x0);
                const int i1 = min(r.box.y, x0 + tw - 1);
                const int j0 = max(r.box.z, y0);
                const int j1 = min(r.box.w, y0 + th - 1);
                if (i0 <= i1 && j0 <= j1) {
                    const int bw = i1 - i0 + 1;
                    const unsigned con =
                        (__ldg(contract_bits + (i >> 5)) >> (i & 31)) & 1u;
                    s_r0[tid] = r.r0;
                    s_r1[tid] = r.r1;
                    s_r2[tid] = make_float2(r.r2.x, r.r2.y);
                    s_id[tid] = i;
                    // tile-local box corner, width, and contract
                    s_geo[tid] = (i0 - x0) | ((j0 - y0) << 5) | (bw << 10)
                                 | (con << 16);
                    cnt = bw * (j1 - j0 + 1);
                }
            }
            s_pre[tid] = vvr_tile_scan(cnt, s_ws);
            __syncthreads();
            const int total = s_pre[VVR_MR_THREADS - 1];
            const int last = min(items.n - base, VVR_MR_THREADS) - 1;
            vvr_batch_coarse(cnt, s_pre, total, s_coarse);
            __syncthreads();
            for (int q = tid; q < total; q += VVR_MR_THREADS) {
                const int lo =
                    vvr_batch_slot(q, s_pre, last, total, s_coarse);
                const int idx = q - (lo > 0 ? s_pre[lo - 1] : 0);
                const int geo = s_geo[lo];
                const int bw = (geo >> 10) & 63;
                const int row = idx / bw;
                const int lx = (geo & 31) + (idx - row * bw);
                const int ly = ((geo >> 5) & 31) + row;
                const int p = ly * VVR_TILE + lx;
                float depth;
                const bool cover = vvr_fragment(
                    s_r0[lo], s_r1[lo], s_r2[lo], (geo >> 16) & 1,
                    (float)(x0 + lx) + 0.5f, (float)(y0 + ly) + 0.5f,
                    &depth);
                if (!cover) continue;
                if (sweep == 0) {
                    atomicMin(s_z + p, __float_as_uint(depth));
                } else if (depth <= __uint_as_float(s_z[p]) * 1.000001f) {
                    atomicMin(s_win + p, s_id[lo]);
                }
            }
        }
        __syncthreads();
    }
    for (int p = tid; p < VVR_TILE_PIX; p += VVR_MR_THREADS) {
        const int r = p / VVR_TILE, c = p - r * VVR_TILE;
        if (r < th && c < tw) {
            const size_t o = (size_t)(y0 + r) * width + x0 + c;
            zbuf[o] = __uint_as_float(s_z[p]);
            winner[o] = s_win[p];
        }
    }
}

// scratch (render/raster.py raster_scratch_words): the triangle records
// (16 words each), the binning's (tilebin.cuh VvrBins), sx, sy, w of every
// vertex, then the two masks (a word per 32 triangles each)
extern "C" int vvr_raster_triangles(
        const void* verts, int nv, const void* extra_verts, int ne,
        const void* tris, int nt, const void* extra_tris, int nx, float m0,
        float m1, float m2, float m3, float m4, float m5, float m6, float m7,
        float m8, float m9, float m10, float m11, int width, int height,
        void* scratch, void* zbuf, void* winner, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (width <= 0 || height <= 0 || width > 32767 || height > 32767
        || nv < 0 || ne < 0 || nt < 0 || nx < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const VvrViewProj M = {{m0, m1, m2, m3, m4, m5, m6, m7, m8, m9, m10,
                            m11}};
    const int n_tris = nt + nx, n_verts = nv + ne;
    const int n_words = (n_tris + 31) / 32;
    const int tiles_x = (width + VVR_TILE - 1) / VVR_TILE;
    const int n_tiles = tiles_x * ((height + VVR_TILE - 1) / VVR_TILE);
    VvrTriRec* recs = (VvrTriRec*)scratch;
    const VvrBins bins = vvr_bins_at(recs + n_tris, n_tiles, n_tris);
    float* sx = (float*)vvr_bins_end(bins, n_tris);
    float* sy = sx + n_verts;
    float* sw = sy + n_verts;
    unsigned* wide_bits = (unsigned*)(sw + n_verts);
    unsigned* fits_bits = wide_bits + n_words;
    vvr_bins_clear(bins, n_tiles, st);
    if (n_verts > 0) {
        vvr_mesh_project_kernel<<<vvr_blocks(n_verts, 256), 256, 0, st>>>(
            (const float*)verts, nv, (const float*)extra_verts, ne, M, width,
            height, sx, sy, sw);
    }
    if (n_tris > 0) {
        vvr_tri_setup_kernel<<<vvr_blocks(n_tris, 256), 256, 0, st>>>(
            (const int*)tris, nt, (const int*)extra_tris, nx, sx, sy, sw,
            width, height, tiles_x, recs, bins, wide_bits, fits_bits);
    }
    vvr_tri_scan_kernel<<<1 + (n_tris + VVR_MR_SLAB - 1) / VVR_MR_SLAB, 1024,
                          0, st>>>(bins, n_tiles, wide_bits, fits_bits,
                                   n_words);
    vvr_bins_fill(bins, n_tris, tiles_x, (const int4*)recs + 3, 4, st);
    vvr_tri_tile_kernel<<<n_tiles, VVR_MR_THREADS, 0, st>>>(
        width, height, recs, bins, fits_bits, (float*)zbuf, (int*)winner);
    return (int)cudaGetLastError();
}

// K23: one thread a pixel
__global__ void __launch_bounds__(256)
vvr_shade_raster_kernel(const int* __restrict__ winner, int n,
                        const float* __restrict__ verts, int nv,
                        const float* __restrict__ extra_verts,
                        const int* __restrict__ tris, int nt,
                        const int* __restrict__ extra_tris,
                        const uint32_t* __restrict__ rows, int size,
                        int depth, int max_steps, float ox, float oy,
                        float oz, const float* __restrict__ d, float sx,
                        float sy, float sz,
                        const float* __restrict__ skybox, int sky_res,
                        const float* __restrict__ clouds, int cl_res,
                        float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int w = winner[i];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    float r, g, b;
    if (w != VVR_NO_TRI) {
        const int3 t = vvr_triangle(tris, nt, extra_tris, w);
        const float3 v0 = vvr_vertex(verts, nv, extra_verts, t.x);
        const float3 v1 = vvr_vertex(verts, nv, extra_verts, t.y);
        const float3 v2 = vvr_vertex(verts, nv, extra_verts, t.z);
        // the geometric normal and the ray's point on its plane
        // (:275-282), contracted as render/raster.py `_plane_hit` says
        const float e1x = v1.x - v0.x, e1y = v1.y - v0.y, e1z = v1.z - v0.z;
        const float e2x = v2.x - v0.x, e2y = v2.y - v0.y, e2z = v2.z - v0.z;
        float nx = __fmaf_rn(e1y, e2z, -(e1z * e2y));
        float ny = __fmaf_rn(e1z, e2x, -(e1x * e2z));
        float nz = __fmaf_rn(e1x, e2y, -(e1y * e2x));
        const float nn = fmaxf(
            sqrtf(__fmaf_rn(nz, nz, __fmaf_rn(ny, ny, nx * nx))), 1e-12f);
        nx = nx / nn;
        ny = ny / nn;
        nz = nz / nn;
        const float denom = __fmaf_rn(nz, dz, __fmaf_rn(ny, dy, nx * dx));
        const float num = __fmaf_rn(nz, v0.z - oz,
                                    __fmaf_rn(ny, v0.y - oy,
                                              nx * (v0.x - ox)));
        const float tp = num / (fabsf(denom) < 1e-9f ? 1e-9f : denom);
        const float wx = __fmaf_rn(dx, tp, ox);
        const float wy = __fmaf_rn(dy, tp, oy);
        const float wz = __fmaf_rn(dz, tp, oz);
        // the fragment's shadow ray (rasterized.slang:83-85)
        const JumpHit h = vvr_pyramid_trace_ray<false, false>(
            rows, size, depth, (wx + 0.5f) + sx * 0.1f,
            (wy + 0.5f) + sy * 0.1f, (wz + 0.5f) + sz * 0.1f, sx, sy, sz,
            true, max_steps);
        r = g = b = h.hit ? 1.0f : 0.0f;
    } else {
        const float4 cl = vvr_sample_clouds(clouds, cl_res, dx, dy, dz, ox,
                                            oy, oz);
        const float3 sb = vvr_sample_skybox(skybox, sky_res, dx, dy, dz);
        r = sb.x + (cl.x - sb.x) * cl.w;
        g = sb.y + (cl.y - sb.y) * cl.w;
        b = sb.z + (cl.z - sb.z) * cl.w;
    }
    out[i] = r;
    out[n + i] = g;
    out[2 * (size_t)n + i] = b;
    out[3 * (size_t)n + i] = 0.0f;
}

extern "C" int vvr_shade_raster(
        const void* winner, int n, const void* verts, int nv,
        const void* extra_verts, const void* tris, int nt,
        const void* extra_tris, const void* rows, int size, int depth,
        int max_steps, float ox, float oy, float oz, const void* d, float sx,
        float sy, float sz, const void* skybox, int sky_res,
        const void* clouds, int cl_res, void* out, void* stream) {
    if (n > 0) {
        vvr_shade_raster_kernel<<<vvr_blocks(n, 256), 256, 0,
                                  (cudaStream_t)stream>>>(
            (const int*)winner, n, (const float*)verts, nv,
            (const float*)extra_verts, (const int*)tris, nt,
            (const int*)extra_tris, (const uint32_t*)rows, size, depth,
            max_steps, ox, oy, oz, (const float*)d, sx, sy, sz,
            (const float*)skybox, sky_res, (const float*)clouds, cl_res,
            (float*)out);
    }
    return (int)cudaGetLastError();
}
