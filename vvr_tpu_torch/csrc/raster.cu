// K9 raster_fragments and K10 raster_resolve: first hits of the camera's
// primary rays by depth-min rasterization of the merged exposed faces.
// Replace vvr_tpu/ops/rastertrace.py:190 `trace_raster` (ops/rastertrace.py
// wraps them).
//
// K9 bins the faces by 32x32-pixel screen tile (tilebin.cuh, shared with
// K22), then rasterizes each tile in shared memory, one CTA per tile.
// Four kernels, one C entry point:
//  1. project, one thread per face: its pixel bbox (`_project_faces`,
//     :61-140, tightened to the pixels whose centres lie within
//     VVR_BOX_MARGIN of its projected corners; a face that straddles the
//     camera plane takes the whole screen), and the fields its fragment
//     test reads, in one 16-byte record; then the bbox's tile counts
//     (or its place on the big list);
//  2. one block scans the tile counts into offsets (items.cuh);
//  3. bin, one thread per face: each binned face writes its index into
//     the list of each of its tiles (the order within a list is free: the
//     key is a min);
//  4. tile, one CTA per tile: the tile's directions and their reciprocals
//     (the IEEE 1.0f / d, BIG_T where d == 0) go into shared memory once;
//     its faces come in batches of one per thread, each clipped to the
//     tile and stored in shared memory; the batch's fragments are
//     flattened and searched as tilebin.cuh says; a thread skips its
//     fragment if the face lies wholly behind the pixel's key so far (a
//     lower bound on its t, vvr_face_t_key), else tests it and takes
//     atomicMin on the pixel's key in shared memory. The tile's keys go to
//     device memory once, coalesced.
// The key is (t_bits - 0x20000000) << 2 | axis (:161-184): u32 order is t
// order, and exact cross-axis ties resolve x > y > z as the oracle's z ->
// y -> x stepping does. The tight box and the depth skip drop only
// fragments that cannot lower a key, so the keys are those of the JAX
// box's every fragment (ops/rastertrace.py holds both to the plain K9).
// The fragment's t is the oracle's entry formula (plane - o_a) * (1/d_a)
// on the wavefront's own direction d, not on a direction recomputed from
// the pixel: compiled with -fmad=false, it equals the oracle's t bit for
// bit, so no ulp wobble reaches the winner. Coverage takes the oracle's
// own cell at that crossing (vvr_cell_at), not floor(o + d*t): the floor
// disagrees with the DDA's stepping on rays that graze a voxel edge (9 of
// the 2,073,600 bench rays on an H100).
// K10: one thread per pixel decodes the key, finds the winning plane along
// the key's axis by the two-candidate window match (:462-509), and applies
// the start-in-solid and origin-outside rules (:511-519).
//
// What bounds K9 on an H100: instructions and latency, not bytes. The
// bench view's tight boxes hold about 2.2 fragments per pixel, up to
// 17,000 in one tile at the horizon, so the CTA of the busiest tile sets
// the kernel's span; 512 threads a CTA give it a larger share of its SM.
// The design reads each direction once, divides once per pixel and
// component, keeps every atomic in shared memory, and gives small faces
// whole warps. The binned lists hold at most VVR_BIN_MAX entries per face
// and the big list one, so the wrapper sizes them from the face count
// alone and nothing can overflow. The TPU design's fixed tile capacity,
// its cumulative-max face map and its full-screen net for straddling and
// overflowing faces are not ported.
#include "tilebin.cuh"

#define VVR_SENTINEL 0xFFFFFFFFu
#define VVR_BITS_BIAS 0x20000000u
// K9's tile CTA (its tile and the most tiles a binned face may span:
// tilebin.cuh VVR_TILE and VVR_BIN_MAX, ops/rastertrace.py TILE and
// BIN_MAX)
#define VVR_TILE_THREADS 512
// pixels of a face's bbox: centres within this of its projected corners
// (ops/rastertrace.py BOX_MARGIN)
#define VVR_BOX_MARGIN 0.05f

struct VvrRasterCam {
    float px, py, pz;   // position
    float rx, ry, rz;   // right
    float ux, uy, uz;   // up
    float fx, fy, fz;   // forward
    float tan_half;
    float ratio;        // width / height, rounded to float32
    int width, height;
};

static __device__ __forceinline__ float vvr_sel3(int a, float x, float y,
                                                 float z) {
    return a == 0 ? x : (a == 1 ? y : z);
}

// pixel bbox (imin, imax, jmin, jmax) of face f's fragments: the pixels
// whose centres lie within VVR_BOX_MARGIN of its corners' projected extent
// (a face straddling the camera plane takes the whole screen); false when
// it makes none (back-facing, behind the camera, off screen, between pixel
// centres). The JAX box (floor(ic - 0.01) .. ceil(ic + 0.01)) adds up to a
// pixel on each side, most of the bench view's fragments; a pixel outside
// this one is never covered, since the exact test's crossing lies inside
// the face to within rounding (about 1e-3 px here).
static __device__ bool vvr_raster_box(const VvrFaces& F, int f,
                                      const VvrRasterCam& c, int4* box) {
    const int ax = F.axis[f], sg = F.sgn[f], eu = F.eu[f], ev = F.ev[f];
    const int vx = F.vx[f], vy = F.vy[f], vz = F.vz[f];
    const float pf = (float)((ax == 0 ? vx : (ax == 1 ? vy : vz)) + sg);
    const float o_a = vvr_sel3(ax, c.px, c.py, c.pz);
    const bool visible = (sg == 1 ? o_a > pf : o_a < pf) && eu > 0;
    if (!visible) return false;
    const float euf = (float)eu, evf = (float)ev;
    const float tx = c.tan_half, ty = c.tan_half / c.ratio;
    const float hw = (float)c.width * 0.5f, hh = (float)c.height * 0.5f;
    int imin = c.width, imax = -1, jmin = c.height, jmax = -1;
    bool some_behind = false, all_behind = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float du = (float)(k >> 1), dv = (float)(k & 1);
        const float cx = ax == 0 ? pf : (float)vx + du * euf;
        const float cy = ax == 1 ? pf
                                 : (float)vy + (ax == 0 ? du * euf : dv * evf);
        const float cz = ax == 2 ? pf : (float)vz + dv * evf;
        const float qx = cx - c.px, qy = cy - c.py, qz = cz - c.pz;
        const float zc = (qx * c.fx + qy * c.fy) + qz * c.fz;
        const float xc = (qx * c.rx + qy * c.ry) + qz * c.rz;
        const float yc = (qx * c.ux + qy * c.uy) + qz * c.uz;
        const bool beh = zc <= 1e-6f;
        some_behind = some_behind || beh;
        all_behind = all_behind && beh;
        const float zs = fmaxf(zc, 1e-6f);
        const float su = xc / (zs * tx);
        const float sv = yc / (zs * ty);
        const float ic = (su + 1.0f) * hw - 0.5f;
        const float jc = (1.0f - sv) * hh - 0.5f;
        imin = min(imin, vvr_ceil_int(ic - VVR_BOX_MARGIN));
        imax = max(imax, vvr_floor_int(ic + VVR_BOX_MARGIN));
        jmin = min(jmin, vvr_ceil_int(jc - VVR_BOX_MARGIN));
        jmax = max(jmax, vvr_floor_int(jc + VVR_BOX_MARGIN));
    }
    // no point of a face wholly behind the camera plane is on any ray
    if (all_behind) return false;
    if (some_behind) {
        *box = make_int4(0, c.width - 1, 0, c.height - 1);
        return true;
    }
    if (imax < 0 || imin > c.width - 1 || jmax < 0 || jmin > c.height - 1
        || imin > imax || jmin > jmax)
        return false;
    *box = make_int4(max(imin, 0), min(imax, c.width - 1), max(jmin, 0),
                     min(jmax, c.height - 1));
    return true;
}

// The oracle's cell along axis u at the moment the ray crosses a plane of
// axis a at t_a: its DDA is the merge of the per-axis crossing sequences
// t = (bound - o) * (1/d), ties stepped z, then y, then x, so a u-crossing
// at t_u comes first iff t_u < t_a, or t_u == t_a and u > a (u_first).
// floor(o_u + d_u * t_a) is that cell except within rounding of a u-plane;
// the loop moves it until the crossings into and out of it agree. `inv`
// is 1.0f / d_u (read only where d_u != 0).
static __device__ int vvr_cell_at(float o_u, float d_u, float inv, float t_a,
                                  bool u_first) {
    int c = vvr_floor_int(o_u + d_u * t_a);
    if (d_u == 0.0f) return c;
    const int c0 = vvr_floor_int(o_u);
    const int step = d_u > 0.0f ? 1 : -1;
    for (int k = 0; k < 4; ++k) {
        const float t_in = ((float)(d_u > 0.0f ? c : c + 1) - o_u) * inv;
        const float t_out = ((float)(d_u > 0.0f ? c + 1 : c) - o_u) * inv;
        if (c != c0 && !(t_in < t_a || (t_in == t_a && u_first))) {
            c -= step;            // not yet entered c
        } else if (t_out < t_a || (t_out == t_a && u_first)) {
            c += step;            // already left c
        } else {
            break;
        }
    }
    return c;
}

static __device__ __forceinline__ unsigned vvr_axis_key(float t, int axis) {
    unsigned b = __float_as_uint(t);
    b = b > VVR_BITS_BIAS ? b - VVR_BITS_BIAS : 0u;
    return (b << 2) | (unsigned)axis;
}

// boxes[2f] is face f's pixel bbox (imin, imax, jmin, jmax), empty when
// it makes no fragments; boxes[2f+1] what the fragment test reads of it:
// (plane << 2 | axis, u0, v0, eu << 16 | ev), in-plane axes (u, v) = (y, z),
// (x, z), (x, y) for axis 0, 1, 2 (a world of at most 65535 voxels a side).
static __global__ void vvr_raster_project_kernel(
        VvrFaces F, VvrRasterCam c, int tiles_x, int4* __restrict__ boxes,
        VvrBins bins) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    int4 b = make_int4(0, -1, 0, -1);
    if (f < F.n) {
        const int ax = F.axis[f], vx = F.vx[f], vy = F.vy[f], vz = F.vz[f];
        boxes[2 * f + 1] = make_int4(
            (((ax == 0 ? vx : (ax == 1 ? vy : vz)) + F.sgn[f]) << 2) | ax,
            ax == 0 ? vy : vx, ax == 2 ? vy : vz, (F.eu[f] << 16) | F.ev[f]);
        vvr_raster_box(F, f, c, &b);
        boxes[2 * f] = b;
    }
    vvr_bin_count(b, f, tiles_x, bins);
}

// A lower bound on t over the face's fragments, as a key (the fragment's
// key with axis 0): the distance from the camera to the face's rectangle,
// less 0.1% and 0.01, a margin far beyond the rounding of d (unit length
// within an ulp), of t and of the crossing cells that decide coverage.
// A fragment's key is at least this, since keys grow with t.
static __device__ __forceinline__ unsigned vvr_face_t_key(
        const VvrRasterCam& c, int ax, float pf, int u0, int u1, int v0,
        int v1) {
    const float ou = ax == 0 ? c.py : c.px, ov = ax == 2 ? c.py : c.pz;
    const float da = pf - vvr_sel3(ax, c.px, c.py, c.pz);
    const float du = fmaxf(fmaxf((float)u0 - ou, ou - (float)u1), 0.0f);
    const float dv = fmaxf(fmaxf((float)v0 - ov, ov - (float)v1), 0.0f);
    const float t = 0.999f * sqrtf((da * da + du * du) + dv * dv) - 0.01f;
    return t > 0.0f ? vvr_axis_key(t, 0) : 0u;
}

static __global__ void __launch_bounds__(VVR_TILE_THREADS)
vvr_raster_tile_kernel(VvrRasterCam c, const float* __restrict__ d,
                       const int4* __restrict__ boxes, VvrBins bins,
                       unsigned* __restrict__ keys) {
    __shared__ float s_d[3][VVR_TILE_PIX];
    __shared__ float s_inv[3][VVR_TILE_PIX];
    __shared__ unsigned s_key[VVR_TILE_PIX];
    // the batch's faces: plane, in-plane cell ranges [u0, u1) x [v0, v1),
    // axis | clipped box (x, y, width) within the tile, 1 / width, the key
    // of a lower bound on t, inclusive fragment prefix
    __shared__ float s_pf[VVR_TILE_THREADS], s_rbw[VVR_TILE_THREADS];
    __shared__ unsigned s_tk[VVR_TILE_THREADS];
    __shared__ int s_u0[VVR_TILE_THREADS], s_u1[VVR_TILE_THREADS];
    __shared__ int s_v0[VVR_TILE_THREADS], s_v1[VVR_TILE_THREADS];
    __shared__ int s_geo[VVR_TILE_THREADS], s_pre[VVR_TILE_THREADS];
    __shared__ int s_ws[VVR_TILE_THREADS / 32];
    __shared__ unsigned short s_coarse[VVR_COARSE];
    const int tid = threadIdx.x;
    const int tiles_x = (c.width + VVR_TILE - 1) / VVR_TILE;
    const int tile = blockIdx.x;
    const int x0 = (tile % tiles_x) * VVR_TILE;
    const int y0 = (tile / tiles_x) * VVR_TILE;
    const int tw = min(VVR_TILE, c.width - x0);
    const int th = min(VVR_TILE, c.height - y0);
    // the tile's rows of d are 3 * tw contiguous floats each; every load
    // is issued before the first is used
    constexpr int D_PER = 3 * VVR_TILE_PIX / VVR_TILE_THREADS;
    float dv[D_PER];
#pragma unroll
    for (int k = 0; k < D_PER; ++k) {
        const int e = tid + k * VVR_TILE_THREADS;
        const int r = e / (3 * VVR_TILE), q = e - r * 3 * VVR_TILE;
        dv[k] = r < th && q < 3 * tw
                    ? __ldg(d + 3 * ((size_t)(y0 + r) * c.width + x0) + q)
                    : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < D_PER; ++k) {
        const int e = tid + k * VVR_TILE_THREADS;
        const int r = e / (3 * VVR_TILE), q = e - r * 3 * VVR_TILE;
        const int i = q / 3, a = q - 3 * i;
        s_d[a][r * VVR_TILE + i] = dv[k];
        s_inv[a][r * VVR_TILE + i] = dv[k] == 0.0f ? VVR_BIG_T : 1.0f / dv[k];
    }
    for (int p = tid; p < VVR_TILE_PIX; p += VVR_TILE_THREADS) {
        s_key[p] = VVR_SENTINEL;
    }
    const VvrTileItems items = vvr_tile_items(bins, tile);
    for (int base = 0; base < items.n; base += VVR_TILE_THREADS) {
        __syncthreads();  // the tile's loads, or the last batch, are done
        const int k = base + tid;
        int cnt = 0;
        if (k < items.n) {
            const int f = vvr_tile_item(items, k);
            const int4 b = __ldg(boxes + 2 * f);
            const int4 rec = __ldg(boxes + 2 * f + 1);
            const int i0 = max(b.x, x0), i1 = min(b.y, x0 + tw - 1);
            const int j0 = max(b.z, y0), j1 = min(b.w, y0 + th - 1);
            if (i0 <= i1 && j0 <= j1) {
                const int ax = rec.x & 3;
                const float pf = (float)(rec.x >> 2);
                const int u1 = rec.y + (int)((unsigned)rec.w >> 16);
                const int v1 = rec.z + (rec.w & 0xFFFF);
                s_pf[tid] = pf;
                s_u0[tid] = rec.y;
                s_u1[tid] = u1;
                s_v0[tid] = rec.z;
                s_v1[tid] = v1;
                s_tk[tid] = vvr_face_t_key(c, ax, pf, rec.y, u1, rec.z, v1);
                const int bw = i1 - i0 + 1;
                s_rbw[tid] = 1.0f / (float)bw;
                s_geo[tid] = ax | ((i0 - x0) << 2) | ((j0 - y0) << 7)
                             | (bw << 12);
                cnt = bw * (j1 - j0 + 1);
            }
        }
        s_pre[tid] = vvr_tile_scan(cnt, s_ws);
        __syncthreads();
        const int total = s_pre[VVR_TILE_THREADS - 1];
        const int last = min(items.n - base, VVR_TILE_THREADS) - 1;
        vvr_batch_coarse(cnt, s_pre, total, s_coarse);
        __syncthreads();
        for (int q = tid; q < total; q += VVR_TILE_THREADS) {
            const int lo = vvr_batch_slot(q, s_pre, last, total, s_coarse);
            const int idx = q - (lo > 0 ? s_pre[lo - 1] : 0);
            const int geo = s_geo[lo];
            const int ax = geo & 3, bw = geo >> 12;
            // idx / bw: idx < 1024 and bw <= 32 keep (idx + 0.5) / bw at
            // least 1/64 from an integer, far beyond the rounding
            const int row = (int)(((float)idx + 0.5f) * s_rbw[lo]);
            const int p = (((geo >> 7) & 31) + row) * VVR_TILE
                          + ((geo >> 2) & 31) + (idx - row * bw);
            // the face's every fragment keys at least s_tk: nothing it
            // covers here can lower a key already below that
            if (s_tk[lo] > s_key[p]) continue;
            const float dx = s_d[0][p], dy = s_d[1][p], dz = s_d[2][p];
            const float ix = s_inv[0][p], iy = s_inv[1][p],
                        iz = s_inv[2][p];
            const float o_a = vvr_sel3(ax, c.px, c.py, c.pz);
            const float t = (s_pf[lo] - o_a) * vvr_sel3(ax, ix, iy, iz);
            if (!(t > 0.0f)) continue;
            // in-plane axes (u, v): axis 0 -> (y, z), 1 -> (x, z), 2 -> (x, y)
            const int u_c = ax == 0 ? vvr_cell_at(c.py, dy, iy, t, true)
                                    : vvr_cell_at(c.px, dx, ix, t, false);
            const int v_c = ax == 2 ? vvr_cell_at(c.py, dy, iy, t, false)
                                    : vvr_cell_at(c.pz, dz, iz, t, true);
            if (u_c >= s_u0[lo] && u_c < s_u1[lo] && v_c >= s_v0[lo]
                && v_c < s_v1[lo]) {
                atomicMin(s_key + p, vvr_axis_key(t, ax));
            }
        }
    }
    __syncthreads();
    for (int p = tid; p < VVR_TILE_PIX; p += VVR_TILE_THREADS) {
        const int r = p / VVR_TILE, i = p - r * VVR_TILE;
        if (r < th && i < tw) {
            keys[(size_t)(y0 + r) * c.width + x0 + i] = s_key[p];
        }
    }
}

// K10: per-pixel reconstruction of the winner (frame trace outputs)
static __global__ void vvr_raster_resolve_kernel(
        const unsigned* __restrict__ keys, const float* __restrict__ d,
        float px, float py, float pz, int probe, int size, int n,
        uint8_t* __restrict__ hit_out, int* __restrict__ face_out,
        int* __restrict__ axis_coord_out, float* __restrict__ t_out) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const unsigned key = keys[p];
    bool hit = key != VVR_SENTINEL;
    const unsigned wbits = (key >> 2) + VVR_BITS_BIAS;
    int face = (int)(key & 3u);
    const float ta0 = __uint_as_float(wbits);
    const float dx = d[3 * p], dy = d[3 * p + 1], dz = d[3 * p + 2];
    const float d_a = vvr_sel3(face, dx, dy, dz);
    const float o_a = vvr_sel3(face, px, py, pz);
    const float h_a = vvr_sel3(face, px + dx * ta0, py + dy * ta0,
                               pz + dz * ta0);
    const float inv_a = d_a == 0.0f ? VVR_BIG_T : 1.0f / d_a;
    const int k0 = vvr_floor_int(h_a);
    int ac = 0;
    float t = VVR_BIG_T;
    bool found = false;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
        const float ta = ((float)(k0 + kc) - o_a) * inv_a;
        const long long diff = (long long)(int)__float_as_uint(ta)
                               - (long long)(int)wbits;
        const bool window = diff <= 8 && diff >= -8;
        if (hit && window && ta > 0.0f && (!found || ta < t)) {
            ac = d_a > 0.0f ? k0 + kc : k0 + kc - 1;
            t = ta;
            found = true;
        }
    }
    if (!hit) face = 0;
    const float fs = (float)size;
    const bool inside = px >= 0.0f && px < fs && py >= 0.0f && py < fs
                        && pz >= 0.0f && pz < fs;
    if (probe && inside) {  // start in solid: t 0, face 0, axis_coord cell x
        face = 0;
        ac = (int)vvr_clamp(floorf(px), 0.0f, (float)(size - 1));
        t = 0.0f;
        hit = true;
    }
    hit = hit && inside;
    hit_out[p] = hit ? 1 : 0;
    face_out[p] = face;
    axis_coord_out[p] = hit ? ac : 0;
    t_out[p] = hit ? t : VVR_BIG_T;
}

extern "C" int vvr_raster_fragments(
        const void* vx, const void* vy, const void* vz, const void* axis,
        const void* sgn, const void* eu, const void* ev, int n_faces,
        float px, float py, float pz, float rx, float ry, float rz, float ux,
        float uy, float uz, float fx, float fy, float fz, float tan_half,
        float ratio, int width, int height, const void* d, void* scratch,
        void* boxes, void* keys, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const VvrFaces F = {(const int*)vx, (const int*)vy, (const int*)vz,
                        (const int*)axis, (const int*)sgn, (const int*)eu,
                        (const int*)ev, nullptr, n_faces};
    const VvrRasterCam c = {px, py, pz, rx, ry, rz, ux, uy, uz, fx, fy, fz,
                            tan_half, ratio, width, height};
    const int tiles_x = (width + VVR_TILE - 1) / VVR_TILE;
    const int n_tiles = tiles_x * ((height + VVR_TILE - 1) / VVR_TILE);
    if (n_tiles == 0) return (int)cudaGetLastError();
    // scratch: the binning's (tilebin.cuh VvrBins)
    const VvrBins bins = vvr_bins_at(scratch, n_tiles, n_faces);
    vvr_bins_clear(bins, n_tiles, st);
    if (n_faces > 0) {
        vvr_raster_project_kernel<<<vvr_blocks(n_faces, 256), 256, 0, st>>>(
            F, c, tiles_x, (int4*)boxes, bins);
    }
    vvr_scan_top_kernel<<<1, 1024, 0, st>>>(bins.tile_off, n_tiles,
                                            bins.total);
    vvr_bins_fill(bins, n_faces, tiles_x, (const int4*)boxes, 2, st);
    vvr_raster_tile_kernel<<<n_tiles, VVR_TILE_THREADS, 0, st>>>(
        c, (const float*)d, (const int4*)boxes, bins, (unsigned*)keys);
    return (int)cudaGetLastError();
}

extern "C" int vvr_raster_resolve(const void* keys, const void* d, float px,
                                  float py, float pz, int probe, int size,
                                  int n, void* hit, void* face,
                                  void* axis_coord, void* t, void* stream) {
    if (n > 0) {
        vvr_raster_resolve_kernel<<<vvr_blocks(n, 256), 256, 0,
                                    (cudaStream_t)stream>>>(
            (const unsigned*)keys, (const float*)d, px, py, pz, probe, size,
            n, (uint8_t*)hit, (int*)face, (int*)axis_coord, (float*)t);
    }
    return (int)cudaGetLastError();
}
