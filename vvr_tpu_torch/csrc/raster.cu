// K9 raster_fragments and K10 raster_resolve: first hits of the camera's
// primary rays by depth-min rasterization of the merged exposed faces.
// Replace vvr_tpu/ops/rastertrace.py:190 `trace_raster` (ops/rastertrace.py
// wraps them).
//
// K9: a projection kernel gives each visible face its pixel bbox
// (`_project_faces`, :61-140; a face that straddles the camera plane has no
// bbox and takes the whole screen) and its count of 8x4-pixel tiles; the
// counts go through an exclusive scan (items.cuh); then one warp per (face,
// tile) item tests its 32 pixels and writes each covered pixel's key with
// atomicMin. The key is (t_bits - 0x20000000) << 2 | axis (:161-184): u32
// order is t order, and exact cross-axis ties resolve x > y > z as the
// oracle's z -> y -> x stepping does.
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
// What bounds K9 on an H100: the scattered atomicMin traffic and the
// fragment count (every pixel of every visible face's bbox, about ten per
// pixel on the bench view), not bandwidth in the streaming sense; the
// direction array (25 MB at 1080p) and the key buffer (8 MB) stay in the
// 50 MB L2. The TPU design's fixed tile capacity, its cumulative-max face
// map and its full-screen net for straddling and overflowing faces are not
// ported: the scan sizes the work exactly.
#include "items.cuh"

#define VVR_SENTINEL 0xFFFFFFFFu
#define VVR_BITS_BIAS 0x20000000u
#define VVR_TKX 8
#define VVR_TKY 4

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

// pixel bbox (imin, imax, jmin, jmax) of face f's fragments; false when it
// makes none (back-facing, behind the camera, off screen, zero extent)
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
        imin = min(imin, vvr_floor_int(ic - 0.01f));
        imax = max(imax, vvr_ceil_int(ic + 0.01f));
        jmin = min(jmin, vvr_floor_int(jc - 0.01f));
        jmax = max(jmax, vvr_ceil_int(jc + 0.01f));
    }
    // no point of a face wholly behind the camera plane is on any ray
    if (all_behind) return false;
    if (some_behind) {
        *box = make_int4(0, c.width - 1, 0, c.height - 1);
        return true;
    }
    if (imax < 0 || imin > c.width - 1 || jmax < 0 || jmin > c.height - 1)
        return false;
    *box = make_int4(max(imin, 0), min(imax, c.width - 1), max(jmin, 0),
                     min(jmax, c.height - 1));
    return true;
}

static __global__ void vvr_raster_count_kernel(VvrFaces F, VvrRasterCam c,
                                               long long* __restrict__ cnt,
                                               int4* __restrict__ boxes) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F.n) return;
    int4 b = make_int4(0, -1, 0, -1);
    long long n = 0;
    if (vvr_raster_box(F, f, c, &b)) {
        n = (long long)(b.y / VVR_TKX - b.x / VVR_TKX + 1)
            * (long long)(b.w / VVR_TKY - b.z / VVR_TKY + 1);
    }
    cnt[f] = n;
    boxes[f] = b;
}

// The oracle's cell along axis u at the moment the ray crosses a plane of
// axis a at t_a: its DDA is the merge of the per-axis crossing sequences
// t = (bound - o) * (1/d), ties stepped z, then y, then x, so a u-crossing
// at t_u comes first iff t_u < t_a, or t_u == t_a and u > a (u_first).
// floor(o_u + d_u * t_a) is that cell except within rounding of a u-plane;
// the loop moves it until the crossings into and out of it agree.
static __device__ int vvr_cell_at(float o_u, float d_u, float t_a,
                                  bool u_first) {
    int c = vvr_floor_int(o_u + d_u * t_a);
    if (d_u == 0.0f) return c;
    const int c0 = vvr_floor_int(o_u);
    const float inv = 1.0f / d_u;
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

static __global__ void vvr_raster_frag_kernel(
        VvrFaces F, VvrRasterCam c, const float* __restrict__ d,
        const long long* __restrict__ off, const int4* __restrict__ boxes,
        const long long* __restrict__ total_p, unsigned* __restrict__ keys) {
    const long long total = *total_p;
    const int lane = threadIdx.x & 31;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long item = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                          >> 5;
         item < total; item += nwarps) {
        const int f = vvr_item_face(off, F.n, item);
        const int4 b = boxes[f];
        const long long li = item - off[f];
        const int ti0 = b.x / VVR_TKX;
        const int tw = b.y / VVR_TKX - ti0 + 1;
        const int tj0 = b.z / VVR_TKY;
        const int i = (ti0 + (int)(li % tw)) * VVR_TKX + (lane & 7);
        const int j = (tj0 + (int)(li / tw)) * VVR_TKY + (lane >> 3);
        if (i < b.x || i > b.y || j < b.z || j > b.w) continue;
        const int ax = __ldg(F.axis + f);
        const int vx = __ldg(F.vx + f), vy = __ldg(F.vy + f),
                  vz = __ldg(F.vz + f);
        const float pf = (float)((ax == 0 ? vx : (ax == 1 ? vy : vz))
                                 + __ldg(F.sgn + f));
        const int pix = j * c.width + i;
        const float dx = __ldg(d + 3 * pix), dy = __ldg(d + 3 * pix + 1),
                    dz = __ldg(d + 3 * pix + 2);
        const float d_a = vvr_sel3(ax, dx, dy, dz);
        const float o_a = vvr_sel3(ax, c.px, c.py, c.pz);
        const float inv_a = d_a == 0.0f ? VVR_BIG_T : 1.0f / d_a;
        const float t = (pf - o_a) * inv_a;
        if (!(t > 0.0f)) continue;
        // in-plane axes (u, v): axis 0 -> (y, z), 1 -> (x, z), 2 -> (x, y)
        const int u_c = ax == 0 ? vvr_cell_at(c.py, dy, t, true)
                                : vvr_cell_at(c.px, dx, t, false);
        const int v_c = ax == 2 ? vvr_cell_at(c.py, dy, t, false)
                                : vvr_cell_at(c.pz, dz, t, true);
        const int u_0 = ax == 0 ? vy : vx, v_0 = ax == 2 ? vy : vz;
        if (u_c >= u_0 && u_c < u_0 + __ldg(F.eu + f) && v_c >= v_0
            && v_c < v_0 + __ldg(F.ev + f)) {
            atomicMin(keys + pix, vvr_axis_key(t, ax));
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
    // scratch: offsets (n_faces), block sums (ceil(n_faces/1024)), total
    long long* off = (long long*)scratch;
    long long* bsum = off + n_faces;
    long long* total = bsum + (n_faces + 1023) / 1024;
    cudaMemsetAsync(keys, 0xFF, (size_t)width * height * 4, st);
    if (n_faces > 0) {
        vvr_raster_count_kernel<<<vvr_blocks(n_faces, 256), 256, 0, st>>>(
            F, c, off, (int4*)boxes);
    }
    vvr_exclusive_scan(off, n_faces, bsum, total, st);
    vvr_raster_frag_kernel<<<vvr_item_blocks(), 256, 0, st>>>(
        F, c, (const float*)d, off, (const int4*)boxes, total,
        (unsigned*)keys);
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
