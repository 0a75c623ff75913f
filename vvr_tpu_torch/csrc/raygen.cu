// K13 generate_rays: the camera's primary rays. Replaces
// vvr_tpu/ops/raygen.py:37-51 `generate_rays` (ops/raygen.py wraps it).
// Pixel i = row * width + col, row 0 at the top of the image, gets its
// origin o[i] (the camera position) and its unit direction d[i], both
// (N, 3) float32, row-major from the top-left as the plain version lays
// them out.
//
// Bit-exact against the plain version (ops/raygen.py): every operation is
// the plain version's, in its order, correctly rounded (-fmad=false, no
// fast math): u = (col + 0.5) / width * 2 - 1 and v = 1 - (row + 0.5) /
// height * 2 as two divisions (not a multiply by a reciprocal), the
// direction forward + (u tx) right + (v ty) up summed left to right, the
// norm sqrtf((x x + y y) + z z) and an IEEE division by it. The camera
// basis and the frustum's tx and ty come in as float arguments (the
// wrapper computes ty as the plain version does), so a frame copies
// nothing to the card before the launch.
//
// What bounds it on an H100: the 24 bytes a pixel it writes (49.8 MB at
// 1920x1080, 14.9 us at 3.35 TB/s); each pixel's arithmetic (two
// divisions, a sqrt, a third division for each component) hides under the
// stores. A thread a pixel storing its six floats one by one, 12 bytes
// apart, left each warp's store a dozen sectors a third full and took
// twice the bound (30.7-30.9 us on an H100 80GB HBM3 at 700 W, PERF.md
// section 6). So a block owns a span of VVR_RAY_SPAN pixels, each thread
// VVR_RAY_PIX of them: it stages the span's directions in shared memory
// and writes the span of d whole, as 16-byte stores with neighbouring
// threads on neighbouring addresses; o needs no staging, its float4s
// repeat with period 3, (px, py, pz, px), (py, pz, px, py), (pz, px, py,
// pz). A span starts at a multiple of 1024 pixels, so its floats start
// 16-byte aligned; the floats past the last whole float4 of the last span
// take scalar stores. The stores keep the default cache policy (K9 and
// K12 read d next): 18.5 us on that card, 80% of the bound; a TMA bulk
// store of d and streaming stores measured no faster (PERF.md section
// 6).
#include "common.cuh"

#define VVR_RAY_THREADS 256
#define VVR_RAY_PIX 4
#define VVR_RAY_SPAN (VVR_RAY_THREADS * VVR_RAY_PIX)

struct VvrCamera {
    float px, py, pz;   // position
    float rx, ry, rz;   // right
    float ux, uy, uz;   // up
    float fx, fy, fz;   // forward
    float tx, ty;       // tan of the half field of view, across and up
};

__global__ void __launch_bounds__(VVR_RAY_THREADS)
vvr_generate_rays_kernel(VvrCamera c, int width, int height,
                         float* __restrict__ o, float* __restrict__ d) {
    __shared__ __align__(16) float sd[3 * VVR_RAY_SPAN];
    const int base = blockIdx.x * VVR_RAY_SPAN;
    const int cnt = min(VVR_RAY_SPAN, width * height - base);
#pragma unroll
    for (int k = 0; k < VVR_RAY_PIX; ++k) {
        const int q = threadIdx.x + k * VVR_RAY_THREADS;
        if (q < cnt) {
            const int i = base + q;
            const int row = i / width;
            const int col = i - row * width;
            const float u = ((float)col + 0.5f) / (float)width * 2.0f - 1.0f;
            const float v = 1.0f - ((float)row + 0.5f) / (float)height * 2.0f;
            const float ut = u * c.tx, vt = v * c.ty;
            const float x = (c.fx + ut * c.rx) + vt * c.ux;
            const float y = (c.fy + ut * c.ry) + vt * c.uy;
            const float z = (c.fz + ut * c.rz) + vt * c.uz;
            const float n = sqrtf((x * x + y * y) + z * z);
            sd[3 * q] = x / n;       // stride 3 words: no bank conflict
            sd[3 * q + 1] = y / n;
            sd[3 * q + 2] = z / n;
        }
    }
    const int nf = 3 * cnt;          // the span's floats
    const int nv = nf >> 2;          // its whole float4s
    float* dd = d + 3LL * base;
    float* od = o + 3LL * base;
    __syncthreads();
    const float4* s4 = reinterpret_cast<const float4*>(sd);
    float4* d4 = reinterpret_cast<float4*>(dd);
    for (int f = threadIdx.x; f < nv; f += VVR_RAY_THREADS) d4[f] = s4[f];
    for (int e = 4 * nv + threadIdx.x; e < nf; e += VVR_RAY_THREADS) {
        dd[e] = sd[e];
    }
    // o: the span starts at float4 3 * base / 4, a multiple of 3, so float4
    // f of the span is pattern f % 3; a thread's next float4 is 256 further,
    // the next pattern (256 % 3 == 1): the three rotate in registers
    const float4 p0 = make_float4(c.px, c.py, c.pz, c.px);
    const float4 p1 = make_float4(c.py, c.pz, c.px, c.py);
    const float4 p2 = make_float4(c.pz, c.px, c.py, c.pz);
    static_assert(VVR_RAY_THREADS % 3 == 1, "o's float4s rotate by one");
    const int m0 = threadIdx.x % 3;
    float4 q0 = m0 == 0 ? p0 : (m0 == 1 ? p1 : p2);
    float4 q1 = m0 == 0 ? p1 : (m0 == 1 ? p2 : p0);
    float4 q2 = m0 == 0 ? p2 : (m0 == 1 ? p0 : p1);
    float4* o4 = reinterpret_cast<float4*>(od);
    for (int f = threadIdx.x; f < nv; f += VVR_RAY_THREADS) {
        o4[f] = q0;
        const float4 t = q0;
        q0 = q1;
        q1 = q2;
        q2 = t;
    }
    for (int e = 4 * nv + threadIdx.x; e < nf; e += VVR_RAY_THREADS) {
        const int m = e % 3;
        od[e] = m == 0 ? c.px : (m == 1 ? c.py : c.pz);
    }
}

// o, d: (width * height, 3) float32, 16-byte aligned
extern "C" int vvr_generate_rays(float px, float py, float pz, float rx,
                                 float ry, float rz, float ux, float uy,
                                 float uz, float fx, float fy, float fz,
                                 float tx, float ty, int width, int height,
                                 void* o, void* d, void* stream) {
    const VvrCamera c = {px, py, pz, rx, ry, rz, ux, uy, uz,
                         fx, fy, fz, tx, ty};
    const long long n = (long long)width * height;
    if (width <= 0 || height <= 0 || n > 0x7FFFFFFFLL / 3
            || (((uintptr_t)o | (uintptr_t)d) & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    vvr_generate_rays_kernel<<<vvr_blocks(n, VVR_RAY_SPAN), VVR_RAY_THREADS,
                               0, (cudaStream_t)stream>>>(
        c, width, height, (float*)o, (float*)d);
    return (int)cudaGetLastError();
}
