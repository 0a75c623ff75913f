// K13 generate_rays: the camera's primary rays, one thread per pixel.
// Replaces vvr_tpu/ops/raygen.py:37-51 `generate_rays` (ops/raygen.py wraps
// it). Pixel i = row * width + col, row 0 at the top of the image, writes
// its origin o[i] (the camera position) and its unit direction d[i], both
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
// 1920x1080); each thread's arithmetic (two divisions, a sqrt, a third
// division for each component) hides under the stores.
#include "common.cuh"

struct VvrCamera {
    float px, py, pz;   // position
    float rx, ry, rz;   // right
    float ux, uy, uz;   // up
    float fx, fy, fz;   // forward
    float tx, ty;       // tan of the half field of view, across and up
};

__global__ void __launch_bounds__(256)
vvr_generate_rays_kernel(VvrCamera c, int width, int height,
                         float* __restrict__ o, float* __restrict__ d) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width * height) return;
    const int row = i / width;
    const int col = i - row * width;
    const float u = ((float)col + 0.5f) / (float)width * 2.0f - 1.0f;
    const float v = 1.0f - ((float)row + 0.5f) / (float)height * 2.0f;
    const float ut = u * c.tx, vt = v * c.ty;
    const float x = (c.fx + ut * c.rx) + vt * c.ux;
    const float y = (c.fy + ut * c.ry) + vt * c.uy;
    const float z = (c.fz + ut * c.rz) + vt * c.uz;
    const float n = sqrtf((x * x + y * y) + z * z);
    o[3 * i] = c.px;
    o[3 * i + 1] = c.py;
    o[3 * i + 2] = c.pz;
    d[3 * i] = x / n;
    d[3 * i + 1] = y / n;
    d[3 * i + 2] = z / n;
}

extern "C" int vvr_generate_rays(float px, float py, float pz, float rx,
                                 float ry, float rz, float ux, float uy,
                                 float uz, float fx, float fy, float fz,
                                 float tx, float ty, int width, int height,
                                 void* o, void* d, void* stream) {
    const VvrCamera c = {px, py, pz, rx, ry, rz, ux, uy, uz,
                         fx, fy, fz, tx, ty};
    const long long n = (long long)width * height;
    if (width <= 0 || height <= 0 || n > 0x7FFFFFFFLL / 3) {
        return (int)cudaErrorInvalidValue;
    }
    vvr_generate_rays_kernel<<<vvr_blocks(n, 256), 256, 0,
                               (cudaStream_t)stream>>>(
        c, width, height, (float*)o, (float*)d);
    return (int)cudaGetLastError();
}
