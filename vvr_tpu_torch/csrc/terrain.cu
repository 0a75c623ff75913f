// K24 height_field: the terrain's surface height h(x, z) for every column,
// one thread per column. Replaces the jitted vvr_tpu/world/generator.py:29
// `_height_field` with vvr_tpu/ops/noise.py:88 `fbm2` over :61 `perlin2`
// (world/generator.py `height_field` wraps it). Column i = z * size + x
// writes out[i], the (size, size) float32 field in [z, x] order.
//
// Bit for bit the plain version (world/generator.py height_field_plain,
// ops/noise.py fbm2_sum and perlin2_lerp), which rounds as XLA's jit does
// on the CPU. The library is compiled with -fmad=false, so each product
// and sum below rounds on its own, and __fmaf_rn stands exactly where the
// plain version calls _fma: each corner's gradient dot, the fade's inner
// polynomial, the three lerps, each octave's product into the sum (the
// first two plain octaves as fma(lerp0, SQRT2, lerp1 * c1)), the Billow
// fold, the amplitude and offset, the terrace distance and the detail.
// Every division of the JAX function is a multiply by the float32
// reciprocal the wrapper passes (world/generator.py terrain_constants), as
// XLA folds it; nothing divides here.
//
// What bounds it on an H100: its operations, about 45 float32 operations
// and 4 lattice hashes (about 20 integer operations each) a corner an
// octave, 9 octaves a column; it writes 4 bytes a column.
#include "common.cuh"

// perlin2's output scale, float32(1.41421356)
#define VVR_SQRT2 1.41421354f

struct VvrTerrain {
    int size, seed, octaves, detail_octaves;
    float freq, amplitude, offset, step, inv_step, inv_half_step;
    float detail_freq, inv_detail_norm, detail_scale;
};

// perlin2 before its scale by VVR_SQRT2 (ops/noise.py perlin2_lerp);
// swap11 contracts the (1, 1) corner's other product
static __device__ __forceinline__ float vvr_perlin2_lerp(float x, float y,
                                                         uint32_t sk,
                                                         bool swap11) {
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int ix = (int)x0, iy = (int)y0;
    float n[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int ox = c & 1, oy = c >> 1;
        float gx, gy;
        vvr_grad2(vvr_lattice_hash2(ix + ox, iy + oy, sk), &gx, &gy);
        const float dx = fx - (float)ox, dy = fy - (float)oy;
        n[c] = (swap11 && c == 3) ? __fmaf_rn(gy, dy, gx * dx)
                                  : __fmaf_rn(gx, dx, gy * dy);
    }
    const float u = fx * fx * fx
                    * __fmaf_rn(fx, __fmaf_rn(fx, 6.0f, -15.0f), 10.0f);
    const float v = fy * fy * fy
                    * __fmaf_rn(fy, __fmaf_rn(fy, 6.0f, -15.0f), 10.0f);
    const float nx0 = __fmaf_rn(u, n[1] - n[0], n[0]);
    const float nx1 = __fmaf_rn(u, n[3] - n[2], n[2]);
    return __fmaf_rn(v, nx1 - nx0, nx0);
}

// fbm2's octave sum before the norm (ops/noise.py fbm2_sum), lacunarity 2
// and persistence 0.5: each octave's frequency is the first's times a
// power of two, as exact in float32 as the plain version's float64 one
static __device__ __forceinline__ float vvr_fbm2_sum(float x, float y,
                                                     int octaves, float freq,
                                                     int seed, bool billow,
                                                     bool swap11) {
    float total = 0.0f, first = 0.0f, amp = 1.0f;
    for (int i = 0; i < octaves; ++i) {
        const float lerp = vvr_perlin2_lerp(x * freq, y * freq,
                                            vvr_seed_key(seed + i),
                                            swap11 && i == 0);
        if (billow) {
            const float n = __fmaf_rn(fabsf(lerp * VVR_SQRT2), 2.0f, -1.0f);
            total = i == 0 ? n : __fmaf_rn(n, amp, total);
        } else if (i == 0) {
            first = lerp;
            total = lerp * VVR_SQRT2;
        } else if (i == 1) {
            total = __fmaf_rn(first, VVR_SQRT2, lerp * (VVR_SQRT2 * amp));
        } else {
            total = __fmaf_rn(lerp, VVR_SQRT2 * amp, total);
        }
        amp *= 0.5f;
        freq *= 2.0f;
    }
    return total;
}

__global__ void __launch_bounds__(256)
vvr_height_field_kernel(VvrTerrain t, float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)t.size * t.size) return;
    const float x = (float)(int)(i % t.size);
    const float z = (float)(int)(i / t.size);
    const float total = vvr_fbm2_sum(x, z, t.octaves, t.freq, t.seed, false,
                                     true);
    const float height = __fmaf_rn(total, t.amplitude, t.offset);
    const float stepped = floorf(height * t.inv_step) * t.step;
    const float diff = __fmaf_rn(fabsf(height - stepped), t.inv_half_step,
                                 -0.5f);
    const float detail = vvr_fbm2_sum(x, z, t.detail_octaves, t.detail_freq,
                                      t.seed + 101, true, false)
                         * t.inv_detail_norm;
    out[i] = __fmaf_rn(-diff * detail, t.detail_scale, stepped);
}

extern "C" int vvr_height_field(void* out, int size, int seed, int octaves,
                                float freq, float amplitude, float offset,
                                float step, float inv_step,
                                float inv_half_step, int detail_octaves,
                                float detail_freq, float inv_detail_norm,
                                float detail_scale, void* stream) {
    if (size <= 0 || size > 46340 || octaves < 1 || detail_octaves < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const VvrTerrain t = {size, seed, octaves, detail_octaves, freq,
                          amplitude, offset, step, inv_step, inv_half_step,
                          detail_freq, inv_detail_norm, detail_scale};
    const long long n = (long long)size * size;
    vvr_height_field_kernel<<<vvr_blocks(n, 256), 256, 0,
                              (cudaStream_t)stream>>>(t, (float*)out);
    return (int)cudaGetLastError();
}
