// The nearest cloud texel along a ray, shared by K2 (shade.cu: the miss
// shader along the camera ray, the hard shadow's cloud toward the sun) and
// K14 (softshadow.cu: each soft-shadow sample's cloud along its jittered
// direction). Port of vvr_tpu/ops/sky.py:243-258 (`clouds_idx_soa` with
// its fetch).
#pragma once

#include "common.cuh"

#define VVR_CLOUD_HEIGHT 800.0f
#define VVR_CLOUD_EXTENT 8000.0f

// nearest cloud texel along (d from p) on the cloud plane
// (sky.py:243-258); rgba = 0 where the plane is not ahead or off-texture
static __device__ __forceinline__ float4 vvr_sample_clouds(
        const float* __restrict__ clouds, int r, float dx, float dy, float dz,
        float px, float py, float pz) {
    const float denom = -dy;
    const float t = -(VVR_CLOUD_HEIGHT - py)
                    / (fabsf(denom) < 1e-4f ? 1.0f : denom);
    const float u = (px + t * dx) / VVR_CLOUD_EXTENT + 0.5f;
    const float v = (pz + t * dz) / VVR_CLOUD_EXTENT + 0.5f;
    const bool valid = fabsf(denom) > 1e-4f && t >= 0.0f && u >= 0.0f
                       && u <= 1.0f && v >= 0.0f && v <= 1.0f;
    if (!valid) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int iu = vvr_trunc_clip(u * (float)r, 0, r - 1);
    const int iv = vvr_trunc_clip(v * (float)r, 0, r - 1);
    return __ldg(reinterpret_cast<const float4*>(clouds) + iv * r + iu);
}
