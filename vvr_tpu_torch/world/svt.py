"""The density field of the filtered ambient occlusion, and its trilinear
sample.

Counterpart of vvr_tpu/world/svt.py:21 `density_from_occupancy` and :26
`sample_density_trilinear`: a dense u8 field [z, y, x], 255 where the voxel
is solid (the alpha channel of the reference's sparse voxel texture), read
through a linear sampler with texel centres at +0.5 and clamp to edge. The
frame reads it one voxel off the surface along the normal (K15,
csrc/bounce.cu, ops/bounce.py); on the card the field is 16 MiB at 256^3
and stays in the L2 cache.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def density_from_occupancy(occ, device="cuda") -> torch.Tensor:
    """Dense u8 density (S, S, S) [z, y, x], 255 where `occ` is solid, on
    `device`."""
    occ = np.asarray(occ, bool)
    if occ.ndim != 3 or len(set(occ.shape)) != 1:
        raise ValueError(f"occupancy must be (S, S, S), got {occ.shape}")
    return torch.from_numpy(occ.astype(np.uint8) * np.uint8(255)).to(device)


def sample_density_trilinear(density: torch.Tensor, pos: torch.Tensor):
    """Trilinear density in [0, 1] at world positions `pos` (..., 3) float32:
    texel centres at +0.5, clamp to edge, each tap's u8 over 255, the
    interpolation along x, then y, then z, as the JAX version forms it."""
    s = density.shape[0]
    p = pos.to(F32) - 0.5
    p0 = torch.floor(p)
    f = p - p0
    i0 = p0.to(torch.int64)
    flat = density.reshape(-1)

    def tap(dx, dy, dz):
        x = torch.clamp(i0[..., 0] + dx, 0, s - 1)
        y = torch.clamp(i0[..., 1] + dy, 0, s - 1)
        z = torch.clamp(i0[..., 2] + dz, 0, s - 1)
        return flat[(z * s + y) * s + x].to(F32) / 255.0

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = tap(0, 0, 0) * (1 - fx) + tap(1, 0, 0) * fx
    c10 = tap(0, 1, 0) * (1 - fx) + tap(1, 1, 0) * fx
    c01 = tap(0, 0, 1) * (1 - fx) + tap(1, 0, 1) * fx
    c11 = tap(0, 1, 1) * (1 - fx) + tap(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
