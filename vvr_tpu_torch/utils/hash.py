"""Shadertoy float-hash family (Dave Hoskins) in torch.

Counterpart of vvr_tpu/utils/hash.py for the functions the slice needs.
Every formula keeps the JAX op order: these chains amplify a one-ulp
difference to O(1) through `fract`, so the three-term sums are written
`(a + b) + c`, left to right, the order the JAX reductions take, and
`per_block_unique_colour` also rounds where XLA's jit rounds (see there).
The CUDA copies live in csrc/common.cuh, compiled without FMA contraction.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _fract(x):
    return x - torch.floor(x)


def hash12(p):
    """p: (..., 2) -> (...)"""
    p3 = _fract(torch.stack([p[..., 0], p[..., 1], p[..., 0]], -1)
                * 0.1031)
    t = p3 * (p3[..., [1, 2, 0]] + 33.33)
    d = (t[..., 0] + t[..., 1]) + t[..., 2]
    p3 = p3 + d[..., None]
    return _fract((p3[..., 0] + p3[..., 1]) * p3[..., 2])


def hash33(p3):
    """p3: (..., 3) -> (..., 3). Matches shaders/hash.slang:102-108."""
    k = torch.tensor([0.1031, 0.1030, 0.0973], dtype=F32, device=p3.device)
    p3 = _fract(p3 * k)
    t = p3 * (p3[..., [1, 0, 2]] + 33.33)
    d = (t[..., 0] + t[..., 1]) + t[..., 2]
    p3 = p3 + d[..., None]
    return _fract((p3[..., [0, 0, 1]] + p3[..., [1, 0, 0]])
                  * p3[..., [2, 1, 0]])


def hash33_soa(x, y, z):
    """hash33 on separate (N,) channels -> (r, g, b) flat tensors."""
    px = _fract(x * 0.1031)
    py = _fract(y * 0.1030)
    pz = _fract(z * 0.0973)
    d = (px * (py + 33.33) + py * (px + 33.33)) + pz * (pz + 33.33)
    px = px + d
    py = py + d
    pz = pz + d
    return (_fract((px + py) * pz), _fract((px + px) * py),
            _fract((py + px) * px))


def _fma(a, b, c):
    """float32 a*b + c with one rounding, as an FMA gives it. The product
    of two floats is exact in float64, so only the float64 sum rounds
    before the float32 one; that double rounding differs from a true FMA
    only when the float64 sum lands exactly halfway between two floats."""
    return (a.double() * b.double() + c.double()).to(F32)


def sqrt32(x):
    """Correctly rounded float32 sqrt. torch's vectorized CPU sqrt is off
    by one ulp on some inputs; a float64 sqrt rounded to float32 is exact
    (float64 carries more than 2*24+2 bits), as the card's sqrtf is."""
    return torch.sqrt(x.double()).to(F32)


def per_block_unique_colour(block_pos):
    """normalize(hash33(block_pos * k)) (reference other.slang:10-13), as
    the JAX package computes it inside its jitted frame: XLA contracts the
    two sums of hash33's dot product and the two sums of the norm into
    FMAs (checked equal on 20,000 random blocks). The hash turns that
    one-ulp difference into a different colour for about a quarter of all
    blocks, and the golden frames carry the contracted colours, so the
    port contracts the same four sums (csrc/common.cuh uses __fmaf_rn)."""
    k = torch.tensor([23.231, -435.4354, 9412.1], dtype=F32,
                     device=block_pos.device)
    c = torch.tensor([0.1031, 0.1030, 0.0973], dtype=F32,
                     device=block_pos.device)
    p = _fract(block_pos.to(F32) * k * c)
    px, py, pz = p.unbind(-1)
    d = _fma(pz, pz + 33.33, _fma(py, px + 33.33, px * (py + 33.33)))
    px, py, pz = px + d, py + d, pz + d
    col = torch.stack([_fract((px + py) * pz), _fract((px + px) * py),
                       _fract((py + px) * px)], -1)
    c0, c1, c2 = col.unbind(-1)
    n = sqrt32(_fma(c2, c2, _fma(c1, c1, c0 * c0)))
    return col / torch.clamp(n, min=1e-12)[..., None]
