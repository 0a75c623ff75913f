"""Shadertoy float-hash family (Dave Hoskins) in torch.

Counterpart of vvr_tpu/utils/hash.py for the functions the slice needs.
Every formula keeps the JAX op order: these chains amplify a one-ulp
difference to O(1) through `fract`, so the three-term sums are written
`(a + b) + c`, left to right, the order the JAX reductions take, and
`per_block_unique_colour` also rounds where XLA's jit rounds (see there).
The CUDA copies live in csrc/common.cuh, compiled without FMA contraction.
"""

from __future__ import annotations

import numpy as np
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


def hash13_soa(x, y, z):
    """hash13 on separate (N,) channels -> (N,), as the JAX package's
    jitted frame rounds it (the mirror decision, frame.py:241-251): XLA
    contracts the two sums of its three-term dot product into FMAs,
    fma(pz, px + 33.33, fma(py, py + 33.33, px * (pz + 33.33))) (equal to
    a jitted hash13_soa on every 8^3 group of a 256^3 world; the op-by-op
    sum differs on about a fifth of them). csrc/bounce.cu places
    __fmaf_rn at the same points."""
    px = _fract(x * 0.1031)
    py = _fract(y * 0.1031)
    pz = _fract(z * 0.1031)
    d = _fma(pz, px + 33.33, _fma(py, py + 33.33, px * (pz + 33.33)))
    px = px + d
    py = py + d
    pz = pz + d
    return _fract((px + py) * pz)


def light_colours(count: int) -> np.ndarray:
    """(count, 3) float32: the colour of point light li, hash33(li *
    3.21312 in all three channels) * 0.3 (frame.py:514-519), as the JAX
    frame has it. Its input is a constant there, so XLA folds the hash at
    compile time, and its constant folder sums the dot product in float64
    before rounding (equal to a jitted copy for li < 30; the float32 sum
    differs at li = 1 and 3)."""
    out = np.zeros((count, 3), np.float32)
    k = np.array([0.1031, 0.1030, 0.0973], np.float32)
    c = np.float32(33.33)
    for li in range(count):
        v = np.full(3, li * 3.21312, np.float32) * k
        p = v - np.floor(v)
        t = p * (p[[1, 0, 2]] + c)
        d = np.float32(t.astype(np.float64).sum())
        q = p + d
        h = (q[[0, 0, 1]] + q[[1, 0, 0]]) * q[[2, 1, 0]]
        out[li] = (h - np.floor(h)) * np.float32(0.3)
    return out


def _fma(a, b, c):
    """float32 a*b + c with one rounding, as an FMA gives it. Each of a, b,
    c is a float32 tensor or a Python number that is a float32 value (a or
    b a tensor). The product of two floats is exact in float64, so only
    the float64 sum rounds before the float32 one. That double rounding
    differs from one FMA rounding only where the float64 sum lands exactly
    halfway between two floats and was itself inexact: there the sum steps
    one float64 ulp toward the exact one (its error from TwoSum), so the
    float32 rounding is the FMA's on the CPU and on the card alike. (The
    halfway test reads the float64 bits as a float32 normal number's.)"""
    a, b, c = (v.double() if torch.is_tensor(v) else float(v)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    halfway = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.copysign(torch.full_like(s, torch.inf), err)
    s = torch.where(halfway & (err != 0), torch.nextafter(s, toward), s)
    return s.to(F32)


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
