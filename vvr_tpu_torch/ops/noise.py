"""Gradient and simplex noise in torch — world generation and the cloud layer.

Counterpart of vvr_tpu/ops/noise.py (`perlin2`, `fbm2`, `sdnoise2`,
`snoise2`), the same formulas in the same op order. The lattice hash is
uint32 arithmetic with wrapping multiplies. torch has no `>>` for uint32 on
the CPU, so words are held as int64 masked to 32 bits, and every multiply
is split in 16-bit halves so that no int64 product overflows. The CUDA copy
(csrc/common.cuh) uses native uint32.
"""

from __future__ import annotations

import torch

F32 = torch.float32
MASK32 = 0xFFFFFFFF

_GX = (1.0, -1.0, 1.0, -1.0, 0.70710678, -0.70710678, 0.70710678,
       -0.70710678)
_GY = (0.70710678, 0.70710678, -0.70710678, -0.70710678, 1.0, 1.0, -1.0,
       -1.0)


def _u32(x):
    """Integer tensor -> its uint32 bit pattern, held in int64."""
    return x.to(torch.int64) & MASK32


def _mul32(a, c: int):
    """(a * c) mod 2**32 for `a` in [0, 2**32) held in int64, constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _hash_u32(s):
    """H. Schechter & R. Bridson uint hash (shaders/hash.slang:7-16)."""
    s = s ^ 2747636419
    s = _mul32(s, 2654435769)
    s = s ^ (s >> 16)
    s = _mul32(s, 2654435769)
    s = s ^ (s >> 16)
    return _mul32(s, 2654435769)


def _lattice_hash2(ix, iy, seed: int):
    sk = (seed * 0x27D4EB2F + 0x165667B1) & MASK32
    return _hash_u32(_mul32(_u32(ix), 0x9E3779B1)
                     ^ _mul32(_u32(iy), 0x85EBCA77) ^ sk)


def _grad2(h):
    """Map hash -> unit gradient from 8 directions (cheap, no trig)."""
    idx = (h >> 28) & 7
    gx = torch.tensor(_GX, dtype=F32, device=h.device)
    gy = torch.tensor(_GY, dtype=F32, device=h.device)
    return gx[idx], gy[idx]


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin2(x, y, seed: int = 0):
    """2D Perlin gradient noise, output approximately [-1, 1]."""
    x = x.to(F32)
    y = y.to(F32)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)

    def dot_grad(ox, oy):
        gx, gy = _grad2(_lattice_hash2(ix + ox, iy + oy, seed))
        return gx * (fx - ox) + gy * (fy - oy)

    u = _fade(fx)
    v = _fade(fy)
    n00 = dot_grad(0, 0)
    n10 = dot_grad(1, 0)
    n01 = dot_grad(0, 1)
    n11 = dot_grad(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return 1.41421356 * (nx0 + v * (nx1 - nx0))


def fbm2(x, y, octaves: int, frequency: float, seed: int = 0,
         lacunarity: float = 2.0, persistence: float = 0.5,
         billow: bool = False):
    """Fractal Brownian motion over perlin2. `billow=True` gives the Billow
    variant (per-octave abs()*2-1) the reference uses for terrain detail."""
    x = x.to(F32)
    y = y.to(F32)
    total = torch.zeros_like(x)
    amp = 1.0
    freq = frequency
    norm = 0.0
    for i in range(octaves):
        n = perlin2(x * freq, y * freq, seed + i)
        if billow:
            n = torch.abs(n) * 2.0 - 1.0
        total = total + n * amp
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


_F2 = 0.36602540378  # (sqrt(3)-1)/2
_G2 = 0.21132486540  # (3-sqrt(3))/6


def sdnoise2(x, y, seed: int = 0):
    """Simplex noise with analytic derivatives: returns (value, dx, dy)."""
    x = x.to(F32)
    y = y.to(F32)
    s = (x + y) * _F2
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * _G2
    x0 = x - (i - t)
    y0 = y - (j - t)
    i1 = (x0 > y0).to(F32)
    j1 = 1.0 - i1
    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    x2 = x0 - 1.0 + (2.0 * _G2)
    y2 = y0 - 1.0 + (2.0 * _G2)
    ii = i.to(torch.int64)
    jj = j.to(torch.int64)
    i1i = i1.to(torch.int64)
    j1i = j1.to(torch.int64)

    val = torch.zeros_like(x)
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(x)
    for cx, cy, oi, oj in ((x0, y0, 0, 0), (x1, y1, i1i, j1i),
                           (x2, y2, 1, 1)):
        tt = torch.clamp(0.5 - cx * cx - cy * cy, min=0.0)
        t2 = tt * tt
        t4 = t2 * t2
        gx, gy = _grad2(_lattice_hash2(ii + oi, jj + oj, seed))
        gdot = gx * cx + gy * cy
        val = val + t4 * gdot
        t3 = t2 * tt
        dx = dx + (-8.0 * t3 * cx * gdot + t4 * gx)
        dy = dy + (-8.0 * t3 * cy * gdot + t4 * gy)
    return 40.0 * val, 40.0 * dx, 40.0 * dy


def snoise2(x, y, seed: int = 0):
    """Plain simplex value noise in ~[-1,1] (shader `snoise(float2)`)."""
    return sdnoise2(x, y, seed)[0]
