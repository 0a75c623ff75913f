"""Gradient and simplex noise in torch — world generation and the cloud layer.

Counterpart of vvr_tpu/ops/noise.py (`perlin2`, `fbm2`, `sdnoise2`,
`snoise2`, and `snoise3` of the wavy mirror reflections), the same
formulas. `sdnoise2`, `snoise2` and `snoise3` keep the JAX op order;
`perlin2` and `fbm2` round as the JAX functions do under jax.jit, the
form the JAX program runs them in (its height field is jitted): FMAs
where XLA on the CPU contracts and the reciprocals it folds (see
`perlin2_lerp` and `fbm2_sum`). The lattice hash is
uint32 arithmetic with wrapping multiplies. torch has no `>>` for uint32 on
the CPU, so words are held as int64 masked to 32 bits, and every multiply
is split in 16-bit halves so that no int64 product overflows. The CUDA copy
(csrc/common.cuh) uses native uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch.utils.hash import _fma

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


def _lattice_hash3(ix, iy, iz, seed: int):
    sk = (seed * 0x27D4EB2F + 0x165667B1) & MASK32
    return _hash_u32(_mul32(_u32(ix), 0x9E3779B1)
                     ^ _mul32(_u32(iy), 0x85EBCA77)
                     ^ _mul32(_u32(iz), 0xC2B2AE3D) ^ sk)


def _grad2(h):
    """Map hash -> unit gradient from 8 directions (cheap, no trig)."""
    idx = (h >> 28) & 7
    gx = torch.tensor(_GX, dtype=F32, device=h.device)
    gy = torch.tensor(_GY, dtype=F32, device=h.device)
    return gx[idx], gy[idx]


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


# perlin2's output scale as the float32 constant the JAX package uses
SQRT2 = float(np.float32(1.41421356))


def perlin2_lerp(x, y, seed: int = 0, swap11: bool = False):
    """perlin2 before its final scale by SQRT2, rounded as XLA's jit rounds
    it on the CPU: each corner's gradient dot is fma(gx, fx - ox, gy *
    (fy - oy)), the fade's inner polynomial fma(t, fma(t, 6, -15), 10),
    and the three lerps fma(u, b - a, a). `swap11` contracts the other
    product of the (1, 1) corner's dot, fma(gy, fy - 1, gx * (fx - 1)), as
    the jitted height field does in its first octave. csrc/terrain.cu
    places __fmaf_rn at the same points."""
    x = x.to(F32)
    y = y.to(F32)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)

    def dot_grad(ox, oy, swap=False):
        gx, gy = _grad2(_lattice_hash2(ix + ox, iy + oy, seed))
        dx, dy = fx - ox, fy - oy
        return _fma(gy, dy, gx * dx) if swap else _fma(gx, dx, gy * dy)

    def fade(t):
        return t * t * t * _fma(t, _fma(t, 6.0, -15.0), 10.0)

    u = fade(fx)
    v = fade(fy)
    n00 = dot_grad(0, 0)
    n10 = dot_grad(1, 0)
    n01 = dot_grad(0, 1)
    n11 = dot_grad(1, 1, swap11)
    nx0 = _fma(u, n10 - n00, n00)
    nx1 = _fma(u, n11 - n01, n01)
    return _fma(v, nx1 - nx0, nx0)


def perlin2(x, y, seed: int = 0):
    """2D Perlin gradient noise, output approximately [-1, 1], as the JAX
    package's jitted perlin2 computes it."""
    return perlin2_lerp(x, y, seed) * SQRT2


def octave_constants(octaves: int, frequency: float, lacunarity: float = 2.0,
                     persistence: float = 0.5):
    """Each octave's float32 (frequency, amplitude) of fbm2, and the norm,
    the sum of the amplitudes, as Python floats (the frequency and the
    norm summed in float64, as the JAX function does)."""
    out = []
    amp, freq, norm = 1.0, frequency, 0.0
    for _ in range(octaves):
        out.append((float(np.float32(freq)), amp))
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return out, norm


def fbm2_sum(x, y, octaves: int, frequency: float, seed: int = 0,
             lacunarity: float = 2.0, persistence: float = 0.5,
             billow: bool = False, swap11: bool = False):
    """fbm2's sum of octaves before the division by the norm, rounded as
    XLA's jit rounds it: it folds perlin2's SQRT2 into each octave's
    amplitude (a float32 product) and contracts each octave's product
    into the sum, fma(n, amp, total); the first two octaves of plain
    noise sum as fma(lerp0, SQRT2, lerp1 * SQRT2 * amp1). The Billow
    octave is fma(|lerp * SQRT2|, 2, -1). `swap11` goes to the first
    octave's perlin2_lerp."""
    x = x.to(F32)
    y = y.to(F32)
    consts, _ = octave_constants(octaves, frequency, lacunarity, persistence)
    total = first = None
    for i, (freq, amp) in enumerate(consts):
        lerp = perlin2_lerp(x * freq, y * freq, seed + i, swap11 and i == 0)
        if billow:
            n = _fma(torch.abs(lerp * SQRT2), 2.0, -1.0)
            total = n if total is None else _fma(
                n, float(np.float32(amp)), total)
            continue
        c = float(np.float32(SQRT2) * np.float32(amp))
        if i == 0:
            first = lerp
        elif i == 1:
            total = _fma(first, SQRT2, lerp * c)
        else:
            total = _fma(lerp, c, total)
    if total is None and first is not None:
        total = first * SQRT2
    return total


def reciprocal32(v: float) -> float:
    """1 / float32(v) in float32: XLA's jit turns a division by a constant
    into a multiply by this reciprocal."""
    return float(np.float32(1.0) / np.float32(v))


def fbm2(x, y, octaves: int, frequency: float, seed: int = 0,
         lacunarity: float = 2.0, persistence: float = 0.5,
         billow: bool = False):
    """Fractal Brownian motion over perlin2, as the JAX package's jitted
    fbm2 computes it: fbm2_sum times the reciprocal of the norm.
    `billow=True` gives the Billow variant (per-octave abs()*2-1) the
    reference uses for terrain detail."""
    _, norm = octave_constants(octaves, frequency, lacunarity, persistence)
    total = fbm2_sum(x, y, octaves, frequency, seed, lacunarity,
                     persistence, billow)
    return total * reciprocal32(norm)


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


# snoise3's 12 edge gradients
_G3 = ((1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0), (1, 0, 1), (-1, 0, 1),
       (1, 0, -1), (-1, 0, -1), (0, 1, 1), (0, -1, 1), (0, 1, -1),
       (0, -1, -1))


def snoise3(p, seed: int = 0):
    """3D gradient noise in ~[-1, 1] over (..., 3) points: the wave of the
    wavy mirror reflections (raytracer.slang:262). As in the JAX package,
    3D Perlin noise with the integer lattice hash and 12 edge gradients."""
    x, y, z = (p[..., k].to(F32) for k in range(3))
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    ix, iy, iz = (c.to(torch.int64) for c in (x0, y0, z0))
    g = torch.tensor(_G3, dtype=F32, device=x.device)

    def dot_grad(ox, oy, oz):
        h = _lattice_hash3(ix + ox, iy + oy, iz + oz, seed)
        gg = g[(h >> 28) % 12]
        return (gg[..., 0] * (fx - ox) + gg[..., 1] * (fy - oy)) \
            + gg[..., 2] * (fz - oz)

    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    n000, n100 = dot_grad(0, 0, 0), dot_grad(1, 0, 0)
    n010, n110 = dot_grad(0, 1, 0), dot_grad(1, 1, 0)
    n001, n101 = dot_grad(0, 0, 1), dot_grad(1, 0, 1)
    n011, n111 = dot_grad(0, 1, 1), dot_grad(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return 1.1547 * (nxy0 + w * (nxy1 - nxy0))
