"""Soft and pixelated sun shadows — kernel K14 `soft_shadow`
(csrc/softshadow.cu).

Replaces the soft-shadow branch of vvr_tpu/render/frame.py's bounce body
(`shadow_samples > 1`, :308-464) with its pixelated query point (:283-286)
for the slice (bounce 0, no mirrors). For each primary hit:

  1. the surface point (frame.py:212-238) and, with `pixelated`, its
     quarter-voxel floor floor(w * 4) / 4, the query point p;
  2. the shadow lanes: hits whose face turns toward the sun (:308-311);
  3. with the cone grids (`gate`), `soft_shadow_gate`: lanes whose every
     jittered direction is certainly shadowed (kh) or lit (km) trace
     nothing (:320-331);
  4. per sample s of S: the jittered direction and its strength
     (`sample_dir`, :339-354), the start p + sun * 0.004 + d_s * 0.05
     (`ray_start`, :356-359), the sample's hit: the grid's DDA of a
     shadow lane (after, with the gate on the jump grid,
     `near_walk_classify` against the cone gridC of p's texel, :391-425;
     the JAX frame walks no paged grid, :388), and its cloud alpha along
     d_s from p (:455-459);
  5. the factor, summed in sample order: shadow += where(hit, 0, strength
     * (1 - cloud alpha)) / S (:460-464). Lanes that trace nothing (hits
     facing away from the sun) still add their unshadowed terms, as the
     JAX frame does; lighting multiplies them by max(n.l, 0).

The factor (N,) f32 is 0 on a miss (the sky shades those pixels). The JAX
design's packed residue, its waves and its overflow net exist for static
shapes and are not ported. On the card a warp serves a tile of 32
pixels (`soft_pixels`) and then their (pixel, sample) items a lane each,
the pixels that trace first (`soft_lane_map`).

Rounding. The jitter's hash feeds `fract` three times, so one ulp moves a
sample direction by up to 0.01: the jitter rounds where XLA's jit on the
CPU rounds it (checked bit for bit against a jitted copy of frame.py:
339-354 on 20,000 surface points of the 64^3 world, s = 0..3,
tests/test_torch_softshadow.py): at s = 0 XLA drops the + 0 and folds
the two constant multiplies into one; at s > 0 `p * c1 + c2` is one FMA;
the hash's three-term dot product is two FMAs, the first fusing the y
term onto the x term's product for the hash's x and y channels and the x
term onto the y term's for its z channel (XLA evaluates the sum in two
fusions); `sun + t * 0.005` is an FMA, the
norm fma(z, z, fma(x, x, y * y)) and the strength's cosine
fma(z, sz, fma(x, sx, y * sy)); the start is
fma(d_s, 0.05, p + sun * 0.004). The CUDA copy places __fmaf_rn at the
same points. The strength's pow(cos, 40) is powf on the card and may
differ from the CPU's pow by an ulp or two.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops import trace as tracer
from vvr_tpu_torch.ops.shade import _reconstruct, check_trace_inputs
from vvr_tpu_torch.ops.sky import sample_clouds
from vvr_tpu_torch.utils.hash import _fma, _fract, sqrt32

F32 = torch.float32
C1 = 23.12123545          # the jitter hash's input scale (frame.py:344)
C2 = 30.43324             # its offset per sample
JITTER = 0.005            # the jitter's half-width about the sun
SUN_LIFT = 0.004          # the start's offset along the sun
SAMPLE_LIFT = 0.05        # and along the sample's own direction
SHARPNESS = 40.0          # strength = cos(angle to the sun) ^ SHARPNESS


def _f32(x, like):
    return torch.tensor(x, dtype=F32, device=like.device)


def sample_dir(s: int, px, py, pz, sun):
    """(dx, dy, dz, strength): sample s's jittered unit direction and its
    strength at query points (px, py, pz), rounded as the JAX package's
    jitted frame rounds them (module docstring). `sun`: (3,) f32 tensor."""
    c1 = _f32(C1, px)
    k = (_f32(0.1031, px), _f32(0.1030, px), _f32(0.0973, px))
    if s == 0:
        h = [q * (c1 * kk) for q, kk in zip((px, py, pz), k)]
    else:
        c2 = _f32(s * C2, px)
        h = [_fma(q, c1, c2) * kk for q, kk in zip((px, py, pz), k)]
    x, y, z = (_fract(v) for v in h)
    # the dot product x (y + 33.33) + y (x + 33.33) + z (z + 33.33), its
    # first sum fusing the y term onto the x term's product (d_a) or the x
    # term onto the y term's (d_b)
    d_a = _fma(z, z + 33.33, _fma(y, x + 33.33, x * (y + 33.33)))
    d_b = _fma(z, z + 33.33, _fma(x, y + 33.33, y * (x + 33.33)))

    def jitter(d):
        ax, ay, az = x + d, y + d, z + d
        r = (_fract((ax + ay) * az), _fract((ax + ax) * ay),
             _fract((ay + ax) * ax))
        return [_fma(r[c] * 2.0 - 1.0, _f32(JITTER, px), sun[c].expand_as(px))
                for c in range(3)]

    # the x and y channels from d_a, the z channel from d_b
    sx, sy, _ = jitter(d_a)
    sz = jitter(d_b)[2]
    sn = torch.clamp(sqrt32(_fma(sz, sz, _fma(sx, sx, sy * sy))), min=1e-12)
    dx, dy, dz = sx / sn, sy / sn, sz / sn
    cos = _fma(dz, sun[2].expand_as(px),
               _fma(dx, sun[0].expand_as(px), dy * sun[1]))
    strength = torch.pow(torch.clamp(cos, 0.0, 1.0), SHARPNESS)
    return dx, dy, dz, strength


def ray_start(px, py, pz, dx, dy, dz, sun):
    """The sample's DDA start p + sun * 0.004 + d * 0.05 (frame.py:356-359,
    the last sum an FMA as XLA forms it)."""
    lift = _f32(SAMPLE_LIFT, px)
    return tuple(_fma(d, lift, p + sun[c] * SUN_LIFT)
                 for c, (p, d) in enumerate(((px, dx), (py, dy), (pz, dz))))


def query_points(o, d, hit, face, axis_coord, sun, pixelated: bool):
    """(p (N, 3), shadow lanes (N,)): the surface point of each primary
    hit, floored to quarter voxels with `pixelated`, and the hits whose
    face turns toward the sun."""
    (nx, ny, nz), world, _ = _reconstruct(o, d, face, axis_coord)
    p = torch.stack(world, -1)
    if pixelated:
        p = torch.floor(p * 4.0) / 4.0
    facing = ((nx * sun[0] + ny * sun[1]) + nz * sun[2]) > 0.0
    return p, hit & facing


def sample_hits_plain(grid: tracer.Grid, o, d, hit, face, axis_coord, sun3,
                      samples: int, max_steps: int, pixelated: bool = False,
                      gate=None, rows_read=None):
    """Each sample's shadow hit (S, N) bool of the primary hits (steps 1-4
    of the module docstring). `gate`: (e1, e2, cone grids) of the cone
    classifier, or None to trace every shadow lane's samples. `rows_read`
    (as `tracer.trace_plain` takes it) gets the rows the walks and the
    DDAs load."""
    dev = o.device
    sun = torch.as_tensor(np.asarray(sun3, np.float32)).to(dev)
    p, active = query_points(o, d, hit, face, axis_coord, sun, pixelated)
    px, py, pz = p.unbind(1)
    n = o.shape[0]
    kh = km = torch.zeros(n, dtype=torch.bool, device=dev)
    if gate is not None:
        e1, e2, grids = gate
        kh, km = sunshadow.soft_shadow_gate(p, sun3, e1, e2, grids, active,
                                            grid.size)
        row_c = sunshadow.surface_row_c(p, sun3, e1, e2, grids, grid.size)
    traced = active & ~kh & ~km
    hits = []
    for s in range(samples):
        dirs = sample_dir(s, px, py, pz, sun)[:3]
        start = torch.stack(ray_start(px, py, pz, *dirs, sun), -1)
        dirs = torch.stack(dirs, -1)
        run = traced
        s_dda = torch.zeros(n, dtype=torch.bool, device=dev)
        if gate is not None and tracer.near_walk(grid):
            idx = torch.nonzero(traced)[:, 0]
            wh, wm = sunshadow.near_walk_classify(
                grid, start[idx], dirs[idx], row_c[idx], sun3, grid.size,
                rows_read)
            s_dda[idx[wh]] = True
            run = torch.zeros_like(traced)
            run[idx[~wh & ~wm]] = True
        idx = torch.nonzero(run)[:, 0]
        s_dda[idx] = tracer.trace_plain(grid, start[idx], dirs[idx],
                                        max_steps, stats=False,
                                        rows_read=rows_read).hit
        hits.append(kh | (~km & s_dda))
    return torch.stack(hits)


def shadow_factor_plain(o, d, hit, face, axis_coord, sun3, hits, clouds,
                        pixelated: bool = False):
    """The shadow factor (N,) f32 from each sample's hit (S, N) (step 5 of
    the module docstring): the samples' unshadowed strengths times their
    clouds' transmission, averaged in sample order; 0 on a miss."""
    sun = torch.as_tensor(np.asarray(sun3, np.float32)).to(o.device)
    p, _ = query_points(o, d, hit, face, axis_coord, sun, pixelated)
    px, py, pz = p.unbind(1)
    samples = hits.shape[0]
    shadow = torch.zeros(o.shape[0], dtype=F32, device=o.device)
    for s in range(samples):
        dx, dy, dz, strength = sample_dir(s, px, py, pz, sun)
        cl_a = sample_clouds(clouds, dx, dy, dz, px, py, pz)[:, 3]
        shadow = shadow + torch.where(hits[s], 0.0,
                                      strength * (1.0 - cl_a)) / samples
    return torch.where(hit, shadow, 0.0)


def soft_shadow_plain(grid: tracer.Grid, o, d, hit, face, axis_coord, sun3,
                      samples: int, clouds, max_steps: int,
                      pixelated: bool = False, gate=None, rows_read=None):
    """Plain torch K14: (shadow factor (N,) f32, per-sample hits (S, N)
    bool); `rows_read` as `sample_hits_plain` takes it."""
    hits = sample_hits_plain(grid, o, d, hit, face, axis_coord, sun3,
                             samples, max_steps, pixelated, gate, rows_read)
    return (shadow_factor_plain(o, d, hit, face, axis_coord, sun3, hits,
                                clouds, pixelated), hits)


def soft_lanes(samples: int) -> int:
    """K14's lanes a pixel in its sample rounds: the samples rounded up to a
    power of two, at most a warp (csrc/softshadow.cu vvr_soft_lanes)."""
    g = 1
    while g < samples and g < 32:
        g <<= 1
    return g


def soft_pixels(n: int, width: int) -> torch.Tensor:
    """The pixel of each K14 thread, -1 for none, the kernel's own index
    arithmetic: with `width` > 0 warp w takes the 8x4 tile w of the image
    (row-major over the tiles) and lane l its pixel in Z order (x from the
    bits 0, 2 and 4 of l, y from the bits 1 and 3); with width 0 the
    pixels 32 w ... 32 w + 31."""
    if width > 0:
        tiles_x = -(-width // 8)
        rows = -(-n // width)
        warps = tiles_x * -(-rows // 4)
        i = torch.arange(warps * 32)
        warp, lane = i // 32, i % 32
        x = warp % tiles_x * 8 + ((lane & 1) | ((lane >> 1) & 2)
                                  | ((lane >> 2) & 4))
        y = warp // tiles_x * 4 + (((lane >> 1) & 1) | ((lane >> 2) & 2))
        pix = torch.where(x < width, y * width + x, n)
    else:
        pix = torch.arange(-(-n // 32) * 32)
    return torch.where(pix < n, pix, -1)


def soft_lane_map(n: int, width: int, samples: int, traced, adds):
    """K14's sample rounds: (pixel, sample), each (threads, rounds) int64,
    -1 where a thread has no item in a round. `adds` (N,) bool: the
    pixels with samples to add (hit, not in certain shadow); `traced`: those
    of them that trace. Each warp ranks its pixels (soft_pixels) that add,
    those that trace first, in lane order; round b * ceil(S / G) + r gives
    lane l the pixel of rank b * P + l // G and its sample r * G + l % G,
    G = soft_lanes(S), P = 32 // G."""
    pix = soft_pixels(n, width)
    warps = pix.numel() // 32
    g = soft_lanes(samples)
    per = 32 // g
    sub = -(-samples // g)
    pc = pix.clamp(min=0)
    add = (pix >= 0) & adds.cpu()[pc]
    tr = add & traced.cpu()[pc]
    t, u = tr.view(warps, 32), (add & ~tr).view(warps, 32)
    rank = torch.where(t, t.cumsum(1) - 1,
                       t.sum(1, keepdim=True) + u.cumsum(1) - 1).flatten()
    by_rank = torch.full((warps, 33), -1, dtype=torch.int64)
    row = torch.arange(pix.numel()) // 32
    by_rank[row[add], rank[add]] = pix[add]
    lane = torch.arange(32)
    rounds = [(b, r) for b in range(-(-32 // per)) for r in range(sub)]
    k = torch.tensor([b * per for b, _ in rounds])[None, :] \
        + (lane // g)[:, None]
    smp = torch.tensor([r * g for _, r in rounds])[None, :] \
        + (lane % g)[:, None]
    got = by_rank[:, torch.clamp(k, max=32)].reshape(warps * 32, -1)
    smp = smp.repeat(warps, 1)
    ok = (got >= 0) & (smp < samples)
    return torch.where(ok, got, -1), torch.where(ok, smp, -1)


def soft_shadow(grid: tracer.Grid, o, d, hit, face, axis_coord, sun3,
                samples: int, clouds, max_steps: int,
                pixelated: bool = False, gate=None, with_hits: bool = False,
                width: int = 0):
    """The soft-shadow factor (N,) f32 of the primary hits (0 on a miss),
    and with `with_hits` the per-sample hits (S, N) bool. `sun3`: the
    frame's (3,) sun; `clouds`: the (R, R, 4) cloud texture; `gate`: (e1,
    e2, cone grids) from sun_basis and sun_grids(..., cone_tan=CONE_TAN),
    or None; `width`: the image's width, if the lanes are its pixels in
    row-major order (the kernel then serves 8x4 tiles of them,
    soft_pixels), or 0. CUDA: K14, one launch."""
    if not kernels.on_cuda(o):
        factor, hits = soft_shadow_plain(grid, o, d, hit, face, axis_coord,
                                         sun3, samples, clouds, max_steps,
                                         pixelated, gate)
        return (factor, hits) if with_hits else factor
    check_trace_inputs(o, d, hit, face, axis_coord)
    if not 1 <= samples <= 255:
        raise ValueError(f"samples must lie in 1..255, got {samples}")
    if width < 0:
        raise ValueError(f"width must be 0 or more, got {width}")
    if clouds.dim() != 3 or clouds.shape[2] != 4 or clouds.dtype != F32 \
            or clouds.data_ptr() % 16:
        raise ValueError("clouds must be (R, R, 4) float32, 16-byte "
                         "aligned")
    n = o.shape[0]
    dev = o.device
    name, grid_args = tracer.kernel_args("soft_shadow", grid)
    tensors = [*tracer.tensors(grid), o, d, hit, face, axis_coord, clouds]
    basis = [0.0] * 6
    gbc_ptr, g, frame = 0, 0, (0.0, 0.0, 0.0)
    if gate is not None:
        e1, e2, (gbc, a0, b0, ts) = gate
        if gbc.dtype != F32 or gbc.dim() != 2 or gbc.shape[1] != 2:
            raise ValueError("gBC must be (G^2, 2) float32")
        tensors.append(gbc)
        basis = [float(c) for v in (e1, e2) for c in v]
        gbc_ptr, g = gbc.data_ptr(), math.isqrt(gbc.shape[0])
        frame = (float(a0), float(b0), float(ts))
    kernels.check_cuda(*tensors)
    factor = torch.empty(n, dtype=F32, device=dev)
    hits = (torch.empty((samples, n), dtype=torch.bool, device=dev)
            if with_hits else None)
    kernels.launch(name, dev, *grid_args, o.data_ptr(), d.data_ptr(),
                   hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(), n,
                   width,
                   *(float(c) for c in np.asarray(sun3, np.float32)[:3]),
                   samples, int(pixelated), clouds.data_ptr(),
                   clouds.shape[0], max_steps, *basis, gbc_ptr, g, *frame,
                   factor.data_ptr(), 0 if hits is None else hits.data_ptr())
    return (factor, hits) if with_hits else factor
