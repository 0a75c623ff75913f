"""Bloom mip chain and compositor — kernel K4 (csrc/post.cu).

Replaces vvr_tpu/ops/post.py `bloom_pyramid_p` (:146, with its passes
`bloom_downsample` :92 and `bloom_upsample` :127) and `composite_p` (:205):

  downsample: 9 taps on the half-texel grid, each kept where
              length(rgba) > 0.6 (the sky's alpha 10 makes the sky bloom),
              clamped to [0, 1000], summed, /9;
  upsample:   a 2x2 tent from the coarser mip, NaN-guarded, overwriting
              mips N-2 .. 2; the bloom lives in mip 2;
  composite:  4x bilinear bloom from mip 2 * strength, ACES, gamma 1/2.2,
              u8 quantization `(clip * 255 + 0.5)` truncated, integer
              upscale to the output size.

What bounds them on an H100: memory bandwidth and latency. Mip 1 reads the
33 MB HDR image and writes a quarter of it; the other eleven levels are
small, so each costs a dependent step. `bloom_pyramid` runs every level in
one cooperative launch, with a grid sync between stages and the mips in
one scratch buffer: a downsample level takes a thread per output texel
(its 64 texels loaded at once), and the five upsample levels run as one
stage, a tile of mip 2 per CTA in shared memory. The composite reads the
HDR image and the bloom mip and writes 6 MB of u8, one thread per output
texel. The per-level plain functions are the pyramid's plain version,
pass by pass.

All images are planar (C, H, W) float32, as in the JAX version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tfn

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.shade import aces

F32 = torch.float32


def bloom_mip_count(width: int, height: int) -> int:
    return max(int(math.log2(min(width, height))) - 2, 3)


def _mip_size(size: int, mip: int) -> int:
    return max(size >> mip, 1)


def _edge_pad(img, top, bottom, left, right):
    return tfn.pad(img[None], (left, right, top, bottom),
                   mode="replicate")[0]


def _length4(t):
    """length(rgba), channels summed left to right."""
    return torch.sqrt(((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2])
                      + t[3] * t[3])


def bloom_downsample_plain(prev, next_h: int, next_w: int):
    """prev (C, h, w) -> (C, next_h, next_w)."""
    p = _edge_pad(prev, 1, 1, 1, 1)
    hy = 0.5 * (p[:, :-1] + p[:, 1:])
    hg = 0.5 * (hy[:, :, :-1] + hy[:, :, 1:])           # (C, h+1, w+1)
    keep = _length4(hg) > 0.6
    kept = torch.where(keep[None], torch.clamp(hg, 0.0, 1000.0), 0.0)
    pad_y = max(2 * next_h + 2 - kept.shape[1], 0)
    pad_x = max(2 * next_w + 2 - kept.shape[2], 0)
    if pad_y or pad_x:
        kept = _edge_pad(kept, 0, pad_y, 0, pad_x)
    s = None
    for dy in range(3):               # window sum, row-major tap order
        for dx in range(3):
            tap = kept[:, dy:dy + 2 * next_h:2, dx:dx + 2 * next_w:2]
            s = tap if s is None else s + tap
    return s / 9.0


def _up2_axis1(a_exact, a_mid):
    """2x along axis 1: out[2k] = 0.5*(mid[k] + exact[k]),
    out[2k+1] = 0.5*(exact[k] + mid[k+1])."""
    c, n0 = a_exact.shape[0], a_exact.shape[1]
    even = 0.5 * (a_mid[:, :n0] + a_exact)
    odd = 0.5 * (a_exact + a_mid[:, 1:n0 + 1])
    return torch.stack([even, odd], 2).reshape((c, 2 * n0)
                                               + a_exact.shape[2:])


def bloom_upsample_plain(prev, next_h: int, next_w: int):
    """Coarser mip prev (C, h, w) -> (C, next_h, next_w)."""
    py = _edge_pad(prev, 1, 1, 0, 0)
    my = 0.5 * (py[:, :-1] + py[:, 1:])
    uy = _up2_axis1(prev, my)
    pux = _edge_pad(uy, 0, 0, 1, 1)
    mux = 0.5 * (pux[:, :, :-1] + pux[:, :, 1:])
    ux = _up2_axis1(uy.transpose(1, 2), mux.transpose(1, 2)).transpose(1, 2)
    out = ux[:, :next_h, :next_w]
    pad_y = max(0, next_h - out.shape[1])
    pad_x = max(0, next_w - out.shape[2])
    if pad_y or pad_x:
        out = _edge_pad(out, 0, pad_y, 0, pad_x)
    return torch.where(torch.isnan(out), 0.0, out)


def _up4_phases_axis1(a):
    """4x along axis 1 at bilinear texel-center phases (3/8,5/8) (1/8,7/8)
    (7/8,1/8) (5/8,3/8)."""
    n0 = a.shape[1]
    pa = _edge_pad(a, 1, 1, 0, 0)
    prev, cur, nxt = pa[:, :-2], pa[:, 1:-1], pa[:, 2:]
    out = torch.stack([0.375 * prev + 0.625 * cur,
                       0.125 * prev + 0.875 * cur,
                       0.875 * cur + 0.125 * nxt,
                       0.625 * cur + 0.375 * nxt], 2)
    return out.reshape((a.shape[0], 4 * n0) + a.shape[2:])


def _upsample4_bilinear(img, out_h: int, out_w: int):
    uy = _up4_phases_axis1(img)
    ux = _up4_phases_axis1(uy.transpose(1, 2)).transpose(1, 2)
    out = ux[:, :out_h, :out_w]
    pad_y = max(0, out_h - out.shape[1])
    pad_x = max(0, out_w - out.shape[2])
    if pad_y or pad_x:
        out = _edge_pad(out, 0, pad_y, 0, pad_x)
    return out


def composite_p_plain(rendered, bloom_mip2, out_h: int, out_w: int,
                      bloom_strength: float = 0.05,
                      bloom_enabled: bool = True):
    """(out_h, out_w, 3) u8 from planar rendered (4, rh, rw) and bloom
    mip 2 (4, bh, bw)."""
    rh, rw = rendered.shape[1], rendered.shape[2]
    colour = rendered[:3]
    if bloom_enabled:
        colour = colour + _upsample4_bilinear(bloom_mip2[:3], rh, rw) \
            * bloom_strength
    ldr = torch.pow(aces(colour), 1.0 / 2.2)
    img = (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    if (out_h, out_w) != (rh, rw):
        sy = max(out_h // rh, 1)
        sx = max(out_w // rw, 1)
        iy = torch.clamp(torch.arange(out_h, device=img.device) // sy,
                         max=rh - 1)
        ix = torch.clamp(torch.arange(out_w, device=img.device) // sx,
                         max=rw - 1)
        img = img[:, iy][:, :, ix]
    return img.permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch K4, CPU tensors run the plain versions
# ---------------------------------------------------------------------------

def _check_planar(img, channels: int = 4):
    if img.dim() != 3 or img.shape[0] != channels or img.dtype != F32:
        raise ValueError(f"expected a ({channels}, H, W) float32 image, got "
                         f"{tuple(img.shape)} {img.dtype}")
    kernels.check_cuda(img)


def _mip_offsets(h: int, w: int, n_mips: int):
    """Element offset of each mip 1..n_mips-1 in the pyramid's scratch
    buffer, back to back (csrc/post.cu mip_offset), and the total."""
    offsets, off = {}, 0
    for m in range(1, n_mips):
        offsets[m] = off
        off += 4 * _mip_size(h, m) * _mip_size(w, m)
    return offsets, off


def bloom_pyramid_plain(rendered):
    """Full bloom chain on a planar (4, H, W) image, pass by pass; returns
    mip 2."""
    h, w = rendered.shape[1], rendered.shape[2]
    n_mips = bloom_mip_count(w, h)
    mips = [rendered]
    for m in range(1, n_mips):
        mips.append(bloom_downsample_plain(mips[m - 1], _mip_size(h, m),
                                           _mip_size(w, m)))
    for m in range(n_mips - 2, 1, -1):
        mips[m] = bloom_upsample_plain(mips[m + 1], _mip_size(h, m),
                                       _mip_size(w, m))
    return mips[2]


def bloom_pyramid_p(rendered):
    """Full bloom chain on a planar (4, H, W) image; returns mip 2.
    CUDA: K4 `bloom_pyramid`, every level in one launch; mip 2 is a view
    of its scratch buffer."""
    if not kernels.on_cuda(rendered):
        return bloom_pyramid_plain(rendered)
    _check_planar(rendered)
    h, w = rendered.shape[1], rendered.shape[2]
    n_mips = bloom_mip_count(w, h)
    offsets, total = _mip_offsets(h, w, n_mips)
    scratch = torch.empty(total, dtype=F32, device=rendered.device)
    kernels.launch("bloom_pyramid", rendered.device, rendered.data_ptr(), h,
                   w, n_mips, scratch.data_ptr())
    h2, w2 = _mip_size(h, 2), _mip_size(w, 2)
    return scratch[offsets[2]:offsets[2] + 4 * h2 * w2].view(4, h2, w2)


def composite_p(rendered, bloom_mip2, out_h: int, out_w: int,
                bloom_strength: float = 0.05, bloom_enabled: bool = True):
    """Final (out_h, out_w, 3) u8 frame. CUDA: K4 `composite`."""
    if not kernels.on_cuda(rendered):
        return composite_p_plain(rendered, bloom_mip2, out_h, out_w,
                                 bloom_strength, bloom_enabled)
    _check_planar(rendered)
    _check_planar(bloom_mip2)
    out = torch.empty((out_h, out_w, 3), dtype=torch.uint8,
                      device=rendered.device)
    kernels.launch("composite", rendered.device, rendered.data_ptr(),
                   rendered.shape[1], rendered.shape[2], bloom_mip2.data_ptr(),
                   bloom_mip2.shape[1], bloom_mip2.shape[2],
                   float(bloom_strength), int(bloom_enabled), out.data_ptr(),
                   out_h, out_w)
    return out
