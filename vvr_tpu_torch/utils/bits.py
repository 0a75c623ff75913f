"""Bit and index helpers of the SVO tree — torch and numpy.

Counterpart of vvr_tpu/utils/bits.py. Index convention (x-major, the
reference's src/voxel/util.rs:8-38):
  linear = x + y*size + z*size*size
  child bit within a 4x4x4 node = x | y<<2 | z<<4

A u64 is a (lo, hi) pair of u32 words, as in the JAX package. torch has
few operations on uint32, so a torch u32 word is held in int64 (its bit
pattern masked to 32 bits; an int32 tensor of bit patterns is accepted
and masked). numpy arrays keep their own unsigned types. Only the port's
tree (world/tree.py) and the tests call these.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def offset_to_index(xyz, size: int):
    """(x,y,z) -> x + y*size + z*size^2; numpy arrays or tensors."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return x + y * size + z * size * size


def index_to_offset(index, size: int):
    """Inverse of offset_to_index; returns stacked (..., 3)."""
    mod = index % (size * size)
    x = mod % size
    y = mod // size
    z = index // (size * size)
    if torch.is_tensor(index):
        return torch.stack([x, y, z], -1)
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def child_bit_index(local_xyz):
    """Bit index of a child within a 4x4x4 node: x | y<<2 | z<<4
    (src/voxel/util.rs:32-38, ray_stuff_other.slang:197-198)."""
    x, y, z = local_xyz[..., 0], local_xyz[..., 1], local_xyz[..., 2]
    return x | (y << 2) | (z << 4)


def u64_split(v):
    """u64 -> (lo, hi) u32 words: numpy uint64 to uint32 arrays, an int64
    tensor of u64 bit patterns to int64 tensors."""
    if torch.is_tensor(v):
        return v & MASK32, (v >> 32) & MASK32
    v = np.asarray(v, dtype=np.uint64)
    return ((v & np.uint64(MASK32)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def u64_join(lo, hi):
    """(lo, hi) -> u64 (numpy uint64, or an int64 tensor's bit pattern)."""
    if torch.is_tensor(lo):
        return (lo & MASK32) | ((hi & MASK32) << 32)
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


def _u32(v):
    return v.to(torch.int64) & MASK32


def popcount32(v):
    """32-bit popcount (Hacker's Delight) of numpy uint32 words or of a
    tensor of u32 words."""
    if torch.is_tensor(v):
        v = _u32(v)
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return ((v * 0x01010101) >> 24) & 0xFF
    v = np.asarray(v).astype(np.uint32)
    c1, c2, c4 = (np.uint32(0x55555555), np.uint32(0x33333333),
                  np.uint32(0x0F0F0F0F))
    v = v - ((v >> np.uint32(1)) & c1)
    v = (v & c2) + ((v >> np.uint32(2)) & c2)
    v = (v + (v >> np.uint32(4))) & c4
    return (v * np.uint32(0x01010101)) >> np.uint32(24)


def _below_mask(bits):
    """u32 mask of the bits below `bits` in [0, 32], as int64 tensors."""
    return torch.where(bits >= 32, torch.full_like(bits, MASK32),
                       (1 << bits.clamp(max=31)) - 1)


def popcount_prefix_u64(lo, hi, bit_index):
    """Set bits strictly below `bit_index` (in [0, 64)) in the u64 (lo,
    hi): the child-offset rule of the GPU traversal
    (ray_stuff_other.slang:216-218). Tensors of u32 words and bits."""
    bit = bit_index.to(torch.int64)
    in_lo = bit < 32
    lo_bits = torch.where(in_lo, bit, torch.full_like(bit, 32))
    hi_bits = torch.where(in_lo, torch.zeros_like(bit), bit - 32)
    return (popcount32(_u32(lo) & _below_mask(lo_bits))
            + popcount32(_u32(hi) & _below_mask(hi_bits)))


def u64_get_bit(lo, hi, bit_index):
    """Bit `bit_index` (in [0, 64)) of the u64 (lo, hi); tensors."""
    bit = bit_index.to(torch.int64)
    word = torch.where(bit < 32, _u32(lo), _u32(hi))
    return (word >> (bit & 31)) & 1


def base4_trailing_levels(v, max_levels: int):
    """How many trailing base-4 digits of `v` are zero, capped at
    max_levels (the HDDA's ascent level); numpy arrays or tensors."""
    if torch.is_tensor(v):
        cur = v.to(torch.int32)
        out = torch.zeros_like(cur)
        ok = torch.ones_like(cur, dtype=torch.bool)
    else:
        cur = np.asarray(v).astype(np.int32)
        out = np.zeros_like(cur)
        ok = np.ones_like(cur, dtype=bool)
    for _ in range(max_levels):
        ok = ok & ((cur & 3) == 0)
        out = out + (ok.to(out.dtype) if torch.is_tensor(ok)
                     else ok.astype(out.dtype))
        cur = cur >> 2
    return out
