"""Occupancy bit layouts — brick-pyramid node rows and jump-grid
superbrick rows.

Counterpart of vvr_tpu/world/occupancy.py:
- a pyramid node's 64-bit child mask as a (lo, hi) u32 pair, bit = x |
  y<<2 | z<<4 within the node (`node_bit`, `bit64`); the level-1 any bits
  are the voxels (`pyramid_voxel_solid`, :39, with
  vvr_tpu/ops/traverse.py:121 `solid_at`);
- an 8^3 superbrick's 512-bit voxel occupancy as 16 u32 words; word =
  2*lz + (ly>>2), bit = lx + 8*(ly&3).
The CUDA copies are `vvr_pyramid_solid` (csrc/pyramid_dda.cuh) and
`vvr_brick_solid` (csrc/jump_dda.cuh).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def node_bit(x, y, z):
    """Bit index of local coords within a 4^3 node: x | y<<2 | z<<4."""
    return (x & 3) | ((y & 3) << 2) | ((z & 3) << 4)


def bit64(lo, hi, bit):
    """Bit `bit` (0..63) of the (lo, hi) u32 pair (int64 tensors)."""
    word = torch.where(bit >= 32, hi, lo)
    return ((word >> (bit & 31)) & 1) == 1


def pyramid_voxel_solid(pyr, v, rows_read=None):
    """Whether each voxel v (N, 3) int64, inside the world, is solid: one
    level-1 node row and its any bit. `rows_read`, a 1-tuple of a bool
    tensor as long as the rows, gets True at the rows loaded."""
    g = pyr.size >> 2
    addr = (pyr.bases[1] + (v[:, 0] >> 2) + (v[:, 1] >> 2) * g
            + (v[:, 2] >> 2) * g * g)
    if rows_read is not None:
        rows_read[0][addr] = True
    row = pyr.rows[addr, :2].to(torch.int64) & MASK32
    return bit64(row[:, 0], row[:, 1], node_bit(v[:, 0], v[:, 1], v[:, 2]))


def brick_word_index(lx, ly, lz):
    """(word 0..15, shift 0..31) of local coords within an 8^3 brick."""
    return 2 * lz + (ly >> 2), lx + ((ly & 3) << 3)


def brick_solid(words, lx, ly, lz):
    """Voxel bit of local coords from brick rows `words` ((N, >=16) int64
    holding u32 bit patterns)."""
    w, sh = brick_word_index(lx, ly, lz)
    word = torch.gather(words, 1, w[:, None])[:, 0]
    return ((word >> sh) & 1) == 1
