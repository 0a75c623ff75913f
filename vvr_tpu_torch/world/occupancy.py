"""Occupancy bit layouts — jump-grid superbrick rows.

Counterpart of the jump-grid half of vvr_tpu/world/occupancy.py: an 8^3
superbrick's 512-bit voxel occupancy as 16 u32 words; word = 2*lz + (ly>>2),
bit = lx + 8*(ly&3). The CUDA copy is `brick_solid` in csrc/jump_dda.cuh.
"""

from __future__ import annotations

import torch


def brick_word_index(lx, ly, lz):
    """(word 0..15, shift 0..31) of local coords within an 8^3 brick."""
    return 2 * lz + (ly >> 2), lx + ((ly & 3) << 3)


def brick_solid(words, lx, ly, lz):
    """Voxel bit of local coords from brick rows `words` ((N, >=16) int64
    holding u32 bit patterns)."""
    w, sh = brick_word_index(lx, ly, lz)
    word = torch.gather(words, 1, w[:, None])[:, 0]
    return ((word >> sh) & 1) == 1
