"""Brick pyramid — the node tables of the hierarchical DDA (HDDA).

Counterpart of vvr_tpu/world/pyramid.py `BrickPyramid`,
`_pack_node_masks`, `build_brick_pyramid` and `brick_pyramid_from_chunks`
(:152, :199, :227, :259). For each level l in [1, depth] a dense table of
nodes, one row per level-l cell, x-major within the level:

  [any_lo, any_hi, full_lo, full_hi]: the 64-bit any and full masks of
  the cell's 4x4x4 children (level l-1 cells), child bit x | y<<2 | z<<4

All levels concatenate into one (R, 4) int32 tensor of u32 bit patterns
(level l from row `bases[l]`), so a node fetch is one 16 B row. At level
1 the children are voxels (any = full); a child at level l > 1 is any
when its own any mask is not 0 and full when its full mask is all ones.
The frame's walk reads only the any masks, the first 8 B of a row (the
JAX package keeps a separate (R, 2) copy of them, `rows_any`, and the
grouped 64 B rows of its opt-in TPU mode, `rows_grp`: neither is kept
here). At 1024^3 (depth 5) the table has 17,043,521 rows, 273 MB.

The build runs in torch on the pyramid's device from the dense occupancy,
a slab of node rows at a time, so the card builds its own pyramid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vvr_tpu_torch.world.generator import assemble_dense

ROW_WORDS = 4
MAX_DEPTH = 5            # the kernels address rows with 32-bit integers
SLAB_VOXELS = 1 << 26    # children packed in one step of the build


@dataclasses.dataclass
class BrickPyramid:
    """rows (R, 4) int32 u32 bit patterns; `depth` levels of 4^3 nodes
    over a world of edge 4^depth."""

    rows: torch.Tensor
    depth: int

    @property
    def size(self) -> int:
        return 1 << (2 * self.depth)

    @property
    def bases(self) -> tuple:
        """Row offset of each level, index 0 unused (no voxel table):
        level l starts after levels 1 .. l-1, (size >> 2k)^3 rows each."""
        out, off = [0], 0
        for lv in range(1, self.depth + 1):
            out.append(off)
            off += (self.size >> (2 * lv)) ** 3
        return tuple(out)

    def memory_bytes(self) -> int:
        return self.rows.numel() * 4


def pyramid_depth(size: int) -> int:
    """log4(size), for sizes 4 .. 4^MAX_DEPTH."""
    depth = (int(size).bit_length() - 1) // 2
    if 4 ** depth != size or not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"the brick pyramid needs a size 4^d, 1 <= d <= "
                         f"{MAX_DEPTH}, got {size}")
    return depth


def pack_bits64(bits: torch.Tensor) -> torch.Tensor:
    """bool (K, 64) -> int32 (K, 2): the little-endian 64-bit mask of
    each row as (lo, hi) u32 bit patterns."""
    b = bits.reshape(-1, 8, 8).to(torch.uint8)
    byte = b[..., 0]
    for k in range(1, 8):
        byte = byte | (b[..., k] << k)
    return byte.contiguous().view(torch.int32)


def pack_node_masks(bits: torch.Tensor) -> torch.Tensor:
    """bool (n, n, n) child grid [z, y, x] -> int32 (m^3, 2) masks of each
    4x4x4 node, m = n / 4, bit x | y<<2 | z<<4 (`_pack_node_masks`),
    a slab of node z-rows at a time."""
    n = bits.shape[0]
    m = n // 4
    out = torch.empty((m ** 3, 2), dtype=torch.int32, device=bits.device)
    step = max(1, SLAB_VOXELS // (4 * n * n))
    for z0 in range(0, m, step):
        z1 = min(m, z0 + step)
        g = bits[4 * z0:4 * z1].reshape(z1 - z0, 4, m, 4, m, 4)
        g = g.permute(0, 2, 4, 1, 3, 5).reshape(-1, 64)
        out[z0 * m * m:z1 * m * m] = pack_bits64(g)
    return out


def _reduce4(a: torch.Tensor, fn) -> torch.Tensor:
    m = a.shape[0] // 4
    r = a.reshape(m, 4, m, 4, m, 4)
    return fn(fn(fn(r, 5), 3), 1)


def build_brick_pyramid(occ, device="cuda") -> BrickPyramid:
    """The pyramid of a dense bool occupancy [z, y, x] (numpy array or
    tensor), built on `device`."""
    if isinstance(occ, np.ndarray):
        occ = torch.from_numpy(np.ascontiguousarray(occ, bool))
    occ = occ.to(device=device, dtype=torch.bool)
    size = occ.shape[0]
    depth = pyramid_depth(size)
    tables = []
    any_l = full_l = occ
    for level in range(1, depth + 1):
        a2 = pack_node_masks(any_l)
        f2 = a2 if level == 1 else pack_node_masks(full_l)
        tables.append(torch.cat([a2, f2], 1))
        any_l = _reduce4(any_l, torch.any)
        full_l = _reduce4(full_l, torch.all)
    return BrickPyramid(torch.cat(tables).contiguous(), depth)


def brick_pyramid_from_chunks(chunks, size: int,
                              device="cuda") -> BrickPyramid:
    """The pyramid of a world given as chunks (assembled densely, as the
    JAX version does)."""
    return build_brick_pyramid(assemble_dense(chunks, size), device)
