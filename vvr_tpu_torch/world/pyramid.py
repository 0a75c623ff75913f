"""Brick pyramid — the node tables of the hierarchical DDA (HDDA) — and
the flat occupancy pyramid the SVO tree reads.

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

`OccupancyPyramid`, `build_pyramid` and `build_pyramid_from_chunks` are
the counterparts of vvr_tpu/world/pyramid.py:37, :81 and :105: one flat
array of u32 words, level 0 one bit a voxel, level l in [1, depth] two
bits a cell (bit 0 any voxel below, bit 1 all of them), cells x-major,
bits little-endian within a word, level l from word `bases[l]`. Its words
are equal to the JAX ones; they live on the given device and
`level_bits` is the host accessor. Only the SVO tree (world/tree.py)
reads it.
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


def _pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """bool (n,) -> int32 little-endian packed u32 words (bit patterns),
    padded to a whole word, a slab at a time."""
    bits = bits.reshape(-1)
    n = bits.numel()
    words = (n + 31) // 32
    out = torch.empty(words + (words & 1), dtype=torch.int32,
                      device=bits.device)
    for b0 in range(0, n, SLAB_VOXELS):
        slab = bits[b0:b0 + SLAB_VOXELS]
        pad = (-slab.numel()) % 64
        if pad:
            slab = torch.cat([slab, slab.new_zeros(pad)])
        w0 = b0 // 32
        out[w0:w0 + slab.numel() // 32] = pack_bits64(
            slab.reshape(-1, 64)).reshape(-1)
    return out[:words]


def _unpack_bits(words: torch.Tensor, count: int) -> torch.Tensor:
    """The first `count` bits of int32 words, little-endian, as bool."""
    byte = words.contiguous().view(torch.uint8)[:(count + 7) // 8]
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((byte[:, None] >> shifts) & 1).to(torch.bool).reshape(-1)[:count]


@dataclasses.dataclass
class OccupancyPyramid:
    """words (W,) int32 u32 bit patterns on the device; `depth` levels
    above the voxels; `bases` the first word of each level 0..depth."""

    words: torch.Tensor
    depth: int
    bases: tuple

    @property
    def size(self) -> int:
        return 1 << (2 * self.depth)

    def level_masks(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(any, full) bool (s, s, s) [z, y, x] of a level, on the words'
        device (at level 0 both are the voxels)."""
        s = self.size >> (2 * level)
        n = s ** 3
        if level == 0:
            a = _unpack_bits(self.words[self.bases[0]:], n).reshape(s, s, s)
            return a, a.clone()
        raw = _unpack_bits(self.words[self.bases[level]:], 2 * n)
        raw = raw.reshape(-1, 2)
        return raw[:, 0].reshape(s, s, s), raw[:, 1].reshape(s, s, s)

    def level_bits(self, level: int) -> tuple[np.ndarray, np.ndarray]:
        """(any, full) bool arrays [z,y,x] for a level (host)."""
        return tuple(m.cpu().numpy() for m in self.level_masks(level))


def build_pyramid(occ, device="cuda") -> OccupancyPyramid:
    """The occupancy pyramid of a dense bool occupancy [z,y,x] (numpy
    array or tensor), built in torch on `device`."""
    if isinstance(occ, np.ndarray):
        occ = torch.from_numpy(np.ascontiguousarray(occ, bool))
    occ = occ.to(device=device, dtype=torch.bool)
    size = occ.shape[0]
    depth = (size.bit_length() - 1) // 2
    if 4 ** depth != size:
        raise ValueError(f"size {size} must be a power of 4")
    level_words = [_pack_bits_u32(occ)]
    any_l = full_l = occ
    for _ in range(1, depth + 1):
        any_l = _reduce4(any_l, torch.any)
        full_l = _reduce4(full_l, torch.all)
        level_words.append(_pack_bits_u32(
            torch.stack([any_l.reshape(-1), full_l.reshape(-1)], -1)))
    bases, off = [], 0
    for w in level_words:
        bases.append(off)
        off += w.numel()
    return OccupancyPyramid(torch.cat(level_words), depth, tuple(bases))


def build_pyramid_from_chunks(chunks, size: int,
                              device="cuda") -> OccupancyPyramid:
    """The occupancy pyramid of a world given as chunks (assembled
    densely; the JAX version reads the chunk mips for levels 1-3, which
    give the same words)."""
    return build_pyramid(assemble_dense(chunks, size), device)
