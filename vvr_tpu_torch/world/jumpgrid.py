"""Jump grid — superbrick occupancy + jump distances, one row per 8^3.

Counterpart of vvr_tpu/world/jumpgrid.py `build_jump_grid`: the same host
numpy build, word for word, with the rows moved to the device as a tensor.
Each (S/8)^3 grid cell has one 128-byte row:

  words[0:16] : the superbrick's 512-bit voxel occupancy
                (word = 2*lz + (ly>>2), bit = lx + 8*(ly&3))
  words[16]   : chebyshev distance (in superbricks) to the nearest
                non-empty superbrick; 0 = this superbrick is non-empty
  words[17:19]: 64-bit any-mask of the brick's 4^3 grid of 2^3-voxel
                subcells (bit = cx | cy<<2 | cz<<4)
  words[19:24]: zero padding
  words[24:32]: per-direction-octant jump distances: words[24 + oct]
                (oct = (dx>0) | (dy>0)<<1 | (dz>0)<<2) is the largest d
                such that the box extending d-1 superbricks from this one
                along the octant only is all-empty.

The device tensor is int32 holding the u32 bit patterns: the CUDA kernel
reads it as uint32, and the plain torch tracer widens it to int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SB = 8          # superbrick edge, voxels
ROW_WORDS = 32  # u32 words per row (128 B)


@dataclasses.dataclass
class JumpGrid:
    """(G^3, 32) rows, x-major (row = x + y*G + z*G*G), G = size // 8."""

    rows: torch.Tensor   # int32 (G^3, 32), u32 bit patterns
    size: int

    @property
    def gsize(self) -> int:
        return self.size // SB


def chebyshev_distance(occ_sb: np.ndarray,
                       cap: int | None = None) -> np.ndarray:
    """Chebyshev distance (in cells) to the nearest True cell of occ_sb
    [z,y,x]; 0 at True cells. Iterated separable 3-wide min-filter (+1)."""
    g = occ_sb.shape[0]
    cap = g if cap is None else cap
    d = np.where(occ_sb, 0, cap).astype(np.int32)
    for _ in range(cap):
        prev = d
        m = d
        for ax in range(3):
            lo = np.full_like(m, cap)
            hi = np.full_like(m, cap)
            sl_lo = [slice(None)] * 3
            sl_hi = [slice(None)] * 3
            sl_lo[ax] = slice(1, None)
            sl_hi[ax] = slice(None, -1)
            lo[tuple(sl_hi)] = m[tuple(sl_lo)]
            hi[tuple(sl_lo)] = m[tuple(sl_hi)]
            m = np.minimum(m, np.minimum(lo, hi))
        d = np.minimum(d, m + 1)
        d = np.where(occ_sb, 0, d)
        if (d == prev).all():
            break
    return d


def _shift_fill(a: np.ndarray, off: tuple, fill: int) -> np.ndarray:
    """a sampled at v + off ([z,y,x] offsets), out-of-grid -> fill."""
    out = np.full_like(a, fill)
    src = []
    dst = []
    for ax, o in enumerate(off):
        n = a.shape[ax]
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, n - o))
        else:
            src.append(slice(0, n + o))
            dst.append(slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def octant_distances(occ_sb: np.ndarray, cap: int = 32) -> np.ndarray:
    """(8, G, G, G) int32: for each direction octant, the largest d such
    that the one-sided box {v + c*sign, c in [0, d-1]^3} is all-empty
    (0 at non-empty cells); out-of-grid counts as empty."""
    g = occ_sb.shape[0]
    cap = min(cap, g)
    out = np.zeros((8,) + occ_sb.shape, np.int32)
    offs = [(cz, cy, cx) for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)
            if (cx, cy, cz) != (0, 0, 0)]
    for oct_ in range(8):
        sx = 1 if (oct_ & 1) else -1
        sy = 1 if (oct_ & 2) else -1
        sz = 1 if (oct_ & 4) else -1
        d = np.where(occ_sb, 0, cap).astype(np.int32)
        for _ in range(cap):
            prev = d
            m = np.full_like(d, cap)
            for (cz, cy, cx) in offs:
                np.minimum(m, _shift_fill(d, (cz * sz, cy * sy, cx * sx),
                                          cap), out=m)
            d = np.where(occ_sb, 0, np.minimum(d, np.minimum(m, cap - 1) + 1))
            if (d == prev).all():
                break
        out[oct_] = d
    return out


def pack_superbricks(occ: np.ndarray) -> np.ndarray:
    """bool occ [z,y,x] (S,S,S) -> (G^3, 16) u32 occupancy words with
    word = 2*lz + (ly>>2), bit-in-word = lx + 8*(ly&3)."""
    s = occ.shape[0]
    g = s // SB
    v = occ.reshape(g, SB, g, SB, g, SB)
    v = v.transpose(0, 2, 4, 1, 3, 5)          # (gz,gy,gx, lz,ly,lx)
    v = v.reshape(g ** 3, SB * 2, 32)          # (rows, word, bit)
    flat = np.ascontiguousarray(v).reshape(g ** 3, 512)
    packed = np.packbits(flat, axis=1, bitorder="little")
    return packed.view(np.uint32)               # (g^3, 16)


def pack_node_masks(bits: np.ndarray) -> np.ndarray:
    """bool (n, n, n) child-cell grid [z,y,x] -> (m^3, 2) u32 lo/hi masks of
    each 4x4x4 node, bit = x | y<<2 | z<<4 (vvr_tpu/world/pyramid.py
    `_pack_node_masks`)."""
    n = bits.shape[0]
    m = n // 4
    g = bits.reshape(m, 4, m, 4, m, 4)
    g = g.transpose(0, 2, 4, 1, 3, 5)
    packed = np.packbits(g.reshape(m ** 3, 64), axis=1, bitorder="little")
    return packed.view(np.uint32)


def build_jump_rows(occ: np.ndarray) -> np.ndarray:
    """(G^3, 32) u32 rows from dense bool occupancy [z,y,x]."""
    occ = np.asarray(occ, bool)
    size = occ.shape[0]
    if size % SB:
        raise ValueError(f"size {size} must be a multiple of {SB}")
    g = size // SB
    occ_sb = occ.reshape(g, SB, g, SB, g, SB).any(axis=(1, 3, 5))
    rows = np.zeros((g ** 3, ROW_WORDS), np.uint32)
    rows[:, :16] = pack_superbricks(occ)
    rows[:, 16] = chebyshev_distance(occ_sb).ravel().astype(np.uint32)
    h = size // 2
    occ2 = occ.reshape(h, 2, h, 2, h, 2).any(axis=(1, 3, 5))
    rows[:, 17:19] = pack_node_masks(occ2)
    odist = octant_distances(occ_sb)
    for oct_ in range(8):
        rows[:, 24 + oct_] = odist[oct_].ravel().astype(np.uint32)
    return rows


def build_jump_grid(occ, device="cuda") -> JumpGrid:
    """Build from dense bool occupancy [z,y,x] (numpy array or tensor);
    the rows land on `device`."""
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    rows = build_jump_rows(occ)
    return JumpGrid(torch.from_numpy(rows.view(np.int32)).to(device),
                    occ.shape[0])
