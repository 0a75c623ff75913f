"""Paged two-level grid — the acceleration structure of worlds past 512^3.

Counterpart of vvr_tpu/world/paged.py `build_paged_grid`: the same host
numpy build, word for word, with the tables moved to the device as int32
tensors of u32 bit patterns (the CUDA kernel reads them as uint32, the
plain torch tracer widens them to int64).

  page table `prows` ((S/32)^3, 8), x-major, one 32 B row per 32^3 page
  (4^3 superbricks):
    w0, w1 : the 64-bit mask of the page's occupied superbricks, bit =
             sx | sy<<2 | sz<<4
    w2     : the page's pool base, the sum of the earlier pages' counts
    w3     : 8 octant jump radii in pages, 4 bits each (capped at 15);
             0 for a page with an occupied superbrick
    w4..7  : zero
  brick pool `brows` (cap, 20), one 80 B row per occupied superbrick in
  (page x-major, in-page bit) order:
    w0..15 : the superbrick's 512 voxel bits (world/jumpgrid.py's layout)
    w16, 17: the 64-bit any-mask of its 2^3 subcells
    w18, 19: zero
  cap is the least power of two >= max(rows, 512); the rows past the
  occupied ones are zero.

A world whose size is not a multiple of 32 is zero-padded in the tables
only: `size` stays the true size, which the tracer's exit tests use, and
`psize` (the page table's edge) comes from the table. At 1024^3 (the
generated terrain, depth 5): 6,376 of 32,768 pages and 352,219 of
2,097,152 superbricks are occupied, so the pool rounds up to 524,288 rows,
40 MiB, beside a 1 MiB page table; the flat grid's rows take 256 MiB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vvr_tpu_torch.world.jumpgrid import (SB, octant_distances,
                                          pack_node_masks, pack_superbricks)

PG = 32          # page edge, voxels
PAGE_SB = 4      # superbricks per page edge
POOL_WORDS = 20
PAGE_WORDS = 8


@dataclasses.dataclass
class PagedGrid:
    """prows ((P^3, 8)) and brows ((cap, 20)), int32 u32 bit patterns."""

    prows: torch.Tensor
    brows: torch.Tensor
    size: int            # the true world size

    @property
    def psize(self) -> int:
        """The page table's edge, from the table (padded worlds)."""
        n = self.prows.shape[0]
        m = round(n ** (1 / 3))
        return next(mm for mm in (m - 1, m, m + 1) if mm ** 3 == n)

    @property
    def gsize(self) -> int:
        return self.psize * PAGE_SB

    def memory_bytes(self) -> int:
        return (self.prows.numel() + self.brows.numel()) * 4


def build_paged_rows(occ: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(prows (P^3, 8) u32, brows (cap, 20) u32) from dense bool occupancy
    [z, y, x], padded to a multiple of the page edge in the tables only."""
    occ = np.asarray(occ, bool)
    size = occ.shape[0]
    padded = -(-size // PG) * PG
    if padded != size:
        ext = np.zeros((padded, padded, padded), bool)
        ext[:size, :size, :size] = occ
        occ = ext
    g = padded // SB
    p = padded // PG

    occ_sb = occ.reshape(g, SB, g, SB, g, SB).any(axis=(1, 3, 5))  # [z,y,x]
    per_page = occ_sb.reshape(p, PAGE_SB, p, PAGE_SB, p, PAGE_SB)
    counts = per_page.sum(axis=(1, 3, 5)).ravel().astype(np.int64)
    base = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=base[1:])
    n_pool = int(counts.sum())

    prows = np.zeros((p ** 3, PAGE_WORDS), np.uint32)
    prows[:, 0:2] = pack_node_masks(occ_sb)
    prows[:, 2] = base.astype(np.uint32)
    occ_pg = per_page.any(axis=(1, 3, 5))
    odist = np.minimum(octant_distances(occ_pg, cap=15), 15).astype(
        np.uint32)
    packed = np.zeros((p, p, p), np.uint32)
    for oct_ in range(8):
        packed |= odist[oct_] << np.uint32(4 * oct_)
    prows[:, 3] = packed.ravel()

    # the occupied superbricks in (page x-major, in-page bit) order
    gz, gy, gx = np.nonzero(occ_sb)
    page_id = ((gx >> 2).astype(np.int64) + (gy >> 2).astype(np.int64) * p
               + (gz >> 2).astype(np.int64) * p * p)
    bit = (gx & 3) | ((gy & 3) << 2) | ((gz & 3) << 4)
    order = np.argsort(page_id * 64 + bit, kind="stable")
    sb_flat = (gx.astype(np.int64) + gy.astype(np.int64) * g
               + gz.astype(np.int64) * g * g)[order]

    h = padded // 2
    occ2 = occ.reshape(h, 2, h, 2, h, 2).any(axis=(1, 3, 5))
    cap = 512
    while cap < n_pool:
        cap *= 2
    brows = np.zeros((cap, POOL_WORDS), np.uint32)
    brows[:n_pool, 0:16] = pack_superbricks(occ)[sb_flat]
    brows[:n_pool, 16:18] = pack_node_masks(occ2)[sb_flat]
    return prows, brows


def build_paged_grid(occ, device="cuda") -> PagedGrid:
    """Build from dense bool occupancy [z, y, x] (numpy array or tensor);
    the tables land on `device`."""
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    prows, brows = build_paged_rows(occ)
    return PagedGrid(torch.from_numpy(prows.view(np.int32)).to(device),
                     torch.from_numpy(brows.view(np.int32)).to(device),
                     occ.shape[0])
