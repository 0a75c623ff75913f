"""World edits — set or clear voxels and patch the device structures.

Counterpart of vvr_tpu/world/edit.py `WorldEditor`: an edit changes the
chunks' voxels, then patches each attached structure with row scatters
on its device, in place wherever the tensor keeps its size:
- the brick pyramid (`WorldEditor(chunks, pyramid=...)`, :220-262): the
  edited voxels' ancestor row at every level; level 1 from the voxels
  (any = full), each level above from the patched rows of the level
  below, on the device (a child is any where its any mask is not 0, full
  where its full mask is all ones): the JAX editor recomputes each row
  from its dense occupancy, the whole world at the top level. No grouped
  rows are kept, so the rows patched are the ancestors only, where the
  JAX count adds the members of their 2x2x2 groups;
- the jump grid (`attach_jump_grid`): the edited superbricks' rows, and
  both distance columns grid-wide when a superbrick turns empty or
  non-empty;
- the paged grid (`attach_paged`): the pool rows of still-occupied
  superbricks, or on a superbrick flip its page's pool span and page row
  (each page has slack and reads its pool base from its own row, so no
  other page moves; a page that outgrows its span moves into a shared
  tail, and an exhausted tail rebuilds the grid), and the octant-radius
  column when a page flips;
- the exposed faces (`attach_faces_incremental`): each touched region's
  faces, re-extracted with a one-voxel halo into its fixed slot of the
  face arrays (sentinel rows of zero extent pad a slot); a slot overflow
  re-packs every region's kept faces into the arrays.
After the same edits every array equals the JAX editor's, element for
element.

The JAX editor keeps a dense host copy of the world (1 GiB at 1024^3)
beside the chunks. This one reads the chunks' own voxels (the scene's,
edited in place) and assembles the dense view only in `occupancy()`, for
tests and tools.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk
from vvr_tpu_torch.world.faces import (FIELDS, FaceSet,
                                       extract_merged_faces,
                                       extract_merged_faces_region)
from vvr_tpu_torch.world.generator import assemble_dense
from vvr_tpu_torch.world.jumpgrid import (SB, JumpGrid, chebyshev_distance,
                                          octant_distances, pack_node_masks,
                                          pack_superbricks)
from vvr_tpu_torch.world.paged import (PAGE_SB, PAGE_WORDS, PG, POOL_WORDS,
                                       PagedGrid)
from vvr_tpu_torch.world.pyramid import BrickPyramid, pack_bits64

# the 64 children of a node in bit order (x | y<<2 | z<<4): (64, 3) x, y, z
NODE_CHILDREN = np.stack([np.arange(64) & 3, (np.arange(64) >> 2) & 3,
                          np.arange(64) >> 4], -1)

SENTINEL = -8   # the corner of a face slot's padding rows (zero extent)


def world_depth(size: int) -> int:
    """The tree depth of a world of edge `size`, log4(size). The JAX
    editor derives it for any size (vvr_tpu/world/edit.py:38) and is
    wrong where size is not a power of 4 (ROADMAP C4): refused here."""
    size = int(size)
    depth = (size.bit_length() - 1) // 2
    if size < 1 or 4 ** depth != size:
        raise ValueError(f"world size {size} is not a power of 4, so it has "
                         "no tree depth (ROADMAP C4)")
    return depth


def _as_u32(a: np.ndarray, device) -> torch.Tensor:
    """A copy of u32 words on `device` as the int32 tensor the kernels
    read."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32).copy()).to(device)


def _mask_below(lo: int, hi: int, bit: int) -> int:
    """Set bits of the 64-bit mask (lo, hi) below `bit`: a superbrick's
    rank in its page's pool span."""
    if bit >= 32:
        return int(lo).bit_count() + (int(hi) & ((1 << (bit - 32)) - 1)
                                      ).bit_count()
    return (int(lo) & ((1 << bit) - 1)).bit_count()


def _empty_faces(size: int) -> FaceSet:
    z = np.zeros(0, np.int32)
    return FaceSet(z, z, z, z, z, size, z, z, z)


class WorldEditor:
    """The mutable world: the chunks, and the structures attached to it.
    `size` is the world's edge (the pyramid's, given one); the structures'
    patches land on `device` (the pyramid's and an attached grid's own
    device for them)."""

    def __init__(self, chunks: list[Chunk],
                 pyramid: BrickPyramid | None = None, jumpgrid=None,
                 size: int | None = None, device="cuda"):
        if size is None:
            if pyramid is None:
                raise ValueError("size is required (the world's edge)")
            size = pyramid.size
        if pyramid is not None and pyramid.size != size:
            raise ValueError(f"a {pyramid.size}^3 pyramid for a {size}^3 "
                             "world")
        self.pyramid = pyramid
        self.size = int(size)
        self.depth = world_depth(self.size)
        self.device = torch.device(device)
        self.chunks = chunks
        self._chunk_index = {tuple(int(v) for v in c.position): c
                             for c in chunks}
        self.jumpgrid: JumpGrid | None = None
        self.paged: PagedGrid | None = None
        self.faces: tuple | None = None
        self.last_timings: dict = {}
        self._pg_prows = None      # the paged grid's host mirrors
        self._fc_sets = None       # each region's faces (incremental faces)
        self._fc_total = 0
        self._fc_dev = None        # (8, total) int32: the faces' storage
        if jumpgrid is not None:
            self.attach_jump_grid(jumpgrid)

    # ---- reading the chunks ---------------------------------------------

    def _box(self, x0: int, y0: int, z0: int, n: int) -> np.ndarray:
        """bool (n, n, n) [z, y, x] of the voxels from (x0, y0, z0): False
        outside the world and where no chunk exists."""
        out = np.zeros((n, n, n), bool)
        org = np.array([x0, y0, z0])
        lo = np.maximum(org, 0)
        hi = np.minimum(org + n, self.size)
        if (hi <= lo).any():
            return out
        c0, c1 = lo // CHUNK_SIZE, (hi - 1) // CHUNK_SIZE
        for cz in range(c0[2], c1[2] + 1):
            for cy in range(c0[1], c1[1] + 1):
                for cx in range(c0[0], c1[0] + 1):
                    c = self._chunk_index.get((cx, cy, cz))
                    if c is None:
                        continue
                    cb = np.array([cx, cy, cz]) * CHUNK_SIZE
                    a0 = np.maximum(lo, cb)
                    a1 = np.minimum(hi, cb + CHUNK_SIZE)
                    o0, o1, l0, l1 = a0 - org, a1 - org, a0 - cb, a1 - cb
                    out[o0[2]:o1[2], o0[1]:o1[1], o0[0]:o1[0]] = c.voxels[
                        l0[2]:l1[2], l0[1]:l1[1], l0[0]:l1[0]]
        return out

    def occupancy(self) -> np.ndarray:
        """The dense bool occupancy [z, y, x], assembled from the chunks
        (1 GiB at 1024^3: for tests and tools, not the edit path)."""
        return assemble_dense(self.chunks, self.size)

    def _occ_sb(self) -> np.ndarray:
        """bool (g, g, g) [z, y, x]: which 8^3 superbricks hold a voxel."""
        g, m = self.size // SB, CHUNK_SIZE // SB
        occ_sb = np.zeros((g, g, g), bool)
        for (cx, cy, cz), c in self._chunk_index.items():
            if c.voxels.any():
                occ_sb[cz * m:(cz + 1) * m, cy * m:(cy + 1) * m,
                       cx * m:(cx + 1) * m] = c.voxels.reshape(
                    m, SB, m, SB, m, SB).any(axis=(1, 3, 5))
        return occ_sb

    def _sb_words(self, sbs: np.ndarray):
        """(words (K, 16), sub2 (K, 2), occupied (K,)) of (K, 3) x, y, z
        superbricks: the 512 voxel bits in the jump grid's word order, the
        64-bit any-mask of the 2^3 subcells (bit = cx | cy<<2 | cz<<4)
        and whether the superbrick holds a voxel."""
        k = len(sbs)
        regions = np.stack([self._box(int(x) * SB, int(y) * SB,
                                      int(z) * SB, SB) for x, y, z in sbs]
                           ) if k else np.zeros((0, SB, SB, SB), bool)
        words = np.packbits(regions.reshape(k, 512), axis=1,
                            bitorder="little").view(np.uint32)
        sub = regions.reshape(k, 4, 2, 4, 2, 4, 2).any(axis=(2, 4, 6))
        sub2 = np.packbits(sub.reshape(k, 64), axis=1,
                           bitorder="little").view(np.uint32)
        return words, sub2, regions.any(axis=(1, 2, 3))

    def _voxels(self, v: np.ndarray) -> np.ndarray:
        """bool (M,): the voxels at (M, 3) x, y, z inside the world, read
        from their chunks (False where no chunk exists)."""
        out = np.zeros(len(v), bool)
        keys = v // CHUNK_SIZE
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        for ki, key in enumerate(uniq):
            c = self._chunk_index.get(tuple(int(k) for k in key))
            if c is not None:
                sel = inv == ki
                lv = v[sel] % CHUNK_SIZE
                out[sel] = c.voxels[lv[:, 2], lv[:, 1], lv[:, 0]]
        return out

    # ---- edits -----------------------------------------------------------

    def set_voxels(self, positions: np.ndarray, solid: bool) -> int:
        """Set (solid) or clear the voxels at (K, 3) int world coords x, y,
        z (those outside the world are dropped), creating chunks where
        none exist, then patch the attached structures, timing each
        (`last_timings`: pyramid_ms, paged_ms, jump_ms, faces_ms, host
        clock around each patch). Returns the pyramid's rows written plus
        the paged grid's pool rows written (the edited positions' count
        after a rebuild)."""
        positions = np.atleast_2d(np.asarray(positions, np.int64))
        positions = positions[
            np.all((positions >= 0) & (positions < self.size), axis=1)]
        self.last_timings = {}
        if len(positions) == 0:
            return 0
        keys = positions // CHUNK_SIZE
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        for ki, key_arr in enumerate(uniq):
            key = tuple(int(v) for v in key_arr)
            c = self._chunk_index.get(key)
            if c is None:
                c = Chunk(np.array(key), np.zeros((CHUNK_SIZE,) * 3, bool))
                self._chunk_index[key] = c
                self.chunks.append(c)
            sel = positions[inv == ki] % CHUNK_SIZE
            c.voxels[sel[:, 2], sel[:, 1], sel[:, 0]] = solid

        def timed(tag, fn):
            t0 = _time.monotonic()
            out = fn(positions)
            self.last_timings[tag] = round((_time.monotonic() - t0) * 1e3, 1)
            return out

        n_patched = 0
        if self.pyramid is not None:
            n_patched += timed("pyramid_ms", self._patch_pyramid)
        if self._pg_prows is not None:
            n_patched += timed("paged_ms", self._patch_paged)
        if self.jumpgrid is not None:
            timed("jump_ms", self._patch_jump_grid)
        if self.faces is not None:
            timed("faces_ms", self._refresh_faces)
        return n_patched

    # ---- the brick pyramid (world/pyramid.py) ------------------------------

    def _patch_pyramid(self, positions: np.ndarray) -> int:
        """Each edited voxel's ancestor row at every level, one scatter a
        level (module docstring). Returns the rows written."""
        pyr = self.pyramid
        rows, bases = pyr.rows, pyr.bases
        dev = rows.device
        n = 0
        for level in range(1, pyr.depth + 1):
            cells = np.unique(positions >> (2 * level), axis=0)
            k = len(cells)
            child = (cells[:, None, :] * 4 + NODE_CHILDREN[None]).reshape(
                -1, 3)
            if level == 1:
                bits = torch.from_numpy(self._voxels(child).reshape(k, 64))
                masks = pack_bits64(bits).to(dev)
                vals = torch.cat([masks, masks], 1)
            else:
                gc = self.size >> (2 * (level - 1))
                cidx = (bases[level - 1] + child[:, 0] + child[:, 1] * gc
                        + child[:, 2] * gc * gc)
                crow = rows[torch.from_numpy(cidx).to(dev)].view(k, 64, 4)
                any_b = (crow[..., 0] != 0) | (crow[..., 1] != 0)
                full_b = (crow[..., 2] == -1) & (crow[..., 3] == -1)
                vals = torch.cat([pack_bits64(any_b), pack_bits64(full_b)], 1)
            g = self.size >> (2 * level)
            idx = bases[level] + cells[:, 0] + cells[:, 1] * g \
                + cells[:, 2] * g * g
            rows.index_copy_(0, torch.from_numpy(idx).to(dev), vals)
            n += k
        return n

    # ---- the jump grid (world/jumpgrid.py) --------------------------------

    def attach_jump_grid(self, grid: JumpGrid) -> JumpGrid:
        """Keep `grid` in step with the edits. Host copies of the
        superbrick occupancy and of both distance fields let a patch be
        assembled without reading the device."""
        self.jumpgrid = grid
        self._occ_sb_j = self._occ_sb()
        self._jg_dist = chebyshev_distance(self._occ_sb_j)
        self._jg_odist = octant_distances(self._occ_sb_j)
        return grid

    def _patch_jump_grid(self, positions: np.ndarray) -> None:
        """The edited superbricks' rows (one scatter). The distance fields
        depend only on which superbricks hold a voxel: when an edit flips
        one, both are recomputed and their columns rewritten grid-wide (a
        stale radius would jump over the new voxels)."""
        g = self.size // SB
        sbs = np.unique(positions >> 3, axis=0)
        vals = np.zeros((len(sbs), 32), np.uint32)
        words, sub2, new_sb = self._sb_words(sbs)
        vals[:, :16] = words
        vals[:, 17:19] = sub2
        old_sb = self._occ_sb_j[sbs[:, 2], sbs[:, 1], sbs[:, 0]]
        flipped = bool((new_sb != old_sb).any())
        if flipped:
            self._occ_sb_j[sbs[:, 2], sbs[:, 1], sbs[:, 0]] = new_sb
            self._jg_dist = chebyshev_distance(self._occ_sb_j)
            self._jg_odist = octant_distances(self._occ_sb_j)
        vals[:, 16] = self._jg_dist[sbs[:, 2], sbs[:, 1], sbs[:, 0]]
        for oct_ in range(8):
            vals[:, 24 + oct_] = self._jg_odist[oct_, sbs[:, 2], sbs[:, 1],
                                                sbs[:, 0]]
        rows = self.jumpgrid.rows
        idx = sbs[:, 0] + sbs[:, 1] * g + sbs[:, 2] * g * g
        rows.index_copy_(0, torch.from_numpy(idx).to(rows.device),
                         _as_u32(vals, rows.device))
        if flipped:
            cols = np.concatenate([self._jg_dist.reshape(1, -1),
                                   self._jg_odist.reshape(8, -1)])
            rows[:, [16] + list(range(24, 32))] = _as_u32(
                cols.T, rows.device)

    # ---- the paged two-level grid (world/paged.py) ------------------------

    def attach_paged(self, tail_slack: int = 4096) -> PagedGrid:
        """An editable paged grid (world/paged.py's layout) whose pages
        each reserve count + max(count/4, 2) pool rows, followed by a
        shared tail of `tail_slack` rows: the tracer reads each page's
        pool base from its own row, so a superbrick flip rewrites only
        its page's span. The size must be a multiple of the page edge."""
        if self.size % PG:
            raise ValueError(f"the paged grid needs a size that is a "
                             f"multiple of {PG}, got {self.size} (ROADMAP "
                             "C4)")
        p = self.size // PG
        occ_sb = self._occ_sb()
        per_page = occ_sb.reshape(p, PAGE_SB, p, PAGE_SB, p, PAGE_SB)
        counts = per_page.sum(axis=(1, 3, 5)).ravel().astype(np.int64)
        caps = counts + np.maximum(counts // 4, 2)
        base = np.zeros_like(caps)
        np.cumsum(caps[:-1], out=base[1:])
        total = int(caps.sum()) + tail_slack

        prows = np.zeros((p ** 3, PAGE_WORDS), np.uint32)
        prows[:, 0:2] = pack_node_masks(occ_sb)
        prows[:, 2] = base.astype(np.uint32)
        occ_pg = per_page.any(axis=(1, 3, 5))
        prows[:, 3] = self._paged_odist_col(occ_pg)

        # every occupied superbrick's words, chunk by chunk, then the pool
        # order: page x-major, in-page bit
        m = CHUNK_SIZE // SB
        lz, ly, lx = (a.ravel() for a in np.meshgrid(
            np.arange(m), np.arange(m), np.arange(m), indexing="ij"))
        parts = []
        for (cx, cy, cz), c in self._chunk_index.items():
            v = c.voxels
            if not v.any():
                continue
            occ = v.reshape(m, SB, m, SB, m, SB).any(axis=(1, 3, 5)).ravel()
            h = CHUNK_SIZE // 2
            sub = pack_node_masks(v.reshape(h, 2, h, 2, h, 2).any(
                axis=(1, 3, 5)))
            parts.append((np.stack([lx[occ] + cx * m, ly[occ] + cy * m,
                                    lz[occ] + cz * m], -1),
                          pack_superbricks(v)[occ], sub[occ]))
        brows = np.zeros((total, POOL_WORDS), np.uint32)
        if parts:
            sbs, words, sub2 = (np.concatenate(a) for a in zip(*parts))
            gx, gy, gz = (sbs[:, i].astype(np.int64) for i in range(3))
            page_id = (gx >> 2) + (gy >> 2) * p + (gz >> 2) * p * p
            bit = (gx & 3) | ((gy & 3) << 2) | ((gz & 3) << 4)
            order = np.argsort(page_id * 64 + bit, kind="stable")
            pid_s = page_id[order]
            newp = np.ones(len(pid_s), bool)
            newp[1:] = pid_s[1:] != pid_s[:-1]
            firsts = np.maximum.accumulate(
                np.where(newp, np.arange(len(pid_s)), 0))
            rowi = base[pid_s] + np.arange(len(pid_s)) - firsts
            brows[rowi, 0:16] = words[order]
            brows[rowi, 16:18] = sub2[order]

        self._pg_occ_sb = occ_sb
        self._pg_occ_pg = occ_pg
        self._pg_counts = counts
        self._pg_caps = caps
        self._pg_base = base
        self._pg_spare = int(caps.sum())   # the tail's allocation cursor
        self._pg_total = total
        self._pg_brows_host = brows
        self._pg_prows = prows
        self.paged = PagedGrid(_as_u32(prows, self.device),
                               _as_u32(brows, self.device), self.size)
        return self.paged

    @staticmethod
    def _paged_odist_col(occ_pg: np.ndarray) -> np.ndarray:
        """The page rows' word 3: 8 octant jump radii in pages, 4 bits
        each, capped at 15."""
        odist = np.minimum(octant_distances(occ_pg, cap=15), 15).astype(
            np.uint32)
        packed = np.zeros(occ_pg.shape, np.uint32)
        for oct_ in range(8):
            packed |= odist[oct_] << np.uint32(4 * oct_)
        return packed.ravel()

    def _patch_paged(self, positions: np.ndarray) -> int:
        """Without a superbrick flip, the touched pool rows of the
        still-occupied superbricks; with one, every touched page's pool
        span (moved into the tail when it outgrows its slack; an exhausted
        tail rebuilds the grid) and page row, and the octant-radius column
        when a page turns empty or non-empty. Returns the pool rows
        written."""
        p = self.size // PG
        aff = np.unique(positions >> 3, axis=0)            # (K, 3) x, y, z
        words, sub2, new_occ = self._sb_words(aff)
        page_id = ((aff[:, 0] >> 2) + (aff[:, 1] >> 2) * p
                   + (aff[:, 2] >> 2) * p * p).astype(np.int64)
        bit = (aff[:, 0] & 3) | ((aff[:, 1] & 3) << 2) | ((aff[:, 2] & 3)
                                                          << 4)
        old_occ = self._pg_occ_sb[aff[:, 2], aff[:, 1], aff[:, 0]]
        flip = new_occ != old_occ
        row_idx, row_val, prow_idx = [], [], []
        page_flip = False
        if not flip.any():
            for k in np.nonzero(new_occ)[0]:
                pg = int(page_id[k])
                r = int(self._pg_base[pg]) + _mask_below(
                    self._pg_prows[pg, 0], self._pg_prows[pg, 1], int(bit[k]))
                vals = np.zeros(POOL_WORDS, np.uint32)
                vals[0:16] = words[k]
                vals[16:18] = sub2[k]
                self._pg_brows_host[r] = vals
                row_idx.append(np.array([r]))
                row_val.append(vals[None])
        else:
            self._pg_occ_sb[aff[:, 2], aff[:, 1], aff[:, 0]] = new_occ
            for pgi in (int(v) for v in np.unique(page_id)):
                px, py, pz = pgi % p, (pgi // p) % p, pgi // (p * p)
                reg = self._pg_occ_sb[pz * PAGE_SB:(pz + 1) * PAGE_SB,
                                      py * PAGE_SB:(py + 1) * PAGE_SB,
                                      px * PAGE_SB:(px + 1) * PAGE_SB]
                newmask = pack_node_masks(reg)[0]
                cnt = int(reg.sum())
                if cnt > self._pg_caps[pgi]:
                    # the page moves into the shared tail
                    need = cnt + max(cnt // 4, 2)
                    if self._pg_spare + need > self._pg_total:
                        return self._paged_full_rebuild(positions)
                    self._pg_base[pgi] = self._pg_spare
                    self._pg_caps[pgi] = need
                    self._pg_spare += need
                # the page's new span: touched superbricks from their fresh
                # words, the others from their old rows
                lz, ly, lx = np.nonzero(reg)
                bits_n = (lx | (ly << 2) | (lz << 4)).astype(np.int64)
                o = np.argsort(bits_n)
                bits_n = bits_n[o]
                gxyz = np.stack([px * PAGE_SB + lx[o], py * PAGE_SB + ly[o],
                                 pz * PAGE_SB + lz[o]], -1)
                new_rows = np.zeros((cnt, POOL_WORDS), np.uint32)
                old_lo, old_hi, ob = (int(v) for v in self._pg_prows[pgi,
                                                                     0:3])
                in_aff = {(int(a[0]), int(a[1]), int(a[2])): k
                          for k, a in enumerate(aff)
                          if int(page_id[k]) == pgi}
                for r_i in range(cnt):
                    k = in_aff.get(tuple(int(v) for v in gxyz[r_i]))
                    if k is not None:
                        new_rows[r_i, 0:16] = words[k]
                        new_rows[r_i, 16:18] = sub2[k]
                    else:
                        b = int(bits_n[r_i])
                        was = ((old_hi >> (b - 32)) & 1 if b >= 32
                               else (old_lo >> b) & 1)
                        if not was:
                            raise RuntimeError("a surviving superbrick is "
                                               "missing from its page mask")
                        new_rows[r_i] = self._pg_brows_host[
                            ob + _mask_below(old_lo, old_hi, b)]
                nb = int(self._pg_base[pgi])
                self._pg_brows_host[nb:nb + cnt] = new_rows
                row_idx.append(np.arange(nb, nb + cnt))
                row_val.append(new_rows)
                self._pg_counts[pgi] = cnt
                self._pg_prows[pgi, 0:2] = newmask
                self._pg_prows[pgi, 2] = np.uint32(nb)
                prow_idx.append(pgi)
                if (cnt > 0) != ((old_lo | old_hi) != 0):
                    page_flip = True
        prows, brows = self.paged.prows, self.paged.brows
        if page_flip:
            self._pg_occ_pg = self._pg_occ_sb.reshape(
                p, PAGE_SB, p, PAGE_SB, p, PAGE_SB).any(axis=(1, 3, 5))
            self._pg_prows[:, 3] = self._paged_odist_col(self._pg_occ_pg)
            prows[:, 3] = _as_u32(self._pg_prows[:, 3], prows.device)
        if prow_idx:
            idx = np.asarray(prow_idx, np.int64)
            prows.index_copy_(0, torch.from_numpy(idx).to(prows.device),
                              _as_u32(self._pg_prows[idx], prows.device))
        if row_idx:
            idx = np.concatenate(row_idx).astype(np.int64)
            brows.index_copy_(0, torch.from_numpy(idx).to(brows.device),
                              _as_u32(np.concatenate(row_val),
                                      brows.device))
        return int(sum(len(i) for i in row_idx))

    def _paged_full_rebuild(self, positions: np.ndarray) -> int:
        """The tail is exhausted: the grid is built again (new tensors,
        the default tail)."""
        self.attach_paged()
        return int(len(positions))

    # ---- the exposed faces (world/faces.py) -------------------------------

    def attach_faces(self, faces=None) -> tuple:
        """Keep the merged faces of the whole world in step with the
        edits, extracted again in full after each edit."""
        self.faces = faces if faces is not None else extract_merged_faces(
            self.occupancy()).device_tuple(self.device)
        return self.faces

    def attach_faces_incremental(self, region: int = CHUNK_SIZE,
                                 slack: float = 0.5, pad_rows: int = 4,
                                 total_rows: int | None = None) -> tuple:
        """Faces extracted region by region (runs stop at a region's
        edge, extract_merged_faces_region), each region in a slot of
        count + max(count * slack, pad_rows) rows of arrays whose length
        (`total_rows`, at least 1.25 times the slots, a multiple of 4096)
        an overflow never shrinks; padding rows have zero extent at
        (SENTINEL,) * 3, which the rasterizer and the sun-grid build skip
        (eu > 0)."""
        self._fc_region = int(region)
        nr = self.size // self._fc_region
        self._fc_sets = {(rx, ry, rz): self._region_faces(rx, ry, rz)
                         for rz in range(nr) for ry in range(nr)
                         for rx in range(nr)}
        return self._pack_faces(slack, pad_rows, total_rows)

    def _pack_faces(self, slack: float, pad_rows: int,
                    total_rows: int | None) -> tuple:
        """Lay every region's kept faces into fresh slots (x-major region
        order) and upload them, in place where the length is kept."""
        nr = self.size // self._fc_region
        counts = np.zeros(nr ** 3, np.int64)
        for (rx, ry, rz), fs in self._fc_sets.items():
            counts[rx + ry * nr + rz * nr * nr] = len(fs)
        caps = np.maximum(counts + (counts * slack).astype(np.int64),
                          counts + pad_rows)
        base = np.zeros_like(caps)
        np.cumsum(caps[:-1], out=base[1:])
        if total_rows is None:
            total_rows = self._fc_total
        total = max(int(total_rows), (int(caps.sum()) * 5 + 3) // 4)
        total = -(-total // 4096) * 4096
        host = np.zeros((len(FIELDS), total), np.int32)
        host[0:3] = SENTINEL
        for (rx, ry, rz), fs in self._fc_sets.items():
            b = int(base[rx + ry * nr + rz * nr * nr])
            for i, k in enumerate(FIELDS):
                host[i, b:b + len(fs)] = getattr(fs, k)
        self._fc_base, self._fc_caps, self._fc_counts = base, caps, counts
        self._fc_total = total
        self._fc_host = host
        if self._fc_dev is not None and self._fc_dev.shape[1] == total:
            self._fc_dev.copy_(torch.from_numpy(host))
        else:
            self._fc_dev = torch.from_numpy(host.copy()).to(self.device)
        self.faces = tuple(self._fc_dev[i] for i in range(len(FIELDS)))
        return self.faces

    def _region_faces(self, rx: int, ry: int, rz: int) -> FaceSet:
        """The merged faces of region (rx, ry, rz), from its voxels and a
        one-voxel halo (empty outside the world). A halo with no voxel or
        with every voxel has no exposed face in its core."""
        cs = self._fc_region
        x0, y0, z0 = rx * cs, ry * cs, rz * cs
        halo = self._box(x0 - 1, y0 - 1, z0 - 1, cs + 2)
        if not halo.any() or halo.all():
            return _empty_faces(self.size)
        return extract_merged_faces_region(halo, (x0, y0, z0), self.size,
                                           cs)

    def _refresh_faces(self, positions: np.ndarray) -> None:
        """Re-extract every region an edit can change (the positions' own
        and those across a region edge from them: an edit changes its
        neighbours' exposure) into its slot; if one outgrows its slot,
        re-pack all regions with the default slack. Without incremental
        faces, extract the whole world again."""
        if self._fc_sets is None:
            self.faces = extract_merged_faces(self.occupancy()).device_tuple(
                self.device)
            return
        cs = self._fc_region
        nr = self.size // cs
        cand = [positions]
        for ax in range(3):
            for d in (-1, 1):
                q = positions.copy()
                q[:, ax] += d
                cand.append(q)
        cand = np.concatenate(cand, 0)
        cand = cand[np.all((cand >= 0) & (cand < self.size), axis=1)]
        regs = [tuple(int(v) for v in r) for r in np.unique(cand // cs,
                                                            axis=0)]
        overflow = False
        for key in regs:
            fs = self._region_faces(*key)
            self._fc_sets[key] = fs
            ri = key[0] + key[1] * nr + key[2] * nr * nr
            overflow |= len(fs) > self._fc_caps[ri]
        if overflow:
            self._pack_faces(0.5, 4, None)
            return
        idx = []
        for key in regs:
            ri = key[0] + key[1] * nr + key[2] * nr * nr
            fs = self._fc_sets[key]
            b, cap, n = (int(self._fc_base[ri]), int(self._fc_caps[ri]),
                         len(fs))
            slot = self._fc_host[:, b:b + cap]
            slot[:] = 0
            slot[0:3] = SENTINEL
            for i, k in enumerate(FIELDS):
                slot[i, :n] = getattr(fs, k)
            self._fc_counts[ri] = n
            idx.append(np.arange(b, b + cap))
        if idx:
            idx = np.concatenate(idx)
            dev = self._fc_dev.device
            self._fc_dev.index_copy_(
                1, torch.from_numpy(idx).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    self._fc_host[:, idx])).to(dev))
