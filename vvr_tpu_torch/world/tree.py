"""Sparse voxel 64-tree — the reference-layout flattened buffers.

Counterpart of vvr_tpu/world/tree.py (the reference's SparseVoxelOctree
and convert_to_buffers, src/voxel/sparse.rs:13-205, 318-513): the tree of
4x4x4-branching nodes flattened in BFS (level) order into three parallel
buffers

  indices  : u32, the flat index of the node's first child; FULL_NODE
             marks a full subtree (sparse.rs:389), BOTTOM_NODE a height-1
             node whose children are voxels
  bitmasks : u64, which of the 64 children exist (any occupancy)
  aabbs    : u64, the tight world AABB, 10 bits an axis for min and max,
             both clamped to [0, size-1] (pack_aabb_bounds,
             sparse.rs:299-311)

with the popcount-prefix rule: the child at bit b of a node is at its
base index + popcount(bitmask & ((1 << b) - 1)) (sparse.rs:405-446).
Every output equals the JAX package's array for array.

The flatten runs level by level in torch on the pyramid's device: a
level's nodes are the any-cells without a full ancestor, in (parent BFS
order, bit) order, their bases an exclusive sum of child counts. The
buffers stay there as int32 / int64 tensors of the u32 / u64 bit
patterns; `SparseVoxelTree.numpy` gives the JAX dtypes. No frame reads
the tree: it is the checkpoint artifact (world/cache.py save_tree) and
the reference layout's parity check.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vvr_tpu_torch.utils.bits import popcount32, popcount_prefix_u64, u64_split
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, ChunkKind, build_chunk_mips
from vvr_tpu_torch.world.pyramid import OccupancyPyramid, pack_bits64

FULL_NODE = np.uint32(0xFFFFFFFF - 1)   # src/voxel/util.rs:4
BOTTOM_NODE = np.uint32(0xFFFFFFFF)     # src/voxel/util.rs:3
BIG = 1 << 20                           # the bounds' empty-cell sentinel

# 64 child offsets in bit-index order (bit = x | y<<2 | z<<4)
_OFFS = np.array([[b & 3, (b >> 2) & 3, (b >> 4) & 3] for b in range(64)],
                 np.int32)


@dataclasses.dataclass
class SparseVoxelTree:
    indices: torch.Tensor      # (N,) int32, u32 bit patterns
    bitmasks: torch.Tensor     # (N,) int64, u64 bit patterns
    aabbs: torch.Tensor        # (N,) int64, u64 bit patterns
    level_starts: dict         # height -> first BFS index of that height
    depth: int
    metrics: dict

    @property
    def num_nodes(self) -> int:
        return int(self.indices.numel())

    def numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indices uint32, bitmasks uint64, aabbs uint64) on the host,
        the JAX tree's arrays."""
        return (self.indices.cpu().numpy().view(np.uint32),
                self.bitmasks.cpu().numpy().view(np.uint64),
                self.aabbs.cpu().numpy().view(np.uint64))

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indices, self.bitmasks, self.aabbs))


def _as_u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def bounds_pyramid_from_dense(occ, device="cuda") -> list[torch.Tensor]:
    """Tight world AABBs of every cell of levels 1..depth, (S_l, S_l, S_l,
    6) int32 [z, y, x] (min xyz, max xyz exclusive), on `device`; BIG /
    -BIG where a cell has no solid voxel (vvr_tpu/world/tree.py:62 on the
    host, equal grid for grid). Level 1 comes from each 4^3 block's planes
    of solid voxels, so no voxel-sized bounds grid is made."""
    if isinstance(occ, np.ndarray):
        occ = torch.from_numpy(np.ascontiguousarray(occ, bool))
    occ = occ.to(device=device, dtype=torch.bool)
    size = occ.shape[0]
    depth = (size.bit_length() - 1) // 2
    m = size // 4
    g = occ.reshape(m, 4, m, 4, m, 4)
    lane = torch.arange(4, dtype=torch.int32, device=occ.device)
    cells = torch.arange(m, dtype=torch.int32, device=occ.device) * 4
    mins, maxs = [], []
    # x, y, z: the axis's 4 planes within a block, any over the other two
    for keep, shape in ((5, (1, 1, m)), (3, (1, m, 1)), (1, (m, 1, 1))):
        planes = _planes_last(g, keep)                 # (m, m, m, 4)
        first = torch.where(planes, lane, torch.full_like(lane, 4)).amin(-1)
        last = torch.where(planes, lane, torch.full_like(lane, -1)).amax(-1)
        mins.append(cells.reshape(shape) + first)
        maxs.append(cells.reshape(shape) + last + 1)
    solid = g.any(dim=5).any(dim=3).any(dim=1)
    b = torch.stack(mins + maxs, -1)
    empty = torch.tensor([BIG] * 3 + [-BIG] * 3, dtype=torch.int32,
                         device=occ.device)
    b = torch.where(solid[..., None], b, empty)
    grids = [b]
    for _ in range(2, depth + 1):
        m = b.shape[0] // 4
        gb = b.reshape(m, 4, m, 4, m, 4, 6)
        lo = gb[..., :3].amin(dim=5).amin(dim=3).amin(dim=1)
        hi = gb[..., 3:].amax(dim=5).amax(dim=3).amax(dim=1)
        b = torch.cat([lo, hi], -1)
        grids.append(b)
    return grids


def _planes_last(g: torch.Tensor, keep: int) -> torch.Tensor:
    """(m, 4, m, 4, m, 4) block grid -> (m, m, m, 4): any over the two
    in-block axes other than `keep` (5 x, 3 y, 1 z), that axis last."""
    if keep == 5:
        return g.any(dim=3).any(dim=1)                 # (m, m, m, 4x)
    if keep == 3:
        return g.any(dim=5).any(dim=1).permute(0, 1, 3, 2)   # 4y last
    return g.any(dim=5).any(dim=3).permute(0, 2, 3, 1)       # 4z last


def bounds_pyramid_from_chunks(chunks, size: int) -> list[np.ndarray]:
    """Chunk-mip-based bounds pyramid (levels 1..depth), host NumPy, equal
    grid for grid to vvr_tpu/world/tree.py:87 (a solid-free cell of a
    chunk that holds voxels carries the chunk's origin added to the
    sentinels there, as in the JAX function; the tree reads only solid
    cells)."""
    depth = int(round(np.log2(size) / 2))
    grids = []
    mips = {id(c): build_chunk_mips(c.voxels) for c in chunks
            if c.kind != ChunkKind.EMPTY}
    for k in range(1, 4):
        s = size >> (2 * k)
        cs = CHUNK_SIZE >> (2 * k)
        g = np.empty((s, s, s, 6), np.int32)
        g[..., :3] = BIG
        g[..., 3:] = -BIG
        for c in chunks:
            if id(c) not in mips:
                continue
            x, y, z = (int(v) * cs for v in c.position)
            wb = mips[id(c)].bounds[k].copy()
            origin = c.position.astype(np.int32) * CHUNK_SIZE
            wb[..., :3] += origin
            wb[..., 3:] += origin
            g[z:z + cs, y:y + cs, x:x + cs] = wb
        grids.append(g)
    b = grids[-1]
    for _ in range(4, depth + 1):
        m = b.shape[0] // 4
        gb = b.reshape(m, 4, m, 4, m, 4, 6)
        b = np.concatenate([gb[..., :3].min(axis=(1, 3, 5)),
                            gb[..., 3:].max(axis=(1, 3, 5))], -1)
        grids.append(b)
    return grids


def _pack_aabbs(bmin, bmax, size: int):
    """pack_aabb_bounds (sparse.rs:299-311): min and (exclusive) max both
    clamped to [0, size-1]; 10 bits an axis. Tensors -> int64 tensor,
    numpy -> uint64 (the JAX function)."""
    if torch.is_tensor(bmin):
        mn = bmin.clamp(0, size - 1).to(torch.int64)
        mx = bmax.clamp(0, size - 1).to(torch.int64)
        lo = mn[:, 0] | (mn[:, 1] << 10) | (mn[:, 2] << 20)
        hi = mx[:, 0] | (mx[:, 1] << 10) | (mx[:, 2] << 20)
        return lo | (hi << 30)
    mn = np.clip(bmin, 0, size - 1).astype(np.uint64)
    mx = np.clip(bmax, 0, size - 1).astype(np.uint64)
    lo = mn[:, 0] | (mn[:, 1] << np.uint64(10)) | (mn[:, 2] << np.uint64(20))
    hi = mx[:, 0] | (mx[:, 1] << np.uint64(10)) | (mx[:, 2] << np.uint64(20))
    return lo | (hi << np.uint64(30))


def surface_area_bitmask(mask: int) -> int:
    """Exposed-face count of the 4x4x4 bitmask (the reference's optional
    SAH metric, src/voxel/sparse.rs:469,524-545)."""
    area = 0
    for b in range(64):
        if not (mask >> b) & 1:
            continue
        x, y, z = b & 3, (b >> 2) & 3, (b >> 4) & 3
        for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                           (0, 0, 1), (0, 0, -1)):
            nx, ny, nz = x + dx, y + dy, z + dz
            if not (0 <= nx < 4 and 0 <= ny < 4 and 0 <= nz < 4):
                area += 1
            elif not (mask >> (nx | (ny << 2) | (nz << 4))) & 1:
                area += 1
    return area


def _popcount64(masks: torch.Tensor) -> torch.Tensor:
    lo, hi = u64_split(masks)
    return popcount32(lo) + popcount32(hi)


def flatten_tree(pyr: OccupancyPyramid, bounds: list,
                 calculate_sah: bool = False) -> SparseVoxelTree:
    """Level-order flatten on the pyramid's device (vvr_tpu/world/tree.py
    :147). `bounds` from bounds_pyramid_from_dense or _from_chunks (numpy
    grids or tensors). calculate_sah adds the normalized surface-area
    metric (the reference's CALCULATE_SAH, sparse.rs:466-476)."""
    t0 = time.monotonic()
    depth, size = pyr.depth, pyr.size
    dev = pyr.words.device
    offs = torch.from_numpy(_OFFS).to(dev)
    masks = {lvl: pyr.level_masks(lvl) for lvl in range(depth + 1)}
    cells = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    full = masks[depth][1].reshape(-1)[:1]
    levels = {}
    for lvl in range(depth, 0, -1):
        child = cells[:, None, :] * 4 + offs[None]             # (M, 64, 3)
        ca = masks[lvl - 1][0]
        cb = ca[child[..., 2], child[..., 1], child[..., 0]]   # (M, 64)
        bitmask = pack_bits64(cb).view(torch.int64).reshape(-1)
        nd = dict(cells=cells, full=full, bitmask=bitmask)
        if lvl > 1:
            expand = cb & ~full[:, None]
            nxt = child.reshape(-1, 3)[expand.reshape(-1)]
            cf = masks[lvl - 1][1]
            nd["child_counts"] = expand.sum(1)
            cells, full = nxt, cf[nxt[:, 2], nxt[:, 1], nxt[:, 0]]
        levels[lvl] = nd

    level_starts, off = {}, 0
    for lvl in range(depth, 0, -1):
        level_starts[lvl] = off
        off += levels[lvl]["cells"].shape[0]
    total = off
    indices, bitmasks, aabbs = [], [], []
    for lvl in range(depth, 0, -1):
        nd = levels[lvl]
        if lvl > 1:
            cc = nd["child_counts"]
            base = level_starts[lvl - 1] + torch.cumsum(cc, 0) - cc
            base = torch.where(nd["full"], int(FULL_NODE), base)
        else:
            base = torch.where(nd["full"], int(FULL_NODE), int(BOTTOM_NODE))
        indices.append(_as_u32_bits(base.to(torch.int64)))
        bitmasks.append(nd["bitmask"])
        g = torch.as_tensor(bounds[lvl - 1]).to(dev)
        c = nd["cells"].to(torch.int64)
        bb = g[c[:, 2], c[:, 1], c[:, 0]]
        aabbs.append(_pack_aabbs(bb[:, :3], bb[:, 3:], size))
    indices = torch.cat(indices)
    bitmasks = torch.cat(bitmasks)
    aabbs = torch.cat(aabbs)

    full_count = int(sum(int(nd["full"].sum()) for nd in levels.values()))
    set_bits = int(_popcount64(bitmasks).sum())
    metrics = dict(
        nodes=total,
        build_time_s=time.monotonic() - t0,
        full_nodes=full_count,
        avg_bits_set=set_bits / max(total, 1),
        level_counts={lvl: int(levels[lvl]["cells"].shape[0])
                      for lvl in range(depth, 0, -1)},
    )
    if calculate_sah:
        area_4x4x4 = 4 * 4 * 6
        host = bitmasks.cpu().numpy().view(np.uint64)
        sah = sum(surface_area_bitmask(int(m)) / area_4x4x4 for m in host)
        metrics["sah_total"] = sah
        metrics["sah_normalized_pct"] = 100.0 * sah / max(total, 1)
    return SparseVoxelTree(indices, bitmasks, aabbs, level_starts, depth,
                           metrics)


def verify_popcount_invariant(tree: SparseVoxelTree) -> None:
    """The invariant the GPU traversal relies on (sparse.rs:405-446),
    checked as vvr_tpu/world/tree.py:239 checks it: each expandable node's
    base is the next level's start plus the popcounts of the expandable
    nodes before it, the children exactly fill the next level, and on a
    sample of 64 nodes a level every set bit's child offset is its
    popcount prefix. Raises AssertionError."""
    depth, starts = tree.depth, tree.level_starts
    for lvl in range(depth, 1, -1):
        s0, nxt = starts[lvl], starts[lvl - 1]
        base = tree.indices[s0:nxt].to(torch.int64) & 0xFFFFFFFF
        masks = tree.bitmasks[s0:nxt]
        expand = base != int(FULL_NODE)
        pc = torch.where(expand, _popcount64(masks), 0)
        expected = nxt + torch.cumsum(pc, 0) - pc
        assert torch.equal(base[expand], expected[expand]), lvl
        n_children = int(pc.sum())
        next_end = starts[lvl - 2] if lvl - 2 in starts else tree.num_nodes
        assert n_children == next_end - nxt, (lvl, n_children, next_end - nxt)
        rng = np.random.default_rng(0)
        sample = rng.choice(len(base), min(64, len(base)), replace=False)
        sample = torch.from_numpy(sample).to(base.device)
        sample = sample[expand[sample]]
        lo, hi = u64_split(masks[sample])
        bit = torch.arange(64, device=base.device)
        prefix = popcount_prefix_u64(lo[:, None], hi[:, None], bit[None])
        has = ((masks[sample][:, None] >> bit[None]) & 1).bool()
        rank = torch.cumsum(has.to(torch.int64), 1) - has.to(torch.int64)
        assert torch.equal(prefix[has], rank[has]), lvl


def node_cells(tree: SparseVoxelTree) -> dict:
    """Each level's node cells, (M, 3) int64 [x, y, z] in the tree's node
    order, replayed from the root by the bitmasks alone: the children of
    the expandable nodes are their set bits in (node, bit) order."""
    dev = tree.indices.device
    offs = torch.from_numpy(_OFFS).to(device=dev, dtype=torch.int64)
    bit = torch.arange(64, device=dev)
    cells = {tree.depth: torch.zeros((1, 3), dtype=torch.int64, device=dev)}
    for lvl in range(tree.depth, 1, -1):
        s0 = tree.level_starts[lvl]
        n = cells[lvl].shape[0]
        expand = (tree.indices[s0:s0 + n].to(torch.int64)
                  & 0xFFFFFFFF) != int(FULL_NODE)
        has = ((tree.bitmasks[s0:s0 + n, None] >> bit) & 1).bool()
        child = cells[lvl][:, None, :] * 4 + offs[None]
        cells[lvl - 1] = child[has & expand[:, None]]
    return cells


def brick_pyramid_masks(tree: SparseVoxelTree, pyr) -> torch.Tensor:
    """(N,) int64: the any mask of each node's cell in a brick pyramid
    (world/pyramid.py BrickPyramid, the HDDA's node rows) in the tree's
    node order, the u64 the node's bitmask must equal."""
    out = []
    for lvl, c in sorted(node_cells(tree).items(), reverse=True):
        s = pyr.size >> (2 * lvl)
        row = pyr.bases[lvl] + c[:, 0] + c[:, 1] * s + c[:, 2] * s * s
        out.append(pyr.rows[row.to(pyr.rows.device), :2].contiguous()
                   .view(torch.int64).reshape(-1))
    return torch.cat(out)
