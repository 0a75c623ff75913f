"""Chunk — the 64^3 unit of world storage.

Counterpart of vvr_tpu/world/chunk.py for what the port needs: a chunk's
position and its voxels, indexed [z, y, x] so the C-contiguous linear index
equals the reference's x-major convention, and its kind (empty, full or
partial, chunk.rs:10-25), which the sparse voxel texture (world/bricks.py)
and the world editor (world/edit.py) read, and its mips (`ChunkMips`,
`build_chunk_mips`, chunk.rs:211-322: 64 -> 16 -> 4 -> 1 any/all
occupancy and tight child-union bounds), which the SVO tree's chunk
bounds read (world/tree.py). The kind, the mips and the world bounds are
computed from the voxels whenever they are asked for, so an edit never
leaves them stale (the JAX chunk computes them once, in `rebuild`).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

CHUNK_SIZE = 64       # src/voxel/chunk.rs:6
CHUNK_MIPS = 4        # 64 -> 16 -> 4 -> 1


class ChunkKind(enum.Enum):
    EMPTY = 0
    FULL = 1
    PARTIAL = 2


def chunk_kind(voxels: np.ndarray) -> ChunkKind:
    """EMPTY with no solid voxel, FULL with every voxel solid, else
    PARTIAL (Chunk::rebuild, chunk.rs:205)."""
    n = int(np.count_nonzero(voxels))
    if n == 0:
        return ChunkKind.EMPTY
    return ChunkKind.FULL if n == voxels.size else ChunkKind.PARTIAL


@dataclasses.dataclass
class ChunkMips:
    """any/all occupancy + tight bounds per mip level.

    any_mips[k]  : bool (m, m, m) [z,y,x], m = 64 >> (2k)  (k = 0..3)
    all_mips[k]  : bool (m, m, m)
    bounds[k]    : int32 (m, m, m, 6) chunk-local tight AABB (minx,miny,minz,
                   maxx,maxy,maxz; max exclusive); undefined where any=False.
    """

    any_mips: list
    all_mips: list
    bounds: list


@dataclasses.dataclass
class Chunk:
    """position: (3,) int chunk coords; voxels: bool (64,64,64) [z,y,x]."""

    position: np.ndarray
    voxels: np.ndarray

    def __post_init__(self):
        self.position = np.asarray(self.position, np.int32)
        self.voxels = np.asarray(self.voxels, bool)
        if self.voxels.shape != (CHUNK_SIZE,) * 3:
            raise ValueError(f"chunk voxels must be {CHUNK_SIZE}^3, got "
                             f"{self.voxels.shape}")

    @property
    def kind(self) -> ChunkKind:
        return chunk_kind(self.voxels)

    @property
    def mips(self) -> ChunkMips:
        return build_chunk_mips(self.voxels)

    @property
    def world_bounds(self) -> np.ndarray:
        """(6,) int32 tight world AABB of the solid voxels, max exclusive;
        zeros for an empty chunk (the reference's Aabb::default(),
        chunk.rs:219)."""
        if self.kind == ChunkKind.EMPTY:
            return np.zeros(6, np.int32)
        origin = self.position.astype(np.int64) * CHUNK_SIZE
        local = self.mips.bounds[CHUNK_MIPS - 1][0, 0, 0]
        return (local + np.concatenate([origin, origin])).astype(np.int32)


_B0_CACHE = None


def _voxel_bounds_grid() -> np.ndarray:
    """Per-voxel unit AABBs (cached module-wide)."""
    global _B0_CACHE
    if _B0_CACHE is None:
        m = CHUNK_SIZE
        zz, yy, xx = np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                                 indexing="ij")
        _B0_CACHE = np.stack([xx, yy, zz, xx + 1, yy + 1, zz + 1],
                             axis=-1).astype(np.int32)
    return _B0_CACHE


def build_chunk_mips(voxels: np.ndarray) -> ChunkMips:
    """Bottom-up mip build (chunk_to_sparse, chunk.rs:211-322), host
    NumPy: any/all over 4x4x4 groups and tight child-union AABBs, equal
    array for array to vvr_tpu/world/chunk.py:96 build_chunk_mips."""
    voxels = np.asarray(voxels, bool)
    any_mips = [voxels]
    all_mips = [voxels]
    bounds = [_voxel_bounds_grid()]
    big = np.int32(1 << 20)
    for _ in range(1, CHUNK_MIPS):
        nm = any_mips[-1].shape[0] // 4
        ga = any_mips[-1].reshape(nm, 4, nm, 4, nm, 4)
        gl = all_mips[-1].reshape(nm, 4, nm, 4, nm, 4)
        gb = bounds[-1].reshape(nm, 4, nm, 4, nm, 4, 6)
        mask = ga[..., None]
        mins = np.where(mask, gb[..., :3], big).min(axis=(1, 3, 5))
        maxs = np.where(mask, gb[..., 3:], -big).max(axis=(1, 3, 5))
        any_mips.append(ga.any(axis=(1, 3, 5)))
        all_mips.append(gl.all(axis=(1, 3, 5)))
        bounds.append(np.concatenate([mins, maxs], axis=-1).astype(np.int32))
    return ChunkMips(any_mips, all_mips, bounds)
