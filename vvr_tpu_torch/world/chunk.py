"""Chunk — the 64^3 unit of world storage.

Counterpart of vvr_tpu/world/chunk.py for what the port needs: a chunk's
position and its voxels, indexed [z, y, x] so the C-contiguous linear index
equals the reference's x-major convention, and its kind (empty, full or
partial, chunk.rs:10-25), which the sparse voxel texture (world/bricks.py)
and the world editor (world/edit.py) read. The kind is computed from the
voxels whenever it is asked for, so an edit never leaves it stale. The
per-chunk mips feed the brick pyramid (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

CHUNK_SIZE = 64       # src/voxel/chunk.rs:6


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
