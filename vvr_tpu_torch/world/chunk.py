"""Chunk — the 64^3 unit of world storage.

Counterpart of vvr_tpu/world/chunk.py for what the slice needs: a chunk's
position and its voxels, indexed [z, y, x] so the C-contiguous linear index
equals the reference's x-major convention. The per-chunk mips feed the brick
pyramid, which the slice does not build (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np

CHUNK_SIZE = 64       # src/voxel/chunk.rs:6


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
