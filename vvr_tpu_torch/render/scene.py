"""Scene — the world's chunks and its device-resident structures.

Counterpart of vvr_tpu/render/scene.py `build_scene` for what the slice
reads: the jump grid (DDA traversal) and, built lazily on first use, the
merged exposed faces of the face rasterizer and the sun-grid build. The
brick pyramid, the density field, the SVO tree and the lights come back
with their consumers (ROADMAP A10-A13).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.world import cache as cache_mod
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk
from vvr_tpu_torch.world.faces import extract_merged_faces
from vvr_tpu_torch.world.generator import assemble_dense, generate_world
from vvr_tpu_torch.world.jumpgrid import JumpGrid, build_jump_grid

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Scene:
    cfg: WorldConfig
    chunks: list[Chunk]
    jumpgrid: JumpGrid
    faces: tuple | None = None   # FaceSet.device_tuple() on the grid's device
    epoch: int = 0               # world version, part of the sun-grid key
    _chunk_index: dict | None = None

    def ensure_faces(self) -> tuple:
        """Merged exposed faces, built on the host once and kept on the
        jump grid's device."""
        if self.faces is None:
            fs = extract_merged_faces(assemble_dense(self.chunks,
                                                     self.cfg.size))
            self.faces = fs.device_tuple(self.jumpgrid.rows.device)
        return self.faces

    def solid_at_host(self, p) -> bool:
        """Whether the voxel at point p (clipped into the world, as the
        tracer clips its start cell) is solid: the camera-in-solid probe
        of the rasterizer, a chunk lookup on the host."""
        s = self.cfg.size
        x, y, z = (int(min(max(np.floor(c), 0), s - 1)) for c in p)
        if self._chunk_index is None:
            self._chunk_index = {tuple(int(v) for v in c.position): c
                                 for c in self.chunks}
        c = self._chunk_index.get((x // CHUNK_SIZE, y // CHUNK_SIZE,
                                   z // CHUNK_SIZE))
        if c is None:
            return False
        return bool(c.voxels[z % CHUNK_SIZE, y % CHUNK_SIZE,
                             x % CHUNK_SIZE])


def build_scene(cfg: WorldConfig, device="cuda",
                force_regenerate: bool = False, cache_path=None) -> Scene:
    """Load the cached world or generate and cache it (the height field
    runs on `device`), then build the jump grid on `device`."""
    device = torch.device(device)
    path = cache_path or cache_mod.default_cache_path(cfg)
    chunks = None if force_regenerate else cache_mod.load_world(path,
                                                                cfg.size)
    if chunks is None:
        log.info("generating world (size %d)...", cfg.size)
        chunks = generate_world(cfg, device)
        try:
            cache_mod.save_world(path, chunks, cfg.size)
        except OSError as e:  # pragma: no cover
            log.warning("could not write world cache: %s", e)
    else:
        log.info("world cache hit: %s (%d chunks)", path, len(chunks))
    grid = build_jump_grid(assemble_dense(chunks, cfg.size), device)
    return Scene(cfg, chunks, grid)
