"""Scene — the world's chunks and its device-resident jump grid.

Counterpart of vvr_tpu/render/scene.py `build_scene` without the brick
pyramid, the density field, the SVO tree or the lights: the slice's frame
reads only the jump grid (ROADMAP A10-A13 bring the others back with their
consumers).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.world import cache as cache_mod
from vvr_tpu_torch.world.chunk import Chunk
from vvr_tpu_torch.world.generator import assemble_dense, generate_world
from vvr_tpu_torch.world.jumpgrid import JumpGrid, build_jump_grid

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Scene:
    cfg: WorldConfig
    chunks: list[Chunk]
    jumpgrid: JumpGrid


def build_scene(cfg: WorldConfig, device="cpu", force_regenerate: bool = False,
                cache_path=None) -> Scene:
    """Load the cached world or generate and cache it (the height field
    runs on `device`), then build the jump grid on `device`."""
    device = torch.device(device)
    path = cache_path or cache_mod.default_cache_path(cfg.size)
    chunks = None if force_regenerate else cache_mod.load_world(path)
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
