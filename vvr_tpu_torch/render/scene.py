"""Scene — the world's chunks and its device-resident structures.

Counterpart of vvr_tpu/render/scene.py `build_scene` for what the port
reads: the chunks, the animated point lights (host NumPy, as in the JAX
package: scene.py:27, :126-141, :174-175) and, built lazily on first use,
the DDA's grid (the jump grid up to 512^3, `ensure_jumpgrid`; the paged
grid past it, `ensure_paged`, as scene.py:93-110 builds them; the brick
pyramid with `traversal="pyramid"`, `ensure_pyramid`, scene.py:47), the merged
exposed faces of the face rasterizer and the sun-grid build, and the u8
density field of the filtered ambient occlusion, each on the scene's
device. They all come from the dense occupancy, which the scene assembles
once and keeps until `release_dense` (the Renderer releases it once it
has built what it reads: 1 GiB at 1024^3). A world editor
(world/edit.py) made over the scene's chunks patches the grids and the
faces it hands the scene, and `Renderer.apply_edits` points the scene at
them. The reference-layout SVO tree (`ensure_tree`, scene.py:75) is
built on request only: no frame reads it.
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
from vvr_tpu_torch.world.paged import PagedGrid, build_paged_grid
from vvr_tpu_torch.world.pyramid import (BrickPyramid, build_brick_pyramid,
                                         build_pyramid)
from vvr_tpu_torch.world.svt import density_from_occupancy
from vvr_tpu_torch.world.tree import (SparseVoxelTree,
                                      bounds_pyramid_from_dense, flatten_tree)

log = logging.getLogger(__name__)

NUM_LIGHTS = 100  # src/renderer.rs:290
LIGHT_SEED = 421  # renderer.rs:494


def initial_lights(size: int) -> np.ndarray:
    """(NUM_LIGHTS, 4) float32: the lights' start, uniform in [0, size)."""
    rng = np.random.default_rng(LIGHT_SEED)
    return rng.random((NUM_LIGHTS, 4)).astype(np.float32) * size


@dataclasses.dataclass
class Scene:
    cfg: WorldConfig
    chunks: list[Chunk]
    jumpgrid: JumpGrid | None = None   # built by ensure_jumpgrid
    paged: PagedGrid | None = None     # built by ensure_paged
    pyramid: BrickPyramid | None = None  # built by ensure_pyramid
    tree: SparseVoxelTree | None = None  # built by ensure_tree
    faces: tuple | None = None   # FaceSet.device_tuple() on the device
    epoch: int = 0               # world version, part of the sun-grid key
    lights: np.ndarray | None = None  # (NUM_LIGHTS, 4) float32, host
    density: torch.Tensor | None = None  # u8 (S, S, S) on the device
    device: torch.device | str = "cuda"  # where the structures live
    _chunk_index: dict | None = None
    _dense: np.ndarray | None = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.lights is None:
            self.lights = initial_lights(self.cfg.size)

    def dense(self) -> np.ndarray:
        """The dense bool occupancy [z, y, x], assembled from the chunks
        once and kept until release_dense."""
        if self._dense is None:
            self._dense = assemble_dense(self.chunks, self.cfg.size)
        return self._dense

    def release_dense(self) -> None:
        """Drop the dense occupancy (a later ensure_* assembles it
        again)."""
        self._dense = None

    def ensure_jumpgrid(self) -> JumpGrid:
        """The jump grid (world/jumpgrid.py), built on the host once."""
        if self.jumpgrid is None:
            self.jumpgrid = build_jump_grid(self.dense(), self.device)
        return self.jumpgrid

    def ensure_paged(self) -> PagedGrid:
        """The paged two-level grid (world/paged.py), built on the host
        once."""
        if self.paged is None:
            self.paged = build_paged_grid(self.dense(), self.device)
        return self.paged

    def ensure_pyramid(self) -> BrickPyramid:
        """The brick pyramid (world/pyramid.py), built once on the scene's
        device from the dense occupancy."""
        if self.pyramid is None:
            self.pyramid = build_brick_pyramid(self.dense(), self.device)
        return self.pyramid

    def ensure_tree(self) -> SparseVoxelTree:
        """The reference-layout SVO buffers, flattened on the scene's
        device from the chunks' dense occupancy: its occupancy pyramid
        and bounds pyramid (the JAX scene reads the chunk mips for both,
        which give the same tree); a checkpoint artifact no frame
        reads."""
        if self.tree is None:
            occ = torch.from_numpy(self.dense()).to(self.device)
            self.tree = flatten_tree(build_pyramid(occ, self.device),
                                     bounds_pyramid_from_dense(occ,
                                                               self.device))
            log.info("tree: %s", self.tree.metrics)
        return self.tree

    def ensure_density(self) -> torch.Tensor:
        """The density field of the filtered AO (world/svt.py), built on
        the host once."""
        if self.density is None:
            self.density = density_from_occupancy(self.dense(), self.device)
        return self.density

    def animate_lights(self, camera_position, elapsed: float,
                       delta: float) -> None:
        """Host light animation (src/renderer.rs:494-505), as the JAX
        package's Scene.animate_lights: each light moves `delta` of the way
        toward a point on a disk of radius 5 around the camera, turned by
        `elapsed` about the light's own random axis."""
        rng = np.random.default_rng(LIGHT_SEED)
        axes = rng.random((NUM_LIGHTS, 3)).astype(np.float32) - 0.5
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        c, s = np.cos(elapsed), np.sin(elapsed)
        # Rodrigues rotation of unit_x around each axis by `elapsed`
        ux = np.array([1.0, 0.0, 0.0], np.float32)
        k = axes
        rot = (ux[None] * c
               + np.cross(k, ux[None]) * s
               + k * (k @ ux)[:, None] * (1 - c))
        target = np.asarray(camera_position, np.float32)[None] + rot * 5.0
        t = min(max(delta, 0.0), 1.0)
        self.lights[:, :3] += (target - self.lights[:, :3]) * t

    def ensure_faces(self) -> tuple:
        """Merged exposed faces, built on the host once."""
        if self.faces is None:
            self.faces = extract_merged_faces(self.dense()).device_tuple(
                self.device)
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
    runs on `device`): a scene whose structures (the grids, the faces,
    the density field) are built on `device` when first asked for."""
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
    return Scene(cfg, chunks, device=device)
