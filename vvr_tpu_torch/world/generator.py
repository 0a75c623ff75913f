"""World generation — FBM terrain, the height field in torch.

Counterpart of vvr_tpu/world/generator.py (reference src/voxel.rs:58-95):
6-octave Perlin FBM height (freq 0.001, *700 + 80), terraced to steps of 10,
modulated by a 3-octave Billow detail field (freq 0.01); a voxel is solid
iff y < surface(x, z). Terrain parameters scale with world size so smaller
worlds are shrunk versions of the 1024^3 original.

The height field runs on the given device at setup only; the chunk split
and the dense occupancy are host numpy. A one-ulp height difference flips
a `y < h` voxel, so tests hold the occupancy equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.ops import noise
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk


def height_field(cfg: WorldConfig, device) -> torch.Tensor:
    """Surface height h(x, z) for every column; (size, size) f32 [z, x]."""
    s = cfg.size
    scale = s / 1024.0
    coords = torch.arange(s, dtype=torch.float32, device=device)
    x = coords[None, :].expand(s, s)
    z = coords[:, None].expand(s, s)
    f = cfg.fbm_frequency / scale
    h = noise.fbm2(x, z, cfg.fbm_octaves, f, seed=cfg.seed)
    height = h * (cfg.fbm_amplitude * scale) + cfg.fbm_offset * scale

    step = cfg.terrace_step * scale
    stepped = torch.floor(height / step) * step
    diff = torch.abs(height - stepped) / (step / 2.0) - 0.5

    detail = noise.fbm2(x, z, cfg.detail_octaves,
                        cfg.detail_frequency / scale, seed=cfg.seed + 101,
                        billow=True)
    return stepped + (-diff) * detail * (5.0 * scale)


def generate_world(cfg: WorldConfig, device="cpu") -> list[Chunk]:
    """All chunks in x-major chunk order (reference
    create_sparse_structures, src/voxel.rs:58-95)."""
    surface = height_field(cfg, device).cpu().numpy()  # [z, x]
    n = cfg.chunk_count
    ys = np.arange(CHUNK_SIZE, dtype=np.float32)
    chunks = []
    for index in range(n ** 3):
        cx = index % n
        cy = (index // n) % n
        cz = index // (n * n)
        hslab = surface[cz * CHUNK_SIZE:(cz + 1) * CHUNK_SIZE,
                        cx * CHUNK_SIZE:(cx + 1) * CHUNK_SIZE]  # [z, x]
        wy = ys + cy * CHUNK_SIZE
        chunks.append(Chunk(np.array([cx, cy, cz]),
                            wy[None, :, None] < hslab[:, None, :]))
    return chunks


def assemble_dense(chunks: list[Chunk], size: int) -> np.ndarray:
    """Dense bool occupancy (size, size, size) [z,y,x] from chunks."""
    occ = np.zeros((size, size, size), dtype=bool)
    for c in chunks:
        x, y, z = (int(v) * CHUNK_SIZE for v in c.position)
        occ[z:z + CHUNK_SIZE, y:y + CHUNK_SIZE, x:x + CHUNK_SIZE] = c.voxels
    return occ
