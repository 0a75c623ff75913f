"""World generation — FBM terrain, the height field in torch.

Counterpart of vvr_tpu/world/generator.py (reference src/voxel.rs:58-95):
6-octave Perlin FBM height (freq 0.001, *700 + 80), terraced to steps of 10,
modulated by a 3-octave Billow detail field (freq 0.01); a voxel is solid
iff y < surface(x, z). Terrain parameters scale with world size so smaller
worlds are shrunk versions of the 1024^3 original.

The height field runs on the given device at setup only: on a CUDA
device as K24 (csrc/terrain.cu), on the CPU as its plain version; the
chunk split and the dense occupancy are host numpy. A one-ulp height
difference flips a `y < h` voxel, and the JAX package computes its field
under jax.jit, so both versions round as XLA does there (FMAs where it
contracts, each constant division a multiply by the reciprocal it folds)
and the tests hold them to the jitted function bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.ops import noise
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk


# 2: the height field rounds as the JAX package's jitted one (FMAs where
# XLA contracts, divisions as reciprocal multiplies); 1 rounded op by op.
# The world cache's key holds it (world/cache.py default_cache_path).
GENERATOR_VERSION = 2


def terrain_constants(cfg: WorldConfig) -> dict:
    """The height field's float32 constants as the jitted JAX function
    folds them (Python floats, each a float32 value): each division by a
    constant becomes a multiply by its float32 reciprocal, and the main
    fbm2's 1/norm folds into the amplitude. K24 takes the same values."""
    scale = cfg.size / 1024.0
    _, norm = noise.octave_constants(cfg.fbm_octaves, 1.0)
    _, detail_norm = noise.octave_constants(cfg.detail_octaves, 1.0)
    f32 = np.float32
    step = cfg.terrace_step * scale
    return dict(
        freq=cfg.fbm_frequency / scale,
        detail_freq=cfg.detail_frequency / scale,
        amplitude=float(f32(noise.reciprocal32(norm))
                        * f32(cfg.fbm_amplitude * scale)),
        offset=float(f32(cfg.fbm_offset * scale)),
        step=float(f32(step)),
        inv_step=noise.reciprocal32(step),
        inv_half_step=noise.reciprocal32(step / 2.0),
        inv_detail_norm=noise.reciprocal32(detail_norm),
        detail_scale=float(f32(5.0 * scale)))


def height_field_plain(cfg: WorldConfig, device) -> torch.Tensor:
    """Surface height h(x, z) for every column; (size, size) f32 [z, x],
    rounded as the JAX package's jitted `_height_field` on the CPU (see
    ops/noise.py for the noise): height = fma(sum, amplitude / norm,
    offset), the terrace's distance fma(|height - stepped|, 1 / (step /
    2), -0.5), the detail fma(-diff * detail, 5 * scale, stepped). Only
    float32 multiplies, adds, floors and float64-emulated FMAs, so the
    card computes the same bits as the CPU."""
    s = cfg.size
    k = terrain_constants(cfg)
    coords = torch.arange(s, dtype=torch.float32, device=device)
    x = coords[None, :].expand(s, s)
    z = coords[:, None].expand(s, s)
    total = noise.fbm2_sum(x, z, cfg.fbm_octaves, k["freq"], seed=cfg.seed,
                           swap11=True)
    height = noise._fma(total, k["amplitude"], k["offset"])
    stepped = torch.floor(height * k["inv_step"]) * k["step"]
    diff = noise._fma(torch.abs(height - stepped), k["inv_half_step"], -0.5)
    detail = noise.fbm2_sum(x, z, cfg.detail_octaves, k["detail_freq"],
                            seed=cfg.seed + 101, billow=True)
    detail = detail * k["inv_detail_norm"]
    return noise._fma(-diff * detail, k["detail_scale"], stepped)


def height_field(cfg: WorldConfig, device) -> torch.Tensor:
    """The height field on `device`: on a CUDA device K24 (csrc/terrain.cu,
    one launch, bit for bit the plain version), on the CPU
    height_field_plain."""
    if not kernels.on_cuda(device):
        return height_field_plain(cfg, device)
    dev = torch.device(device)
    out = torch.empty((cfg.size, cfg.size), dtype=torch.float32, device=dev)
    k = terrain_constants(cfg)
    kernels.launch("height_field", dev, out.data_ptr(), cfg.size, cfg.seed,
                   cfg.fbm_octaves, k["freq"], k["amplitude"], k["offset"],
                   k["step"], k["inv_step"], k["inv_half_step"],
                   cfg.detail_octaves, k["detail_freq"],
                   k["inv_detail_norm"], k["detail_scale"])
    return out


def generate_world(cfg: WorldConfig, device="cuda") -> list[Chunk]:
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
