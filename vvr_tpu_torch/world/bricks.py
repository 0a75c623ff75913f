"""Sparse voxel texture (SVT) — page table, brick pool, and kernel K17
`svt_update_brick` (csrc/svt.cu), its per-frame update pass.

Counterpart of vvr_tpu/world/bricks.py: only partial chunks own a 64^3
RGBA8 brick; empty and full chunks are page-table codes, and the metadata
marks full chunks 255 (the reference's sparse-resident image,
src/voxel.rs:164-506, and its O(1) `is_solid`, shaders/other.slang:16-25).
The page table, metadata and origins are kept on the host beside their
device copies, so the per-frame pass reads no scalar back.

The dynamic world's pass (shaders/voxel_interesting_compute.slang:9-35,
one brick a frame, round-robin, src/renderer.rs:581-609): a voxel with
alpha 255 takes the hash colour of its world position with alpha 255;
every other voxel the mean of its 3x3x3 neighbourhood (clamped to the
brick) times 254/255; each channel is stored as clip(v * 255 + 0.5) cut to
u8. The bytes are the jitted JAX pass's: XLA folds `/ 255` into a multiply
by float32(1/255), `/ 27 * (254/255)` into one multiply by
float32(float32(1/27) * float32(254/255)), sums the 27 taps in (dz, dy, dx)
order, and contracts three of them (dy = dx = 1, whose tap it multiplies
inline: acc = fma(u, 1/255, acc)) and the output's `* 255 + 0.5` into
FMAs; the colour is utils/hash.py's `per_block_unique_colour`. The pass
is functional in JAX, so K17 writes into a scratch brick and copies it
into the slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.utils.hash import _fma, per_block_unique_colour
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk, ChunkKind

PAGE_EMPTY = -1
PAGE_FULL = -2
F32 = torch.float32
C255 = np.float32(1.0 / 255.0)          # 0x1.010102p-8
C_BLUR = np.float32(np.float32(1.0 / 27.0) * np.float32(254.0 / 255.0))
# the taps XLA multiplies inline, contracted into the sum: (dz, 1, 1)
FUSED_TAPS = (4, 13, 22)
BRICK_BYTES = CHUNK_SIZE ** 3 * 4


@dataclasses.dataclass
class SparseVoxelTexture:
    page_table: torch.Tensor   # int32 (n, n, n) [z, y, x]: code or slot
    metadata: torch.Tensor     # uint8 (n, n, n): 255 where the chunk is full
    bricks: torch.Tensor       # uint8 (B, 64, 64, 64, 4) rgba [z, y, x]
    origins: torch.Tensor      # int32 (B, 3): each brick's world origin
    page_host: np.ndarray      # host copies of the three above
    metadata_host: np.ndarray
    origins_host: np.ndarray
    scratch: torch.Tensor | None = None   # K17's output brick, made once

    @property
    def num_bricks(self) -> int:
        return self.bricks.shape[0]

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.page_table, self.metadata, self.bricks, self.origins))


def build_svt(chunks: list[Chunk], size: int,
              device="cuda") -> SparseVoxelTexture:
    """A brick for each partial chunk, alpha = occupancy * 255 and colour
    0 (vvr_tpu/world/bricks.py:54); one zero brick at the origin when no
    chunk is partial."""
    n = size // CHUNK_SIZE
    page = np.full((n, n, n), PAGE_EMPTY, np.int32)
    meta = np.zeros((n, n, n), np.uint8)
    partial, origins = [], []
    for c in chunks:
        x, y, z = (int(v) for v in c.position)
        kind = c.kind
        if kind == ChunkKind.FULL:
            page[z, y, x] = PAGE_FULL
            meta[z, y, x] = 255
        elif kind == ChunkKind.PARTIAL:
            page[z, y, x] = len(partial)
            partial.append(c)
            origins.append(np.array([x, y, z], np.int32) * CHUNK_SIZE)
    if not origins:
        origins = [np.zeros(3, np.int32)]
    origins = np.stack(origins)
    device = torch.device(device)
    bricks = torch.zeros((len(origins),) + (CHUNK_SIZE,) * 3 + (4,),
                         dtype=torch.uint8, device=device)
    if partial:
        vox = np.stack([c.voxels for c in partial]).view(np.uint8)
        bricks[..., 3] = torch.from_numpy(vox).to(device) * 255
    return SparseVoxelTexture(
        torch.from_numpy(page).to(device), torch.from_numpy(meta).to(device),
        bricks, torch.from_numpy(origins).to(device), page, meta, origins)


def is_solid(svt: SparseVoxelTexture, pos: torch.Tensor) -> torch.Tensor:
    """The reference's Fetcher.is_solid (other.slang:18-25): the chunk is
    full, or the voxel's alpha is 255. pos: (..., 3) int voxel coords
    inside the world."""
    cp = pos // CHUNK_SIZE
    page = svt.page_table[cp[..., 2], cp[..., 1], cp[..., 0]].long()
    lp = pos % CHUNK_SIZE
    w = svt.bricks[page.clamp(min=0), lp[..., 2], lp[..., 1], lp[..., 0], 3]
    return (page == PAGE_FULL) | ((page >= 0) & (w == 255))


def sample_colour_nearest(svt: SparseVoxelTexture,
                          pos: torch.Tensor) -> torch.Tensor:
    """Nearest RGBA in [0, 1] at world positions (..., 3) float32 (the
    reference's diffuse fetch, raytracer.slang:200): (0, 0, 0, 1) in a
    full chunk, 0 in an empty one."""
    p = torch.floor(pos).long()
    cp = p // CHUNK_SIZE
    page = svt.page_table[cp[..., 2], cp[..., 1], cp[..., 0]].long()
    lp = p % CHUNK_SIZE
    rgba = svt.bricks[page.clamp(min=0), lp[..., 2], lp[..., 1],
                      lp[..., 0]].to(F32) / 255.0
    full = torch.zeros_like(rgba)
    full[..., 3] = 1.0
    rgba = torch.where((page == PAGE_FULL)[..., None], full, rgba)
    return torch.where((page == PAGE_EMPTY)[..., None],
                       torch.zeros_like(rgba), rgba)


def svt_update_brick_plain(bricks: torch.Tensor, slot: int,
                           origin) -> torch.Tensor:
    """Plain torch K17: the update pass on brick `slot` of `bricks`
    (B, 64, 64, 64, 4) u8, written in place; `origin` the brick's world
    origin (x, y, z). Returns `bricks`."""
    e = CHUNK_SIZE
    u = bricks[slot].to(F32)                       # (64, 64, 64, 4)
    solid = bricks[slot, ..., 3] == 255
    c255 = torch.tensor(C255, device=u.device)
    pad = torch.nn.functional.pad(u.permute(3, 0, 1, 2)[None],
                                  (1, 1, 1, 1, 1, 1), mode="replicate")[0]
    pad = pad.permute(1, 2, 3, 0)
    acc = torch.zeros_like(u)
    k = 0
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = pad[dz:dz + e, dy:dy + e, dx:dx + e]
                if k in FUSED_TAPS:
                    acc = _fma(tap, c255.expand_as(tap), acc)
                else:
                    acc = acc + tap * c255
                k += 1
    blurred = acc * torch.tensor(C_BLUR, device=u.device)
    z, y, x = torch.meshgrid(*(torch.arange(e, device=u.device),) * 3,
                             indexing="ij")
    ox, oy, oz = (int(v) for v in origin)
    colour = per_block_unique_colour(torch.stack([x + ox, y + oy, z + oz],
                                                 -1))
    colour = torch.cat([colour, torch.ones_like(colour[..., :1])], -1)
    new = torch.where(solid[..., None], colour, blurred)
    out = _fma(new, torch.full_like(new, 255.0), torch.full_like(new, 0.5))
    bricks[slot] = torch.clamp(out, 0.0, 255.0).to(torch.uint8)
    return bricks


def svt_update_brick(svt: SparseVoxelTexture, slot: int) -> torch.Tensor:
    """The update pass on brick `slot` of the texture (its origin from the
    host copy), in place. CUDA: K17, into the texture's scratch brick
    (made at the first call) and copied into the slot in the same entry
    point."""
    slot = int(slot)
    if not 0 <= slot < svt.num_bricks:
        raise ValueError(f"slot {slot} outside 0..{svt.num_bricks - 1}")
    origin = svt.origins_host[slot]
    bricks = svt.bricks
    if not kernels.on_cuda(bricks):
        return svt_update_brick_plain(bricks, slot, origin)
    if bricks.dtype != torch.uint8 or tuple(bricks.shape[1:]) != (
            CHUNK_SIZE,) * 3 + (4,):
        raise ValueError("bricks must be u8 (B, 64, 64, 64, 4)")
    if svt.scratch is None:
        svt.scratch = torch.empty(BRICK_BYTES, dtype=torch.uint8,
                                  device=bricks.device)
    kernels.check_cuda(bricks, svt.scratch)
    kernels.launch("svt_update_brick", bricks.device, bricks.data_ptr(),
                   svt.num_bricks, slot, *(int(v) for v in origin),
                   svt.scratch.data_ptr())
    return bricks
