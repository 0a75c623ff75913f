"""World cache — checkpoint/resume of the generated world.

The npz/zlib format of vvr_tpu/world/cache.py (bit-packed chunk bitsets,
zlib level 1), so either package can read the other's file. The default
path is the port's own, named by the size and a digest of every
`WorldConfig` field and the generator's version
(world/generator.py GENERATOR_VERSION): the JAX cache is keyed by size
alone, so another seed or terrain field of one size would load the first
world cached, and a world made by an earlier height field is not loaded.
The checkpoint of the flattened SVO64 tree (`save_tree`, `load_tree`) is
the JAX package's npz as well.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pathlib
import zlib

import numpy as np
import torch

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk
from vvr_tpu_torch.world.generator import GENERATOR_VERSION

log = logging.getLogger(__name__)


def default_cache_path(cfg: WorldConfig) -> pathlib.Path:
    key = json.dumps(dict(dataclasses.asdict(cfg),
                          generator=GENERATOR_VERSION), sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return (pathlib.Path.home() / ".cache" / "vvr_tpu_torch"
            / f"map_{cfg.size}_{digest}.npz")


def save_world(path: pathlib.Path, chunks: list[Chunk], size: int) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    positions = np.stack([c.position for c in chunks])
    packed = np.packbits(
        np.stack([c.voxels for c in chunks]).reshape(len(chunks), -1), axis=1,
        bitorder="little")
    blob = zlib.compress(packed.tobytes(), level=1)
    np.savez(path, positions=positions,
             voxels_zlib=np.frombuffer(blob, np.uint8),
             n_chunks=len(chunks), size=size)


def save_tree(path: pathlib.Path, tree) -> None:
    """Checkpoint the flattened SVO buffers (world/tree.py) in the JAX
    package's npz (vvr_tpu/world/cache.py:36), so either package loads
    the other's file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    indices, bitmasks, aabbs = tree.numpy()
    keys = sorted(tree.level_starts)
    np.savez_compressed(
        path, indices=indices, bitmasks=bitmasks, aabbs=aabbs,
        depth=tree.depth, level_keys=np.array(keys, np.int64),
        level_vals=np.array([tree.level_starts[k] for k in keys], np.int64))


def load_tree(path: pathlib.Path, device="cuda"):
    """The checkpointed tree with its buffers on `device` (no metrics, as
    the JAX load_tree), or None if there is no file."""
    from vvr_tpu_torch.world.tree import SparseVoxelTree
    path = pathlib.Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        starts = {int(k): int(v)
                  for k, v in zip(z["level_keys"], z["level_vals"])}
        return SparseVoxelTree(
            torch.from_numpy(z["indices"].astype(np.uint32).view(np.int32)
                             ).to(device),
            torch.from_numpy(z["bitmasks"].astype(np.uint64).view(np.int64)
                             ).to(device),
            torch.from_numpy(z["aabbs"].astype(np.uint64).view(np.int64)
                             ).to(device),
            starts, int(z["depth"]), {})


def load_world(path: pathlib.Path, size: int | None = None
               ) -> list[Chunk] | None:
    """The cached chunks, or None if there is no file, or if `size` is
    given and the file holds a world of another size."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        if size is not None and int(z["size"]) != size:
            log.info("world cache %s holds size %d, not %d: ignored", path,
                     int(z["size"]), size)
            return None
        positions = z["positions"]
        n = int(z["n_chunks"])
        raw = zlib.decompress(z["voxels_zlib"].tobytes())
    bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(n, -1),
                         axis=1, bitorder="little")
    vox = bits.reshape(n, CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE).astype(bool)
    return [Chunk(positions[i], vox[i]) for i in range(n)]
