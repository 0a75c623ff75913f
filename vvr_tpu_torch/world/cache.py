"""World cache — checkpoint/resume of the generated world.

The npz/zlib format of vvr_tpu/world/cache.py (bit-packed chunk bitsets,
zlib level 1), so either package can read the other's file. The default
path is the port's own, named by the size and a digest of every
`WorldConfig` field: the JAX cache is keyed by size alone, so another seed
or terrain field of one size would load the first world cached.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pathlib
import zlib

import numpy as np

from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk

log = logging.getLogger(__name__)


def default_cache_path(cfg: WorldConfig) -> pathlib.Path:
    key = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
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
