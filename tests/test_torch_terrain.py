"""The port's terrain height field (world/generator.py, the plain version
of K24 csrc/terrain.cu) against the JAX package's jitted `_height_field`,
and the world cache's generator version.

The JAX program runs its height field under jax.jit, where XLA on the CPU
contracts multiply-adds into FMAs and folds each division by a constant
into a multiply by its reciprocal. An op-by-op height field differs from
it in most columns, and past 64^3 in the solid voxels of some (a terrace
step flips at 1024^3), so the port is held to the jitted function bit for
bit at every size it generates.
"""

import dataclasses
import functools
import hashlib
import json

import numpy as np
import pytest
import torch

from vvr_tpu.config import WorldConfig as JaxWorldConfig
from vvr_tpu.world.generator import _height_field as jax_height_field
from vvr_tpu_torch import kernels
from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.world import cache
from vvr_tpu_torch.world.chunk import CHUNK_SIZE, Chunk
from vvr_tpu_torch.world.generator import (assemble_dense, generate_world,
                                           height_field, height_field_plain,
                                           terrain_constants)

torch.set_num_threads(1)


@functools.cache
def _heights(depth: int, seed: int):
    """(JAX jitted, port) height fields of one world, computed once."""
    ref = jax_height_field(JaxWorldConfig(depth=depth, seed=seed))
    ref = np.asarray(ref)
    out = height_field(WorldConfig(depth=depth, seed=seed), "cpu").numpy()
    return ref, out


@pytest.mark.parametrize("depth,seed", [(3, 0), (3, 7), (4, 0), (5, 0)])
def test_height_field_equals_jitted_jax(depth, seed):
    """Bit for bit at 64^2, 256^2 (two seeds at 64^2) and 1024^2."""
    ref, out = _heights(depth, seed)
    assert out.dtype == np.float32 and out.shape == (4 ** depth,) * 2
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("depth", [4, 5])
def test_solid_voxels_per_column_equal_jax(depth):
    """The solid count of every column (y < h for y in [0, size)) of the
    256^3 and 1024^3 worlds equals the JAX world's; at 256^3 the port's
    chunks hold exactly those voxels."""
    ref, out = _heights(depth, 0)
    size = 4 ** depth
    count = np.clip(np.ceil(out), 0, size).astype(np.int64)
    np.testing.assert_array_equal(
        count, np.clip(np.ceil(ref), 0, size).astype(np.int64))
    if depth == 4:
        occ = assemble_dense(generate_world(WorldConfig(depth=4), "cpu"),
                             size)
        np.testing.assert_array_equal(occ.sum(axis=1), count)


def test_height_field_dispatch_and_constants():
    """On a CPU tensor's device the wrapper runs the plain version (K24
    runs only on the card; nothing falls back from one to the other), and
    the constants K24 takes are float32 values, the reciprocals XLA
    folds."""
    cfg = WorldConfig(depth=3)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(height_field(cfg, "cpu"),
                       height_field_plain(cfg, "cpu"))
    assert kernels.LAUNCHES == before
    k = terrain_constants(cfg)
    for name, v in k.items():
        if name not in ("freq", "detail_freq"):
            assert float(np.float32(v)) == v, name
    assert k["inv_step"] == float(np.float32(1) / np.float32(0.625))
    assert k["amplitude"] == float(np.float32(np.float32(1)
                                              / np.float32(1.96875))
                                   * np.float32(43.75))
    assert kernels.KERNELS["height_field"].replaces \
        == "vvr_tpu/world/generator.py:29"


def _old_digest_path(cfg: WorldConfig):
    """The world cache path as it was named before the generator version
    joined the key: a digest of the WorldConfig fields alone."""
    key = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return cache.default_cache_path(cfg).with_name(
        f"map_{cfg.size}_{digest}.npz")


def test_world_cache_key_holds_the_generator_version(tmp_path, monkeypatch):
    """A world file written under the old digest (by the op-by-op height
    field) is not loaded: build_scene generates the world anew under the
    new name."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = WorldConfig(depth=3)
    old = _old_digest_path(cfg)
    assert old != cache.default_cache_path(cfg)
    assert old.parent == cache.default_cache_path(cfg).parent
    stale = [Chunk(np.array([0, 0, 0]),
                   np.zeros((CHUNK_SIZE,) * 3, bool))]
    cache.save_world(old, stale, cfg.size)
    assert cache.load_world(old, cfg.size) is not None
    scene = build_scene(cfg, "cpu")
    np.testing.assert_array_equal(
        assemble_dense(scene.chunks, cfg.size),
        assemble_dense(generate_world(cfg, "cpu"), cfg.size))
    assert cache.default_cache_path(cfg).exists()
