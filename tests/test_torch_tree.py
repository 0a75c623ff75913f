"""The port's SVO64 tree and what it reads (world/tree.py, world/chunk.py
build_chunk_mips, world/pyramid.py OccupancyPyramid, utils/bits.py)
against the JAX package, array for array, on the cases of
tests/test_tree.py, tests/test_world.py and tests/test_bits.py, the 64^3
terrain and, once, the 256^3 terrain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.utils import bits as jbits
from vvr_tpu.world import cache as jcache
from vvr_tpu.world import tree as jtree
from vvr_tpu.world.chunk import build_chunk_mips as jax_build_chunk_mips
from vvr_tpu.world.pyramid import build_pyramid as jax_build_pyramid
from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.render.scene import Scene
from vvr_tpu_torch.utils import bits
from vvr_tpu_torch.world import cache, tree
from vvr_tpu_torch.world.chunk import CHUNK_MIPS, Chunk, build_chunk_mips
from vvr_tpu_torch.world.generator import assemble_dense, generate_world
from vvr_tpu_torch.world.pyramid import (build_pyramid,
                                         build_pyramid_from_chunks)

torch.set_num_threads(1)


def _scene_occ(name):
    rng = np.random.default_rng(10)
    if name == "random":
        return rng.random((64, 64, 64)) < 0.2
    if name == "full":
        return np.ones((16, 16, 16), bool)
    if name == "empty":
        return np.zeros((16, 16, 16), bool)
    occ = np.zeros((64, 64, 64), bool)      # "pruned": tests/test_tree.py
    occ[0:16, 0:16, 0:16] = True            # a full level-2 cell
    occ[32, 32, 32] = True
    return occ


def _assert_tree_equal(port, ref):
    indices, bitmasks, aabbs = port.numpy()
    for a, b in ((indices, ref.indices), (bitmasks, ref.bitmasks),
                 (aabbs, ref.aabbs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.level_starts == ref.level_starts
    assert port.depth == ref.depth
    drop = ("build_time_s",)
    assert ({k: v for k, v in port.metrics.items() if k not in drop}
            == {k: v for k, v in ref.metrics.items() if k not in drop})


@pytest.fixture(scope="module")
def terrain_256():
    """The 256^3 world's chunks (the port's generator, equal to JAX's),
    its dense occupancy and its JAX tree, shared by this file's tests."""
    chunks = generate_world(WorldConfig(depth=4), "cpu")
    occ = assemble_dense(chunks, 256)
    ref = jtree.flatten_tree(jax_build_pyramid(occ),
                             jtree.bounds_pyramid_from_dense(occ))
    return chunks, occ, ref


@pytest.mark.parametrize("name", ["random", "full", "empty", "pruned"])
def test_tree_equals_jax(name):
    """indices, bitmasks, aabbs, level starts, depth and metrics (with the
    SAH metric) equal JAX flatten_tree's; the invariant holds."""
    occ = _scene_occ(name)
    ref = jtree.flatten_tree(jax_build_pyramid(occ),
                             jtree.bounds_pyramid_from_dense(occ),
                             calculate_sah=True)
    port = tree.flatten_tree(build_pyramid(occ, "cpu"),
                             tree.bounds_pyramid_from_dense(occ, "cpu"),
                             calculate_sah=True)
    _assert_tree_equal(port, ref)
    tree.verify_popcount_invariant(port)
    if name == "pruned":
        h2 = port.numpy()[0][port.level_starts[2]:port.level_starts[1]]
        assert int((h2 == tree.FULL_NODE).sum()) == 1


def test_terrain_tree_from_chunks_equals_jax(small_world):
    """The 64^3 terrain: both bounds pyramids equal JAX's grid for grid,
    and the scene's tree (ensure_tree) equals the JAX tree of the chunk
    bounds."""
    cfg, jchunks, occ = small_world
    chunks = [Chunk(c.position, c.voxels) for c in jchunks]
    jb_dense = jtree.bounds_pyramid_from_dense(occ)
    jb_chunks = jtree.bounds_pyramid_from_chunks(jchunks, cfg.size)
    for a, b in zip(tree.bounds_pyramid_from_dense(occ, "cpu"), jb_dense):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tree.bounds_pyramid_from_chunks(chunks, cfg.size),
                    jb_chunks):
        np.testing.assert_array_equal(a, b)
    ref = jtree.flatten_tree(jax_build_pyramid(occ), jb_chunks)
    scene = Scene(WorldConfig(depth=3), chunks, device="cpu")
    _assert_tree_equal(scene.ensure_tree(), ref)
    tree.verify_popcount_invariant(scene.tree)


def test_terrain_256_tree_equals_jax(terrain_256):
    chunks, occ, ref = terrain_256
    scene = Scene(WorldConfig(depth=4), chunks, device="cpu")
    port = scene.ensure_tree()
    _assert_tree_equal(port, ref)
    tree.verify_popcount_invariant(port)
    assert port.metrics["level_counts"][1] == ref.metrics["level_counts"][1]


def test_tree_checkpoint_both_ways(tmp_path, terrain_256):
    """The port's checkpoint round-trips and JAX load_tree reads it; the
    port's load_tree reads JAX save_tree's file."""
    _, _, ref = terrain_256
    port = tree.flatten_tree(
        build_pyramid(terrain_256[1], "cpu"),
        tree.bounds_pyramid_from_dense(terrain_256[1], "cpu"))
    path = tmp_path / "tree.npz"
    cache.save_tree(path, port)
    back = cache.load_tree(path, "cpu")
    for a, b in zip(back.numpy(), port.numpy()):
        np.testing.assert_array_equal(a, b)
    assert back.level_starts == port.level_starts and back.depth == 4
    tree.verify_popcount_invariant(back)
    jl = jcache.load_tree(path)
    _assert_tree_equal_arrays(jl, ref)
    jpath = tmp_path / "jax_tree.npz"
    jcache.save_tree(jpath, ref)
    _assert_tree_equal_arrays(cache.load_tree(jpath, "cpu"), ref)
    assert cache.load_tree(tmp_path / "none.npz", "cpu") is None


def _assert_tree_equal_arrays(t, ref):
    arrays = t.numpy() if hasattr(t, "numpy") else (t.indices, t.bitmasks,
                                                     t.aabbs)
    for a, b in zip(arrays, (ref.indices, ref.bitmasks, ref.aabbs)):
        np.testing.assert_array_equal(a, b)
    assert t.level_starts == ref.level_starts and t.depth == ref.depth


def test_tree_bitmasks_are_the_pyramid_any_masks(terrain_256):
    """Each node's bitmask equals the any mask of the same cell in the
    scene's brick pyramid (the check chip_smoke.py makes on the card), the
    cells replayed from the root by the bitmasks; the replay's cells are
    the JAX tree's aabbs' cells."""
    chunks, _, ref = terrain_256
    scene = Scene(WorldConfig(depth=4), chunks, device="cpu")
    t = scene.ensure_tree()
    masks = tree.brick_pyramid_masks(t, scene.ensure_pyramid())
    assert torch.equal(masks, t.bitmasks)
    cells = tree.node_cells(t)
    assert [cells[lvl].shape[0] for lvl in range(4, 0, -1)] \
        == [t.metrics["level_counts"][lvl] for lvl in range(4, 0, -1)]
    lo = ref.aabbs & np.uint64(0x3FFFFFFF)
    mn = np.stack([(lo >> np.uint64(10 * k)) & np.uint64(1023)
                   for k in range(3)], -1).astype(np.int64)
    s1 = t.level_starts[1]
    np.testing.assert_array_equal(cells[1].numpy(), mn[s1:] // 4)
    broken = t.bitmasks.clone()
    broken[s1] ^= 1 << 5
    assert not torch.equal(masks, broken)


@pytest.mark.parametrize("case", ["terrain", "full", "empty", "partial",
                                  "random"])
def test_chunk_mips_equal_jax(case, small_world):
    """build_chunk_mips equals the JAX one array for array, and a chunk's
    mips and world bounds follow its voxels (computed when asked for)."""
    if case == "terrain":
        vox = [c.voxels for c in small_world[1]]
    elif case == "full":
        vox = [np.ones((64,) * 3, bool)]
    elif case == "empty":
        vox = [np.zeros((64,) * 3, bool)]
    elif case == "partial":
        v = np.zeros((64,) * 3, bool)
        v[10, 20, 30] = True
        v[11, 22, 33] = True
        vox = [v]
    else:
        vox = [np.random.default_rng(0).random((64,) * 3) < 0.3]
    for v in vox:
        ref, port = jax_build_chunk_mips(v), build_chunk_mips(v)
        for k in range(CHUNK_MIPS):
            np.testing.assert_array_equal(port.any_mips[k], ref.any_mips[k])
            np.testing.assert_array_equal(port.all_mips[k], ref.all_mips[k])
            np.testing.assert_array_equal(port.bounds[k], ref.bounds[k])
    if case == "partial":
        c = Chunk([1, 0, 2], vox[0].copy())
        np.testing.assert_array_equal(c.world_bounds,
                                      [94, 20, 138, 98, 23, 140])
        c.voxels[:] = False
        assert not c.mips.any_mips[3].any()
        np.testing.assert_array_equal(c.world_bounds, np.zeros(6))


@pytest.mark.parametrize("case", ["terrain", "random16"])
def test_occupancy_pyramid_equals_jax(case, small_world):
    """Words, bases and every level's (any, full) bits equal JAX's; the
    chunk builder gives the dense builder's words."""
    if case == "terrain":
        occ = small_world[2]
    else:
        occ = np.random.default_rng(11).random((16, 16, 16)) < 0.3
    ref = jax_build_pyramid(occ)
    port = build_pyramid(occ, "cpu")
    np.testing.assert_array_equal(port.words.numpy().view(np.uint32),
                                  np.asarray(ref.words))
    assert port.bases == ref.bases and port.depth == ref.depth
    for lvl in range(ref.depth + 1):
        for a, b in zip(port.level_bits(lvl), ref.level_bits(lvl)):
            np.testing.assert_array_equal(a, b)
    if case == "terrain":
        chunks = [Chunk(c.position, c.voxels) for c in small_world[1]]
        assert torch.equal(build_pyramid_from_chunks(chunks, 64, "cpu").words,
                           port.words)


def test_bits_equal_jax():
    """tests/test_bits.py's cases through the port's helpers, torch and
    numpy."""
    idx = np.arange(64 ** 3)
    off = bits.index_to_offset(idx, 64)
    np.testing.assert_array_equal(off, jbits.index_to_offset(idx, 64))
    np.testing.assert_array_equal(bits.offset_to_index(off, 64), idx)
    t_off = bits.index_to_offset(torch.from_numpy(idx), 64)
    np.testing.assert_array_equal(t_off.numpy(), off)
    o = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [3, 3, 3]])
    np.testing.assert_array_equal(bits.child_bit_index(o), [1, 4, 16, 63])
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint32)
    expect = np.asarray(jbits.popcount32(jnp.asarray(v)))
    np.testing.assert_array_equal(bits.popcount32(v), expect)
    np.testing.assert_array_equal(
        bits.popcount32(torch.from_numpy(v.view(np.int32))).numpy(), expect)
    rng = np.random.default_rng(1)
    masks = rng.integers(0, 2 ** 64, size=500, dtype=np.uint64)
    bit = rng.integers(0, 64, size=500)
    lo, hi = bits.u64_split(masks)
    jlo, jhi = jbits.u64_split(masks)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(bits.u64_join(lo, hi), masks)
    tlo, thi = (torch.from_numpy(w.view(np.int32)) for w in (lo, hi))
    tb = torch.from_numpy(bit)
    np.testing.assert_array_equal(
        bits.popcount_prefix_u64(tlo, thi, tb).numpy(),
        np.asarray(jbits.popcount_prefix_u64(jnp.asarray(lo),
                                             jnp.asarray(hi),
                                             jnp.asarray(bit))))
    np.testing.assert_array_equal(
        bits.u64_get_bit(tlo, thi, tb).numpy(),
        np.asarray(jbits.u64_get_bit(jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.asarray(bit))))
    t64 = torch.from_numpy(masks.view(np.int64))
    slo, shi = bits.u64_split(t64)
    np.testing.assert_array_equal(slo.numpy(), lo.astype(np.int64))
    assert torch.equal(bits.u64_join(slo, shi), t64)
    v4 = np.array([0, 1, 4, 16, 64, 20, 256, 3], np.int32)
    want = [4, 0, 1, 2, 3, 1, 4, 0]
    np.testing.assert_array_equal(bits.base4_trailing_levels(v4, 4), want)
    np.testing.assert_array_equal(
        bits.base4_trailing_levels(torch.from_numpy(v4), 4).numpy(), want)
    np.testing.assert_array_equal(jbits.base4_trailing_levels(v4, 4), want)
