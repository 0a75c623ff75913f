"""The port's world setup held to the JAX package's: noise, generator
occupancy, jump-grid rows, the chunk cache format, and the rule that the
port never imports jax or vvr_tpu.

Everything here is integer or bit-pattern output (occupancy, u32 rows,
noise evaluated op by op), so every comparison is exact."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops import noise as jnoise
from vvr_tpu.world import cache as jcache
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.ops import noise
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.world import cache
from vvr_tpu_torch.world.generator import assemble_dense, generate_world
from vvr_tpu_torch.world.jumpgrid import build_jump_grid, build_jump_rows

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


def _points(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return rng.uniform(-300.0, 300.0, (2, n)).astype(np.float32)


@pytest.mark.parametrize("fn", ["perlin2", "fbm2", "fbm2_billow", "sdnoise2"])
def test_noise_equals_jax(fn):
    """Exact: lattice hashes are uint32 arithmetic and the float chains
    keep the JAX op order; JAX runs op by op here (no jit fusion)."""
    x, y = _points()
    calls = {
        "perlin2": lambda m, a, b: m.perlin2(a, b, seed=5),
        "fbm2": lambda m, a, b: m.fbm2(a, b, 6, 0.016, seed=0),
        "fbm2_billow": lambda m, a, b: m.fbm2(a, b, 3, 0.16, seed=101,
                                              billow=True),
        "sdnoise2": lambda m, a, b: m.sdnoise2(a, b, seed=17),
    }
    ref = calls[fn](jnoise, jnp.asarray(x), jnp.asarray(y))
    out = calls[fn](noise, torch.from_numpy(x), torch.from_numpy(y))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_generator_occupancy_equals_jax(small_world):
    """Exact at 64^3: a one-ulp height difference would flip a y < h
    voxel, so equal occupancy pins the height field too."""
    _, _, occ = small_world
    port = assemble_dense(generate_world(WorldConfig(depth=3), "cpu"), 64)
    np.testing.assert_array_equal(port, occ)


@pytest.mark.parametrize("scene", ["terrain", "sparse", "corner", "empty"])
def test_jump_rows_equal_jax(scene, small_world):
    """build_jump_grid rows equal the JAX package's word for word."""
    if scene == "terrain":
        occ = small_world[2]
    elif scene == "sparse":
        occ = np.random.default_rng(2).random((64, 64, 64)) < 0.01
    elif scene == "corner":
        occ = np.zeros((64, 64, 64), bool)
        occ[:8, :8, :8] = True
    else:
        occ = np.zeros((64, 64, 64), bool)
    ref = np.asarray(jax_build_jump_grid(occ).rows)
    np.testing.assert_array_equal(build_jump_rows(occ), ref)
    grid = build_jump_grid(torch.from_numpy(occ), "cpu")
    assert grid.rows.dtype == torch.int32 and grid.size == 64
    np.testing.assert_array_equal(grid.rows.numpy().view(np.uint32), ref)


def test_world_cache_format_shared_and_path_separate(tmp_path, small_world):
    """The npz/zlib format is the JAX package's (each reads the other's
    file), while the default path is the port's own."""
    _, chunks, occ = small_world
    jpath = tmp_path / "jax.npz"
    jcache.save_world(jpath, chunks, 64)
    loaded = cache.load_world(jpath)
    np.testing.assert_array_equal(assemble_dense(loaded, 64), occ)
    ppath = tmp_path / "port.npz"
    cache.save_world(ppath, loaded, 64)
    back = jcache.load_world(ppath)
    np.testing.assert_array_equal(
        np.stack([c.voxels for c in back]),
        np.stack([c.voxels for c in chunks]))
    port_path = cache.default_cache_path(WorldConfig(depth=3))
    assert port_path != jcache.default_cache_path(64)
    assert "vvr_tpu_torch" in port_path.parts


def test_world_cache_keyed_by_every_field(tmp_path, monkeypatch):
    """build_scene's default cache file is named by every WorldConfig
    field: two seeds of one size give two worlds, each reloaded from its
    own file."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfgs = [WorldConfig(depth=3), WorldConfig(depth=3, seed=1)]
    paths = [cache.default_cache_path(c) for c in cfgs]
    assert paths[0] != paths[1]
    a, b = (build_scene(c, "cpu") for c in cfgs)
    assert all(p.exists() and tmp_path in p.parents for p in paths)
    assert not torch.equal(a.jumpgrid.rows, b.jumpgrid.rows)
    again = build_scene(cfgs[1], "cpu")
    assert torch.equal(again.jumpgrid.rows, b.jumpgrid.rows)


def test_world_cache_of_another_size_not_loaded(tmp_path, small_world):
    """A file whose stored size is not the asked one is not loaded:
    build_scene regenerates the world and rewrites the file."""
    _, chunks, occ = small_world
    path = tmp_path / "map.npz"
    cache.save_world(path, chunks, 128)
    assert cache.load_world(path, 64) is None
    assert cache.load_world(path) is not None
    scene = build_scene(WorldConfig(depth=3), "cpu", cache_path=path)
    np.testing.assert_array_equal(assemble_dense(scene.chunks, 64), occ)
    np.testing.assert_array_equal(
        assemble_dense(cache.load_world(path, 64), 64), occ)


def test_port_imports_neither_jax_nor_vvr_tpu():
    """Every module of vvr_tpu_torch imports with jax and vvr_tpu blocked
    (the machine with the GPU has no jax)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vvr_tpu'] = None\n"
        "import vvr_tpu_torch\n"
        "for m in pkgutil.walk_packages(vvr_tpu_torch.__path__, "
        "'vvr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
