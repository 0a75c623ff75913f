"""The port's mesher, AO solver and camera matrices on the CPU, held to the
JAX package.

- Mesher: surface nets and the blocky scheme give the JAX mesher's
  vertices, indices, draw ranges and OBJ text exactly, on the 64^3
  world's chunk and on three seeded random chunks (with an empty and a
  full chunk beside them, which neither scheme meshes but the blocky one
  meshes the full chunk).
- `ao_solver` equals the JAX function's on seeded probes.
- `Camera.matrices`, `horizontal_to_vertical` and `Snapshot.to_json`
  equal the JAX camera's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vvr_tpu.ops.shade import ao_solver as jax_ao_solver
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.utils.camera import horizontal_to_vertical as jax_h2v
from vvr_tpu.utils.camera import load_snapshots as jax_load_snapshots
from vvr_tpu.world.chunk import Chunk as JaxChunk
from vvr_tpu.world.mesher import VoxelMeshBuffers as JaxMesh
from vvr_tpu_torch import convert
from vvr_tpu_torch.ops.shade import ao_solver
from vvr_tpu_torch.utils.camera import Camera, horizontal_to_vertical
from vvr_tpu_torch.utils.camera import load_snapshots
from vvr_tpu_torch.world.chunk import Chunk
from vvr_tpu_torch.world.mesher import (VoxelMeshBuffers,
                                        mesh_chunk_surface_nets,
                                        mesh_voxels_blocky)

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

SCHEMES = ("surface_nets", "blocky")


def _random_chunks():
    """Three seeded random partial chunks (scattered voxels at densities
    0.01 and 0.04, and a ground of random column heights), an empty and a
    full one."""
    rng = np.random.default_rng(17)
    vox = [rng.random((64,) * 3) < p for p in (0.01, 0.04)]
    h = (rng.random((64, 64)) * 40 + 8).astype(int)
    ground = np.arange(64)[None, :, None] < h[:, None, :]
    vox += [ground, np.zeros((64,) * 3, bool), np.ones((64,) * 3, bool)]
    return [([k % 2, k // 2, 1], v) for k, v in enumerate(vox)]


def _both(voxels_at):
    """(JAX chunks, port chunks) over the same voxels."""
    jax_chunks = [JaxChunk(np.array(p), v.copy()).rebuild()
                  for p, v in voxels_at]
    return jax_chunks, [Chunk(np.array(p), v.copy()) for p, v in voxels_at]


@pytest.fixture(scope="module")
def chunk_sets(small_world):
    _, chunks, _ = small_world
    world = [(c.position, np.asarray(c.voxels)) for c in chunks]
    return {"world": _both(world), "random": _both(_random_chunks())}


def _assert_same_mesh(ours: VoxelMeshBuffers, ref):
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    assert ours.vertices.dtype == np.float32
    np.testing.assert_array_equal(ours.indices, ref.indices)
    assert ours.indices.dtype == np.uint32
    assert len(ours.ranges) == len(ref.ranges)
    for a, b in zip(ours.ranges, ref.ranges):
        np.testing.assert_array_equal(a.chunk_position, b.chunk_position)
        assert (a.first_index, a.index_count, a.vertex_offset) == (
            b.first_index, b.index_count, b.vertex_offset)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("which", ["world", "random"])
def test_mesh_buffers_equal_jax(chunk_sets, which, scheme, tmp_path):
    """The world buffers, ranges and OBJ text equal the JAX mesher's (its
    blocky scheme on the numpy path, which tests/test_native.py holds
    equal to its C++ one)."""
    jax_chunks, chunks = chunk_sets[which]
    ref = JaxMesh.build(jax_chunks, prefer_native=False, scheme=scheme)
    ours = VoxelMeshBuffers.build(chunks, scheme=scheme)
    assert len(ours.indices) > 0
    _assert_same_mesh(ours, ref)
    if which == "random":
        # the empty chunk is skipped by both; the full one only by nets
        assert len(ours.ranges) == (3 if scheme == "surface_nets" else 4)
    ref.export_obj(tmp_path / "jax.obj")
    ours.export_obj(tmp_path / "port.obj")
    assert (tmp_path / "port.obj").read_text() == \
        (tmp_path / "jax.obj").read_text()


@pytest.mark.parametrize("k", range(3))
def test_chunk_meshers_equal_jax(chunk_sets, k):
    """Each random chunk alone through both chunk meshers."""
    from vvr_tpu.world.mesher import mesh_chunk_surface_nets as jax_nets
    from vvr_tpu.world.mesher import mesh_voxels_blocky as jax_blocky
    vox = chunk_sets["random"][1][k].voxels
    for ours, ref in ((mesh_chunk_surface_nets, jax_nets),
                      (mesh_voxels_blocky, jax_blocky)):
        (v, i), (jv, ji) = ours(vox), ref(vox)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(i, ji)


def test_triangles_and_mesh_from_numpy(chunk_sets):
    """`triangles()` flattens the ranges (indices + vertex offset) as the
    JAX frame does (raster.py:308-315), and mesh_from_numpy carries a JAX
    mesh over unchanged."""
    jax_chunks, _ = chunk_sets["random"]
    ref = JaxMesh.build(jax_chunks, prefer_native=False)
    mesh = convert.mesh_from_numpy(ref.vertices, ref.indices, ref.ranges,
                                   device="cpu")
    _assert_same_mesh(mesh.buffers, ref)
    tris = np.concatenate([
        np.asarray(ref.indices[r.first_index:r.first_index + r.index_count],
                   np.int64) + r.vertex_offset for r in ref.ranges])
    np.testing.assert_array_equal(mesh.tris_host.reshape(-1), tris)
    assert mesh.tris.dtype == torch.int32 and mesh.verts.dtype == torch.float32
    np.testing.assert_array_equal(mesh.tris.numpy(), mesh.tris_host)
    tup = [(r.chunk_position, r.first_index, r.index_count, r.vertex_offset)
           for r in ref.ranges]
    again = convert.mesh_from_numpy(ref.vertices, ref.indices, tup, "cpu")
    np.testing.assert_array_equal(again.tris_host, mesh.tris_host)
    with pytest.raises(ValueError):
        convert.mesh_from_numpy(ref.vertices[:10], ref.indices, ref.ranges,
                                "cpu")


def test_ao_solver_equals_jax():
    """Seeded probes over a random 8^3 occupancy: every face, ray sign and
    uv; the port's AO equals the JAX solver's bit for bit."""
    rng = np.random.default_rng(5)
    occ = rng.random((8, 8, 8)) < 0.4
    n = 400
    block = rng.integers(1, 7, (n, 3)).astype(np.int32)
    uv = rng.random((n, 3)).astype(np.float32)
    face = rng.integers(0, 3, n).astype(np.int32)
    sgn = np.where(rng.random((n, 3)) < 0.5, -1.0, 1.0).astype(np.float32)
    occ_j = jnp.asarray(occ)
    occ_t = torch.from_numpy(occ)

    def jax_solid(p):
        p = jnp.clip(p, 0, 7)
        return occ_j[p[..., 2], p[..., 1], p[..., 0]]

    def solid(p):
        p = torch.clamp(p, 0, 7)
        return occ_t[p[..., 2], p[..., 1], p[..., 0]]

    ref = np.asarray(jax_ao_solver(jax_solid, jnp.asarray(block),
                                   jnp.asarray(uv), jnp.asarray(face),
                                   jnp.asarray(sgn)))
    ours = ao_solver(solid, torch.from_numpy(block), torch.from_numpy(uv),
                     torch.from_numpy(face), torch.from_numpy(sgn))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert 0 < (ref < 1).mean() < 1


@pytest.mark.parametrize("size", [(96, 64), (1920, 1080), (33, 67)])
def test_camera_matrices_equal_jax(size):
    """view and proj of snapshot and look-at cameras, bit for bit."""
    cams = [((32, 28, 6), (32, 2, 45), 85.0), ((1.5, 90, -3), (7, 2, 45),
                                                100.0),
            ((128, 100, 20), (128, 20, 180), 60.0)]
    pairs = [(Camera.look_at(p, t, fov), JaxCamera.look_at(p, t, fov))
             for p, t, fov in cams]
    pairs += [(Camera.from_snapshot(a), JaxCamera.from_snapshot(b))
              for a, b in zip(load_snapshots(), jax_load_snapshots())]
    for ours, ref in pairs:
        for a, b in zip(ours.matrices(*size), ref.matrices(*size)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert (ours.near, ours.far) == (ref.near, ref.far)
    assert horizontal_to_vertical(85.0, size[0] / size[1]) == \
        jax_h2v(85.0, size[0] / size[1])


def test_snapshot_to_json_equals_jax():
    for ours, ref in zip(load_snapshots(), jax_load_snapshots()):
        assert ours.to_json() == ref.to_json()
        assert type(ours).from_json(ours.to_json()).to_json() == \
            ours.to_json()
