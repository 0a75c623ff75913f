"""The port's exposed-face extraction (vvr_tpu_torch/world/faces.py) and the
scene's face and probe setup, held to the JAX package's.

Everything here is integer or boolean output, so every comparison is
exact, and the merged rectangles come in the JAX order."""

import numpy as np
import pytest
import torch

from vvr_tpu.world.faces import extract_merged_faces as jax_merged_faces
from vvr_tpu_torch import convert
from vvr_tpu_torch.config import WorldConfig
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.world.faces import (FIELDS, extract_faces,
                                       extract_merged_faces)

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)


def _occupancy(name, small_world):
    if name == "terrain":
        return small_world[2]
    return np.random.default_rng(3).random((16, 16, 16)) < 0.3


@pytest.mark.parametrize("name", ["terrain", "random16"])
def test_merged_faces_equal_jax(name, small_world):
    occ = _occupancy(name, small_world)
    ref = jax_merged_faces(occ)
    out = extract_merged_faces(occ)
    assert out.size == ref.size and len(out) == len(ref) > 0
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k),
                                      err_msg=k)
    assert out.einfo.any()      # some internal v edges to extend across


def test_extract_faces_brute_force():
    """Every solid voxel's face toward an empty or out-of-world neighbour,
    once (tests/test_raster_trace.py:50)."""
    occ = np.random.default_rng(3).random((16, 16, 16)) < 0.3
    fs = extract_faces(occ)
    n_exp = 0
    for dz, dy, dx in ((0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
                       (1, 0, 0), (-1, 0, 0)):
        for z, y, x in np.argwhere(occ):
            nz, ny, nx = z + dz, y + dy, x + dx
            if not (0 <= nz < 16 and 0 <= ny < 16 and 0 <= nx < 16) \
                    or not occ[nz, ny, nx]:
                n_exp += 1
    assert len(fs) == n_exp
    assert occ[fs.vz, fs.vy, fs.vx].all()
    off = np.where(fs.sgn == 1, 1, -1)
    nx = fs.vx + np.where(fs.axis == 0, off, 0)
    ny = fs.vy + np.where(fs.axis == 1, off, 0)
    nz = fs.vz + np.where(fs.axis == 2, off, 0)
    inb = ((nx >= 0) & (nx < 16) & (ny >= 0) & (ny < 16) & (nz >= 0)
           & (nz < 16))
    assert not occ[nz[inb], ny[inb], nx[inb]].any()
    # merged rectangles cover the same unit faces
    m = extract_merged_faces(occ)
    assert int((m.eu * m.ev).sum()) == len(fs)


def test_device_tuple_and_faces_from_numpy(small_world):
    ref = jax_merged_faces(small_world[2])
    dt = extract_merged_faces(small_world[2]).device_tuple("cpu")
    assert len(dt) == len(FIELDS)
    assert all(a.dtype == torch.int32 and a.is_contiguous() for a in dt)
    for a, b in zip(dt, convert.faces_from_numpy(ref, "cpu")):
        assert torch.equal(a, b)


def test_scene_faces_and_probe(tmp_path, small_world):
    """ensure_faces builds once, on the grid's device; solid_at_host is the
    occupancy at the clipped floor of the point."""
    sc = build_scene(WorldConfig(depth=3), "cpu",
                     cache_path=tmp_path / "map_64.npz")
    assert sc.faces is None
    faces = sc.ensure_faces()
    assert sc.ensure_faces() is faces
    ref = extract_merged_faces(small_world[2])
    np.testing.assert_array_equal(faces[3].numpy(), ref.axis)
    occ = small_world[2]
    pts = np.random.default_rng(0).uniform(-4, 68, (300, 3))
    for p in pts:
        c = np.clip(np.floor(p).astype(int), 0, 63)
        assert sc.solid_at_host(p) == bool(occ[c[2], c[1], c[0]])
