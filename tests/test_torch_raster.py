"""K9 + K10 (the face rasterizer): the port's plain `trace_raster` held to
the JAX package's `trace_raster` and to the port's numpy oracle.

Tolerance: none. (hit, face, axis_coord, t) are integer or exact float
outputs of the oracle's own formulas. Against JAX the inputs are the same
faces, camera and (JAX-made) directions. Against the oracle the port's own
rays go through both, on the corpus of tests/test_raster_trace.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.ops.rastertrace import trace_raster as jax_trace_raster
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.world.faces import extract_merged_faces as jax_merged_faces
from vvr_tpu_torch.ops import rastertrace
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.rastertrace import raster_camera, trace_raster
from vvr_tpu_torch.render.oracle import trace_dense
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.faces import extract_faces, extract_merged_faces

FIELDS = ("hit", "face", "axis_coord", "t")
TERRAIN_CAM = Camera.look_at([32.0, 45.0, 6.0], [32.0, 10.0, 40.0], fov=85.0)


def _probe(occ, cam):
    c = np.clip(np.floor(cam.position).astype(int), 0, occ.shape[0] - 1)
    return bool(occ[c[2], c[1], c[0]])


def _raster(occ, cam, w, h, merged=True):
    fs = extract_merged_faces(occ) if merged else extract_faces(occ)
    o, d = camera_rays(cam, w, h, "cpu")
    res = trace_raster(fs.device_tuple("cpu"), raster_camera(cam), d,
                       _probe(occ, cam), occ.shape[0], w, h)
    return res, o, d


def _staircase():
    zz, yy, xx = np.meshgrid(np.arange(64), np.arange(64), np.arange(64),
                             indexing="ij")
    return np.ascontiguousarray(yy <= ((xx + zz) // 2) % 24)


def _case(name, occ):
    """(occ, camera, w, h) of one oracle case."""
    if name == "single_block":
        one = np.zeros((16, 16, 16), bool)
        one[8, 8, 8] = True
        return one, Camera.look_at([2.0, 9.0, 2.0], [8.5, 8.5, 8.5], 60.0), \
            96, 64
    if name == "inside_solid":
        z, y, x = np.argwhere(occ)[0]
        return occ, Camera.look_at([x + 0.5, y + 0.5, z + 0.5],
                                   [x + 5.0, y + 5.0, z + 5.0], 70.0), 32, 24
    if name == "outside_world":
        return occ, Camera.look_at([-10.0, 40.0, -10.0], [32.0, 10.0, 32.0],
                                   80.0), 32, 24
    if name == "close_big_faces":
        solid = np.argwhere(occ)
        z, y, x = solid[len(solid) // 2]
        return occ, Camera.look_at([x + 0.5, y + 2.2, z + 0.5],
                                   [x + 0.5, y - 5.0, z + 0.5], 100.0), 64, 48
    if name.startswith("random"):
        rng = np.random.default_rng(5 + int(name[-1]))
        p = rng.uniform(2, 62, 3)
        tgt = rng.uniform(2, 62, 3)
        if np.linalg.norm(tgt - p) < 1:
            tgt = tgt + 3.0
        return occ, Camera.look_at(p, tgt, float(rng.uniform(40, 110))), \
            64, 48
    if name == "staircase":
        # a camera on the x = z diagonal of a diagonal staircase with an odd
        # width: the middle column's x and z crossings are near ties
        return _staircase(), Camera.look_at([1.5, 16.0, 1.5],
                                            [60.0, 10.0, 60.0], 40.0), 97, 65
    raise ValueError(name)


CASES = ["single_block", "inside_solid", "outside_world", "close_big_faces",
         "random0", "random1", "staircase"]


@pytest.mark.parametrize("name", CASES)
def test_raster_equals_oracle(name, small_world):
    occ, cam, w, h = _case(name, small_world[2])
    res, o, d = _raster(occ, cam, w, h)
    ref = trace_dense(occ, o.numpy(), d.numpy())
    hit = res.hit.numpy()
    np.testing.assert_array_equal(hit, ref["hit"])
    for f in ("face", "axis_coord", "t"):
        np.testing.assert_array_equal(getattr(res, f).numpy()[hit],
                                      ref[f][hit], err_msg=f)
    assert (res.iterations == 0).all() and (res.fetches == 0).all()
    if name == "inside_solid":
        assert hit.all() and (res.t == 0).all() and (res.face == 0).all()
    if name == "outside_world":
        assert not hit.any()
    if name in ("single_block", "staircase", "close_big_faces"):
        assert hit.any()


def test_raster_equals_jax(small_world):
    """Same faces, camera and JAX rays through both packages."""
    occ = small_world[2]
    jcam = JaxCamera(TERRAIN_CAM.position, TERRAIN_CAM.rotation,
                     TERRAIN_CAM.fov)
    _, jd = jax_camera_rays(jcam, 96, 64)
    rc = raster_camera(TERRAIN_CAM)
    probe = _probe(occ, TERRAIN_CAM)
    ref = jax_trace_raster(jax_merged_faces(occ).device_tuple(),
                           tuple(jnp.asarray(c) for c in rc), jd,
                           jnp.asarray(probe), 64, 96, 64)
    out = trace_raster(extract_merged_faces(occ).device_tuple("cpu"), rc,
                       torch.from_numpy(np.array(jd)), probe, 64, 96, 64)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert out.hit.any() and not out.hit.all()


def test_merged_equals_unit_faces(small_world):
    """Coverage is a per-cell range test, so merged rectangles give the
    unit faces' winners."""
    occ = small_world[2]
    rm = _raster(occ, TERRAIN_CAM, 96, 64, merged=True)[0]
    ru = _raster(occ, TERRAIN_CAM, 96, 64, merged=False)[0]
    for f in FIELDS:
        assert torch.equal(getattr(rm, f), getattr(ru, f)), f


def test_fragment_chunks_do_not_change_keys(small_world, monkeypatch):
    """The plain version walks the fragments in chunks; tiny chunks (one
    face at a time where a face alone overflows) give the same keys."""
    occ = small_world[2]
    fs = extract_merged_faces(occ).device_tuple("cpu")
    rc = raster_camera(TERRAIN_CAM)
    _, d = camera_rays(TERRAIN_CAM, 64, 48, "cpu")
    ref = rastertrace.raster_fragments(fs, rc, d, 64, 48)
    monkeypatch.setattr(rastertrace, "PLAIN_CHUNK", 500)
    assert torch.equal(rastertrace.raster_fragments(fs, rc, d, 64, 48), ref)
    assert (ref != -1).any()


def test_grazing_cell_follows_the_oracle():
    """`cell_at` is the DDA's cell, not floor(o + d*t), at ties and
    rounding: a u-crossing at exactly t_a counts first only when u > a."""
    o = torch.tensor([0.5, 0.5, 0.5, 0.5])
    d = torch.tensor([1.0, 1.0, -1.0, -1.0])
    t = torch.tensor([0.5, 0.5, 0.5, 0.5])      # u crosses at t_a exactly
    first = torch.tensor([True, False, True, False])
    np.testing.assert_array_equal(
        rastertrace.cell_at(o, d, t, first).numpy(), [1, 0, -1, 0])
    # no crossing: the start cell
    np.testing.assert_array_equal(
        rastertrace.cell_at(torch.tensor([3.25]), torch.tensor([0.0]),
                            torch.tensor([7.0]), torch.tensor([True])),
        [3])


def test_raster_dispatch_no_fallback(small_world):
    """A device with neither a kernel nor a plain path raises."""
    fs = extract_merged_faces(small_world[2]).device_tuple("cpu")
    _, d = camera_rays(TERRAIN_CAM, 8, 4, "cpu")
    with pytest.raises(ValueError):
        trace_raster(fs, raster_camera(TERRAIN_CAM), d.to("meta"), False,
                     64, 8, 4)
