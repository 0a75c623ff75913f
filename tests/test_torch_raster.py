"""K9 + K10 (the face rasterizer): the port's plain `trace_raster` held to
the JAX package's `trace_raster` and to the port's numpy oracle, and the
CUDA K9's tile-binned design (`raster_fragments_tiled_plain`) held to the
plain K9 key for key.

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

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

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


def _edges_at_centres():
    """A checkered wall at z = 10 (a backing wall at z = 11) seen straight
    along +z from z = 2 with a 90-degree fov at 64 x 64: every voxel edge
    of the z = 10 plane projects onto a column or row of pixel centres
    (ic = 64 - 4x, jc = 64 - 4y)."""
    occ = np.zeros((16, 16, 16), bool)
    yy, xx = np.meshgrid(np.arange(4, 12), np.arange(4, 12), indexing="ij")
    occ[10, 4:12, 4:12] = (xx + yy) % 2 == 0
    occ[11, 4:12, 4:12] = True
    return occ, Camera.look_at([8.125, 8.125, 2.0], [8.125, 8.125, 12.0],
                               90.0), 64, 64


def _straddle():
    """A floor (y < 4) with a pillar, the camera just above it looking
    along it: the floor's top faces run from behind the camera to in
    front of it."""
    occ = np.zeros((16, 16, 16), bool)
    occ[:, :4] = True
    occ[8:10, 4:8, 6:8] = True
    return occ, Camera.look_at([8.3, 5.2, 3.1], [8.3, 4.2, 15.0], 80.0), \
        96, 72


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
    if name == "sky":
        # looking up from above the terrain: no face on screen, every
        # pixel misses (every tile bin of K9's design stays empty)
        return occ, Camera.look_at([32.0, 60.0, 32.0], [32.0, 90.0, 33.0],
                                   70.0), 32, 24
    if name == "edges_at_centres":
        return _edges_at_centres()
    if name == "straddle":
        return _straddle()
    raise ValueError(name)


CASES = ["single_block", "inside_solid", "outside_world", "close_big_faces",
         "random0", "random1", "staircase", "edges_at_centres", "straddle",
         "sky"]


def _corners(fs):
    """(n, 4, 3) float64 corners of the face rectangles."""
    vx, vy, vz, axis, sgn, eu, ev = (np.asarray(a, np.float64)
                                     for a in fs.device_tuple("cpu")[:7])
    plane = np.choose(axis.astype(int), [vx, vy, vz]) + sgn
    out = []
    for du in (0.0, 1.0):
        for dv in (0.0, 1.0):
            out.append(np.stack([
                np.where(axis == 0, plane, vx + du * eu),
                np.where(axis == 1, plane, vy + np.where(axis == 0, du * eu,
                                                         dv * ev)),
                np.where(axis == 2, plane, vz + dv * ev)], -1))
    return np.stack(out, 1)


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
    if name in ("outside_world", "sky"):
        assert not hit.any()
    if name in ("single_block", "staircase", "close_big_faces",
                "edges_at_centres", "straddle"):
        assert hit.any()


@pytest.mark.parametrize("name", CASES)
def test_tiled_twin_equals_plain(name, small_world):
    """K9's tile-binned design gives the plain K9's keys bit for bit, with
    its default bin limit (at these sizes every face is binned) and with
    every face on the big list (0)."""
    occ, cam, w, h = _case(name, small_world[2])
    fs = extract_merged_faces(occ).device_tuple("cpu")
    rc = raster_camera(cam)
    _, d = camera_rays(cam, w, h, "cpu")
    ref = rastertrace.raster_fragments_plain(fs, rc, d, w, h)
    for bin_max in (rastertrace.BIN_MAX, 0):
        out = rastertrace.raster_fragments_tiled_plain(fs, rc, d, w, h,
                                                       bin_max)
        assert torch.equal(out, ref), (bin_max, int((out != ref).sum()))
    if name in ("single_block", "staircase", "edges_at_centres", "straddle"):
        assert (ref != -1).any()
    if name == "sky":
        assert (ref == -1).all()


@pytest.mark.parametrize("name", CASES)
def test_depth_cull_bound_holds(name, small_world):
    """K9's depth cull never drops a fragment the exact test covers: each
    covered fragment's key is at least its face's `face_t_keys` bound."""
    occ, cam, w, h = _case(name, small_world[2])
    fs = extract_merged_faces(occ).device_tuple("cpu")
    rc = raster_camera(cam)
    _, d = camera_rays(cam, w, h, "cpu")
    face, _, key = rastertrace.tiled_fragments_plain(fs, rc, d, w, h)
    bound = rastertrace.face_t_keys(fs, rc)
    assert (bound[face] <= key).all()
    if name in ("single_block", "staircase", "edges_at_centres", "straddle"):
        assert (bound[face] > 0).any()


@pytest.mark.parametrize("name", CASES)
def test_tight_box_holds_every_covered_fragment(name, small_world):
    """K9's tight bbox never drops a fragment the exact test covers: every
    covered fragment of the JAX box lies in its face's tight box."""
    occ, cam, w, h = _case(name, small_world[2])
    fs = extract_merged_faces(occ).device_tuple("cpu")
    rc = raster_camera(cam)
    _, d = camera_rays(cam, w, h, "cpu")
    face, pix, _ = rastertrace.tiled_fragments_plain(fs, rc, d, w, h,
                                                     tight=False)
    use, imin, imax, jmin, jmax = rastertrace.project_faces(fs, rc, w, h,
                                                            tight=True)
    i, j = pix % w, pix // w
    assert (use[face] & (imin[face] <= i) & (i <= imax[face])
            & (jmin[face] <= j) & (j <= jmax[face])).all()
    loose = rastertrace.project_faces(fs, rc, w, h)
    area = [((b - a + 1) * (bb - aa + 1))[u].sum()
            for u, a, b, aa, bb in (loose, (use, imin, imax, jmin, jmax))]
    assert area[1] <= area[0]


def test_edges_at_centres_case_is_one():
    """The z = 10 plane's face corners project within 1e-3 px of pixel
    centres (float64 pinhole projection)."""
    occ, cam, w, h = _edges_at_centres()
    right, up, fwd = (np.asarray(v, np.float64) for v in cam.basis())
    tan_half = np.tan(np.radians(cam.fov) / 2.0)
    corners = _corners(extract_merged_faces(occ))
    front = corners[:, :, 2].max(1) == 10.0
    q = corners[front] - np.asarray(cam.position, np.float64)
    zc = q @ fwd
    ic = (q @ right / (zc * tan_half) + 1.0) * (w / 2) - 0.5
    jc = (1.0 - q @ up / (zc * tan_half * h / w)) * (h / 2) - 0.5
    assert front.sum() > 4
    assert np.abs(ic - np.round(ic)).max() < 1e-3
    assert np.abs(jc - np.round(jc)).max() < 1e-3


def test_straddle_case_is_one():
    """Some face of the straddle case has corners on both sides of the
    camera plane."""
    occ, cam, _, _ = _straddle()
    fwd = np.asarray(cam.basis()[2], np.float64)
    zc = (_corners(extract_merged_faces(occ))
          - np.asarray(cam.position, np.float64)) @ fwd
    assert ((zc <= 1e-6).any(1) & (zc > 1e-6).any(1)).any()


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
        rastertrace.cell_at(o, d, t, first,
                            rastertrace.reciprocal(d)).numpy(),
        [1, 0, -1, 0])
    # no crossing: the start cell
    d0 = torch.tensor([0.0])
    np.testing.assert_array_equal(
        rastertrace.cell_at(torch.tensor([3.25]), d0, torch.tensor([7.0]),
                            torch.tensor([True]),
                            rastertrace.reciprocal(d0)), [3])


def test_raster_dispatch_no_fallback(small_world):
    """A device with neither a kernel nor a plain path raises."""
    fs = extract_merged_faces(small_world[2]).device_tuple("cpu")
    _, d = camera_rays(TERRAIN_CAM, 8, 4, "cpu")
    with pytest.raises(ValueError):
        trace_raster(fs, raster_camera(TERRAIN_CAM), d.to("meta"), False,
                     64, 8, 4)
