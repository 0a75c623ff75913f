"""The brick pyramid on the CPU: the port's builder, HDDA (K19's plain
version), overlap AO (K20's), debug heatmaps (K21's), the pyramid frames
and the pyramid's edits, held to the JAX package.

- Builder and edits: rows, bases and depth equal JAX
  `build_brick_pyramid`'s and the JAX editor's, row for row.
- HDDA: every output of every lane equals JAX `trace(compact=False)`
  (hit, face, axis_coord, t and the three counters), with the FULL
  early-out and without, on tests/test_traverse.py's cases, random rays
  on the 64^3 world and rays that reach a small cap; hits equal the
  port's oracle.
- Overlap: the densities and the AO equal the jitted JAX functions
  exactly (they round as XLA's jit does: ops/overlap.py); the cube at
  half 2.4, whose JAX jit takes minutes to compile, is held by its sum to
  the JAX function run op by op, which divides that sum by the volume.
- Frames: the pyramid frame meets the goldens' bar (they are JAX pyramid
  frames) and equals the port's jump-grid frame byte for byte; the
  normals heatmap frame equals JAX `render_frame`'s u8 on both grids;
  the overlap AO frame on the jump grid is within HDR rtol=atol=4e-6 and
  one u8 step of the JAX frame (which reads a JAX pyramid for it).
"""

import copy
import ctypes
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.ops import overlap as jax_overlap
from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.ops.traverse import trace as jax_trace
from vvr_tpu.render.frame import _debug_image as jax_debug_image
from vvr_tpu.render.frame import render_frame as jax_render_frame
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.world.edit import WorldEditor as JaxWorldEditor
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu.world.occupancy import \
    pyramid_voxel_solid as jax_pyramid_voxel_solid
from vvr_tpu.world.pyramid import build_brick_pyramid as jax_build_pyramid
from vvr_tpu_torch import convert, kernels
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import debug as debug_ops
from vvr_tpu_torch.ops import overlap
from vvr_tpu_torch.ops import trace as tracer
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.traverse import trace_pyramid, trace_pyramid_plain
from vvr_tpu_torch.render.frame import render_frame
from vvr_tpu_torch.render.oracle import trace_dense
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.render.scene import Scene
from vvr_tpu_torch.utils.camera import Camera, load_snapshots
from vvr_tpu_torch.world.chunk import Chunk
from vvr_tpu_torch.world.edit import WorldEditor
from vvr_tpu_torch.world.jumpgrid import build_jump_grid
from vvr_tpu_torch.world.occupancy import pyramid_voxel_solid
from vvr_tpu_torch.world.paged import build_paged_grid
from vvr_tpu_torch.world.pyramid import (brick_pyramid_from_chunks,
                                         build_brick_pyramid)

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
SLICE = dict(width=96, height=64, shadow_samples=1, max_ray_iterations=2,
             skybox_resolution=32, clouds_resolution=32,
             primary_raster="off", sun_mask="off")
SUN = np.array([-0.28, 0.65, -0.71], np.float32)
SUN = np.concatenate([SUN / np.linalg.norm(SUN), [0.0]]).astype(np.float32)
TERRAIN = Camera.look_at([32, 28, 6], [32, 2, 45], fov=85)
N = 1024          # one ray-batch shape: one JAX compile per cap and mode
OUTPUTS = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
           "missed_pops")
JAX_AO = jax.jit(jax_overlap.overlap_ao)


def _pair(occ):
    """(JAX pyramid, the port's pyramid built from the same occupancy)."""
    return jax_build_pyramid(occ), build_brick_pyramid(occ, "cpu")


def _random_rays(rng, n, size, inside=True):
    lo, hi = (0.5, size - 0.5) if inside else (-size, 2 * size)
    o = rng.uniform(lo, hi, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _pad(o, d, act=None):
    reps = -(-N // len(o))
    act = np.ones(len(o), bool) if act is None else act
    return (np.tile(o, (reps, 1))[:N].astype(np.float32),
            np.tile(d, (reps, 1))[:N].astype(np.float32),
            np.tile(act, reps)[:N])


def _case(name, small_world):
    """(occupancy, o, d, active) of tests/test_traverse.py's cases."""
    rng = np.random.default_rng(5)
    occ = np.zeros((64,) * 3, bool)
    if name == "single_voxel":
        occ[8, 8, 8] = True
        o = np.array([[0.5, 8.5, 8.5], [0.5, 8.5, 8.5], [8.5, 8.5, 8.5]])
        d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0]])
        return (occ, *_pad(o, d))
    if name in ("inside_solid", "outside_origin", "active_mask"):
        occ[:] = True
        if name == "inside_solid":
            return (occ, *_pad(np.array([[5.5, 5.5, 5.5]]),
                               np.array([[1, 0, 0]])))
        if name == "outside_origin":
            return (occ, *_pad(np.array([[-1.0, 5, 5], [64.0, 5, 5]]),
                               np.array([[1, 0, 0], [-1, 0, 0]])))
        return (occ, *_pad(np.full((4, 3), 5.5), np.tile([[1, 0, 0]],
                                                         (4, 1)),
                           np.array([True, False, True, False])))
    if name == "axis_aligned":
        occ = rng.random((64,) * 3) < 0.02
        o = rng.uniform(0.25, 63.75, size=(200, 3))
        d = np.zeros((200, 3))
        d[np.arange(200), rng.integers(0, 3, 200)] = rng.choice([-1.0, 1.0],
                                                                200)
        return (occ, *_pad(o, d))
    if name == "empty_world":
        return (occ, *_pad(*_random_rays(rng, N, 64)))
    if name == "full_region":
        occ[0:16, 0:16, 0:16] = True
        return (occ, *_pad(*_random_rays(rng, N, 64)))
    occ = small_world[2]
    o, d = _random_rays(np.random.default_rng(7), N, 64,
                        inside=name != "terrain_outside")
    # rays from voxel corners and cell planes: exact boundary crossings
    o[:256] = np.floor(o[:256] * 2) / 2
    return (occ, *_pad(o, d))


CASES = ["single_voxel", "inside_solid", "outside_origin", "axis_aligned",
         "empty_world", "full_region", "active_mask", "terrain",
         "terrain_outside"]


def _jax_trace(jp, o, d, act, max_steps, use_full):
    res = jax_trace(jp, jnp.asarray(o), jnp.asarray(d), max_steps=max_steps,
                    active=jnp.asarray(act), compact=False,
                    use_full=use_full)
    return {k: np.asarray(getattr(res, k)) for k in OUTPUTS}


def _assert_trace_equal(res, ref, what):
    for k in OUTPUTS:
        np.testing.assert_array_equal(getattr(res, k).numpy(), ref[k],
                                      err_msg=f"{what}: {k}")


# ---- the builder ---------------------------------------------------------

@pytest.mark.parametrize("world", ["random16", "terrain64"])
def test_builder_equals_jax(world, small_world):
    """rows, bases and depth of the dense build and of the build from
    chunks."""
    if world == "random16":
        occ = np.random.default_rng(1).random((16,) * 3) < 0.3
        chunks = None
    else:
        occ = small_world[2]
        chunks = [Chunk(np.array(c.position), c.voxels.copy())
                  for c in small_world[1]]
    jp = jax_build_pyramid(occ)
    pyr = build_brick_pyramid(occ, "cpu")
    assert pyr.depth == jp.depth and pyr.size == jp.size
    assert pyr.bases == jp.bases
    np.testing.assert_array_equal(pyr.rows.numpy(),
                                  np.asarray(jp.rows).view(np.int32))
    conv = convert.pyramid_from_numpy(np.asarray(jp.rows), jp.size, "cpu")
    assert torch.equal(conv.rows, pyr.rows)
    if chunks is not None:
        assert torch.equal(brick_pyramid_from_chunks(chunks, 64, "cpu").rows,
                           pyr.rows)


def test_solid_equals_jax(small_world):
    occ = small_world[2]
    jp, pyr = _pair(occ)
    v = np.random.default_rng(2).integers(0, 64, (4000, 3))
    got = pyramid_voxel_solid(pyr, torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_pyramid_voxel_solid(jp, jnp.asarray(v))))
    np.testing.assert_array_equal(got, occ[v[:, 2], v[:, 1], v[:, 0]])
    assert torch.equal(tracer.solid(pyr, torch.from_numpy(v)),
                       torch.from_numpy(got))


# ---- the HDDA ------------------------------------------------------------

@pytest.mark.parametrize("use_full", [True, False], ids=["full", "any"])
@pytest.mark.parametrize("case", CASES)
def test_hdda_equals_jax(case, use_full, small_world):
    occ, o, d, act = _case(case, small_world)
    jp, pyr = _pair(occ)
    ref = _jax_trace(jp, o, d, act, 512, use_full)
    res = trace_pyramid_plain(pyr, torch.from_numpy(o), torch.from_numpy(d),
                              512, torch.from_numpy(act), use_full=use_full)
    _assert_trace_equal(res, ref, case)
    # the oracle, but on the rays from half-voxel planes, whose exact
    # crossing ties (ROADMAP C8) each walk may take its own way
    keep = slice(256 if case.startswith("terrain") else 0, None)
    dense = trace_dense(occ, o[keep], d[keep])
    hit = dense["hit"] & act[keep]
    np.testing.assert_array_equal(res.hit.numpy()[keep], hit)
    for k in ("face", "axis_coord"):
        np.testing.assert_array_equal(getattr(res, k).numpy()[keep][hit],
                                      dense[k][hit], err_msg=k)
    if case == "active_mask":
        np.testing.assert_array_equal(res.hit.numpy(), act)
    if case == "full_region" and use_full:
        assert res.iterations.numpy()[hit].mean() < 60


@pytest.mark.parametrize("use_full", [True, False], ids=["full", "any"])
def test_hdda_cap_equals_jax(use_full, small_world):
    """A cap of 7 steps ends most rays early: the capped rays' outputs
    (a miss, the last face, the counters at the cap) equal JAX's."""
    occ, o, d, act = _case("terrain", small_world)
    jp, pyr = _pair(occ)
    ref = _jax_trace(jp, o, d, act, 7, use_full)
    res = trace_pyramid_plain(pyr, torch.from_numpy(o), torch.from_numpy(d),
                              7, torch.from_numpy(act), use_full=use_full)
    _assert_trace_equal(res, ref, "cap 7")
    assert (ref["iterations"] == 7).mean() > 0.2


def test_hdda_t0_rule_c18():
    """ROADMAP C18 (copied): a ray that starts on a voxel face and steps
    into its solid neighbour at t = 0 gets the origin's cell, as in JAX
    `trace`; the oracle (and the jump grid's DDA) the entered cell."""
    occ = np.zeros((64,) * 3, bool)
    occ[10, 10, 39] = True
    o, d, act = _pad(np.array([[40.0, 10.5, 10.5]]),
                     np.array([[-1.0, 0.01, 0.0]]))
    jp, pyr = _pair(occ)
    ref = _jax_trace(jp, o, d, act, 512, False)
    res = trace_pyramid_plain(pyr, torch.from_numpy(o), torch.from_numpy(d),
                              512, torch.from_numpy(act), use_full=False)
    _assert_trace_equal(res, ref, "C18")
    assert bool(res.hit[0]) and float(res.t[0]) == 0.0
    assert int(res.axis_coord[0]) == 40
    assert int(trace_dense(occ, o[:1], d[:1])["axis_coord"][0]) == 39
    jump = build_jump_grid(occ, "cpu")
    assert int(tracer.trace_plain(jump, torch.from_numpy(o[:1]),
                                  torch.from_numpy(d[:1])).axis_coord[0]) \
        == 39


def test_trace_dispatch(small_world):
    """On the CPU `trace_pyramid` is its plain version, without the
    counters when asked, and the frame's tracer walks the any masks."""
    occ, o, d, _ = _case("terrain", small_world)
    pyr = build_brick_pyramid(occ, "cpu")
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    a = trace_pyramid(pyr, o, d, 256, width=32, stats=False)
    b = trace_pyramid_plain(pyr, o, d, 256)
    assert a.iterations is None and torch.equal(a.t, b.t)
    c = tracer.trace(pyr, o, d, 256)
    ref = trace_pyramid_plain(pyr, o, d, 256, use_full=False)
    _assert_trace_equal(c, {k: getattr(ref, k).numpy() for k in OUTPUTS},
                        "dispatch")
    assert tracer.step_cap(pyr, 256) == 256
    assert tracer.step_cap(build_jump_grid(occ, "cpu"), 256) == 2048
    assert not tracer.near_walk(pyr)
    assert tracer.kernel_args("soft_shadow", pyr)[0] == "soft_shadow_pyramid"


@pytest.mark.parametrize("flat,pyramid", [
    ("jump_trace", "pyramid_trace"),
    ("masked_shadow", "masked_shadow_pyramid"),
    ("soft_shadow", "soft_shadow_pyramid"),
    ("shade_bounce", "shade_bounce_pyramid")])
def test_the_pyramid_entries_port_the_hdda(flat, pyramid):
    """K19 and the pyramid forms of K12, K14 and K15 port the JAX HDDA
    (vvr_tpu/ops/traverse.py:406) and take their jump-grid entry's
    arguments with the grid's (rows, size) replaced by (rows, size,
    depth), K19 with its FULL flag, from the same source."""
    f, p = kernels.KERNELS[flat], kernels.KERNELS[pyramid]
    assert "vvr_tpu/ops/traverse.py:406" in p.replaces
    assert p.path == "frame" and p.source == f.source
    P, I = ctypes.c_void_p, ctypes.c_int
    assert f.argtypes[:2] == (P, I)
    extra = (I,) if pyramid == "pyramid_trace" else ()
    assert p.argtypes == (P, I, I) + extra + f.argtypes[2:]


def _invariant_breaks(pyr) -> int:
    """The nodes below the root whose any mask is non-zero where their
    bit in the parent's any mask is 0, or zero where it is set: the
    invariant a walk would trust to answer a fetch from the masks of the
    nodes it descended through."""
    rows = pyr.rows.numpy().astype(np.int64) & 0xFFFFFFFF
    any_ = rows[:, 0] | (rows[:, 1] << 32)
    breaks = 0
    for lv in range(1, pyr.depth):
        g = pyr.size >> (2 * lv)
        z, y, x = np.meshgrid(*(np.arange(g),) * 3, indexing="ij")
        child = any_[pyr.bases[lv]:pyr.bases[lv] + g ** 3].reshape(g, g, g)
        gp = g >> 2
        parent = any_[pyr.bases[lv + 1] + (x >> 2) + (y >> 2) * gp
                      + (z >> 2) * gp * gp]
        bit = (x & 3) | ((y & 3) << 2) | ((z & 3) << 4)
        breaks += int(((child != 0) != (((parent >> bit) & 1) == 1)).sum())
    return breaks


@pytest.mark.parametrize("world", ["terrain", "added", "added and removed"])
def test_pyramid_parent_bits(world, small_world):
    """A node's any mask is non-zero exactly when its parent's bit for it
    is set: on a fresh build of the 64^3 world, after WorldEditor adds
    balls (in the air, at the corner, in the terrain) and after it removes
    them again (world/edit.py `_patch_pyramid`), which empties nodes whose
    parents must clear their bits."""
    chunks = [Chunk(np.array(c.position), c.voxels.copy())
              for c in small_world[1]]
    ed = WorldEditor(chunks, pyramid=build_brick_pyramid(small_world[2],
                                                         "cpu"),
                     device="cpu")
    balls = [_ball(c) for c in ((31, 30, 32), (63, 0, 15), (16, 12, 47))]
    if world != "terrain":
        for b in balls:
            assert ed.set_voxels(b, True) > 0
    if world == "added and removed":
        for b in balls:
            assert ed.set_voxels(b, False) > 0
        assert not ed.occupancy()[30, 31, 31]
    assert _invariant_breaks(ed.pyramid) == 0
    assert torch.equal(ed.pyramid.rows,
                       build_brick_pyramid(ed.occupancy(), "cpu").rows)


def _frame_rays(small_world, shadow):
    """1024 of the TERRAIN view's 96x64 primary rays, or the shadow rays
    from their hits along SUN (the frame's starts, ops/shade.py)."""
    from vvr_tpu_torch.ops.shade import shade_surface
    o, d = camera_rays(TERRAIN, 96, 64, "cpu")
    o, d = o[::6][:N].contiguous(), d[::6][:N].contiguous()
    if not shadow:
        return o, d, torch.ones(N, dtype=torch.bool)
    pyr = build_brick_pyramid(small_world[2], "cpu")
    r = trace_pyramid_plain(pyr, o, d, 512, use_full=False)
    so, sa = shade_surface(o, d, r.hit, r.face, r.axis_coord,
                           torch.from_numpy(SUN[:3]))
    return so, torch.from_numpy(SUN[:3]).expand(N, 3).contiguous(), sa


@pytest.mark.parametrize("use_full", [True, False], ids=["full", "any"])
@pytest.mark.parametrize("rays", ["primary", "shadow"])
def test_answered_fetches(rays, use_full, small_world):
    """The plain walk's count of the fetches the masks a ray holds answer
    (`answered`): on the frame's primary and shadow rays of the 64^3
    world each answered row is all zero or the root, the root is
    answered once a ray, some all-zero rows are answered too, and the
    seven outputs stay equal to JAX `trace`'s."""
    occ = small_world[2]
    o, d, act = _frame_rays(small_world, rays == "shadow")
    jp, pyr = _pair(occ)
    answered = (torch.zeros(pyr.rows.shape[0], dtype=torch.int64),)
    res = trace_pyramid_plain(pyr, o, d, 512, act, use_full=use_full,
                              answered=answered)
    ref = _jax_trace(jp, o.numpy(), d.numpy(), act.numpy(), 512, use_full)
    _assert_trace_equal(res, ref, rays)
    count = answered[0]
    root = pyr.bases[pyr.depth]
    rows = torch.nonzero(count)[:, 0]
    empty = (pyr.rows[rows, 0] == 0) & (pyr.rows[rows, 1] == 0)
    assert bool((empty | (rows == root)).all())
    assert int(count[root]) == int(act.sum())
    assert int(count.sum()) - int(count[root]) > 0
    assert int(count.sum()) < int(res.fetches.sum())


# ---- overlap AO ----------------------------------------------------------

@pytest.fixture(scope="module")
def ov_scene():
    """tests/test_overlap.py's 16^3 scene, positions in and around it
    (half of them on half-voxel planes), axes and unit normals."""
    occ = np.random.default_rng(7).random((16, 16, 16)) < 0.3
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.0, 17.0, (512, 3)).astype(np.float32)
    pos[:256] = np.round(pos[:256] * 2) / 2
    axis = rng.integers(0, 3, 512)
    normal = np.zeros((512, 3), np.float32)
    normal[np.arange(512), axis] = rng.choice([-1.0, 1.0], 512)
    return occ, *_pair(occ), pos, axis, normal


@pytest.mark.parametrize("half", [0.8, 1.5, 2.4])
def test_cube_density_equals_jax(half, ov_scene):
    """At half 0.8 against the jitted JAX function; at 1.5 and 2.4 (whose
    jits take half a minute and minutes to compile) the sum against the
    JAX function run op by op, which divides it by the volume, and the
    density the sum times the scale the jit uses (held at 0.8 here and
    in the planar tests)."""
    occ, jp, pyr, pos, _, _ = ov_scene
    got = overlap.cube_overlap_density(pyr, torch.from_numpy(pos), half)
    if half < 1.0:
        ref = jax_overlap.cube_overlap_density(jp, jnp.asarray(pos), half)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        return
    k = overlap.reach(half)
    rng = range(-k, k + 1)
    offs = (torch.tensor([x, y, z], dtype=torch.float32).expand(512, 3)
            for x in rng for y in rng for z in rng)
    s = overlap._density(pyr, torch.from_numpy(pos), half, offs)
    ref = jax_overlap.cube_overlap_density.__wrapped__(jp, jnp.asarray(pos),
                                                       half)
    np.testing.assert_array_equal((s / np.float32((half * 2.0) ** 3)).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), (s * overlap.box_scale(half, False)).numpy())


@pytest.mark.parametrize("half", [0.8, 2.4])
def test_planar_density_equals_jax(half, ov_scene):
    occ, jp, pyr, pos, axis, _ = ov_scene
    got = overlap.planar_overlap_density(pyr, torch.from_numpy(pos), half,
                                         torch.from_numpy(axis))
    ref = jax_overlap.planar_overlap_density(jp, jnp.asarray(pos), half,
                                             jnp.asarray(axis, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_overlap_ao_equals_jax(ov_scene):
    """overlap_ao against the jitted JAX function, and the same AO and
    densities read through the jump grid's voxels."""
    occ, jp, pyr, pos, axis, normal = ov_scene
    args = [torch.from_numpy(a) for a in (pos, normal, axis)]
    got = overlap.overlap_ao(pyr, *args)
    ref = JAX_AO(jp, jnp.asarray(pos), jnp.asarray(normal),
                 jnp.asarray(axis, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ((got > 0) & (got < 1)).any()
    grid = build_jump_grid(np.pad(occ, ((0, 48),) * 3), "cpu")
    small = build_brick_pyramid(occ, "cpu")
    inside = torch.from_numpy(np.clip(pos, 0.0, 15.99))
    for fn, a in ((overlap.overlap_ao, (args[1], args[2])),
                  (overlap.cube_overlap_density, (1.5,)),
                  (overlap.planar_overlap_density, (2.4, args[2]))):
        # the padded jump grid's voxels inside the 16^3 scene are its own
        assert torch.equal(fn(grid, inside, *a), fn(small, inside, *a))
    assert torch.equal(overlap.cube_overlap_density_svo(pyr, args[0], 1.5),
                       overlap.cube_overlap_density(pyr, args[0], 1.5))


# ---- frames --------------------------------------------------------------

def _views():
    cams = {"terrain": TERRAIN,
            "sky": Camera.look_at([32, 40, 32], [32, 80, 90], fov=100)}
    for i, s in enumerate(load_snapshots()[:2]):
        cam = Camera.from_snapshot(s)
        cam.position = cam.position * (64 / 1024.0)
        cams[f"snap{i}"] = cam
    return cams


@pytest.fixture(scope="module")
def grids(small_world):
    """The 64^3 world's pyramids and jump grids, both packages'."""
    occ = small_world[2]
    jp, pyr = _pair(occ)
    jg = jax_build_jump_grid(occ)
    return jp, pyr, jg, convert.jumpgrid_from_numpy(np.asarray(jg.rows), 64,
                                                    "cpu")


@pytest.mark.parametrize("view", ["terrain", "sky", "snap0", "snap1"])
def test_pyramid_frame_goldens(view, grids):
    """The goldens are JAX pyramid frames: their bar; and the port's jump
    grid frame, byte for byte (tests/test_render.py
    test_jump_traversal_frame_matches_pyramid)."""
    o, d = camera_rays(_views()[view], 96, 64, "cpu")
    cfg = RenderConfig(**{**SLICE, "traversal": "pyramid"})
    img, hdr = render_frame(grids[1], o, d, SUN, 0.0, cfg)
    golden = np.load(GOLDEN_DIR / f"{view}.npy")
    diff = np.abs(img.numpy().astype(int) - golden.astype(int))
    assert (diff > 2).mean() < 0.005, f"{view}: {(diff > 2).mean():.4%}"
    img_j, hdr_j = render_frame(grids[3], o, d, SUN, 0.0,
                                RenderConfig(**SLICE))
    assert torch.equal(img, img_j) and torch.equal(hdr, hdr_j)


def _sky():
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    return (jnp.asarray(sb), jnp.asarray(cl)), convert.sky_from_numpy(
        sb, cl, "cpu")


def _both_frames(jgrid, grid, knobs, **jax_kw):
    """(JAX (img, hdr), port (img, hdr)) at 64x48 (under the 4096 rays
    where the JAX tracer's compaction cascade engages), the same rays
    and seeded sky textures."""
    cfg = {**SLICE, "width": 64, "height": 48, **knobs}
    jo, jd = jax_camera_rays(JaxCamera(TERRAIN.position, TERRAIN.rotation,
                                       TERRAIN.fov), 64, 48)
    jsky, sky = _sky()
    ref = jax_render_frame(jgrid, jo, jd, jnp.asarray(SUN), jnp.float32(0.0),
                           JaxRenderConfig(**cfg), sky=jsky, **jax_kw)
    got = render_frame(grid, torch.from_numpy(np.array(jo)),
                       torch.from_numpy(np.array(jd)), SUN, 0.0,
                       RenderConfig(**cfg), sky=sky)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize("grid", ["pyramid", "jump"])
def test_normals_heatmap_frame_equals_jax(grid, grids):
    """debug_type 3 on each grid: the u8 frames equal (misses show their
    trace's last face, which differs between the grids' walks)."""
    jp, pyr, jg, g = grids
    pair = (jp, pyr) if grid == "pyramid" else (jg, g)
    knobs = {"debug_type": 3, "traversal": grid}
    (ref_img, ref_hdr), (img, hdr) = _both_frames(*pair, knobs)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(hdr, ref_hdr)


def test_overlap_ao_frame_equals_jax(grids):
    """ao_mode "overlap" on the jump grid: the JAX frame reads a pyramid
    of the same world (`overlap_pyr`), the port the jump grid's voxels
    inside K15's plain version; the bar of the JAX package's own frame
    comparisons (HDR rtol=atol=4e-6, u8 within one step)."""
    jp, pyr, jg, g = grids
    knobs = {"ambient_occlusion": True, "ao_mode": "overlap"}
    (ref_img, ref_hdr), (img, hdr) = _both_frames(jg, g, knobs,
                                                  overlap_pyr=jp)
    np.testing.assert_allclose(hdr, ref_hdr, rtol=4e-6, atol=4e-6)
    assert np.abs(img.astype(int) - ref_img.astype(int)).max() <= 1
    plain = render_frame(g, *camera_rays(TERRAIN, 64, 48, "cpu"), SUN, 0.0,
                         RenderConfig(**{**SLICE, "width": 64, "height": 48,
                                         **knobs}), sky=_sky()[1])[1]
    ref_no = render_frame(g, *camera_rays(TERRAIN, 64, 48, "cpu"), SUN, 0.0,
                          RenderConfig(**{**SLICE, "width": 64,
                                          "height": 48}), sky=_sky()[1])[1]
    assert (plain[..., :3] < ref_no[..., :3]).any()   # the AO darkens


def test_paged_grid_overlap_ao_and_heatmaps(grids, small_world):
    """ao_mode "overlap" and the heatmaps on the paged grid too: the
    overlap AO frame equals the jump grid's byte for byte (the same
    voxels, the same DDA answers), and a heatmap frame's normals and
    world image equal the jump grid's on every hit pixel (a miss shows
    its walk's last face, which the grids do not share)."""
    pgrid = build_paged_grid(small_world[2], "cpu")
    o, d = camera_rays(TERRAIN, 96, 64, "cpu")
    ao = {"ambient_occlusion": True, "ao_mode": "overlap"}
    a = render_frame(pgrid, o, d, SUN, 0.0,
                     RenderConfig(**{**SLICE, **ao, "traversal": "paged"}))
    b = render_frame(grids[3], o, d, SUN, 0.0, RenderConfig(**SLICE, **ao))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for dt in (3, 4):
        _, hp = render_frame(pgrid, o, d, SUN, 0.0, RenderConfig(
            **{**SLICE, "debug_type": dt, "traversal": "paged"}))
        _, hj = render_frame(grids[3], o, d, SUN, 0.0,
                             RenderConfig(**{**SLICE, "debug_type": dt}))
        hit = hj[..., 3] == 0
        assert torch.equal(hp[..., 3], hj[..., 3]) and hit.any()
        assert torch.equal(hp[hit], hj[hit])


def test_debug_images_equal_jax(grids):
    """The plain debug_image of types 1-5 against JAX `_debug_image` on
    the same trace of the terrain view, and on made-up miss lanes whose
    reconstructed point is far outside the int32 range."""
    jp, pyr = grids[:2]
    o, d = camera_rays(TERRAIN, 64, 48, "cpu")
    res = trace_pyramid_plain(pyr, o, d, 256, use_full=False)
    face, ac = res.face.clone(), res.axis_coord.clone()
    d = d.clone()
    d[:8] = torch.tensor([1e-13, 1.0, 0.0])
    d[8:16] = torch.tensor([-1e-13, -1.0, 0.0])
    face[:16], ac[:16] = 0, 0
    dbg = _jax_debug_record(o.numpy(), d.numpy(), face.numpy(), ac.numpy(),
                            res)
    for dt in (1, 2, 3, 4, 5):
        cfg = JaxRenderConfig(width=64, height=48, debug_type=dt)
        ref = np.asarray(jax_debug_image(dbg, cfg, 48, 64, 64))
        out = torch.zeros((4, 48, 64))
        counter = (getattr(res, debug_ops.HEATMAPS[dt][0])
                   if debug_ops.needs_stats(dt) else None)
        debug_ops.debug_image(o, d, face, ac, counter, dt, out)
        np.testing.assert_array_equal(out[:3].permute(1, 2, 0).numpy(), ref,
                                      err_msg=f"debug_type {dt}")
        assert not out[3].any()
    with pytest.raises(ValueError, match="iterations"):
        debug_ops.debug_image(o, d, face, ac, None, 1, out)


def _jax_debug_record(o, d, face, ac, res):
    """Bounce 0's record as the JAX frame forms it (frame.py:192-255)."""
    o, d, face, ac = (jnp.asarray(a) for a in (o, d, face, ac))
    sg = [jnp.where(d[:, i] >= 0, 1.0, -1.0) for i in range(3)]
    normal = [jnp.where(face == i, -sg[i], 0.0) for i in range(3)]

    def sel(x, y, z):
        return jnp.where(face == 0, x, jnp.where(face == 1, y, z))

    plane = ac.astype(jnp.float32) + jnp.where(sel(*sg) < 0, 1.0, 0.0)
    df = sel(d[:, 0], d[:, 1], d[:, 2])
    dist = (plane - sel(o[:, 0], o[:, 1], o[:, 2])) / jnp.where(
        jnp.abs(df) < 1e-12, 1e-12, df)
    world = [jnp.where(face == i, plane, o[:, i] + d[:, i] * dist)
             for i in range(3)]
    block = [jnp.where(face == i, ac, jnp.floor(world[i]).astype(jnp.int32))
             for i in range(3)]
    return dict(iterations=jnp.asarray(res.iterations.numpy()),
                fetches=jnp.asarray(res.fetches.numpy()),
                missed_pops=jnp.asarray(res.missed_pops.numpy()),
                normal_soa=tuple(normal), block_soa=tuple(block))


# ---- edits ---------------------------------------------------------------

def _ball(center, r=3):
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1].reshape(3, -1).T
    return np.asarray(center, np.int64)[None] + g[(g ** 2).sum(1) <= r * r]


# a ball in the air, a dent in the terrain, a ball clipped by the world's
# corner, a dent under the view
EDITS = [((31, 30, 32), True), ((16, 12, 47), False), ((63, 0, 15), True),
         ((32, 13, 30), False)]


def test_edits_equal_jax_editor():
    """Balls added and removed across node and chunk boundaries of a
    256^3 world of 64^3 chunks (a slab with noise on it) and at its
    corner: the patched rows equal the JAX editor's after every edit, and
    a fresh build's."""
    from vvr_tpu.world.chunk import Chunk as JaxChunk
    rng = np.random.default_rng(4)
    occ = np.zeros((256,) * 3, bool)
    occ[:, :60] = True
    occ[:, 60:70] = rng.random((256, 10, 256)) < 0.3
    pos = [(x, y, z) for z in range(4) for y in range(2) for x in range(4)]
    vox = [occ[z * 64:z * 64 + 64, y * 64:y * 64 + 64, x * 64:x * 64 + 64]
           for x, y, z in pos]
    jed = JaxWorldEditor([JaxChunk(np.array(p), v.copy())
                          for p, v in zip(pos, vox)], jax_build_pyramid(occ))
    ed = WorldEditor([Chunk(np.array(p), v.copy()) for p, v in zip(pos, vox)],
                     pyramid=build_brick_pyramid(occ, "cpu"), device="cpu")
    assert ed.size == 256
    for center, solid in [((64, 68, 128), False), ((127, 64, 191), True),
                          ((128, 130, 64), True), ((255, 70, 0), False),
                          ((64, 68, 128), True)]:
        jed.set_voxels(_ball(center), solid)
        assert ed.set_voxels(_ball(center), solid) > 0
        np.testing.assert_array_equal(ed.pyramid.rows.numpy(),
                                      np.asarray(jed.pyramid.rows).view(
                                          np.int32))
    fresh = build_brick_pyramid(ed.occupancy(), "cpu")
    assert torch.equal(fresh.rows, ed.pyramid.rows)
    assert len(ed.chunks) == len(jed.chunks) == 36
    assert "pyramid_ms" in ed.last_timings


def test_frame_after_edit_equals_fresh_scene(small_world):
    """Renderer.apply_edits on the pyramid: the frame equals a Renderer's
    on a fresh scene of the edited world."""
    chunks = [Chunk(np.array(c.position), c.voxels.copy())
              for c in small_world[1]]
    cfg = RenderConfig(**{**SLICE, "traversal": "pyramid"})
    scene = Scene(WorldConfig(depth=3), chunks, device="cpu")
    ed = WorldEditor(chunks, pyramid=scene.ensure_pyramid(), device="cpu")
    r = Renderer(WorldConfig(depth=3), cfg, device="cpu", scene=scene)
    before = r.render(TERRAIN, time=0.0, fetch=True)
    for center, solid in EDITS[:2]:
        r.apply_edits(ed, _ball(center), solid)
    assert r.scene.pyramid is ed.pyramid and r.scene.epoch == 2
    after = r.render(TERRAIN, time=0.0, fetch=True)
    fresh = Scene(WorldConfig(depth=3), [
        Chunk(np.array(c.position), c.voxels.copy()) for c in chunks],
        device="cpu")
    ref = Renderer(WorldConfig(depth=3), cfg, device="cpu",
                   scene=fresh).render(TERRAIN, time=0.0, fetch=True)
    np.testing.assert_array_equal(after, ref)
    assert (after != before).any()


def test_stale_overlap_pyramid_c17(small_world):
    """ROADMAP C17: on the jump grid the JAX renderer's overlap AO reads
    the scene's pyramid (`ensure_pyramid`), which an editor without one
    leaves stale; the port's reads the patched grid. Beside a ball added
    in the air the JAX AO is the pre-edit world's, the port's a fresh
    build's."""
    occ = small_world[2]
    jed = JaxWorldEditor(copy.deepcopy(list(small_world[1])), None, size=64)
    jed.attach_jump_grid(jax_build_jump_grid(occ))
    stale = jax_build_pyramid(occ)          # the JAX scene's pyramid
    chunks = [Chunk(np.array(c.position), c.voxels.copy())
              for c in small_world[1]]
    ed = WorldEditor(chunks, size=64, device="cpu")
    grid = ed.attach_jump_grid(build_jump_grid(occ, "cpu"))
    center = np.array([31, 30, 32])
    jed.set_voxels(_ball(center), True)
    ed.set_voxels(_ball(center), True)
    assert jed.pyramid is None
    fresh = jax_build_pyramid(jed.occupancy())
    # surface points five voxels off the ball, facing it: the planes at
    # 0.5 and 2.5 along the normal, the second through the ball
    normal = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]],
                      np.float32)
    pos = (center[None] - 5.0 * normal + 0.5 * (normal == 0)).astype(
        np.float32)
    face = np.array([0, 1, 2, 0], np.int32)
    # 512 lanes, the shape test_overlap_ao_equals_jax compiles
    pos, normal, face = (np.tile(a, (128,) + (1,) * (a.ndim - 1))
                         for a in (pos, normal, face))
    args = (jnp.asarray(pos), jnp.asarray(normal), jnp.asarray(face))
    jax_stale = np.asarray(JAX_AO(stale, *args))
    jax_fresh = np.asarray(JAX_AO(fresh, *args))
    port = overlap.overlap_ao(grid, torch.from_numpy(pos),
                              torch.from_numpy(normal),
                              torch.from_numpy(face)).numpy()
    np.testing.assert_array_equal(port, jax_fresh)
    assert (jax_stale != jax_fresh).all()
