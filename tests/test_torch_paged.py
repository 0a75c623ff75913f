"""The paged two-level grid and its DDA (K16): the port's builder and plain
tracer held to the JAX package's `build_paged_grid` and `trace_paged`, and
the port's frames on the paged grid to its frames on the jump grid.

- The builder: page table and pool bit for bit, on the 64^3 world, a
  sparse random world and a 48^3 world whose tables pad to 64.
- The tracer: all seven outputs (hit, face, axis_coord, t, iterations,
  fetches, missed_pops) equal to JAX `trace_paged(..., compact=False)` on
  3000 rays a case (under the 4096 where the JAX cascade engages; the
  cascade repacks a lane with both rows to re-fetch, one more iteration),
  and (hit, face, axis_coord, t) on the hits equal to the port's numpy
  oracle; at caps 1..24 through one JAX compile with a cap per ray.
- Frames: the paged DDA frame at the golden view meets
  tests/golden/paged.npy's bar (under 0.5% of pixels off by more than 2)
  and equals the port's jump-grid frame byte for byte; at 64x48 its HDR
  meets JAX `render_frame` on JAX's paged grid as the jump frame does
  (tests/test_torch_frame.py::test_terrain_hdr_equals_jax: alpha exact,
  rgb within rtol = atol = 1e-4 on 99.5% of pixels; 64x48 keeps the JAX
  frame under its cascade, whose compile costs about a minute of CPU).
  Through `Renderer`, traversal "paged" renders the default-knob frame
  (K12's residue without the near walk), the soft cone frame (K14's gate
  without it), config 4 and the lights frame byte for byte as "jump".
- `RenderConfig.use_paged` and `use_jump` resolve as the JAX package's.

Tolerance: none but the HDR bar above. The tracers compute the same IEEE
expressions in the same order and count the same events.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.ops import paged as jax_paged
from vvr_tpu.ops.paged import trace_paged as jax_trace_paged
from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.ops.traverse import _run_groups as jax_run_groups
from vvr_tpu.render.frame import render_frame as jax_render_frame
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.world.paged import build_paged_grid as jax_build_paged_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops.paged import (solid_plain, trace_paged,
                                     trace_paged_plain)
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.trace import tensors, trace, trace_plain
from vvr_tpu_torch.render.frame import render_frame
from vvr_tpu_torch.render.oracle import trace_dense
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.jumpgrid import build_jump_grid
from vvr_tpu_torch.world.paged import build_paged_grid, build_paged_rows

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

N = 3000
FIELDS = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
          "missed_pops")
GOLDEN = pathlib.Path(__file__).parent / "golden" / "paged.npy"
SUN = np.array([-0.28, 0.65, -0.71], np.float32)
SUN = np.concatenate([SUN / np.linalg.norm(SUN), [0.0]]).astype(np.float32)
VIEW = Camera.look_at([32, 28, 6], [32, 2, 45], fov=85)  # test_render.py
DDA = dict(width=96, height=64, shadow_samples=1, max_ray_iterations=2,
           skybox_resolution=32, clouds_resolution=32, primary_raster="off",
           sun_mask="off")


def _worlds(occ):
    return {"terrain": occ,
            "sparse": np.random.default_rng(4).random((64, 64, 64)) < 0.01,
            "pad48": occ[:48, :48, :48],
            "empty": np.zeros((64, 64, 64), bool),
            "far_corner": _corner()}


def _corner():
    """An empty world but its first 8^3 block: rays from the far corner
    jump across empty pages and walk empty superbricks."""
    occ = np.zeros((64, 64, 64), bool)
    occ[0:8, 0:8, 0:8] = True
    return occ


@pytest.mark.parametrize("name", ["terrain", "sparse", "pad48"])
def test_build_equals_jax(name, small_world):
    occ = _worlds(small_world[2])[name]
    ref = _jax_grid(name, occ)
    prows, brows = build_paged_rows(occ)
    np.testing.assert_array_equal(prows, np.asarray(ref.prows))
    np.testing.assert_array_equal(brows, np.asarray(ref.brows))
    grid = build_paged_grid(torch.from_numpy(occ), "cpu")
    assert grid.size == occ.shape[0] == ref.size
    assert grid.psize == ref.psize and grid.gsize == ref.gsize
    assert grid.memory_bytes() == ref.memory_bytes()
    assert grid.prows.dtype == torch.int32


def _rays(rng, n, size, inside=True):
    lo, hi = (0.5, size - 0.5) if inside else (-size, 2 * size)
    o = rng.uniform(lo, hi, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


_JAX_GRIDS = {}


def _jax_grid(name, occ):
    """JAX `build_paged_grid` of world `name` of _worlds, built once."""
    if name not in _JAX_GRIDS:
        _JAX_GRIDS[name] = jax_build_paged_grid(occ)
    return _JAX_GRIDS[name]


def _case(name, occ_world):
    """(world name, occ, o, d, active) of one corpus case, N rays."""
    rng = np.random.default_rng(200 + CASES.index(name))
    worlds = _worlds(occ_world)
    act = np.ones(N, bool)
    world = "terrain"
    if name == "inside":
        o, d = _rays(rng, N, 64)
    elif name == "outside_origins":
        o, d = _rays(rng, N, 64, inside=False)
    elif name == "axis_aligned":
        o = rng.uniform(0.25, 63.75, size=(N, 3)).astype(np.float32)
        o[: N // 2] = np.floor(o[: N // 2]) + 0.5
        d = np.zeros((N, 3), np.float32)
        d[np.arange(N), rng.integers(0, 3, N)] = rng.choice([-1.0, 1.0], N)
    elif name == "sparse":
        world = "sparse"
        o, d = _rays(rng, N, 64)
    elif name == "far_jump":
        world = "far_corner"
        o = rng.uniform(40, 63, size=(N, 3)).astype(np.float32)
        d = rng.uniform(0, 8, size=(N, 3)) - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        d[: N // 3] = -d[: N // 3]   # and away from it, out of the world
    elif name == "empty_world":
        world = "empty"
        o, d = _rays(rng, N, 64)
    elif name == "active_mask":
        o, d = _rays(rng, N, 64)
        act = rng.random(N) < 0.5
    elif name == "padded":
        world = "pad48"
        o, d = _rays(rng, N, 48, inside=False)
    else:
        raise ValueError(name)
    return world, worlds[world], o, d, act


CASES = ["inside", "outside_origins", "axis_aligned", "sparse", "far_jump",
         "empty_world", "active_mask", "padded"]


@pytest.mark.parametrize("name", CASES)
def test_trace_equals_jax_and_oracle(name, small_world):
    world, occ, o, d, act = _case(name, small_world[2])
    jgrid = _jax_grid(world, occ)
    ref = jax_trace_paged(jgrid, jnp.asarray(o), jnp.asarray(d),
                          max_steps=4096, active=jnp.asarray(act),
                          compact=False)
    grid = convert.paged_grid_from_numpy(np.asarray(jgrid.prows),
                                         np.asarray(jgrid.brows),
                                         occ.shape[0], "cpu")
    res = trace_paged(grid, torch.from_numpy(o), torch.from_numpy(d),
                      max_steps=4096, active=torch.from_numpy(act))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{name}: {f}")
    dense = trace_dense(occ, o, d)
    hit = res.hit.numpy()
    np.testing.assert_array_equal(hit, dense["hit"] & act)
    for f in ("face", "axis_coord", "t"):
        np.testing.assert_array_equal(getattr(res, f).numpy()[hit],
                                      dense[f][hit], err_msg=f"{name}: {f}")
    if name == "far_jump":   # the rays away from the block leave at once
        assert hit.any() and (res.iterations.numpy()[~hit] == 1).any()


CAPS = np.arange(1, 25)


@pytest.fixture(scope="module")
def cap_sweep(small_world):
    """The inside case's first N / 24 rays traced by JAX at each cap in
    CAPS in one call: the JAX stepper (compaction off, as `trace_paged`
    runs it) compares each ray's count with `max_steps`, so a cap per ray
    runs every cap through one compile."""
    world, occ, o, d, _ = _case("inside", small_world[2])
    m = N // len(CAPS)
    o, d = np.tile(o[:m], (len(CAPS), 1)), np.tile(d[:m], (len(CAPS), 1))
    caps = np.repeat(CAPS, m).astype(np.int32)
    jgrid = _jax_grid(world, occ)

    @jax.jit
    def run(grid, o, d, caps):
        ray = jax_paged._make_ray(o, d)
        ox, oy, oz = ray[:3]
        size = grid.size
        inside = ((ox >= 0) & (ox < size) & (oy >= 0) & (oy < size)
                  & (oz >= 0) & (oz < size))
        state = jax_paged._init_state(grid, o.shape[0], inside, (ox, oy, oz))
        fetch, alu = jax_paged._make_stepper(grid, ray, caps, True)
        state = jax_run_groups(fetch, alu, state, None,
                               jax_paged.FETCH_EVERY)
        return jax_paged._outputs(state, ray, size)

    ref = run(jgrid, jnp.asarray(o), jnp.asarray(d), jnp.asarray(caps))
    grid = build_paged_grid(occ, "cpu")
    return grid, o[:m], d[:m], {
        f: np.asarray(getattr(ref, f)).reshape(len(CAPS), m) for f in FIELDS}


@pytest.mark.parametrize("cap", [1, 2, 3, 5, 8, 13, 24])
def test_trace_cap_sweep_equals_jax(cap, cap_sweep):
    grid, o, d, ref = cap_sweep
    res = trace_paged_plain(grid, torch.from_numpy(o), torch.from_numpy(d),
                            max_steps=cap)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      ref[f][cap - 1],
                                      err_msg=f"cap {cap}: {f}")
    assert (res.iterations.numpy() == cap).any()


def test_trace_without_counters_and_one_direction(small_world):
    """stats=False gives the same hits and no counters, the tiled width
    changes nothing, one (3,) direction equals it materialized, the
    dispatch picks the paged tracer, and a device with neither a kernel
    nor a plain path raises."""
    _, occ, o, _, act = _case("active_mask", small_world[2])
    grid = build_paged_grid(occ, "cpu")
    o, act = torch.from_numpy(o), torch.from_numpy(act)
    sun = torch.from_numpy(SUN[:3].copy())
    full = trace_paged(grid, o, sun.expand(N, 3).contiguous(), 4096, act)
    lean = trace(grid, o, sun, 4096, act, width=60, stats=False)
    for f in ("hit", "face", "axis_coord", "t"):
        assert torch.equal(getattr(lean, f), getattr(full, f)), f
    assert lean.iterations is None and lean.missed_pops is None
    plain = trace_plain(grid, o, sun, 4096, act)
    for f in FIELDS:
        assert torch.equal(getattr(plain, f), getattr(full, f)), f
    with pytest.raises(ValueError):
        trace_paged(grid, o, sun, 4096, act, width=7)
    with pytest.raises(ValueError):
        trace_paged(grid, o.to("meta"), sun.to("meta"))


@pytest.mark.parametrize("kind", ["jump", "paged"])
def test_rows_read_are_the_rows_the_rays_load(kind, small_world):
    """`rows_read` of either plain tracer (the bounds' count of the bytes a
    trace needs) marks the rows a trace loads: a straight ray never comes
    back to a page or a brick it left, so one ray marks as many rows as it
    counts fetches; a set of rays marks the union of its rays' rows; on
    the paged grid only occupied pool rows, never the zero rows that pad
    the pool."""
    build = build_paged_grid if kind == "paged" else build_jump_grid
    grid = build(small_world[2], "cpu")
    o, d = (torch.from_numpy(a) for a in
            _rays(np.random.default_rng(7), 40, 64))

    def marks():
        return tuple(torch.zeros(t.shape[0], dtype=torch.bool)
                     for t in tensors(grid))

    union, each = marks(), marks()
    trace_plain(grid, o, d, 4096, rows_read=union)
    for i in range(o.shape[0]):
        one = marks()
        res = trace_plain(grid, o[i:i + 1], d[i:i + 1], 4096, rows_read=one)
        assert sum(int(m.sum()) for m in one) == int(res.fetches[0]), i
        for a, b in zip(each, one):
            a |= b
    for a, b in zip(union, each):
        assert torch.equal(a, b)
    assert union[-1].any()
    if kind == "paged":
        assert (grid.brows[union[1]] != 0).any(1).all()


def test_solid_lookup(small_world):
    """The paged grid's voxel lookup (K12's start-in-solid test) is the
    occupancy, on every voxel of the padded world."""
    occ = small_world[2][:48, :48, :48]
    grid = build_paged_grid(occ, "cpu")
    z, y, x = np.meshgrid(*(np.arange(48),) * 3, indexing="ij")
    v = torch.from_numpy(np.stack([x, y, z], -1).reshape(-1, 3))
    np.testing.assert_array_equal(solid_plain(grid, v).numpy(),
                                  occ.reshape(-1))


def test_paged_dda_frame_meets_golden_and_equals_jump(small_world):
    """The paged DDA frame at the golden view: the golden bar, and the
    jump-grid frame byte for byte (tests/test_render.py:240 holds the
    JAX paged frame to the pyramid's the same way)."""
    occ = small_world[2]
    o, d = camera_rays(VIEW, 96, 64, "cpu")
    cfg = RenderConfig(**DDA)
    img, hdr = render_frame(build_paged_grid(occ, "cpu"), o, d, SUN, 0.0,
                            cfg)
    diff = np.abs(img.numpy().astype(int) - np.load(GOLDEN).astype(int))
    assert (diff > 2).mean() < 0.005, f"{(diff > 2).mean():.4%}"
    ref, ref_hdr = render_frame(build_jump_grid(occ, "cpu"), o, d, SUN, 0.0,
                                cfg)
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    np.testing.assert_array_equal(hdr.numpy(), ref_hdr.numpy())


def test_paged_hdr_equals_jax(small_world):
    """At 64x48 (under the JAX frame's 4096-ray cascade): the port's
    paged DDA frame against the JAX frame on the JAX paged grid, the same
    rays and seeded sky textures."""
    occ = small_world[2]
    cfg = {**DDA, "width": 64, "height": 48}
    jo, jd = jax_camera_rays(JaxCamera(VIEW.position, VIEW.rotation,
                                       VIEW.fov), 64, 48)
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    jgrid = _jax_grid("terrain", occ)
    _, ref = jax_render_frame(jgrid, jo, jd, jnp.asarray(SUN),
                              jnp.float32(0.0), JaxRenderConfig(**cfg),
                              sky=(jnp.asarray(sb), jnp.asarray(cl)))
    ref = np.asarray(ref)
    grid = convert.paged_grid_from_numpy(np.asarray(jgrid.prows),
                                         np.asarray(jgrid.brows), 64, "cpu")
    _, hdr = render_frame(grid, torch.from_numpy(np.array(jo)),
                          torch.from_numpy(np.array(jd)), SUN, 0.0,
                          RenderConfig(**cfg),
                          sky=convert.sky_from_numpy(sb, cl, "cpu"))
    hdr = hdr.numpy()
    np.testing.assert_array_equal(hdr[..., 3], ref[..., 3])
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()
    ok = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.995, f"{1 - ok.mean():.4%} of pixels differ"


# the Renderer's frames at 48x32: (knobs beside SMALL, mirror materials)
SMALL = dict(width=48, height=32, shadow_samples=1, max_ray_iterations=2,
             skybox_resolution=32, clouds_resolution=32)
RENDERER_FRAMES = [
    ("default", {}, False),
    ("soft_cone", dict(shadow_samples=4), False),
    ("config4", dict(shadow_samples=4, max_ray_iterations=4,
                     ambient_occlusion=True), True),
    ("lights", dict(max_ray_iterations=3, point_lights=True,
                    wavy_reflections=True), True),
]


@pytest.fixture(scope="module")
def shared_scene(tmp_path_factory):
    """One 64^3 scene for every Renderer below, its first ten lights set
    near the view's surface (2 units back along ten rays from their
    hits)."""
    path = tmp_path_factory.mktemp("paged") / "map_64.npz"
    r = Renderer(WorldConfig(depth=3), RenderConfig(**DDA), device="cpu",
                 cache_path=path)
    o, d = camera_rays(VIEW, SMALL["width"], SMALL["height"], "cpu")
    res = trace(r.grid, o, d, 2048)
    hits = torch.nonzero(res.hit)[:, 0]
    idx = hits[::len(hits) // 10][:10]
    r.scene.lights[:10, :3] = (o[idx] + d[idx] * (res.t[idx, None] - 2.0)
                               ).numpy()
    return r.scene


_FRAMES = {}
_SUNMASK = {}   # the Renderers' sun-grid caches, by soft shadows or not:
                # the grids depend on the faces and the sun only


def _frame(scene, traversal: str, name: str):
    """The u8 frame `name` of RENDERER_FRAMES through traversal, once."""
    if (traversal, name) in _FRAMES:
        return _FRAMES[traversal, name]
    _, knobs, mirrors = next(f for f in RENDERER_FRAMES if f[0] == name)
    cfg = RenderConfig(**{**SMALL, **knobs, "traversal": traversal})
    lights = scene.lights.copy()
    r = Renderer(WorldConfig(depth=3), cfg, device="cpu", scene=scene,
                 mirror_materials=mirrors)
    assert r.use_paged == (traversal == "paged")
    cone = cfg.shadow_samples > 1
    r._sunmask_cache = _SUNMASK.get(cone)
    img = r.render(VIEW, time=0.0, fetch=True)
    _SUNMASK[cone] = r._sunmask_cache
    scene.lights[:] = lights   # render animates them
    _FRAMES[traversal, name] = img
    return img


@pytest.mark.parametrize("name", [f[0] for f in RENDERER_FRAMES])
def test_renderer_paged_equals_jump(name, shared_scene):
    paged = _frame(shared_scene, "paged", name)
    jump = _frame(shared_scene, "jump", name)
    assert paged.shape == (32, 48, 3) and paged.std() > 10
    np.testing.assert_array_equal(paged, jump)
    assert shared_scene.paged is not None


def test_lights_change_the_frame(shared_scene):
    """The lights frame's light DDAs matter: without lights it differs."""
    with_lights = _frame(shared_scene, "paged", "lights")
    lights = shared_scene.lights.copy()
    shared_scene.lights[:10, :3] = -1000.0   # out of every pixel's reach
    try:
        r = Renderer(WorldConfig(depth=3), RenderConfig(**{
            **SMALL, "max_ray_iterations": 3, "point_lights": True,
            "wavy_reflections": True, "traversal": "paged"}),
            device="cpu", scene=shared_scene, mirror_materials=True)
        none = r.render(VIEW, time=0.0, fetch=True)
    finally:
        shared_scene.lights[:] = lights
    assert (with_lights != none).any(-1).mean() > 0.001


SIZES = (16, 64, 256, 512, 1024)


@pytest.mark.parametrize("traversal", ["auto", "jump", "paged", "pyramid",
                                       "jump2"])
def test_traversal_resolves_as_jax(traversal):
    cfg = RenderConfig(traversal=traversal)
    ref = JaxRenderConfig(traversal=traversal)
    for s in SIZES:
        assert cfg.use_jump(s) == ref.use_jump(s), s
        assert cfg.use_paged(s) == ref.use_paged(s), s
