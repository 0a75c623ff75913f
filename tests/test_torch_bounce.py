"""Mirror bounces, the filtered AO and the point lights (K15 `shade_bounce`,
the frame's bounce loop): the port's plain versions held to the JAX
package on the same seeded inputs, on the 64^3 world.

- The density field byte for byte against JAX `density_from_occupancy`,
  and its trilinear sample within 1e-6 on 10,000 seeded points, some
  outside [0, S).
- The mirror decision (hash13 of the 8^3 block group above 0.8) on every
  group of a 256^3 world against a jitted JAX `hash13_soa`, value for
  value: XLA's jit contracts the hash's sums into FMAs, and the port
  rounds where it does.
- `snoise3` within 1e-6 of the JAX version on 10,000 points; the point
  lights' colours and their animation against the JAX package's.
- Frames against a jitted JAX `raytrace_pass` (3 bounces, hard shadows,
  sun_mask "off", seeded sky textures as in
  tests/test_torch_frame.py::test_terrain_hdr_equals_jax; 64x48, under the
  4096 lanes where the JAX bounce waves compile): mirrors and AO; then
  mirrors, AO, two point lights placed near the view's surface (light 0's
  colour is black, light 1's one the JAX constant folder rounds otherwise
  than a float32 sum) and wavy reflections (2 bounces). Alpha exact, HDR within rtol = atol = 1e-4 on at least
  99.5% of pixels, each bounce's live, hit and mirror lane counts equal to
  `collect_demand`'s. The JAX frame with lights placed far from
  everything (the same compiled graph) shows that the lights change at
  least 1% of its pixels.
- The port's plain config-4 frame at tests/test_render.py:436's view and
  knobs (the cone grids, four soft samples, four bounces, AO, mirrors)
  against the committed `config4` golden: fewer than 0.5% of pixels off
  by more than 2.

Every failed assertion prints the pixels (row, column) or groups at fault.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.ops.noise import snoise3 as jax_snoise3
from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.render.frame import raytrace_pass as jax_raytrace_pass
from vvr_tpu.render.scene import Scene as JaxScene
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.utils.hash import hash13_soa as jax_hash13_soa
from vvr_tpu.utils.hash import hash33 as jax_hash33
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu.world.svt import density_from_occupancy as jax_density
from vvr_tpu.world.svt import \
    sample_density_trilinear as jax_sample_density
from vvr_tpu_torch import convert
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops.bounce import MAX_LIGHTS
from vvr_tpu_torch.ops.jump import trace_jump_plain
from vvr_tpu_torch.ops.noise import snoise3
from vvr_tpu_torch.ops.rastertrace import raster_camera
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.frame import render_frame
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.render.scene import Scene, initial_lights
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.utils.hash import hash13_soa, light_colours
from vvr_tpu_torch.world.faces import extract_merged_faces
from vvr_tpu_torch.world.svt import (density_from_occupancy,
                                     sample_density_trilinear)

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
SUN = np.array([-0.28, 0.65, -0.71], np.float32)
SUN = np.concatenate([SUN / np.linalg.norm(SUN), [0.0]]).astype(np.float32)
TERRAIN = Camera.look_at([32, 28, 6], [32, 2, 45], fov=85)
JW, JH = 64, 48   # the JAX frames
FRAME = dict(width=JW, height=JH, shadow_samples=1, max_ray_iterations=3,
             skybox_resolution=32, clouds_resolution=32,
             primary_raster="off", sun_mask="off", ambient_occlusion=True)
LIGHTS = 2   # each light's DDA compiles into every bounce of the JAX
#              frame


def _where(mask) -> list:
    """The first 20 (row, column) pixels, or indices, of a mask."""
    return np.argwhere(mask)[:20].tolist()


@pytest.fixture(scope="module")
def world(small_world):
    occ = small_world[2]
    jgrid = jax_build_jump_grid(occ)
    grid = convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64, "cpu")
    jdens = jax_density(occ)
    return occ, jgrid, grid, jdens, convert.density_from_numpy(
        np.asarray(jdens), "cpu")


@pytest.fixture(scope="module")
def sky():
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    return sb, cl


@pytest.fixture(scope="module")
def rays():
    jo, jd = jax_camera_rays(JaxCamera(TERRAIN.position, TERRAIN.rotation,
                                       TERRAIN.fov), JW, JH)
    return jo, jd


def test_density_equals_jax(world):
    occ, _, _, jdens, dens = world
    port = density_from_occupancy(occ, "cpu")
    assert port.dtype == torch.uint8
    np.testing.assert_array_equal(port.numpy(), np.asarray(jdens))
    np.testing.assert_array_equal(dens.numpy(), port.numpy())
    rng = np.random.default_rng(7)
    pts = rng.uniform(-6.0, 70.0, (10_000, 3)).astype(np.float32)
    assert ((pts < 0) | (pts >= 64)).any(1).mean() > 0.1
    ref = np.asarray(jax_sample_density(jdens, jnp.asarray(pts)))
    got = sample_density_trilinear(port, torch.from_numpy(pts)).numpy()
    bad = np.abs(got - ref) > 1e-6
    assert not bad.any(), f"points {_where(bad)} differ by " \
        f"{np.abs(got - ref).max()}"
    assert (ref > 0).any() and (ref < 1).any()


def test_mirror_decision_equals_jitted_jax():
    """hash13 of every 8^3 group of a 256^3 world, value for value, and so
    the > 0.8 mirror decision."""
    g = np.stack(np.meshgrid(*(np.arange(32, dtype=np.float32),) * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    ref = np.asarray(jax.jit(jax_hash13_soa)(
        *(jnp.asarray(g[:, k]) for k in range(3))))
    got = hash13_soa(*(torch.from_numpy(g[:, k]) for k in range(3))).numpy()
    off = got != ref
    assert not off.any(), f"groups {g[off][:20].tolist()} differ"
    mirror = got > 0.8
    assert 0.1 < mirror.mean() < 0.3


def test_snoise3_equals_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-50.0, 300.0, (10_000, 3)).astype(np.float32)
    ref = np.asarray(jax_snoise3(jnp.asarray(pts)))
    got = snoise3(torch.from_numpy(pts)).numpy()
    bad = np.abs(got - ref) > 1e-6
    assert not bad.any(), f"points {_where(bad)} differ by " \
        f"{np.abs(got - ref).max()}"
    assert np.abs(ref).max() > 0.3


def test_light_colours_equal_jitted_jax():
    """The light colours are constants in the JAX frame, which XLA folds:
    hash33(li * 3.21312) * 0.3 as a jitted copy gives them."""
    ref = np.stack([np.asarray(jax.jit(
        lambda li=li: jax_hash33(jnp.full((3,), li * 3.21312, jnp.float32))
        * 0.3)()) for li in range(MAX_LIGHTS)])
    got = light_colours(MAX_LIGHTS)
    off = (got != ref).any(1)
    assert not off.any(), f"lights {np.nonzero(off)[0].tolist()} differ"


def test_lights_animate_as_jax(world):
    """The port's scene starts its lights and moves them as the JAX
    Scene does (host NumPy in both)."""
    start = initial_lights(64)
    jscene = JaxScene(None, [], None, None, None, start.copy())
    scene = Scene(WorldConfig(depth=3), [], world[2])
    np.testing.assert_array_equal(scene.lights, start)
    for k, t in enumerate((0.0, 0.4, 3.7)):
        pos = np.array([30.0 + k, 25.0, 8.0 - k], np.float32)
        jscene.animate_lights(pos, t, 1.0 / 60.0)
        scene.animate_lights(pos, t, 1.0 / 60.0)
    np.testing.assert_array_equal(scene.lights, jscene.lights)
    assert not np.array_equal(scene.lights, start)


def _jax_frame(world, sky, rays, cfg: JaxRenderConfig, lights=None,
               mirrors: bool = True):
    """A jitted JAX raytrace_pass and its demand counts: (HDR (H, W, 4),
    {key: count})."""
    _, jgrid, _, jdens, _ = world
    fn = _jax_pass(cfg, mirrors)
    (r, g, b), alpha, dbg = fn(
        jgrid, *rays, jnp.asarray(sky[0]), jnp.asarray(sky[1]),
        jnp.asarray(SUN), jnp.float32(0.0), svt_density=jdens,
        lights=None if lights is None else jnp.asarray(lights))
    hdr = np.stack([np.asarray(c) for c in (r, g, b, alpha)], -1)
    return hdr.reshape(JH, JW, 4), {k: int(v) for k, v in
                                    dbg["demand"].items()}


@functools.cache
def _jax_pass(cfg: JaxRenderConfig, mirrors: bool):
    return jax.jit(functools.partial(jax_raytrace_pass, cfg=cfg,
                                     mirror_materials=mirrors,
                                     collect_demand=True))


def _port_frame(world, sky, rays, cfg: RenderConfig, lights=None,
                mirrors: bool = True):
    _, _, grid, _, dens = world
    demand = {}
    _, hdr = render_frame(
        grid, torch.from_numpy(np.array(rays[0])),
        torch.from_numpy(np.array(rays[1])), SUN, 0.0, cfg,
        sky=convert.sky_from_numpy(*sky, "cpu"), density=dens,
        lights=lights, mirror_materials=mirrors, demand=demand)
    return hdr.numpy(), {k: int(v) for k, v in demand.items()}


def _check_frame(hdr, counts, ref, ref_counts, bounces: int):
    off = hdr[..., 3] != ref[..., 3]
    assert not off.any(), f"alpha differs at {_where(off)}"
    ok = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4,
                    atol=1e-4).all(-1)
    assert ok.mean() >= 0.995, (f"{1 - ok.mean():.4%} of pixels differ, at "
                                f"{_where(~ok)}")
    for b in range(bounces):
        for key in ("active", "hit", "mirror"):
            k = f"b{b}_{key}"
            assert counts[k] == ref_counts.get(k, 0), (k, counts[k],
                                                       ref_counts.get(k))
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()


@pytest.mark.parametrize("mirrors", [True, False], ids=["mirrors", "ao"])
def test_mirror_ao_frame_equals_jax(mirrors, world, sky, rays):
    """Mirrors and AO; and AO alone, K15 without mirrors (one bounce)."""
    ref, ref_counts = _jax_frame(world, sky, rays, JaxRenderConfig(**FRAME),
                                 mirrors=mirrors)
    hdr, counts = _port_frame(world, sky, rays, RenderConfig(**FRAME),
                              mirrors=mirrors)
    _check_frame(hdr, counts, ref, ref_counts, 3 if mirrors else 1)
    if mirrors:   # mirror pixels whose bounce 1 is shaded
        assert counts["b0_mirror"] > 0
        assert counts["b1_hit"] - counts["b1_mirror"] > 0


def _lights_near_the_view(world, rays) -> np.ndarray:
    """LIGHTS lights (x, y, z, 0), each 2 units back along a seeded camera
    ray from that ray's first hit (in empty space, near the surface)."""
    _, _, grid, _, _ = world
    o = torch.from_numpy(np.array(rays[0]))
    d = torch.from_numpy(np.array(rays[1]))
    res = trace_jump_plain(grid, o, d, stats=False)
    idx = np.nonzero(res.hit.numpy())[0]
    pick = np.random.default_rng(5).choice(idx, LIGHTS, replace=False)
    pos = (o + d * (res.t[:, None] - 2.0)).numpy()[pick]
    return np.concatenate([pos, np.zeros((LIGHTS, 1), np.float32)], 1)


def test_lights_wavy_frame_equals_jax(world, sky, rays):
    """Two bounces: the JAX frame compiles each light's DDA into every
    bounce."""
    knobs = {**FRAME, "point_lights": True, "wavy_reflections": True,
             "max_ray_iterations": 2}
    lights = convert.lights_from_numpy(_lights_near_the_view(world, rays))
    far = lights.copy()
    far[:, :3] = -1000.0
    jcfg = JaxRenderConfig(**knobs)
    ref, ref_counts = _jax_frame(world, sky, rays, jcfg, lights)
    ref_far, _ = _jax_frame(world, sky, rays, jcfg, far)
    lit = ~np.isclose(ref_far, ref, rtol=1e-4, atol=1e-4).all(-1)
    assert lit.mean() >= 0.01, f"the lights change {lit.mean():.4%}"
    hdr, counts = _port_frame(world, sky, rays, RenderConfig(**knobs),
                              lights)
    _check_frame(hdr, counts, ref, ref_counts, 2)


@pytest.fixture(scope="module")
def cone_sunmask(world):
    """(e1, e2, cone grids) of the 64^3 world's merged faces at SUN, the
    2048^2 build of soft shadows, built once for the two config-4 tests
    below (the Renderer's scene holds the same faces)."""
    faces = extract_merged_faces(world[0]).device_tuple("cpu")
    e1, e2, s = sunshadow.sun_basis(SUN[:3])
    return e1, e2, sunshadow.sun_grids(faces, e1, e2, s, 64, sunshadow.GRID,
                                       sunshadow.CONE_TAN)


def test_config4_golden(world, cone_sunmask):
    """tests/test_render.py:436's config-4 frame (the JAX package renders
    it on its brick pyramid, without the rasterizer) through the port's
    plain path on the jump grid, also without it."""
    occ, _, grid, _, dens = world
    cfg = RenderConfig(width=96, height=64, shadow_samples=4,
                       max_ray_iterations=4, skybox_resolution=32,
                       clouds_resolution=32, ambient_occlusion=True,
                       primary_raster="off")
    o, d = camera_rays(TERRAIN, 96, 64, "cpu")
    demand = {}
    img, hdr = render_frame(grid, o, d, SUN, 0.0, cfg,
                            sunmask=cone_sunmask, density=dens,
                            mirror_materials=True, demand=demand)
    assert torch.isfinite(hdr).all()
    assert int(demand["b3_active"]) > 0   # four bounces live
    golden = np.load(GOLDEN_DIR / "config4.npy")
    off = (np.abs(img.numpy().astype(int) - golden.astype(int)) > 2).any(-1)
    assert off.mean() < 0.005, f"{off.mean():.4%} off, at {_where(off)}"


def test_renderer_config4_on_the_cpu(world, cone_sunmask):
    """Renderer with config 4's knobs and the point lights: the scene
    builds its density, the lights move every frame, and the frame is
    the render_frame call with the scene's density and first lights; the
    second frame too, whose continuation buffers (kept by the Renderer)
    hold the first frame's rays, against fresh zero-filled ones. The
    Renderer's cone grids are seeded with the module's (the same faces
    and sun)."""
    cfg = RenderConfig(width=48, height=32, shadow_samples=4,
                       max_ray_iterations=4, ambient_occlusion=True,
                       point_lights=True, skybox_resolution=32,
                       clouds_resolution=32)
    r = Renderer(WorldConfig(depth=3), cfg, device="cpu",
                 mirror_materials=True)
    assert np.array_equal(r.sun[:3], SUN[:3])
    r._sunmask_cache = ((r.sun[:3].tobytes(), r.scene.epoch, False, True),
                        cone_sunmask)
    np.testing.assert_array_equal(r.scene.density.numpy(),
                                  world[4].numpy())
    before = r.scene.lights.copy()
    img = r.render(TERRAIN, time=0.5, fetch=True)
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    assert not np.array_equal(r.scene.lights, before)
    o, d = camera_rays(TERRAIN, 48, 32, "cpu")
    kept = r._nxt

    def fresh(t):
        return render_frame(
            r.scene.jumpgrid, o, d, r.sun, t, cfg, sky=r._sky(t),
            raster=(r.scene.ensure_faces(), raster_camera(TERRAIN),
                    r.scene.solid_at_host(TERRAIN.position))
            if r.use_raster else None,
            sunmask=r._sunmask(), density=r.scene.density,
            lights=r.scene.lights, mirror_materials=True)[0].numpy()

    np.testing.assert_array_equal(img, fresh(0.5))
    assert kept is not None and bool(kept[0].any())
    img2 = r.render(TERRAIN, time=0.6, fetch=True)
    assert r._nxt is kept
    np.testing.assert_array_equal(img2, fresh(0.6))
