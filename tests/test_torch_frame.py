"""The slice as a whole: the port's `render_frame` and `Renderer` on the CPU
(plain torch path) held to the committed goldens and to the JAX frame.

- Goldens: the port renders the golden views of tests/test_render.py with
  its own rays, on the JAX package's jump grid (convert.py), and must meet
  that file's bar: fewer than 0.5% of pixels off by more than 2. At the
  default knobs (face rasterizer, sun classifier) the frame must also equal
  the DDA frame pixel for pixel.
- The JAX frame: same rays, world and sky textures through both packages;
  alpha exact, rgb within rtol=atol=1e-4 on at least 99.5% of pixels
  (pow ulps in lighting; a nearest cloud texel can flip on a boundary).
- Rays: XLA folds `/ width * 2` into one multiply and contracts the
  multiply-adds of the direction, so about half of the JAX directions
  differ from the port's correctly rounded ones by one or two ulps:
  components agree within 2.5e-7 absolute (two ulps at 1.0), origins
  exactly.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.config import WorldConfig as JaxWorldConfig
from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.render.frame import render_frame as jax_render_frame
from vvr_tpu.ops.sunshadow import build_sun_grids as jax_build_sun_grids
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.world.faces import extract_merged_faces as jax_merged_faces
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops.rastertrace import raster_camera
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.frame import render_frame
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera, load_snapshots
from vvr_tpu_torch.world.faces import extract_merged_faces

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
SLICE = dict(width=96, height=64, shadow_samples=1, max_ray_iterations=2,
             skybox_resolution=32, clouds_resolution=32,
             primary_raster="off", sun_mask="off")
SUN = np.array([-0.28, 0.65, -0.71], np.float32)
SUN = np.concatenate([SUN / np.linalg.norm(SUN), [0.0]]).astype(np.float32)


def _views():
    cams = {"terrain": Camera.look_at([32, 28, 6], [32, 2, 45], fov=85),
            "sky": Camera.look_at([32, 40, 32], [32, 80, 90], fov=100)}
    for i, s in enumerate(load_snapshots()[:2]):
        cam = Camera.from_snapshot(s)
        cam.position = cam.position * (64 / 1024.0)
        cams[f"snap{i}"] = cam
    return cams


def _jax_camera(cam):
    return JaxCamera(cam.position, cam.rotation, cam.fov)


@pytest.fixture(scope="module")
def grids(small_world):
    jgrid = jax_build_jump_grid(small_world[2])
    return jgrid, convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64,
                                              "cpu")


@pytest.fixture(scope="module")
def classifier(small_world):
    """The port's faces and hard-shadow classifier of the 64^3 world."""
    faces = extract_merged_faces(small_world[2]).device_tuple("cpu")
    e1, e2, s = sunshadow.sun_basis(SUN[:3])
    return faces, (e1, e2, sunshadow.sun_grids(faces, e1, e2, s, 64))


def _probe(occ, cam):
    c = np.clip(np.floor(cam.position).astype(int), 0, 63)
    return bool(occ[c[2], c[1], c[0]])


@pytest.mark.parametrize("view", ["terrain", "sky", "snap0", "snap1"])
def test_golden_views_default_knobs(view, grids, classifier, small_world):
    """The face rasterizer and the sun classifier: the golden bar, and the
    DDA frame's pixels exactly."""
    cam = _views()[view]
    o, d = camera_rays(cam, 96, 64, "cpu")
    faces, sunmask = classifier
    cfg = RenderConfig(**{**SLICE, "primary_raster": "auto",
                          "sun_mask": "auto"})
    img, hdr = render_frame(
        grids[1], o, d, SUN, 0.0, cfg,
        raster=(faces, raster_camera(cam), _probe(small_world[2], cam)),
        sunmask=sunmask)
    assert torch.isfinite(hdr).all()
    golden = np.load(GOLDEN_DIR / f"{view}.npy")
    diff = np.abs(img.numpy().astype(int) - golden.astype(int))
    assert (diff > 2).mean() < 0.005, f"{view}: {(diff > 2).mean():.4%}"
    ref, _ = render_frame(grids[1], o, d, SUN, 0.0, RenderConfig(**SLICE))
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


@pytest.mark.parametrize("view", ["terrain", "sky", "snap0", "snap1"])
def test_golden_views(view, grids):
    cam = _views()[view]
    o, d = camera_rays(cam, 96, 64, "cpu")
    img, hdr = render_frame(grids[1], o, d, SUN, 0.0, RenderConfig(**SLICE))
    assert img.dtype == torch.uint8 and tuple(img.shape) == (64, 96, 3)
    assert torch.isfinite(hdr).all()
    golden = np.load(GOLDEN_DIR / f"{view}.npy")
    diff = np.abs(img.numpy().astype(int) - golden.astype(int))
    assert (diff > 2).mean() < 0.005, f"{view}: {(diff > 2).mean():.4%}"


def test_terrain_hdr_equals_jax(grids):
    """At 64x48, under the 4096 rays where the JAX tracer's compaction
    cascade engages: compiling the cascade into the JAX frame costs about
    a minute of CPU. Both packages get the same seeded sky textures."""
    jgrid, grid = grids
    cfg = {**SLICE, "width": 64, "height": 48}
    jo, jd = jax_camera_rays(_jax_camera(_views()["terrain"]), 64, 48)
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    _, ref = jax_render_frame(jgrid, jo, jd, jnp.asarray(SUN),
                              jnp.float32(0.0), JaxRenderConfig(**cfg),
                              sky=(jnp.asarray(sb), jnp.asarray(cl)))
    ref = np.asarray(ref)
    _, hdr = render_frame(grid, torch.from_numpy(np.array(jo)),
                          torch.from_numpy(np.array(jd)), SUN, 0.0,
                          RenderConfig(**cfg),
                          sky=convert.sky_from_numpy(sb, cl, "cpu"))
    hdr = hdr.numpy()
    np.testing.assert_array_equal(hdr[..., 3], ref[..., 3])
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()
    ok = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.995, f"{1 - ok.mean():.4%} of pixels differ"


def test_default_knobs_hdr_equals_jax(grids, small_world):
    """The JAX frame with `raster` and `sunmask` against the port's, at the
    bar of test_terrain_hdr_equals_jax: same rays, faces, classifier grids
    (the JAX build, converted) and sky textures."""
    jgrid, grid = grids
    occ = small_world[2]
    cfg = {**SLICE, "width": 64, "height": 48, "primary_raster": "auto",
           "sun_mask": "auto"}
    cam = _views()["terrain"]
    jo, jd = jax_camera_rays(_jax_camera(cam), 64, 48)
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    jfaces = jax_merged_faces(occ)
    rc = raster_camera(cam)
    probe = _probe(occ, cam)
    e1, e2, s = sunshadow.sun_basis(SUN[:3])
    jgrids, ok = jax_build_sun_grids(jfaces.device_tuple(), jnp.asarray(e1),
                                     jnp.asarray(e2), jnp.asarray(s), 64)
    assert bool(ok)
    _, ref = jax_render_frame(
        jgrid, jo, jd, jnp.asarray(SUN), jnp.float32(0.0),
        JaxRenderConfig(**cfg), sky=(jnp.asarray(sb), jnp.asarray(cl)),
        raster=(jfaces.device_tuple(), tuple(jnp.asarray(c) for c in rc),
                jnp.asarray(probe)),
        sunmask=(jnp.asarray(e1), jnp.asarray(e2), jgrids))
    ref = np.asarray(ref)
    _, hdr = render_frame(
        grid, torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd)),
        SUN, 0.0, RenderConfig(**cfg),
        sky=convert.sky_from_numpy(sb, cl, "cpu"),
        raster=(convert.faces_from_numpy(jfaces, "cpu"), rc, probe),
        sunmask=(e1, e2, convert.sun_grids_from_numpy(
            tuple(np.asarray(a) for a in jgrids), "cpu")))
    hdr = hdr.numpy()
    np.testing.assert_array_equal(hdr[..., 3], ref[..., 3])
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()
    ok = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.995, f"{1 - ok.mean():.4%} of pixels differ"


@pytest.mark.parametrize("iterations", [0, 1])
def test_max_ray_iterations_equals_jax(iterations, grids):
    """The JAX frame runs `max_ray_iterations` bounces and zeroes the lanes
    still active: with 0 every pixel is black with alpha 0; with 1 (no
    mirrors) bounce 0 runs, as at the default 3. Same rays, world and sky
    textures through both packages, the bar of
    test_terrain_hdr_equals_jax."""
    jgrid, grid = grids
    cfg = {**SLICE, "width": 64, "height": 48,
           "max_ray_iterations": iterations}
    jo, jd = jax_camera_rays(_jax_camera(_views()["terrain"]), 64, 48)
    rng = np.random.default_rng(0)
    sb = rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32)
    cl = rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
    ref_img, ref = jax_render_frame(jgrid, jo, jd, jnp.asarray(SUN),
                                    jnp.float32(0.0), JaxRenderConfig(**cfg),
                                    sky=(jnp.asarray(sb), jnp.asarray(cl)))
    ref = np.asarray(ref)
    img, hdr = render_frame(grid, torch.from_numpy(np.array(jo)),
                            torch.from_numpy(np.array(jd)), SUN, 0.0,
                            RenderConfig(**cfg),
                            sky=convert.sky_from_numpy(sb, cl, "cpu"))
    hdr = hdr.numpy()
    np.testing.assert_array_equal(hdr[..., 3], ref[..., 3])
    if iterations == 0:
        assert not ref.any()
        np.testing.assert_array_equal(hdr, ref)
        np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
        return
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()
    ok = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.995, f"{1 - ok.mean():.4%} of pixels differ"


def test_negative_max_ray_iterations_raises(grids):
    o, d = camera_rays(_views()["terrain"], 96, 64, "cpu")
    cfg = RenderConfig(**{**SLICE, "max_ray_iterations": -1})
    with pytest.raises(ValueError, match="max_ray_iterations"):
        render_frame(grids[1], o, d, SUN, 0.0, cfg)
    with pytest.raises(ValueError, match="max_ray_iterations"):
        Renderer(WorldConfig(depth=3), cfg, device="cpu")


@pytest.mark.parametrize("view", ["terrain", "snap1"])
def test_rays_close_to_jax(view):
    cam = _views()[view]
    jo, jd = jax_camera_rays(_jax_camera(cam), 96, 64)
    o, d = camera_rays(cam, 96, 64, "cpu")
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=2.5e-7)


def test_renderer_renders_and_caches_sky(tmp_path, grids):
    r = Renderer(WorldConfig(depth=3), RenderConfig(**SLICE), device="cpu",
                 cache_path=tmp_path / "map_64.npz")
    assert (tmp_path / "map_64.npz").exists()
    np.testing.assert_array_equal(r.scene.jumpgrid.rows.numpy(),
                                  grids[1].rows.numpy())
    cam = _views()["terrain"]
    img = r.render(cam, time=0.0, fetch=True)
    sky0 = r._sky_cache
    assert r.render(cam, time=0.2, fetch=True).shape == (64, 96, 3)
    assert r._sky_cache is sky0             # same 0.25 s bucket
    r.render(cam, time=0.3)
    assert r._sky_cache is not sky0          # next bucket rebuilt
    o, d = camera_rays(cam, 96, 64, "cpu")
    ref, _ = render_frame(grids[1], o, d, SUN, 0.0, RenderConfig(**SLICE))
    np.testing.assert_array_equal(img, ref.numpy())
    assert r.rays_per_frame == 2 * 96 * 64
    res = r.benchmark(cam, duration_s=0.01, warmup=1)
    assert res["samples"] >= 1 and res["avg_ms"] > 0
    assert res["mrays_per_s"] == pytest.approx(
        r.rays_per_frame / (res["avg_ms"] * 1e-3) / 1e6)


def test_renderer_default_knobs_cache_sun_grids(tmp_path, grids):
    """At the default knobs the Renderer rasterizes and classifies; it
    builds the sun grids once per sun direction (and at 512^2 while the sun
    is dragged), and its frames equal the DDA Renderer's."""
    cfg = {k: v for k, v in SLICE.items()
           if k not in ("primary_raster", "sun_mask")}
    r = Renderer(WorldConfig(depth=3), RenderConfig(**cfg), device="cpu",
                 cache_path=tmp_path / "map_64.npz")
    assert r.use_raster and r.use_sunmask and r.scene.faces is not None
    dda = Renderer(WorldConfig(depth=3), RenderConfig(**SLICE), device="cpu",
                   scene=r.scene)
    assert not dda.use_raster and not dda.use_sunmask
    cam = _views()["terrain"]
    img = r.render(cam, time=0.0, fetch=True)
    cache = r._sunmask_cache
    assert cache[1][2][0].shape == (2048 * 2048, 2)
    r.render(cam, time=0.3)
    assert r._sunmask_cache is cache           # same sun: no rebuild
    np.testing.assert_array_equal(img, dda.render(cam, time=0.0,
                                                  fetch=True))
    r.set_sun_dragging(True)
    r.render(cam, time=0.0)
    assert r._sunmask_cache[1][2][0].shape == (512 * 512, 2)
    r.set_sun_dragging(False)
    sun = np.array([0.6, 0.5, 0.6], np.float32)
    r.sun = dda.sun = np.append(sun / np.linalg.norm(sun),
                                0.0).astype(np.float32)
    moved = r.render(cam, time=0.0, fetch=True)
    assert r._sunmask_cache is not cache       # the sun moved: rebuilt
    np.testing.assert_array_equal(moved, dda.render(cam, time=0.0,
                                                    fetch=True))


@pytest.mark.parametrize("pair", [(RenderConfig, JaxRenderConfig),
                                  (WorldConfig, JaxWorldConfig)],
                         ids=["render", "world"])
def test_config_fields_equal_jax(pair):
    """Same field names and defaults, so a config means one frame in both
    packages."""
    port, ref = ([(f.name, f.default) for f in dataclasses.fields(c)]
                 for c in pair)
    assert port == ref


OUTSIDE = [
    ("sun_mask_soft", {"sun_mask": "auto", "shadow_samples": 4}, {}),
    ("soft_shadows", {"shadow_samples": 4}, {}),
    ("ao", {"ambient_occlusion": True}, {}),
    ("point_lights", {"point_lights": True}, {}),
    ("debug_iterations", {"debug_type": 1}, {}),
    ("pyramid", {"traversal": "pyramid"}, {}),
    ("paged", {"traversal": "paged"}, {}),
    ("jump2", {"traversal": "jump2"}, {}),
    ("mirrors", {}, {"mirror_materials": True}),
    ("dynamic", {}, {"dynamic_world": True}),
]


@pytest.mark.parametrize("knobs,kwargs", [c[1:] for c in OUTSIDE],
                         ids=[c[0] for c in OUTSIDE])
def test_outside_the_slice_raises(knobs, kwargs):
    cfg = RenderConfig(**{**SLICE, **knobs})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(WorldConfig(depth=3), cfg, device="cpu", **kwargs)
