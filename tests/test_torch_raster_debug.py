"""The raster debug view (debug_type 0) on the CPU: the port's near-plane
clipping, projection, z-buffer (K22's plain version), fragment shading
(K23's) and frame, held to the JAX package at 64^3 and 96x64 on the JAX
mesh (convert.mesh_from_numpy), at tests/test_render.py's three views
(the terrain view :97, the close-up :122-131, the straddling camera
:185-188).

- `clip_straddlers` equals JAX `_clip_straddlers` below its cap, and past
  it clips every straddler where JAX keeps CLIP_CAP (ROADMAP C3).
- `project_verts` equals the jitted JAX function bit for bit.
- The z-buffer equals the JAX slab loop's (`_raster_slab` replayed as
  `raster_debug_frame` runs it) bit for bit, and the winner too, but at
  pixels the test shows hold both winners' fragments within the 1e-6
  band of the least depth (the JAX loop folds its passes by exact (depth,
  id); the port takes the least id in the band): under 0.1% of covered
  pixels.
- The u8 frame equals JAX `raster_debug_frame`'s within the goldens'
  bar: under 0.5% of pixels off by more than 2, each such pixel a tie
  pixel (the sky textures and the rays differ from the jitted JAX ones in
  the last ulp, which moves sky pixels by a step or two).
- `Renderer(debug_type=0, device="cpu")` and the command line render the
  same frame; the command line writes the OBJ the JAX mesher writes.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.render import raster as jax_raster
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.world.mesher import VoxelMeshBuffers as JaxMesh
from vvr_tpu.world.pyramid import build_brick_pyramid as jax_build_pyramid
from vvr_tpu_torch import cli, convert
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.render import raster
from vvr_tpu_torch.render.frame import check_frame_config, render_frame
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera, load_snapshots

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

W, H = 96, 64
SMALL = dict(width=W, height=H, shadow_samples=1, max_ray_iterations=2,
             skybox_resolution=32, clouds_resolution=32, debug_type=0)
SUN = np.array([-0.28, 0.65, -0.71, 0.0], np.float32)
SUN[:3] /= np.linalg.norm(SUN[:3])
VIEWS = ("terrain", "closeup", "straddle")
BAND = np.float32(1.0 + 1e-6)


def _view(name: str, occ):
    """(position, target, fov) of test_render.py's three raster views."""
    if name == "terrain":
        return [32, 28, 6], [32, 2, 45], 85.0
    h = int(np.max(np.nonzero(occ[32, :, 32])[0]))
    if name == "closeup":
        fwd = occ[32, :, 36]
        ht = int(np.max(np.nonzero(fwd)[0])) if fwd.any() else h
        return [32.5, h + 1.6, 32.5], [32.5, ht + 0.5, 36.5], 85.0
    return [32.5, h + 0.4, 32.5], [38.5, h - 0.2, 38.5], 100.0


def _jax_slab_loop(sx, sy, w, tris, n_extra, extra_tris):
    """JAX `raster_debug_frame`'s slab loop (:328-348), replayed."""
    t = len(tris)
    tris_all = np.concatenate([tris, extra_tris])
    valid = np.zeros(len(tris_all), bool)
    valid[:t + n_extra] = True
    slab = jax_raster.SLAB
    n_slabs = max(-(-len(tris_all) // slab), 1)
    pad = n_slabs * slab - len(tris_all)
    tris_pad = np.pad(tris_all, ((0, pad), (0, 0)))
    valid_pad = np.pad(valid, (0, pad))
    zbuf = jnp.full((H * W,), jnp.inf, jnp.float32)
    winner = jnp.full((H * W,), jax_raster.NO_TRI, jnp.int32)
    for s in range(n_slabs):
        sl = slice(s * slab, (s + 1) * slab)
        zb, wn = jax_raster._raster_slab(
            sx, sy, w, jnp.asarray(tris_pad[sl]), jnp.asarray(valid_pad[sl]),
            jnp.arange(s * slab, (s + 1) * slab, dtype=np.int32), H, W)
        use = (zb < zbuf) | ((zb == zbuf) & (wn < winner))
        zbuf = jnp.minimum(zbuf, zb)
        winner = jnp.where(use, wn, winner)
    return np.asarray(zbuf), np.asarray(winner)


@pytest.fixture(scope="module")
def world(small_world):
    """The JAX mesh, pyramid and occupancy, the port's copies of them."""
    _, chunks, occ = small_world
    jmesh = JaxMesh.build(chunks)
    jpyr = jax_build_pyramid(occ)
    mesh = convert.mesh_from_numpy(jmesh.vertices, jmesh.indices,
                                   jmesh.ranges, device="cpu")
    pyr = convert.pyramid_from_numpy(np.asarray(jpyr.rows), occ.shape[0],
                                     device="cpu")
    return dict(jmesh=jmesh, jpyr=jpyr, mesh=mesh, pyr=pyr,
                occ=np.asarray(occ))


@pytest.fixture(scope="module")
def views(world):
    """Per view: the JAX references (clipping, projection, slab loop,
    frame) and the port's plain results, computed once."""
    out = {}
    mesh = world["mesh"]
    for name in VIEWS:
        pos, tgt, fov = _view(name, world["occ"])
        jcam, cam = JaxCamera.look_at(pos, tgt, fov), Camera.look_at(pos,
                                                                     tgt, fov)
        view, proj = jcam.matrices(W, H)
        _, _, fwd = jcam.basis()
        ev, et, n_extra = jax_raster._clip_straddlers(
            mesh.verts_host, mesh.tris_host, jcam.position, fwd)
        verts = np.concatenate([mesh.verts_host, ev])
        jproj = [np.asarray(a) for a in jax_raster.project_verts(
            jnp.asarray(verts), jnp.asarray(view), jnp.asarray(proj), W, H)]
        zbuf, winner = _jax_slab_loop(*(jnp.asarray(a) for a in jproj),
                                      mesh.tris_host, n_extra, et)
        img = np.asarray(jax_raster.raster_debug_frame(
            world["jmesh"], world["jpyr"], jcam, SUN, 0.0,
            JaxRenderConfig(**SMALL)))
        pev, pet = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                          cam.position, cam.basis()[2])
        m = raster.view_proj(cam, W, H)
        pz, pw = raster.raster_triangles(mesh.verts, mesh.tris, m, W, H,
                                         torch.from_numpy(pev),
                                         torch.from_numpy(pet))
        pimg, hdr = raster.raster_debug_frame(mesh, world["pyr"], cam, SUN,
                                              0.0, RenderConfig(**SMALL))
        out[name] = dict(cam=cam, jcam=jcam, ev=ev, et=et, n_extra=n_extra,
                         verts=verts, jproj=jproj, zbuf=zbuf, winner=winner,
                         img=img, pev=pev, pet=pet, m=m, pz=pz.numpy(),
                         pw=pw.numpy(), pimg=pimg.numpy(), hdr=hdr)
    return out


def _tie_pixels(world, v):
    """The pixels where the winners differ, each checked to hold a
    fragment of both winners within the 1e-6 band of the least depth."""
    mesh = world["mesh"]
    diff = np.nonzero(v["pw"] != v["winner"])[0]
    if len(diff) == 0:
        return diff
    pix, tri, depth = (torch.cat(c).numpy() for c in zip(
        *raster.covered_fragments(
            torch.cat([mesh.verts, torch.from_numpy(v["pev"])]),
            torch.cat([mesh.tris, torch.from_numpy(v["pet"])]), v["m"], W,
            H)))
    in_band = depth <= v["pz"][pix] * BAND
    band = set(zip(pix[in_band].tolist(), tri[in_band].tolist()))
    for p in diff.tolist():
        for who in (v["pw"][p], v["winner"][p]):
            assert (p, int(who)) in band, (
                f"pixel {p}: winner {who} has no fragment within the band")
    return diff


@pytest.mark.parametrize("name", VIEWS)
def test_clip_straddlers_equals_jax(views, name):
    v = views[name]
    assert v["n_extra"] < jax_raster.CLIP_CAP
    assert (v["n_extra"] > 0) == (name != "terrain")
    np.testing.assert_array_equal(v["pet"], v["et"][:v["n_extra"]])
    np.testing.assert_array_equal(v["pev"], v["ev"][:len(v["pev"])])
    # JAX's capacity past its new vertices is zero padding
    assert not v["ev"][len(v["pev"]):].any()


@pytest.mark.parametrize("name", VIEWS)
def test_project_verts_equals_jax(views, name):
    """Bit for bit: the XLA dot's sum order and its two screen FMAs."""
    v = views[name]
    ours = raster.project_verts(torch.from_numpy(v["verts"]), v["m"], W, H)
    for a, b in zip(ours, v["jproj"]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", VIEWS)
def test_zbuffer_and_winner_equal_jax(world, views, name):
    v = views[name]
    np.testing.assert_array_equal(v["pz"].view(np.int32),
                                  v["zbuf"].view(np.int32))
    covered = v["zbuf"] < np.inf
    assert covered.mean() > 0.5
    np.testing.assert_array_equal(v["pw"] == raster.NO_TRI, ~covered)
    ties = _tie_pixels(world, v)
    assert len(ties) <= 0.001 * covered.sum()


@pytest.mark.parametrize("contract", [False, True])
def test_one_rounding_for_every_triangle_moves_the_zbuffer(
        world, views, monkeypatch, contract):
    """Why K22 carries `contract` (render/raster.py's module docstring):
    with the edge functions rounded one way for every triangle, plain or
    as an FMA, the z-buffer leaves the JAX slab loop's on some view, where
    the JAX pass rule keeps it bit for bit (test above)."""
    mesh = world["mesh"]
    setup = raster.triangle_setup

    def one_rounding(*args):
        s = setup(*args)
        return s._replace(contract=torch.full_like(s.contract, contract))
    monkeypatch.setattr(raster, "triangle_setup", one_rounding)
    off = 0
    for name in VIEWS:
        v = views[name]
        pz, _ = raster.raster_triangles(mesh.verts, mesh.tris, v["m"], W, H,
                                        torch.from_numpy(v["pev"]),
                                        torch.from_numpy(v["pet"]))
        off += int((pz.numpy().view(np.int32)
                    != v["zbuf"].view(np.int32)).sum())
    assert off > 0


@pytest.mark.parametrize("name", VIEWS)
def test_frame_equals_jax(world, views, name):
    """The u8 frames agree within the goldens' bar, every pixel off by more
    than 2 a tie pixel; the HDR's alpha is 0, its rgb white or black
    where a triangle won."""
    v = views[name]
    d = np.abs(v["pimg"].astype(int) - v["img"].astype(int)).max(-1).ravel()
    ties = set(_tie_pixels(world, v).tolist())
    assert set(np.nonzero(d > 2)[0].tolist()) <= ties
    assert (d > 2).mean() < 0.005
    hdr = v["hdr"].reshape(4, -1).numpy()
    assert (hdr[3] == 0).all()
    won = v["pw"] != raster.NO_TRI
    assert np.isin(hdr[0, won], (0.0, 1.0)).all()
    assert 0 < (hdr[0, won] == 1.0).mean() < 1


def test_straddlers_past_the_jax_cap_c3():
    """ROADMAP C3: 5,000 straddling triangles. JAX `_clip_straddlers`
    clips CLIP_CAP = 4,096 and drops the rest; the port clips all 5,000,
    the first 4,096 as JAX does."""
    rng = np.random.default_rng(3)
    n = 5000
    front = rng.random((n, 3)) * 4 - 2
    front[:, 2] = rng.random(n) * 3 + 1.0          # w in (1, 4)
    behind = rng.random((n, 2, 3)) * 4 - 2
    behind[:, :, 2] = rng.random((n, 2)) * 0.4 - 0.2   # w < 0.5
    verts = np.concatenate([front[:, None], behind], 1).reshape(-1, 3)
    verts = verts.astype(np.float32)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    pos = np.zeros(3, np.float32)
    fwd = np.array([0, 0, 1], np.float32)
    ev, et, nt = jax_raster._clip_straddlers(verts, tris, pos, fwd)
    pev, pet = raster.clip_straddlers(verts, tris, pos, fwd)
    assert nt == jax_raster.CLIP_CAP and len(pet) == n
    np.testing.assert_array_equal(pet[:nt], et[:nt])
    np.testing.assert_array_equal(pev[:2 * nt], ev[:2 * nt])
    w = (np.concatenate([verts, pev]) @ fwd)[pet]
    assert (w >= raster.NEAR_W - 1e-5).all()


def test_renderer_and_cli_render_the_view(world, views, tmp_path):
    """Renderer(debug_type=0) on the CPU equals JAX raster_debug_frame on
    the terrain view as the frame above does; it builds the pyramid and no
    other grid, meshes once, and the frame functions refuse or accept
    debug_type 0 as they should. The command line writes the frame, the
    OBJ the JAX mesher writes and a profiler trace."""
    cfg = RenderConfig(**SMALL)
    check_frame_config(cfg)
    r = Renderer(WorldConfig(depth=3), cfg, device="cpu",
                 cache_path=tmp_path / "map_64.npz")
    assert r.raster_view and r.scene.pyramid is not None
    assert r.scene.jumpgrid is None and r.scene.faces is None
    v = views["terrain"]
    img = r.render(v["cam"], time=0.0, timed=True, fetch=True)
    mesh = r.mesh
    assert r.render(v["cam"], time=0.0, fetch=True).shape == img.shape
    assert r.mesh is mesh and r.frame_count == 2
    d = np.abs(img.astype(int) - v["img"].astype(int)).max(-1).ravel()
    ties = set(_tie_pixels(world, v).tolist())
    assert set(np.nonzero(d > 2)[0].tolist()) <= ties
    assert (d > 2).mean() < 0.005
    rep = r.memory_report()
    assert rep["mesh_mb"] > 0 and rep["pyramid_rows_mb"] > 0
    cam = r.camera_for_snapshot(0)
    np.testing.assert_allclose(cam.position * 16,
                               load_snapshots()[0].position, rtol=1e-6)
    with pytest.raises(ValueError, match="raster"):
        o = torch.zeros((W * H, 3))
        render_frame(r.grid, o, o, SUN, 0.0, cfg)

    obj, png = tmp_path / "world.obj", tmp_path / "frame.png"
    trace = tmp_path / "trace.json"
    assert cli.main(["--debug-type", "0", "--device", "cpu", "--depth", "3",
                     "--width", str(W), "--height", str(H),
                     "--export-mesh", str(obj), "--output", str(png),
                     "--profile", "--profile-path", str(trace)]) == 0
    assert "traceEvents" in trace.read_text()
    world["jmesh"].export_obj(tmp_path / "jax.obj")
    assert obj.read_text() == (tmp_path / "jax.obj").read_text()
    from PIL import Image
    assert np.asarray(Image.open(png)).shape == (H, W, 3)
