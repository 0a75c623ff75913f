"""Soft and pixelated shadows (K14, K11's cone mode): the port's plain
versions held to the JAX package on the same seeded inputs, on the 64^3
world.

- The jitter (`softshadow.sample_dir`, `ray_start`) bit for bit against a
  jitted copy of vvr_tpu/render/frame.py:339-359 on 20,000 points of the
  world's exposed faces, samples 0-3: XLA's jit on the CPU contracts some
  of its sums into FMAs, and the port places them where XLA does.
- Frames against JAX `render_frame` (sun_mask "off", the per-sample DDA;
  pixelated shadows with one and with four samples), same rays, world and
  seeded sky textures: alpha exact; on every pixel whose four jittered
  samples equal a jitted JAX copy of the frame's surface reconstruction
  and jitter bit for bit (XLA contracts the surface point's `o + d *
  dist`, so an ulp there moves the jitter), HDR within rtol = atol = 1e-4
  (the port's frame bar, tests/test_torch_frame.py) and on at least 95%
  of them within rtol = atol = 4e-6 (XLA also contracts the lighting's
  sums, which moves a pixel with a fractional shadow factor by up to
  1.4e-5: 51 of 2,180 such pixels of the soft frame, whose factors are
  themselves equal); u8 within one step on at least 99.5% of pixels. The
  JAX frames are 64x48,
  under the 4096 rays at which its compaction cascade compiles (one
  96x64 soft frame costs about two minutes of CPU), and are rendered once.
- The cone grids against JAX `build_sun_grids(cone_tan=CONE_TAN)` at 512^2:
  finite texels within 1e-4 (XLA contracts the affine sums of its jitted
  build, as for the hard grids, tests/test_torch_sunshadow.py), and a
  texel may differ beyond that, or be written in one package only, only
  where a face's decision there (its cover test or its touch test with
  the texel's cone margin, or its box) sits within rounding of the
  threshold, recomputed in float64.
- The gate (kh, km) and the near walk exactly against JAX
  `soft_shadow_gate` and `near_walk_classify` on the same grids (the JAX
  build's, converted) and the same points.
- The port's cone frame byte for byte against its per-sample DDA frame
  at C1's configuration (96x64, 4 samples, the default cone grids), and
  every sample's hit of K14's gate mode against its DDA mode on every
  lane.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.config import RenderConfig as JaxRenderConfig
from vvr_tpu.ops.raygen import camera_rays as jax_camera_rays
from vvr_tpu.ops.sunshadow import CONE_TAN as JAX_CONE_TAN
from vvr_tpu.ops.sunshadow import build_sun_grids as jax_build_sun_grids
from vvr_tpu.ops.sunshadow import near_walk_classify as jax_near_walk
from vvr_tpu.ops.sunshadow import soft_shadow_gate as jax_gate
from vvr_tpu.render.frame import render_frame as jax_render_frame
from vvr_tpu.utils.camera import Camera as JaxCamera
from vvr_tpu.utils.hash import hash33_soa as jax_hash33_soa
from vvr_tpu.world.faces import extract_merged_faces as jax_merged_faces
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import softshadow, sunshadow
from vvr_tpu_torch.ops.jump import trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.frame import render_frame
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.faces import extract_merged_faces

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

F32 = jnp.float32
SUN = np.array([-0.28, 0.65, -0.71], np.float32)
SUN = (SUN / np.linalg.norm(SUN)).astype(np.float32)
LOW = np.array([0.6, 0.15, 0.3], np.float32)
LOW = (LOW / np.linalg.norm(LOW)).astype(np.float32)
# C1's camera and configuration (tests/test_sunshadow.py:262-284)
CAM = Camera.look_at([32.0, 45.0, 6.0], [32.0, 10.0, 40.0], fov=85.0)
C1 = dict(width=96, height=64, shadow_samples=4, max_ray_iterations=2,
          skybox_resolution=32, clouds_resolution=32, traversal="jump")
JW, JH = 64, 48   # the JAX frames
FRAMES = {"soft": dict(shadow_samples=4),
          "pixelated1": dict(shadow_samples=1, pixelated_shadows=True),
          "pixelated4": dict(shadow_samples=4, pixelated_shadows=True)}
STEPS = 2048


@pytest.fixture(scope="module")
def world(small_world):
    occ = small_world[2]
    jgrid = jax_build_jump_grid(occ)
    grid = convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64, "cpu")
    return occ, jgrid, grid, jax_merged_faces(occ), extract_merged_faces(occ)


# ---- a jitted copy of the JAX frame's pieces (vvr_tpu/render/frame.py)

def _jax_sample_dir(s, px, py, pz, sun3):
    """frame.py:339-354, verbatim."""
    c1, c2 = F32(23.12123545), F32(s * 30.43324)
    rx, ry, rz = jax_hash33_soa(px * c1 + c2, py * c1 + c2, pz * c1 + c2)
    sdx = sun3[0] + (rx * 2.0 - 1.0) * 0.005
    sdy = sun3[1] + (ry * 2.0 - 1.0) * 0.005
    sdz = sun3[2] + (rz * 2.0 - 1.0) * 0.005
    sn = jnp.maximum(jnp.sqrt(sdx * sdx + sdy * sdy + sdz * sdz), 1e-12)
    sdx, sdy, sdz = sdx / sn, sdy / sn, sdz / sn
    strength = jnp.power(jnp.clip(
        sdx * sun3[0] + sdy * sun3[1] + sdz * sun3[2], 0.0, 1.0), 40.0)
    return sdx, sdy, sdz, strength


def _jax_ray_start(px, py, pz, sdx, sdy, sdz, sun3):
    """frame.py:356-359, verbatim."""
    return (px + sun3[0] * 0.004 + sdx * 0.05,
            py + sun3[1] * 0.004 + sdy * 0.05,
            pz + sun3[2] * 0.004 + sdz * 0.05)


def _jax_surface(o, d, face, axis_coord, pixelated):
    """frame.py:212-232 and :283-286: the hit point (and its floor)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    sg = [jnp.where(c >= 0, F32(1.0), F32(-1.0)) for c in (dx, dy, dz)]

    def sel(vx, vy, vz):
        return jnp.where(face == 0, vx, jnp.where(face == 1, vy, vz))

    plane = axis_coord.astype(F32) + jnp.where(sel(*sg) < 0, F32(1.0),
                                               F32(0.0))
    df = sel(dx, dy, dz)
    dist = (plane - sel(ox, oy, oz)) / jnp.where(jnp.abs(df) < 1e-12,
                                                 F32(1e-12), df)
    w = (jnp.where(face == 0, plane, ox + dx * dist),
         jnp.where(face == 1, plane, oy + dy * dist),
         jnp.where(face == 2, plane, oz + dz * dist))
    if pixelated:
        w = tuple(jnp.floor(c * 4.0) / 4.0 for c in w)
    return w


def _jax_jitter_all(s, px, py, pz, sun3):
    r = _jax_sample_dir(s, px, py, pz, sun3)
    c1, c2 = F32(23.12123545), F32(s * 30.43324)
    h = jax_hash33_soa(px * c1 + c2, py * c1 + c2, pz * c1 + c2)
    return r + _jax_ray_start(px, py, pz, *r[:3], sun3) + h


_jax_jitter = jax.jit(_jax_jitter_all, static_argnums=0)


@pytest.fixture(scope="module")
def face_points(world):
    """20,000 points on the world's exposed faces (seeded): the corner of a
    random merged face plus a random fraction of its two edges."""
    f = world[4]
    rng = np.random.default_rng(7)
    k = rng.integers(0, len(f.vx), 20000)
    u, v = (rng.uniform(0.0, 1.0, 20000).astype(np.float32)
            for _ in range(2))
    axis, sgn = f.axis[k], f.sgn[k]
    base = np.stack([f.vx[k], f.vy[k], f.vz[k]], 1).astype(np.float32)
    du = u * f.eu[k].astype(np.float32)
    dv = v * f.ev[k].astype(np.float32)
    p = base.copy()
    p[np.arange(20000), axis] += sgn.astype(np.float32)
    p[:, 0] += np.where(axis == 0, 0.0, du).astype(np.float32)
    p[:, 1] += np.where(axis == 1, 0.0, np.where(axis == 0, du, dv)) \
        .astype(np.float32)
    p[:, 2] += np.where(axis == 2, 0.0, dv).astype(np.float32)
    return p


@pytest.mark.parametrize("s", range(4))
def test_jitter_equals_jitted_jax(s, face_points):
    """Direction, strength and start of sample s, bit for bit."""
    px, py, pz = (torch.from_numpy(face_points[:, c].copy())
                  for c in range(3))
    sun = torch.from_numpy(SUN)
    dirs = softshadow.sample_dir(s, px, py, pz, sun)
    port = dirs + softshadow.ray_start(px, py, pz, *dirs[:3], sun)
    ref = _jax_jitter(s, *(jnp.asarray(face_points[:, c]) for c in range(3)),
                      jnp.asarray(SUN))
    names = ("dx", "dy", "dz", "strength", "ox", "oy", "oz")
    for name, a, b in zip(names, port, ref):
        b = np.asarray(b)
        assert np.array_equal(a.numpy(), b), (
            f"sample {s} {name}: {int((a.numpy() != b).sum())} of "
            f"{len(b)} differ")


# ---- frames against the JAX frame

def _rays():
    jo, jd = jax_camera_rays(JaxCamera(CAM.position, CAM.rotation, CAM.fov),
                             JW, JH)
    return jo, jd


def _sky():
    rng = np.random.default_rng(0)
    return (rng.uniform(0.0, 1.0, (6, 32, 32, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32))


def _cfg(knobs):
    return dict(C1, width=JW, height=JH, primary_raster="off",
                sun_mask="off", **knobs)


@pytest.fixture(scope="module")
def jax_frames(world):
    """The three JAX frames, (u8, hdr) as numpy, rendered once."""
    jo, jd = _rays()
    sb, cl = _sky()
    sun4 = jnp.asarray(np.append(SUN, 0.0).astype(np.float32))
    out = {}
    for name, knobs in FRAMES.items():
        img, hdr = jax_render_frame(world[1], jo, jd, sun4, jnp.float32(0.0),
                                    JaxRenderConfig(**_cfg(knobs)),
                                    sky=(jnp.asarray(sb), jnp.asarray(cl)))
        out[name] = (np.asarray(img), np.asarray(hdr))
    return out


def _same_jitter(o, d, res, knobs):
    """(H*W,) bool: the pixels whose every sample's direction, strength
    and start from the port's surface point equal a jitted JAX copy's from
    the JAX frame's (jitted) surface point, bit for bit (every pixel with
    hard shadows: they have no jitter)."""
    n = o.shape[0]
    pix = bool(knobs.get("pixelated_shadows", False))
    samples = knobs["shadow_samples"]
    same = np.ones(n, bool)
    if samples == 1:
        return same
    w = jax.jit(_jax_surface, static_argnums=4)(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(res.face.numpy()), jnp.asarray(res.axis_coord.numpy()),
        pix)
    p, _ = softshadow.query_points(o, d, res.hit, res.face, res.axis_coord,
                                   torch.from_numpy(SUN), pix)
    sun = torch.from_numpy(SUN)
    for s in range(samples):
        dirs = softshadow.sample_dir(s, *p.unbind(1), sun)
        port = dirs + softshadow.ray_start(*p.unbind(1), *dirs[:3], sun)
        ref = _jax_jitter(s, *w, jnp.asarray(SUN))
        for a, b in zip(port, ref):
            same &= a.numpy() == np.asarray(b)
    return same


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_equals_jax(name, world, jax_frames):
    knobs = FRAMES[name]
    grid = world[2]
    jo, jd = _rays()
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    sb, cl = _sky()
    img, hdr = render_frame(grid, o, d, np.append(SUN, 0.0), 0.0,
                            RenderConfig(**_cfg(knobs)),
                            sky=convert.sky_from_numpy(sb, cl, "cpu"))
    ref_img, ref = jax_frames[name]
    hdr = hdr.numpy()
    np.testing.assert_array_equal(hdr[..., 3], ref[..., 3])
    assert (ref[..., 3] == 10).any() and (ref[..., 3] == 0).any()
    res = trace_jump_plain(grid, o, d, STEPS)
    same = _same_jitter(o, d, res, knobs).reshape(JH, JW)
    assert same.mean() > 0.5, f"jitter bit-equal on {same.mean():.3f}"
    near = np.isclose(hdr[..., :3], ref[..., :3], rtol=1e-4,
                      atol=1e-4).all(-1)
    assert near[same].all(), (f"{int((~near & same).sum())} pixels with "
                              "bit-equal jitter differ beyond 1e-4")
    close = np.isclose(hdr[..., :3], ref[..., :3], rtol=4e-6,
                       atol=4e-6).all(-1)
    assert close[same].mean() >= 0.95, (
        f"{int((~close & same).sum())} of {int(same.sum())} pixels with "
        "bit-equal jitter differ beyond 4e-6")
    step = np.abs(img.numpy().astype(int) - ref_img.astype(int)).max(-1)
    assert (step <= 1).mean() >= 0.995, f"{(step > 1).mean():.4%} off by > 1"


# ---- the cone grids, the gate and the walk against JAX

def _jax_cone_grids(world, sun, grid):
    e1, e2, s = sunshadow.sun_basis(sun)
    ref, ok = jax_build_sun_grids(world[3].device_tuple(), jnp.asarray(e1),
                                  jnp.asarray(e2), jnp.asarray(s), 64,
                                  grid=grid, cone_tan=JAX_CONE_TAN)
    assert bool(ok)
    return (e1, e2, s), tuple(np.asarray(a) for a in ref)


def _cone_boundary(fs, sg, wz, tex, grid, a0, b0, ts, eps=1e-4):
    """Whether some occluder's decision at texel `tex` of the cone build
    (its cover or touch test with the texel's cone margin, or its box
    edge, grown by the face's reach above the world's least depth wz)
    lies within eps of the threshold, in float64."""
    i, j = tex % grid, tex // grid
    cs, bfc = sunshadow.coarse_side(grid)
    s_t = float(sg[min(j // bfc, cs - 1) * cs + min(i // bfc, cs - 1)])
    f = {k: v.double().numpy() if v.dtype.is_floating_point else v.numpy()
         for k, v in fs.items()}
    near = (f["occl"] & (f["oi0"] <= i + 1) & (f["oi1"] >= i - 1)
            & (f["oj0"] <= j + 1) & (f["oj1"] >= j - 1))
    for k in np.nonzero(near)[0]:
        g = {key: val[k] for key, val in f.items()}
        grow = 0.02 + sunshadow.CONE_TAN * max(g["zmax"] - (s_t - 0.5), 0.0)
        mu, mv = grow * g["rmu"], grow * g["rmv"]
        uus, vvs = [], []
        for da_ in (0, 1):
            for db_ in (0, 1):
                da = float(a0) + (i + da_) * float(ts) - g["p0a"]
                db = float(b0) + (j + db_) * float(ts) - g["p0b"]
                uus.append((da * g["vb"] - db * g["va"]) * g["inv_det"])
                vvs.append((g["ua"] * db - g["ub"] * da) * g["inv_det"])
        margins = [m for uu, vv in zip(uus, vvs)
                   for m in (uu - mu, 1 - mu - uu, vv - mv + g["xv0"],
                             1 - mv + g["xv1"] - vv)]
        margins += [max(uus) + mu, 1 + mu - min(uus), max(vvs) + mv,
                    1 + mv - min(vvs)]
        if min(abs(m) for m in margins) < eps:
            return True
        # the box edges, in texels: floor((corner +- grow - origin) / ts)
        fgrow = 0.02 + sunshadow.CONE_TAN * max(g["zmax"] - wz + 0.5, 0.0)
        ca = [g["p0a"], g["p0a"] + g["va"], g["p0a"] + g["ua"],
              g["p0a"] + g["ua"] + g["va"]]
        cb = [g["p0b"], g["p0b"] + g["vb"], g["p0b"] + g["ub"],
              g["p0b"] + g["ub"] + g["vb"]]
        edges = [(min(ca) - fgrow - float(a0)) / float(ts),
                 (max(ca) + fgrow - float(a0)) / float(ts),
                 (min(cb) - fgrow - float(b0)) / float(ts),
                 (max(cb) + fgrow - float(b0)) / float(ts)]
        if any(abs(e - round(e)) < eps * 100 for e in edges):
            return True
    return False


@pytest.mark.parametrize("sun", ["default", "low"])
def test_cone_grids_equal_jax(sun, world):
    grid = 512
    basis, ref = _jax_cone_grids(world, SUN if sun == "default" else LOW,
                                 grid)
    faces = world[4].device_tuple("cpu")
    gbc, a0, b0, ts = sunshadow.sun_grids(faces, *basis, 64, grid,
                                          sunshadow.CONE_TAN)
    assert (a0, b0, ts) == tuple(np.float32(v) for v in ref[2:])
    g, r = gbc.numpy(), ref[0]
    neg_p, neg_r = g <= -3e38, r <= -3e38
    fin = ~neg_p & ~neg_r
    odd = np.nonzero((neg_p != neg_r).any(1)
                     | (fin & (np.abs(g - r) > 1e-4)).any(1))[0]
    assert len(odd) <= 8, f"{len(odd)} texels differ"
    fs = sunshadow.face_setup(faces, *basis, a0, b0, ts, grid,
                              sunshadow.CONE_TAN, 64)
    sg = sunshadow.support_grid_plain(fs, a0, b0, ts, grid).numpy()
    wz = float(sunshadow.world_zmin(basis[2], 64))
    for tex in odd:
        assert _cone_boundary(fs, sg, wz, tex, grid, a0, b0, ts), (
            f"texel {tex}: port {g[tex]}, JAX {r[tex]}, no face on a "
            "decision boundary")
    # a certain shadow of the cone grids is one of the hard grids: their
    # cover test is stricter and their depth lowered by the cone's reach
    hard = sunshadow.sun_grids(faces, *basis, 64, grid)[0].numpy()
    assert (g[:, 0] <= hard[:, 0]).all()
    assert (g[:, 0] < hard[:, 0]).any()


@pytest.fixture(scope="module")
def cone_case(world):
    """The JAX cone grids of the default sun at 512^2 (and the port's copy)
    with the C1 view's surface points and shadow lanes."""
    basis, ref = _jax_cone_grids(world, SUN, 512)
    o, d = camera_rays(CAM, 96, 64, "cpu")
    res = trace_jump_plain(world[2], o, d, STEPS)
    p, act = softshadow.query_points(o, d, res.hit, res.face, res.axis_coord,
                                     torch.from_numpy(SUN), False)
    return basis, ref, convert.sun_grids_from_numpy(ref, "cpu"), p, act


def test_gate_equals_jax(cone_case):
    (e1, e2, _), ref, grids, p, act = cone_case
    kh, km = sunshadow.soft_shadow_gate(p, SUN, e1, e2, grids, act, 64)
    # the JAX gate and walk run jitted, as the JAX frame runs them
    jkh, jkm = jax.jit(jax_gate, static_argnums=6)(
        jnp.asarray(p.numpy()), jnp.asarray(SUN), jnp.asarray(e1),
        jnp.asarray(e2), tuple(jnp.asarray(a) for a in ref),
        jnp.asarray(act.numpy()), 64)
    np.testing.assert_array_equal(kh.numpy(), np.asarray(jkh))
    np.testing.assert_array_equal(km.numpy(), np.asarray(jkm))
    assert kh.any() and km.any() and (act & ~kh & ~km).any()


@pytest.mark.parametrize("s", [0, 3])
def test_near_walk_equals_jax(s, world, cone_case):
    (e1, e2, _), ref, grids, p, act = cone_case
    kh, km = sunshadow.soft_shadow_gate(p, SUN, e1, e2, grids, act, 64)
    idx = torch.nonzero(act & ~kh & ~km)[:, 0]
    q = p[idx].unbind(1)
    sun = torch.from_numpy(SUN)
    dirs = softshadow.sample_dir(s, *q, sun)[:3]
    start = torch.stack(softshadow.ray_start(*q, *dirs, sun), -1)
    dirs = torch.stack(dirs, -1)
    row_c = sunshadow.surface_row_c(p[idx], SUN, e1, e2, grids, 64)
    wh, wm = sunshadow.near_walk_classify(world[2], start, dirs, row_c, SUN,
                                          64)
    jwh, jwm = jax.jit(jax_near_walk, static_argnums=5)(
        world[1], jnp.asarray(start.numpy()), jnp.asarray(dirs.numpy()),
        jnp.asarray(row_c.numpy()), jnp.asarray(SUN), 64)
    np.testing.assert_array_equal(wh.numpy(), np.asarray(jwh))
    np.testing.assert_array_equal(wm.numpy(), np.asarray(jwm))
    assert wh.any() and wm.any() and (~wh & ~wm).any()


# ---- the port's cone frame against its own per-sample DDA frame

@pytest.fixture(scope="module")
def c1_renderers(tmp_path_factory):
    path = tmp_path_factory.mktemp("softshadow") / "map_64.npz"
    cone = Renderer(WorldConfig(depth=3), RenderConfig(**C1, sun_mask="auto"),
                    device="cpu", cache_path=path)
    dda = Renderer(WorldConfig(depth=3), RenderConfig(**C1, sun_mask="off"),
                   device="cpu", scene=cone.scene)
    return cone, dda


def test_cone_frame_equals_dda_frame(c1_renderers):
    """C1's configuration through the port's Renderer: the cone frame (the
    rasterizer, K14 gated by the 2048^2 cone grids) byte for byte against
    the per-sample DDA frame."""
    cone, dda = c1_renderers
    assert cone.use_sunmask and not dda.use_sunmask
    img = cone.render(CAM, time=0.0, fetch=True)
    assert cone._sunmask_cache[0][3]        # the cone grids were built
    np.testing.assert_array_equal(img, dda.render(CAM, time=0.0, fetch=True))


def test_gate_mode_hits_equal_dda_mode_every_lane(c1_renderers, world):
    """Every sample's hit of K14's gate mode (the cone gate, the near walk,
    the DDA of what is left) equals its DDA mode's, on every lane."""
    cone, _ = c1_renderers
    o, d = camera_rays(CAM, 96, 64, "cpu")
    res = trace_jump_plain(world[2], o, d, STEPS)
    args = (world[2], o, d, res.hit, res.face, res.axis_coord, SUN, 4,
            cone._sky(0.0)[1], STEPS)
    f_gate, h_gate = softshadow.soft_shadow(*args, gate=cone._sunmask(),
                                            with_hits=True)
    f_dda, h_dda = softshadow.soft_shadow(*args, with_hits=True)
    assert h_gate.shape == (4, 96 * 64) and h_gate.any()
    assert torch.equal(h_gate, h_dda)
    assert torch.equal(f_gate, f_dda)
    assert not bool(f_dda[~res.hit].any())
    assert bool(((f_dda > 0) & (f_dda < 1)).any())   # penumbra pixels


def test_cone_margin_covers_the_jitter():
    """CONE_TAN bounds the tan of every jittered direction's angle to the
    sun: the jitter moves each component by at most 0.005."""
    assert sunshadow.CONE_TAN == JAX_CONE_TAN
    assert math.atan(sunshadow.CONE_TAN) >= 0.005 * math.sqrt(3.0)


# ---- K14's map of its threads to pixels and (pixel, sample) items

@pytest.mark.parametrize("samples", [1, 3, 4, 5])
@pytest.mark.parametrize("height", [67, 1080])
@pytest.mark.parametrize("width", [0, 33, 1920])
def test_lane_map_covers_each_pair_once(width, height, samples):
    """soft_pixels gives every pixel one thread; soft_lane_map gives every
    (pixel, sample) of a pixel with samples to add one (thread, round),
    none to the others, on seeded masks (flat lanes, width 0: 61 x height
    of them)."""
    n = (width or 61) * height
    pix = softshadow.soft_pixels(n, width)
    assert pix.numel() % 32 == 0
    assert torch.equal(torch.sort(pix[pix >= 0]).values, torch.arange(n))
    rng = np.random.default_rng(1000 * width + height + samples)
    adds = torch.from_numpy(rng.random(n) < 0.7)
    traced = adds & torch.from_numpy(rng.random(n) < 0.5)
    p, s = softshadow.soft_lane_map(n, width, samples, traced, adds)
    ok = p >= 0
    assert torch.equal(ok, s >= 0)
    key = torch.sort(p[ok] * samples + s[ok]).values
    want = torch.nonzero(adds)[:, 0, None] * samples + torch.arange(samples)
    assert torch.equal(key, want.flatten())


def test_lane_map_rounds_take_traced_pixels_first():
    """In each warp the pixels that trace take the first rounds: no round
    of a warp holds a pixel that traces after one that does not."""
    n, width, samples = 33 * 67, 33, 4
    rng = np.random.default_rng(7)
    adds = torch.from_numpy(rng.random(n) < 0.8)
    traced = adds & torch.from_numpy(rng.random(n) < 0.4)
    p, _ = softshadow.soft_lane_map(n, width, samples, traced, adds)
    for warp in p.view(-1, 32, p.shape[1]):
        seq = [int(x) for r in range(warp.shape[1]) for x in warp[:, r]
               if x >= 0]
        flags = [bool(traced[x]) for x in dict.fromkeys(seq)]
        assert flags == sorted(flags, reverse=True)
