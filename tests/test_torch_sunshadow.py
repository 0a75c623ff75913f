"""K11 + K12 (the hard-shadow sun classifier): the port's plain grids and
masked shadow query held to the JAX package's `build_sun_grids`
(cone_tan 0) and `masked_shadow_hits`, to the every-lane DDA and to the
port's numpy oracle.

Tolerances. The grid frame (a0, b0, ts) and the basis are exact. XLA
contracts the affine sums of the JAX build into FMAs; the port rounds each
product (its CUDA copy is compiled with -fmad=false, as its plain version
runs). Finite texels therefore agree within 1e-4 absolute, and a texel may
take another value, or be written in one package and not the other, only
where some face's decision (its SAFE-shrunk cover test or its texel bbox)
sits within rounding of the threshold: the test recomputes those decisions
in float64 and requires such a face for every texel that differs. Both
sides are conservative there (the SAFE margin). Shadow booleans have no
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvr_tpu.ops.jump import trace_jump as jax_trace_jump
from vvr_tpu.ops.sunshadow import _near_segment as jax_near_segment
from vvr_tpu.ops.sunshadow import build_sun_grids as jax_build_sun_grids
from vvr_tpu.ops.sunshadow import masked_shadow_hits as jax_masked_shadow
from vvr_tpu.ops.sunshadow import sun_basis as jax_sun_basis
from vvr_tpu.world.faces import extract_merged_faces as jax_merged_faces
from vvr_tpu.world.jumpgrid import build_jump_grid as jax_build_jump_grid
from vvr_tpu_torch import convert
from vvr_tpu_torch.ops import shade, sunshadow
from vvr_tpu_torch.ops.jump import trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.rastertrace import raster_camera, trace_raster
from vvr_tpu_torch.ops.trace import solid, tensors, trace_plain
from vvr_tpu_torch.render.oracle import trace_dense
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.faces import extract_merged_faces
from vvr_tpu_torch.world.paged import build_paged_grid

# one intra-op thread: the suite runs six pytest workers on eight cores
torch.set_num_threads(1)

SUNS = {"default": [-0.28, 0.65, -0.71], "low": [0.6, 0.15, 0.3],
        "steep": [0.1, 0.95, 0.2], "x_major": [0.95, 0.3, 0.1]}
SUNS = {k: (np.array(v, np.float32) / np.linalg.norm(v)).astype(np.float32)
        for k, v in SUNS.items()}
CAM = Camera.look_at([32.0, 45.0, 6.0], [32.0, 10.0, 40.0], fov=85.0)
STEPS = 2048


@pytest.fixture(scope="module")
def world(small_world):
    occ = small_world[2]
    jgrid = jax_build_jump_grid(occ)
    grid = convert.jumpgrid_from_numpy(np.asarray(jgrid.rows), 64, "cpu")
    jfaces = jax_merged_faces(occ)
    return occ, jgrid, grid, jfaces, extract_merged_faces(occ)


@pytest.fixture(scope="module")
def grids(world):
    """{sun: (basis, JAX grids as numpy, port grids)} at 2048^2."""
    out = {}
    for name in ("default", "low"):
        e1, e2, s = sunshadow.sun_basis(SUNS[name])
        ref, ok = jax_build_sun_grids(world[3].device_tuple(),
                                      jnp.asarray(e1), jnp.asarray(e2),
                                      jnp.asarray(s), 64)
        assert bool(ok)
        ref = tuple(np.asarray(a) for a in ref)
        port = sunshadow.sun_grids(world[4].device_tuple("cpu"), e1, e2, s,
                                   64)
        out[name] = ((e1, e2, s), ref, port)
    return out


@pytest.mark.parametrize("name", sorted(SUNS))
def test_sun_basis_equals_jax(name):
    for a, b in zip(sunshadow.sun_basis(SUNS[name]),
                    jax_sun_basis(SUNS[name])):
        np.testing.assert_array_equal(a, b)


def _boundary_faces(fs, tex, grid, a0, b0, ts, eps=1e-4):
    """Whether some occluder face's decision at texel `tex` (its cover
    test, or its bbox edge) lies within eps of the threshold in float64."""
    i, j = tex % grid, tex // grid
    f = {k: v.double().numpy() if v.dtype.is_floating_point else v.numpy()
         for k, v in fs.items()}
    near = (f["occl"] & (f["oi0"] <= i + 1) & (f["oi1"] >= i - 1)
            & (f["oj0"] <= j + 1) & (f["oj1"] >= j - 1))
    for k in np.nonzero(near)[0]:
        g = {key: val[k] for key, val in f.items()}
        margins = []
        for da_ in (0, 1):
            for db_ in (0, 1):
                da = float(a0) + (i + da_) * float(ts) - g["p0a"]
                db = float(b0) + (j + db_) * float(ts) - g["p0b"]
                uu = (da * g["vb"] - db * g["va"]) * g["inv_det"]
                vv = (g["ua"] * db - g["ub"] * da) * g["inv_det"]
                margins += [uu - g["mu"], 1 - g["mu"] - uu,
                            vv - g["mv"] + g["xv0"], 1 - g["mv"] + g["xv1"]
                            - vv]
        if min(abs(m) for m in margins) < eps:
            return True
        # the bbox edges, in texels: floor((corner +- SAFE - origin) / ts)
        ca = [g["p0a"], g["p0a"] + g["va"], g["p0a"] + g["ua"],
              g["p0a"] + g["ua"] + g["va"]]
        cb = [g["p0b"], g["p0b"] + g["vb"], g["p0b"] + g["ub"],
              g["p0b"] + g["ub"] + g["vb"]]
        edges = [(min(ca) - 0.02 - float(a0)) / float(ts),
                 (max(ca) + 0.02 - float(a0)) / float(ts),
                 (min(cb) - 0.02 - float(b0)) / float(ts),
                 (max(cb) + 0.02 - float(b0)) / float(ts)]
        if min(abs(e - round(e)) for e in edges) < eps * 100:
            return True
    return False


@pytest.fixture(scope="module")
def grids_200(world):
    """The default sun's (basis, JAX grids as numpy, port grids) at 200^2,
    a side that is no multiple of K11's tiles."""
    e1, e2, s = sunshadow.sun_basis(SUNS["default"])
    ref, ok = jax_build_sun_grids(world[3].device_tuple(), jnp.asarray(e1),
                                  jnp.asarray(e2), jnp.asarray(s), 64,
                                  grid=200)
    assert bool(ok)
    return ((e1, e2, s), tuple(np.asarray(a) for a in ref),
            sunshadow.sun_grids(world[4].device_tuple("cpu"), e1, e2, s, 64,
                                200))


@pytest.mark.parametrize("name, grid", [("default", 2048), ("low", 2048),
                                        ("default", 200)],
                         ids=["default", "low", "default-200"])
def test_grids_equal_jax(name, grid, request, world):
    (e1, e2, s), ref, port = (request.getfixturevalue("grids")[name]
                              if grid == 2048
                              else request.getfixturevalue("grids_200"))
    gbc, a0, b0, ts = port
    assert gbc.shape == (grid * grid, 2)
    assert (a0, b0, ts) == tuple(np.float32(v) for v in ref[2:])
    g, r = gbc.numpy(), ref[0]
    neg_p, neg_r = g <= -3e38, r <= -3e38
    fin = ~neg_p & ~neg_r
    if name == "default":   # depths of both signs along this sun
        assert (g[fin] < 0).any() and (g[fin] > 0).any()
    odd = np.nonzero((neg_p != neg_r).any(1)
                     | (fin & (np.abs(g - r) > 1e-4)).any(1))[0]
    assert len(odd) <= 16, f"{len(odd)} texels differ"
    fs = sunshadow.face_setup(world[4].device_tuple("cpu"), e1, e2, s, a0,
                               b0, ts, grid)
    for tex in odd:
        assert _boundary_faces(fs, tex, grid, a0, b0, ts), (
            f"texel {tex}: port {g[tex]}, JAX {r[tex]}, no face on a "
            "decision boundary")
    close = fin & (np.abs(g - r) <= 1e-4)
    assert close.sum() >= fin.sum() - 2 * len(odd)


@pytest.mark.parametrize("grid, tiling", [
    (2048, (32, 64)), (1024, (32, 32)), (1023, (16, 32)), (512, (16, 16)),
    (509, (16, 16)), (200, (16, 16)), (1, (16, 16)), (4096, (32, 128))])
def test_sun_tiling(grid, tiling):
    """K11's (tile, bin) sides: 32-texel tiles from 1024^2 up, 16 below,
    the bins a whole number of tiles and at most SUN_MAX_BINS of them."""
    assert sunshadow.sun_tiling(grid) == tiling
    tile, side = tiling
    assert side % tile == 0
    assert (-(-grid // side)) ** 2 <= sunshadow.SUN_MAX_BINS


@pytest.mark.parametrize("n_faces, grid, nbytes", [
    # 32^2 bins of 64 texels, 4^2 coarse bins and the global list: 1041
    # lists, for 68 blocks of faces; a job per bin; 22 int4 per face
    (68923, 2048, 16 * 68923 * 22 + 32 * 32 ** 2 + 8 * (1041 * 68 + 70 + 1)),
    # no faces: one block of zero counts (two scan blocks), the 32^2 jobs,
    # nothing per face
    (0, 512, 32 * 32 ** 2 + 8 * (1041 + 2 + 1)),
    (0, 509, 32 * 32 ** 2 + 8 * (1041 + 2 + 1)),
    # 13^2 bins of 16 texels, 2^2 coarse bins, the global list
    (5, 200, 16 * 5 * 22 + 32 * 13 ** 2 + 8 * (174 + 1 + 1))])
def test_sun_scratch_bytes(n_faces, grid, nbytes):
    """K11's scratch, sized from the face count and the grid alone (the
    layout of csrc/sunshadow.cu vvr_sun_grids)."""
    assert sunshadow.sun_scratch_bytes(n_faces, grid) == nbytes


@pytest.mark.parametrize("name", ["default", "low"])
def test_certain_answers_agree_with_oracle(name, grids, world):
    """Empty-space points: a certain answer must be the DDA's
    (tests/test_sunshadow.py:35), and most points must be certain."""
    occ = world[0]
    (e1, e2, s), _, port = grids[name]
    rng = np.random.default_rng(100)
    pts = np.concatenate([rng.uniform(0.2, 63.8, (3000, 3)),
                          rng.uniform([0, 0, 0], [64, 38.4, 64], (3000, 3))
                          ]).astype(np.float32)
    cell = np.clip(np.floor(pts).astype(np.int64), 0, 63)
    pts = pts[~occ[cell[:, 2], cell[:, 1], cell[:, 0]]]
    cs, cl, inw, _, _ = sunshadow.certain(torch.from_numpy(pts), s, e1, e2,
                                          port, 64, back=0.0)
    cs, cl = cs.numpy(), cl.numpy()
    ref = trace_dense(occ, pts, np.broadcast_to(s, pts.shape))["hit"]
    assert not (cs & ~ref).any(), "certain shadow on a lit point"
    assert not (cl & ref).any(), "certain light on a shadowed point"
    assert (cs | cl)[inw.numpy()].mean() > 0.6


@pytest.fixture(scope="module")
def hits(world):
    """The primary hits of a 96x64 frame from the raster:
    (o, d, hit, face, axis_coord)."""
    faces = world[4]
    o, d = camera_rays(CAM, 96, 64, "cpu")
    res = trace_raster(faces.device_tuple("cpu"), raster_camera(CAM), d,
                       False, 64, 96, 64)
    return o, d, res.hit, res.face, res.axis_coord


@pytest.fixture(scope="module")
def surface(hits):
    """Shadow starts of the 96x64 frame's raster hits: surface + 0.05
    along the default sun, lit-facing lanes active."""
    sun = torch.from_numpy(SUNS["default"])
    return shade.shade_surface_plain(*hits, sun)


def test_masked_shadow_equals_every_lane_dda(world, grids, surface):
    grid = world[2]
    (e1, e2, _), _, port = grids["default"]
    s_o, act = surface
    sun = SUNS["default"]
    got = sunshadow.masked_shadow_hits(grid, s_o, sun, e1, e2, port, act,
                                       STEPS)
    want = trace_jump_plain(grid, s_o, torch.from_numpy(sun).expand(
        s_o.shape[0], 3), STEPS, active=act).hit
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(act.sum())
    shadow, light, _, _, _ = sunshadow.certain(s_o, sun, e1, e2, port, 64)
    amb = act & ~shadow & ~light
    assert 0 < int(amb.sum()) < int(act.sum()) // 4


def test_masked_shadow_equals_jax(world, grids, surface):
    """Same starts and the JAX grids through both packages."""
    _, jgrid, grid, _, _ = world
    (e1, e2, _), ref, _ = grids["default"]
    s_o, act = surface
    sun = SUNS["default"]

    def tr(o, d, active=None, pack_first=None, shadow=False):
        return jax_trace_jump(jgrid, o, d, max_steps=STEPS, active=active,
                              compact=False)

    want = np.asarray(jax_masked_shadow(
        tr, jnp.asarray(s_o.numpy()), jnp.asarray(sun), jnp.asarray(e1),
        jnp.asarray(e2), tuple(jnp.asarray(a) for a in ref),
        jnp.asarray(act.numpy()), 64, None))
    got = sunshadow.masked_shadow_hits(
        grid, s_o, sun, e1, e2, convert.sun_grids_from_numpy(ref, "cpu"),
        act, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["default", "low"])
def test_masked_shadow_from_hits_equals_jax(world, grids, hits, name):
    """The frame's K12 entry on the primary hits: its plain version is K2
    `shade_surface_plain` followed by `masked_shadow_hits_plain`, and it
    answers as JAX `masked_shadow_hits` on the same starts and the JAX
    grids, under the default sun and a low one."""
    _, jgrid, grid, _, _ = world
    (e1, e2, _), ref, _ = grids[name]
    sun = SUNS[name]
    port_grids = convert.sun_grids_from_numpy(ref, "cpu")
    got = sunshadow.masked_shadow_from_hits(grid, *hits, sun, e1, e2,
                                            port_grids, STEPS)
    s_o, act = shade.shade_surface_plain(*hits, torch.from_numpy(sun))
    assert torch.equal(got, sunshadow.masked_shadow_hits_plain(
        grid, s_o, sun, e1, e2, port_grids, act, STEPS))
    assert 0 < int(got.sum()) < int(act.sum())

    def tr(o, d, active=None, pack_first=None, shadow=False):
        return jax_trace_jump(jgrid, o, d, max_steps=STEPS, active=active,
                              compact=False)

    want = np.asarray(jax_masked_shadow(
        tr, jnp.asarray(s_o.numpy()), jnp.asarray(sun), jnp.asarray(e1),
        jnp.asarray(e2), tuple(jnp.asarray(a) for a in ref),
        jnp.asarray(act.numpy()), 64, None))
    np.testing.assert_array_equal(got.numpy(), want)


def test_branches_partition_the_lanes(world, grids, surface):
    """Every active lane has one branch and every inactive lane none, and
    a branch that answers without the DDA gives the every-lane DDA's
    answer."""
    grid = world[2]
    (e1, e2, _), _, port = grids["default"]
    s_o, act = surface
    sun = SUNS["default"]
    br = sunshadow.shadow_branches(grid, s_o, sun, e1, e2, port, act)
    assert torch.equal(br == 0, ~act)
    counts = torch.bincount(br, minlength=len(sunshadow.BRANCHES))
    assert len(counts) == len(sunshadow.BRANCHES)
    assert int(counts[3]) > 0 and int(counts[4]) > 0
    dda = trace_jump_plain(grid, s_o, torch.from_numpy(sun).expand(
        s_o.shape[0], 3), STEPS, active=act).hit
    hits = (br == 2) | (br == 3) | (br == 5)
    lights = (br == 1) | (br == 4) | (br == 6) | (br == 7)
    assert not bool((hits & ~dda).any()) and not bool((lights & dda).any())


@pytest.mark.parametrize("kind", ["jump", "paged"])
def test_masked_shadow_records_the_rows_it_loads(kind, world, grids,
                                                 surface):
    """`rows_read` of the plain K12 (the bound's count of the bytes K12
    needs) leaves its answer as it is and marks what its tests load: the
    start voxel's rows of each active lane in the world, the near walk's
    rows of the lanes past the certainty tests (jump grid only), and the
    rows of the residue's DDA."""
    grid = world[2] if kind == "jump" else build_paged_grid(world[0], "cpu")
    (e1, e2, _), _, port = grids["default"]
    s_o, act = surface
    sun = SUNS["default"]

    def marks():
        return tuple(torch.zeros(t.shape[0], dtype=torch.bool)
                     for t in tensors(grid))

    read = marks()
    got = sunshadow.masked_shadow_hits_plain(grid, s_o, sun, e1, e2, port,
                                             act, STEPS, rows_read=read)
    assert torch.equal(got, sunshadow.masked_shadow_hits_plain(
        grid, s_o, sun, e1, e2, port, act, STEPS))
    want = marks()
    inw = ((s_o >= 0) & (s_o < 64)).all(1)
    v = torch.floor(s_o[act & inw]).to(torch.int64)
    solid(grid, v, want)
    br = sunshadow.shadow_branches(grid, s_o, sun, e1, e2, port, act)
    if kind == "jump":
        sunshadow.near_segment_plain(grid, s_o[br >= 5], sun,
                                     rows_read=want)
    trace_plain(grid, s_o[br == 8], torch.from_numpy(sun), STEPS,
                stats=False, rows_read=want)
    for a, b in zip(read, want):
        assert torch.equal(a, b)
    assert int(read[-1].sum()) > 0


def test_near_segment_equals_jax(world, surface):
    _, jgrid, grid, _, _ = world
    s_o, act = surface
    p = s_o[act]
    sun = SUNS["default"]
    # jitted, as the JAX frame runs it
    ref = jax.jit(jax_near_segment)(jgrid, jnp.asarray(p.numpy()),
                                    jnp.asarray(sun))
    out = sunshadow.near_segment_plain(grid, p, sun)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[0].any() and not out[0].all()


def test_low_res_grid_same_booleans(world, grids, surface):
    """512^2 grids (the sun-drag resolution) widen the ambiguous residue
    and give the same answers."""
    grid, faces = world[2], world[4]
    (e1, e2, s), _, fine = grids["default"]
    s_o, act = surface
    sun = SUNS["default"]
    coarse = sunshadow.sun_grids(faces.device_tuple("cpu"), e1, e2, s, 64,
                                 sunshadow.GRID_DRAGGING)
    assert coarse[0].shape == (512 * 512, 2)
    a = sunshadow.masked_shadow_hits(grid, s_o, sun, e1, e2, fine, act,
                                     STEPS)
    b = sunshadow.masked_shadow_hits(grid, s_o, sun, e1, e2, coarse, act,
                                     STEPS)
    assert torch.equal(a, b)
    amb = [int((act & ~c[0] & ~c[1]).sum()) for c in (
        sunshadow.certain(s_o, sun, e1, e2, g, 64) for g in (fine, coarse))]
    assert amb[0] <= amb[1]


def test_grid_chunks_do_not_change_grids(world, grids, monkeypatch):
    """The plain build walks (face, texel) pairs in chunks; tiny chunks
    give the same grids."""
    (e1, e2, s), _, _ = grids["low"]
    faces = world[4].device_tuple("cpu")
    ref = sunshadow.sun_grids(faces, e1, e2, s, 64, 512)
    monkeypatch.setattr(sunshadow, "PLAIN_CHUNK", 3000)
    out = sunshadow.sun_grids(faces, e1, e2, s, 64, 512)
    assert torch.equal(out[0], ref[0])


@pytest.mark.parametrize("grid", [2048, 1024, 512, 509, 200, 1, 4096])
def test_sun_tiling_cone(grid):
    """The cone build's tiles are 16 texels a side at every size, its bins
    those of the hard build (so the scratch is the same) and at most
    SUN_MAX_BINS of them."""
    tile, side = sunshadow.sun_tiling(grid, cone=True)
    assert tile == 16 and side % tile == 0
    assert side == sunshadow.sun_tiling(grid)[1]
    assert (-(-grid // side)) ** 2 <= sunshadow.SUN_MAX_BINS


@pytest.mark.parametrize("n_faces, grid", [(68923, 2048), (0, 512), (5, 200)])
def test_sun_scratch_bytes_cone(n_faces, grid):
    """The cone build's scratch: the hard build's, behind the support grid
    (cs^2 u32, cs = min(256, grid), rounded up to 16 bytes)."""
    cs = min(256, grid)
    assert (sunshadow.sun_scratch_bytes(n_faces, grid, cone=True)
            == sunshadow.sun_scratch_bytes(n_faces, grid)
            + -(-4 * cs * cs // 16) * 16)


# ---- the cone build's tight boxes (cone_boxes_plain; K11's setup)

@pytest.fixture(scope="module")
def cone_boxes(world):
    """{(sun, grid): (per-face setup with the present boxes, support grid,
    tight boxes, frame)} of the cone build."""
    faces = world[4].device_tuple("cpu")
    out = {}
    for name in ("default", "low"):
        basis = sunshadow.sun_basis(SUNS[name])
        for grid in (512, 2048):
            frame = sunshadow.grid_frame(basis[0], basis[1], 64, grid)
            fs = sunshadow.face_setup(faces, *basis, *frame, grid,
                                      sunshadow.CONE_TAN, 64)
            sg = sunshadow.support_grid_plain(fs, *frame, grid)
            tight = sunshadow.cone_boxes_plain(fs, sg, *frame, grid,
                                               sunshadow.CONE_TAN)
            out[name, grid] = fs, sg, tight, frame
    return out


@pytest.mark.parametrize("grid", [512, 2048])
@pytest.mark.parametrize("name", ["default", "low"])
def test_tight_boxes_lie_in_the_present_boxes(name, grid, cone_boxes):
    """Each occluder's tight box is empty or inside its present box (grown
    from the world's least depth), and some are smaller."""
    fs, _, (i0, i1, j0, j1), _ = cone_boxes[name, grid]
    occ = fs["occl"]
    full = (i0 <= i1) & (j0 <= j1)
    assert bool((i0[occ & full] >= fs["oi0"][occ & full]).all())
    assert bool((i1[occ & full] <= fs["oi1"][occ & full]).all())
    assert bool((j0[occ & full] >= fs["oj0"][occ & full]).all())
    assert bool((j1[occ & full] <= fs["oj1"][occ & full]).all())
    area = torch.where(full, (i1 - i0 + 1) * (j1 - j0 + 1), 0)
    loose = (fs["oi1"] - fs["oi0"] + 1) * (fs["oj1"] - fs["oj0"] + 1)
    assert bool((area[occ] < loose[occ]).any())
    assert int(area[occ].sum()) < int(loose[occ].sum())


@pytest.mark.parametrize("grid", [512, 2048])
@pytest.mark.parametrize("name", ["default", "low"])
def test_passing_pairs_lie_in_the_tight_boxes(name, grid, cone_boxes):
    """Every (face, texel) pair whose texel test marks gridB or gridC in
    the present boxes' build lies inside the face's tight box."""
    fs, sg, (i0, i1, j0, j1), frame = cone_boxes[name, grid]
    marked = 0
    for f, i, j, poss, _, fully, _ in sunshadow.pair_tests(
            fs, sg, *frame, grid, sunshadow.CONE_TAN):
        m = poss | fully
        f, i, j = f[m], i[m], j[m]
        assert bool(((i >= i0[f]) & (i <= i1[f]) & (j >= j0[f])
                     & (j <= j1[f])).all())
        marked += int(m.sum())
    assert marked > 0


@pytest.mark.parametrize("name, grid", [("default", 2048), ("low", 512)])
def test_tight_cone_build_equals_present_boxes(name, grid, world):
    """The plain cone build over the tight boxes equals the build over the
    present boxes bit for bit."""
    faces = world[4].device_tuple("cpu")
    basis = sunshadow.sun_basis(SUNS[name])
    loose = sunshadow.sun_grids_plain(faces, *basis, 64, grid,
                                      sunshadow.CONE_TAN)[0]
    tight = sunshadow.sun_grids_plain(faces, *basis, 64, grid,
                                      sunshadow.CONE_TAN, tight=True)[0]
    assert torch.equal(loose, tight)
    assert bool((loose[:, 1] > -3e38).any())


@pytest.mark.parametrize("name", ["default", "low"])
def test_bbox_grown_by_the_margin_is_not_enough(name, cone_boxes):
    """Why the tight box is cut from the test's (u, v) region: the bbox of
    the quad grown by the S_lo margin misses pairs whose texel test marks
    gridB or gridC (a skewed quad grown by g reaches past its bbox grown
    by g, and the test compares the texel's (u, v) interval)."""
    fs, sg, _, (a0, b0, ts) = cone_boxes[name, 512]
    cs, bfc = sunshadow.coarse_side(512)
    ci0, ci1 = (torch.clamp(fs[k] // bfc, max=cs - 1) for k in ("oi0", "oi1"))
    cj0, cj1 = (torch.clamp(fs[k] // bfc, max=cs - 1) for k in ("oj0", "oj1"))
    s_lo = torch.full_like(fs["zmax"], 3e38)
    cw = ci1 - ci0 + 1
    cnt = torch.where(fs["occl"], cw * (cj1 - cj0 + 1), 0)
    for f, ci, cj in sunshadow._pairs(cnt, ci0, cj0, cw):
        s_lo.scatter_reduce_(0, f, sg[cj * cs + ci], "amin")
    grow = sunshadow.SAFE + sunshadow.CONE_TAN * torch.clamp(
        fs["zmax"] - (s_lo - sunshadow.S_SLACK), min=0.0)
    ca = torch.stack([fs["p0a"], fs["p0a"] + fs["va"], fs["p0a"] + fs["ua"],
                      fs["p0a"] + fs["ua"] + fs["va"]])
    cb = torch.stack([fs["p0b"], fs["p0b"] + fs["vb"], fs["p0b"] + fs["ub"],
                      fs["p0b"] + fs["ub"] + fs["vb"]])

    def texel(x, lo):
        return torch.floor((x - float(lo)) / float(ts)).long()

    i0, i1 = texel(ca.amin(0) - grow, a0), texel(ca.amax(0) + grow, a0)
    j0, j1 = texel(cb.amin(0) - grow, b0), texel(cb.amax(0) + grow, b0)
    missed = 0
    for f, i, j, poss, _, fully, _ in sunshadow.pair_tests(
            fs, sg, a0, b0, ts, 512, sunshadow.CONE_TAN):
        m = (poss | fully) & ~fs["deg"][f]
        missed += int((m & ((i < i0[f]) | (i > i1[f]) | (j < j0[f])
                            | (j > j1[f]))).sum())
    assert missed > 0
