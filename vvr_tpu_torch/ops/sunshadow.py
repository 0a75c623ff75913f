"""Sun-space shadow classifier — kernels K11 `sun_grids` and K12
`masked_shadow` (csrc/sunshadow.cu), and the cone gate K14 runs
(csrc/softshadow.cu).

Replaces vvr_tpu/ops/sunshadow.py: `sun_basis` (:83), `build_sun_grids`
(:112) with cone_tan 0 (hard shadows) and CONE_TAN (the cone grids of
soft shadows), `masked_shadow_hits` (:654) with its `_certain` (:525) and
`_near_segment` (:536), and `soft_shadow_gate` (:771) and
`near_walk_classify` (:617) as plain versions of K14's gate mode, and
`invalidate_sun_texels` (:460) as K18 `invalidate_texels`, the grids'
repair after a world edit. `classify` is used only by the JAX package's
tests and tools and is not ported.

All shadow rays of a frame share the sun direction s, so occlusion is a
property of the world's projection along s. A ray toward the sun can enter
solid only through an exposed face whose normal opposes s; two
conservative grids over the projection, built once per sun direction from
those faces, answer most lanes with one table read:

  gridB[t] = max over faces fully covering texel t (quad shrunk by SAFE)
             of the face's affine min depth over t: a start below
             gridB - SAFE is certainly shadowed;
  gridC[t] = max over faces possibly touching t (bbox grown by SAFE) of
             the face's affine max depth (+ the margin): a surface above
             gridC + SAFE is certainly lit.

A lane neither certain walks its first six voxel crossings (a hit there is
the DDA's hit; a miss lifts the query above the local wall), and only what
is still ambiguous runs the jump-grid DDA. On the paged grid (worlds past
512^3) there is no walk, as in the JAX frame (vvr_tpu/render/frame.py:475):
every lane the grids leave ambiguous runs the paged DDA (K16's, inline).
The answer equals the DDA's for every lane whose DDA ends within its step
cap.

The frame calls `masked_shadow_from_hits` with its primary hits: on the
card K12 computes each lane's start and mask from them in registers, with
K2 `shade_surface`'s code (csrc/surface.cuh), so the frame launches no
`shade_surface` and the starts never reach device memory.

The cone grids (soft shadows) make one classification hold for every
jittered direction of a lane: each texel's margins grow by the cone's
lateral reach, CONE_TAN times the face's depth above a support depth S,
the least surface depth of the texel's coarse column (COARSE texels a
side), so a lane whose every sample is certainly shadowed or lit traces
nothing (`soft_shadow_gate`); a sample that is neither walks its first
crossings and lifts above its surface texel's cone gridC
(`near_walk_classify`) before the DDA. On the card the cone build takes
each occluder's tight box (`cone_boxes_plain`): the texels whose test can
pass at the largest margin its box's support depths allow; the grids are
those of the present boxes bit for bit.

The grids are (gBC (G^2, 2) f32, a0, b0, ts): texel (i, j) covers
[a0 + i*ts, a0 + (i+1)*ts) x [b0 + j*ts, ...) of the (e1, e2) plane, row
j*G + i. The JAX build's fixed entry capacity with its overflow flag and
retry, the coarse level cBC that no query reads, and the two-stage pack of
the ambiguous lanes with its lax.cond net exist for static shapes and are
not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops import trace as tracer
from vvr_tpu_torch.ops.shade import (check_trace_inputs,
                                     shade_surface_plain)
from vvr_tpu_torch.utils.hash import sqrt32
from vvr_tpu_torch.world.jumpgrid import JumpGrid
from vvr_tpu_torch.world.occupancy import brick_solid

F32 = torch.float32
GRID = 2048
GRID_DRAGGING = 512   # while the sun is dragged (Renderer.set_sun_dragging)
SAFE = 0.02
NEG = -3e38
BACK = 0.05     # the frame's shadow-start offset along s
NEAR_K = 6      # near-segment length in voxel crossings
MASK32 = 0xFFFFFFFF
# (face, texel) pairs per chunk of the plain build (bounds its memory)
PLAIN_CHUNK = 1 << 22
# K11: faces per block of its setup and bin kernels, the most bins, the
# bins a side of a coarse bin, the most bins (or coarse bins) a face's
# entries span (csrc/sunshadow.cu VVR_SUN_FPB, VVR_SUN_MAX_BINS,
# VVR_SUN_COARSE, VVR_SUN_BIN_MAX)
SUN_FPB = 1024
SUN_MAX_BINS = 1024
SUN_COARSE = 8
SUN_BIN_MAX = 16
# the soft-shadow cone (vvr_tpu/ops/sunshadow.py:96-108, :765): the largest
# angle between a jittered sample direction and the sun (its tan), the
# support grid's side (COARSE texels at most), the support pass's lateral
# pad and depth slack, and the most a sample's start sits ahead of its
# surface point along the sun
CONE_TAN = 0.0087
COARSE = 256
S_PAD = 0.5
S_SLACK = 0.5
SOFT_FWD = 0.06
# the most coarse texels of a present box over which the cone build's
# setup takes its least support depth (cone_boxes_plain); a face whose box
# spans more keeps that box
TIGHT_SPAN = 64


def sun_basis(sun3):
    """Orthonormal (e1, e2, s) float32 numpy vectors, s the unit sun."""
    s = np.asarray(sun3, np.float32)
    s = s / np.linalg.norm(s)
    a = np.array([1.0, 0.0, 0.0], np.float32)
    if abs(s[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0], np.float32)
    e1 = np.cross(s, a)
    e1 = (e1 / np.linalg.norm(e1)).astype(np.float32)
    e2 = np.cross(s, e1).astype(np.float32)
    return e1, e2, s


def _project_corners(b, size: int):
    """The world cube's eight corners projected on b, float32, each sum in
    the JAX order (the corner coordinates are 0 or size, so each product
    is exact)."""
    c = np.array([[x, y, z] for x in (0.0, size) for y in (0.0, size)
                  for z in (0.0, size)], np.float32)
    b = np.asarray(b, np.float32)
    return (c[:, 0] * b[0] + c[:, 1] * b[1]) + c[:, 2] * b[2]


def grid_frame(e1, e2, size: int, grid: int):
    """(a0, b0, ts) as float32 numpy scalars: the grid covers the world
    cube's projection with a margin of one unit (build_sun_grids
    :134-141)."""
    pa, pb = _project_corners(e1, size), _project_corners(e2, size)
    one = np.float32(1.0)
    a0 = pa.min() - one
    b0 = pb.min() - one
    ts = (np.maximum(pa.max() - a0, pb.max() - b0) + np.float32(2.0)) \
        / np.float32(grid)
    return np.float32(a0), np.float32(b0), np.float32(ts)


def _sel3(a, x, y, z):
    return torch.where(a == 0, x, torch.where(a == 1, y, z))


def _floor_int(x):
    return torch.clamp(torch.floor(x), -1e9, 1e9).to(torch.int64)


def world_zmin(s, size: int) -> np.float32:
    """The least depth along s of the world cube's corners (float32)."""
    return np.float32(_project_corners(s, size).min())


def coarse_side(grid: int) -> tuple[int, int]:
    """(cs, bfc): the cone build's support grid is cs^2 texels of bfc^2
    fine texels each (build_sun_grids :271-272)."""
    cs = min(COARSE, grid)
    return cs, grid // cs


def face_setup(faces, e1, e2, s, a0, b0, ts, grid: int, cone_tan=0.0,
               size: int | None = None):
    """Per-face quantities of the build, as a dict of (F,) tensors (the
    CUDA copy is vvr_sun_face). With cone_tan > 0 (the soft-shadow cone
    grids) the texel box grows by the face-level cone reach above the
    world's lowest depth, and the per-texel margins are formed in the
    build from rmu, rmv and gsum; `size` is then the world's side."""
    vx, vy, vz, axis, sgn, eu, ev, einfo = faces[:8]
    dev = vx.device

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    e1, e2, s = vec(e1), vec(e2), vec(s)
    s_a = _sel3(axis, s[0], s[1], s[2])
    occl = torch.where(sgn == 1, s_a < 0.0, s_a > 0.0) & (eu > 0)
    pc = (_sel3(axis, vx, vy, vz) + sgn).to(F32)
    euf, evf = eu.to(F32), ev.to(F32)
    ca, cb, cz = [], [], []
    for du in (0.0, 1.0):
        for dv in (0.0, 1.0):
            x = torch.where(axis == 0, pc, vx.to(F32) + du * euf)
            y = torch.where(axis == 1, pc, vy.to(F32) + torch.where(
                axis == 0, du * euf, dv * evf))
            z = torch.where(axis == 2, pc, vz.to(F32) + dv * evf)
            for out, b in ((ca, e1), (cb, e2), (cz, s)):
                out.append((x * b[0] + y * b[1]) + z * b[2])
    ca, cb, cz = (torch.stack(v, -1) for v in (ca, cb, cz))
    zmax = cz.amax(-1)
    if cone_tan > 0.0:
        wz = torch.tensor(world_zmin(s.cpu().numpy(), size), device=dev)
        grow = SAFE + cone_tan * torch.clamp((zmax - wz) + S_SLACK, min=0.0)
    else:
        grow = torch.tensor(SAFE, dtype=F32, device=dev)
    a0, b0, ts = (torch.tensor(v, dtype=F32, device=dev)
                  for v in (a0, b0, ts))

    def texel(x, lo):
        return torch.clamp(_floor_int((x - lo) / ts), 0, grid - 1)

    amin, amax, bmin, bmax = ca.amin(-1), ca.amax(-1), cb.amin(-1), \
        cb.amax(-1)
    r = {"occl": occl,
         "oi0": texel(amin - grow, a0), "oi1": texel(amax + grow, a0),
         "oj0": texel(bmin - grow, b0), "oj1": texel(bmax + grow, b0),
         "zmax": zmax, "zmin": cz.amin(-1)}
    p0a, p0b = ca[:, 0], cb[:, 0]
    ua, ub = ca[:, 2] - p0a, cb[:, 2] - p0b
    va, vb = ca[:, 1] - p0a, cb[:, 1] - p0b
    det = ua * vb - ub * va
    deg = det.abs() < 1e-12
    inv_det = torch.where(deg, 0.0, 1.0 / det)
    adet = torch.clamp(det.abs(), min=1e-12)
    z00 = cz[:, 0]
    zu, zv = cz[:, 2] - z00, cz[:, 1] - z00
    g_a = (vb * zu - ub * zv) * inv_det
    g_b = (ua * zv - va * zu) * inv_det
    rmu = sqrt32(va * va + vb * vb) / adet
    rmv = sqrt32(ua * ua + ub * ub) / adet
    gsum = g_a.abs() + g_b.abs()
    r.update(deg=deg, p0a=p0a, p0b=p0b, ua=ua, ub=ub, va=va, vb=vb,
             inv_det=inv_det, z00=z00, g_a=g_a, g_b=g_b, rmu=rmu, rmv=rmv,
             gsum=gsum, mu=grow * rmu, mv=grow * rmv, g_m=grow * gsum,
             xv0=(einfo & 1).to(F32) / evf,
             xv1=((einfo >> 1) & 1).to(F32) / evf)
    if cone_tan > 0.0:
        cs, bfc = coarse_side(grid)
        tsc = ts * bfc

        def coarse(x, lo):
            return torch.clamp(_floor_int((x - lo) / tsc), 0, cs - 1)

        r.update(si0=coarse(amin - S_PAD, a0), si1=coarse(amax + S_PAD, a0),
                 sj0=coarse(bmin - S_PAD, b0), sj1=coarse(bmax + S_PAD, b0))
    return r


def _pairs(cnt, lo_i, lo_j, width):
    """The (face, i, j) triples of boxes of cnt texels, width a row, from
    (lo_i, lo_j), in chunks of about PLAIN_CHUNK (bounds the plain build's
    memory)."""
    dev = cnt.device
    ends = torch.cumsum(cnt, 0)
    ends_h = ends.cpu().numpy()
    starts_h = ends_h - cnt.cpu().numpy()
    f0 = 0
    while f0 < len(ends_h):
        base = int(starts_h[f0])
        f1 = max(int(np.searchsorted(ends_h, base + PLAIN_CHUNK, "right")),
                 f0 + 1)
        fidx = torch.repeat_interleave(torch.arange(f0, f1, device=dev),
                                       cnt[f0:f1])
        f0 = f1
        if fidx.numel() == 0:
            continue
        local = (torch.arange(fidx.numel(), device=dev) + base
                 - (ends[fidx] - cnt[fidx]))
        yield (fidx, lo_i[fidx] + local % width[fidx],
               lo_j[fidx] + torch.div(local, width[fidx],
                                      rounding_mode="floor"))


def support_grid_plain(fs, a0, b0, ts, grid: int):
    """The cone build's support grid S (cs^2 f32, build_sun_grids
    :283-320): per coarse texel, the least depth over every face whose box
    grown by S_PAD covers it of the face's affine depth at the texel's
    corners, held at or above the face's own least depth (its least depth
    for an edge-on face); 3e38 where no face reaches."""
    dev = fs["zmin"].device
    cs, bfc = coarse_side(grid)
    tsc = torch.tensor(ts, dtype=F32, device=dev) * bfc
    a0, b0 = (torch.tensor(v, dtype=F32, device=dev) for v in (a0, b0))
    sw = fs["si1"] - fs["si0"] + 1
    cnt = (fs["sj1"] - fs["sj0"] + 1) * sw
    sg = torch.full((cs * cs,), 3e38, dtype=F32, device=dev)
    for fidx, ci, cj in _pairs(cnt, fs["si0"], fs["sj0"], sw):
        ta = a0 + ci.to(F32) * tsc
        tb = b0 + cj.to(F32) * tsc
        zmn = torch.full_like(ta, 3e38)
        p0a, p0b = fs["p0a"][fidx], fs["p0b"][fidx]
        z00, g_a, g_b = fs["z00"][fidx], fs["g_a"][fidx], fs["g_b"][fidx]
        for da_ in (0.0, 1.0):
            for db_ in (0.0, 1.0):
                da = (ta + da_ * tsc) - p0a
                db = (tb + db_ * tsc) - p0b
                zmn = torch.minimum(zmn, (z00 + da * g_a) + db * g_b)
        zmin = fs["zmin"][fidx]
        zv = torch.where(fs["deg"][fidx], zmin, torch.maximum(zmn, zmin))
        sg.scatter_reduce_(0, cj * cs + ci, zv, "amin")
    return sg


def cone_boxes_plain(fs, sg, a0, b0, ts, grid: int, cone_tan: float):
    """The cone build's tight texel boxes (oi0, oi1, oj0, oj1), (F,) each,
    from the per-face setup `fs` (face_setup with cone_tan) and the support
    grid `sg` (support_grid_plain); csrc/sunshadow.cu vvr_sun_tight_box is
    its CUDA copy.

    An occluder whose present box (grown from the world's least depth)
    spans at most TIGHT_SPAN coarse texels takes S_lo, the least S over
    them, and the grow SAFE + cone_tan * max(zmax - (S_lo - S_SLACK), 0):
    the per-texel expression with S_lo in place of the texel's S, so no
    texel of the present box has a larger margin. Its tight box is the
    present box cut to the texels whose corner (i, j) can pass the texel
    test at that margin: its (u, v) lies within the quad grown by the
    margin and by the texel's own (u, v) extent (and across the internal
    v edges, for gridB), mapped back to the (e1, e2) plane with one texel
    to spare on each side for rounding. The grown bbox of the quad alone
    would not do: a skewed parallelogram grown by a distance g reaches
    past its bbox grown by g at its acute corners, and the texel test
    compares the texel's (u, v) interval. Any other face keeps its
    present box. The grids are maxima over the pairs whose test passes,
    so these boxes give the present boxes' grids bit for bit."""
    dev = fs["zmax"].device
    cs, bfc = coarse_side(grid)
    a0t, b0t, tst = (torch.tensor(v, dtype=F32, device=dev)
                     for v in (a0, b0, ts))
    oi0, oi1, oj0, oj1 = (fs[k] for k in ("oi0", "oi1", "oj0", "oj1"))
    ci0, ci1 = (torch.clamp(x // bfc, max=cs - 1) for x in (oi0, oi1))
    cj0, cj1 = (torch.clamp(x // bfc, max=cs - 1) for x in (oj0, oj1))
    cw = ci1 - ci0 + 1
    span = cw * (cj1 - cj0 + 1)
    tight = fs["occl"] & ~fs["deg"] & (span <= TIGHT_SPAN)
    s_lo = torch.full_like(fs["zmax"], 3e38)
    for fidx, ci, cj in _pairs(torch.where(tight, span, 0), ci0, cj0, cw):
        s_lo.scatter_reduce_(0, fidx, sg[cj * cs + ci], "amin")
    grow = SAFE + cone_tan * torch.clamp(
        fs["zmax"] - (s_lo - S_SLACK), min=0.0)
    inv = fs["inv_det"].abs()
    hu = (tst * (fs["va"].abs() + fs["vb"].abs())) * inv
    hv = (tst * (fs["ua"].abs() + fs["ub"].abs())) * inv
    mu, mv = grow * fs["rmu"], grow * fs["rmv"]
    u_lo, u_hi = -(mu + hu), (1.0 + mu) + hu
    v_lo = -((mv + fs["xv0"]) + hv)
    v_hi = ((1.0 + mv) + fs["xv1"]) + hv

    def extent(p0, eu_, ev_, lo):
        a = torch.minimum(u_lo * eu_, u_hi * eu_)
        b = torch.minimum(v_lo * ev_, v_hi * ev_)
        c = torch.maximum(u_lo * eu_, u_hi * eu_)
        d = torch.maximum(v_lo * ev_, v_hi * ev_)
        return (_floor_int(((p0 + a) + b - lo) / tst) - 1,
                _floor_int(((p0 + c) + d - lo) / tst) + 1)

    i_lo, i_hi = extent(fs["p0a"], fs["ua"], fs["va"], a0t)
    j_lo, j_hi = extent(fs["p0b"], fs["ub"], fs["vb"], b0t)
    i_lo, i_hi = torch.maximum(oi0, i_lo), torch.minimum(oi1, i_hi)
    j_lo, j_hi = torch.maximum(oj0, j_lo), torch.minimum(oj1, j_hi)
    empty = (i_lo > i_hi) | (j_lo > j_hi)
    return tuple(torch.where(tight, torch.where(empty, e, t), lo)
                 for t, lo, e in ((i_lo, oi0, 0), (i_hi, oi1, -1),
                                  (j_lo, oj0, 0), (j_hi, oj1, -1)))


def pair_tests(fs, sg, a0, b0, ts, grid: int, cone_tan: float = 0.0):
    """The texel test of every (face, texel) pair of the occluders' boxes
    in `fs` (face_setup), in chunks (_pairs): yields (face, i, j, marks C,
    C value, marks B, B value), each (P,). With cone_tan > 0 the cone
    build's test, each texel's margins grown by the cone's reach above
    its support depth in `sg` (support_grid_plain)."""
    dev = fs["zmax"].device
    cone = cone_tan > 0.0
    if cone:
        cs, bfc = coarse_side(grid)
    a0, b0, tsf = (torch.tensor(v, dtype=F32, device=dev)
                   for v in (a0, b0, ts))
    bw = fs["oi1"] - fs["oi0"] + 1
    cnt = torch.where(fs["occl"], bw * (fs["oj1"] - fs["oj0"] + 1), 0)
    for fidx, i, j in _pairs(cnt, fs["oi0"], fs["oj0"], bw):
        f = {k: v[fidx] for k, v in fs.items()}
        if cone:
            s_t = sg[torch.clamp(j // bfc, max=cs - 1) * cs
                     + torch.clamp(i // bfc, max=cs - 1)]
            grow_t = SAFE + cone_tan * torch.clamp(
                f["zmax"] - (s_t - S_SLACK), min=0.0)
            mu, mv = grow_t * f["rmu"], grow_t * f["rmv"]
            g_m, g_bm = grow_t * f["gsum"], (grow_t - SAFE) * f["gsum"]
        else:
            mu, mv, g_m = f["mu"], f["mv"], f["g_m"]
        ta0 = a0 + i.to(F32) * tsf
        tb0 = b0 + j.to(F32) * tsf
        fully = ~f["deg"]
        zc_min = torch.full_like(ta0, 3e38)
        zc_max = torch.full_like(ta0, NEG)
        uvs = []
        for da_ in (0.0, 1.0):
            for db_ in (0.0, 1.0):
                da = (ta0 + da_ * tsf) - f["p0a"]
                db = (tb0 + db_ * tsf) - f["p0b"]
                uu = (da * f["vb"] - db * f["va"]) * f["inv_det"]
                vv = (f["ua"] * db - f["ub"] * da) * f["inv_det"]
                uvs.append((uu, vv))
                fully &= ((uu > mu) & (uu < 1.0 - mu)
                          & (vv > mv - f["xv0"])
                          & (vv < (1.0 - mv) + f["xv1"]))
                zc = (f["z00"] + da * f["g_a"]) + db * f["g_b"]
                zc_min = torch.minimum(zc_min, zc)
                zc_max = torch.maximum(zc_max, zc)
        zc_val = torch.where(f["deg"], f["zmax"],
                             torch.minimum(f["zmax"], zc_max + g_m))
        if cone:
            # possibly touching: the texel's corner interval meets the
            # quad grown by this texel's reach (build_sun_grids :426-432)
            uu = torch.stack([u for u, _ in uvs])
            vv = torch.stack([v for _, v in uvs])
            poss = f["deg"] | ((uu.amax(0) > -mu) & (uu.amin(0) < 1.0 + mu)
                               & (vv.amax(0) > -mv) & (vv.amin(0) < 1.0 + mv))
            zb_val = torch.minimum(zc_min - g_bm, f["zmax"])
        else:
            poss = torch.ones_like(fully)
            zb_val = torch.minimum(zc_min, f["zmax"])
        yield fidx, i, j, poss, zc_val, fully, zb_val


def sun_grids_plain(faces, e1, e2, s, size: int, grid: int = GRID,
                    cone_tan: float = 0.0, tight: bool = False):
    """Plain torch K11: (gBC (grid^2, 2) f32, a0, b0, ts). With cone_tan >
    0 the cone grids of soft shadows (build_sun_grids with cone_tan): each
    texel's margins grow by the cone's reach above the texel's support
    depth S, and a face marks gridC only where its quad grown by that
    reach may touch the texel. The faces' texel boxes are face_setup's,
    or with `tight` (the cone grids) the kernel's cone_boxes_plain, which
    give the same grids."""
    dev = faces[0].device
    a0, b0, ts = grid_frame(e1, e2, size, grid)
    fs = face_setup(faces, e1, e2, s, a0, b0, ts, grid, cone_tan, size)
    sg = None
    if cone_tan > 0.0:
        sg = support_grid_plain(fs, a0, b0, ts, grid)
        if tight:
            fs["oi0"], fs["oi1"], fs["oj0"], fs["oj1"] = cone_boxes_plain(
                fs, sg, a0, b0, ts, grid, cone_tan)
    g_b = torch.full((grid * grid,), NEG, dtype=F32, device=dev)
    g_c = torch.full((grid * grid,), NEG, dtype=F32, device=dev)
    for _, i, j, poss, zc_val, fully, zb_val in pair_tests(
            fs, sg, a0, b0, ts, grid, cone_tan):
        tex = j * grid + i
        g_c.scatter_reduce_(0, tex[poss], zc_val[poss], "amax")
        g_b.scatter_reduce_(0, tex[fully], zb_val[fully], "amax")
    return torch.stack([g_b, g_c], 1), a0, b0, ts


def sun_tiling(grid: int, cone: bool = False) -> tuple[int, int]:
    """K11's (tile side, bin side) in texels at `grid`^2: a CTA owns a
    tile, and a bin (a square of tiles) holds one face list; the bins are
    as small as SUN_MAX_BINS allows. The hard build takes 32-texel tiles
    at 1024^2 and above, 16 below, so the 512^2 build of a dragged sun
    still has a CTA for each of 1024 tiles; the cone build (`cone`) takes
    16-texel tiles at every size, since its busiest tiles hold 30-40
    times the mean tile's (face, texel) pairs and a CTA's time follows its
    tile's pairs."""
    tile = 32 if grid >= 1024 and not cone else 16
    tiles_x = -(-grid // tile)
    return tile, tile * -(-tiles_x // math.isqrt(SUN_MAX_BINS))


def sun_scratch_bytes(n_faces: int, grid: int, cone: bool = False) -> int:
    """Bytes of K11's scratch (csrc/sunshadow.cu vvr_sun_grids): per face
    a texel box (int4), a record (4 float4) and room for SUN_BIN_MAX + 1
    list entries (int4); a job (2 int4) per bin; a count per (list, block
    of SUN_FPB faces), int64, the lists being the bins, the coarse bins
    (SUN_COARSE bins a side) and the global list, with the scan's block
    sums and total. The cone build adds its support grid (cs^2 u32,
    rounded up to 16 bytes) in front."""
    bin_side = sun_tiling(grid, cone)[1]
    bins_x = -(-grid // bin_side)
    n_lists = bins_x ** 2 + (-(-bins_x // SUN_COARSE)) ** 2 + 1
    n_cnt = n_lists * max(-(-n_faces // SUN_FPB), 1)
    support = -(-4 * coarse_side(grid)[0] ** 2 // 16) * 16 if cone else 0
    return (support + 16 * n_faces * (5 + SUN_BIN_MAX + 1)
            + 32 * bins_x ** 2
            + 8 * (n_cnt + -(-n_cnt // 1024) + 1))


def sun_grids(faces, e1, e2, s, size: int, grid: int = GRID,
              cone_tan: float = 0.0):
    """Conservative shadow grids (gBC, a0, b0, ts) for sun basis (e1, e2,
    s) from the merged faces (FaceSet.device_tuple()): the hard grids, or
    with cone_tan > 0 (CONE_TAN) the cone grids of soft shadows. CUDA:
    K11 (with the cone, its support pass first, in the same entry point,
    and the cone build's tight boxes, cone_boxes_plain)."""
    if not kernels.on_cuda(faces[0]):
        return sun_grids_plain(faces, e1, e2, s, size, grid, cone_tan)
    if len(faces) < 8 or any(a.dtype != torch.int32 for a in faces[:8]):
        raise ValueError("faces must be FaceSet.device_tuple()")
    if not 1 <= grid <= 65535:
        raise ValueError(f"grid must lie in 1..65535, got {grid}")
    kernels.check_cuda(*faces[:8])
    dev = faces[0].device
    a0, b0, ts = grid_frame(e1, e2, size, grid)
    nf = faces[0].shape[0]
    cone = cone_tan > 0.0
    scratch = torch.empty(sun_scratch_bytes(nf, grid, cone),
                          dtype=torch.uint8, device=dev)
    gbc = torch.empty((grid * grid, 2), dtype=F32, device=dev)
    kernels.launch("sun_grids", dev, *(a.data_ptr() for a in faces[:8]), nf,
                   *(float(c) for v in (e1, e2, s) for c in v), float(a0),
                   float(b0), float(ts), grid, *sun_tiling(grid, cone),
                   float(cone_tan), float(world_zmin(s, size)) if cone
                   else 0.0, scratch.data_ptr(), gbc.data_ptr())
    return gbc, a0, b0, ts


# superbrick_groups' key of a superbrick (x, y, z), each of magnitude
# below 2^20: ordered as (x, y, z) lexicographically
_SB_KEY = np.array([1 << 42, 1 << 21, 1], np.int64)


def superbrick_groups(positions) -> tuple[np.ndarray, np.ndarray]:
    """(order, offsets): the (K, 3) int positions (coordinates of magnitude
    below 2^23) grouped by 8^3 superbrick without a Python loop. Group k,
    the k-th superbrick in np.unique's order (x, then y, then z), holds
    positions[order[offsets[k]:offsets[k + 1]]], in their given order;
    offsets has R + 1 entries for R superbricks."""
    pos = np.asarray(positions, np.int64).reshape(-1, 3)
    key = (pos >> 3) @ _SB_KEY
    order = key.argsort(kind="stable")
    if not len(pos):
        return order, np.zeros(1, np.int64)
    ks = key[order]
    return order, np.concatenate(
        ([0], np.flatnonzero(ks[1:] != ks[:-1]) + 1, [len(pos)]))


# a voxel's eight cube corners, x outermost
_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)], np.int64)


def texel_grow(size: int, cone_tan: float = 0.0) -> float:
    """The largest margin the sun grids' build applies (SAFE, and with
    cone_tan > 0 the cone's reach over the world's whole depth)."""
    return SAFE + (cone_tan * (size * math.sqrt(3.0) + S_SLACK)
                   if cone_tan > 0.0 else 0.0)


def texel_rects(e1, e2, positions, size: int, grid: int, a0, b0, ts,
                cone_tan: float = 0.0) -> np.ndarray:
    """(R, 4) int32 texel rectangles (i0, i1, j0, j1), inclusive, one per
    8^3 superbrick holding an edited voxel of `positions` ((K, 3) int x, y,
    z), in superbrick_groups' order: the projection of its edited voxels'
    cubes grown by texel_grow, plus a texel, clamped into the grid (a
    rectangle off the grid comes out empty: i0 > i1 or j0 > j1). Host
    float64, as vvr_tpu/ops/sunshadow.py:486-509 forms them, but each
    corner's projection is (x e_x + y e_y) + z e_z, every product and sum
    rounded on its own: the JAX function's BLAS product rounds in an order
    that depends on the CPU's kernel and the slice, K18 in this one."""
    pos = np.asarray(positions, np.int64).reshape(-1, 3)
    order, offsets = superbrick_groups(pos)
    if not len(order):
        return np.zeros((0, 4), np.int32)
    grow = texel_grow(size, cone_tan)
    tsf = float(ts)
    cs = (pos[order][:, None, :] + _CORNERS[None]).astype(np.float64)
    edges = []
    for e, origin in ((e1, a0), (e2, b0)):
        e = np.asarray(e, np.float64)
        p = (cs[..., 0] * e[0] + cs[..., 1] * e[1]) + cs[..., 2] * e[2]
        lo = np.minimum.reduceat(p.min(1), offsets[:-1])
        hi = np.maximum.reduceat(p.max(1), offsets[:-1])
        o = float(origin)
        edges += [np.clip(np.floor((lo - grow - o) / tsf) - 1, 0, grid),
                  np.clip(np.floor((hi + grow - o) / tsf) + 1, -1, grid - 1)]
    return np.stack(edges, 1).astype(np.int32)


def invalidate_texels_plain(gbc, rects: np.ndarray) -> None:
    """Plain torch K18's fill: (NEG, 3e38) into every texel of each
    rectangle of gBC (grid^2, 2), in place."""
    g = math.isqrt(gbc.shape[0])
    view = gbc.view(g, g, 2)
    for i0, i1, j0, j1 in np.asarray(rects).tolist():
        view[j0:j1 + 1, i0:i1 + 1, 0] = NEG
        view[j0:j1 + 1, i0:i1 + 1, 1] = 3e38


def invalidate_texels(gbc, e1, e2, positions, size: int, a0, b0, ts,
                      cone_tan: float = 0.0, want_rects: bool = False):
    """(NEG, 3e38) into every texel of texel_rects' rectangles of gBC
    (grid^2, 2) of basis (e1, e2) and frame (a0, b0, ts), in place, after
    edits at `positions` ((K, 3) int, each coordinate of magnitude below
    2^23). With `want_rects`, returns the (R, 4) int32 rectangles on gBC's
    device (else None). CPU: texel_rects, then invalidate_texels_plain.
    CUDA: K18's entry point groups the positions by superbrick on the host
    (in C++, in superbrick_groups' order), copies the groups once,
    non-blocking, from pinned memory (a ring of buffers, so the call
    waits for no earlier launch still queued), and launches K18 once,
    which forms the rectangles on the card, bit for bit as texel_rects
    does, and fills them; an edit without positions launches nothing."""
    g = math.isqrt(gbc.shape[0])
    if not kernels.on_cuda(gbc):
        rects = texel_rects(e1, e2, positions, size, g, a0, b0, ts,
                            cone_tan)
        invalidate_texels_plain(gbc, rects)
        return torch.from_numpy(rects) if want_rects else None
    kernels.check_cuda(gbc)
    if gbc.dtype != F32 or gbc.shape != (g * g, 2):
        raise ValueError("gBC must be float32 (grid^2, 2)")
    pos = np.ascontiguousarray(positions, np.int64).reshape(-1, 3)
    if not len(pos):                   # no superbrick: no launch
        return (torch.zeros((0, 4), dtype=torch.int32, device=gbc.device)
                if want_rects else None)
    rects = n_rects = None
    if want_rects:
        rects = torch.empty((len(pos), 4), dtype=torch.int32,
                            device=gbc.device)
        n_rects = np.zeros(1, np.int32)
    kernels.launch("invalidate_texels", gbc.device, gbc.data_ptr(), g,
                   pos.ctypes.data, len(pos), *map(float, e1),
                   *map(float, e2), float(a0), float(b0), float(ts),
                   texel_grow(size, cone_tan),
                   0 if rects is None else rects.data_ptr(),
                   0 if n_rects is None else n_rects.ctypes.data)
    return None if rects is None else rects[:int(n_rects[0])]


def invalidate_sun_texels(grids, e1, e2, positions, size: int,
                          cone_tan: float = 0.0):
    """Repair cached sun grids (gBC, a0, b0, ts) of basis (e1, e2) after
    edits at `positions`: every texel whose answer the edit could change
    becomes ambiguous, certain of neither shadow nor light (NEG, 3e38),
    so its lanes run the exact DDA against the patched grid; frames stay
    exact without rebuilding the grids. Any face the edit adds or removes
    registers only within the texel_rects rectangles, and every query
    reads its own ray's texel (the projection is invariant along s), so
    no query elsewhere can see the change. gBC is written in place
    (invalidate_texels: K18 on the card) and the grids are returned."""
    gbc, a0, b0, ts = grids
    invalidate_texels(gbc, e1, e2, positions, size, a0, b0, ts, cone_tan)
    return grids


def near_segment_plain(grid: JumpGrid, p_o, sun3, k: int = NEAR_K,
                       rows_read=None):
    """(hit, exited, t_end) of the first k voxel crossings from p_o along
    the sun (`_near_segment`): hit = entered solid within the segment;
    exited = left the world; t_end = the entry parameter of the last cell
    tested empty. The plain voxel step of the DDA, so a hit is the DDA's.
    `sun3` is one direction for every lane, or an (N, 3) tensor of them
    (the soft path's jittered samples). `rows_read` (as `trace_jump_plain`
    takes it) gets True at the row of every voxel the walk tests."""
    dev = p_o.device
    size, g = grid.size, grid.gsize
    rows = grid.rows.to(torch.int64) & MASK32
    o = p_o.to(F32)
    if isinstance(sun3, torch.Tensor):
        sun = sun3.to(device=dev, dtype=F32)
    else:
        sun = torch.as_tensor(np.asarray(sun3, np.float32), device=dev)
    big = 3e38
    inv = torch.where(sun == 0.0, big, 1.0 / sun)
    pos = (sun > 0).to(torch.int64)
    n = o.shape[0]
    v = torch.clamp(torch.floor(o), 0, size - 1).to(torch.int64)
    t = torch.zeros(n, dtype=F32, device=dev)
    t_end = torch.zeros(n, dtype=F32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    exited = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(k):
        addr = (v[:, 0] >> 3) + (v[:, 1] >> 3) * g + (v[:, 2] >> 3) * g * g
        if rows_read is not None:
            rows_read[0][addr[alive]] = True
        lc = v & 7
        solid = brick_solid(rows[addr], lc[:, 0], lc[:, 1], lc[:, 2])
        hit |= alive & solid
        alive &= ~solid
        t_end = torch.where(alive, t, t_end)
        b = v + pos
        tax = torch.where(sun == 0.0, big, (b.to(F32) - o) * inv)
        te = torch.minimum(tax[:, 0], torch.minimum(tax[:, 1], tax[:, 2]))
        nface = torch.where(tax[:, 2] <= te, 2,
                            torch.where(tax[:, 1] <= te, 1, 0))
        moved = torch.where(sun > 0, b, b - 1)
        nv = torch.where(torch.arange(3, device=dev) == nface[:, None],
                         moved, v)
        oob = ((nv < 0) | (nv >= size)).any(1)
        exited |= alive & oob
        step = alive & ~oob
        v = torch.where(step[:, None], nv, v)
        t = torch.where(step, te, t)
        alive = step
    return hit, exited, t_end


def _texel_rows(p, sun, e1, e2, grids, size: int):
    """(in world, depth along the sun, texel in the grid, its gBC row) of
    points p (N, 3): each projection summed left to right, the texel
    floor((q - origin) / ts) (row 0 off the grid)."""
    gbc, a0, b0, ts = grids
    g = math.isqrt(gbc.shape[0])
    dev = p.device
    sun, e1, e2 = (torch.as_tensor(np.asarray(v, np.float32), device=dev)
                   for v in (sun, e1, e2))
    a0, b0, ts = (torch.tensor(v, dtype=F32, device=dev)
                  for v in (a0, b0, ts))
    x, y, z = p.unbind(1)
    inw = ((p >= 0) & (p < size)).all(1)
    qa, qb, qz = ((x * b[0] + y * b[1]) + z * b[2] for b in (e1, e2, sun))
    i = _floor_int((qa - a0) / ts)
    j = _floor_int((qb - b0) / ts)
    ing = (i >= 0) & (i < g) & (j >= 0) & (j < g)
    return inw, qz, ing, gbc[torch.where(ing, j * g + i, 0)]


def soft_shadow_gate(s_base, sun3, e1, e2, grids, active, size: int,
                     fwd: float = SOFT_FWD):
    """(known hit, known miss), each (N,) bool, shared by every jittered
    sample of a soft-shadow lane (`soft_shadow_gate`, :771): from the
    cone grids, a surface point s_base whose depth plus `fwd` lies below
    its texel's B - SAFE is shadowed for every direction of the cone; one
    above C + SAFE is lit for all of them; a point outside the world is
    lit (the DDA's origin-outside rule). The plain version K14's gate
    mode runs per lane."""
    inw, qz, ing, row = _texel_rows(s_base, sun3, e1, e2, grids, size)
    inb = inw & ing
    kh = active & inb & (qz + fwd < row[:, 0] - SAFE)
    km = active & ~kh & ((inb & (qz > row[:, 1] + SAFE)) | ~inw)
    return kh, km


def surface_row_c(s_base, sun3, e1, e2, grids, size: int):
    """The cone gridC of each surface point's texel, 3e38 where the point
    projects off the grid (no claim): the bound near_walk_classify lifts
    a sample above (render/frame.py:410-423)."""
    _, _, ing, row = _texel_rows(s_base, sun3, e1, e2, grids, size)
    return torch.where(ing, row[:, 1], 3e38)


def near_walk_classify(grid: JumpGrid, p_o, p_d, row_c, sun3, size: int,
                       rows_read=None):
    """(known hit, known miss) of soft-shadow sample rays from p_o along
    their own directions p_d (N, 3) (`near_walk_classify`, :617): the
    first NEAR_K voxel crossings exactly (a hit there is the DDA's), then
    a miss is certain where the walk left the world or lifted the ray's
    depth above its surface texel's cone gridC row_c + SAFE (every later
    crossing would lie above every one the cone grids registered). A start
    outside the world is a miss. Lanes in neither run the DDA. `rows_read`
    as `near_segment_plain` takes it."""
    inw = ((p_o >= 0) & (p_o < size)).all(1)
    nh, nexit, t_end = near_segment_plain(grid, p_o, p_d,
                                          rows_read=rows_read)
    sun = torch.as_tensor(np.asarray(sun3, np.float32), device=p_o.device)
    ox, oy, oz = p_o.unbind(1)
    dx, dy, dz = p_d.unbind(1)
    lift = ((ox * sun[0] + oy * sun[1]) + oz * sun[2]) \
        + t_end * ((dx * sun[0] + dy * sun[1]) + dz * sun[2])
    kh = inw & nh
    km = ~inw | (inw & ~nh & (nexit | (lift > row_c + SAFE)))
    return kh, km


def certain(s_o, sun3, e1, e2, grids, size: int, back: float = BACK):
    """The two certainty tests of ray starts s_o (N, 3) toward the sun
    (`_certain`): (certain shadow, certain light, in world, depth along the
    sun, gridC row). Shadow is tested at s_o's depth, light at the depth
    `back` below it. Starts outside the world are never certain."""
    inw, qz, ing, row = _texel_rows(s_o, sun3, e1, e2, grids, size)
    inb = inw & ing
    shadow = inb & (qz < row[:, 0] - SAFE)
    light = inb & (qz - back > row[:, 1] + SAFE)
    return shadow, light, inw, qz, row[:, 1]


# the branch of K12 that answers a lane, in K12's order (shadow_branches)
BRANCHES = ("inactive", "outside", "buried", "certain shadow",
            "certain light", "near-walk hit", "exit", "lift", "residue")


def shadow_branches(grid: tracer.Grid, s_o, sun3, e1, e2, grids, active,
                    back: float = BACK, rows_read=None):
    """(N,) int64: for each lane, the index in BRANCHES of the test that
    answers it in K12: a start outside the world (light), a buried start
    (hit), certain shadow, certain light, then, on the jump grid, the near
    walk's hit, its exit from the world and its lift (light), and the
    residue the DDA answers (on the paged grid every lane left after the
    certainty tests: the JAX frame walks only the jump grid). `rows_read`
    (as `tracer.trace_plain` takes it) gets the rows K12's tests load: the
    start voxel's of each active lane in the world, the walk's."""
    shadow, light, inw, qz, row_c = certain(s_o, sun3, e1, e2, grids,
                                            grid.size, back)
    v = torch.clamp(torch.floor(s_o), 0, grid.size - 1).to(torch.int64)
    buried = tracer.solid(grid, v)
    if rows_read is not None:
        tracer.solid(grid, v[active & inw], rows_read)
    br = torch.zeros(s_o.shape[0], dtype=torch.int64, device=s_o.device)
    rest = active.clone()
    for code, cond in ((1, ~inw), (2, buried), (3, shadow), (4, light)):
        br[rest & cond] = code
        rest &= ~cond
    amb = torch.nonzero(rest)[:, 0]
    if not tracer.near_walk(grid):
        br[amb] = 8
        return br
    nh, nexit, t_end = near_segment_plain(grid, s_o[amb], sun3,
                                          rows_read=rows_read)
    lift = qz[amb] + t_end > row_c[amb] + SAFE
    br[amb] = torch.where(nh, 5, torch.where(nexit, 6,
                                             torch.where(lift, 7, 8)))
    return br


def masked_shadow_hits_plain(grid: tracer.Grid, s_o, sun3, e1, e2, grids,
                             active, max_steps: int, back: float = BACK,
                             rows_read=None):
    """Plain torch K12: (N,) bool shadow hits of the active lanes.
    `rows_read` (as `tracer.trace_plain` takes it) gets the rows K12
    loads."""
    br = shadow_branches(grid, s_o, sun3, e1, e2, grids, active, back,
                         rows_read)
    out = (br == 2) | (br == 3) | (br == 5)  # buried, certain, near-walk hit
    res = torch.nonzero(br == 8)[:, 0]       # the residue
    sun = torch.as_tensor(np.asarray(sun3, np.float32), device=s_o.device)
    dda = tracer.trace_plain(grid, s_o[res], sun, max_steps,
                             stats=False, rows_read=rows_read).hit
    out[res[dda]] = True
    return out


def masked_shadow_from_hits_plain(grid: tracer.Grid, o, d, hit, face,
                                  axis_coord, sun3, e1, e2, grids,
                                  max_steps: int, back: float = BACK,
                                  rows_read=None):
    """Plain torch version of the frame's K12 entry: K2 `shade_surface`'s
    starts, then the query on them (`rows_read` as
    `masked_shadow_hits_plain` takes it)."""
    sun = torch.as_tensor(np.asarray(sun3, np.float32))
    s_o, s_act = shade_surface_plain(o, d, hit, face, axis_coord, sun)
    return masked_shadow_hits_plain(grid, s_o, sun3, e1, e2, grids, s_act,
                                    max_steps, back, rows_read)


def _launch_k12(grid: tracer.Grid, lanes, n: int, sun3, e1, e2, grids,
                max_steps: int, back: float):
    """K12 over n lanes: `lanes` is (s_o, active) or the primary hits
    (o, d, hit, face, axis_coord)."""
    gbc, a0, b0, ts = grids
    if gbc.dtype != F32 or gbc.dim() != 2 or gbc.shape[1] != 2:
        raise ValueError("gBC must be (G^2, 2) float32")
    name, grid_args = tracer.kernel_args("masked_shadow", grid)
    kernels.check_cuda(*tracer.tensors(grid), gbc, *lanes)
    dev = gbc.device
    ptrs = [t.data_ptr() for t in lanes]
    ptrs = ptrs + [0] * 5 if len(ptrs) == 2 else [0, 0] + ptrs
    out = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch(name, dev, *grid_args, *ptrs, n,
                   *(float(c) for v in (sun3, e1, e2) for c in v),
                   gbc.data_ptr(), math.isqrt(gbc.shape[0]), float(a0),
                   float(b0), float(ts), float(back), max_steps,
                   out.data_ptr())
    return out


def masked_shadow_hits(grid: tracer.Grid, s_o, sun3, e1, e2, grids, active,
                       max_steps: int, back: float = BACK):
    """The hard-shadow query: (N,) bool, whether the ray from s_o
    (surface point + `back` along the sun) toward the sun hits, for the
    active lanes (False elsewhere). `sun3` is the frame's sun direction,
    (e1, e2) and `grids` come from sun_basis and sun_grids. Light
    certainty is tested at the surface's depth (s_o's minus `back`), so a
    crossing that buries s_o blocks the claim; a start whose own voxel is
    solid is a hit before any grid test, as in the DDA (the JAX version
    answers such a start from the grids, which is unsound for a start
    buried deeper than `back`: a camera inside solid). CUDA: K12."""
    if not kernels.on_cuda(s_o):
        return masked_shadow_hits_plain(grid, s_o, sun3, e1, e2, grids,
                                        active, max_steps, back)
    n = s_o.shape[0]
    if s_o.shape != (n, 3) or s_o.dtype != F32:
        raise ValueError("s_o must be (N, 3) float32")
    if active.dtype != torch.bool or active.shape != (n,):
        raise ValueError("active must be a (N,) bool tensor")
    return _launch_k12(grid, (s_o, active), n, sun3, e1, e2, grids,
                       max_steps, back)


def masked_shadow_from_hits(grid: tracer.Grid, o, d, hit, face, axis_coord,
                            sun3, e1, e2, grids, max_steps: int,
                            back: float = BACK):
    """The frame's hard-shadow query from its primary hits: the starts
    and mask of K2 `shade_surface` (surface + 0.05 along `sun3`, lanes
    whose face turns toward the sun), then `masked_shadow_hits` on them.
    CUDA: the same K12 kernel, which computes each start in registers, so
    the starts never reach device memory."""
    if not kernels.on_cuda(o):
        return masked_shadow_from_hits_plain(grid, o, d, hit, face,
                                             axis_coord, sun3, e1, e2,
                                             grids, max_steps, back)
    check_trace_inputs(o, d, hit, face, axis_coord)
    return _launch_k12(grid, (o, d, hit, face, axis_coord), o.shape[0],
                       sun3, e1, e2, grids, max_steps, back)
