"""Sun-space hard-shadow classifier — kernels K11 `sun_grids` and K12
`masked_shadow` (csrc/sunshadow.cu).

Replaces vvr_tpu/ops/sunshadow.py for hard shadows: `sun_basis` (:83),
`build_sun_grids` (:112) with cone_tan 0 and `masked_shadow_hits` (:654)
with its `_certain` (:525) and `_near_segment` (:536). The cone grids of
soft shadows, `classify`, `soft_shadow_gate`, `near_walk_classify` and
`invalidate_sun_texels` wait for ROADMAP A9 and A12.

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
is still ambiguous runs the jump-grid DDA. The answer equals the DDA's for
every lane whose DDA ends within its step cap.

The frame calls `masked_shadow_from_hits` with its primary hits: on the
card K12 computes each lane's start and mask from them in registers, with
K2 `shade_surface`'s code (csrc/surface.cuh), so the frame launches no
`shade_surface` and the starts never reach device memory.

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
from vvr_tpu_torch.ops.jump import trace_jump_plain
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


def grid_frame(e1, e2, size: int, grid: int):
    """(a0, b0, ts) as float32 numpy scalars: the grid covers the world
    cube's projection with a margin of one unit (build_sun_grids
    :134-141; the corner coordinates are 0 or size, so each product is
    exact and the sums are taken in the JAX order)."""
    c = np.array([[x, y, z] for x in (0.0, size) for y in (0.0, size)
                  for z in (0.0, size)], np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    pa = (c[:, 0] * e1[0] + c[:, 1] * e1[1]) + c[:, 2] * e1[2]
    pb = (c[:, 0] * e2[0] + c[:, 1] * e2[1]) + c[:, 2] * e2[2]
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


def face_setup(faces, e1, e2, s, a0, b0, ts, grid: int):
    """Per-face quantities of the hard-shadow build, as a dict of (F,)
    tensors (the CUDA copy is vvr_sun_face)."""
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
    grow = torch.tensor(SAFE, dtype=F32, device=dev)
    a0, b0, ts = (torch.tensor(v, dtype=F32, device=dev)
                  for v in (a0, b0, ts))

    def texel(x, lo):
        return torch.clamp(_floor_int((x - lo) / ts), 0, grid - 1)

    r = {"occl": occl,
         "oi0": texel(ca.amin(-1) - grow, a0),
         "oi1": texel(ca.amax(-1) + grow, a0),
         "oj0": texel(cb.amin(-1) - grow, b0),
         "oj1": texel(cb.amax(-1) + grow, b0),
         "zmax": cz.amax(-1)}
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
    r.update(deg=deg, p0a=p0a, p0b=p0b, ua=ua, ub=ub, va=va, vb=vb,
             inv_det=inv_det, z00=z00, g_a=g_a, g_b=g_b,
             mu=grow * (sqrt32(va * va + vb * vb) / adet),
             mv=grow * (sqrt32(ua * ua + ub * ub) / adet),
             g_m=grow * (g_a.abs() + g_b.abs()),
             xv0=(einfo & 1).to(F32) / evf,
             xv1=((einfo >> 1) & 1).to(F32) / evf)
    return r


def sun_grids_plain(faces, e1, e2, s, size: int, grid: int = GRID):
    """Plain torch K11: (gBC (grid^2, 2) f32, a0, b0, ts)."""
    dev = faces[0].device
    a0, b0, ts = grid_frame(e1, e2, size, grid)
    fs = face_setup(faces, e1, e2, s, a0, b0, ts, grid)
    tsf = torch.tensor(ts, dtype=F32, device=dev)
    bw = fs["oi1"] - fs["oi0"] + 1
    cnt = torch.where(fs["occl"], bw * (fs["oj1"] - fs["oj0"] + 1), 0)
    g_b = torch.full((grid * grid,), NEG, dtype=F32, device=dev)
    g_c = torch.full((grid * grid,), NEG, dtype=F32, device=dev)
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
        i = fs["oi0"][fidx] + local % bw[fidx]
        j = fs["oj0"][fidx] + torch.div(local, bw[fidx],
                                        rounding_mode="floor")
        f = {k: v[fidx] for k, v in fs.items()}
        ta0 = a0 + i.to(F32) * tsf
        tb0 = b0 + j.to(F32) * tsf
        fully = ~f["deg"]
        zc_min = torch.full_like(ta0, 3e38)
        zc_max = torch.full_like(ta0, NEG)
        for da_ in (0.0, 1.0):
            for db_ in (0.0, 1.0):
                da = (ta0 + da_ * tsf) - f["p0a"]
                db = (tb0 + db_ * tsf) - f["p0b"]
                uu = (da * f["vb"] - db * f["va"]) * f["inv_det"]
                vv = (f["ua"] * db - f["ub"] * da) * f["inv_det"]
                fully &= ((uu > f["mu"]) & (uu < 1.0 - f["mu"])
                          & (vv > f["mv"] - f["xv0"])
                          & (vv < (1.0 - f["mv"]) + f["xv1"]))
                zc = (f["z00"] + da * f["g_a"]) + db * f["g_b"]
                zc_min = torch.minimum(zc_min, zc)
                zc_max = torch.maximum(zc_max, zc)
        tex = j * grid + i
        zc_val = torch.where(f["deg"], f["zmax"],
                             torch.minimum(f["zmax"], zc_max + f["g_m"]))
        g_c.scatter_reduce_(0, tex, zc_val, "amax")
        g_b.scatter_reduce_(0, tex[fully],
                            torch.minimum(zc_min, f["zmax"])[fully], "amax")
    return torch.stack([g_b, g_c], 1), a0, b0, ts


def sun_grids(faces, e1, e2, s, size: int, grid: int = GRID):
    """Conservative hard-shadow grids (gBC, a0, b0, ts) for sun basis
    (e1, e2, s) from the merged faces (FaceSet.device_tuple()). CUDA:
    K11."""
    if not kernels.on_cuda(faces[0]):
        return sun_grids_plain(faces, e1, e2, s, size, grid)
    if len(faces) < 8 or any(a.dtype != torch.int32 for a in faces[:8]):
        raise ValueError("faces must be FaceSet.device_tuple()")
    kernels.check_cuda(*faces[:8])
    dev = faces[0].device
    a0, b0, ts = grid_frame(e1, e2, size, grid)
    nf = faces[0].shape[0]
    scratch = torch.empty(nf + (nf + 1023) // 1024 + 1, dtype=torch.int64,
                          device=dev)
    gbc = torch.empty((grid * grid, 2), dtype=F32, device=dev)
    kernels.launch("sun_grids", dev, *(a.data_ptr() for a in faces[:8]), nf,
                   *(float(c) for v in (e1, e2, s) for c in v), float(a0),
                   float(b0), float(ts), grid, scratch.data_ptr(),
                   gbc.data_ptr())
    return gbc, a0, b0, ts


def near_segment_plain(grid: JumpGrid, p_o, sun3, k: int = NEAR_K):
    """(hit, exited, t_end) of the first k voxel crossings from p_o along
    the sun (`_near_segment`): hit = entered solid within the segment;
    exited = left the world; t_end = the entry parameter of the last cell
    tested empty. The plain voxel step of the DDA, so a hit is the DDA's."""
    dev = p_o.device
    size, g = grid.size, grid.gsize
    rows = grid.rows.to(torch.int64) & MASK32
    o = p_o.to(F32)
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


def certain(s_o, sun3, e1, e2, grids, size: int, back: float = BACK):
    """The two certainty tests of ray starts s_o (N, 3) toward the sun
    (`_certain`): (certain shadow, certain light, in world, depth along the
    sun, gridC row). Shadow is tested at s_o's depth, light at the depth
    `back` below it. Starts outside the world are never certain."""
    gbc, a0, b0, ts = grids
    g = math.isqrt(gbc.shape[0])
    dev = s_o.device

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    sun, e1, e2 = vec(sun3), vec(e1), vec(e2)
    a0, b0, ts = (torch.tensor(v, dtype=F32, device=dev)
                  for v in (a0, b0, ts))
    ox, oy, oz = s_o.unbind(1)
    inw = ((s_o >= 0) & (s_o < size)).all(1)
    qa, qb, qz = ((ox * b[0] + oy * b[1]) + oz * b[2] for b in (e1, e2, sun))
    i = _floor_int((qa - a0) / ts)
    j = _floor_int((qb - b0) / ts)
    inb = inw & (i >= 0) & (i < g) & (j >= 0) & (j < g)
    row = gbc[torch.where(inb, j * g + i, 0)]
    shadow = inb & (qz < row[:, 0] - SAFE)
    light = inb & (qz - back > row[:, 1] + SAFE)
    return shadow, light, inw, qz, row[:, 1]


# the branch of K12 that answers a lane, in K12's order (shadow_branches)
BRANCHES = ("inactive", "outside", "buried", "certain shadow",
            "certain light", "near-walk hit", "exit", "lift", "residue")


def shadow_branches(grid: JumpGrid, s_o, sun3, e1, e2, grids, active,
                    back: float = BACK):
    """(N,) int64: for each lane, the index in BRANCHES of the test that
    answers it in K12: a start outside the world (light), a buried start
    (hit), certain shadow, certain light, then the near walk's hit, its
    exit from the world and its lift (light), and the residue the DDA
    answers."""
    shadow, light, inw, qz, row_c = certain(s_o, sun3, e1, e2, grids,
                                            grid.size, back)
    v = torch.clamp(torch.floor(s_o), 0, grid.size - 1).to(torch.int64)
    g = grid.gsize
    words = grid.rows[(v[:, 0] >> 3) + (v[:, 1] >> 3) * g
                      + (v[:, 2] >> 3) * g * g].to(torch.int64) & MASK32
    buried = brick_solid(words, v[:, 0] & 7, v[:, 1] & 7, v[:, 2] & 7)
    br = torch.zeros(s_o.shape[0], dtype=torch.int64, device=s_o.device)
    rest = active.clone()
    for code, cond in ((1, ~inw), (2, buried), (3, shadow), (4, light)):
        br[rest & cond] = code
        rest &= ~cond
    amb = torch.nonzero(rest)[:, 0]
    nh, nexit, t_end = near_segment_plain(grid, s_o[amb], sun3)
    lift = qz[amb] + t_end > row_c[amb] + SAFE
    br[amb] = torch.where(nh, 5, torch.where(nexit, 6,
                                             torch.where(lift, 7, 8)))
    return br


def masked_shadow_hits_plain(grid: JumpGrid, s_o, sun3, e1, e2, grids,
                             active, max_steps: int, back: float = BACK):
    """Plain torch K12: (N,) bool shadow hits of the active lanes."""
    br = shadow_branches(grid, s_o, sun3, e1, e2, grids, active, back)
    out = (br == 2) | (br == 3) | (br == 5)  # buried, certain, near-walk hit
    res = torch.nonzero(br == 8)[:, 0]       # the residue
    sun = torch.as_tensor(np.asarray(sun3, np.float32), device=s_o.device)
    dda = trace_jump_plain(grid, s_o[res], sun, max_steps, stats=False).hit
    out[res[dda]] = True
    return out


def masked_shadow_from_hits_plain(grid: JumpGrid, o, d, hit, face,
                                  axis_coord, sun3, e1, e2, grids,
                                  max_steps: int, back: float = BACK):
    """Plain torch version of the frame's K12 entry: K2 `shade_surface`'s
    starts, then the query on them."""
    sun = torch.as_tensor(np.asarray(sun3, np.float32))
    s_o, s_act = shade_surface_plain(o, d, hit, face, axis_coord, sun)
    return masked_shadow_hits_plain(grid, s_o, sun3, e1, e2, grids, s_act,
                                    max_steps, back)


def _launch_k12(grid: JumpGrid, lanes, n: int, sun3, e1, e2, grids,
                max_steps: int, back: float):
    """K12 over n lanes: `lanes` is (s_o, active) or the primary hits
    (o, d, hit, face, axis_coord)."""
    gbc, a0, b0, ts = grids
    if gbc.dtype != F32 or gbc.dim() != 2 or gbc.shape[1] != 2:
        raise ValueError("gBC must be (G^2, 2) float32")
    kernels.check_cuda(grid.rows, gbc, *lanes)
    dev = gbc.device
    ptrs = [t.data_ptr() for t in lanes]
    ptrs = ptrs + [0] * 5 if len(ptrs) == 2 else [0, 0] + ptrs
    out = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch("masked_shadow", dev, grid.rows.data_ptr(), grid.size,
                   *ptrs, n, *(float(c) for v in (sun3, e1, e2) for c in v),
                   gbc.data_ptr(), math.isqrt(gbc.shape[0]), float(a0),
                   float(b0), float(ts), float(back), max_steps,
                   out.data_ptr())
    return out


def masked_shadow_hits(grid: JumpGrid, s_o, sun3, e1, e2, grids, active,
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


def masked_shadow_from_hits(grid: JumpGrid, o, d, hit, face, axis_coord,
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
