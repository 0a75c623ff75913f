"""Distance-jump superbrick traversal — kernel K1 (csrc/trace.cu).

Replaces vvr_tpu/ops/jump.py `trace_jump` (its `_make_stepper`,
`_make_ray`, `_init_state` and `_outputs`). Each ray runs a flat DDA over
the jump grid's 128 B superbrick rows (world/jumpgrid.py): a load reads the
row of the superbrick the ray is in; a non-zero octant distance jumps the
ray to the exit plane of that all-empty box, a zero distance enters the
brick, where an 8^3 voxel DDA steps one voxel, or one 2^3 subcell when the
row's subcell mask says it is empty, until the ray hits or leaves.

Every sub-step is the exit from an axis-aligned box [lo, hi] per axis: the
jump box (superbricks b .. b +- (dval - 1) along the octant), an empty
subcell, or one voxel (lo = hi). The exit plane is hi + 1 on a positive
axis and lo on a negative one; the crossed axis lands on the next cell, the
others on clip(floor(o + d*te), lo, hi), which leaves a voxel step's cell
unchanged. So a trip of the loop is "load the row if the ray needs one,
then one box exit": the jump and the in-brick step are one body, and a load
that enters a brick goes on to its in-brick test in the same trip.

What bounds it on an H100: dependent loads and divergence, not bandwidth.
The 4 MiB row table of the 256^3 world sits in the 50 MB L2, and a ray's
next load depends on its last, so each thread waits on one L2 round trip
per load; neighbouring pixels walk the same bricks, so most in-brick word
reads hit L1. The kernel is one thread per ray with the ray's state in
registers; given the image width it gives each warp an 8x4 pixel tile, whose
rays walk more alike than a 32x1 row's. The compaction cascades and
`pack_first` nets of the JAX version exist for TPU lanes and are not
ported: a finished GPU thread simply exits.

The JAX version runs groups of one fetch slot plus five in-brick slots; a
lane that jumps idles until the next group. The counters count only work
done (a load counts one iteration and one fetch, an in-brick step one
iteration; `missed_pops` counts the in-brick steps that leave a brick), and
the cap is checked after every sub-step, so any schedule of each ray's
sub-steps gives the same (hit, face, axis_coord, t, iterations, fetches,
missed_pops), capped rays included (the tests hold it to the JAX version
with compaction off, where a repacked lane's re-fetch does not enter the
counters).
"""

from __future__ import annotations

import dataclasses

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.world.jumpgrid import SB, JumpGrid
from vvr_tpu_torch.world.occupancy import brick_solid

BIG_T = 1e30
MASK32 = 0xFFFFFFFF
TILE_W, TILE_H = 8, 4   # the pixels of one warp in a tiled launch


@dataclasses.dataclass
class TraceResult:
    hit: torch.Tensor          # bool (N,)
    face: torch.Tensor         # int32 (N,) axis of entry face: 0=x 1=y 2=z
    axis_coord: torch.Tensor   # int32 (N,) entry-plane block coordinate
    t: torch.Tensor            # f32 (N,) entry distance, BIG_T on a miss
    # the counters, None when the caller did not ask for them (stats=False)
    iterations: torch.Tensor | None   # int32 (N,) loads + in-brick steps
    fetches: torch.Tensor | None      # int32 (N,) superbrick rows loaded
    missed_pops: torch.Tensor | None  # int32 (N,) in-brick steps that
                                      # left a brick


def _sel3(face, x, y, z):
    return torch.where(face == 0, x, torch.where(face == 1, y, z))


def _floor_clip(x, lo, hi):
    """clip(int(floor(x)), lo, hi) as the CUDA copy computes it: a NaN
    floors to 0, an infinity to the nearer bound, so a box of one voxel
    (lo = hi) always gives lo."""
    fl = torch.nan_to_num(torch.floor(x), nan=0.0)
    return torch.minimum(torch.maximum(fl, lo.to(x.dtype)),
                         hi.to(x.dtype)).to(torch.int64)


def _exit_step(o, d, inv, bound):
    """(te, nface) of the nearest crossing of the per-axis `bound` planes
    (m, 3): t = (bound - o) * inv, BIG_T on zero-direction axes, z > y > x
    on ties."""
    tax = torch.where(d == 0.0, BIG_T, (bound.to(torch.float32) - o) * inv)
    te = torch.minimum(tax[:, 0], torch.minimum(tax[:, 1], tax[:, 2]))
    nface = torch.where(tax[:, 2] <= te, 2,
                        torch.where(tax[:, 1] <= te, 1, 0))
    return te, nface


def _directions(ray_d, n: int):
    """(N, 3) directions, or one (3,) direction for every ray."""
    if tuple(ray_d.shape) == (3,):
        return ray_d.to(torch.float32).expand(n, 3)
    if tuple(ray_d.shape) != (n, 3):
        raise ValueError(f"directions must be ({n}, 3) or (3,), got "
                         f"{tuple(ray_d.shape)}")
    return ray_d.to(torch.float32)


def tile_ray_index(width: int, height: int) -> torch.Tensor:
    """The ray each thread of a tiled K1 launch traces, -1 for none: the
    kernel's own index arithmetic. Warp w takes pixel tile w (8 wide, 4
    high, row-major over the tiles) and lane l its pixel (l % 8, l // 8);
    the rays stay row-major, so the outputs are where a flat launch puts
    them."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    i = torch.arange(tiles_x * tiles_y * TILE_W * TILE_H)
    tile, lane = i // (TILE_W * TILE_H), i % (TILE_W * TILE_H)
    x = tile % tiles_x * TILE_W + lane % TILE_W
    y = tile // tiles_x * TILE_H + lane // TILE_W
    return torch.where((x < width) & (y < height), y * width + x, -1)


def trace_jump_plain(grid: JumpGrid, ray_o, ray_d, max_steps: int = 2048,
                     active=None, stats: bool = True, on_trip=None,
                     rows_read=None) -> TraceResult:
    """Plain torch version of K1, in its form: per loop trip, on the
    compacted set of active rays, a ray waiting for a row loads it, and
    every ray that neither hit nor stopped then takes one box exit (its
    jump, or the in-brick step after its solid test). `on_trip(loaded,
    stepped)`, if given, sees each trip's work: the indices of the rays
    that loaded a row and of those that took an in-brick step
    (tools/lane_use.py counts the lanes of a warp's trips with it).
    `rows_read`, a 1-tuple of a bool tensor as long as the rows, gets True
    at every row the rays load (what a trace must read, for its bound)."""
    dev = ray_o.device
    n = ray_o.shape[0]
    size, g = grid.size, grid.gsize
    rows = grid.rows.to(torch.int64) & MASK32
    o = ray_o.to(torch.float32)
    d = _directions(ray_d, n)
    inv = torch.where(d == 0.0, BIG_T, 1.0 / d)
    pos = d > 0
    p = pos.to(torch.int64)
    octant = p[:, 0] | (p[:, 1] << 1) | (p[:, 2] << 2)
    axes = torch.arange(3, device=dev)

    inside = ((o >= 0) & (o < size)).all(1)
    act = inside if active is None else inside & active.to(dev)
    v = torch.clamp(torch.floor(o), 0, size - 1).to(torch.int64)
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    face = torch.zeros(n, dtype=torch.int64, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    pend = act.clone()
    cur = torch.zeros(n, dtype=torch.int64, device=dev)  # row of the brick

    def addr_of(vv):
        return (vv[:, 0] >> 3) + (vv[:, 1] >> 3) * g + (vv[:, 2] >> 3) * g * g

    addr = addr_of(v)
    it = torch.zeros(n, dtype=torch.int64, device=dev)
    fe = torch.zeros_like(it)
    em = torch.zeros_like(it)

    while True:
        idx = torch.nonzero(act)[:, 0]
        if idx.numel() == 0:
            break
        # ---- load the row of each ray that waits for one
        fi = idx[pend[idx]]
        if rows_read is not None:
            rows_read[0][addr[fi]] = True
        dval = rows[addr[fi], 24 + octant[fi]]
        it[fi] += 1
        fe[fi] += 1
        e = fi[dval == 0]
        pend[e] = False
        cur[e] = addr[e]
        act[e[it[e] >= max_steps]] = False  # the cap, between load and step
        ji = fi[dval > 0]
        dv = dval[dval > 0][:, None]

        # ---- in-brick: the solid test, then the box of the empty subcell
        # or of the voxel
        si = idx[~pend[idx] & act[idx]]
        if on_trip is not None:
            on_trip(fi, si)
        words = rows[cur[si]]
        vs = v[si]
        lc = vs & 7
        solid = brick_solid(words, lc[:, 0], lc[:, 1], lc[:, 2])
        it[si] += 1
        hit[si[solid]] = True
        act[si[solid]] = False
        si, vs, lc, words = si[~solid], vs[~solid], lc[~solid], words[~solid]
        sbit = ((lc[:, 0] >> 1) | ((lc[:, 1] >> 1) << 2)
                | ((lc[:, 2] >> 1) << 4))
        sword = torch.where(sbit >= 32, words[:, 18], words[:, 17])
        big = (((sword >> (sbit & 31)) & 1) == 0)[:, None]
        lo_s = torch.where(big, (vs >> 1) << 1, vs)
        hi_s = torch.where(big, lo_s + 1, vs)
        # the jump box: superbricks b .. b +- (dval - 1) along the octant
        b = v[ji] >> 3
        pj = pos[ji]
        lo_j = torch.where(pj, b * SB, (b - dv + 1) * SB)
        hi_j = torch.where(pj, (b + dv) * SB - 1, b * SB + SB - 1)

        # ---- one box exit for every ray that steps
        r = torch.cat([ji, si])
        lo = torch.cat([lo_j, lo_s])
        hi = torch.cat([hi_j, hi_s])
        pr = pos[r]
        bound = torch.where(pr, hi + 1, lo)
        te, nface = _exit_step(o[r], d[r], inv[r], bound)
        crossed = torch.where(pr, bound, bound - 1)
        fl = _floor_clip(o[r] + d[r] * te[:, None], lo, hi)
        nv = torch.where(axes == nface[:, None], crossed, fl)
        moved = nv.gather(1, nface[:, None])[:, 0]
        stayed = v[r].gather(1, nface[:, None])[:, 0]
        exited = (moved >> 3) != (stayed >> 3)   # every jump exits
        oob = ((nv < 0) | (nv >= size)).any(1)
        v[r] = nv
        t[r] = te
        face[r] = nface
        em[si] += exited[len(ji):].to(torch.int64)
        act[r[oob]] = False
        leave = exited & ~oob
        pend[r[leave]] = True
        addr[r[leave]] = addr_of(nv[leave])

        act[idx[it[idx] >= max_steps]] = False

    axis_coord = _sel3(face, v[:, 0], v[:, 1], v[:, 2])
    i32 = torch.int32
    counters = ((it.to(i32), fe.to(i32), em.to(i32)) if stats
                else (None, None, None))
    return TraceResult(hit, face.to(i32),
                       torch.where(hit, axis_coord, 0).to(i32),
                       torch.where(hit, t, BIG_T), *counters)


def trace_jump(grid: JumpGrid, ray_o, ray_d, max_steps: int = 2048,
               active=None, width: int | None = None,
               stats: bool = True) -> TraceResult:
    """Trace N rays (o: (N, 3) f32; d: (N, 3) f32, or (3,) for one
    direction of every ray) against the jump grid. CUDA tensors launch K1;
    CPU tensors run `trace_jump_plain`.

    Rays with an origin outside [0, size)^3 miss; a ray starting in a solid
    voxel hits with face 0 and t 0. `max_steps` caps loads plus in-brick
    sub-steps; `active` (N,) bool masks rays out. `width`: the rays are an
    image's pixels, row-major, `width` to a row; the kernel then gives
    each warp an 8x4 pixel tile (the outputs do not change). `stats=False`
    leaves the counters out (None): the kernel does not write them."""
    check_width(ray_o.shape[0], width)
    if not kernels.on_cuda(ray_o):
        return trace_jump_plain(grid, ray_o, ray_d, max_steps, active, stats)
    if grid.rows.dtype != torch.int32:
        raise ValueError("jump-grid rows must be int32 (u32 bit patterns)")
    if grid.rows.data_ptr() % 16:
        raise ValueError("jump-grid rows must be 16-byte aligned (the "
                         "kernel loads 4 words at a time)")
    return launch_trace("jump_trace", [grid.rows.data_ptr(), grid.size],
                        [grid.rows], ray_o, ray_d, max_steps, active, width,
                        stats)


def check_width(n: int, width: int | None) -> None:
    if width is not None and (width <= 0 or n % width):
        raise ValueError(f"{n} rays are not rows of width {width}")


def launch_trace(name: str, grid_args: list, tables: list, ray_o, ray_d,
                 max_steps: int, active, width: int | None,
                 stats: bool) -> TraceResult:
    """Launch the trace kernel `name` (K1 or K16, csrc/trace.cu) on CUDA
    rays: the grid's launch arguments `grid_args`, its device `tables`;
    the rest as `trace_jump`."""
    n = ray_o.shape[0]
    if ray_o.shape != (n, 3) or ray_d.shape not in ((n, 3), (3,)):
        raise ValueError(f"rays must be (N, 3) with (N, 3) or (3,) "
                         f"directions, got {tuple(ray_o.shape)} and "
                         f"{tuple(ray_d.shape)}")
    if ray_o.dtype != torch.float32 or ray_d.dtype != torch.float32:
        raise ValueError("rays must be float32")
    tensors = [*tables, ray_o, ray_d]
    if active is not None:
        if active.dtype != torch.bool or active.shape != (n,):
            raise ValueError("active must be a (N,) bool tensor")
        tensors.append(active)
    kernels.check_cuda(*tensors)
    dev = ray_o.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    face, axis_coord = (torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(2))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    counters = ([torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in range(3)] if stats else [None] * 3)
    kernels.launch(
        name, dev, *grid_args, ray_o.data_ptr(), ray_d.data_ptr(),
        3 if ray_d.dim() == 2 else 0,
        0 if active is None else active.data_ptr(), n, width or 0,
        max_steps, hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(),
        t.data_ptr(), *(0 if c is None else c.data_ptr() for c in counters))
    return TraceResult(hit, face, axis_coord, t, *counters)
