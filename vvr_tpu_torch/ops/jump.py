"""Distance-jump superbrick traversal — kernel K1 (csrc/jump_trace.cu).

Replaces vvr_tpu/ops/jump.py `trace_jump` (its `_make_stepper`,
`_make_ray`, `_init_state` and `_outputs`). Each ray runs a flat DDA over
the jump grid's 128 B superbrick rows (world/jumpgrid.py): a fetch reads the
row of the superbrick the ray is in; a non-zero octant distance jumps the
ray to the exit plane of that all-empty box, a zero distance enters the
brick, where an 8^3 voxel DDA steps one voxel, or one 2^3 subcell when the
row's subcell mask says it is empty, until the ray hits or leaves.

What bounds it on an H100: dependent loads and divergence, not bandwidth.
The 4 MiB row table of the 256^3 world sits in the 50 MB L2, and a ray's
next fetch depends on its last, so each thread waits on one L2 round trip
per fetch; neighbouring pixels walk the same bricks, so most in-brick word
reads hit L1. The kernel is one thread per ray with the ray's state in
registers and the brick's occupancy words read through the read-only
cache on demand, instead of the TPU design's 512-bit mask held in vector
registers. The compaction cascades and `pack_first` nets of the JAX
version exist for TPU lanes and are not ported: a finished GPU thread
simply exits.

The JAX version runs groups of one fetch slot plus five in-brick slots; a
lane that jumps idles until the next group. The counters count only work
done, so a loop that takes each ray's next step at once gives the same
(hit, face, axis_coord, t, iterations, fetches, missed_pops), capped rays
included (the tests hold it to the JAX version with compaction off, where
a repacked lane's re-fetch does not enter the counters).
"""

from __future__ import annotations

import dataclasses

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.world.jumpgrid import SB, JumpGrid
from vvr_tpu_torch.world.occupancy import brick_solid

BIG_T = 1e30
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class TraceResult:
    hit: torch.Tensor          # bool (N,)
    face: torch.Tensor         # int32 (N,) axis of entry face: 0=x 1=y 2=z
    axis_coord: torch.Tensor   # int32 (N,) entry-plane block coordinate
    t: torch.Tensor            # f32 (N,) entry distance, BIG_T on a miss
    iterations: torch.Tensor   # int32 (N,) fetches + in-brick sub-steps
    fetches: torch.Tensor      # int32 (N,) superbrick rows fetched
    missed_pops: torch.Tensor  # int32 (N,) in-brick steps that left a brick


def _sel3(face, x, y, z):
    return torch.where(face == 0, x, torch.where(face == 1, y, z))


def _floor_clip(x, lo, hi):
    """clip(int(floor(x)), lo, hi), clamping in float first so that an
    out-of-range float never reaches the int conversion (the CUDA copy
    does the same)."""
    return torch.minimum(torch.maximum(torch.floor(x), lo.to(x.dtype)),
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


def trace_jump_plain(grid: JumpGrid, ray_o, ray_d, max_steps: int = 2048,
                     active=None) -> TraceResult:
    """Plain torch version of K1: every active ray takes its next sub-step
    (a fetch when it waits for a row, an in-brick step otherwise) per loop
    iteration, on the compacted set of active rays."""
    dev = ray_o.device
    n = ray_o.shape[0]
    size, g = grid.size, grid.gsize
    rows = grid.rows.to(torch.int64) & MASK32
    o = ray_o.to(torch.float32)
    d = ray_d.to(torch.float32)
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
        fi = idx[pend[idx]]
        si = idx[~pend[idx]]

        # ---- fetch: the pending superbrick row
        dval = rows[addr[fi], 24 + octant[fi]]
        it[fi] += 1
        fe[fi] += 1
        ent = dval == 0
        e = fi[ent]
        pend[e] = False
        cur[e] = addr[e]
        j = fi[~ent]
        dv = dval[~ent][:, None]
        vj = v[j]
        b = vj >> 3
        pj = pos[j]
        ex = torch.where(pj, (b + dv) * SB, (b - dv + 1) * SB)
        te, nface = _exit_step(o[j], d[j], inv[j], ex)
        lo = torch.where(pj, b * SB, (b - dv + 1) * SB)
        hi = torch.where(pj, (b + dv) * SB - 1, b * SB + SB - 1)
        crossed = torch.where(pj, ex, ex - 1)
        fl = _floor_clip(o[j] + d[j] * te[:, None], lo, hi)
        nv = torch.where(axes == nface[:, None], crossed, fl)
        oob = ((nv < 0) | (nv >= size)).any(1)
        v[j] = nv
        t[j] = te
        face[j] = nface
        addr[j] = addr_of(nv)
        act[j[oob]] = False

        # ---- in-brick step: solid test, then a voxel or subcell step
        words = rows[cur[si]]
        vs = v[si]
        lc = vs & 7
        solid = brick_solid(words, lc[:, 0], lc[:, 1], lc[:, 2])
        it[si] += 1
        hit[si[solid]] = True
        act[si[solid]] = False
        s = si[~solid]
        vs, lc, words = vs[~solid], lc[~solid], words[~solid]
        sbit = ((lc[:, 0] >> 1) | ((lc[:, 1] >> 1) << 2)
                | ((lc[:, 2] >> 1) << 4))
        sword = torch.where(sbit >= 32, words[:, 18], words[:, 17])
        big = (((sword >> (sbit & 31)) & 1) == 0)[:, None]
        ps = p[s]
        bnd = torch.where(big, ((vs >> 1) + ps) << 1, vs + ps)
        te, nface = _exit_step(o[s], d[s], inv[s], bnd)
        crossed = torch.where(pos[s], bnd, bnd - 1)
        base = (vs >> 1) << 1
        fl = _floor_clip(o[s] + d[s] * te[:, None], base, base + 1)
        nv = torch.where(axes == nface[:, None], crossed,
                         torch.where(big, fl, vs))
        moved = nv.gather(1, nface[:, None])[:, 0]
        stayed = vs.gather(1, nface[:, None])[:, 0]
        exited = (moved >> 3) != (stayed >> 3)
        oob = (moved < 0) | (moved >= size)
        v[s] = nv
        t[s] = te
        face[s] = nface
        em[s] += exited.to(torch.int64)
        act[s[oob]] = False
        leave = s[exited & ~oob]
        pend[leave] = True
        addr[leave] = addr_of(v[leave])

        act[idx[it[idx] >= max_steps]] = False

    axis_coord = _sel3(face, v[:, 0], v[:, 1], v[:, 2])
    i32 = torch.int32
    return TraceResult(
        hit=hit, face=face.to(i32),
        axis_coord=torch.where(hit, axis_coord, 0).to(i32),
        t=torch.where(hit, t, BIG_T),
        iterations=it.to(i32), fetches=fe.to(i32), missed_pops=em.to(i32))


def trace_jump(grid: JumpGrid, ray_o, ray_d, max_steps: int = 2048,
               active=None) -> TraceResult:
    """Trace N rays (o, d: (N, 3) f32) against the jump grid. CUDA tensors
    launch K1; CPU tensors run `trace_jump_plain`.

    Rays with an origin outside [0, size)^3 miss; a ray starting in a solid
    voxel hits with face 0 and t 0. `max_steps` caps fetches plus in-brick
    sub-steps; `active` (N,) bool masks rays out."""
    if not kernels.on_cuda(ray_o):
        return trace_jump_plain(grid, ray_o, ray_d, max_steps, active)
    n = ray_o.shape[0]
    if ray_o.shape != (n, 3) or ray_d.shape != (n, 3):
        raise ValueError(f"rays must be (N, 3), got {tuple(ray_o.shape)} "
                         f"and {tuple(ray_d.shape)}")
    if ray_o.dtype != torch.float32 or ray_d.dtype != torch.float32:
        raise ValueError("rays must be float32")
    if grid.rows.dtype != torch.int32:
        raise ValueError("jump-grid rows must be int32 (u32 bit patterns)")
    tensors = [grid.rows, ray_o, ray_d]
    if active is not None:
        if active.dtype != torch.bool or active.shape != (n,):
            raise ValueError("active must be a (N,) bool tensor")
        tensors.append(active)
    kernels.check_cuda(*tensors)
    dev = ray_o.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    ints = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(5)]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face, axis_coord, iters, fetches, missed = ints
    kernels.launch(
        "jump_trace", dev, grid.rows.data_ptr(), grid.size,
        ray_o.data_ptr(), ray_d.data_ptr(),
        0 if active is None else active.data_ptr(), n, max_steps,
        hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(), t.data_ptr(),
        iters.data_ptr(), fetches.data_ptr(), missed.data_ptr())
    return TraceResult(hit, face, axis_coord, t, iters, fetches, missed)
