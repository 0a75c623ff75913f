"""Hierarchical DDA over the brick pyramid — kernel K19 (csrc/trace.cu).

Replaces vvr_tpu/ops/traverse.py `trace` (:406; its `_addr_fns` :131,
`_make_stepper` :156 with the fetch slot :179 and the ALU step :204,
`_init_state` :361 and `outputs` :495) over the pyramid of
world/pyramid.py. A ray starts at the root node (level `depth`), its
local cell the origin's, and each step of the walk tests the child cell
it is in:

  any bit and (level 1, or the full bit with `use_full`): a hit at the
      child's granularity;
  any bit: descend, the new node the child cell, its local cell the one
      at the ray's present point (o + d*t, truncated toward zero);
  empty: step to the next child cell along the ray (the exit plane of the
      present one, z > y > x on ties); a step out of the node ascends to
      the coarsest level whose boundary the step crossed (the trailing
      base-4 zero digits of the crossed coordinate) and loads that node;
      a step out of the world ends the ray.

A descend or an ascend makes the ray wait for its new node's row, which
the next trip loads (one fetch). The counters count work done, as the JAX
stepper does: `iterations` the steps (a trip's load is not one),
`fetches` the rows loaded, `missed_pops` the levels left on each node
exit (the ascend's a + 1). The cap `iterations >= max_steps` ends a ray
after any step. So every schedule of a ray's events gives the same seven
outputs, and the port is held to the JAX tracer with compaction off: its
cascade repacks a lane with its row to load again, one more fetch.

A node's any mask is 0 exactly when its bit in its parent's mask is 0
(world/pyramid.py), and the parent of a node the ray enters is a node it
descended through. So a walk that kept its ancestors' masks could answer
the root's fetch and an exit into a node whose bit is 0 without a load;
the plain version counts those fetches (`answered`). K19 loads every
fetch: answering them measured slower on the H100 (csrc/pyramid_dda.cuh).

A miss keeps the face of its last step (JAX `outputs` masks axis_coord and
t, not face): the normals heatmap shows it on sky pixels. A hit's
`axis_coord` is the entry plane's block coordinate of the hit cell, at
the far side of a coarse cell entered from its high side; a hit at t = 0
(a start inside solid) gives the origin's voxel.

Not ported, TPU machinery: the compaction cascade (:517-631), `pack_first`
and its `lax.cond` overflow net (:421-460), the grouped 64 B rows
(`_sel8`, `rows_grp`), the `fetch_every` / `phase1_groups` /
`pack_fraction` / `cascade` knobs and `start_level` / `start_cell` (no
caller passes them). One thread a ray, which exits when its ray ends.

Rounding: the descend's point `(o + d*t) * inv_g` is contracted by XLA's
jit into fma(d, t, o) (checked against the jitted JAX `trace` on rays
that land on cell boundaries); the kernel places __fmaf_rn there and the
plain version `_fma` (utils/hash.py). Everything else keeps the JAX op
order; the library is built with -fmad=false.
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.jump import (BIG_T, MASK32, TraceResult, _directions,
                                    _sel3, check_width, launch_trace)
from vvr_tpu_torch.ops.paged import popcount32
from vvr_tpu_torch.utils.hash import _fma
from vvr_tpu_torch.world.occupancy import bit64
from vvr_tpu_torch.world.pyramid import BrickPyramid

F32 = torch.float32
# what a ray's step does, the codes of trace_pyramid_plain's `trips`
PATHS = ("in-node step", "node exit", "descend", "hit", "left the world")


def node_addr(pyr: BrickPyramid, lvl, cx, cy, cz):
    """Row of node (cx, cy, cz) at level `lvl` (int64 tensors)."""
    bases = torch.tensor(pyr.bases, dtype=torch.int64, device=lvl.device)
    g = pyr.size >> (2 * lvl)
    return bases[lvl] + cx + cy * g + cz * g * g


def trace_pyramid_plain(pyr: BrickPyramid, ray_o, ray_d,
                        max_steps: int = 512, active=None,
                        stats: bool = True, use_full: bool = True,
                        rows_read=None, answered=None,
                        trips=None) -> TraceResult:
    """Plain torch version of K19: per loop trip, on the compacted set of
    active rays, each ray waiting for a node row loads it, then every ray
    takes one step of the walk (module docstring). `use_full`: the FULL
    early-out (the full masks of the rows), as JAX `trace`'s default; the
    frame walks the any masks only. `rows_read`, a 1-tuple of a bool
    tensor as long as the rows, gets True at every row the rays load.
    `answered`, a 1-tuple of an int64 tensor as long as the rows, gets one
    at a row for each fetch of it that the masks the ray holds answer: the
    root's, and a node's whose bit in its parent's any mask is 0.
    `trips`, a list, gets a record of each trip: the active rays'
    indices, whether each loaded a row in it and the index in PATHS of
    its step."""
    dev = ray_o.device
    n = ray_o.shape[0]
    size, depth = pyr.size, pyr.depth
    o = ray_o.to(F32)
    d = _directions(ray_d, n)
    inv = torch.where(d == 0.0, BIG_T, 1.0 / d)
    sgn = torch.where(d > 0, 1, -1).to(torch.int64)
    pos = (d > 0).to(torch.int64)
    axes = torch.arange(3, device=dev)

    inside = ((o >= 0) & (o < size)).all(1)
    act = inside if active is None else inside & active.to(dev)
    i64 = dict(dtype=torch.int64, device=dev)
    node = torch.zeros((n, 3), **i64)
    lvl = torch.full((n,), depth, **i64)
    inv_root = 1.0 / (1 << (2 * (depth - 1)))
    loc = torch.clamp((o * inv_root).to(torch.int64), 0, 3)
    t = torch.zeros(n, dtype=F32, device=dev)
    face = torch.zeros(n, **i64)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hlvl = torch.ones(n, **i64)
    pend = act.clone()
    addr = node_addr(pyr, lvl, node[:, 0], node[:, 1], node[:, 2])
    words = 4 if use_full else 2
    mask = torch.zeros((n, words), **i64)
    it = torch.zeros(n, **i64)
    fe = torch.zeros_like(it)
    em = torch.zeros_like(it)

    while True:
        idx = torch.nonzero(act)[:, 0]
        if idx.numel() == 0:
            break
        # ---- the fetch slot
        fi = idx[pend[idx]]
        if rows_read is not None:
            rows_read[0][addr[fi]] = True
        if answered is not None:
            ai = addr[fi][_answered(pyr, lvl[fi], node[fi])]
            answered[0].index_add_(0, ai, torch.ones_like(ai))
        mask[fi] = pyr.rows[addr[fi], :words].to(torch.int64) & MASK32
        fe[fi] += 1
        loaded = pend[idx].clone() if trips is not None else None
        pend[fi] = False

        # ---- one step of every active ray
        lv, nd, lc, tt = lvl[idx], node[idx], loc[idx], t[idx]
        m = mask[idx]
        bit = lc[:, 0] | (lc[:, 1] << 2) | (lc[:, 2] << 4)
        abit = bit64(m[:, 0], m[:, 1], bit)
        leaf = lv == 1
        if use_full:
            hit_now = abit & (leaf | bit64(m[:, 2], m[:, 3], bit))
        else:
            hit_now = abit & leaf
        desc = abit & ~hit_now
        stepping = ~abit

        # descend: the child cell becomes the node, the local cell that
        # of the point o + d*t in grandchild units
        dn = nd * 4 + lc
        inv_g = (1.0 / (1 << (2 * torch.clamp(lv - 2, min=0)))).to(F32)
        p = _fma(d[idx], tt[:, None].expand(-1, 3), o[idx])
        dl = torch.clamp((p * inv_g[:, None]).to(torch.int64) - dn * 4, 0, 3)

        # step: the exit plane of the present child cell
        cs = (1 << (2 * (lv - 1))).to(F32)
        bound = (dn + pos[idx]).to(F32) * cs[:, None]
        tax = torch.where(d[idx] == 0.0, BIG_T, (bound - o[idx]) * inv[idx])
        t_exit = torch.minimum(tax[:, 0], torch.minimum(tax[:, 1],
                                                        tax[:, 2]))
        nface = torch.where(tax[:, 2] <= t_exit, 2,
                            torch.where(tax[:, 1] <= t_exit, 1, 0))
        sl = lc + torch.where(axes == nface[:, None], sgn[idx], 0)
        inside_node = ((sl >= 0) & (sl <= 3)).all(1)
        gc = nd * 4 + sl
        gsz = size >> (2 * (lv - 1))
        oob = ((gc < 0) | (gc >= gsz[:, None])).any(1)
        crossed = gc.gather(1, nface[:, None])[:, 0]
        ssign = sgn[idx].gather(1, nface[:, None])[:, 0]
        cross_c = torch.where(ssign > 0, crossed, crossed + 1)
        # ascend a levels: the trailing base-4 zero digits of cross_c >> 2,
        # its trailing zero bits popcount((x & -x) - 1) (32 for 0), capped
        # at the root
        cur = (cross_c >> 2) & MASK32
        ctz = popcount32(((cur & -cur) - 1) & MASK32)
        a = torch.minimum(ctz >> 1, depth - lv)
        an = gc >> (2 * (a + 1))[:, None]
        al = (gc >> (2 * a)[:, None]) & 3
        exit_node = stepping & ~inside_node & ~oob
        trans = desc | exit_node
        if trips is not None:
            trips.append((idx, loaded, torch.where(
                hit_now, 3, torch.where(desc, 2, torch.where(
                    stepping & oob, 4, torch.where(exit_node, 1, 0))))))

        tlvl = torch.where(desc, torch.clamp(lv - 1, min=1), lv + a)
        tn = torch.where(desc[:, None], dn, an)
        hit[idx] |= hit_now
        act[idx] &= ~hit_now & ~(stepping & oob)
        pend[idx] |= trans
        ti = idx[trans]
        addr[ti] = node_addr(pyr, tlvl[trans], *tn[trans].unbind(1))
        node[ti] = tn[trans]
        lvl[ti] = tlvl[trans]
        loc[idx] = torch.where(
            desc[:, None], dl,
            torch.where(exit_node[:, None], al,
                        torch.where(stepping[:, None], sl, lc)))
        t[idx] = torch.where(stepping, t_exit, tt)
        face[idx] = torch.where(stepping, nface, face[idx])
        hlvl[idx] = torch.where(hit_now, lv, hlvl[idx])
        it[idx] += 1
        em[idx] += torch.where(exit_node, a + 1, 0)
        act[idx[it[idx] >= max_steps]] = False

    # outputs: the hit cell's entry-plane coordinate at its level
    hl = torch.clamp(hlvl - 1, min=0)
    cc = _sel3(face, *(node * 4 + loc).unbind(1))
    vsz = 1 << (2 * hl)
    neg = _sel3(face, *sgn.unbind(1)) < 0
    axis_coord = cc * vsz + torch.where(neg, vsz - 1, 0)
    sv = _sel3(face, *torch.clamp(o.to(torch.int64), 0, size - 1).unbind(1))
    axis_coord = torch.where(t == 0.0, sv, axis_coord)
    i32 = torch.int32
    counters = ((it.to(i32), fe.to(i32), em.to(i32)) if stats
                else (None, None, None))
    return TraceResult(hit, face.to(i32),
                       torch.where(hit, axis_coord, 0).to(i32),
                       torch.where(hit, t, BIG_T), *counters)


def _answered(pyr: BrickPyramid, lvl, node):
    """Whether each fetch of node `node` (int64 (K, 3)) at level `lvl`
    is answered without a load: the node is the root, or its bit in its
    parent's any mask is 0."""
    up = torch.clamp(lvl + 1, max=pyr.depth)
    parent = node_addr(pyr, up, *(node >> 2).unbind(1))
    m = pyr.rows[parent, :2].to(torch.int64) & MASK32
    child = node & 3
    bit = child[:, 0] | (child[:, 1] << 2) | (child[:, 2] << 4)
    return (lvl == pyr.depth) | ~bit64(m[:, 0], m[:, 1], bit)


def check_pyramid(pyr: BrickPyramid) -> None:
    """The table's layout the kernels read: int32 bit patterns, (R, 4),
    16-byte aligned (a row loads as one uint2 or uint4)."""
    if pyr.rows.dtype != torch.int32 or pyr.rows.dim() != 2 \
            or pyr.rows.shape[1] != 4:
        raise ValueError("pyramid rows must be (R, 4) int32 (u32 bit "
                         "patterns)")
    if pyr.rows.data_ptr() % 16:
        raise ValueError("pyramid rows must be 16-byte aligned")


def trace_pyramid(pyr: BrickPyramid, ray_o, ray_d, max_steps: int = 512,
                  active=None, width: int | None = None,
                  stats: bool = True, use_full: bool = True) -> TraceResult:
    """Trace N rays (o: (N, 3) f32; d: (N, 3) f32, or (3,) for one
    direction of every ray) against the brick pyramid. CUDA tensors launch
    K19; CPU tensors run `trace_pyramid_plain`. The contract of
    ops/jump.py `trace_jump` (origins outside the world miss, `active`,
    `width`'s 8x4 tiles, `stats=False` leaves the counters out), with
    `max_steps` capping the walk's steps and `use_full` the FULL
    early-out (the frame passes False, as the JAX frame does)."""
    check_width(ray_o.shape[0], width)
    if not kernels.on_cuda(ray_o):
        return trace_pyramid_plain(pyr, ray_o, ray_d, max_steps, active,
                                   stats, use_full)
    check_pyramid(pyr)
    return launch_trace("pyramid_trace",
                        [pyr.rows.data_ptr(), pyr.size, pyr.depth,
                         int(use_full)],
                        [pyr.rows], ray_o, ray_d, max_steps, active, width,
                        stats)
