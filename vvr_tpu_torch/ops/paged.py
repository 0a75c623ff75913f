"""Paged two-level traversal — kernel K16 (csrc/trace.cu).

Replaces vvr_tpu/ops/paged.py `trace_paged` (its `_make_stepper`,
`_make_ray`, `_init_state` and `_outputs`) over the paged grid of
world/paged.py. A ray is in one of four modes:

  waiting for its page row: a row whose octant radius is > 0 jumps the ray
      to the exit of the all-empty box of pages b .. b +- (radius - 1)
      (the ray keeps waiting, on the next page's row); a radius of 0
      latches the page's superbrick mask and pool base, and the ray walks
      the page;
  in the page: the current superbrick's bit of the mask; an occupied one
      sends the ray to its pool row, base + popcount(mask below the bit);
      an empty one steps the ray across the superbrick (8 voxels);
  waiting for its pool row: the row is loaded, and the ray is in a brick;
  in a brick: the voxel's bit (a hit ends the ray), then one voxel step,
      or one 2^3 subcell step when the row's subcell mask says it is
      empty. Leaving the brick within the page goes to the next brick's
      pool row if the mask has it, else back to the page walk; leaving the
      page waits for the next page's row.

Every move is the exit from an axis-aligned box [lo, hi] per axis (the
jump box, a superbrick, a subcell or a voxel), as in ops/jump.py: the
crossed axis lands on the next cell, the others on clip(floor(o + d*te),
lo, hi). The exit tests use the true world size (crossed axis only, or
every axis after a page jump, as the JAX stepper tests them).

The counters count work done, as the JAX stepper does: a slot that loads a
row (page or pool) counts one iteration and one fetch, a page-walk or
in-brick step one iteration, an in-brick step that leaves its brick one
missed pop; the cap `iterations >= max_steps` ends the ray after any of
them. So every schedule of a ray's events gives the same seven outputs,
and the port is held to the JAX tracer with compaction off (its cascade
repacks a lane with both rows to re-fetch, one more iteration).

The compaction cascade, `pack_first` and the `lax.cond` net of the JAX
version are TPU machinery and are not ported: one thread per ray, which
exits when its ray ends. On the card the page table and the pool (41 MiB
at 1024^3) fit in the H100's 50 MB L2; the flat grid's 256 MiB does not,
yet K1 on the flat grid traces config 5's view faster (PERF.md section 6).
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.jump import (BIG_T, MASK32, TraceResult, _directions,
                                    _exit_step, _floor_clip, _sel3,
                                    check_width, launch_trace)
from vvr_tpu_torch.world.occupancy import brick_solid
from vvr_tpu_torch.world.paged import PG, PagedGrid

# a ray's modes
PEND_PAGE, PAGE, PEND_POOL, BRICK = 0, 1, 2, 3


def popcount32(x):
    """Bits set in each int64 value below 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def mask_bit(mlo, mhi, bit):
    """Bit `bit` (0..63) of the 64-bit mask (mlo, mhi)."""
    word = torch.where(bit >= 32, mhi, mlo)
    return ((word >> (bit & 31)) & 1) == 1


def pool_offset(mlo, mhi, bit):
    """popcount(mask & ((1 << bit) - 1)) of the 64-bit mask (mlo, mhi):
    the pool row of superbrick `bit` past its page's base."""
    below_lo = torch.where(bit >= 32, MASK32,
                           (1 << torch.clamp(bit, max=31)) - 1)
    below_hi = torch.where(bit >= 32, (1 << torch.clamp(bit - 32, min=0)) - 1,
                           0)
    return popcount32(mlo & below_lo) + popcount32(mhi & below_hi)


def superbrick_bit(v):
    """The in-page bit of each voxel's superbrick, sx | sy<<2 | sz<<4."""
    s = (v >> 3) & 3
    return s[:, 0] | (s[:, 1] << 2) | (s[:, 2] << 4)


def page_of(v, p: int):
    """The page-table row of each voxel (N, 3)."""
    return (v[:, 0] >> 5) + (v[:, 1] >> 5) * p + (v[:, 2] >> 5) * p * p


def solid_plain(grid: PagedGrid, v, rows_read=None):
    """Whether each voxel v (N, 3) int64 of the world is solid: its page's
    mask, then its pool row's voxel bit. `rows_read` (as
    `trace_paged_plain` takes it) gets True at the rows the test loads."""
    page = page_of(v, grid.psize)
    prow = grid.prows[page].to(torch.int64) & MASK32
    bit = superbrick_bit(v)
    occ = mask_bit(prow[:, 0], prow[:, 1], bit)
    row = torch.where(occ, prow[:, 2] + pool_offset(prow[:, 0], prow[:, 1],
                                                    bit), 0)
    if rows_read is not None:
        rows_read[0][page] = True
        rows_read[1][row[occ]] = True
    words = grid.brows[row].to(torch.int64) & MASK32
    lc = v & 7
    return occ & brick_solid(words, lc[:, 0], lc[:, 1], lc[:, 2])


def trace_paged_plain(grid: PagedGrid, ray_o, ray_d, max_steps: int = 2048,
                      active=None, stats: bool = True,
                      rows_read=None) -> TraceResult:
    """Plain torch version of K16: per loop trip, on the compacted set of
    active rays, the JAX stepper's fetch slot (each ray waiting for a page
    or pool row loads it) and then its step (each ray in a page or a
    brick takes one). `rows_read`, a pair of bool tensors as long as the
    page table and the pool, gets True at every row the rays load (what a
    trace must read, for its bound)."""
    dev = ray_o.device
    n = ray_o.shape[0]
    size, p = grid.size, grid.psize
    prows = grid.prows.to(torch.int64) & MASK32
    brows = grid.brows
    o = ray_o.to(torch.float32)
    d = _directions(ray_d, n)
    inv = torch.where(d == 0.0, BIG_T, 1.0 / d)
    pos = d > 0
    pi = pos.to(torch.int64)
    oct_sh = 4 * (pi[:, 0] | (pi[:, 1] << 1) | (pi[:, 2] << 2))
    axes = torch.arange(3, device=dev)

    inside = ((o >= 0) & (o < size)).all(1)
    act = inside if active is None else inside & active.to(dev)
    v = torch.clamp(torch.floor(o), 0, size - 1).to(torch.int64)
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    face = torch.zeros(n, dtype=torch.int64, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    mode = torch.full((n,), PEND_PAGE, dtype=torch.int64, device=dev)
    mlo, mhi, base, pool = (torch.zeros(n, dtype=torch.int64, device=dev)
                            for _ in range(4))
    it = torch.zeros(n, dtype=torch.int64, device=dev)
    fe = torch.zeros_like(it)
    em = torch.zeros_like(it)

    def exit_box(r, lo, hi):
        """Move rays r out of their boxes [lo, hi]: (new cells, the crossed
        axis's coordinate after and before the move)."""
        pr = pos[r]
        bound = torch.where(pr, hi + 1, lo)
        te, nface = _exit_step(o[r], d[r], inv[r], bound)
        crossed = torch.where(pr, bound, bound - 1)
        fl = _floor_clip(o[r] + d[r] * te[:, None], lo, hi)
        nv = torch.where(axes == nface[:, None], crossed, fl)
        moved = nv.gather(1, nface[:, None])[:, 0]
        stayed = v[r].gather(1, nface[:, None])[:, 0]
        v[r] = nv
        t[r] = te
        face[r] = nface
        return nv, moved, stayed

    while True:
        idx = torch.nonzero(act)[:, 0]
        if idx.numel() == 0:
            break
        m = mode[idx]

        # ---- the fetch slot: page rows, then pool rows
        fi = idx[m == PEND_PAGE]
        page = page_of(v[fi], p)
        prow = prows[page]
        dval = (prow[:, 3] >> oct_sh[fi]) & 15
        ent = dval == 0
        e = fi[ent]
        mlo[e], mhi[e], base[e] = prow[ent, 0], prow[ent, 1], prow[ent, 2]
        mode[e] = PAGE
        ji = fi[~ent]
        if ji.numel():
            # the all-empty box of pages b .. b +- (dval - 1)
            dv = dval[~ent][:, None]
            b = v[ji] >> 5
            pj = pos[ji]
            lo = torch.where(pj, b * PG, (b - dv + 1) * PG)
            hi = torch.where(pj, (b + dv) * PG - 1, b * PG + PG - 1)
            nv, _, _ = exit_box(ji, lo, hi)
            act[ji[((nv < 0) | (nv >= size)).any(1)]] = False
        li = idx[m == PEND_POOL]
        mode[li] = BRICK
        if rows_read is not None:
            rows_read[0][page] = True
            rows_read[1][pool[li]] = True
        fi = torch.cat([fi, li])
        it[fi] += 1
        fe[fi] += 1
        act[fi[it[fi] >= max_steps]] = False

        # ---- the step: page walks, then bricks
        m = mode[idx]
        si = idx[act[idx] & ((m == PAGE) | (m == BRICK))]
        it[si] += 1
        pg = si[mode[si] == PAGE]
        bit = superbrick_bit(v[pg])
        occ = mask_bit(mlo[pg], mhi[pg], bit)
        enter = pg[occ]
        pool[enter] = base[enter] + pool_offset(mlo[enter], mhi[enter],
                                                bit[occ])
        mode[enter] = PEND_POOL
        sp = pg[~occ]
        lo_p = (v[sp] >> 3) << 3

        bi = si[mode[si] == BRICK]
        words = brows[pool[bi]].to(torch.int64) & MASK32
        lc = v[bi] & 7
        solid = brick_solid(words, lc[:, 0], lc[:, 1], lc[:, 2])
        hit[bi[solid]] = True
        act[bi[solid]] = False
        sb, lc, words = bi[~solid], lc[~solid], words[~solid]
        sbit = ((lc[:, 0] >> 1) | ((lc[:, 1] >> 1) << 2)
                | ((lc[:, 2] >> 1) << 4))
        sword = torch.where(sbit >= 32, words[:, 17], words[:, 16])
        big = (((sword >> (sbit & 31)) & 1) == 0)[:, None]
        vs = v[sb]
        lo_s = torch.where(big, (vs >> 1) << 1, vs)
        hi_s = torch.where(big, lo_s + 1, vs)

        r = torch.cat([sp, sb])
        nv, moved, stayed = exit_box(r, torch.cat([lo_p, lo_s]),
                                     torch.cat([lo_p + 7, hi_s]))
        ok = (moved >= 0) & (moved < size)
        left_brick = (moved >> 3) != (stayed >> 3)
        left_page = (moved >> 5) != (stayed >> 5)
        act[r[~ok]] = False
        k = sp.numel()
        mode[r[:k][ok[:k] & left_page[:k]]] = PEND_PAGE
        em[sb] += left_brick[k:].to(torch.int64)
        leave = ok[k:] & left_brick[k:]
        mode[sb[leave & left_page[k:]]] = PEND_PAGE
        wi = leave & ~left_page[k:]
        w = sb[wi]
        nbit = superbrick_bit(nv[k:][wi])
        n_occ = mask_bit(mlo[w], mhi[w], nbit)
        pool[w[n_occ]] = base[w[n_occ]] + pool_offset(
            mlo[w[n_occ]], mhi[w[n_occ]], nbit[n_occ])
        mode[w] = torch.where(n_occ, PEND_POOL, PAGE)
        act[si[it[si] >= max_steps]] = False

    axis_coord = _sel3(face, v[:, 0], v[:, 1], v[:, 2])
    i32 = torch.int32
    counters = ((it.to(i32), fe.to(i32), em.to(i32)) if stats
                else (None, None, None))
    return TraceResult(hit, face.to(i32),
                       torch.where(hit, axis_coord, 0).to(i32),
                       torch.where(hit, t, BIG_T), *counters)


def check_paged(grid: PagedGrid) -> None:
    """The tables' layout the kernels read: int32 bit patterns, 16-byte
    aligned (page rows load as one uint4, pool words 16-17 as a uint2)."""
    for name, tab in (("page table", grid.prows), ("pool", grid.brows)):
        if tab.dtype != torch.int32:
            raise ValueError(f"paged-grid {name} must be int32 (u32 bit "
                             "patterns)")
        if tab.data_ptr() % 16:
            raise ValueError(f"paged-grid {name} must be 16-byte aligned")


def trace_paged(grid: PagedGrid, ray_o, ray_d, max_steps: int = 2048,
                active=None, width: int | None = None,
                stats: bool = True) -> TraceResult:
    """Trace N rays (o: (N, 3) f32; d: (N, 3) f32, or (3,) for one
    direction of every ray) against the paged grid. CUDA tensors launch
    K16; CPU tensors run `trace_paged_plain`. The contract of
    ops/jump.py `trace_jump`: origins outside [0, size)^3 miss, a start in
    solid hits with face 0 and t 0, `max_steps` caps the counted events,
    `active` masks rays out, `width` traces an image's rows by 8x4 pixel
    tiles, `stats=False` leaves the counters out (None)."""
    check_width(ray_o.shape[0], width)
    if not kernels.on_cuda(ray_o):
        return trace_paged_plain(grid, ray_o, ray_d, max_steps, active,
                                 stats)
    check_paged(grid)
    return launch_trace("paged_trace", [grid.prows.data_ptr(),
                                        grid.brows.data_ptr(), grid.size,
                                        grid.psize],
                        [grid.prows, grid.brows], ray_o, ray_d, max_steps,
                        active, width, stats)
