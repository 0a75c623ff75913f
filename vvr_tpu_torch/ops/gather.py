"""Random row gathers, the microbenchmark of the traversal's fetch cost —
kernels K5-K8 (csrc/gather.cu).

The JAX package chose its traversal layouts (blocked fine grid, paged
grid, coarse sun level) from six Pallas microbenchmarks that measured a
per-lane random row fetch on a TPU. Each wrapper here replaces some of
them, on one design for an H100:

  gather_chain         K5  pallas_take (tools/microbench_gather.py:92) and
                           pallas_tala (tools/microbench_gather2.py:69):
                           8 dependent row gathers per lane, the table in
                           device memory; a thread walks one or two lanes'
                           chains interleaved and fetches each lane's
                           whole row (16-byte loads where 4 | cols), as the
                           TPU kernel's row take does; the floor mod
                           without a division (floor_mod_magic).
  gather_chain_shared  K6  pallas_vreg (tools/microbench_gather.py:133): the
                           same chain with the table in shared memory, the
                           counterpart of VMEM or of one vreg; each block
                           copies the table once and walks many lanes.
  gather_onehot        K7  pallas_onehot (tools/microbench_gather.py:177,
                           u32; tools/microbench_gather2.py:112, i32): the
                           chain where each gather is a one-hot bf16 product
                           with the table's u8 planes on the tensor cores
                           (wgmma m64nNk16, N = 4 cols, the one-hot from
                           registers, the planes loaded once per CTA by
                           TMA; every k tile of every row), decoded back
                           to the 32-bit word.
  gather_rows          K8  pallas_scalar (tools/microbench_gather.py:228):
                           one un-chained row gather, out[i] = T[idx[i]];
                           a thread a row where the row is one 16-, 8- or
                           4-byte vector, else a warp per 32 rows moving
                           them as such vectors; the index and its floor
                           mod once per row.

What bounds them on an H100: K5, K6 and K8 move a few MB (the indices, the
outputs, the table once), a few microseconds at 3.35 TB/s; what they
measure is the latency of dependent fetches from L2 or shared memory, which
no bandwidth bound sees, so their roofline shares are low by design. K5's
whole-row fetches move 8 * lanes * 4*cols bytes through L2 (1.07 GB a call
at 16 columns), which the bound of its HBM bytes does not count either.
K8's single gather is a microsecond of device work, so a call is bound by
its launch and the host's path in front of it (kernels.launch). K7 is
bound by its tensor-core work, 2 * lanes * rows * 4*cols per step, which
at (4096, 2) and (512, 16) is 2^40 operations for 2^21 lanes (about 1.1
ms at the bf16 dense peak); at 8 plane columns a wgmma is 4 clocks of an
SM's tensor cores, and the wgmma issue of a warpgroup, which waits for
each batch before it builds the next one-hot fragment, sets K7's pace
(csrc/gather.cu, K7).

The chain is the reference's: r = T[idx, 0]; acc += r (mod 2^32);
idx = (int32(r) ^ idx) mod rows, with jnp's floor mod, so a table word
of 2^31 or more (a negative int32) still gives an index in [0, rows). The
starting index is taken mod rows the same way, in the plain versions and
the kernels alike, so no index reads outside the table. The plain versions
do the arithmetic in int64 masked to 32 bits (torch's uint32 has no add,
mod or shift).
K5 and K7 take that floor mod without a division: a mask where rows is a
power of two, else Lemire, Kaser and Kurz's direct remainder with the
magic number floor_mod_magic(rows) passed from here; floor_mod_twin is
the same arithmetic in numpy, which the CPU tests hold to torch.remainder.

Tables are uint32 tensors, (rows, cols) or, for pallas_vreg's table,
(rows,); indices are int32 (N,). On the CPU each wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vvr_tpu_torch import kernels

CHAIN = 8                       # dependent gathers per lane (the reference's)
SHARED_BYTES = 232448           # shared memory one block can use on an H100
ONEHOT_BLOCK_BYTES = 64 << 20   # largest one-hot block of the plain K7
MASK32 = 0xFFFFFFFF
U32, I32, I64 = torch.uint32, torch.int32, torch.int64


def _u32_values(t: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 of the same values, through an int32 view
    (torch implements few operations for uint32)."""
    return t.view(I32).to(I64) & MASK32


def _to_32(x: torch.Tensor, dtype=U32) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> the same 32 bits as `dtype`
    (uint32 or int32)."""
    out = torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)
    return out.view(dtype)


def _next_index(r: torch.Tensor, idx: torch.Tensor, rows: int):
    """(int32(r) ^ idx) mod rows with a floor mod; r holds u32 values."""
    s = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return torch.remainder(s ^ idx, rows)


def _start(idx: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.remainder(idx.to(I64), rows)


# ---------------------------------------------------------------------------
# the floor mod of K5 and K7 (csrc/gather.cu FloorMod), host side
# ---------------------------------------------------------------------------

MASK64 = (1 << 64) - 1


def floor_mod_magic(rows: int) -> int:
    """M = ceil(2^64 / rows) mod 2^64, the launch argument of K5 and K7
    (rows in [1, 2^31)); rows 1 gives 0."""
    if not 1 <= rows < 1 << 31:
        raise ValueError(f"rows {rows} outside [1, 2^31)")
    return (MASK64 // rows + 1) & MASK64


def floor_mod_twin(x: np.ndarray, rows: int) -> np.ndarray:
    """The kernels' x mod rows (floor) on int32 values, step for step:
    x & (rows - 1) for a power of two; else u = x + 2^31 as u32, u mod rows
    = hi64((M * u mod 2^64) * rows) (the product split in 32-bit halves as
    __umul64hi takes it), less 2^31 mod rows got the same way, plus rows
    where negative. Returns int64."""
    x = np.asarray(x, np.int32)
    if rows & (rows - 1) == 0:
        return (x & np.int32(rows - 1)).astype(np.int64)
    magic = np.uint64(floor_mod_magic(rows))
    d = np.uint64(rows)
    lo32 = np.uint64(0xFFFFFFFF)

    def mod_u32(a: np.ndarray) -> np.ndarray:
        low = magic * a                          # mod 2^64
        hi = (low >> np.uint64(32)) * d
        return (hi + (((low & lo32) * d) >> np.uint64(32))) >> np.uint64(32)

    with np.errstate(over="ignore"):
        u = (x.view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
        bias = mod_u32(np.array([1 << 31], np.uint64))
        r = mod_u32(u).astype(np.int64) - bias.astype(np.int64)
    return np.where(r < 0, r + rows, r)


# ---------------------------------------------------------------------------
# K7's launch plan
# ---------------------------------------------------------------------------

ONEHOT_ALIGN = 1024             # the planes' alignment in shared memory
# most k tiles a batch (between a wgmma fence and its wait), by plane
# columns: more where a wgmma carries little work; a batch is the largest
# power of two up to it that divides rows / 16
ONEHOT_KB = {8: 8, 16: 4, 32: 2, 64: 2}


@dataclasses.dataclass(frozen=True)
class OnehotPlan:
    """What K7's wrapper computes for (rows, cols4) planes and passes to
    the kernel, which checks it."""
    kb: int              # k tiles a batch
    box_rows: int        # rows a TMA box (a power of two dividing rows)
    smem: int            # shared memory bytes a CTA: the planes, their
    #                      alignment and the mbarrier


def onehot_plan(rows: int, cols4: int) -> OnehotPlan:
    """K7's launch plan; raises where K7 does not take the shape (rows a
    multiple of 16, 8, 16, 32 or 64 plane columns, the planes and their
    alignment within SHARED_BYTES)."""
    if rows < 16 or rows % 16 or cols4 not in ONEHOT_KB:
        raise ValueError(f"K7 takes rows a multiple of 16 and 8, 16, 32 or "
                         f"64 plane columns, got ({rows}, {cols4})")
    smem = rows * cols4 * 2 + ONEHOT_ALIGN + 8
    if smem > SHARED_BYTES:
        raise ValueError(f"planes ({rows}, {cols4}) take {smem} B with their "
                         f"alignment and mbarrier, more than the "
                         f"{SHARED_BYTES} B of shared memory of a block")
    kb = min(ONEHOT_KB[cols4], (rows // 16) & -(rows // 16))
    return OnehotPlan(kb=kb, box_rows=min(256, rows & -rows), smem=smem)


def u8_planes(table: torch.Tensor) -> torch.Tensor:
    """(rows, cols) uint32 -> (rows, 4*cols) bf16 planes: column 4c + b is
    byte b of word c (microbench_gather.py:187-188); 0-255 is exact in
    bf16."""
    t = _u32_values(table)
    planes = torch.stack([(t >> (8 * b)) & 0xFF for b in range(4)], -1)
    return planes.reshape(table.shape[0], -1).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gather_chain_plain(table: torch.Tensor, idx: torch.Tensor):
    """(N,) uint32: the sum of the CHAIN words fetched by each lane. Only
    word 0 of a row enters the chain."""
    rows = table.shape[0]
    col0 = _u32_values(table if table.dim() == 1 else table[:, 0])
    i = _start(idx, rows)
    acc = torch.zeros_like(i)
    for _ in range(CHAIN):
        r = col0[i]
        acc = (acc + r) & MASK32
        i = _next_index(r, i, rows)
    return _to_32(acc)


def gather_onehot_plain(planes: torch.Tensor, idx: torch.Tensor,
                        out_dtype=U32):
    """The chain through the one-hot product in float32: each step is
    onehot(idx) @ planes, decoded from plane columns 0-3. Lanes go in
    chunks whose one-hot block is at most ONEHOT_BLOCK_BYTES."""
    rows = planes.shape[0]
    p = planes.to(torch.float32)
    start = _start(idx, rows)
    iota = torch.arange(rows, device=planes.device)
    chunk = max(1, ONEHOT_BLOCK_BYTES // (4 * rows))
    out = torch.empty_like(start)
    for a in range(0, start.shape[0], chunk):
        i = start[a:a + chunk]
        acc = torch.zeros_like(i)
        for _ in range(CHAIN):
            onehot = (iota[None, :] == i[:, None]).to(torch.float32)
            b = (onehot @ p)[:, :4].to(I64)
            r = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
            acc = (acc + r) & MASK32
            i = _next_index(r, i, rows)
        out[a:a + chunk] = acc
    return _to_32(out, out_dtype)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor):
    """(N, cols) rows of the table, T[idx mod rows]."""
    return table.view(I32)[_start(idx, table.shape[0])].view(table.dtype)


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch K5-K8, CPU tensors run the plain versions
# ---------------------------------------------------------------------------

def _check(table: torch.Tensor, idx: torch.Tensor, dtype, dims):
    """What the kernels need of their inputs, and no more: the dtypes and
    dims they index by, contiguous tensors on the table's CUDA device, a
    table on a 16-byte boundary (vector loads) with a row or more and fewer
    than 2^31 words (32-bit offsets). Returns the table's address, its
    shape and the number of lanes."""
    shape, lanes = table.shape, idx.shape
    if table.dtype != dtype or len(shape) not in dims \
            or idx.dtype != I32 or len(lanes) != 1:
        raise ValueError(f"table must be {dtype} with {dims} dims and idx "
                         f"(N,) int32, got {table.dtype} {tuple(shape)} and "
                         f"{idx.dtype} {tuple(idx.shape)}")
    kernels.check_cuda(table, idx)
    ptr = table.data_ptr()
    if ptr % 16:
        raise ValueError("the table must start on a 16-byte boundary")
    if shape[0] < 1 or table.numel() >= 1 << 31:
        raise ValueError(f"table of {shape[0]} rows, {table.numel()} words")
    return ptr, shape, lanes[0]


def _cols(table: torch.Tensor) -> int:
    return 1 if table.dim() == 1 else table.shape[1]


def _chain(name: str, table: torch.Tensor, idx: torch.Tensor, tptr: int,
           *extra):
    out = torch.empty(idx.shape, dtype=U32, device=idx.device)
    kernels.launch(name, idx.device, tptr, table.shape[0], _cols(table),
                   idx.data_ptr(), idx.shape[0], out.data_ptr(), 0, 0,
                   *extra)
    return out


def gather_chain(table: torch.Tensor, idx: torch.Tensor):
    """(N,) uint32 chain sums. CUDA: K5, the table in device memory."""
    if not kernels.on_cuda(table):
        return gather_chain_plain(table, idx)
    tptr = _check(table, idx, U32, (1, 2))[0]
    return _chain("gather_chain", table, idx, tptr,
                  floor_mod_magic(table.shape[0]))


def gather_chain_shared(table: torch.Tensor, idx: torch.Tensor):
    """(N,) uint32 chain sums. CUDA: K6, the table in shared memory; a
    table larger than a block's shared memory raises (use gather_chain)."""
    if not kernels.on_cuda(table):
        return gather_chain_plain(table, idx)
    tptr = _check(table, idx, U32, (1, 2))[0]
    if table.numel() * 4 > SHARED_BYTES:
        raise ValueError(f"a {tuple(table.shape)} table takes "
                         f"{table.numel() * 4} B, more than the "
                         f"{SHARED_BYTES} B of shared memory of a block: "
                         "use gather_chain")
    return _chain("gather_chain_shared", table, idx, tptr)


def gather_onehot(planes: torch.Tensor, idx: torch.Tensor, out_dtype=U32):
    """(N,) chain sums as `out_dtype` (uint32, or int32 as
    microbench_gather2.py's kernel gives them: the same bits) from the
    (rows, 4*cols) bf16 u8 planes of a table (u8_planes). CUDA: K7 on the
    tensor cores; rows a multiple of 16, cols 2, 4, 8 or 16, the planes
    within a block's shared memory (onehot_plan)."""
    if out_dtype not in (U32, I32):
        raise ValueError(f"out_dtype must be uint32 or int32, not "
                         f"{out_dtype}")
    if not kernels.on_cuda(planes):
        return gather_onehot_plain(planes, idx, out_dtype)
    pptr, (rows, cols4), _ = _check(planes, idx, torch.bfloat16, (2,))
    plan = onehot_plan(rows, cols4)
    out = torch.empty(idx.shape, dtype=out_dtype, device=idx.device)
    kernels.launch("gather_onehot", idx.device, pptr, rows,
                   cols4, idx.data_ptr(), idx.shape[0], out.data_ptr(), 0, 0,
                   plan.kb, plan.box_rows, plan.smem, floor_mod_magic(rows))
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor):
    """(N, cols) uint32 rows T[idx mod rows]. CUDA: K8."""
    if not kernels.on_cuda(table):
        return gather_rows_plain(table, idx)
    tptr, (rows, cols), n = _check(table, idx, U32, (2,))
    if n * cols >= 1 << 31:
        raise ValueError(f"{n} rows of {cols} words: 2^31 words or more")
    dev = table.device
    out = torch.empty(n, cols, dtype=U32, device=dev)
    if n == 0 or cols == 0:
        return out
    optr = out.data_ptr()
    if optr % 16:
        raise ValueError("the output must start on a 16-byte boundary")
    kernels.launch("gather_rows", dev, tptr, rows, cols, idx.data_ptr(), n,
                   optr)
    return out
