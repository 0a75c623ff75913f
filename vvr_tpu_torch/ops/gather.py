"""Random row gathers, the microbenchmark of the traversal's fetch cost —
kernels K5-K8 (csrc/gather.cu).

The JAX package chose its traversal layouts (blocked fine grid, paged
grid, coarse sun level) from six Pallas microbenchmarks that measured a
per-lane random row fetch on a TPU. Each wrapper here replaces some of
them, on one design for an H100:

  gather_chain         K5  pallas_take (tools/microbench_gather.py:92) and
                           pallas_tala (tools/microbench_gather2.py:69):
                           8 dependent row gathers per lane, the table in
                           device memory; one thread per lane fetches the
                           whole row (16-byte loads where 4 | cols), as the
                           TPU kernel's row take does.
  gather_chain_shared  K6  pallas_vreg (tools/microbench_gather.py:133): the
                           same chain with the table in shared memory, the
                           counterpart of VMEM or of one vreg; each block
                           copies the table once and walks many lanes.
  gather_onehot        K7  pallas_onehot (tools/microbench_gather.py:177,
                           u32; tools/microbench_gather2.py:112, i32): the
                           chain where each gather is a one-hot bf16 product
                           with the table's u8 planes on the tensor cores
                           (mma.sync m16n8k16, every k tile of every row),
                           decoded back to the 32-bit word.
  gather_rows          K8  pallas_scalar (tools/microbench_gather.py:228):
                           one un-chained row gather, out[i] = T[idx[i]];
                           a thread a row where the row is one 16-, 8- or
                           4-byte vector, else a warp per 32 rows moving
                           them as such vectors; the index and its floor
                           mod once per row.

What bounds them on an H100: K5, K6 and K8 move a few MB (the indices, the
outputs, the table once), a few microseconds at 3.35 TB/s; what they
measure is the latency of dependent fetches from L2 or shared memory, which
no bandwidth bound sees, so their roofline shares are low by design. K8's
single gather is a microsecond of device work, so a call is bound by its
launch and the host's path in front of it (kernels.launch). K7 is
bound by its tensor-core work, 2 * lanes * rows * 4*cols per step, which
at (4096, 2) and (512, 16) is 2^40 operations for 2^21 lanes (about 1.1
ms at the bf16 dense peak, which mma.sync does not reach).

The chain is the reference's: r = T[idx, 0]; acc += r (mod 2^32);
idx = (int32(r) ^ idx) mod rows, with jnp's floor mod, so a table word
of 2^31 or more (a negative int32) still gives an index in [0, rows). The
starting index is taken mod rows the same way, in the plain versions and
the kernels alike, so no index reads outside the table. The plain versions
do the arithmetic in int64 masked to 32 bits (torch's uint32 has no add,
mod or shift).

Tables are uint32 tensors, (rows, cols) or, for pallas_vreg's table,
(rows,); indices are int32 (N,). On the CPU each wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

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


def _chain(name: str, table: torch.Tensor, idx: torch.Tensor, tptr: int):
    out = torch.empty(idx.shape, dtype=U32, device=idx.device)
    kernels.launch(name, idx.device, tptr, table.shape[0], _cols(table),
                   idx.data_ptr(), idx.shape[0], out.data_ptr(), 0, 0)
    return out


def gather_chain(table: torch.Tensor, idx: torch.Tensor):
    """(N,) uint32 chain sums. CUDA: K5, the table in device memory."""
    if not kernels.on_cuda(table):
        return gather_chain_plain(table, idx)
    tptr = _check(table, idx, U32, (1, 2))[0]
    return _chain("gather_chain", table, idx, tptr)


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
    tensor cores; rows a multiple of 16, cols 2, 4, 8 or 16."""
    if out_dtype not in (U32, I32):
        raise ValueError(f"out_dtype must be uint32 or int32, not "
                         f"{out_dtype}")
    if not kernels.on_cuda(planes):
        return gather_onehot_plain(planes, idx, out_dtype)
    pptr, (rows, cols4), _ = _check(planes, idx, torch.bfloat16, (2,))
    if rows % 16 or cols4 not in (8, 16, 32, 64):
        raise ValueError(f"K7 takes rows a multiple of 16 and 8, 16, 32 or "
                         f"64 plane columns, got {tuple(planes.shape)}")
    if planes.numel() * 2 > SHARED_BYTES:
        raise ValueError(f"planes {tuple(planes.shape)} exceed the "
                         f"{SHARED_BYTES} B of shared memory of a block")
    out = torch.empty(idx.shape, dtype=out_dtype, device=idx.device)
    kernels.launch("gather_onehot", idx.device, pptr, rows,
                   cols4, idx.data_ptr(), idx.shape[0], out.data_ptr(), 0, 0)
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
