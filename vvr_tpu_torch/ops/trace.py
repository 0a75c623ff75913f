"""One tracer interface for both grids: the jump grid (K1, ops/jump.py) and
the paged grid (K16, ops/paged.py).

Counterpart of vvr_tpu/render/frame.py `make_tracer` for the port's two
grids: the frame and the plain versions of K12, K14 and K15 trace through
`trace` and `trace_plain`, which pick the tracer by the grid's type. The
kernels that trace inline take the grid as a view (csrc/grid_view.cuh):
`kernel_args` gives each launch its entry point's name and the grid's
arguments. `near_walk` says whether the grid's shadow paths walk the
first crossings before the DDA: the JAX frame walks only the jump grid
(frame.py:388, :475).
"""

from __future__ import annotations

import torch

from vvr_tpu_torch.ops.jump import TraceResult, trace_jump, trace_jump_plain
from vvr_tpu_torch.ops.paged import (check_paged, solid_plain, trace_paged,
                                     trace_paged_plain)
from vvr_tpu_torch.world.jumpgrid import JumpGrid
from vvr_tpu_torch.world.occupancy import brick_solid
from vvr_tpu_torch.world.paged import PagedGrid

MASK32 = 0xFFFFFFFF
Grid = JumpGrid | PagedGrid


def is_paged(grid) -> bool:
    if isinstance(grid, PagedGrid):
        return True
    if isinstance(grid, JumpGrid):
        return False
    raise TypeError(f"not a grid of the port: {type(grid).__name__}")


def trace(grid, ray_o, ray_d, max_steps: int = 2048, active=None,
          width: int | None = None, stats: bool = True) -> TraceResult:
    """`trace_paged` on a paged grid, else `trace_jump` (same contract)."""
    fn = trace_paged if is_paged(grid) else trace_jump
    return fn(grid, ray_o, ray_d, max_steps, active, width, stats)


def trace_plain(grid, ray_o, ray_d, max_steps: int = 2048, active=None,
                stats: bool = True, rows_read=None) -> TraceResult:
    """The plain torch tracer of the grid (K16's or K1's plain version).
    `rows_read`: one bool tensor per table of `tensors(grid)`, as long as
    the table, which gets True at every row the rays load."""
    if is_paged(grid):
        return trace_paged_plain(grid, ray_o, ray_d, max_steps, active,
                                 stats, rows_read=rows_read)
    return trace_jump_plain(grid, ray_o, ray_d, max_steps, active, stats,
                            rows_read=rows_read)


def near_walk(grid) -> bool:
    """Whether shadow rays walk their first crossings before the DDA."""
    return not is_paged(grid)


def solid(grid, v, rows_read=None) -> torch.Tensor:
    """Whether each voxel v (N, 3) int64 inside the world is solid.
    `rows_read` (as `trace_plain` takes it) gets True at the rows the test
    loads."""
    if is_paged(grid):
        return solid_plain(grid, v, rows_read)
    g = grid.gsize
    addr = (v[:, 0] >> 3) + (v[:, 1] >> 3) * g + (v[:, 2] >> 3) * g * g
    if rows_read is not None:
        rows_read[0][addr] = True
    words = grid.rows[addr].to(torch.int64) & MASK32
    return brick_solid(words, v[:, 0] & 7, v[:, 1] & 7, v[:, 2] & 7)


def tensors(grid) -> list[torch.Tensor]:
    """The grid's device tables."""
    return [grid.prows, grid.brows] if is_paged(grid) else [grid.rows]


def kernel_args(name: str, grid) -> tuple[str, list]:
    """(kernel name, grid arguments) of a launch of kernel `name` on the
    grid: `name` and (rows, size) on the jump grid, `name`_paged and (page
    table, pool, size, page edge) on the paged grid. Raises unless the
    tables are int32 and 16-byte aligned."""
    if is_paged(grid):
        check_paged(grid)
        return f"{name}_paged", [grid.prows.data_ptr(),
                                 grid.brows.data_ptr(), grid.size,
                                 grid.psize]
    if grid.rows.dtype != torch.int32 or grid.rows.data_ptr() % 16:
        raise ValueError("jump-grid rows must be int32, 16-byte aligned")
    return name, [grid.rows.data_ptr(), grid.size]
