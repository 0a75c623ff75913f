"""One tracer interface for the three grids: the jump grid (K1,
ops/jump.py), the paged grid (K16, ops/paged.py) and the brick pyramid
(K19, ops/traverse.py).

Counterpart of vvr_tpu/render/frame.py `make_tracer` for the port's
grids: the frame and the plain versions of K12, K14 and K15 trace through
`trace` and `trace_plain`, which pick the tracer by the grid's type (on
the pyramid the any-only walk, `use_full=False`, as the JAX frame's
tracer, frame.py:114). The kernels that trace inline take the grid as a
view (csrc/grid_view.cuh): `kernel_args` gives each launch its entry
point's name and the grid's arguments. `near_walk` says whether the
grid's shadow paths walk the first crossings before the DDA: the JAX
frame walks only the jump grid (frame.py:389, :475). `step_cap` is each
grid's cap: the grids count voxel sub-steps, capped at
`traversal_max_steps * 8` (frame.py:52, :82, :95), the pyramid counts
HDDA steps, capped at `traversal_max_steps` (:114).
"""

from __future__ import annotations

import torch

from vvr_tpu_torch.ops.jump import TraceResult, trace_jump, trace_jump_plain
from vvr_tpu_torch.ops.paged import (check_paged, solid_plain, trace_paged,
                                     trace_paged_plain)
from vvr_tpu_torch.ops.traverse import (check_pyramid, trace_pyramid,
                                        trace_pyramid_plain)
from vvr_tpu_torch.world.jumpgrid import JumpGrid
from vvr_tpu_torch.world.occupancy import brick_solid, pyramid_voxel_solid
from vvr_tpu_torch.world.paged import PagedGrid
from vvr_tpu_torch.world.pyramid import BrickPyramid

MASK32 = 0xFFFFFFFF
Grid = JumpGrid | PagedGrid | BrickPyramid


def kind(grid) -> str:
    """"jump", "paged" or "pyramid"."""
    if isinstance(grid, JumpGrid):
        return "jump"
    if isinstance(grid, PagedGrid):
        return "paged"
    if isinstance(grid, BrickPyramid):
        return "pyramid"
    raise TypeError(f"not a grid of the port: {type(grid).__name__}")


def step_cap(grid, traversal_max_steps: int) -> int:
    """The frame's cap on the grid's trace (module docstring)."""
    if kind(grid) == "pyramid":
        return traversal_max_steps
    return traversal_max_steps * 8


def trace(grid, ray_o, ray_d, max_steps: int = 2048, active=None,
          width: int | None = None, stats: bool = True) -> TraceResult:
    """`trace_jump`, `trace_paged` or the pyramid's any-only
    `trace_pyramid` by the grid's type (one contract)."""
    k = kind(grid)
    if k == "pyramid":
        return trace_pyramid(grid, ray_o, ray_d, max_steps, active, width,
                             stats, use_full=False)
    fn = trace_paged if k == "paged" else trace_jump
    return fn(grid, ray_o, ray_d, max_steps, active, width, stats)


def trace_plain(grid, ray_o, ray_d, max_steps: int = 2048, active=None,
                stats: bool = True, rows_read=None) -> TraceResult:
    """The plain torch tracer of the grid (K1's, K16's or K19's plain
    version). `rows_read`: one bool tensor per table of `tensors(grid)`,
    as long as the table, which gets True at every row the rays load."""
    k = kind(grid)
    if k == "paged":
        return trace_paged_plain(grid, ray_o, ray_d, max_steps, active,
                                 stats, rows_read=rows_read)
    if k == "pyramid":
        return trace_pyramid_plain(grid, ray_o, ray_d, max_steps, active,
                                   stats, use_full=False,
                                   rows_read=rows_read)
    return trace_jump_plain(grid, ray_o, ray_d, max_steps, active, stats,
                            rows_read=rows_read)


def near_walk(grid) -> bool:
    """Whether shadow rays walk their first crossings before the DDA."""
    return kind(grid) == "jump"


def solid(grid, v, rows_read=None) -> torch.Tensor:
    """Whether each voxel v (N, 3) int64 inside the world is solid.
    `rows_read` (as `trace_plain` takes it) gets True at the rows the test
    loads."""
    k = kind(grid)
    if k == "paged":
        return solid_plain(grid, v, rows_read)
    if k == "pyramid":
        return pyramid_voxel_solid(grid, v, rows_read)
    g = grid.gsize
    addr = (v[:, 0] >> 3) + (v[:, 1] >> 3) * g + (v[:, 2] >> 3) * g * g
    if rows_read is not None:
        rows_read[0][addr] = True
    words = grid.rows[addr].to(torch.int64) & MASK32
    return brick_solid(words, v[:, 0] & 7, v[:, 1] & 7, v[:, 2] & 7)


def tensors(grid) -> list[torch.Tensor]:
    """The grid's device tables."""
    k = kind(grid)
    if k == "paged":
        return [grid.prows, grid.brows]
    return [grid.rows]


def kernel_args(name: str, grid) -> tuple[str, list]:
    """(kernel name, grid arguments) of a launch of kernel `name` on the
    grid: `name` and (rows, size) on the jump grid, `name`_paged and (page
    table, pool, size, page edge) on the paged grid, `name`_pyramid and
    (rows, size, depth) on the pyramid (its any-only walk). Raises unless
    the tables are int32 and 16-byte aligned."""
    k = kind(grid)
    if k == "paged":
        check_paged(grid)
        return f"{name}_paged", [grid.prows.data_ptr(),
                                 grid.brows.data_ptr(), grid.size,
                                 grid.psize]
    if k == "pyramid":
        check_pyramid(grid)
        return f"{name}_pyramid", [grid.rows.data_ptr(), grid.size,
                                   grid.depth]
    if grid.rows.dtype != torch.int32 or grid.rows.data_ptr() % 16:
        raise ValueError("jump-grid rows must be int32, 16-byte aligned")
    return name, [grid.rows.data_ptr(), grid.size]
