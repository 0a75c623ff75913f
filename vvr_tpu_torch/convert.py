"""State from the JAX package, as numpy arrays, into the port's tensors.

The tests feed both packages the same world, textures and gather tables
through these, so a difference in world generation or in the sky passes
cannot hide behind a frame difference. Nothing here imports vvr_tpu:
callers hand over `np.asarray(...)` of the JAX values. The tensors land on
`device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch.world.faces import FIELDS
from vvr_tpu_torch.world.jumpgrid import ROW_WORDS, JumpGrid


def jumpgrid_from_numpy(rows: np.ndarray, size: int,
                        device="cuda") -> JumpGrid:
    """JumpGrid from `np.asarray(vvr_tpu JumpGrid.rows)` ((G^3, 32) u32)."""
    rows = np.array(rows, np.uint32)  # a writable copy
    g = size // 8
    if rows.shape != (g ** 3, ROW_WORDS):
        raise ValueError(f"rows {rows.shape} do not fit a {size}^3 grid")
    return JumpGrid(torch.from_numpy(rows.view(np.int32)).to(device), size)


def sky_from_numpy(skybox: np.ndarray, clouds: np.ndarray,
                   device="cuda"):
    """(skybox (6, R, R, 3), clouds (R', R', 4)) float32 tensors from the
    JAX `write_skybox` / `write_clouds` outputs."""
    sb = torch.from_numpy(np.array(skybox, np.float32))
    cl = torch.from_numpy(np.array(clouds, np.float32))
    if sb.dim() != 4 or sb.shape[0] != 6 or sb.shape[3] != 3:
        raise ValueError(f"skybox must be (6, R, R, 3), got {sb.shape}")
    if cl.dim() != 3 or cl.shape[2] != 4:
        raise ValueError(f"clouds must be (R, R, 4), got {cl.shape}")
    return sb.to(device), cl.to(device)


def occupancy_from_numpy(occ: np.ndarray, device="cuda") -> torch.Tensor:
    """Dense bool occupancy (S, S, S) [z, y, x] as a tensor."""
    return torch.from_numpy(np.array(occ, bool)).to(device)


def gather_table_from_numpy(table: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 table (rows,) or (rows, cols) of the gather microbenchmarks
    (tools/microbench_gather*.py) as a uint32 tensor, bit for bit."""
    table = np.asarray(table)
    if table.dtype != np.uint32 or table.ndim not in (1, 2):
        raise ValueError(f"expected a uint32 (rows,) or (rows, cols) table, "
                         f"got {table.dtype} {table.shape}")
    return torch.from_numpy(table.copy()).to(device)


def gather_planes_from_numpy(planes: np.ndarray,
                             device="cuda") -> torch.Tensor:
    """bf16 u8 planes (rows, 4*cols) of the one-hot microbenchmark as a
    bfloat16 tensor, bit for bit: JAX hands them to numpy as ml_dtypes
    bfloat16, which goes through its 16-bit pattern, never through float."""
    planes = np.asarray(planes)
    if planes.dtype.name != "bfloat16" or planes.ndim != 2:
        raise ValueError(f"expected (rows, 4*cols) bfloat16 planes, got "
                         f"{planes.dtype} {planes.shape}")
    bits = torch.from_numpy(planes.view(np.int16).copy())
    return bits.view(torch.bfloat16).to(device)


def faces_from_numpy(faces, device="cuda") -> tuple:
    """The port's face tuple (FaceSet.device_tuple(): vx, vy, vz, axis,
    sgn, eu, ev, einfo as int32) from a JAX `FaceSet` (its numpy fields)."""
    arrays = [np.array(getattr(faces, k), np.int32) for k in FIELDS]
    if any(a.shape != arrays[0].shape or a.ndim != 1 for a in arrays):
        raise ValueError("face arrays must be 1-D of one length")
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def sun_grids_from_numpy(grids, device="cuda"):
    """The port's hard-shadow grids (gBC, a0, b0, ts) from the JAX
    `build_sun_grids` grids (gBC, cBC, a0, b0, ts); the coarse cBC is
    dropped (no query reads it)."""
    gbc, _cbc, a0, b0, ts = grids
    gbc = np.array(gbc, np.float32)
    if gbc.ndim != 2 or gbc.shape[1] != 2:
        raise ValueError(f"gBC must be (G^2, 2), got {gbc.shape}")
    return (torch.from_numpy(gbc).to(device), np.float32(a0),
            np.float32(b0), np.float32(ts))
