"""State from the JAX package, as numpy arrays, into the port's tensors.

The tests feed both packages the same world and textures through these, so
a difference in world generation or in the sky passes cannot hide behind a
frame difference. Nothing here imports vvr_tpu: callers hand over
`np.asarray(...)` of the JAX values.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch.world.jumpgrid import ROW_WORDS, JumpGrid


def jumpgrid_from_numpy(rows: np.ndarray, size: int, device="cpu") -> JumpGrid:
    """JumpGrid from `np.asarray(vvr_tpu JumpGrid.rows)` ((G^3, 32) u32)."""
    rows = np.array(rows, np.uint32)  # a writable copy
    g = size // 8
    if rows.shape != (g ** 3, ROW_WORDS):
        raise ValueError(f"rows {rows.shape} do not fit a {size}^3 grid")
    return JumpGrid(torch.from_numpy(rows.view(np.int32)).to(device), size)


def sky_from_numpy(skybox: np.ndarray, clouds: np.ndarray, device="cpu"):
    """(skybox (6, R, R, 3), clouds (R', R', 4)) float32 tensors from the
    JAX `write_skybox` / `write_clouds` outputs."""
    sb = torch.from_numpy(np.array(skybox, np.float32))
    cl = torch.from_numpy(np.array(clouds, np.float32))
    if sb.dim() != 4 or sb.shape[0] != 6 or sb.shape[3] != 3:
        raise ValueError(f"skybox must be (6, R, R, 3), got {sb.shape}")
    if cl.dim() != 3 or cl.shape[2] != 4:
        raise ValueError(f"clouds must be (R, R, 4), got {cl.shape}")
    return sb.to(device), cl.to(device)


def occupancy_from_numpy(occ: np.ndarray, device="cpu") -> torch.Tensor:
    """Dense bool occupancy (S, S, S) [z, y, x] as a tensor."""
    return torch.from_numpy(np.array(occ, bool)).to(device)
