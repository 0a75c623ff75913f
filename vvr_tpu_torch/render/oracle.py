"""CPU oracle — ground-truth traversal over the dense voxel grid.

The numpy body of vvr_tpu/render/oracle.py `trace_dense`, copied so the
port can check its tracer where vvr_tpu cannot be imported. A plain
Amanatides-Woo voxel DDA written with the same floating-point formulas as
the jump tracer (fresh t = (bound - o) * inv_d per step, z>y>x tie rule),
so the tracer must agree with it bit for bit on (hit, face, axis_coord, t).
"""

from __future__ import annotations

import numpy as np

BIG_T = np.float32(1e30)


def trace_dense(occ: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray,
                max_steps: int | None = None):
    """occ: bool (S,S,S) [z,y,x]. ray_o/ray_d: (N,3) f32.

    Returns dict(hit (N,) bool, face (N,) i32, axis_coord (N,) i32, t (N,) f32).
    """
    occ = np.asarray(occ, bool)
    size = occ.shape[0]
    if max_steps is None:
        max_steps = 4 * size

    o = np.asarray(ray_o, np.float32)
    d = np.asarray(ray_d, np.float32)
    n = o.shape[0]
    with np.errstate(divide="ignore"):
        inv_d = np.where(d == 0.0, BIG_T, np.float32(1.0) / d)
    step_dir = np.where(d > 0, 1, -1).astype(np.int32)
    d_pos = (d > 0).astype(np.int32)

    inside = np.all((o >= 0) & (o < size), axis=1)
    active = inside.copy()
    hit = np.zeros(n, bool)
    face = np.zeros(n, np.int32)
    t = np.zeros(n, np.float32)

    cell = np.clip(np.floor(o).astype(np.int32), 0, size - 1)

    for _ in range(max_steps):
        if not active.any():
            break
        idx = np.nonzero(active)[0]
        c = cell[idx]
        solid = occ[c[:, 2], c[:, 1], c[:, 0]]
        newly_hit = idx[solid]
        hit[newly_hit] = True
        active[newly_hit] = False

        idx = idx[~solid]
        if idx.size == 0:
            continue
        c = cell[idx]
        bound = (c + d_pos[idx]).astype(np.float32)
        t_ax = (bound - o[idx]) * inv_d[idx]
        t_ax = np.where(d[idx] == 0.0, BIG_T, t_ax)
        tmin = t_ax.min(axis=1)
        f = np.where(t_ax[:, 2] <= tmin, 2,
                     np.where(t_ax[:, 1] <= tmin, 1, 0)).astype(np.int32)
        c2 = c.copy()
        rows = np.arange(len(idx))
        c2[rows, f] += step_dir[idx, f]
        cell[idx] = c2
        t[idx] = tmin
        face[idx] = f
        out = np.any((c2 < 0) | (c2 >= size), axis=1)
        active[idx[out]] = False

    vcoord = cell[np.arange(n), face]
    axis_coord = np.where(hit, vcoord, 0).astype(np.int32)
    return dict(hit=hit, face=face, axis_coord=axis_coord,
                t=np.where(hit, t, BIG_T).astype(np.float32))
