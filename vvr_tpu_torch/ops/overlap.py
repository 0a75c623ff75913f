"""Overlap AO — the box-overlap occupancy densities, kernel K20
(csrc/overlap.cu).

Replaces vvr_tpu/ops/overlap.py: `volume_aabb_aabb_overlap` (:39, quirk
included: max(-vx*vy*vz, 0) is positive where exactly two axes overlap
negatively, so a far cell of the loops can add phantom volume),
`pyramid_is_solid` (:50), `cube_overlap_density` (:62),
`planar_overlap_density` (:81), `cube_overlap_density_svo` (:108, the
same value) and `overlap_ao` (:117). For each position, the solid voxels
of the (2k+1)^3 cube, or of the (2k+1)^2 square in the plane across
`axis`, around it (k = ceil(half); cells at trunc(position + offset),
toward zero as the JAX `astype(int32)`; cells outside the world empty)
add their overlap volume with the box of half-edge `half`, in the JAX
loop order (x, y, z; u, v), and the sum is divided by the box's volume
or area. `overlap_ao`: 1 plus the planar densities at world + normal *
0.5 (half 0.8) and * 2.5 (half 2.4) across the face axis, clipped to [0,
2], times 0.2, inverted and clipped to [0, 1].

The plain versions read any grid of the port through ops/trace.py `solid`
(the same occupancy gives the same densities); K20 takes the brick
pyramid, the JAX functions' structure, one thread a position. The frame's
overlap AO runs inside K15 (csrc/bounce.cu), through its grid view's
`solid`, so no frame builds a pyramid for it.

Rounding, as XLA's jit computes the JAX functions: the sum is multiplied
by the float32 reciprocal of the box volume's float32 (XLA turns `s /
total` into that product; the op-by-op division differs in the last bit
on about a fifth of the positions), and `overlap_ao`'s
`1 - clip(ao, 0, 2) * 0.2` is contracted into an FMA (checked against
the jitted JAX functions on tests/test_overlap.py's scene); the position
plus a normal times 0.5 or 2.5 is exact (normal components are 0 or +-1).
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops import trace as tracer
from vvr_tpu_torch.utils.hash import _fma

F32 = torch.float32
AXIS_UV = ((1, 2), (0, 2), (0, 1))   # the plane's axes across each axis
AO_TAPS = ((0.5, 0.8), (2.5, 2.4))   # (normal offset, half) of each
                                     # density of overlap_ao


def reach(half: float) -> int:
    """k = ceil(half): the loops' offsets run from -k to k."""
    return int(-(-half // 1))


def box_scale(half: float, planar: bool) -> float:
    """The float32 reciprocal of the float32 of the box's volume (2
    half)^3, or area (2 half)^2: XLA's jit turns the JAX division by the
    constant into this product."""
    total = torch.tensor((half * 2.0) ** (2 if planar else 3), dtype=F32)
    return float(torch.tensor(1.0, dtype=F32) / total)


def volume_aabb_aabb_overlap(amin, amax, center, half):
    """Overlap volume of the integer boxes [amin, amax] (N, 3) with the
    cubes (center (N, 3) float32, half), quirk included."""
    h = torch.tensor(half, dtype=F32)
    maxxino = torch.maximum(amin.to(F32), center - h)
    minnimo = torch.minimum(amax.to(F32), center + h)
    v = maxxino - minnimo
    return torch.clamp(-v[:, 0] * v[:, 1] * v[:, 2], min=0.0)


def grid_is_solid(grid, pos, rows_read=None):
    """Whether each integer cell pos (N, 3) is a solid voxel of the grid;
    False outside the world (`pyramid_is_solid` on any grid)."""
    size = grid.size
    inb = ((pos >= 0) & (pos < size)).all(1)
    solid = tracer.solid(grid, torch.clamp(pos, 0, size - 1))
    if rows_read is not None:
        tracer.solid(grid, pos[inb], rows_read)
    return solid & inb


def _density(grid, center, half: float, offsets, rows_read=None):
    """The sum over `offsets` ((N, 3) float32 each, in loop order) of the
    solid cells' overlap volumes around `center`."""
    s = torch.zeros(center.shape[0], dtype=F32, device=center.device)
    for off in offsets:
        pos = (center + off).to(torch.int64)
        vol = volume_aabb_aabb_overlap(pos, pos + 1, center, half)
        s = s + torch.where(grid_is_solid(grid, pos, rows_read), vol, 0.0)
    return s


def cube_overlap_density_plain(grid, cube_pos, half: float,
                               rows_read=None):
    """Plain torch K20's cube mode: (N,) float32."""
    k = reach(half)
    rng = range(-k, k + 1)
    offs = (torch.tensor([x, y, z], dtype=F32, device=cube_pos.device)
            .expand_as(cube_pos) for x in rng for y in rng for z in rng)
    s = _density(grid, cube_pos.to(F32), half, offs, rows_read)
    return s * torch.tensor(box_scale(half, False), dtype=F32,
                            device=s.device)


def _plane_offsets(axis, k: int):
    """The offsets of the (2k+1)^2 square across each lane's axis, in the
    JAX loop order (u, then v)."""
    dev = axis.device
    for u in range(-k, k + 1):
        for v in range(-k, k + 1):
            per_axis = []
            for ua, va in AXIS_UV:
                o = [0.0, 0.0, 0.0]
                o[ua], o[va] = float(u), float(v)
                per_axis.append(o)
            yield torch.tensor(per_axis, dtype=F32, device=dev)[axis]


def planar_overlap_density_plain(grid, plane_pos, half: float, axis,
                                 rows_read=None):
    """Plain torch K20's planar mode: (N,) float32; `axis` (N,) int, the
    plane's normal axis."""
    s = _density(grid, plane_pos.to(F32), half,
                 _plane_offsets(axis.to(torch.int64), reach(half)),
                 rows_read)
    return s * torch.tensor(box_scale(half, True), dtype=F32,
                            device=s.device)


def overlap_ao_plain(grid, world, normal, face, rows_read=None):
    """Plain torch `overlap_ao`: (N,) float32 of world (N, 3), normal
    (N, 3) (components 0 or +-1) and face (N,) int: each planar sum added
    to 1 times its box's scale by an FMA, then 1 - clip(ao, 0, 2) * 0.2
    by an FMA, clipped (module docstring)."""
    dev = world.device
    one = torch.tensor(1.0, dtype=F32, device=dev)
    ao = one.expand(world.shape[0])
    axis = face.to(torch.int64)
    for off, half in AO_TAPS:
        s = _density(grid, world + normal * off, half,
                     _plane_offsets(axis, reach(half)), rows_read)
        ao = _fma(s, torch.tensor(box_scale(half, True), dtype=F32,
                                  device=dev), ao)
    return torch.clamp(_fma(-torch.clamp(ao, 0.0, 2.0),
                            torch.tensor(0.2, dtype=F32, device=dev), one),
                       0.0, 1.0)


def _launch_k20(grid, pos, mode: int, half: float = 0.0, axis=None,
                normal=None):
    """K20 over the positions (N, 3) float32 on the pyramid: mode 0 the
    cube density, 1 the planar density across `axis`, 2 overlap_ao with
    `normal` and `axis` the face."""
    n = pos.shape[0]
    if pos.shape != (n, 3) or pos.dtype != F32:
        raise ValueError("positions must be (N, 3) float32")
    if tracer.kind(grid) != "pyramid":
        raise ValueError("K20 takes the brick pyramid (the frame's overlap "
                         "AO on any grid runs inside K15)")
    tensors = [*tracer.tensors(grid), pos]
    if axis is not None:
        axis = axis.to(torch.int32).contiguous()
        if axis.shape != (n,):
            raise ValueError("axis must be (N,)")
        tensors.append(axis)
    if normal is not None:
        if normal.shape != (n, 3) or normal.dtype != F32:
            raise ValueError("normal must be (N, 3) float32")
        tensors.append(normal)
    tracer.kernel_args("overlap_density", grid)   # checks the table
    kernels.check_cuda(*tensors)
    k = reach(half) if mode < 2 else 0
    scale = box_scale(half, mode == 1) if mode < 2 else 0.0
    out = torch.empty(n, dtype=F32, device=pos.device)
    kernels.launch("overlap_density", pos.device, grid.rows.data_ptr(),
                   grid.size, grid.depth, pos.data_ptr(),
                   0 if normal is None else normal.data_ptr(),
                   0 if axis is None else axis.data_ptr(), n, mode,
                   float(half), k, scale, out.data_ptr())
    return out


def _check_half(half: float) -> None:
    if not 0.0 < half <= 8.0:
        raise ValueError(f"half must be in (0, 8], got {half}")


def cube_overlap_density(grid, cube_pos, half: float):
    """Solid-voxel overlap volume in the cube of half-edge `half` around
    each of cube_pos (N, 3) float32, over the cube's volume. CUDA: K20 on
    the brick pyramid; CPU: the plain version (any grid)."""
    _check_half(half)
    if not kernels.on_cuda(cube_pos):
        return cube_overlap_density_plain(grid, cube_pos, half)
    return _launch_k20(grid, cube_pos, 0, half)


def cube_overlap_density_svo(grid, cube_pos, half: float):
    """The tree-walking variant: on the dense pyramid its value is the
    in-box leaf sum, `cube_overlap_density`."""
    return cube_overlap_density(grid, cube_pos, half)


def planar_overlap_density(grid, plane_pos, half: float, axis):
    """Overlap density in the plane across `axis` (N,) int at each of
    plane_pos (N, 3) float32, over the square's area. CUDA: K20."""
    _check_half(half)
    if not kernels.on_cuda(plane_pos):
        return planar_overlap_density_plain(grid, plane_pos, half, axis)
    return _launch_k20(grid, plane_pos, 1, half, axis)


def overlap_ao(grid, world, normal, face):
    """The reference's planar-overlap AO (raytracer.slang:283-297): (N,)
    float32 (module docstring). CUDA: K20, one launch."""
    if not kernels.on_cuda(world):
        return overlap_ao_plain(grid, world, normal, face)
    return _launch_k20(grid, world, 2, axis=face, normal=normal)
