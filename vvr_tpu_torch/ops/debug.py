"""The debug heatmaps — kernel K21 `debug_image` (csrc/debug.cu).

Replaces vvr_tpu/render/frame.py:701 `_debug_image` with `heatmap`
(:124) over bounce 0's record (:252-255): the primary trace's counters,
the normal and the block of its hit reconstruction (:212-238). By the
reference's DebugType (raytracer.slang:401-428):

  1 iterations / 256, 2 fetches / 32, 5 missed_pops / 64, each through
    the blue -> green -> red heatmap of its value clipped to [0, 1];
  3 the entry face's normal, clipped to [0, 1];
  4 the block coordinates, floor-mod 16 (jnp `%`), over 16.

Every lane is written, misses too, as the JAX frame computes them: a
miss keeps its trace's last face (its normal shows on sky pixels) and
axis_coord 0, from which the reconstruction places its "block" (a far
point whose floor saturates at the int32 range, as XLA's conversion and
the card's do). The image replaces the HDR frame's rgb planes; alpha
stays the frame's, and the frame composites it without bloom.
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.shade import _reconstruct

F32 = torch.float32
DEBUG_ITERATIONS, DEBUG_FETCHES, DEBUG_NORMALS, DEBUG_WORLD, DEBUG_EXIT = (
    1, 2, 3, 4, 5)
# the counter each heatmap shows and its full scale
HEATMAPS = {DEBUG_ITERATIONS: ("iterations", 256.0),
            DEBUG_FETCHES: ("fetches", 32.0),
            DEBUG_EXIT: ("missed_pops", 64.0)}
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def needs_stats(debug_type: int) -> bool:
    """Whether the debug image reads the primary trace's counters."""
    return debug_type in HEATMAPS


def heatmap(x):
    """(r, g, b) of the blue -> green -> red map over [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    return (torch.clamp(2.0 * x - 1.0, 0.0, 1.0),
            1.0 - torch.abs(2.0 * x - 1.0),
            torch.clamp(1.0 - 2.0 * x, 0.0, 1.0))


def debug_image_plain(o, d, face, axis_coord, counter, debug_type: int,
                      out):
    """Plain torch K21: the rgb planes of `out` (>= 3, H, W) float32,
    written in place from the rays (N, 3), the trace's face and
    axis_coord, and `counter` (N,) int32 for the heatmaps (None
    otherwise). Returns `out`."""
    n = o.shape[0]
    flat = out.view(out.shape[0], n)
    if debug_type in HEATMAPS:
        rgb = heatmap(counter.to(F32) / HEATMAPS[debug_type][1])
    else:
        normal, _, block = _reconstruct(o, d, face.to(torch.int64),
                                        axis_coord)
        if debug_type == DEBUG_NORMALS:
            rgb = [torch.clamp(c, 0.0, 1.0) for c in normal]
        elif debug_type == DEBUG_WORLD:
            rgb = [torch.remainder(torch.clamp(b, I32_MIN, I32_MAX), 16)
                   .to(F32) / 16.0 for b in block]
        else:
            raise ValueError(f"debug_type {debug_type} has no image")
    for c in range(3):
        flat[c] = rgb[c]
    return out


def debug_image(o, d, face, axis_coord, counter, debug_type: int, out):
    """The debug image of `debug_type` (module docstring) into the rgb
    planes of the HDR frame `out` (4, H, W) float32, in place. CUDA: K21,
    one launch."""
    if debug_type not in (DEBUG_ITERATIONS, DEBUG_FETCHES, DEBUG_NORMALS,
                          DEBUG_WORLD, DEBUG_EXIT):
        raise ValueError(f"debug_type {debug_type} has no image")
    if debug_type in HEATMAPS and counter is None:
        raise ValueError(f"debug_type {debug_type} needs the trace's "
                         f"{HEATMAPS[debug_type][0]}")
    if not kernels.on_cuda(o):
        return debug_image_plain(o, d, face, axis_coord, counter,
                                 debug_type, out)
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or o.dtype != F32 \
            or d.dtype != F32 or face.dtype != torch.int32 \
            or axis_coord.dtype != torch.int32:
        raise ValueError("o, d must be (N, 3) float32, face and "
                         "axis_coord int32")
    if out.dtype != F32 or out.dim() != 3 or out.shape[0] < 3 \
            or out.shape[1] * out.shape[2] != n:
        raise ValueError(f"out must be (>= 3, H, W) float32 with H * W = "
                         f"{n}")
    tensors = [o, d, face, axis_coord, out]
    if counter is not None:
        if counter.shape != (n,) or counter.dtype != torch.int32:
            raise ValueError("counter must be (N,) int32")
        tensors.append(counter)
    kernels.check_cuda(*tensors)
    kernels.launch("debug_image", o.device, o.data_ptr(), d.data_ptr(),
                   face.data_ptr(), axis_coord.data_ptr(),
                   0 if counter is None else counter.data_ptr(),
                   out.data_ptr(), n, debug_type)
    return out
