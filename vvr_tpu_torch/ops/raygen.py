"""Camera ray generation — kernel K13 `generate_rays` (csrc/raygen.cu).

Counterpart of vvr_tpu/ops/raygen.py: pinhole primary rays, row-major from
the top-left (row 0 = top of image, +u right, +v up), with its fixed-order
normalize, every op correctly rounded. The JAX package's jitted rays differ
in the last ulp or two on about half of the directions: XLA folds
`/ width * 2.0` into one multiply and contracts the direction's
multiply-adds.

On a CUDA device `camera_rays` launches K13 once, with the camera as float
arguments: no host-to-device copy and no other launch. Each K13 block
writes its span of 1024 rays whole, as 16-byte stores. K13 is bit-exact
against `generate_rays` run on the CPU (its divisions are divisions and its
sqrtf is correctly rounded without fast math), so K9's raster keys and
K12's starts, which come from `d`, do not depend on where the rays were
made.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.utils.hash import sqrt32

F32 = torch.float32


def normalize_dirs(d):
    """Normalize (..., 3) directions with a fixed op sequence
    ((x*x + y*y) + z*z, then a correctly rounded sqrt and divide)."""
    n = sqrt32((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
               + d[..., 2] * d[..., 2])
    return d / n[..., None]


def generate_rays(position, right, up, forward, tan_half_h, width: int,
                  height: int):
    """Returns (o, d): ((H*W, 3), (H*W, 3)) f32 contiguous tensors on the
    device of `position`, row-major top-left first."""
    dev = position.device
    ratio = width / height
    u = (torch.arange(width, dtype=F32, device=dev) + 0.5) / width * 2.0 - 1.0
    v = 1.0 - (torch.arange(height, dtype=F32, device=dev) + 0.5) \
        / height * 2.0
    tx = tan_half_h
    ty = tan_half_h / ratio
    du = u[None, :, None] * tx * right[None, None, :]
    dv = v[:, None, None] * ty * up[None, None, :]
    d = normalize_dirs(forward[None, None, :] + du + dv).reshape(-1, 3)
    o = position.expand(d.shape).contiguous()
    return o, d.contiguous()


def frustum(fov: float, width: int, height: int) -> tuple[float, float]:
    """(tx, ty): the tangents of the half field of view across and up, as
    float32 values rounded as generate_rays rounds them on the CPU."""
    tan_half = torch.tensor(np.float32(np.tan(np.radians(fov) / 2.0)))
    return float(tan_half), float(tan_half / (width / height))


def camera_rays(cam: Camera, width: int, height: int,
                device="cuda"):
    """(o, d): the camera's (H*W, 3) float32 primary rays on `device`.
    CUDA: K13, one launch."""
    right, up, forward = cam.basis()
    if kernels.on_cuda(device):
        dev = torch.device(device)
        n = width * height
        o = torch.empty((n, 3), dtype=F32, device=dev)
        d = torch.empty((n, 3), dtype=F32, device=dev)
        vecs = (cam.position, right, up, forward)
        kernels.launch("generate_rays", dev,
                       *(float(c) for v in vecs
                         for c in np.asarray(v, np.float32)),
                       *frustum(cam.fov, width, height), width, height,
                       o.data_ptr(), d.data_ptr())
        return o, d
    tan_half = np.float32(np.tan(np.radians(cam.fov) / 2.0))

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return generate_rays(vec(cam.position), vec(right), vec(up),
                         vec(forward), torch.tensor(tan_half, device=device),
                         width, height)
