"""Primary visibility by exposed-face rasterization — kernels K9
`raster_fragments` and K10 `raster_resolve` (csrc/raster.cu).

Replaces vvr_tpu/ops/rastertrace.py:190 `trace_raster` (full frame; the
band mode of multi-chip sharding waits for ROADMAP A16). Every first hit of
a primary ray from an empty-space camera lies on an exposed face
(world/faces.py), so the frame's first hits are a depth-min rasterization
of the merged faces:

  K9  each visible face's fragments (pixel bbox, or the whole screen for a
      face that straddles the camera plane) test coverage with the oracle's
      own formulas on the wavefront's direction d (the crossing's t, and
      the oracle's cell at that crossing, `cell_at`), and each covered
      pixel keeps the least key (t_bits - 0x20000000) << 2 | axis;
  K10 per pixel, the key's t and axis, the winning plane by the
      two-candidate window match, then start-in-solid and origin-outside.

The result is a TraceResult of the jump tracer's form with zero counters,
equal to the DDA's (hit, face, axis_coord, t) bit for bit. The TPU
design's fixed entry capacity, cumulative-max face map and full-screen net
for overflowing faces exist for static shapes and are not ported; the CUDA
kernel sizes its work with a scan, and the plain version enumerates every
fragment in chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.jump import BIG_T, TraceResult
from vvr_tpu_torch.utils.camera import Camera

F32 = torch.float32
SENTINEL = 0xFFFFFFFF
BITS_BIAS = 0x20000000
MASK32 = 0xFFFFFFFF
# fragments per chunk of the plain version (bounds its memory)
PLAIN_CHUNK = 1 << 22


def raster_camera(cam: Camera) -> tuple:
    """(position, right, up, forward, tan_half) as float32 numpy values,
    the camera tuple of vvr_tpu's renderer (renderer.py:171-178)."""
    right, up, forward = cam.basis()
    return (np.asarray(cam.position, np.float32),
            np.asarray(right, np.float32), np.asarray(up, np.float32),
            np.asarray(forward, np.float32),
            np.float32(np.tan(np.radians(cam.fov) / 2.0)))


def _sel3(a, x, y, z):
    return torch.where(a == 0, x, torch.where(a == 1, y, z))


def _floor_int(x):
    """int(floor(x)) clamped to +-1e9 in float first (the CUDA copy is
    vvr_floor_int)."""
    return torch.clamp(torch.floor(x), -1e9, 1e9).to(torch.int64)


def project_faces(faces, cam, width: int, height: int):
    """(use, imin, imax, jmin, jmax) per face: whether the face makes
    fragments, and its pixel bbox (the whole screen for a face straddling
    the camera plane). `_project_faces` of the JAX package, with a margin
    of 0.01 pixel."""
    vx, vy, vz, axis, sgn, eu, ev = faces[:7]
    dev = vx.device
    pos, right, up, fwd = (torch.as_tensor(np.asarray(c, np.float32),
                                           device=dev) for c in cam[:4])
    tx = torch.tensor(cam[4], dtype=F32, device=dev)
    ty = tx / torch.tensor(np.float32(width / height), device=dev)
    plane = (_sel3(axis, vx, vy, vz) + sgn).to(F32)
    o_a = pos[axis.long()]
    visible = torch.where(sgn == 1, o_a > plane, o_a < plane) & (eu > 0)
    euf, evf = eu.to(F32), ev.to(F32)
    n = vx.shape[0]
    imin = torch.full((n,), width, dtype=torch.int64, device=dev)
    jmin = torch.full((n,), height, dtype=torch.int64, device=dev)
    imax = torch.full((n,), -1, dtype=torch.int64, device=dev)
    jmax = torch.full((n,), -1, dtype=torch.int64, device=dev)
    some_behind = torch.zeros(n, dtype=torch.bool, device=dev)
    all_behind = torch.ones(n, dtype=torch.bool, device=dev)
    hw = np.float32(width * 0.5)
    hh = np.float32(height * 0.5)
    for du in (0.0, 1.0):
        for dv in (0.0, 1.0):
            cx = torch.where(axis == 0, plane, vx.to(F32) + du * euf)
            cy = torch.where(axis == 1, plane, vy.to(F32) + torch.where(
                axis == 0, du * euf, dv * evf))
            cz = torch.where(axis == 2, plane, vz.to(F32) + dv * evf)
            q = (cx - pos[0], cy - pos[1], cz - pos[2])
            zc, xc, yc = ((q[0] * b[0] + q[1] * b[1]) + q[2] * b[2]
                          for b in (fwd, right, up))
            beh = zc <= 1e-6
            some_behind |= beh
            all_behind &= beh
            zs = torch.clamp(zc, min=1e-6)
            ic = (xc / (zs * tx) + 1.0) * hw - 0.5
            jc = (1.0 - yc / (zs * ty)) * hh - 0.5
            imin = torch.minimum(imin, _floor_int(ic - 0.01))
            imax = torch.maximum(imax, -_floor_int(-(ic + 0.01)))
            jmin = torch.minimum(jmin, _floor_int(jc - 0.01))
            jmax = torch.maximum(jmax, -_floor_int(-(jc + 0.01)))
    visible &= ~all_behind
    straddle = some_behind & ~all_behind
    onscreen = (imax >= 0) & (imin <= width - 1) & (jmax >= 0) \
        & (jmin <= height - 1)
    use = visible & (straddle | onscreen)
    imin = torch.where(straddle, 0, torch.clamp(imin, 0, width - 1))
    imax = torch.where(straddle, width - 1, torch.clamp(imax, 0, width - 1))
    jmin = torch.where(straddle, 0, torch.clamp(jmin, 0, height - 1))
    jmax = torch.where(straddle, height - 1,
                       torch.clamp(jmax, 0, height - 1))
    return use, imin, imax, jmin, jmax


def cell_at(o_u, d_u, t_a, u_first):
    """The oracle's cell along axis u when the ray crosses a plane of axis
    a at t_a (the CUDA copy is vvr_cell_at): its DDA merges the per-axis
    crossings t = (bound - o) * (1/d), ties stepped z, y, x, so a
    u-crossing comes first iff t_u < t_a, or t_u == t_a and u > a
    (`u_first`). Starts from floor(o_u + d_u * t_a) and moves it until the
    crossings into and out of the cell agree."""
    c = _floor_int(o_u + d_u * t_a)
    c0 = _floor_int(o_u)
    moving = d_u != 0.0
    inv = torch.where(moving, 1.0 / d_u, 1.0)
    pos = d_u > 0.0
    step = torch.where(pos, 1, -1)

    def first(t_u):
        return (t_u < t_a) | ((t_u == t_a) & u_first)

    for _ in range(4):
        t_in = (torch.where(pos, c, c + 1).to(F32) - o_u) * inv
        t_out = (torch.where(pos, c + 1, c).to(F32) - o_u) * inv
        back = moving & (c != c0) & ~first(t_in)
        ahead = moving & ~back & first(t_out)
        c = c - torch.where(back, step, 0) + torch.where(ahead, step, 0)
    return c


def axis_key(t, axis):
    """(t_bits - BIAS) << 2 | axis as int64 holding u32 values, for
    positive t: u32 order is t order, ties resolve x > y > z."""
    b = t.view(torch.int32).to(torch.int64) & MASK32
    b = torch.where(b > BITS_BIAS, b - BITS_BIAS, 0)
    return ((b << 2) | axis.to(torch.int64)) & MASK32


def _to_u32_bits(x):
    """int64 holding u32 values -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def raster_fragments_plain(faces, cam, d_rays, width: int, height: int):
    """Plain torch K9: the least key of every pixel, (H*W,) int32 holding
    u32 bit patterns (SENTINEL where no fragment covers the pixel)."""
    vx, vy, vz, axis, sgn, eu, ev = faces[:7]
    dev = d_rays.device
    pos = torch.as_tensor(np.asarray(cam[0], np.float32), device=dev)
    use, imin, imax, jmin, jmax = project_faces(faces, cam, width, height)
    bw = imax - imin + 1
    cnt = torch.where(use, bw * (jmax - jmin + 1), 0)
    plane = (_sel3(axis, vx, vy, vz) + sgn).to(F32)
    keys = torch.full((width * height,), SENTINEL, dtype=torch.int64,
                      device=dev)
    ends = torch.cumsum(cnt, 0)
    ends_h = ends.cpu().numpy()
    starts_h = ends_h - cnt.cpu().numpy()
    f0 = 0
    while f0 < len(ends_h):
        # the faces whose fragments fit in one chunk (at least one face)
        base = int(starts_h[f0])
        f1 = max(int(np.searchsorted(ends_h, base + PLAIN_CHUNK, "right")),
                 f0 + 1)
        fs = torch.arange(f0, f1, device=dev)
        fidx = torch.repeat_interleave(fs, cnt[f0:f1])
        f0 = f1
        if fidx.numel() == 0:
            continue
        local = (torch.arange(fidx.numel(), device=dev) + base
                 - (ends[fidx] - cnt[fidx]))
        i = imin[fidx] + local % bw[fidx]
        j = jmin[fidx] + torch.div(local, bw[fidx], rounding_mode="floor")
        pix = j * width + i
        d = d_rays[pix]
        ax = axis[fidx].long()
        d_a = d.gather(1, ax[:, None])[:, 0]
        inv_a = torch.where(d_a == 0.0, BIG_T, 1.0 / d_a)
        t = (plane[fidx] - pos[ax]) * inv_a
        # in-plane axes (u, v): axis 0 -> (y, z), 1 -> (x, z), 2 -> (x, y)
        ua = torch.where(ax == 0, 1, 0)
        va = torch.where(ax == 2, 1, 2)
        u_c = cell_at(pos[ua], d.gather(1, ua[:, None])[:, 0], t, ua > ax)
        v_c = cell_at(pos[va], d.gather(1, va[:, None])[:, 0], t, va > ax)
        u_0 = torch.where(ax == 0, vy[fidx], vx[fidx])
        v_0 = torch.where(ax == 2, vy[fidx], vz[fidx])
        cover = ((t > 0.0) & (u_c >= u_0) & (u_c < u_0 + eu[fidx])
                 & (v_c >= v_0) & (v_c < v_0 + ev[fidx]))
        keys.scatter_reduce_(0, pix[cover], axis_key(t[cover], ax[cover]),
                             "amin")
    return _to_u32_bits(keys)


def raster_resolve_plain(keys, cam, d_rays, probe: bool,
                         size: int) -> TraceResult:
    """Plain torch K10: the trace outputs from the per-pixel keys."""
    dev = d_rays.device
    pos = torch.as_tensor(np.asarray(cam[0], np.float32), device=dev)
    k = keys.to(torch.int64) & MASK32
    n = k.shape[0]
    hit = k != SENTINEL
    wbits = (k >> 2) + BITS_BIAS
    face = (k & 3).long()   # 3 on a SENTINEL key: reads z, then masked
    fsel = torch.clamp(face, max=2)
    t_approx = wbits.to(torch.int32).view(F32)
    d_a = d_rays.gather(1, fsel[:, None])[:, 0]
    o_a = pos[fsel]
    h_a = o_a + d_a * t_approx
    inv_a = torch.where(d_a == 0.0, BIG_T, 1.0 / d_a)
    k0 = _floor_int(h_a)
    axis_coord = torch.zeros(n, dtype=torch.int64, device=dev)
    t_out = torch.full((n,), BIG_T, dtype=F32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for kc in (0, 1):
        ta = ((k0 + kc).to(F32) - o_a) * inv_a
        tb = ta.view(torch.int32).to(torch.int64)
        window = (tb - wbits).abs() <= 8
        match = hit & window & (ta > 0.0) & (~found | (ta < t_out))
        vc = torch.where(d_a > 0, k0 + kc, k0 + kc - 1)
        axis_coord = torch.where(match, vc, axis_coord)
        t_out = torch.where(match, ta, t_out)
        found |= match
    face = torch.where(hit, face, 0)
    inside = bool(((pos >= 0) & (pos < size)).all())
    if probe and inside:
        # start in solid: t 0, face 0, axis_coord the start cell's x
        face = torch.zeros_like(face)
        axis_coord = torch.full_like(axis_coord, min(max(
            int(np.floor(cam[0][0])), 0), size - 1))
        t_out = torch.zeros_like(t_out)
        hit = torch.ones_like(hit)
    hit = hit & inside
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    return TraceResult(hit=hit, face=face.to(torch.int32),
                       axis_coord=torch.where(hit, axis_coord, 0).to(
                           torch.int32),
                       t=torch.where(hit, t_out, BIG_T), iterations=zero,
                       fetches=zero, missed_pops=zero)


def _check_faces(faces, d_rays):
    if len(faces) < 7:
        raise ValueError("faces must be FaceSet.device_tuple()")
    for a in faces[:7]:
        if a.dtype != torch.int32 or a.shape != faces[0].shape:
            raise ValueError("face arrays must be int32 of one length")
    if d_rays.dim() != 2 or d_rays.shape[1] != 3 or d_rays.dtype != F32:
        raise ValueError("d_rays must be (N, 3) float32")


def raster_fragments(faces, cam, d_rays, width: int, height: int):
    """Per-pixel least fragment keys, (H*W,) int32 holding u32 bits.
    CUDA: K9."""
    if not kernels.on_cuda(d_rays):
        return raster_fragments_plain(faces, cam, d_rays, width, height)
    _check_faces(faces, d_rays)
    if d_rays.shape[0] != width * height:
        raise ValueError(f"{d_rays.shape[0]} rays for {width}x{height}")
    kernels.check_cuda(d_rays, *faces[:7])
    dev = d_rays.device
    nf = faces[0].shape[0]
    scratch = torch.empty(nf + (nf + 1023) // 1024 + 1, dtype=torch.int64,
                          device=dev)
    boxes = torch.empty((nf, 4), dtype=torch.int32, device=dev)
    keys = torch.empty(width * height, dtype=torch.int32, device=dev)
    pos, right, up, fwd, tan_half = cam
    kernels.launch(
        "raster_fragments", dev, *(a.data_ptr() for a in faces[:7]), nf,
        *(float(c) for v in (pos, right, up, fwd) for c in v),
        float(tan_half), float(np.float32(width / height)), width, height,
        d_rays.data_ptr(), scratch.data_ptr(), boxes.data_ptr(),
        keys.data_ptr())
    return keys


def raster_resolve(keys, cam, d_rays, probe: bool, size: int) -> TraceResult:
    """Trace outputs from the per-pixel keys. CUDA: K10."""
    if not kernels.on_cuda(d_rays):
        return raster_resolve_plain(keys, cam, d_rays, probe, size)
    n = d_rays.shape[0]
    if keys.dtype != torch.int32 or keys.shape != (n,):
        raise ValueError("keys must be (N,) int32")
    kernels.check_cuda(keys, d_rays)
    dev = d_rays.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    axis_coord = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.empty(n, dtype=F32, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    px, py, pz = (float(c) for c in cam[0])
    kernels.launch("raster_resolve", dev, keys.data_ptr(), d_rays.data_ptr(),
                   px, py, pz, int(bool(probe)), size, n, hit.data_ptr(),
                   face.data_ptr(), axis_coord.data_ptr(), t.data_ptr())
    return TraceResult(hit, face, axis_coord, t, zero, zero, zero)


def trace_raster(faces, cam, d_rays, probe: bool, size: int, width: int,
                 height: int) -> TraceResult:
    """First hits of the camera's H x W primary rays against the face set.

    faces:  FaceSet.device_tuple() (int32 arrays)
    cam:    raster_camera(camera)
    d_rays: (H*W, 3) f32, the wavefront's own directions (camera_rays)
    probe:  whether the camera's voxel is solid (Scene.solid_at_host)
    Returns a TraceResult over H*W rays, row-major from the top left, with
    zero counters. CUDA tensors launch K9 then K10; CPU tensors run the
    plain versions."""
    keys = raster_fragments(faces, cam, d_rays, width, height)
    return raster_resolve(keys, cam, d_rays, probe, size)
