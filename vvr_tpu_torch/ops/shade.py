"""Surface reconstruction and shading of bounce 0 — kernel K2 (csrc/shade.cu).

Replaces the bounce-0 body of vvr_tpu/render/frame.py:192-570 for the
slice configuration (hard shadows or none, no mirrors, no AO, no point
lights) together with the ops/shade.py pieces it calls (`material_at_soa`,
`get_face_normal_soa`, `lighting_soa`) and the cloud/skybox lookups. Two
entry points, because the shadow trace (K1) sits between them:

  surface: hit reconstruction (frame.py:218-238), the face normal, the
           shadow-ray origin `surface + sun*0.05` and the shadow mask
           `hit & n.l > 0` (:310-311, :466-467);
  shade:   albedo hash (shade.py:162-182), the merged cloud sample (along
           the sun from the surface on hit lanes, along the camera ray on
           miss lanes, :297-307), the shadow factor (:481-482),
           Cook-Torrance `lighting_soa`, the sky with cloud blend on a miss
           (:527-542) and alpha 10 on a miss. It writes planar HDR
           (4, H, W).

What bounds them on an H100: memory traffic, a few dozen bytes per pixel
in and 16 out, with two texture gathers (clouds 4 MiB, skybox 4.7 MiB,
both L2-resident). One thread per pixel recomputes the hit point in the
second kernel instead of storing it, and reads the trace outputs once.

The block-colour hash turns one ulp into an O(1) colour change, so every
sum keeps the JAX order and the CUDA file is compiled without FMA
contraction.
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.sky import sample_clouds, sample_skybox
from vvr_tpu_torch.utils.hash import per_block_unique_colour

F32 = torch.float32
PI = 3.1415926538
ROUGHNESS = 0.80   # the uniform terrain material (raytracer.slang:199-224)


def aces(x):
    """ACES filmic tonemap (lighting.slang:7-14)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def get_face_normal_soa(face, sgnx, sgny, sgnz):
    """SoA get_face_normal: (nx, ny, nz) flat tensors."""
    return (torch.where(face == 0, -sgnx, 0.0),
            torch.where(face == 1, -sgny, 0.0),
            torch.where(face == 2, -sgnz, 0.0))


def material_at_soa(bx, by, bz, world_size: int):
    """Albedo of integer block coords: white, or lerp(block colour, 1, 0.5)
    for blocks with x > size/2. Returns (alb_r, alb_g, alb_b)."""
    col = per_block_unique_colour(torch.stack([bx, by, bz], -1).to(F32))
    hi = bx > world_size // 2
    return tuple(torch.where(hi, col[:, c] + (1.0 - col[:, c]) * 0.5, 1.0)
                 for c in range(3))


def lighting_soa(albedo, normal, roughness, visibility, shadows, view,
                 sun_dir, sun_color):
    """Cook-Torrance `lighting()` for the uniform terrain material
    (metallic 0, scalar roughness), channels as separate (N,) tensors.
    sun_dir, sun_color: (3,) tensors; roughness: a scalar, used as float32
    as the JAX version's 0-d constant is. Returns (r, g, b)."""
    ax, ay, az = albedo
    nx, ny, nz = normal
    vx, vy, vz = view
    sx, sy, sz = sun_dir[0], sun_dir[1], sun_dir[2]
    hx, hy, hz = vx + sx, vy + sy, vz + sz
    hn = torch.clamp(torch.sqrt((hx * hx + hy * hy) + hz * hz), min=1e-12)
    hx, hy, hz = hx / hn, hy / hn, hz / hn

    # the scalar chain in float32, not in python doubles
    roughness = torch.as_tensor(roughness, dtype=F32, device=ax.device)
    f0 = torch.tensor(0.04, dtype=F32, device=ax.device)
    hv = torch.clamp((hx * vx + hy * vy) + hz * vz, 0.0, 1.0)
    cos_t = torch.clamp(1.0 - torch.clamp(hv, min=0.0), 0.0, 1.0)
    ks = f0 + (torch.maximum(1.0 - roughness, f0) - f0) \
        * torch.pow(cos_t, 5.0)
    kd = 1.0 - ks

    a = roughness * roughness
    a2 = a * a
    n_dot_h = torch.clamp((nx * hx + ny * hy) + nz * hz, min=0.0)
    semi = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    nd = a2 / (PI * semi * semi)
    r1 = roughness + 1.0
    k = (r1 * r1) / 8.0
    nv = torch.clamp((nx * vx + ny * vy) + nz * vz, min=0.0)
    nl = torch.clamp((nx * sx + ny * sy) + nz * sz, min=0.0)
    g = (nv / (nv * (1.0 - k) + k)) * (nl / (nl * (1.0 - k) + k))
    fr = f0 + (1.0 - f0) * torch.pow(1.0 - hv, 5.0)
    denom = torch.clamp(4.0 * nv * nl, min=1e-4)
    tmp = nd * g * fr / denom
    spec = torch.where(torch.isinf(tmp), 1000.0, torch.clamp(tmp, 0.0, 1000.0))

    n_dot_l = torch.clamp((sx * nx + sy * ny) + sz * nz, min=0.0)
    w = n_dot_l * shadows
    amb = 0.2 * kd * visibility * 0.2
    return tuple((kd * alb / PI + spec) * sun_color[c] * w + amb * alb
                 for c, alb in enumerate((ax, ay, az)))


def _reconstruct(o, d, face, axis_coord):
    """Exact hit point and block of each primary ray (frame.py:212-238):
    the entry plane sits at axis_coord, +1 when entering from the high
    side. Returns (normal, world point, block) channel tuples."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    sg = tuple(torch.where(c >= 0, 1.0, -1.0) for c in (dx, dy, dz))
    normal = get_face_normal_soa(face, *sg)

    def sel(x, y, z):
        return torch.where(face == 0, x, torch.where(face == 1, y, z))

    k = axis_coord.to(F32)
    plane = k + torch.where(sel(*sg) < 0, 1.0, 0.0)
    df = sel(dx, dy, dz)
    dist = (plane - sel(ox, oy, oz)) / torch.where(torch.abs(df) < 1e-12,
                                                   1e-12, df)
    world = (torch.where(face == 0, plane, ox + dx * dist),
             torch.where(face == 1, plane, oy + dy * dist),
             torch.where(face == 2, plane, oz + dz * dist))
    ac = axis_coord.to(torch.int64)
    block = tuple(torch.where(face == a, ac, torch.floor(world[a]).to(
        torch.int64)) for a in range(3))
    return normal, world, block


def shade_surface_plain(o, d, hit, face, axis_coord, sun):
    """(shadow origins (N, 3), shadow mask (N,)) of the primary hits."""
    sun = sun.to(o.device)
    (nx, ny, nz), (wx, wy, wz), _ = _reconstruct(o, d, face, axis_coord)
    s_o = torch.stack([wx + sun[0] * 0.05, wy + sun[1] * 0.05,
                       wz + sun[2] * 0.05], -1)
    sun_facing = ((nx * sun[0] + ny * sun[1]) + nz * sun[2]) > 0.0
    return s_o, hit & sun_facing


def shade_pixel_plain(o, d, hit, face, axis_coord, shadow_hit, size: int,
                      skybox, clouds, sun, sun_col, height: int, width: int):
    """Planar HDR (4, H, W): shaded hits, sky plus clouds on misses,
    alpha 10 on a miss. `shadow_hit` None means shadows off."""
    n = o.shape[0]
    sun, sun_col = sun.to(o.device), sun_col.to(o.device)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    (nx, ny, nz), (wx, wy, wz), (bx, by, bz) = _reconstruct(
        o, d, face, axis_coord)
    alb = material_at_soa(bx, by, bz, size)
    miss = ~hit
    if shadow_hit is None:
        shadow = torch.ones(n, dtype=F32, device=o.device)
    else:
        # one merged cloud lookup: toward the sun from the surface on hit
        # lanes, along the camera ray on miss lanes
        sunv = sun.expand(n, 3)
        cl = sample_clouds(
            clouds,
            torch.where(hit, sunv[:, 0], dx), torch.where(hit, sunv[:, 1], dy),
            torch.where(hit, sunv[:, 2], dz),
            torch.where(hit, wx, ox), torch.where(hit, wy, oy),
            torch.where(hit, wz, oz))
        shadow = torch.where(shadow_hit, 0.0, 1.0 - cl[:, 3])
    lit = lighting_soa(alb, (nx, ny, nz), ROUGHNESS, 1.0, shadow,
                       (-dx, -dy, -dz), sun, sun_col)
    if shadow_hit is None:
        cl = sample_clouds(clouds, dx, dy, dz, ox, oy, oz)
    sb = sample_skybox(skybox, dx, dy, dz)
    out = [torch.where(miss, sb[:, c] + (cl[:, c] - sb[:, c]) * cl[:, 3],
                       lit[c]) for c in range(3)]
    out.append(torch.where(miss, 10.0, 0.0))
    return torch.stack(out).reshape(4, height, width)


def check_trace_inputs(o, d, hit, face, axis_coord):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or o.dtype != F32 \
            or d.dtype != F32:
        raise ValueError("o, d must be (N, 3) float32")
    if hit.dtype != torch.bool or face.dtype != torch.int32 \
            or axis_coord.dtype != torch.int32:
        raise ValueError("hit must be bool, face/axis_coord int32")


def shade_surface(o, d, hit, face, axis_coord, sun):
    """Shadow-ray origins and mask of the primary hits. CUDA: K2
    `shade_surface`."""
    if not kernels.on_cuda(o):
        return shade_surface_plain(o, d, hit, face, axis_coord, sun)
    check_trace_inputs(o, d, hit, face, axis_coord)
    kernels.check_cuda(o, d, hit, face, axis_coord)
    n = o.shape[0]
    s_o = torch.empty((n, 3), dtype=F32, device=o.device)
    s_act = torch.empty(n, dtype=torch.bool, device=o.device)
    sx, sy, sz = (float(c) for c in sun.cpu())
    kernels.launch("shade_surface", o.device, o.data_ptr(), d.data_ptr(),
                   hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(), n,
                   sx, sy, sz, s_o.data_ptr(), s_act.data_ptr())
    return s_o, s_act


def shade_pixel(o, d, hit, face, axis_coord, shadow_hit, size: int, skybox,
                clouds, sun, sun_col, height: int, width: int):
    """Planar HDR (4, H, W) of bounce 0. CUDA: K2 `shade_pixel`."""
    if not kernels.on_cuda(o):
        return shade_pixel_plain(o, d, hit, face, axis_coord, shadow_hit,
                                 size, skybox, clouds, sun, sun_col, height,
                                 width)
    check_trace_inputs(o, d, hit, face, axis_coord)
    n = o.shape[0]
    if n != height * width:
        raise ValueError(f"{n} rays for a {height}x{width} image")
    if skybox.dim() != 4 or skybox.shape[0] != 6 or clouds.dim() != 3 \
            or skybox.dtype != F32 or clouds.dtype != F32:
        raise ValueError("skybox must be (6, R, R, 3), clouds (R, R, 4), "
                         "float32")
    if clouds.data_ptr() % 16:
        raise ValueError("clouds must be 16-byte aligned (read as float4)")
    tensors = [o, d, hit, face, axis_coord, skybox, clouds]
    if shadow_hit is not None:
        tensors.append(shadow_hit)
    kernels.check_cuda(*tensors)
    out = torch.empty((4, height, width), dtype=F32, device=o.device)
    s = [float(c) for c in sun.cpu()]
    c = [float(v) for v in sun_col.cpu()]
    kernels.launch("shade_pixel", o.device, o.data_ptr(), d.data_ptr(),
                   hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(),
                   0 if shadow_hit is None else shadow_hit.data_ptr(), n,
                   size, skybox.data_ptr(), skybox.shape[1],
                   clouds.data_ptr(), clouds.shape[0], *s, *c,
                   out.data_ptr())
    return out
