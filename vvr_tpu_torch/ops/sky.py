"""Analytic atmosphere, clouds and skybox — kernel K3 (csrc/sky.cu).

Replaces vvr_tpu/ops/sky.py `write_skybox` (:285) and `write_clouds`
(:193), with `sky`, `scatter`, `stars` and `sun_colour` beside them, and the
nearest samplers with the semantics of `sample_clouds`/`sample_skybox`
(:243-330). The blocked texture tables (:337-548) are a TPU gather layout
and are not ported: on the GPU a lookup reads the plain texture.

What bounds the kernel on an H100: instruction issue. Each texel evaluates
the closed-form single-scattering sky (optical depths through IEEE sqrt,
exp and division) and, for clouds, five octaves of simplex noise; the
outputs are 4.7 MB. One thread per texel keeps every intermediate in
registers; a warp takes a tile of one face, and what every texel of a
launch shares is computed once per block. The textures depend only on
(sun, time), so the renderer rebuilds them once per 0.25 s bucket, both
from one launch (`write_sky`), off the per-frame path.
"""

from __future__ import annotations

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops.noise import sdnoise2, snoise2
from vvr_tpu_torch.utils.hash import hash12, sqrt32

F32 = torch.float32
PI = 3.14159265358979

SOLAR_IRRADIANCE = 4.0
BOTTOM_RADIUS = 6360.0
RAY_EXP_SCALE_B = -0.125
MIE_EXP_SCALE_B = -0.833333
RAY_SCATTERING = (0.005802, 0.013558, 0.033100)
MIE_SCATTERING = (0.003996, 0.003996, 0.003996)
MIE_EXTINCTION = (0.004440, 0.004440, 0.004440)
MIE_G = 0.8
ABSORB_WIDTH_A = 25.0
ABSORB_LINEAR_A = 0.066667
ABSORB_CONST_A = -0.666667
ABSORB_LINEAR_B = -0.66667
ABSORB_CONST_B = 2.666667
ABSORB_EXTINCTION = (0.000650, 0.001881, 0.000085)
CAM_POS_Y = 0.8

CLOUD_HEIGHT = 800.0     # sky.slang:259 (cloud plane y)
CLOUD_EXTENT = 8000.0    # sky.slang:261 (uv = pos/8000 + 0.5)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _norm(v):
    return sqrt32(_dot(v, v))[..., None]


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def _vec(values, like):
    return torch.tensor(values, dtype=F32, device=like.device)


def planet_bounds(ray, direction):
    """(sky.slang:71-78): sphere intersection with the planet."""
    b = _dot(ray, direction)
    c = _dot(ray, ray) - BOTTOM_RADIUS ** 2
    h = b * b - c
    t0 = -b - sqrt32(torch.clamp(h, min=0.0))
    return torch.where(h < 0.0, -1.0, t0)


def phase_ray(cos_theta):
    return 3.0 / (16.0 * PI) * (1.0 + cos_theta * cos_theta)


def phase_mie(cos_theta):
    k = 3.0 / (8.0 * PI) * (1.0 - MIE_G ** 2) / (2.0 + MIE_G ** 2)
    return k * (1.0 + cos_theta * cos_theta) / torch.pow(
        1.0 + MIE_G ** 2 - 2.0 * MIE_G * cos_theta, 1.5)


def scaled_depth(ray, direction):
    """Closed-form optical depth (sky.slang:95-118); rayleigh, mie, ozone."""
    b = _dot(ray, direction)
    c = _dot(ray, ray)
    h = sqrt32(c)
    r0 = torch.clamp(h - 1.0 / RAY_EXP_SCALE_B, min=BOTTOM_RADIUS)
    r1 = torch.clamp(h - 1.0 / MIE_EXP_SCALE_B, min=BOTTOM_RADIUS)
    r2 = torch.clamp(h, min=BOTTOM_RADIUS + 1.5 * ABSORB_WIDTH_A
                     + 0.5 * ABSORB_CONST_B / ABSORB_LINEAR_B)
    r3 = torch.clamp(h, min=BOTTOM_RADIUS + 1.5 * ABSORB_WIDTH_A
                     + 0.5 * ABSORB_CONST_A / ABSORB_LINEAR_A)
    above = torch.clamp(h - BOTTOM_RADIUS, min=0.0)
    s0 = torch.exp(above * RAY_EXP_SCALE_B)
    s1 = torch.exp(above * MIE_EXP_SCALE_B)

    def disc(r):
        return sqrt32(torch.clamp(b * b + r * r - c, min=0.0))

    return torch.stack([s0 * (disc(r0) - b), s1 * (disc(r1) - b),
                        disc(r3) - disc(r2)], -1)


def optical_depth(ray, direction):
    """(sky.slang:120-131)."""
    mid = _dot(ray, direction)[..., None]
    up = scaled_depth(ray, direction)
    down = (scaled_depth(ray - direction * mid, direction) * 2.0
            - scaled_depth(ray, -direction))
    return torch.where(mid > 0.0, up, down)


def _attenuate(a, b):
    """(sky.slang:134-140), NaN-safe."""
    denom = b - a
    fst = (torch.exp(-a) - torch.exp(-b)) / torch.where(
        torch.abs(denom) < 1e-5, 1.0, denom)
    return torch.where(torch.abs(a - b) < 1e-5, torch.exp(-a), fst)


def _extinct(x, like):
    """einsum('...i,ij->...j', x, [RAY_SCATTERING, MIE_EXTINCTION,
    ABSORB_EXTINCTION])."""
    e0 = _vec(RAY_SCATTERING, like)
    e1 = _vec(MIE_EXTINCTION, like)
    e2 = _vec(ABSORB_EXTINCTION, like)
    return (x[..., 0:1] * e0 + x[..., 1:2] * e1) + x[..., 2:3] * e2


def scatter(ray, direction, light, depth):
    """Combined single scattering (sky.slang:143-169)."""
    opt_view_start = optical_depth(ray, direction)
    opt_light_start = optical_depth(ray, light)
    hit_ground = depth[..., None] >= 0.0
    end_point = ray + direction * depth[..., None]
    opt_view_end = torch.where(hit_ground,
                               optical_depth(end_point, direction), 0.0)
    opt_light_end = torch.where(hit_ground,
                                optical_depth(end_point, light), 0.0)
    a = _extinct(opt_light_start, ray)
    b = _extinct(opt_light_end + opt_view_start - opt_view_end, ray)
    attn = _attenuate(a, b)
    cos_gamma = _dot(direction, light)[..., None]
    dv = opt_view_start - opt_view_end
    return SOLAR_IRRADIANCE * (
        attn * dv[..., 0:1] * _vec(RAY_SCATTERING, ray) * phase_ray(cos_gamma)
        + attn * dv[..., 1:2] * _vec(MIE_SCATTERING, ray)
        * phase_mie(cos_gamma))


def stars(rd):
    """Night stars (sky.slang:171-183)."""
    y = rd[..., 1]
    uv = rd[..., [0, 2]] / (y[..., None] + 1.0)
    cell = torch.floor(uv * 700.0 + 234.0)
    brightness = _smooth(torch.clamp((hash12(cell) - 0.98) / 0.02, 0.0, 1.0))
    return torch.where(y <= 0.0, 0.0, brightness * 0.5 * y)


def sun_colour(light):
    """Sunset<->midday lerp by sun height (sky.slang:189-195)."""
    midday = torch.pow(_vec((252, 232, 212), light) / 255.0, 1 / 2.2)
    sunset = torch.pow(_vec((249, 128, 7), light) / 255.0, 1 / 2.2)
    t = _smooth(torch.clamp(light[..., 1] / 0.2, 0.0, 1.0))
    return sunset + (midday - sunset) * t[..., None]


def sky(sun_dir, ray_dir, extra_light: bool = True):
    """Sky radiance for direction(s) (sky.slang:198-222)."""
    sun_h = sun_dir[..., 1]
    day = _smooth(torch.clamp((sun_h + 0.1) / 0.2, 0.0, 1.0))
    night = 1.0 - _smooth(torch.clamp((sun_h + 0.3) / 0.3, 0.0, 1.0))
    ray_start = torch.zeros_like(ray_dir) + _vec(
        (0.0, CAM_POS_Y + BOTTOM_RADIUS, 0.0), ray_dir)
    planet = planet_bounds(ray_start, ray_dir)
    sd = sun_dir / _norm(sun_dir)
    res = scatter(ray_start, ray_dir, sd, planet) * 4.0 * day[..., None]
    if extra_light:
        cos_sun = _dot(ray_dir, sun_dir)
        disc_t = torch.clamp((cos_sun - 0.9999) / (0.999935 - 0.9999),
                             0.0, 1.0)
        res = res + (_smooth(disc_t) * day * 500.0)[..., None] \
            * sun_colour(sun_dir)
        res = res + (stars(ray_dir) * 0.3 * night)[..., None]
    return res


# ---------------------------------------------------------------------------
# the texture passes
# ---------------------------------------------------------------------------

def _face_dirs(face: int, u, v):
    """uv in [-1,1]^2 -> unnormalized direction (sky_compute.slang:62-97)."""
    one = torch.ones_like(u)
    return torch.stack({0: (-one, -v, u), 1: (one, -v, -u),
                        2: (-u, one, -v), 3: (-u, -one, v),
                        4: (-u, -v, -one), 5: (u, -v, one)}[face], -1)


def _texel_grid(r: int):
    """arange(r) / r in float32, divided on the CPU: torch's CUDA division
    by a Python scalar multiplies by its rounded reciprocal, which moves
    texels by an ulp where r is not a power of two, and the sky amplifies
    that (the kernel and the JAX package divide)."""
    return torch.arange(r, dtype=F32) / r


def write_skybox_plain(sun, resolution: int = 256):
    """(6, R, R, 3) cubemap of sky radiance (sky_compute.slang:100-110)."""
    r = resolution
    g = _texel_grid(r).to(sun.device) * 2.0 - 1.0
    vv, uu = torch.meshgrid(g, g, indexing="ij")      # [row=v, col=u]
    faces = []
    for f in range(6):
        d = _face_dirs(f, uu, vv)
        d = d / _norm(d)
        d = d * _vec((-1.0, 1.0, -1.0), sun)
        faces.append(sky(sun.expand(d.shape), d, extra_light=True))
    return torch.stack(faces)


def write_clouds_plain(sun, time, resolution: int = 512):
    """(R, R, 4) f32 rgba cloud texture (sky_compute.slang:17-59)."""
    r = resolution
    ij = _texel_grid(r).to(sun.device)
    uvy, uvx = torch.meshgrid(ij, ij, indexing="ij")  # [row, col] = (y, x)
    px = (uvx - 0.5) * CLOUD_EXTENT
    pz = (uvy - 0.5) * CLOUD_EXTENT
    drift = torch.as_tensor(time, dtype=F32, device=sun.device) * 0.03

    value = torch.zeros_like(px)
    dx = torch.zeros_like(px)
    dy = torch.zeros_like(px)
    for i in range(4):
        f = (2.3 ** i) * 0.0015
        v, gx, gy = sdnoise2(px * f + drift, pz * f + drift, seed=17 + i)
        a = 0.7 ** i
        value = value + v * a
        dx = dx + gx * a
        dy = dy + gy * a

    mod = snoise2(px * 0.0005, pz * 0.0005, seed=3) * 1.5 - 0.2
    mod = _smooth(torch.clamp(mod, 0.0, 1.0))
    opacity = value * mod * 6.0

    ray_dir = torch.stack([px, torch.full_like(px, CLOUD_HEIGHT), pz], -1)
    ray_dir = ray_dir / _norm(ray_dir)
    bottom_n = torch.stack([dx, -torch.ones_like(px), dy], -1)
    bottom_n = bottom_n / _norm(bottom_n)
    top_n = -bottom_n

    sun_strength = _smooth(torch.clamp(sun[1] / 0.2, 0.0, 1.0))
    scattered = torch.clamp(torch.pow(
        torch.clamp(_dot(ray_dir, sun), 0.0, 1.0) + 0.3, 4.0), 0.0, 1.0) \
        * sun_strength
    reflected = sun - 2.0 * _dot(bottom_n, sun)[..., None] * bottom_n
    silver = torch.pow(torch.clamp(_dot(ray_dir, reflected), 0.0, 1.0),
                       0.5) * sun_strength
    ambient = sky(sun.expand(top_n.shape), top_n, extra_light=False)
    col = ((silver * 0.3)[..., None] * (1.0 - scattered[..., None])
           + 1.4 * scattered[..., None] + 0.4) * (ambient + 0.3)
    return torch.cat([col, torch.clamp(opacity, 0.0, 1.0)[..., None]], -1)


def _host_sun(sun):
    """The sun as three python floats (kernel arguments) and as a float32
    tensor; `sun` may be a (3,) array or tensor on any device."""
    s = torch.as_tensor(sun, dtype=F32).cpu().reshape(-1)[:3]
    return tuple(float(c) for c in s), s


def _launch_sky(sun, time, r_sky, r_clouds, device):
    """K3 on a CUDA `device`: one launch that writes the textures whose
    resolution is not None; (skybox or None, clouds or None)."""
    (sx, sy, sz), _ = _host_sun(sun)
    for r in (r_sky, r_clouds):
        if r is not None and r < 1:
            raise ValueError(f"sky texture resolution {r}")
    skybox = clouds = None
    if r_sky is not None:
        skybox = torch.empty((6, r_sky, r_sky, 3), dtype=F32, device=device)
    if r_clouds is not None:
        clouds = torch.empty((r_clouds, r_clouds, 4), dtype=F32,
                             device=device)
        if clouds.data_ptr() % 16:
            raise ValueError("clouds must be 16-byte aligned (float4)")
    out = skybox if skybox is not None else clouds
    kernels.launch("write_sky", out.device, sx, sy, sz, float(time),
                   r_sky or 0, r_clouds or 0,
                   0 if skybox is None else skybox.data_ptr(),
                   0 if clouds is None else clouds.data_ptr())
    return skybox, clouds


def write_sky(sun, time, r_sky: int = 256, r_clouds: int = 512,
              device="cuda"):
    """(skybox (6, r_sky, r_sky, 3), clouds (r_clouds, r_clouds, 4)) on
    `device`: write_skybox and write_clouds at one (sun, time). CUDA: K3,
    one launch for both."""
    if not kernels.on_cuda(device):
        s = _host_sun(sun)[1].to(device)
        return (write_skybox_plain(s, r_sky),
                write_clouds_plain(s, time, r_clouds))
    return _launch_sky(sun, time, r_sky, r_clouds, device)


def write_skybox(sun, time=0.0, resolution: int = 256,
                 device="cuda"):
    """(6, R, R, 3) cubemap on `device`; `time` is accepted for the JAX
    signature (the sky does not depend on it). CUDA: K3, the skybox
    only."""
    if not kernels.on_cuda(device):
        return write_skybox_plain(_host_sun(sun)[1].to(device), resolution)
    return _launch_sky(sun, 0.0, resolution, None, device)[0]


def write_clouds(sun, time, resolution: int = 512, device="cuda"):
    """(R, R, 4) cloud texture on `device` at `time` (seconds, taken as
    float32). CUDA: K3, the clouds only."""
    if not kernels.on_cuda(device):
        return write_clouds_plain(_host_sun(sun)[1].to(device), time,
                                  resolution)
    return _launch_sky(sun, time, None, resolution, device)[1]


# ---------------------------------------------------------------------------
# nearest samplers on the plain textures (the plain shade path's lookups;
# csrc/clouds.cuh and csrc/shading.cuh have the device copies)
# ---------------------------------------------------------------------------

def sample_clouds(clouds_tex, dx, dy, dz, px, py, pz):
    """Cloud rgba (N, 4) along rays (d, from p) via the cloud-plane
    intersection (sky.slang:283-294); 0 where the plane is not ahead or
    the hit leaves the texture. Nearest texel, truncating casts."""
    r = clouds_tex.shape[0]
    denom = -dy
    t = -(CLOUD_HEIGHT - py) / torch.where(torch.abs(denom) < 1e-4, 1.0,
                                           denom)
    # the extent as a tensor: torch on the card divides by a Python
    # number as a multiply by its reciprocal, which can move a texel; a
    # tensor divisor divides exactly there, as the CPU and the kernels do
    ext = torch.tensor(CLOUD_EXTENT, dtype=torch.float32, device=px.device)
    u = (px + t * dx) / ext + 0.5
    v = (pz + t * dz) / ext + 0.5
    valid = ((torch.abs(denom) > 1e-4) & (t >= 0) & (u >= 0) & (u <= 1)
             & (v >= 0) & (v <= 1))
    iu = torch.clamp(torch.trunc(u * r), 0, r - 1).to(torch.int64)
    iv = torch.clamp(torch.trunc(v * r), 0, r - 1).to(torch.int64)
    rgba = clouds_tex.reshape(-1, 4)[iv * r + iu]
    return torch.where(valid[:, None], rgba, 0.0)


def sample_skybox(skybox, dx, dy, dz):
    """Nearest cubemap sample (N, 3), the exact inverse of the
    write_skybox face mapping."""
    r = skybox.shape[1]
    x, y, z = dx * -1.0, dy, dz * -1.0
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 1, 0),
                       torch.where(is_y, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 5, 4)))
    m = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                    min=1e-12)
    xn, yn, zn = x / m, y / m, z / m
    u = torch.where(face == 0, zn, torch.where(
        face == 1, -zn, torch.where(face == 5, xn, -xn)))
    v = torch.where(face == 2, -zn, torch.where(face == 3, zn, -yn))
    iu = torch.clamp(torch.trunc((u * 0.5 + 0.5) * r), 0, r - 1)
    iv = torch.clamp(torch.trunc((v * 0.5 + 0.5) * r), 0, r - 1)
    flat = (face * r + iv.to(torch.int64)) * r + iu.to(torch.int64)
    return skybox.reshape(-1, 3)[flat]


def sun_colour_final(sun):
    """The frame's sun radiance: 3.2 * sun_colour while the sun is up
    (frame.py:170-171)."""
    return torch.where(sun[1] > 0, 3.2 * sun_colour(sun), 0.0)

