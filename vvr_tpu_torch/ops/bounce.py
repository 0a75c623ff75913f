"""One bounce of the frames with mirrors, filtered AO or point lights —
kernel K15 `shade_bounce` (csrc/bounce.cu).

Replaces the bounce body of vvr_tpu/render/frame.py:192-570 for the
bounces and options K2 `shade_pixel` does not cover, with the write of its
outputs into the frame (:615-621). Each bounce's visibility trace (K9/K10
or K1 at bounce 0, K1 over the live lanes after it) and its sun shadows
(K12, K14, or K2 shade_surface and K1) run before it. For each live lane:

  1. a miss: the sky along the ray (skybox blended with the clouds, as K2)
     times the lane's colour, alpha 10;
  2. a hit: the surface (frame.py:212-238) and its albedo; with `mirror`
     the hit is a mirror when hash13 of its 8^3 block group is above 0.8
     (:241-251, utils/hash.py `hash13_soa`);
  3. a shaded hit (a hit that is no mirror): the shadow factor (K2's three
     modes), with `density` the filtered AO 1 - clip(trilinear density at
     w + n, -2 on a negative axis, * 0.5, 0, 1) (:270-277, world/svt.py),
     lit with visibility pow(ao, 1.4) (:488-492), then each of the first
     ten `lights` within 10 units of the query point: the grid's DDA (the
     jump grid's, or the paged grid's past 512^3) from the light toward
     the point, unshadowed when t + 0.1 > dist, its n.l
     with a smoothstep falloff over 10 - dist over max(dist^2, 1e-4), in
     the light's colour (utils/hash.py `light_colours`), added in light
     order (:495-519); the output is the lane's colour times that;
  4. a mirror: its continuation (:544-567): with `wavy` the normal plus
     snoise3(w * 0.85 + time) * 0.05 in every component, renormalized;
     the reflected direction d - 2 (d.n) n, the origin w + r * 1e-3, the
     colour times the albedo; the lane stays live. Its output is not
     written (it stays 0 until a later bounce writes it; a lane live after
     the last bounce stays black, :693-695).

The output is the planar HDR image (4, H, W), written in place: at bounce
0 (`active` None) every lane's four channels, 0 on mirror lanes; at a
later bounce the rgb of the shaded and missed lanes and the alpha of the
missed ones. The continuation (origins, directions, colours, live flags)
is written in place into `nxt`: the mirror lanes' rays and colours, and
the flags of the live lanes (every lane's at bounce 0); the other lanes
keep what the buffers held, which the later passes do not read (they
trace and shade the live lanes only). After bounce 0 `nxt` must be the
bounce's own inputs. The frame makes the buffers once, zero-filled
(`bounce_buffers`), and the Renderer keeps them across frames.
The JAX design's cap-wide bounce waves (grouped packs, key sorts,
scatters, `force_wide`) exist for static shapes and are not ported: one
lane a pixel at every bounce.

Rounding: the mirror hash rounds as XLA's jit does (utils/hash.py); the
AO, the lights and the continuation keep the JAX op order without FMAs,
where XLA may contract a sum: an ulp there moves a DDA only at an exact
tie. The plain version and the kernel agree bit for bit but for pow (the
lighting's and the AO's), which may differ by an ulp or two.
"""

from __future__ import annotations

import numpy as np
import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.ops import trace as tracer
from vvr_tpu_torch.ops.jump import BIG_T
from vvr_tpu_torch.ops.noise import snoise3
from vvr_tpu_torch.ops.overlap import overlap_ao_plain
from vvr_tpu_torch.ops.shade import (ROUGHNESS, _reconstruct,
                                     check_trace_inputs, lighting_soa,
                                     material_at_soa, pixelate)
from vvr_tpu_torch.ops.sky import sample_clouds, sample_skybox
from vvr_tpu_torch.utils.hash import hash13_soa, light_colours, sqrt32
from vvr_tpu_torch.world.svt import sample_density_trilinear

F32 = torch.float32
MAX_LIGHTS = 10        # the first ten lights light the frame (:495)
LIGHT_RADIUS = 10.0    # and each only within this distance
MIRROR_GROUP = 8       # mirrors are chosen per 8^3 block group
MIRROR_ABOVE = 0.8     # where hash13 of the group is above this
WAVE_FREQUENCY = 0.85  # the wavy normal's noise: snoise3(w * 0.85 + time)
WAVE_AMPLITUDE = 0.05  # times this
CONTINUE_LIFT = 1e-3   # a reflected ray starts this far along itself
LIGHT_COLOURS = light_colours(MAX_LIGHTS)   # constants of the JAX frame


def light_table(lights) -> np.ndarray:
    """(L, 6) float32, L = min(10, len(lights)): each light's position and
    its colour, as K15 takes them."""
    lights = np.asarray(lights, np.float32)
    m = min(MAX_LIGHTS, lights.shape[0])
    return np.ascontiguousarray(np.concatenate(
        [lights[:m, :3], LIGHT_COLOURS[:m]], 1), np.float32)


def bounce_buffers(n: int, device):
    """Zero-filled continuation buffers (origins, directions, colours
    (N, 3) float32, live flags (N,) bool) for `nxt`."""
    z = [torch.zeros((n, 3), dtype=F32, device=device) for _ in range(3)]
    return (*z, torch.zeros(n, dtype=torch.bool, device=device))


def mirror_lanes(hit, block):
    """The hits whose 8^3 block group is a mirror."""
    g = [torch.floor(b.to(F32) / float(MIRROR_GROUP)) for b in block]
    return hit & (hash13_soa(*g) > MIRROR_ABOVE)


def ambient_occlusion(density, world, normal):
    """1 - clip(density * 0.5, 0, 1) one voxel off the surface along the
    normal, two on a negative axis (frame.py:270-277)."""
    probe = torch.stack([w + torch.where(nn < 0, -2.0, nn)
                         for w, nn in zip(world, normal)], -1)
    return 1.0 - torch.clamp(sample_density_trilinear(density, probe) * 0.5,
                             0.0, 1.0)


def add_lights(grid: tracer.Grid, lit, table, shaded, q, normal,
               max_steps: int, rows_read=None):
    """`lit` (r, g, b) plus each light of `table` (light_table) in turn:
    the inverse-square, smoothstepped n.l term of the shaded lanes within
    LIGHT_RADIUS whose DDA from the light does not stop short of the query
    point `q` (frame.py:495-519). `rows_read` (as `tracer.trace_plain`
    takes it) gets the rows the DDAs load."""
    nx, ny, nz = normal
    lit = list(lit)
    for li in range(table.shape[0]):
        lp = torch.as_tensor(table[li, :3], device=q[0].device)
        tx, ty, tz = q[0] - lp[0], q[1] - lp[1], q[2] - lp[2]
        dist = sqrt32((tx * tx + ty * ty) + tz * tz)
        near = shaded & (dist < LIGHT_RADIUS)
        inv = 1.0 / torch.clamp(dist, min=1e-6)
        lx, ly, lz = tx * inv, ty * inv, tz * inv
        t = torch.full_like(dist, BIG_T)
        idx = torch.nonzero(near)[:, 0]
        if idx.numel():
            ld = torch.stack([lx, ly, lz], -1)[idx]
            t[idx] = tracer.trace_plain(grid, lp.expand(idx.numel(), 3), ld,
                                        max_steps, stats=False,
                                        rows_read=rows_read).t
        unshadowed = (t + 0.1) > dist
        n_dot_l = torch.clamp(-((nx * lx + ny * ly) + nz * lz), 0.0, 1.0)
        s = torch.clamp(LIGHT_RADIUS - dist, 0.0, 1.0)
        s = s * s * (3.0 - 2.0 * s)
        strength = s / torch.clamp(dist * dist, min=1e-4)
        add = (unshadowed & near).to(F32) * n_dot_l * strength
        for c in range(3):
            lit[c] = lit[c] + add * float(table[li, 3 + c])
    return lit


def continuation(o, d, world, normal, wavy: bool, time: float):
    """(origin, direction) of the reflected rays (frame.py:544-567)."""
    nn = normal
    if wavy:
        sn = snoise3(torch.stack(world, -1) * WAVE_FREQUENCY + time) \
            * WAVE_AMPLITUDE
        nn = [c + sn for c in normal]
        inv = 1.0 / torch.clamp(sqrt32((nn[0] * nn[0] + nn[1] * nn[1])
                                       + nn[2] * nn[2]), min=1e-12)
        nn = [c * inv for c in nn]
    dx, dy, dz = d.unbind(1)
    dd2 = 2.0 * ((dx * nn[0] + dy * nn[1]) + dz * nn[2])
    rf = torch.stack([dx - dd2 * nn[0], dy - dd2 * nn[1],
                      dz - dd2 * nn[2]], -1)
    return torch.stack(world, -1) + rf * CONTINUE_LIFT, rf


def shade_bounce_plain(grid: tracer.Grid, o, d, hit, face, axis_coord, shadow,
                       skybox, clouds, sun, sun_col, out, col=None,
                       active=None, pixelated: bool = False, density=None,
                       lights=None, max_steps: int = 2048,
                       mirror: bool = False, wavy: bool = False,
                       time: float = 0.0, nxt=None, overlap_ao: bool = False,
                       rows_read=None):
    """Plain torch K15 (the module docstring), writing `out` and `nxt` in
    place; returns `out`. `rows_read` as `add_lights` takes it."""
    n = o.shape[0]
    dev = o.device
    sun, sun_col = sun.to(dev), sun_col.to(dev)
    first = active is None
    act = torch.ones(n, dtype=torch.bool, device=dev) if first else active
    colv = torch.ones((n, 3), dtype=F32, device=dev) if col is None else col
    hit = hit & act
    miss = act & ~hit
    dx, dy, dz = d.unbind(1)
    normal, world, block = _reconstruct(o, d, face, axis_coord)
    alb = material_at_soa(*block, grid.size)
    is_mirror = (mirror_lanes(hit, block) if mirror
                 else torch.zeros_like(hit))
    shaded = hit & ~is_mirror
    q = pixelate(world) if pixelated else world
    if shadow is not None and shadow.dtype == torch.bool:
        sunv = sun.expand(n, 3)
        cl = sample_clouds(
            clouds, *(torch.where(hit, sunv[:, k], d[:, k]) for k in range(3)),
            *(torch.where(hit, q[k], o[:, k]) for k in range(3)))
        factor = torch.where(shadow, 0.0, 1.0 - cl[:, 3])
    else:
        factor = (torch.ones(n, dtype=F32, device=dev) if shadow is None
                  else shadow)
        cl = sample_clouds(clouds, dx, dy, dz, *o.unbind(1))
    vis = 1.0
    if density is not None:
        vis = torch.pow(ambient_occlusion(density, world, normal), 1.4)
    elif overlap_ao:
        vis = torch.pow(overlap_ao_plain(grid, torch.stack(world, -1),
                                         torch.stack(normal, -1), face,
                                         rows_read), 1.4)
    lit = lighting_soa(alb, normal, ROUGHNESS, vis, factor, (-dx, -dy, -dz),
                       sun, sun_col)
    if lights is not None:
        lit = add_lights(grid, lit, light_table(lights), shaded, q, normal,
                         max_steps, rows_read)
    sb = sample_skybox(skybox, dx, dy, dz)
    val = [torch.where(miss, colv[:, c] * (sb[:, c] + (cl[:, c] - sb[:, c])
                                           * cl[:, 3]),
                       colv[:, c] * lit[c]) for c in range(3)]
    flat = out.view(4, n)
    if first:
        for c in range(3):
            flat[c] = torch.where(shaded | miss, val[c], 0.0)
        flat[3] = torch.where(miss, 10.0, 0.0)
    else:
        written = shaded | miss
        for c in range(3):
            flat[c] = torch.where(written, val[c], flat[c])
        flat[3] = torch.where(miss, 10.0, flat[3])
    if mirror and nxt is not None:
        o_n, d_n, col_n, act_n = nxt
        ro, rd = continuation(o, d, world, normal, wavy, time)
        m = is_mirror[:, None]
        new_col = torch.stack([colv[:, c] * alb[c] for c in range(3)], -1)
        o_n.copy_(torch.where(m, ro, o_n))
        d_n.copy_(torch.where(m, rd, d_n))
        col_n.copy_(torch.where(m, new_col, col_n))
        act_n.copy_(torch.where(act, is_mirror, act_n))
    return out


def shade_bounce(grid: tracer.Grid, o, d, hit, face, axis_coord, shadow,
                 skybox, clouds, sun, sun_col, out, col=None, active=None,
                 pixelated: bool = False, density=None, lights=None,
                 max_steps: int = 2048, mirror: bool = False,
                 wavy: bool = False, time: float = 0.0, nxt=None,
                 overlap_ao: bool = False):
    """One bounce (the module docstring) into the planar HDR `out` (4, H, W)
    float32 and, with `mirror`, the continuation `nxt` = (o, d, col,
    active), both written in place. `o`, `d`: the bounce's rays (N, 3);
    `hit`, `face`, `axis_coord`: their trace; `shadow`: None, the hard
    shadow rays' (N,) bool hits or a soft (N,) float32 factor; `col`: the
    lanes' colours (N, 3), None for ones (bounce 0); `active`: the live
    lanes (N,) bool, None at bounce 0 (all); `density`: the filtered AO's
    field, or None; `overlap_ao`: the overlap AO instead (density None);
    neither: no AO; `lights`: the scene's lights (L, >= 3) float32 on the
    host, or None. CUDA: K15, one launch; the lights ride in its
    arguments, with no copy to the card."""
    if wavy and not mirror:
        raise ValueError("wavy reflections bend mirrors only: wavy needs "
                         "mirror")
    if overlap_ao and density is not None:
        raise ValueError("one AO: the filtered AO's density or overlap_ao")
    if not kernels.on_cuda(o):
        return shade_bounce_plain(grid, o, d, hit, face, axis_coord, shadow,
                                  skybox, clouds, sun, sun_col, out, col,
                                  active, pixelated, density, lights,
                                  max_steps, mirror, wavy, time, nxt,
                                  overlap_ao)
    check_trace_inputs(o, d, hit, face, axis_coord)
    n = o.shape[0]
    if out.dtype != F32 or out.dim() != 3 or out.shape[0] != 4 \
            or out.shape[1] * out.shape[2] != n:
        raise ValueError(f"out must be (4, H, W) float32 with H * W = {n}")
    if skybox.dim() != 4 or skybox.shape[0] != 6 or clouds.dim() != 3 \
            or skybox.dtype != F32 or clouds.dtype != F32 \
            or clouds.data_ptr() % 16:
        raise ValueError("skybox must be (6, R, R, 3), clouds (R, R, 4), "
                         "float32, the clouds 16-byte aligned")
    name, grid_args = tracer.kernel_args("shade_bounce", grid)
    tensors = [*tracer.tensors(grid), o, d, hit, face, axis_coord, skybox,
               clouds, out]
    hits = factor = None
    if shadow is not None:
        if shadow.shape != (n,) or shadow.dtype not in (torch.bool, F32):
            raise ValueError("shadow must be (N,) bool hits or a float32 "
                             "factor")
        tensors.append(shadow)
        hits, factor = ((shadow, None) if shadow.dtype == torch.bool
                        else (None, shadow))
    if col is not None:
        if col.shape != (n, 3) or col.dtype != F32:
            raise ValueError("col must be (N, 3) float32")
        tensors.append(col)
    if active is not None:
        if active.shape != (n,) or active.dtype != torch.bool:
            raise ValueError("active must be (N,) bool")
        tensors.append(active)
    if density is not None:
        if density.dtype != torch.uint8 \
                or tuple(density.shape) != (grid.size,) * 3:
            raise ValueError(f"density must be u8 ({grid.size},) * 3")
        tensors.append(density)
    nxt_ptrs = [0] * 4
    if mirror:
        if nxt is None:
            raise ValueError("mirrors need the continuation buffers nxt")
        o_n, d_n, col_n, act_n = nxt
        if o_n.shape != (n, 3) or d_n.shape != (n, 3) \
                or col_n.shape != (n, 3) or act_n.shape != (n,) \
                or {o_n.dtype, d_n.dtype, col_n.dtype} != {F32} \
                or act_n.dtype != torch.bool:
            raise ValueError("nxt must be (N, 3) float32 origins, "
                             "directions and colours and (N,) bool flags")
        if active is not None and [t.data_ptr() for t in nxt] != [
                t.data_ptr() for t in (o, d, col, active)]:
            raise ValueError("after bounce 0 the continuation is written "
                             "in place: nxt must be (o, d, col, active)")
        tensors += list(nxt)
        nxt_ptrs = [t.data_ptr() for t in nxt]
    kernels.check_cuda(*tensors)
    table = (light_table(lights) if lights is not None
             else np.zeros((0, 6), np.float32))
    s = [float(c) for c in sun.cpu()]
    c = [float(v) for v in sun_col.cpu()]
    kernels.launch(name, o.device, *grid_args, o.data_ptr(), d.data_ptr(),
                   0 if col is None else col.data_ptr(),
                   0 if active is None else active.data_ptr(),
                   hit.data_ptr(), face.data_ptr(), axis_coord.data_ptr(),
                   0 if hits is None else hits.data_ptr(),
                   0 if factor is None else factor.data_ptr(), n,
                   skybox.data_ptr(), skybox.shape[1], clouds.data_ptr(),
                   clouds.shape[0], *s, *c, int(pixelated),
                   0 if density is None else density.data_ptr(),
                   int(overlap_ao), table.ctypes.data, table.shape[0],
                   max_steps, int(mirror), int(wavy), float(time),
                   out.data_ptr(), *nxt_ptrs)
    return out
