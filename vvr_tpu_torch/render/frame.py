"""Frame graph — the per-frame pipeline of the slice.

Counterpart of vvr_tpu/render/frame.py `render_frame` for the slice the
port renders: primary visibility by the face rasterizer or the jump-grid
DDA, one hard shadow ray per lit pixel (or none) answered by the sun
classifier or the DDA, no mirrors (so only bounce 0 runs), no AO, no point
lights, the main view (debug_type 6). With `max_ray_iterations` 0 no
bounce runs and every pixel is black with alpha 0, as in the JAX frame
(whose loop then runs no body and zeroes the lanes still active). Every pass
is a kernel on a CUDA device and its plain torch version on the CPU:

  1. sky textures, unless the caller passes cached ones (K3)
  2. primary visibility: the face rasterizer with `raster` (K9, K10),
     else the DDA (K1, by 8x4 pixel tiles, without its counters)
  3. shadow query toward the sun from surface + 0.05, lit pixels only:
     the sun classifier with `sunmask` (K12, which reconstructs the
     surface and the start itself and sends its residue through the DDA),
     else the starts from K2 surface and the DDA (K1, as above, given the
     one sun direction of every ray)
  4. shading, sky and clouds into planar HDR (K2 shade)
  5. bloom chain and composite to u8 (K4)
"""

from __future__ import annotations

import torch

from vvr_tpu_torch.config import DEBUG_MAIN, RenderConfig
from vvr_tpu_torch.ops import post as post_ops
from vvr_tpu_torch.ops import shade as shade_ops
from vvr_tpu_torch.ops import sky as sky_ops
from vvr_tpu_torch.ops.jump import trace_jump
from vvr_tpu_torch.ops.rastertrace import trace_raster
from vvr_tpu_torch.ops.sunshadow import masked_shadow_from_hits
from vvr_tpu_torch.world.jumpgrid import JumpGrid

F32 = torch.float32


def check_frame_config(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for the frame knobs outside the slice,
    naming the ROADMAP item that adds each, and ValueError for a negative
    bounce count."""
    if cfg.max_ray_iterations < 0:
        raise ValueError(f"max_ray_iterations must be >= 0, got "
                         f"{cfg.max_ray_iterations}")
    if cfg.shadow_samples > 1:
        raise NotImplementedError(
            "soft shadows (shadow_samples > 1) are not ported yet: "
            "ROADMAP A9")
    if cfg.pixelated_shadows:
        raise NotImplementedError(
            "pixelated_shadows is not ported yet: ROADMAP A9")
    if cfg.ambient_occlusion:
        raise NotImplementedError(
            "ambient occlusion is not ported yet: ROADMAP A10")
    if cfg.point_lights:
        raise NotImplementedError(
            "point lights are not ported yet: ROADMAP A10")
    if cfg.debug_type != DEBUG_MAIN:
        raise NotImplementedError(
            f"debug_type {cfg.debug_type} is not ported yet: ROADMAP A13 "
            "(heatmaps) and A14 (raster debug view)")


def render_frame(grid: JumpGrid, o, d, sun, time: float, cfg: RenderConfig,
                 sky=None, raster=None, sunmask=None):
    """Full frame. `o`, `d`: the flattened (render_h * render_w, 3) camera
    rays on the render device; `sun`: (3,) or (4,) direction (host array or
    tensor); `sky`: optional cached (skybox, clouds) textures; `raster`:
    optional (faces, raster_camera, camera-in-solid probe) for rasterized
    primary visibility (the rays must be that camera's wavefront);
    `sunmask`: optional (e1, e2, grids) of the hard-shadow classifier.
    Returns (u8 image (H, W, 3), hdr rgba (rh, rw, 4)), both on the rays'
    device."""
    check_frame_config(cfg)
    rh, rw = cfg.render_height, cfg.render_width
    n = o.shape[0]
    if n != rh * rw:
        raise ValueError(f"{n} rays for a {rh}x{rw} render")
    dev = o.device
    if cfg.max_ray_iterations == 0:
        return _post(torch.zeros((4, rh, rw), dtype=F32, device=dev), cfg)
    sun3 = torch.as_tensor(sun, dtype=F32).cpu().reshape(-1)[:3]
    if sky is None:
        skybox = sky_ops.write_skybox(sun3, time, cfg.skybox_resolution, dev)
        clouds = sky_ops.write_clouds(sun3, time, cfg.clouds_resolution, dev)
    else:
        skybox, clouds = sky
    max_steps = cfg.traversal_max_steps * 8

    if raster is not None:
        faces, rcam, probe = raster
        res = trace_raster(faces, rcam, d, probe, grid.size, rw, rh)
    else:
        res = trace_jump(grid, o, d, max_steps, width=rw, stats=False)
    shadow_hit = None
    if cfg.shadow_samples == 1:
        # shadow start: surface + 0.05 along the sun
        if sunmask is not None:
            e1, e2, grids = sunmask
            shadow_hit = masked_shadow_from_hits(
                grid, o, d, res.hit, res.face, res.axis_coord, sun3.numpy(),
                e1, e2, grids, max_steps)
        else:
            s_o, s_act = shade_ops.shade_surface(o, d, res.hit, res.face,
                                                 res.axis_coord, sun3)
            shadow_hit = trace_jump(grid, s_o, sun3.to(dev), max_steps,
                                    active=s_act, width=rw, stats=False).hit
    hdr = shade_ops.shade_pixel(o, d, res.hit, res.face, res.axis_coord,
                                shadow_hit, grid.size, skybox, clouds, sun3,
                                sky_ops.sun_colour_final(sun3), rh, rw)
    return _post(hdr, cfg)


def _post(hdr, cfg: RenderConfig):
    """Bloom and composite of the planar (4, rh, rw) HDR image: (u8 image
    (H, W, 3), hdr rgba (rh, rw, 4))."""
    if cfg.bloom_enabled:
        bloom2 = post_ops.bloom_pyramid_p(hdr)
    else:
        rh, rw = hdr.shape[1:]
        bloom2 = torch.zeros((4, max(rh >> 2, 1), max(rw >> 2, 1)),
                             dtype=F32, device=hdr.device)
    img = post_ops.composite_p(hdr, bloom2, cfg.height, cfg.width,
                               cfg.bloom_strength, cfg.bloom_enabled)
    return img, hdr.permute(1, 2, 0)
