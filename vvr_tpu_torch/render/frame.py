"""Frame graph — the per-frame pipeline of the port.

Counterpart of vvr_tpu/render/frame.py `render_frame`: primary visibility
by the face rasterizer or the grid's DDA, sun shadows (none, one hard
ray per lit pixel, or `shadow_samples` jittered soft rays, from the
surface or, with `pixelated_shadows`, from its quarter-voxel floor),
mirror bounces (`mirror_materials`, `wavy_reflections`), ambient
occlusion (`ambient_occlusion`: "filtered" with the scene's density
field, or "overlap", the box-overlap densities of the grid's voxels) and
the point lights (`point_lights` with the scene's lights), the main view
(debug_type 6) or a debug heatmap (1-5). With `max_ray_iterations` 0 no
bounce runs and every pixel is black with alpha 0, as in the JAX frame
(whose loop then runs no body and zeroes the lanes still active). The
grid is the jump grid (worlds up to 512^3), the paged grid (past it) or,
with `traversal="pyramid"`, the brick pyramid; every trace of the frame
goes through one dispatch, ops/trace.py `trace`, to the grid's DDA (K1,
K16 or K19's any-only HDDA) with the grid's own cap (`step_cap`), as the
JAX frame's one tracer `tr` serves every call site (frame.py:91-119), and
the kernels that trace inline (K12, K14, K15) take the grid's view. Every
pass is a kernel on a CUDA device and its plain torch version on the CPU:

  1. sky textures, unless the caller passes cached ones (K3)
  2. primary visibility: the face rasterizer with `raster` (K9, K10),
     else the DDA (K1, K16 or K19, by 8x4 pixel tiles, with the counters
     only for a heatmap of them)
  3. sun shadows, lit pixels only. Hard: toward the sun from surface +
     0.05: the sun classifier with `sunmask` (K12, which reconstructs the
     surface and the start itself and sends its residue through the DDA),
     else the starts from K2 surface and the DDA (as above, given the one
     sun direction of every ray). Soft: K14, a warp per 8x4 pixel
     tile, gated by the cone grids with `sunmask`, into a shadow factor
  4. shading, sky and clouds into planar HDR: K2 shade when the frame has
     no mirrors, AO or lights; else K15 shade_bounce, which also writes
     the mirror lanes' continuation (and computes either AO inline). With
     mirrors each later bounce, up to `max_ray_iterations`, traces the
     live lanes (the DDA, `active`), runs the same shadow pass on that
     bounce's hits and K15 again, over the whole image with no
     compaction and no early stop (a stop would read a count back to the
     host)
  5. with debug_type 1-5, K21 writes the heatmap of bounce 0's trace
     into the HDR rgb planes (alpha stays)
  6. bloom chain (not in a debug frame) and composite to u8 (K4)
"""

from __future__ import annotations

import torch

from vvr_tpu_torch.config import DEBUG_MAIN, RenderConfig
from vvr_tpu_torch.ops import debug as debug_ops
from vvr_tpu_torch.ops import post as post_ops
from vvr_tpu_torch.ops import shade as shade_ops
from vvr_tpu_torch.ops import sky as sky_ops
from vvr_tpu_torch.ops.bounce import bounce_buffers, shade_bounce
from vvr_tpu_torch.ops.trace import Grid, step_cap, trace
from vvr_tpu_torch.ops.rastertrace import trace_raster
from vvr_tpu_torch.ops.softshadow import soft_shadow
from vvr_tpu_torch.ops.sunshadow import masked_shadow_from_hits

F32 = torch.float32


def check_frame_config(cfg: RenderConfig) -> None:
    """Raise ValueError for a negative bounce count, an unknown AO mode or
    debug type. debug_type 0 is the raster debug view, which the Renderer
    draws through render/raster.py, not `render_frame`."""
    if cfg.max_ray_iterations < 0:
        raise ValueError(f"max_ray_iterations must be >= 0, got "
                         f"{cfg.max_ray_iterations}")
    if cfg.ao_mode not in ("filtered", "overlap"):
        raise ValueError(f"ao_mode must be 'filtered' or 'overlap', got "
                         f"{cfg.ao_mode!r}")
    if not 0 <= cfg.debug_type <= DEBUG_MAIN:
        raise ValueError(f"debug_type must be 0-{DEBUG_MAIN}, got "
                         f"{cfg.debug_type}")


def _shadow(grid: Grid, hits, sun3, cfg: RenderConfig, clouds, sunmask,
            max_steps: int, width: int):
    """The sun shadows of one bounce's hits: None, the hard shadow rays'
    (N,) bool hits or the soft (N,) float32 factor (step 3)."""
    pixelated = cfg.pixelated_shadows
    if cfg.shadow_samples > 1:
        return soft_shadow(grid, *hits, sun3.numpy(), cfg.shadow_samples,
                           clouds, max_steps, pixelated, sunmask,
                           width=width)
    if cfg.shadow_samples == 1:
        # shadow start: surface (its quarter-voxel floor with pixelated
        # shadows) + 0.05 along the sun
        if sunmask is not None:
            return masked_shadow_from_hits(grid, *hits, sun3.numpy(),
                                           *sunmask, max_steps)
        s_o, s_act = shade_ops.shade_surface(*hits, sun3, pixelated)
        return trace(grid, s_o, sun3.to(s_o.device), max_steps,
                     active=s_act, width=width, stats=False).hit
    return None


def render_frame(grid: Grid, o, d, sun, time: float, cfg: RenderConfig,
                 sky=None, raster=None, sunmask=None, density=None,
                 lights=None, mirror_materials: bool = False,
                 demand: dict | None = None, nxt=None):
    """Full frame on the jump or the paged grid. `o`, `d`: the flattened
    (render_h * render_w, 3) camera rays on the render device; `sun`: (3,)
    or (4,) direction (host array or tensor); `sky`: optional cached
    (skybox, clouds) textures; `raster`: optional (faces, raster_camera,
    camera-in-solid probe) for rasterized primary visibility (the rays must
    be that camera's wavefront); `sunmask`: optional (e1, e2, grids) of the
    sun classifier: the hard grids with one shadow sample, the cone grids
    (sunshadow.sun_grids(..., cone_tan=CONE_TAN)) with soft shadows; none
    with pixelated shadows, whose quarter-voxel floor can bury the query
    where a certain-light claim is unsound (Renderer.use_sunmask);
    `density`: the u8 AO field (world/svt.py), read with
    `ambient_occlusion` and ao_mode "filtered" (ao_mode "overlap" reads
    the grid); `lights`: the scene's point lights (L, >= 3)
    float32 on the host, the first ten read with `point_lights`;
    `mirror_materials`: mirror bounces; `demand`: a dict that, if given,
    receives each K15 bounce's live, hit and mirror lane counts as 0-d
    tensors (`b{k}_active`, `b{k}_hit`, `b{k}_mirror`, the JAX frame's
    `collect_demand` keys), read by the caller only; `nxt`: with mirrors,
    the continuation buffers (ops/bounce.py `bounce_buffers(N, device)`),
    which a caller rendering many frames keeps across them; zero-filled
    ones are made here when None. Returns (u8 image (H, W, 3), hdr rgba
    (rh, rw, 4)), both on the rays' device. The rays are not written."""
    check_frame_config(cfg)
    if cfg.debug_type == 0:
        raise ValueError("debug_type 0 is the raster debug view: "
                         "render/raster.py raster_debug_frame draws it")
    if sunmask is not None and cfg.pixelated_shadows:
        raise ValueError("pixelated shadows take no sun classifier: the "
                         "quarter-voxel floor can bury the query")
    rh, rw = cfg.render_height, cfg.render_width
    n = o.shape[0]
    if n != rh * rw:
        raise ValueError(f"{n} rays for a {rh}x{rw} render")
    dev = o.device
    if cfg.max_ray_iterations == 0:
        return _post(torch.zeros((4, rh, rw), dtype=F32, device=dev), cfg)
    sun3 = torch.as_tensor(sun, dtype=F32).cpu().reshape(-1)[:3]
    if sky is None:
        skybox, clouds = sky_ops.write_sky(sun3, time, cfg.skybox_resolution,
                                           cfg.clouds_resolution, dev)
    else:
        skybox, clouds = sky
    max_steps = step_cap(grid, cfg.traversal_max_steps)
    sun_col = sky_ops.sun_colour_final(sun3)

    if raster is not None:
        faces, rcam, probe = raster
        res = trace_raster(faces, rcam, d, probe, grid.size, rw, rh)
    else:
        res = trace(grid, o, d, max_steps, width=rw,
                    stats=debug_ops.needs_stats(cfg.debug_type))
    primary = (o, d, res)
    hits = (o, d, res.hit, res.face, res.axis_coord)
    shadow = _shadow(grid, hits, sun3, cfg, clouds, sunmask, max_steps, rw)
    overlap = cfg.ambient_occlusion and cfg.ao_mode == "overlap"
    # the filtered AO without a density field is no AO, as in the JAX
    # frame (frame.py:270)
    density = (density if cfg.ambient_occlusion and not overlap
               else None)
    lights = lights if cfg.point_lights else None
    if not (mirror_materials or overlap or density is not None
            or lights is not None):
        hdr = shade_ops.shade_pixel(*hits, shadow, grid.size, skybox, clouds,
                                    sun3, sun_col, rh, rw,
                                    cfg.pixelated_shadows)
        return _post(hdr, cfg, primary)

    hdr = torch.empty((4, rh, rw), dtype=F32, device=dev)
    # the next bounce's rays, colours and live lanes: K15 writes the mirror
    # lanes' continuation and every lane's flag here, and from bounce 1 on
    # reads and writes them in place
    if not mirror_materials:
        nxt = None
    elif nxt is None:
        nxt = bounce_buffers(n, dev)
    col = active = None
    for bounce in range(cfg.max_ray_iterations):
        if bounce > 0:
            o, d, col, active = nxt
            res = trace(grid, o, d, max_steps, active=active, width=rw,
                        stats=False)
            hits = (o, d, res.hit, res.face, res.axis_coord)
            shadow = _shadow(grid, hits, sun3, cfg, clouds, sunmask,
                             max_steps, rw)
        if demand is not None:   # before K15 rewrites the live flags
            demand[f"b{bounce}_active"] = (torch.tensor(n) if active is None
                                           else active.sum())
            demand[f"b{bounce}_hit"] = res.hit.sum()
        shade_bounce(grid, *hits, shadow, skybox, clouds, sun3, sun_col, hdr,
                     col, active, cfg.pixelated_shadows, density, lights,
                     max_steps, mirror_materials,
                     mirror_materials and cfg.wavy_reflections, time, nxt,
                     overlap)
        if demand is not None:
            demand[f"b{bounce}_mirror"] = (nxt[3].sum() if mirror_materials
                                           else torch.tensor(0))
        if not mirror_materials:
            break   # no lane continues
    return _post(hdr, cfg, primary)


def _post(hdr, cfg: RenderConfig, primary=None):
    """The debug image of bounce 0's `primary` (rays, trace) with
    debug_type 1-5 (step 5), then bloom and composite of the planar (4,
    rh, rw) HDR image: (u8 image (H, W, 3), hdr rgba (rh, rw, 4))."""
    debug = cfg.debug_type != DEBUG_MAIN and primary is not None
    if debug:
        o, d, res = primary
        counter = (getattr(res, debug_ops.HEATMAPS[cfg.debug_type][0])
                   if debug_ops.needs_stats(cfg.debug_type) else None)
        if debug_ops.needs_stats(cfg.debug_type) and counter is None:
            counter = torch.zeros(o.shape[0], dtype=torch.int32,
                                  device=o.device)
        debug_ops.debug_image(o, d, res.face, res.axis_coord, counter,
                              cfg.debug_type, hdr)
    bloom = cfg.bloom_enabled and not debug
    if bloom:
        bloom2 = post_ops.bloom_pyramid_p(hdr)
    else:
        rh, rw = hdr.shape[1:]
        bloom2 = torch.zeros((4, max(rh >> 2, 1), max(rw >> 2, 1)),
                             dtype=F32, device=hdr.device)
    img = post_ops.composite_p(hdr, bloom2, cfg.height, cfg.width,
                               cfg.bloom_strength, bloom)
    return img, hdr.permute(1, 2, 0)
