"""Digests of the bench frame's bytes, to hold two checkouts to each other
on one card.

    python3 vvr_tpu_torch/tools/frame_digest.py [--root DIR] [--cpu-rays]
        [--traversal jump|paged|pyramid ...] [--worlds DIR]

Renders bench.py's default-knob frame (256^3 world, the bench camera,
t = 0: face rasterizer, sun classifier, one hard shadow ray per lit pixel)
with the vvr_tpu_torch package found under DIR (default: this checkout),
in three configurations: 1920x1080 with bloom, without bloom, and
3840x2160 composited from a 1920x1080 render (the compositor's integer
upscale); and beside them the DDA frame (`primary_raster="off",
sun_mask="off"`: K1 traces the primary and the shadow rays), the soft
frames (K14: four samples with the cone grids and through every sample's
DDA, pixelated with four samples and with one) and config 4 (K15: four
soft samples, four mirror bounces, the filtered AO; and the same with the
scene's point lights as they start and wavy reflections), the overlap
AO frame, and on the brick pyramid (`traversal="pyramid"`: K19 and the
pyramid forms of K12, K14 and K15) the default-knob, DDA, soft cone,
config 4 and overlap AO frames and the five debug heatmaps (K21) at
1920x1080, and the raster debug view (debug_type 0: the surface-nets mesh
through K22, each fragment's sun shadow through the pyramid's HDDA in
K23; its own rays through K13, with --cpu-rays too) at 1920x1080; a
package that does not render a configuration gets a note in its place.
Beside the frames it digests the sky textures (the 256^2 skybox and the
512^2 clouds) at two (sun, time) pairs, the default sun at t = 0 and a
low sun at t = 1.75 s, and the second at odd sizes (7^2 and 13^2), each
built through the renderer's sky cache (`Renderer._sky`), and the sun
grids gBC (K11 `sun_grids`) at 2048^2 and 512^2 (the dragged sun's) for
the default sun and that low sun, hard and cone (soft shadows' `cone_tan`).
It prints one JSON line: for each
configuration the SHA-256 of the frame's HDR image and of its u8 image,
for each sky the SHA-256 of its skybox and its clouds, and for each sun
grid the SHA-256 of gBC. The calls are those of `Renderer.render`,
`Renderer._sky` and `sun_grids`, which earlier checkouts of the port
share, so running the script once
with --root at an unpacked `git archive` of another commit and once
without, in one call on one card, shows whether the two trees' kernels
give the same bytes. With --cpu-rays the frames' rays are made on the CPU
(the package's plain `camera_rays`) and copied to the card, so two
checkouts whose card rays differ (the plain torch rays on the card before
K13, K13's since) are held to each other on the same rays. With --traversal
it also renders config 5's static frames (tools/bench_scale.py:62-97
without its edits: the 1024^3 world, 1920x1080, its camera; the default
knobs and the DDA frame) over one 1024^3 scene, once per traversal named,
so that the jump grid's, the paged grid's and the pyramid's frames can be
held to each other; a package that does not render one gets a note. Each
package generates its worlds from cold, unless --worlds names a directory
of world files (map_256.npz, map_1024.npz in the npz of world/cache.py):
a file there is loaded, a missing one is generated and written, so two
checkouts whose height fields differ can be held to each other on one
world. It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
CONFIGS = {"bloom": dict(width=1920, height=1080),
           "no bloom": dict(width=1920, height=1080, bloom_enabled=False),
           "upscale 2": dict(width=3840, height=2160, downscale_factor=2),
           "dda": dict(width=1920, height=1080, primary_raster="off",
                       sun_mask="off"),
           "soft cone": dict(width=1920, height=1080, shadow_samples=4),
           "soft dda": dict(width=1920, height=1080, shadow_samples=4,
                            sun_mask="off"),
           "pixelated 4": dict(width=1920, height=1080, shadow_samples=4,
                               pixelated_shadows=True),
           "pixelated 1": dict(width=1920, height=1080, shadow_samples=1,
                               pixelated_shadows=True),
           # config 4 (tools/bench_scale.py:33-50) with mirror materials,
           # and with the point lights and wavy reflections too (the
           # renderer's lights as build_scene starts them)
           "config 4": dict(width=1920, height=1080, shadow_samples=4,
                            max_ray_iterations=4, ambient_occlusion=True),
           "config 4 lights wavy": dict(width=1920, height=1080,
                                        shadow_samples=4,
                                        max_ray_iterations=4,
                                        ambient_occlusion=True,
                                        point_lights=True,
                                        wavy_reflections=True),
           # the overlap AO (K15's inline densities), and the brick
           # pyramid's frames (K19 and the pyramid forms of K12, K14,
           # K15; the heatmaps, K21)
           "overlap ao": dict(width=1920, height=1080,
                              ambient_occlusion=True, ao_mode="overlap"),
           **{f"pyramid {name}": dict(knobs, traversal="pyramid")
              for name, knobs in (
                  ("bloom", dict(width=1920, height=1080)),
                  ("dda", dict(width=1920, height=1080,
                               primary_raster="off", sun_mask="off")),
                  ("soft cone", dict(width=1920, height=1080,
                                     shadow_samples=4)),
                  ("config 4", dict(width=1920, height=1080,
                                    shadow_samples=4, max_ray_iterations=4,
                                    ambient_occlusion=True)),
                  ("overlap ao", dict(width=1920, height=1080,
                                      ambient_occlusion=True,
                                      ao_mode="overlap")),
                  *((f"debug {t}", dict(width=1920, height=1080,
                                        debug_type=t))
                    for t in range(1, 6)))}}
# config 5's static frames (tools/bench_scale.py:62-97, without edits)
CONFIG5_CAMERA = ([512.0, 400.0, 80.0], [512.0, 80.0, 720.0], 85.0)
CONFIG5 = {"config 5": dict(width=1920, height=1080),
           "config 5 dda": dict(width=1920, height=1080,
                                primary_raster="off", sun_mask="off")}
# the configurations rendered with mirror materials
MIRRORS = ("config 4", "config 4 lights wavy", "pyramid config 4")
# (sun direction before normalization, or None for the renderer's, time,
# skybox and cloud resolutions)
SKIES = {"sky default sun t 0": (None, 0.0, 256, 512),
         "sky low sun t 1.75": ((0.6, 0.05, 0.8), 1.75, 256, 512),
         "sky low sun t 1.75 at 7/13": ((0.6, 0.05, 0.8), 1.75, 7, 13)}
# the sun grids: (sun direction before normalization, or None for the
# renderer's, grid side, the cone grids of soft shadows)
GRIDS = {f"gbc {'cone ' if cone else ''}{name} sun {grid}": (sun, grid, cone)
         for cone in (False, True)
         for name, sun in (("default", None), ("low", (0.6, 0.05, 0.8)))
         for grid in (2048, 512)}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def grid_digests(sunshadow, faces, size: int, default_sun, grids=GRIDS):
    """{name: SHA-256 of gBC} of `sunshadow.sun_grids` (the module of the
    package under test) for each entry of `grids`, a sun of None being
    `default_sun`, the cone grids with the package's CONE_TAN."""
    out = {}
    for name, (sun, grid, cone) in grids.items():
        s = np.asarray(default_sun if sun is None else sun, np.float32)
        s = (s / np.linalg.norm(s)).astype(np.float32)
        gbc = sunshadow.sun_grids(faces, *sunshadow.sun_basis(s), size,
                                  grid, sunshadow.CONE_TAN if cone
                                  else 0.0)[0]
        out[name] = {"gbc": digest(gbc), "shape": list(gbc.shape)}
    return out


def raster_view_digest(scene, cam, dev):
    """SHA-256 of the raster debug view's HDR and u8 image (debug_type 0,
    1920x1080, t = 0) through the package's `raster_debug_frame`, or a
    note where the package has none."""
    import torch

    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.render.renderer import Renderer
    cfg = RenderConfig(width=1920, height=1080, debug_type=0)
    try:
        from vvr_tpu_torch.render.raster import raster_debug_frame
        r = Renderer(WorldConfig(depth=4), cfg, device=dev, scene=scene)
    except (ImportError, NotImplementedError) as e:
        return f"not rendered by this package ({e})"
    img, hdr = raster_debug_frame(r.mesh, scene.ensure_pyramid(), cam,
                                  r.sun, 0.0, cfg)
    torch.cuda.synchronize()
    return {"hdr": digest(hdr), "u8": digest(img), "shape": list(img.shape)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch renders")
    ap.add_argument("--cpu-rays", action="store_true",
                    help="make the frames' rays on the CPU")
    ap.add_argument("--traversal", nargs="+",
                    choices=("jump", "paged", "pyramid"), default=(),
                    help="render config 5's frames at 1024^3 through each "
                    "of these grids")
    ap.add_argument("--worlds", type=pathlib.Path,
                    help="load the worlds from this directory's files, "
                    "writing a missing one")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("frame_digest: no CUDA device", file=sys.stderr)
        return 1
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import sunshadow
    from vvr_tpu_torch.ops.rastertrace import raster_camera
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.utils.camera import Camera

    dev = torch.device("cuda", 0)
    worlds = (args.worlds.resolve() if args.worlds
              else root / "build" / "vvr_tpu_torch")
    regenerate = args.worlds is None
    out = {"root": str(root), "cpu rays": args.cpu_rays,
           "worlds": str(args.worlds) if args.worlds else "from cold"}
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    scene = None
    for name, knobs in CONFIGS.items():
        cfg = RenderConfig(**{"shadow_samples": 1, "max_ray_iterations": 3,
                              **knobs})
        mirrors = {"mirror_materials": True} if name in MIRRORS else {}
        try:
            r = Renderer(WorldConfig(depth=4), cfg, device=dev, scene=scene,
                         force_regenerate=regenerate and scene is None,
                         cache_path=worlds / "map_256.npz", **mirrors)
        except NotImplementedError as e:
            out[name] = f"not rendered by this package ({e})"
            continue
        scene = r.scene
        extra = {}
        if mirrors:   # the keywords of packages that render config 4
            extra = dict(mirror_materials=True,
                         density=scene.ensure_density(),
                         lights=scene.lights if cfg.point_lights else None)
        o, d = (t.to(dev) for t in camera_rays(
            cam, cfg.render_width, cfg.render_height,
            "cpu" if args.cpu_rays else dev))
        raster = ((scene.ensure_faces(), raster_camera(cam),
                   scene.solid_at_host(cam.position)) if r.use_raster
                  else None)
        # the Renderer's grid (a package before the paged grid: the
        # scene's)
        grid = getattr(r, "grid", None) or scene.jumpgrid
        img, hdr = render_frame(grid, o, d, r.sun, 0.0, cfg,
                                sky=r._sky(0.0), raster=raster,
                                sunmask=r._sunmask() if r.use_sunmask
                                else None, **extra)
        torch.cuda.synchronize()
        out[name] = {"hdr": digest(hdr), "u8": digest(img),
                     "shape": list(img.shape)}
    default_sun = r.sun[:3].copy()
    out["raster view"] = raster_view_digest(scene, cam, dev)
    for name, (sun, t, r_sky, r_clouds) in SKIES.items():
        r = Renderer(WorldConfig(depth=4), RenderConfig(
            skybox_resolution=r_sky, clouds_resolution=r_clouds),
            device=dev, scene=scene)
        if sun is not None:
            s = np.asarray(sun, np.float32)
            r.sun = np.concatenate([s / np.linalg.norm(s), [0.0]]).astype(
                np.float32)
        skybox, clouds = r._sky(t)
        torch.cuda.synchronize()
        out[name] = {"skybox": digest(skybox), "clouds": digest(clouds),
                     "shapes": [list(skybox.shape), list(clouds.shape)]}
    out.update(grid_digests(sunshadow, scene.ensure_faces(),
                            scene.cfg.size, default_sun))
    scene5 = None
    cam5 = Camera.look_at(*CONFIG5_CAMERA[:2], fov=CONFIG5_CAMERA[2])
    for trav in args.traversal:
        for name, knobs in CONFIG5.items():
            cfg = RenderConfig(**{"shadow_samples": 1,
                                  "max_ray_iterations": 3, **knobs,
                                  "traversal": trav})
            try:
                r = Renderer(WorldConfig(depth=5), cfg, device=dev,
                             scene=scene5,
                             force_regenerate=regenerate and scene5 is None,
                             cache_path=worlds / "map_1024.npz")
            except NotImplementedError as e:
                out[f"{name} {trav}"] = f"not rendered by this package ({e})"
                continue
            scene5 = r.scene
            o, d = (t.to(dev) for t in camera_rays(
                cam5, cfg.render_width, cfg.render_height,
                "cpu" if args.cpu_rays else dev))
            raster = ((scene5.ensure_faces(), raster_camera(cam5),
                       scene5.solid_at_host(cam5.position)) if r.use_raster
                      else None)
            grid = getattr(r, "grid", None) or scene5.jumpgrid
            img, hdr = render_frame(grid, o, d, r.sun, 0.0, cfg,
                                    sky=r._sky(0.0), raster=raster,
                                    sunmask=r._sunmask() if r.use_sunmask
                                    else None)
            torch.cuda.synchronize()
            out[f"{name} {trav}"] = {"hdr": digest(hdr), "u8": digest(img),
                                     "shape": list(img.shape)}
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
