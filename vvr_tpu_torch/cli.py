"""CLI — the port's counterpart of vvr_tpu/cli.py, flag for flag (the
reference's src/main.rs:33-80 plus the headless options), with `--device`
(default cuda) and `--profile-path`. It renders to an image file instead
of a window.

Examples:
  python -m vvr_tpu_torch.cli --snapshot 0 --output frame.png
  python -m vvr_tpu_torch.cli --depth 4 --shadow-samples 4 --benchmark
  python -m vvr_tpu_torch.cli --debug-type 0 --output raster.png
  python -m vvr_tpu_torch.cli --debug-type 0 --device cpu --depth 3 \\
      --width 96 --height 64 --export-mesh world.obj

Saving the image needs PIL; without it the frame is written with np.save
to the output path plus ".npy", as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.world.mesher import VoxelMeshBuffers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vvr_tpu_torch", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    # reference flags (src/main.rs:36-79)
    p.add_argument("--downscale-factor", type=int, default=1)
    p.add_argument("--shadow-samples", type=int, default=1,
                   help="0=off, 1=hard, N>1=jittered soft (max 16)")
    p.add_argument("--max-ray-iterations", type=int, default=3,
                   help="reflection bounce cap (1-8)")
    p.add_argument("--round-normals", action="store_true")
    p.add_argument("--ambient-occlusion", action="store_true")
    p.add_argument("--ao-mode", choices=("filtered", "overlap"),
                   default="filtered",
                   help="AO estimator: filtered SVT sample (reference live "
                        "path) or planar overlap query (reference library)")
    p.add_argument("--wavy-reflections", action="store_true")
    p.add_argument("--pixelated-shadows", action="store_true")
    p.add_argument("--fullscreen", action="store_true",
                   help="accepted for parity; the headless renderer "
                        "ignores it")
    p.add_argument("--group-size-exp", type=int, default=3,
                   help="parity flag; the kernels choose their own tiles")
    p.add_argument("--force-regenerate", action="store_true")
    p.add_argument("--enable-debug-stuff", action="store_true")
    # headless options
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--depth", type=int, default=4,
                   help="world depth; size = 4^depth (4 -> 256^3, "
                        "5 -> 1024^3)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot", type=int, default=0,
                   help="camera snapshot index (vvr_tpu/assets/"
                        "snapshots.json)")
    p.add_argument("--camera", type=float, nargs=6,
                   metavar=("X", "Y", "Z", "TX", "TY", "TZ"),
                   help="explicit camera position + look-at target")
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--sun", type=float, nargs=3, default=None)
    p.add_argument("--time", type=float, default=0.0)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--output", type=str, default="frame.png")
    p.add_argument("--benchmark", action="store_true",
                   help="run the 2s capture benchmark (reference L key)")
    p.add_argument("--benchmark-seconds", type=float, default=2.0)
    p.add_argument("--debug-type", type=int, default=6,
                   help="0=raster 1=iterations 2=fetches 3=normals 4=world "
                        "5=exit-type 6=main (reference DebugType enum)")
    p.add_argument("--mirror-materials", action="store_true",
                   help="enable the hash-driven mirror-block material rule")
    p.add_argument("--point-lights", action="store_true",
                   help="enable the 10-light point-light loop")
    p.add_argument("--dynamic-world", action="store_true",
                   help="run the per-frame SVT colorize/blur pass")
    p.add_argument("--export-mesh", type=str, default=None,
                   help="write the surface-nets world mesh to an OBJ file")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of one frame")
    p.add_argument("--profile-path", type=str, default="vvr_trace.json",
                   help="where --profile writes its Chrome trace")
    p.add_argument("--no-bloom", action="store_true")
    p.add_argument("--traversal",
                   choices=("auto", "jump", "jump2", "paged", "pyramid"),
                   default="auto",
                   help="acceleration structure: jump grid, paged "
                        "two-level grid or brick pyramid; auto picks the "
                        "jump grid up to 512^3 worlds and the paged grid "
                        "past it (jump2 is not ported)")
    p.add_argument("--primary-raster", choices=("auto", "on", "off"),
                   default="auto",
                   help="rasterized primary visibility (merged exposed "
                        "faces); auto = on for the main view")
    p.add_argument("--sun-mask", choices=("auto", "off"), default="auto",
                   help="conservative sun-space occlusion classifier for "
                        "hard shadows")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the frame renders on (cuda, or cpu "
                        "for the plain torch path)")
    return p


def save_image(img: np.ndarray, path: str) -> str:
    """Write the u8 frame to `path` with PIL, or with np.save to path +
    '.npy' where PIL is missing; returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", img)
        return path + ".npy"
    Image.fromarray(img).save(path)
    return path


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s: "
                               "%(message)s")
    args = build_parser().parse_args(argv)

    world_cfg = WorldConfig(depth=args.depth, seed=args.seed)
    render_cfg = RenderConfig(
        width=args.width, height=args.height,
        downscale_factor=args.downscale_factor,
        shadow_samples=args.shadow_samples,
        max_ray_iterations=args.max_ray_iterations,
        round_normals=args.round_normals,
        ambient_occlusion=args.ambient_occlusion,
        ao_mode=args.ao_mode,
        wavy_reflections=args.wavy_reflections,
        pixelated_shadows=args.pixelated_shadows,
        enable_debug_stuff=args.enable_debug_stuff,
        debug_type=args.debug_type,
        bloom_enabled=not args.no_bloom,
        point_lights=args.point_lights,
        traversal=args.traversal,
        primary_raster=args.primary_raster,
        sun_mask=args.sun_mask,
    )

    r = Renderer(world_cfg, render_cfg, device=args.device,
                 force_regenerate=args.force_regenerate,
                 mirror_materials=args.mirror_materials,
                 dynamic_world=args.dynamic_world)
    if args.export_mesh:
        buf = (r.mesh.buffers if r.raster_view
               else VoxelMeshBuffers.build(r.scene.chunks))
        buf.export_obj(args.export_mesh)
        print(f"wrote {args.export_mesh} ({len(buf.vertices)} verts, "
              f"{len(buf.indices)} indices, {len(buf.ranges)} chunks)")
    if args.sun is not None:
        sun = np.asarray(args.sun, np.float32)
        r.sun = np.concatenate([sun / np.linalg.norm(sun),
                                [0.0]]).astype(np.float32)

    if args.camera:
        cam = Camera.look_at(args.camera[:3], args.camera[3:],
                             fov=args.fov or 90.0)
    else:
        cam = r.camera_for_snapshot(args.snapshot)
        if args.fov:
            cam.fov = args.fov

    if args.benchmark:
        res = r.benchmark(cam, duration_s=args.benchmark_seconds)
        print(f"Sample Count: {res['samples']}, Avg: {res['avg_ms']:.3f}ms, "
              f"StdDev: {res['stddev']:.4f}")
        print(f"{res['mrays_per_s']:.1f} Mrays/s, {res['fps']:.1f} fps "
              f"({r.rays_per_frame} rays/frame)")
        return 0

    if args.profile:
        r.profile_frame(cam, args.profile_path)
        print(f"profiler trace written to {args.profile_path}")

    img = None
    t0 = time.monotonic()
    for i in range(args.frames):
        img = r.render(cam, time=args.time + i / 60.0, timed=True)
    dt = time.monotonic() - t0
    print(f"{args.frames} frame(s) in {dt:.2f}s; rolling avg "
          f"{r.stats.average_ms():.2f} ms")

    if args.output:
        written = save_image(img.cpu().numpy(), args.output)
        print(f"wrote {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
