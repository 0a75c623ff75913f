"""Digests of the bench frame's bytes, to hold two checkouts to each other
on one card.

    python3 vvr_tpu_torch/tools/frame_digest.py [--root DIR]

Renders bench.py's default-knob frame (256^3 world, the bench camera,
t = 0: face rasterizer, sun classifier, one hard shadow ray per lit pixel)
with the vvr_tpu_torch package found under DIR (default: this checkout),
in three configurations: 1920x1080 with bloom, without bloom, and
3840x2160 composited from a 1920x1080 render (the compositor's integer
upscale); and beside them the DDA frame (`primary_raster="off",
sun_mask="off"`: K1 traces the primary and the shadow rays) at 1920x1080.
Beside the frames it digests the sky textures (the 256^2 skybox and the
512^2 clouds) at two (sun, time) pairs, the default sun at t = 0 and a
low sun at t = 1.75 s, and the second at odd sizes (7^2 and 13^2), each
built through the renderer's sky cache (`Renderer._sky`). It prints one
JSON line: for each configuration the SHA-256 of the frame's HDR image
and of its u8 image, and for each sky the SHA-256 of its skybox and its
clouds. The calls are those of `Renderer.render` and `Renderer._sky`,
which earlier checkouts of the port share, so running the script once
with --root at an unpacked `git archive` of another commit and once
without, in one call on one card, shows whether the two trees' kernels
give the same bytes. It exits non-zero without a CUDA device.
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
                       sun_mask="off")}
# (sun direction before normalization, or None for the renderer's, time,
# skybox and cloud resolutions)
SKIES = {"sky default sun t 0": (None, 0.0, 256, 512),
         "sky low sun t 1.75": ((0.6, 0.05, 0.8), 1.75, 256, 512),
         "sky low sun t 1.75 at 7/13": ((0.6, 0.05, 0.8), 1.75, 7, 13)}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch renders")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("frame_digest: no CUDA device", file=sys.stderr)
        return 1
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops.rastertrace import raster_camera
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.utils.camera import Camera

    dev = torch.device("cuda", 0)
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    scene = None
    out = {"root": str(root)}
    for name, knobs in CONFIGS.items():
        cfg = RenderConfig(shadow_samples=1, max_ray_iterations=3, **knobs)
        r = Renderer(WorldConfig(depth=4), cfg, device=dev, scene=scene,
                     force_regenerate=scene is None,
                     cache_path=root / "build" / "vvr_tpu_torch"
                     / "map_256.npz")
        scene = r.scene
        o, d = camera_rays(cam, cfg.render_width, cfg.render_height, dev)
        raster = ((scene.ensure_faces(), raster_camera(cam),
                   scene.solid_at_host(cam.position)) if r.use_raster
                  else None)
        img, hdr = render_frame(scene.jumpgrid, o, d, r.sun, 0.0, cfg,
                                sky=r._sky(0.0), raster=raster,
                                sunmask=r._sunmask() if r.use_sunmask
                                else None)
        torch.cuda.synchronize()
        out[name] = {"hdr": digest(hdr), "u8": digest(img),
                     "shape": list(img.shape)}
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
