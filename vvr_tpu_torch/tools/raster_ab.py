"""K9 and K22 at the bench view, held to their plain versions and timed.

    python3 vvr_tpu_torch/tools/raster_ab.py [--root DIR]

With the vvr_tpu_torch package found under DIR (default: this checkout),
builds its kernels, the 256^3 world and the bench camera's 1920x1080 rays
on the card, then checks K9 `raster_fragments` (the merged faces) and K22
`raster_triangles` (the surface-nets mesh, straddlers clipped) against
their plain versions, bit for bit, and times each: device us a call by
kernel (torch.profiler, REPS calls after a warm-up) and ms a call (CUDA
events around REPS calls). To compare two checkouts on one card, run it in
turns in one call (parent, change, change, parent). Prints the card's name
and power limit, then one JSON line per kernel; exits non-zero without a
CUDA device or when a kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
REPS = 20
WIDTH, HEIGHT = 1920, 1080


def timed(fn, trace_path, profile_frame) -> dict:
    """{"device_us": {kernel: us a call}, "ms": ms a call} of fn()."""
    import torch
    fn()

    def run():
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in profile_frame.trace_events(trace_path, run):
        per[e["name"][:48]] = per.get(e["name"][:48], 0.0) + e["dur"] / REPS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return {"device_us": per, "ms": start.elapsed_time(end) / REPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose K9 and K22 are measured")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("raster_ab: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import raster
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.tools import profile_frame
    from vvr_tpu_torch.utils.camera import Camera

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip())
    kernels.build()
    dev = torch.device("cuda", 0)
    out = root / "build" / "vvr_tpu_torch"
    scene = build_scene(WorldConfig(depth=4), dev, force_regenerate=True,
                        cache_path=out / "map_256.npz")
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    _, d = camera_rays(cam, WIDTH, HEIGHT, dev)
    faces = scene.ensure_faces()
    rcam = rt.raster_camera(cam)
    r = Renderer(WorldConfig(depth=4), RenderConfig(
        width=WIDTH, height=HEIGHT, debug_type=0), device=dev, scene=scene)
    mesh = r.mesh
    m = raster.view_proj(cam, WIDTH, HEIGHT)
    ev, et = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                    cam.position, cam.basis()[2])
    evd, etd = torch.from_numpy(ev).to(dev), torch.from_numpy(et).to(dev)

    def k9():
        return rt.raster_fragments(faces, rcam, d, WIDTH, HEIGHT)

    def k22():
        return raster.raster_triangles(mesh.verts, mesh.tris, m, WIDTH,
                                       HEIGHT, evd, etd)
    keys = rt.raster_fragments_plain(faces, rcam, d, WIDTH, HEIGHT)
    zp, wp = raster.raster_triangles_plain(torch.cat([mesh.verts, evd]),
                                           torch.cat([mesh.tris, etd]), m,
                                           WIDTH, HEIGHT)
    z, win = k22()
    off = {"K9 keys": int((k9() != keys).sum()),
           "K22 z-buffer bits": int((z.view(torch.int32)
                                     != zp.view(torch.int32)).sum()),
           "K22 winners": int((win != wp).sum())}
    for name, fn in (("raster_fragments", k9), ("raster_triangles", k22)):
        row = timed(fn, out / "raster_ab_trace.json", profile_frame)
        print(json.dumps({"root": str(root), "kernel": name,
                          "device_us": sum(row["device_us"].values()),
                          "ms": row["ms"], "by_kernel": row["device_us"],
                          "differ": off}))
    return 0 if not any(off.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
