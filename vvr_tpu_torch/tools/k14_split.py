"""K14's time at the bench view, split into its sample traces and the rest.

    python3 vvr_tpu_torch/tools/k14_split.py [--root DIR]

With the vvr_tpu_torch package found under DIR (default: this checkout),
renders nothing: it builds the 256^3 world, the bench camera's 1920x1080
rays and their raster hits, the clouds and the cone grids, and records
K14's launch arguments in its three modes (four samples: every sample's
DDA, the cone gate, pixelated). It compiles that package's
csrc/softshadow.cu twice with nvcc into build/vvr_tpu_torch/k14_split/: as
it is, and with each sample's trace (the near walk and the DDA) replaced by
a miss, for timing only; each is a shared library loaded with ctypes. It
times both on the same arguments with CUDA events, in turns (full, no
trace, no trace, full), and prints one JSON line per mode with the card's
name and power limit. The difference is what the traces cost; what is left
is the per-pixel and per-sample work around them (the jitter, powf, the
cloud texel, the gate). It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import pathlib
import subprocess
import sys

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
REPS = 20
SAMPLES = 4
# a sample's trace in K14's source: the warp-round design's call, or the
# earlier one-thread-a-pixel design's branch; each becomes a miss
NO_TRACE = (("it_traced && vvr_sample_hit(", "false && vvr_sample_hit("),
            ("        if (traced) {\n", "        if (false) {\n"))


def no_trace(source: str) -> str:
    """K14's source with each sample's trace replaced by a miss."""
    for old, new in NO_TRACE:
        if old in source:
            return source.replace(old, new)
    raise ValueError("K14's source holds no known sample trace")


def build_pair(kernels, out: pathlib.Path) -> dict:
    """{"full", "no trace"}: K14's C entry point from the package's
    csrc/softshadow.cu (`kernels` is the package's kernels module) as it
    is and without its traces, each compiled by nvcc into a shared library
    under `out` and loaded with ctypes."""
    out.mkdir(parents=True, exist_ok=True)
    source = (kernels.CSRC / "softshadow.cu").read_text()
    fns = {}
    for name, text in (("full", source), ("no trace", no_trace(source))):
        cu = out / f"{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                        f"-I{kernels.CSRC}", "-shared", "-o", str(so),
                        str(cu)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(so)).vvr_soft_shadow
        fn.argtypes = list(kernels.KERNELS["soft_shadow"].argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_pair(fns: dict, kernels, softshadow, grid, hits, sun, samples: int,
              clouds, max_steps: int, pixelated: bool, gate,
              width: int) -> dict:
    """{"full": [us, us], "no trace": [us, us]}: both entry points of
    build_pair timed with CUDA events on the arguments the package's
    wrapper passes (recorded, not launched), REPS launches each, in turns
    (full, no trace, no trace, full). `width` goes to a wrapper that takes
    it."""
    import torch
    wide = ({"width": width} if "width" in inspect.signature(
        softshadow.soft_shadow).parameters else {})
    rec = []
    launch = kernels.launch
    kernels.launch = lambda name, device, *a: rec.append(a)
    try:
        factor = softshadow.soft_shadow(grid, *hits, sun, samples, clouds,
                                        max_steps, pixelated, gate, **wide)
    finally:
        kernels.launch = launch
    stream = torch.cuda.current_stream().cuda_stream
    us = {}
    for name in ("full", "no trace", "no trace", "full"):
        fn = fns[name]
        if fn(*rec[0], stream) != 0:
            raise RuntimeError(f"K14 ({name}) did not launch")
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(REPS):
            fn(*rec[0], stream)
        ev[1].record()
        ev[1].synchronize()
        us.setdefault(name, []).append(
            round(ev[0].elapsed_time(ev[1]) / REPS * 1e3, 2))
    del factor   # the output the recorded arguments point to
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose K14 is measured")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k14_split: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import softshadow
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.utils.camera import Camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    fns = build_pair(kernels, root / "build" / "vvr_tpu_torch" / "k14_split")
    cfg = RenderConfig(width=1920, height=1080, shadow_samples=SAMPLES,
                       max_ray_iterations=3)
    r = Renderer(WorldConfig(depth=4), cfg, device=dev,
                 force_regenerate=True,
                 cache_path=root / "build" / "vvr_tpu_torch"
                 / "map_256.npz")
    # the Renderer's grid (a package before the paged grid: the scene's)
    grid = getattr(r, "grid", None) or r.scene.jumpgrid
    faces = r.scene.ensure_faces()
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    w, h = cfg.width, cfg.height
    o, d = camera_rays(cam, w, h, dev)
    res = rt.trace_raster(faces, rt.raster_camera(cam), d,
                          r.scene.solid_at_host(cam.position), grid.size, w,
                          h)
    hits = (o, d, res.hit, res.face, res.axis_coord)
    sun = r.sun[:3].copy()
    clouds = r._sky(0.0)[1]
    e1, e2, s = ss.sun_basis(sun)
    gate = (e1, e2, ss.sun_grids(faces, e1, e2, s, grid.size, ss.GRID,
                                 ss.CONE_TAN))
    max_steps = cfg.traversal_max_steps * 8
    for mode, pix, g in (("every sample's DDA", False, None),
                         ("cone gate", False, gate),
                         ("pixelated", True, None)):
        us = time_pair(fns, kernels, softshadow, grid, hits, sun, SAMPLES,
                       clouds, max_steps, pix, g, w)
        print(json.dumps({"root": str(root), "mode": mode, "samples": SAMPLES,
                          "us": us, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
