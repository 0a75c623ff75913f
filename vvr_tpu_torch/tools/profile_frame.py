"""Where the time of the slice frame goes, on one NVIDIA GPU.

    python3 -m vvr_tpu_torch.tools.profile_frame [--trace PATH]

Renders the main-path frame that chip_smoke.py drives (256^3 world,
1920x1080, one hard shadow ray per lit pixel, the bench camera, a fixed
time so no sky rebuild falls in a window) and prints, each from this run:

1. frame time on the host clock without the profiler: synchronized after
   every frame, and issued back to back with one synchronize at the end;
2. per phase, CUDA events around each call of the frame's passes; a phase
   includes the host's launch gaps inside it;
3. one window of synchronized frames under torch.profiler with CUDA
   activity only: device time per kernel per frame, and the device busy
   share of that window = the union of device intervals (kernels, copies,
   sets) over the span from the first to the last event of the trace, both
   on the trace's clock. The profiler's own overhead stretches the window
   on the host, so this share is most likely below the unprofiled one;
4. the trace's work counters at this camera.

It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from vvr_tpu_torch import kernels
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import jump, post, shade, sky
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.camera import Camera

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
FRAMES = 50      # per host-clock window
PROFILED = 20    # frames in the profiled window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The __global__ functions of csrc/, to tell the port's kernels from the
# torch ops (ray generation, the sun expand, the host-to-device copies).
PORT_KERNELS = ("vvr_jump_trace_kernel", "vvr_shade_surface_kernel",
                "vvr_shade_pixel_kernel", "skybox_kernel", "clouds_kernel",
                "downsample_kernel", "upsample_kernel", "composite_kernel")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def host_frames(renderer, cam, n: int, sync_each: bool) -> list[float]:
    """Per-frame host ms; with sync_each=False one mean over n frames."""
    if not sync_each:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            renderer.render(cam, time=0.0)
        torch.cuda.synchronize()
        return [(time.perf_counter() - t0) * 1e3 / n]
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        renderer.render(cam, time=0.0)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profiled_window(renderer, cam, n: int, trace_path: pathlib.Path):
    """n synced frames under torch.profiler (CUDA activity). Returns
    (host ms per frame, the chrome trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            renderer.render(cam, time=0.0)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    return wall, [e for e in events if e.get("ph") == "X" and "dur" in e]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the profiler's chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi (name, power limit, SM clock, max SM clock): {smi}")
    dev = torch.device("cuda", 0)
    kernels.build()
    cfg = RenderConfig(width=1920, height=1080, shadow_samples=1,
                       max_ray_iterations=3, primary_raster="off",
                       sun_mask="off")
    repo = pathlib.Path(__file__).resolve().parents[2]
    renderer = Renderer(WorldConfig(depth=4), cfg, device=dev,
                        force_regenerate=True,
                        cache_path=repo / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    host_frames(renderer, cam, 5, True)

    # ---- 1. host clock, no profiler
    synced = host_frames(renderer, cam, FRAMES, True)
    piped = host_frames(renderer, cam, FRAMES, False)[0]
    print(f"frame, synchronized: median {statistics.median(synced):.4f} ms, "
          f"mean {statistics.fmean(synced):.4f} ms over {FRAMES}")
    print(f"frame, back to back: {piped:.4f} ms per frame over "
          f"{FRAMES}")

    # ---- 2. phases, CUDA events around each call
    grid = renderer.scene.jumpgrid
    max_steps = cfg.traversal_max_steps * 8
    sun3 = torch.from_numpy(renderer.sun[:3].copy())
    skybox, clouds = renderer._sky(0.0)
    sun_col = sky.sun_colour_final(sun3)
    h, w = cfg.height, cfg.width
    names = ("ray generation (plain torch)", "K1 primary trace",
             "K2 shade_surface", "K1 shadow trace (+ sun expand)",
             "K2 shade_pixel", "K4 bloom chain", "K4 composite")
    acc = [0.0] * len(names)
    reps = 20
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        o, d = camera_rays(cam, w, h, dev)
        ev[1].record()
        res = jump.trace_jump(grid, o, d, max_steps)
        ev[2].record()
        s_o, s_a = shade.shade_surface(o, d, res.hit, res.face,
                                       res.axis_coord, sun3)
        ev[3].record()
        s_d = sun3.to(dev).expand(o.shape[0], 3).contiguous()
        sh = jump.trace_jump(grid, s_o, s_d, max_steps, active=s_a)
        ev[4].record()
        hdr = shade.shade_pixel(o, d, res.hit, res.face, res.axis_coord,
                                sh.hit, grid.size, skybox, clouds, sun3,
                                sun_col, h, w)
        ev[5].record()
        bloom2 = post.bloom_pyramid_p(hdr)
        ev[6].record()
        post.composite_p(hdr, bloom2, h, w)
        ev[7].record()
        torch.cuda.synchronize()
        if rep:  # the first pass warms up
            for k in range(len(names)):
                acc[k] += ev[k].elapsed_time(ev[k + 1])
    for name, a in zip(names, acc):
        print(f"phase {name:32s} {a / reps:.4f} ms")
    print(f"phase sum {sum(acc) / reps:.4f} ms")

    # ---- 3. one profiled window
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or pathlib.Path(tmp) / "frame_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        wall, events = profiled_window(renderer, cam, PROFILED, path)
    n = PROFILED
    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    span_a = min(e["ts"] for e in events)
    span_b = max(e["ts"] + e["dur"] for e in events)
    busy = union_us((e["ts"], e["ts"] + e["dur"]) for e in dev_ev)
    per_name: dict[str, list[float]] = {}
    for e in dev_ev:
        s = per_name.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"]
    port_us = sum(v[1] for k, v in per_name.items()
                  if any(p in k for p in PORT_KERNELS))
    cats = sorted({e.get("cat") for e in events})
    print(f"profiled window: {n} synchronized frames, host {wall:.4f} ms per "
          f"frame; trace span {(span_b - span_a) / n / 1e3:.4f} ms per "
          f"frame (event categories {cats})")
    print(f"profiled window: device busy {busy / n / 1e3:.4f} ms per frame, "
          f"busy share {busy / (span_b - span_a):.4f} of the span; the "
          f"port's kernels {port_us / n / 1e3:.4f} ms, other device work "
          f"{(sum(v[1] for v in per_name.values()) - port_us) / n / 1e3:.4f}"
          f" ms per frame")
    for k, (cnt, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  device {us / n:9.2f} us/frame  {cnt / n:5.1f} calls/frame"
              f"  {k[:110]}")

    # ---- 4. trace work at this camera
    it = res.iterations.float()
    print(f"primary rays: hit share {float(res.hit.float().mean()):.4f}, "
          f"sub-steps mean {float(it.mean()):.2f} max {float(it.max()):.0f}, "
          f"row fetches mean {float(res.fetches.float().mean()):.2f}")
    it = sh.iterations.float()[s_a]
    print(f"shadow rays: {int(s_a.sum())} traced, sub-steps mean "
          f"{float(it.mean()):.2f} max {float(it.max()):.0f}, blocked share "
          f"{float(sh.hit.float()[s_a].mean()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
