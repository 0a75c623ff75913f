"""Where the time of the slice frame goes, on one NVIDIA GPU.

    python3 vvr_tpu_torch/tools/profile_frame.py [--trace PATH] [--root DIR]
        [--traversal jump|paged ...]

Renders the frames that chip_smoke.py drives (256^3 world, 1920x1080, the
bench camera, a fixed time so no sky rebuild falls in a frame window; the
K3 window below holds the rebuilds): the default-knob frame (face
rasterizer and sun classifier, one hard shadow ray per lit pixel) and the
DDA frame (`primary_raster="off", sun_mask="off"`), and, where the
measured package renders them, the soft-shadow frames (four samples, with
the cone classifier and with `sun_mask="off"`), the pixelated one (four
samples), config 4 (four soft samples with the cone classifier, four
mirror bounces, the filtered AO) and chip_smoke.py's lights frame (its
first ten lights set near the view's surface before each of its
windows), over one scene, and prints, each from
this run:

1. the default frame's setup beyond the DDA frame's: the merged faces
   (host clock: extraction on the host and the copy to the card) and one
   sun-grid build (CUDA events);
2. frame time on the host clock without the profiler, per frame kind:
   synchronized after every frame, and issued back to back with one
   synchronize at the end;
3. per phase, CUDA events around each call of the frame's passes; a phase
   includes the host's launch gaps inside it;
4. one window of synchronized frames of each kind under torch.profiler
   with CUDA activity only: device time per kernel per frame, summed per
   C entry point (K9's four kernels; K1, the bloom pyramid, the composite,
   K12, K2 shade_surface, K13, K14 and K15 one each; K11's sun grids are
   built before the window), K1's per call of the DDA frame (its
   launches alternate: primary rays, then shadow rays), K1's, K14's and
   K15's per launch of a frame where a frame launches them more than once
   (config 4: bounce by bounce), and the
   device busy share of that window = the union of device intervals
   (kernels, copies, sets) over the span from the first to the last event
   of the trace, both on the trace's clock. The profiler's own overhead
   stretches the window on the host, so this share is most likely below
   the unprofiled one;
   then a K3 window: default frames in pairs, the first of each pair at a
   new 0.25 s sky bucket (the sky is rebuilt) and the second in the same
   bucket, with K3's device time per bucket and its launches per bucket,
   and the two kinds of frame on the host clock without the profiler; K11
   windows: sun-grid builds at 2048^2 and at 512^2 (and the cone grids of
   soft shadows where the package builds them), device time per sun
   direction and per device kernel, and for the cone grids the split by
   launch order into the support pass (every launch before the cone
   build's setup kernel) and the cone build; and drag windows: default
   frames, then soft cone frames where the package renders them, while the
   sun is dragged (`set_sun_dragging(True)`, the sun turned DRAG_STEP
   degrees about the vertical every frame, as the app's middle-mouse drag
   turns it, so each frame builds the 512^2 sun grids, hard or cone, and
   the sky), device time per kernel per frame under the profiler and the
   median and slowest frame on the host clock without it;
5. the work counters at this camera (K9's fragments in its tight boxes
   and in the JAX boxes, its binned (face, tile) pairs and big faces);
6. K11's work per tile: for the default sun and frame_digest's low sun,
   at 2048^2 and 512^2, the (face, texel) pairs of the busiest tile
   against the mean, at tiles of 16, 32 and 64 texels a side; for the cone
   build its (face, texel) pairs in the present boxes and, where the
   package has them, in the tight boxes (sunshadow.cone_boxes_plain), the
   busiest tile against the mean at 16 and 32 texels a side, and the
   support pass's (face, coarse texel) pairs (the most of one face).

With --traversal it measures config 5 instead (tools/bench_scale.py:62-97
without its edits: the 1024^3 world, 1920x1080, its camera; with --depth
4 bench.py's 256^3 world and camera): the setup steps one by one (world
generation, the dense occupancy, the merged faces, each grid named with
its memory, the brick pyramid built on the card, K11 per sun direction),
then for each traversal named ("jump", "paged", "pyramid"), in the order
given, over one scene, the default-knob frame, the DDA frame, the soft
cone frame, config 4's knobs, the lights frame, the overlap AO frame and
the iterations heatmap on the host clock (as in 2.) and in a profiled
window (as in 4., K1's, K16's or K19's time per call of the DDA frame,
K14's and K15's per bounce), and the peak device memory; so
`--traversal paged jump jump paged` holds the jump grid to the paged grid
at 1024^3 in turns, and `--depth 4 --traversal jump pyramid pyramid jump`
the pyramid to the jump grid at 256^3.

It measures the vvr_tpu_torch package found under DIR (default: this
checkout), so one call can run it on an unpacked `git archive` of another
commit and on this one in turns; where that package's K1 wrapper predates
the frame's arguments (image width, no counters, one shadow direction),
the DDA phases call it as that package's frame did. It exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
FRAMES = 50      # per host-clock window
PROFILED = 20    # frames in the profiled window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The __global__ functions of csrc/, to tell the port's kernels from the
# torch ops (ray generation, the sun expand, the host-to-device copies).
PORT_KERNELS = ("vvr_trace_kernel", "vvr_shade_surface_kernel",
                "vvr_shade_pixel_kernel", "skybox_kernel", "clouds_kernel",
                "vvr_sky_kernel",
                "vvr_bloom_pyramid_kernel", "composite_kernel",
                "vvr_raster_", "vvr_scan_", "vvr_bin_kernel", "vvr_sun_",
                "vvr_masked_shadow_kernel", "vvr_generate_rays_kernel",
                "vvr_soft_shadow_kernel", "vvr_shade_bounce_kernel",
                "vvr_overlap_density_kernel", "vvr_debug_image_kernel",
                "vvr_mesh_project_kernel", "vvr_tri_",
                "vvr_shade_raster_kernel")
# K1, K16 and K19: the three grid views of one kernel body (csrc/trace.cu)
K1_NAME = "vvr_trace_kernel<VvrFlatView"
K16_NAME = "vvr_trace_kernel<VvrPagedView"
K19_NAME = "vvr_trace_kernel<VvrPyramidViewT"
# the device kernels of one C entry point, by name part: K9 launches
# project, scan, bin and tile kernels (and a memset), K22 project, setup,
# scan, bin and tile kernels (and a memset), the others one each. K9 and
# K22 launch the same bin kernel (csrc/tilebin.cuh), so each entry counts
# it; no frame runs both
ENTRY_KERNELS = {
    "K1 jump_trace": (K1_NAME,),
    "K16 paged_trace": (K16_NAME,),
    "K19 pyramid_trace": (K19_NAME,),
    "K21 debug_image": ("vvr_debug_image_kernel",),
    "K9 raster_fragments": ("vvr_raster_project", "vvr_scan_",
                            "vvr_bin_kernel", "vvr_raster_tile"),
    "K22 raster_triangles": ("vvr_mesh_project_kernel", "vvr_tri_",
                             "vvr_bin_kernel"),
    "K23 shade_raster": ("vvr_shade_raster_kernel",),
    "K4 bloom_pyramid": ("vvr_bloom_pyramid_kernel",),
    "K4 composite": ("composite_kernel",),
    "K12 masked_shadow": ("vvr_masked_shadow_kernel",),
    "K2 shade_surface": ("vvr_shade_surface_kernel",),
    "K13 generate_rays": ("vvr_generate_rays_kernel",),
    "K14 soft_shadow": ("vvr_soft_shadow_kernel",),
    "K15 shade_bounce": ("vvr_shade_bounce_kernel",),
}
# the soft-shadow frames: label, knobs beside the default frame's
SOFT_FRAMES = (("soft, cone", dict(shadow_samples=4)),
               ("soft, DDA", dict(shadow_samples=4, sun_mask="off")),
               ("pixelated", dict(shadow_samples=4, pixelated_shadows=True)))
# config 4 (tools/bench_scale.py:33-50) and chip_smoke.py's lights frame
# (hard shadows, AO, the first ten lights set near the view's surface,
# wavy mirrors): label, knobs beside the default frame's, the Renderer's
# keywords
BOUNCE_FRAMES = (("config 4", dict(shadow_samples=4, max_ray_iterations=4,
                                   ambient_occlusion=True),
                  dict(mirror_materials=True)),
                 ("lights", dict(max_ray_iterations=3,
                                 ambient_occlusion=True, point_lights=True,
                                 wavy_reflections=True),
                  dict(mirror_materials=True)))
# K3's device kernels: one per texture in earlier checkouts, one for both
K3_KERNELS = ("skybox_kernel", "clouds_kernel", "vvr_sky_kernel")
SKY_BUCKETS = 8  # sky rebuilds in the K3 window
LOW_SUN = (0.6, 0.05, 0.8)   # frame_digest.py's low sun
# config 5 (tools/bench_scale.py:62-97) without its edits: its camera and
# the frames measured at 1024^3
CONFIG5_CAMERA = ([512.0, 400.0, 80.0], [512.0, 80.0, 720.0], 85.0)
CONFIG5_FRAMES = (("default knobs", {}, {}),
                  ("DDA", dict(primary_raster="off", sun_mask="off"), {}),
                  ("soft, cone", dict(shadow_samples=4), {}),
                  *BOUNCE_FRAMES,
                  ("overlap AO", dict(ambient_occlusion=True,
                                      ao_mode="overlap"), {}),
                  ("iterations heatmap", dict(debug_type=1), {}))
DRAG_STEP = 0.5   # degrees the dragged sun turns about the vertical a frame


def dragged_sun(sun, k: int):
    """The sun (x, y, z, w) turned k steps of DRAG_STEP degrees about the
    vertical: a sun dragged along the sky at a fixed height above the
    horizon, as the app's middle-mouse drag moves it every frame
    (vvr_tpu/app.py:80-85), as float32 (x, y, z, 0) of unit length."""
    a = math.radians(DRAG_STEP * k)
    x, y, z = (float(c) for c in sun[:3])
    v = np.array([x * math.cos(a) + z * math.sin(a), y,
                  -x * math.sin(a) + z * math.cos(a)])
    return np.append(v / np.linalg.norm(v), 0.0).astype(np.float32)


def place_lights(scene, grid, rays, trace) -> None:
    """The scene's first ten lights 2 units back along ten seeded camera
    rays `rays` (o, d) from their hits by `trace` on `grid`, as
    chip_smoke.py places them for the lights frame (every frame of every
    Renderer on the scene moves them, so they are placed again before
    each window)."""
    o, d = rays
    first = trace(grid, o, d, 2048)
    seeded = np.random.default_rng(11).choice(
        torch.nonzero(first.hit)[:, 0].cpu().numpy(), 10, replace=False)
    scene.lights[:10, :3] = (o + d * (first.t[:, None] - 2.0))[
        seeded].cpu().numpy()


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


def phases(names, calls, reps: int = 20) -> None:
    """CUDA events around each call of one frame's passes, `reps` frames
    after one warm-up frame; prints the mean per phase and the sum."""
    acc = [0.0] * len(names)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        ev[0].record()
        state = {}
        for k, call in enumerate(calls):
            call(state)
            ev[k + 1].record()
        torch.cuda.synchronize()
        if rep:  # the first pass warms up
            for k in range(len(names)):
                acc[k] += ev[k].elapsed_time(ev[k + 1])
    for name, a in zip(names, acc):
        print(f"phase {name:34s} {a / reps:.4f} ms")
    print(f"phase sum {sum(acc) / reps:.4f} ms")


def window(label, renderer, cam, trace_path) -> None:
    """One profiled window of PROFILED synchronized frames."""
    wall, events = profiled_window(renderer, cam, PROFILED, trace_path)
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
    print(f"profiled window ({label}): {n} synchronized frames, host "
          f"{wall:.4f} ms per frame; trace span "
          f"{(span_b - span_a) / n / 1e3:.4f} ms per frame (event "
          f"categories {cats})")
    print(f"profiled window ({label}): device busy {busy / n / 1e3:.4f} ms "
          f"per frame, busy share {busy / (span_b - span_a):.4f} of the "
          f"span; the port's kernels {port_us / n / 1e3:.4f} ms, other "
          f"device work "
          f"{(sum(v[1] for v in per_name.values()) - port_us) / n / 1e3:.4f}"
          f" ms per frame")
    for k, (cnt, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  device {us / n:9.2f} us/frame  {cnt / n:5.1f} calls/frame"
              f"  {k[:110]}")
    for entry, parts in ENTRY_KERNELS.items():
        got = [v for k, v in per_name.items() if any(p in k for p in parts)]
        print(f"  entry {entry}: device {sum(v[1] for v in got) / n:.2f} "
              f"us/frame in {sum(v[0] for v in got) / n:.1f} kernels/frame")
    for label, part in (("K1", K1_NAME), ("K16", K16_NAME),
                        ("K19", K19_NAME)):
        k1 = sorted((e["ts"], e["dur"]) for e in dev_ev
                    if part in e["name"])
        if k1 and len(k1) == 2 * n:
            primary, shadow = (sum(u for _, u in k1[k::2]) / n
                               for k in (0, 1))
            print(f"  {label} per call: primary rays {primary:.2f} us/frame,"
                  f" shadow rays {shadow:.2f} us/frame")
    # the kernels a bounce loop launches more than once a frame, by their
    # k-th launch of a frame: K14's and K15's is bounce k, K1's bounce k +
    # 1 in a frame with mirrors and the rasterizer
    for label, part in (("K1", K1_NAME), ("K16", K16_NAME),
                        ("K19", K19_NAME),
                        ("K14", "vvr_soft_shadow_kernel"),
                        ("K15", "vvr_shade_bounce_kernel")):
        ev_k = sorted((e["ts"], e["dur"]) for e in dev_ev
                      if part in e["name"])
        per = len(ev_k) // n
        if per > 1 and len(ev_k) == per * n:
            print(f"  {label} per launch of a frame: " + ", ".join(
                f"{b}: {sum(u for _, u in ev_k[b::per]) / n:.2f} us"
                for b in range(per)))


def trace_events(trace_path: pathlib.Path, run):
    """run() under torch.profiler with CUDA activity only; the trace's
    complete device events (kernels, copies, sets)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]


# The timing helpers of the port's measurements (chip_smoke.py,
# tools/kernel_ab.py, tools/microbench_gather.py).

# device cycles the card spins at the start of a profiled window of
# `device_us` (about 5 ms), so its launches run once the trace is live
WINDOW_SPIN_CYCLES = 10_000_000
# bytes written between the timed launches of `flushed_us`: more than the
# H100's 50 MB L2, so each launch finds its inputs in device memory
L2_FLUSH_BYTES = 128 << 20


def device_us(fn, parts, reps: int, trace_path, each: bool = False,
              tries: int = 3, before=None) -> float:
    """Device time of one fn() call (torch.profiler), from the trace of
    `reps` calls after a warm-up, before() ahead of each call where given
    (its device work named by none of `parts`): the mean launch of the
    kernel whose name holds every part of `parts`, fn() launching it once;
    with `each`, fn() launching one kernel whose name holds each part, the
    sum of their mean launches. The profiler can drop a window's first
    launches (a window of short kernels can lose them all), so the calls
    queue behind a device spin, and a window that misses a kernel is run
    again, up to `tries` times; after that the time is the mean of CUDA
    event pairs around each call, and the line printed says so."""
    fn()

    def run():
        torch.cuda._sleep(WINDOW_SPIN_CYCLES)
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()   # every launch ends inside the window
    groups = [(p,) for p in parts] if each else [parts]
    for attempt in range(tries):
        events = trace_events(trace_path, run)
        durs = [[e["dur"] for e in events if all(p in e["name"] for p in g)]
                for g in groups]
        missing = [g for g, d in zip(groups, durs) if not d]
        if not missing:
            return sum(sum(d) / len(d) for d in durs)
        print(f"device_us: window {attempt + 1} of {tries}: the profiler "
              f"recorded no launch of {missing}")
    us = cuda_event_us(fn, reps, before)
    print(f"device_us: {parts} timed by CUDA events instead: {us:.2f} us "
          f"a call")
    return us


def cuda_ms(fn, reps: int) -> float:
    """Mean time in ms of one fn() call between CUDA events around `reps`
    calls back to back, after one warm-up call (the host's launch path
    included where it is slower than the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_event_us(fn, reps: int, before=None) -> float:
    """Mean time in us of one fn() call between a CUDA event pair, after
    one warm-up; before() runs ahead of each pair, outside it."""
    fn()
    total = 0.0
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps * 1e3


def flushed_us(fn, reps: int, dev) -> float:
    """Mean time in us of one fn() launch with the L2 cache flushed before
    it: a CUDA event pair around each launch, L2_FLUSH_BYTES of another
    buffer written in between (outside the pair), after one warm-up. The
    time of a kernel whose inputs a back-to-back loop keeps in L2."""
    scrap = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    return cuda_event_us(fn, reps, before=lambda: scrap.fill_(1.0))


def host_us(fn, reps: int) -> float:
    """Mean host time in us of one fn() call over `reps` calls after a
    warm-up (host clock; the card synchronized before and after, outside
    the time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def sky_window(renderer, cam, trace_path) -> None:
    """K3 per sky bucket: SKY_BUCKETS pairs of synchronized frames, the
    first of each at a new 0.25 s bucket (the sky is rebuilt), the second
    1/60 s later in the same bucket, under the profiler; then the same
    frames on the host clock without it."""
    q = renderer.cfg.sky_cache_quantum
    times = [(q * k, q * k + 1.0 / 60.0) for k in range(1, SKY_BUCKETS + 1)]

    def run():
        for pair in times:
            for t in pair:
                renderer.render(cam, time=t)
                torch.cuda.synchronize()

    events = trace_events(trace_path, run)
    per_name: dict[str, list[float]] = {}
    for e in events:
        if any(p in e["name"] for p in K3_KERNELS):
            s = per_name.setdefault(e["name"], [0, 0.0])
            s[0] += 1
            s[1] += e["dur"]
    total = sum(v[1] for v in per_name.values())
    print(f"K3 window: {SKY_BUCKETS} sky rebuilds in {2 * SKY_BUCKETS} "
          f"synchronized frames; K3 device {total / SKY_BUCKETS:.2f} us per "
          f"bucket in "
          f"{sum(v[0] for v in per_name.values()) / SKY_BUCKETS:.1f} "
          f"launches per bucket")
    for k, (cnt, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  device {us / SKY_BUCKETS:9.2f} us/bucket  "
              f"{cnt / SKY_BUCKETS:4.1f} calls/bucket  {k[:100]}")
    host = ([], [])
    for pair in times:
        for k, t in enumerate(pair):
            t0 = time.perf_counter()
            renderer.render(cam, time=t + q * (SKY_BUCKETS + 1))
            torch.cuda.synchronize()
            host[k].append((time.perf_counter() - t0) * 1e3)
    print(f"K3 window, host clock without the profiler: frames that rebuild "
          f"the sky median {statistics.median(host[0]):.4f} ms, max "
          f"{max(host[0]):.4f}; the frames after them median "
          f"{statistics.median(host[1]):.4f} ms, max {max(host[1]):.4f}")


def k11_window(faces, basis, size: int, grid: int, trace_path,
               calls: int = 10, cone_tan: float = 0.0) -> float:
    """K11 per sun direction at `grid`^2 (the cone grids of soft shadows
    with cone_tan > 0): `calls` sun-grid builds under the profiler; prints
    the device time per build, in total and per device kernel, and
    returns the total in us."""
    from vvr_tpu_torch.ops import sunshadow as ss
    cone = (cone_tan,) if cone_tan > 0.0 else ()

    def run():
        for _ in range(calls):
            ss.sun_grids(faces, *basis, size, grid, *cone)
        torch.cuda.synchronize()

    events = trace_events(trace_path, run)
    per_name: dict[str, list[float]] = {}
    for e in events:
        s = per_name.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"]
    us = sum(v[1] for v in per_name.values()) / calls
    if cone:
        # by launch order: a build ends with its cone tile kernel (template
        # mode 1); its cone build starts at the last setup kernel before
        # that, and its support pass is what runs between the two builds
        ev = sorted(events, key=lambda e: e["ts"])
        split, builds, start, setup = [0.0, 0.0], 0, 0, None
        for k, e in enumerate(ev):
            if "vvr_sun_setup_kernel" in e["name"]:
                setup = k
            elif ("vvr_sun_tile_kernel" in e["name"] and ", 1>" in e["name"]
                  and setup is not None):
                split[0] += sum(x["dur"] for x in ev[start:setup])
                split[1] += sum(x["dur"] for x in ev[setup:k + 1])
                builds, start, setup = builds + 1, k + 1, None
        print(f"K11 cone split ({grid}^2, by launch order, {builds} "
              f"builds): support pass {split[0] / max(builds, 1):.2f} us, "
              f"cone build {split[1] / max(builds, 1):.2f} us per sun "
              f"direction")
    print(f"K11 window: {calls} {'cone ' if cone else ''}sun-grid builds "
          f"({grid}^2), device "
          f"{us:.2f} us per sun direction in "
          f"{sum(v[0] for v in per_name.values()) / calls:.1f} device "
          f"kernels, copies and sets per build")
    for k, (cnt, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  device {t / calls:9.2f} us/build  {cnt / calls:4.1f} "
              f"calls/build  {k[:100]}")
    return us


def tile_pairs(fs, grid: int, tile: int):
    """(tile, tile)-texel tiles' (face, texel) pairs of K11 at `grid`^2:
    (tiles per side)^2 int64 counts, from the per-face setup `fs`
    (sunshadow.face_setup) as the sum over each tile of the number of
    occluder boxes that cover each texel (a 2D difference array)."""
    occ = fs["occl"]
    i0, i1, j0, j1 = (fs[k][occ] for k in ("oi0", "oi1", "oj0", "oj1"))
    n = grid + 1
    diff = torch.zeros(n * n, dtype=torch.int64, device=i0.device)
    for ii, jj, sign in ((i0, j0, 1), (i1 + 1, j0, -1), (i0, j1 + 1, -1),
                         (i1 + 1, j1 + 1, 1)):
        diff.index_add_(0, jj * n + ii, torch.full_like(ii, sign))
    cover = diff.view(n, n).cumsum(0).cumsum(1)[:grid, :grid]
    t = -(-grid // tile)
    cover = torch.nn.functional.pad(cover, (0, t * tile - grid,
                                            0, t * tile - grid))
    return cover.view(t, tile, t, tile).sum((1, 3))


def k11_balance(faces, size: int, suns: dict) -> None:
    """K11's work per tile: for each sun and grid, the (face, texel) pairs
    of the busiest tile against the mean over all tiles and over the tiles
    with work, at tiles of 16, 32 and 64 texels a side, and the occluders'
    spans in 64-texel bins."""
    from vvr_tpu_torch.ops import sunshadow as ss
    for label, sun in suns.items():
        e1, e2, s = ss.sun_basis(sun)
        for grid in (ss.GRID, ss.GRID_DRAGGING):
            a0, b0, ts = ss.grid_frame(e1, e2, size, grid)
            fs = ss.face_setup(faces, e1, e2, s, a0, b0, ts, grid)
            occ = fs["occl"]
            spans = ((fs["oi1"] // 64 - fs["oi0"] // 64 + 1)
                     * (fs["oj1"] // 64 - fs["oj0"] // 64 + 1))[occ]
            parts = []
            for tile in (16, 32, 64):
                per = tile_pairs(fs, grid, tile).flatten().double()
                busy = per[per > 0]
                parts.append(
                    f"{tile}^2 tiles: {per.numel()}, with work "
                    f"{busy.numel()}, pairs {float(per.sum()):.0f}, busiest "
                    f"{float(per.max()):.0f}, mean {float(per.mean()):.1f} "
                    f"(with work {float(busy.mean()):.1f}), busiest / mean "
                    f"{float(per.max() / per.mean()):.2f}")
            print(f"K11 balance, {label} sun, {grid}^2: {int(occ.sum())} "
                  f"occluders of {occ.numel()} faces, their spans in 64^2 "
                  f"bins: max {int(spans.max())}, over 16: "
                  f"{int((spans > 16).sum())}, over 4: "
                  f"{int((spans > 4).sum())}; " + "; ".join(parts))
            cone_balance(faces, size, label, (e1, e2, s), grid)


def cone_balance(faces, size: int, label: str, basis, grid: int) -> None:
    """The cone build's (face, texel) pairs in the present boxes and, where
    the package has them, the tight boxes: the total, and the busiest tile
    against the mean at 16 and 32 texels a side; and the support pass's
    (face, coarse texel) pairs."""
    from vvr_tpu_torch.ops import sunshadow as ss
    a0, b0, ts = ss.grid_frame(*basis[:2], size, grid)
    fs = ss.face_setup(faces, *basis, a0, b0, ts, grid, ss.CONE_TAN, size)
    boxes = {"present": tuple(fs[k] for k in ("oi0", "oi1", "oj0", "oj1"))}
    if hasattr(ss, "cone_boxes_plain"):
        sg = ss.support_grid_plain(fs, a0, b0, ts, grid)
        boxes["tight"] = ss.cone_boxes_plain(fs, sg, a0, b0, ts, grid,
                                             ss.CONE_TAN)
    parts = []
    for name, box in boxes.items():
        f = dict(fs, oi0=box[0], oi1=box[1], oj0=box[2], oj1=box[3],
                 occl=fs["occl"] & (box[0] <= box[1]))
        for tile in (16, 32):
            per = tile_pairs(f, grid, tile).flatten().double()
            parts.append(f"{name} boxes {tile}^2 tiles: pairs "
                         f"{float(per.sum()):.0f}, busiest "
                         f"{float(per.max()):.0f}, mean "
                         f"{float(per.mean()):.1f}, "
                         f"busiest / mean {float(per.max() / per.mean()):.1f}")
    sup = (fs["si1"] - fs["si0"] + 1) * (fs["sj1"] - fs["sj0"] + 1)
    print(f"K11 cone balance, {label} sun, {grid}^2: " + "; ".join(parts)
          + f"; support pass (face, coarse texel) pairs {int(sup.sum())}, "
          f"the most of one face {int(sup.max())}")


def drag_window(renderer, cam, trace_path, frames: int,
                label: str = "default knobs") -> None:
    """Frames while the sun is dragged (`set_sun_dragging(True)`, the sun
    turned by `dragged_sun` every frame): device time per frame by kernel
    under the profiler, then the host clock without it."""
    start = renderer.sun.copy()
    renderer.set_sun_dragging(True)

    def run(k0):
        for k in range(frames):
            renderer.sun = dragged_sun(start, k0 + k + 1)
            renderer.render(cam, time=0.0)
            torch.cuda.synchronize()

    run(0)   # the first dragged builds
    events = trace_events(trace_path, lambda: run(frames))
    per_name: dict[str, list[float]] = {}
    for e in events:
        s = per_name.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"]
    busy = union_us((e["ts"], e["ts"] + e["dur"]) for e in events)
    print(f"drag window ({label}): {frames} synchronized frames, the sun "
          f"turned {DRAG_STEP} degrees a frame; device busy "
          f"{busy / frames / 1e3:.4f} ms per frame")
    for k, (cnt, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  device {us / frames:9.2f} us/frame  {cnt / frames:5.1f} "
              f"calls/frame  {k[:100]}")
    host = []
    for k in range(frames):
        renderer.sun = dragged_sun(start, 2 * frames + k + 1)
        t0 = time.perf_counter()
        renderer.render(cam, time=0.0)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"drag window ({label}), host clock without the profiler: median "
          f"{statistics.median(host):.4f} ms, max {max(host):.4f} ms over "
          f"{frames} dragged frames")
    renderer.set_sun_dragging(False)
    renderer.sun = start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the default frame's chrome trace here")
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch is measured")
    ap.add_argument("--traversal", nargs="+",
                    choices=("jump", "paged", "pyramid"), default=(),
                    help="measure config 5 at 1024^3 through each of these "
                    "grids in turn instead")
    ap.add_argument("--depth", type=int, choices=(4, 5), default=5,
                    help="with --traversal: the world's depth (4: bench.py's "
                    "256^3 world and camera)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import jump, post, shade, sky
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.utils.camera import Camera
    from vvr_tpu_torch.world.faces import extract_merged_faces
    from vvr_tpu_torch.world.generator import assemble_dense
    print(f"measuring the vvr_tpu_torch of {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi (name, power limit, SM clock, max SM clock): {smi}")
    dev = torch.device("cuda", 0)
    kernels.build()
    knobs = dict(width=1920, height=1080, shadow_samples=1,
                 max_ray_iterations=3)
    if args.traversal:
        return config5(root, args.traversal, knobs, dev, args.depth)
    cfg = RenderConfig(**knobs)
    wcfg = WorldConfig(depth=4)
    renderer = Renderer(wcfg, cfg, device=dev, force_regenerate=True,
                        cache_path=root / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    dda = Renderer(wcfg, RenderConfig(**knobs, primary_raster="off",
                                      sun_mask="off"),
                   device=dev, scene=renderer.scene)
    soft = []
    for label, extra in SOFT_FRAMES:
        try:
            soft.append((label, Renderer(wcfg, RenderConfig(**{
                **knobs, **extra}), device=dev, scene=renderer.scene)))
        except NotImplementedError as e:
            print(f"frame ({label}): not rendered by this package ({e})")
    for label, extra, kw in BOUNCE_FRAMES:
        try:
            soft.append((label, Renderer(wcfg, RenderConfig(**{
                **knobs, **extra}), device=dev, scene=renderer.scene, **kw)))
        except NotImplementedError as e:
            print(f"frame ({label}): not rendered by this package ({e})")
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    # the Renderer's grid (a package before the paged grid: the scene's)
    grid = getattr(renderer, "grid", None) or renderer.scene.jumpgrid
    max_steps = cfg.traversal_max_steps * 8
    sun3 = torch.from_numpy(renderer.sun[:3].copy())
    sun_np = renderer.sun[:3].copy()
    h, w = cfg.height, cfg.width

    # ---- 1. setup of the default frame
    t0 = time.perf_counter()
    occ = assemble_dense(renderer.scene.chunks, wcfg.size)
    t1 = time.perf_counter()
    faces = extract_merged_faces(occ).device_tuple(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"setup faces: {faces[0].shape[0]} merged faces, "
          f"{(t2 - t1) * 1e3:.1f} ms to extract and copy to the card "
          f"(host clock; the dense occupancy took another "
          f"{(t1 - t0) * 1e3:.1f} ms)")
    e1, e2, s = ss.sun_basis(sun_np)
    ss.sun_grids(faces, e1, e2, s, wcfg.size)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        grids = ss.sun_grids(faces, e1, e2, s, wcfg.size)
    ev[1].record()
    torch.cuda.synchronize()
    print(f"setup sun grids (K11, per sun direction): "
          f"{ev[0].elapsed_time(ev[1]) / 10:.4f} ms, {ss.GRID}^2 texels")

    # ---- 2. host clock, no profiler
    for r, label in ((renderer, "default knobs"), (dda, "DDA"),
                     *((r_, l_) for l_, r_ in soft)):
        if label == "lights":
            place_lights(renderer.scene, grid, camera_rays(cam, w, h, dev),
                         jump.trace_jump)
        host_frames(r, cam, 5, True)
        synced = host_frames(r, cam, FRAMES, True)
        piped = host_frames(r, cam, FRAMES, False)[0]
        print(f"frame ({label}), synchronized: median "
              f"{statistics.median(synced):.4f} ms, mean "
              f"{statistics.fmean(synced):.4f} ms over {FRAMES}")
        print(f"frame ({label}), back to back: {piped:.4f} ms per frame "
              f"over {FRAMES}")

    # ---- 3. phases, CUDA events around each call
    skybox, clouds = renderer._sky(0.0)
    sun_col = sky.sun_colour_final(sun3)
    rcam = rt.raster_camera(cam)
    probe = renderer.scene.solid_at_host(cam.position)

    def rays(st):
        st["o"], st["d"] = camera_rays(cam, w, h, dev)

    def fragments(st):
        st["keys"] = rt.raster_fragments(faces, rcam, st["d"], w, h)

    def resolve(st):
        st["res"] = rt.raster_resolve(st["keys"], rcam, st["d"], probe,
                                      wcfg.size)

    # K1 as the measured package's DDA frame calls it
    frame_k1 = ({"width": w, "stats": False}
                if "stats" in inspect.signature(jump.trace_jump).parameters
                else None)

    def primary(st):
        st["res"] = jump.trace_jump(grid, st["o"], st["d"], max_steps,
                                    **(frame_k1 or {}))

    def surface(st):
        r = st["res"]
        st["s_o"], st["s_a"] = shade.shade_surface(
            st["o"], st["d"], r.hit, r.face, r.axis_coord, sun3)

    def classifier(st):
        r = st["res"]
        st["sh"] = ss.masked_shadow_from_hits(
            grid, st["o"], st["d"], r.hit, r.face, r.axis_coord, sun_np, e1,
            e2, grids, max_steps)

    def shadow(st):
        if frame_k1 is None:
            s_d = sun3.to(dev).expand(st["o"].shape[0], 3).contiguous()
            st["sh"] = jump.trace_jump(grid, st["s_o"], s_d, max_steps,
                                       active=st["s_a"]).hit
        else:
            st["sh"] = jump.trace_jump(grid, st["s_o"], sun3.to(dev),
                                       max_steps, active=st["s_a"],
                                       **frame_k1).hit

    def pixel(st):
        r = st["res"]
        st["hdr"] = shade.shade_pixel(st["o"], st["d"], r.hit, r.face,
                                      r.axis_coord, st["sh"], grid.size,
                                      skybox, clouds, sun3, sun_col, h, w)

    def bloom(st):
        st["bloom"] = post.bloom_pyramid_p(st["hdr"])

    def composite(st):
        post.composite_p(st["hdr"], st["bloom"], h, w)

    print("phases (default knobs):")
    phases(("ray generation (camera_rays)", "K9 raster fragments",
            "K10 raster resolve", "K12 masked shadow (from the hits)",
            "K2 shade_pixel", "K4 bloom pyramid", "K4 composite"),
           (rays, fragments, resolve, classifier, pixel, bloom, composite))
    print("phases (DDA):")
    phases(("ray generation (camera_rays)", "K1 primary trace",
            "K2 shade_surface", "K1 shadow trace",
            "K2 shade_pixel", "K4 bloom pyramid", "K4 composite"),
           (rays, primary, surface, shadow, pixel, bloom, composite))

    # ---- 4. one profiled window per frame kind
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or pathlib.Path(tmp) / "frame_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        window("default knobs", renderer, cam, path)
        window("DDA", dda, cam, pathlib.Path(tmp) / "dda_trace.json")
        for k, (label, r) in enumerate(soft):
            if label == "lights":
                place_lights(renderer.scene, grid,
                             camera_rays(cam, w, h, dev), jump.trace_jump)
            window(label, r, cam, pathlib.Path(tmp) / f"soft{k}_trace.json")
        sky_window(renderer, cam, pathlib.Path(tmp) / "sky_trace.json")
        for g in (ss.GRID, ss.GRID_DRAGGING):
            k11_window(faces, (e1, e2, s), wcfg.size, g,
                       pathlib.Path(tmp) / f"k11_{g}_trace.json")
            if soft:
                k11_window(faces, (e1, e2, s), wcfg.size, g,
                           pathlib.Path(tmp) / f"k11c_{g}_trace.json",
                           cone_tan=ss.CONE_TAN)
        drag_window(renderer, cam, pathlib.Path(tmp) / "drag_trace.json",
                    FRAMES // 2)
        for label, r in soft[:1]:   # the soft cone frame
            drag_window(r, cam, pathlib.Path(tmp) / "drag_soft_trace.json",
                        FRAMES // 2, label)

    # ---- 5. work at this camera
    st = {}
    for call in (rays, primary, surface, shadow):
        call(st)
    sh, s_a = st["sh"], st["s_a"]
    res = jump.trace_jump(grid, st["o"], st["d"], max_steps)  # counters
    it = res.iterations.float()
    print(f"primary rays (K1): hit share {float(res.hit.float().mean()):.4f}, "
          f"sub-steps mean {float(it.mean()):.2f} max {float(it.max()):.0f}, "
          f"row fetches mean {float(res.fetches.float().mean()):.2f}")
    frags = {}
    for tight in (False, True):
        use, imin, imax, jmin, jmax = rt.project_faces(faces, rcam, w, h,
                                                       tight)
        frags[tight] = float(torch.where(
            use, (imax - imin + 1) * (jmax - jmin + 1), 0).sum())
    print(f"raster: {int(use.sum())} of {faces[0].shape[0]} faces make "
          f"fragments in K9's tight boxes, {frags[True]:.0f} fragments "
          f"({frags[True] / (w * h):.2f} per pixel; the JAX boxes of the "
          f"plain version {frags[False]:.0f}, "
          f"{frags[False] / (w * h):.2f} per pixel)")
    spans = ((imax // rt.TILE - imin // rt.TILE + 1)
             * (jmax // rt.TILE - jmin // rt.TILE + 1))
    binned = use & (spans <= rt.BIN_MAX)
    n_tiles = -(-w // rt.TILE) * -(-h // rt.TILE)
    print(f"raster bins ({rt.TILE}^2 tiles, {n_tiles} of them): "
          f"{int(binned.sum())} faces binned into "
          f"{int(spans[binned].sum())} (face, tile) pairs, "
          f"{int((use & ~binned).sum())} on the big list that every tile "
          f"reads")
    full = jump.trace_jump(grid, st["s_o"], sun3.to(dev).expand(
        w * h, 3).contiguous(), max_steps, active=s_a)
    it = full.iterations.float()[s_a]
    print(f"shadow rays: {int(s_a.sum())} traced, sub-steps mean "
          f"{float(it.mean()):.2f} max {float(it.max()):.0f}, blocked share "
          f"{float(sh.float()[s_a].mean()):.4f}")
    branch = ss.shadow_branches(grid, st["s_o"], sun_np, e1, e2, grids,
                                s_a)
    counts = torch.bincount(branch, minlength=len(ss.BRANCHES)).tolist()
    residue = branch == ss.BRANCHES.index("residue")
    rit = full.iterations.float()[residue]
    print(f"sun classifier: {int(residue.sum())} lanes "
          f"({float(residue.sum() / s_a.sum()):.4f} of the active) left to "
          f"the DDA, their sub-steps mean {float(rit.mean()):.2f} max "
          f"{float(rit.max()):.0f}; lanes by branch "
          f"{dict(zip(ss.BRANCHES, counts))}")

    # ---- 6. K11's work per tile
    k11_balance(faces, wcfg.size, {"default": sun_np, "low": LOW_SUN})
    return 0


def config5(root: pathlib.Path, traversals, knobs: dict, dev,
            depth: int = 5) -> int:
    """Config 5's setup and its static frames at 1024^3 (bench.py's world
    at depth 4) through each grid of `traversals` in turn, over one scene
    (module docstring)."""
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.utils.camera import Camera
    try:   # the tracer of either grid (an older package: the jump grid)
        from vvr_tpu_torch.ops.trace import trace
    except ImportError:
        from vvr_tpu_torch.ops.jump import trace_jump as trace
    wcfg = WorldConfig(depth=depth)
    world = "config 5" if depth == 5 else f"{wcfg.size}^3"
    torch.zeros(1, device=dev)   # the allocator's state for the device
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"setup ({world}) {label}: {time.perf_counter() - t0:.3f} s "
              "(host clock)")
        return out

    scene = timed("world generation", lambda: build_scene(
        wcfg, dev, force_regenerate=True,
        cache_path=root / "build" / "vvr_tpu_torch"
        / f"map_{wcfg.size}.npz"))
    if hasattr(scene, "dense"):   # a package that builds its grids lazily
        timed("dense occupancy", scene.dense)
        for trav in dict.fromkeys(traversals):
            build = {"paged": "ensure_paged", "jump": "ensure_jumpgrid",
                     "pyramid": "ensure_pyramid"}[trav]
            if not hasattr(scene, build):
                print(f"setup ({world}) {trav} grid: not in this package")
                continue
            g = timed(f"{trav} grid", getattr(scene, build))
            tabs = [g.prows, g.brows] if trav == "paged" else [g.rows]
            print(f"setup ({world}) {trav} grid: "
                  f"{sum(t.numel() * 4 for t in tabs) / 2**20:.2f} MiB")
    faces = timed("merged faces", scene.ensure_faces)
    print(f"setup ({world}): {faces[0].shape[0]} merged faces")
    sun = np.array([-0.28, 0.65, -0.71], np.float32)
    e1, e2, s = ss.sun_basis(sun / np.linalg.norm(sun))
    ss.sun_grids(faces, e1, e2, s, wcfg.size)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        ss.sun_grids(faces, e1, e2, s, wcfg.size)
    ev[1].record()
    torch.cuda.synchronize()
    print(f"setup ({world}) sun grids (K11, per sun direction): "
          f"{ev[0].elapsed_time(ev[1]) / 10:.4f} ms, {ss.GRID}^2 texels")
    view = CONFIG5_CAMERA if depth == 5 else CAMERA
    cam = Camera.look_at(*view[:2], fov=view[2])

    with tempfile.TemporaryDirectory() as tmp:
        for k, trav in enumerate(traversals):
            for name, extra, kw in CONFIG5_FRAMES:
                label = (f"config 5 {name}, {trav}" if depth == 5
                         else f"{wcfg.size}^3 {name}, {trav}")
                try:
                    r = Renderer(wcfg, RenderConfig(**{
                        **knobs, **extra, "traversal": trav}), device=dev,
                        scene=scene, **kw)
                except NotImplementedError as e:
                    print(f"frame ({label}): not rendered by this package "
                          f"({e})")
                    continue
                rays = camera_rays(cam, knobs["width"], knobs["height"], dev)
                grid = getattr(r, "grid", None) or scene.jumpgrid
                if name == "lights":
                    place_lights(scene, grid, rays, trace)
                host_frames(r, cam, 3, True)
                synced = host_frames(r, cam, FRAMES, True)
                piped = host_frames(r, cam, FRAMES, False)[0]
                print(f"frame ({label}), synchronized: median "
                      f"{statistics.median(synced):.4f} ms, mean "
                      f"{statistics.fmean(synced):.4f} ms over {FRAMES}")
                print(f"frame ({label}), back to back: {piped:.4f} ms per "
                      f"frame over {FRAMES}")
                if name == "lights":
                    place_lights(scene, grid, rays, trace)
                window(label, r, cam, pathlib.Path(tmp) / f"c5_{k}.json")
    print(f"{world} peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
