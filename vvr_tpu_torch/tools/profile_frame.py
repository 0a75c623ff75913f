"""Where the time of the slice frame goes, on one NVIDIA GPU.

    python3 vvr_tpu_torch/tools/profile_frame.py [--trace PATH] [--root DIR]

Renders the frames that chip_smoke.py drives (256^3 world, 1920x1080, one
hard shadow ray per lit pixel, the bench camera, a fixed time so no sky
rebuild falls in a window): the default-knob frame (face rasterizer and
sun classifier) and the DDA frame (`primary_raster="off", sun_mask="off"`),
over one scene, and prints, each from this run:

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
   K12 and K2 shade_surface one each), K1's per call of the DDA frame (its
   launches alternate: primary rays, then shadow rays), and the
   device busy share of that window = the union of device intervals
   (kernels, copies, sets) over the span from the first to the last event
   of the trace, both on the trace's clock. The profiler's own overhead
   stretches the window on the host, so this share is most likely below
   the unprofiled one;
5. the work counters at this camera (K9's fragments in its tight boxes
   and in the JAX boxes, its binned (face, tile) pairs and big faces).

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
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
FRAMES = 50      # per host-clock window
PROFILED = 20    # frames in the profiled window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The __global__ functions of csrc/, to tell the port's kernels from the
# torch ops (ray generation, the sun expand, the host-to-device copies).
PORT_KERNELS = ("vvr_jump_trace_kernel", "vvr_shade_surface_kernel",
                "vvr_shade_pixel_kernel", "skybox_kernel", "clouds_kernel",
                "vvr_bloom_pyramid_kernel", "composite_kernel",
                "vvr_raster_", "vvr_scan_", "vvr_sun_",
                "vvr_masked_shadow_kernel")
# the device kernels of one C entry point, by name part: K9 launches
# project, scan, bin and tile kernels (and a memset), the others one each
ENTRY_KERNELS = {
    "K1 jump_trace": ("vvr_jump_trace_kernel",),
    "K9 raster_fragments": ("vvr_raster_project", "vvr_scan_",
                            "vvr_raster_bin", "vvr_raster_tile"),
    "K4 bloom_pyramid": ("vvr_bloom_pyramid_kernel",),
    "K4 composite": ("composite_kernel",),
    "K12 masked_shadow": ("vvr_masked_shadow_kernel",),
    "K2 shade_surface": ("vvr_shade_surface_kernel",),
}


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
    k1 = sorted((e["ts"], e["dur"]) for e in dev_ev
                if "vvr_jump_trace_kernel" in e["name"])
    if k1 and len(k1) == 2 * n:
        primary, shadow = (sum(u for _, u in k1[k::2]) / n for k in (0, 1))
        print(f"  K1 per call: primary rays {primary:.2f} us/frame, shadow "
              f"rays {shadow:.2f} us/frame")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the default frame's chrome trace here")
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose vvr_tpu_torch is measured")
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
    cfg = RenderConfig(**knobs)
    wcfg = WorldConfig(depth=4)
    renderer = Renderer(wcfg, cfg, device=dev, force_regenerate=True,
                        cache_path=root / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    dda = Renderer(wcfg, RenderConfig(**knobs, primary_raster="off",
                                      sun_mask="off"),
                   device=dev, scene=renderer.scene)
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    grid = renderer.scene.jumpgrid
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
    for r, label in ((renderer, "default knobs"), (dda, "DDA")):
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
    phases(("ray generation (plain torch)", "K9 raster fragments",
            "K10 raster resolve", "K12 masked shadow (from the hits)",
            "K2 shade_pixel", "K4 bloom pyramid", "K4 composite"),
           (rays, fragments, resolve, classifier, pixel, bloom, composite))
    print("phases (DDA):")
    phases(("ray generation (plain torch)", "K1 primary trace",
            "K2 shade_surface", "K1 shadow trace",
            "K2 shade_pixel", "K4 bloom pyramid", "K4 composite"),
           (rays, primary, surface, shadow, pixel, bloom, composite))

    # ---- 4. one profiled window per frame kind
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or pathlib.Path(tmp) / "frame_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        window("default knobs", renderer, cam, path)
        window("DDA", dda, cam, pathlib.Path(tmp) / "dda_trace.json")

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
