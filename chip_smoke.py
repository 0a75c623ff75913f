#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the port's CUDA
   kernels from vvr_tpu_torch/csrc (timed);
2. builds the 256^3 world on the card (timed, from cold);
3. renders frames of the main-path configuration (1920x1080, one hard
   shadow ray per lit pixel, sky textures cached per 0.25 s bucket, bloom,
   ACES) through `Renderer.render`, with every launch counter reset just
   before and read just after, and fails if a kernel of the path was not
   launched;
4. holds each kernel against its plain torch version on the card at the
   main path's shapes (and the trace against the numpy oracle on a
   65,536-ray subset), and the kernel frame against the plain-torch frame;
5. times each kernel beside its plain version (CUDA events) and computes
   its bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the peak for their type;
6. drives the gather microbenchmark's path (vvr_tpu_torch.tools.
   microbench_gather: every experiment of the two reference tools at
   N = 2^21 lanes) with the launch counters reset just before and read
   just after, and fails unless each of K5-K8 was launched; the tool holds
   every kernel against its plain version bit for bit before timing it.

The frame check (3) covers the frame's kernels (K1-K4), the gather check
(6) the gather's (K5-K8). Any failed check raises and the script exits
non-zero. Without a CUDA device it exits non-zero before printing any
result. Before the last line it prints {"kernels": [...]}, one row per
kernel with its launches, error against its plain version, times and
bound; the last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

FRAMES = 24          # at t = i/60 s: spans two 0.25 s sky buckets
ORACLE_RAYS = 65536
CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
# Operations per item of the frame's kernels (per trace sub-step, pixel or
# texel), counted by hand from csrc/ and rounded; only the sky passes are
# bound by them.
OPS_PER_ITEM = {"jump_trace": 30, "shade_surface": 40, "shade_pixel": 250,
                "write_skybox": 450, "write_clouds": 750,
                "bloom_downsample": 220, "bloom_upsample": 40,
                "composite": 60}
# the gather experiment whose times stand in each kernel's row (the first
# line of that name: pallas_onehot:R4096xC2 is the u32 one)
GATHER_ROW = {"gather_chain": "pallas_take:R32768xC16",
              "gather_chain_shared": "pallas_vreg:R1024",
              "gather_onehot": "pallas_onehot:R4096xC2",
              "gather_rows": "pallas_scalar:R266305xC2"}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 1
    repo = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import numpy as np

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import jump, post, shade, sky
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.tools import microbench_gather
    from vvr_tpu_torch.tools.microbench_gather import bound_ms, cuda_ms
    from vvr_tpu_torch.utils.camera import Camera
    from vvr_tpu_torch.world.generator import assemble_dense

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} | nvidia-smi: {smi}")

    # ---- 1. build
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")

    # ---- 2. the 256^3 scene, from cold
    wcfg = WorldConfig(depth=4)
    cfg = RenderConfig(width=1920, height=1080, shadow_samples=1,
                       max_ray_iterations=3, primary_raster="off",
                       sun_mask="off")
    t0 = time.perf_counter()
    renderer = Renderer(wcfg, cfg, device=dev, force_regenerate=True,
                        cache_path=repo / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.2f} s (world generation, "
          f"jump grid {tuple(renderer.scene.jumpgrid.rows.shape)})")
    grid = renderer.scene.jumpgrid
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])

    # ---- 3. the main path through Renderer.render
    renderer.render(cam, time=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    frame_ms = []
    img = None
    for i in range(FRAMES):
        t0 = time.perf_counter()
        img = renderer.render(cam, time=i / 60.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    frame_kernels = [k for k, v in kernels.KERNELS.items()
                     if v.path == "frame"]
    missing = [k for k in frame_kernels if launches[k] == 0]
    check(not missing, f"kernels not launched by the main path: {missing}")
    check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
          f"frame shape {tuple(img.shape)} {img.dtype}")
    check(float(img.float().std()) > 10, "frame is nearly constant")
    med = sorted(frame_ms)[FRAMES // 2]
    print(f"frames: {FRAMES} at {cfg.width}x{cfg.height}, median "
          f"{med:.3f} ms, mean {sum(frame_ms) / FRAMES:.3f} ms, min "
          f"{min(frame_ms):.3f} ms, "
          f"max {max(frame_ms):.3f} ms (host clock, synchronized)")
    print(f"Mrays/s: {renderer.rays_per_frame / (med * 1e-3) / 1e6:.3f} "
          f"({renderer.rays_per_frame} rays/frame at the median)")
    print(f"peak device memory: {peak_mb:.1f} MiB "
          f"(max_memory_allocated over the frames)")
    print(f"launches in the main path: "
          f"{ {k: launches[k] for k in frame_kernels} }")

    # ---- 4. each kernel against its plain version, main-path shapes
    sun3 = torch.from_numpy(renderer.sun[:3].copy())
    sun_d = sun3.to(dev)
    max_steps = cfg.traversal_max_steps * 8
    o, d = camera_rays(cam, cfg.width, cfg.height, dev)
    n = o.shape[0]
    fields = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
              "missed_pops")
    errs = {}

    def same_trace(a, b, what):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            check(bool((x == y).all()),
                  f"{what}: {f} differs on {int((x != y).sum())} rays")
        return float((a.t - b.t).abs().max())

    res_k = jump.trace_jump(grid, o, d, max_steps)
    res_p = jump.trace_jump_plain(grid, o, d, max_steps)
    errs["jump_trace"] = same_trace(res_k, res_p, "K1 primary")
    sel = np.sort(np.random.default_rng(0).choice(n, ORACLE_RAYS,
                                                  replace=False))
    occ = assemble_dense(renderer.scene.chunks, wcfg.size)
    ref = trace_dense(occ, o.cpu().numpy()[sel], d.cpu().numpy()[sel])
    sub = {f: getattr(res_k, f).cpu().numpy()[sel]
           for f in ("hit", "face", "axis_coord", "t")}
    hm = ref["hit"]
    check((sub["hit"] == ref["hit"]).all(), "K1 vs oracle: hit")
    for f in ("face", "axis_coord", "t"):
        check((sub[f][hm] == ref[f][hm]).all(), f"K1 vs oracle: {f}")
    print(f"K1 primary: {n} rays bit-exact vs plain (all 7 outputs); "
          f"{ORACLE_RAYS} rays bit-exact vs the numpy oracle "
          f"({int(hm.sum())} hits)")

    so_k, sa_k = shade.shade_surface(o, d, res_k.hit, res_k.face,
                                     res_k.axis_coord, sun3)
    so_p, sa_p = shade.shade_surface_plain(o, d, res_k.hit, res_k.face,
                                           res_k.axis_coord, sun3)
    check(bool((sa_k == sa_p).all()), "K2 surface: shadow mask differs")
    check(torch.allclose(so_k, so_p, rtol=1e-4, atol=1e-4),
          "K2 surface: shadow origins differ")
    errs["shade_surface"] = float((so_k - so_p).abs().max())
    s_d = sun_d.expand(n, 3).contiguous()
    sh_k = jump.trace_jump(grid, so_k, s_d, max_steps, active=sa_k)
    sh_p = jump.trace_jump_plain(grid, so_k, s_d, max_steps, active=sa_k)
    same_trace(sh_k, sh_p, "K1 shadow")
    print(f"K1 shadow: {int(sa_k.sum())} active of {n} rays bit-exact vs "
          f"plain")

    sb_k = sky.write_skybox(sun3, 0.0, cfg.skybox_resolution, dev)
    sb_p = sky.write_skybox_plain(sun_d, cfg.skybox_resolution)
    cl_k = sky.write_clouds(sun3, 0.25, cfg.clouds_resolution, dev)
    cl_p = sky.write_clouds_plain(sun_d, 0.25, cfg.clouds_resolution)
    check(torch.allclose(sb_k, sb_p, rtol=1e-4, atol=1e-5),
          "K3 skybox differs beyond rtol 1e-4, atol 1e-5")
    check(torch.allclose(cl_k, cl_p, rtol=1e-4, atol=1e-5),
          "K3 clouds differ beyond rtol 1e-4, atol 1e-5")
    errs["write_skybox"] = float((sb_k - sb_p).abs().max())
    errs["write_clouds"] = float((cl_k - cl_p).abs().max())

    sun_col = sky.sun_colour_final(sun3)
    args = (o, d, res_k.hit, res_k.face, res_k.axis_coord, sh_k.hit,
            wcfg.size, sb_k, cl_k, sun3, sun_col, cfg.height, cfg.width)
    hdr_k = shade.shade_pixel(*args)
    hdr_p = shade.shade_pixel_plain(*args)
    check(bool((hdr_k[3] == hdr_p[3]).all()), "K2 shade: alpha differs")
    close = torch.isclose(hdr_k[:3], hdr_p[:3], rtol=1e-4,
                          atol=1e-4).all(0)
    check(float(close.float().mean()) >= 0.999,
          f"K2 shade: only {float(close.float().mean()):.5f} of pixels "
          "within rtol=atol=1e-4")
    errs["shade_pixel"] = float((hdr_k - hdr_p).abs().max())

    h, w = cfg.height, cfg.width
    nm = post.bloom_mip_count(w, h)
    sizes = [(max(h >> m, 1), max(w >> m, 1)) for m in range(nm)]
    mips = [hdr_k]
    errs["bloom_downsample"] = 0.0
    for m in range(1, nm):
        a = post.bloom_downsample(mips[-1], *sizes[m])
        b = post.bloom_downsample_plain(mips[-1], *sizes[m])
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
              f"K4 downsample mip {m} differs beyond 1e-5")
        errs["bloom_downsample"] = max(errs["bloom_downsample"],
                                       float((a - b).abs().max()))
        mips.append(a)
    errs["bloom_upsample"] = 0.0
    for m in range(nm - 2, 1, -1):
        a = post.bloom_upsample(mips[m + 1], *sizes[m])
        b = post.bloom_upsample_plain(mips[m + 1], *sizes[m])
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
              f"K4 upsample mip {m} differs beyond 1e-5")
        errs["bloom_upsample"] = max(errs["bloom_upsample"],
                                     float((a - b).abs().max()))
        mips[m] = a
    img_k = post.composite_p(hdr_k, mips[2], h, w)
    img_p = post.composite_p_plain(hdr_k, mips[2], h, w)
    u8 = (img_k.int() - img_p.int()).abs()
    check(int(u8.max()) <= 1, f"K4 composite: u8 differs by {int(u8.max())}")
    errs["composite"] = float(u8.max())
    print(f"kernel vs plain on the card: {errs}")

    # ---- the kernel frame against the plain-torch frame
    t = 0.25
    img_kf, hdr_kf = render_frame(grid, o, d, renderer.sun, t, cfg)
    pr = jump.trace_jump_plain(grid, o, d, max_steps)
    ps_o, ps_a = shade.shade_surface_plain(o, d, pr.hit, pr.face,
                                           pr.axis_coord, sun3)
    psh = jump.trace_jump_plain(grid, ps_o, s_d, max_steps, active=ps_a)
    phdr = shade.shade_pixel_plain(
        o, d, pr.hit, pr.face, pr.axis_coord, psh.hit, wcfg.size,
        sky.write_skybox_plain(sun_d, cfg.skybox_resolution),
        sky.write_clouds_plain(sun_d, t, cfg.clouds_resolution), sun3,
        sun_col, h, w)
    pm = [phdr]
    for m in range(1, nm):
        pm.append(post.bloom_downsample_plain(pm[-1], *sizes[m]))
    for m in range(nm - 2, 1, -1):
        pm[m] = post.bloom_upsample_plain(pm[m + 1], *sizes[m])
    img_pf = post.composite_p_plain(phdr, pm[2], h, w)
    check(bool(torch.isfinite(hdr_kf).all()), "kernel frame HDR not finite")
    alpha = hdr_kf[..., 3]
    check(bool((alpha == 10).any() and (alpha == 0).any()),
          "frame lacks sky or terrain")
    off = float(((img_kf.int() - img_pf.int()).abs() > 2).any(-1)
                .float().mean())
    check(off <= 0.005, f"kernel frame vs plain frame: {off:.5f} of pixels "
          "off by more than 2")
    print(f"frame: kernel path vs plain path, {off:.6f} of pixels off by "
          f"more than 2 u8 levels (bar 0.005)")

    # ---- 5. times, kernel beside plain, main-path shapes
    def down_chain(fn):
        return lambda: [fn(mips[m - 1], *sizes[m]) for m in range(1, nm)]

    def up_chain(fn):
        return lambda: [fn(mips[m + 1], *sizes[m])
                        for m in range(nm - 2, 1, -1)]

    timed = {
        "jump_trace": (lambda: jump.trace_jump(grid, o, d, max_steps),
                       lambda: jump.trace_jump_plain(grid, o, d, max_steps),
                       10, 1),
        "shade_surface": (
            lambda: shade.shade_surface(o, d, res_k.hit, res_k.face,
                                        res_k.axis_coord, sun3),
            lambda: shade.shade_surface_plain(o, d, res_k.hit, res_k.face,
                                              res_k.axis_coord, sun3),
            50, 5),
        "shade_pixel": (lambda: shade.shade_pixel(*args),
                        lambda: shade.shade_pixel_plain(*args), 50, 5),
        "write_skybox": (
            lambda: sky.write_skybox(sun3, 0.0, cfg.skybox_resolution, dev),
            lambda: sky.write_skybox_plain(sun_d, cfg.skybox_resolution),
            20, 3),
        "write_clouds": (
            lambda: sky.write_clouds(sun3, 0.25, cfg.clouds_resolution, dev),
            lambda: sky.write_clouds_plain(sun_d, 0.25,
                                           cfg.clouds_resolution),
            20, 3),
        "bloom_downsample": (down_chain(post.bloom_downsample),
                             down_chain(post.bloom_downsample_plain), 50, 5),
        "bloom_upsample": (up_chain(post.bloom_upsample),
                           up_chain(post.bloom_upsample_plain), 50, 5),
        "composite": (lambda: post.composite_p(hdr_k, mips[2], h, w),
                      lambda: post.composite_p_plain(hdr_k, mips[2], h, w),
                      50, 5),
    }
    def nbytes(*ts):
        return float(sum(t.nbytes for t in ts))

    def mip_bytes(pairs):
        return 16.0 * sum(sizes[a][0] * sizes[a][1] + sizes[b][0] * sizes[b][1]
                          for a, b in pairs)

    down = [(m - 1, m) for m in range(1, nm)]
    up = [(m + 1, m) for m in range(nm - 2, 1, -1)]
    items = {  # (bytes moved, items for OPS_PER_ITEM) at this run's shapes
        "jump_trace": (nbytes(o, d, grid.rows,
                              *(getattr(res_k, f) for f in fields)),
                       float(res_k.iterations.sum())),
        "shade_surface": (nbytes(o, d, res_k.hit, res_k.face,
                                 res_k.axis_coord, so_k, sa_k), n),
        "shade_pixel": (nbytes(o, d, res_k.hit, res_k.face, res_k.axis_coord,
                               sh_k.hit, sb_k, cl_k, hdr_k), n),
        "write_skybox": (nbytes(sb_k), sb_k.numel() / 3),
        "write_clouds": (nbytes(cl_k), cl_k.numel() / 4),
        "bloom_downsample": (mip_bytes(down),
                             sum(sizes[b][0] * sizes[b][1] for _, b in down)),
        "bloom_upsample": (mip_bytes(up),
                           sum(sizes[b][0] * sizes[b][1] for _, b in up)),
        "composite": (nbytes(hdr_k, mips[2], img_k), h * w),
    }
    rows = []
    for name, (kfn, pfn, kreps, preps) in timed.items():
        ms = cuda_ms(kfn, kreps)
        plain_ms = cuda_ms(pfn, preps)
        moved, count = items[name]
        b_ms, b_by = bound_ms(moved, OPS_PER_ITEM[name] * count, "fp32")
        k = kernels.KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"time {name}: kernel {ms:.4f} ms, plain torch "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    shadow_ms = cuda_ms(lambda: jump.trace_jump(
        grid, so_k, s_d, max_steps, active=sa_k), 10)
    shadow_plain = cuda_ms(lambda: jump.trace_jump_plain(
        grid, so_k, s_d, max_steps, active=sa_k), 1)
    print(f"time jump_trace (shadow rays): kernel {shadow_ms:.4f} ms, "
          f"plain torch {shadow_plain:.4f} ms")

    # ---- 6. the gather microbenchmark's path, through its entry point
    gather_kernels = [k for k, v in kernels.KERNELS.items()
                      if v.path == "gather"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    lines = microbench_gather.run_all(0, dev)
    g_launches = dict(kernels.LAUNCHES)
    missing = [k for k in gather_kernels if g_launches[k] == 0]
    check(not missing, f"kernels not launched by the gather path: {missing}")
    check(len(lines) == len(microbench_gather.EXPERIMENTS),
          "gather experiments missing")
    print(f"gather: {len(lines)} experiments at {microbench_gather.N} lanes "
          f"in {time.perf_counter() - t0:.2f} s, each kernel bit-exact vs "
          f"its plain version; launches "
          f"{ {k: g_launches[k] for k in gather_kernels} }")
    by_name = {}
    for line in lines:
        by_name.setdefault(line["name"], line)
    for name in gather_kernels:
        line = by_name[GATHER_ROW[name]]
        check(line["kernel"] == name, f"{GATHER_ROW[name]} ran {line}")
        k = kernels.KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": g_launches[name],
                     "max_abs_err": 0.0, "ms": line["ms"],
                     "plain_ms": line["plain_ms"],
                     "bound_ms": line["bound_ms"],
                     "bound_by": line["bound_by"],
                     "library_ms": line["library_ms"]})

    print(json.dumps({"kernels": rows}))
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
