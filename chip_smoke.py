#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the port's CUDA
   kernels from vvr_tpu_torch/csrc (timed);
2. the main path: with every launch counter reset, builds the 256^3 world
   on the card from cold (timed) and renders frames of bench.py's
   default-knob configuration (1920x1080, face rasterizer for primary
   visibility, one hard shadow ray per lit pixel answered by the sun
   classifier, sky textures cached per 0.25 s bucket, bloom, ACES) through
   `Renderer.render`; reads the counters and fails unless each kernel of
   that path (K2 shade_pixel, K3, K4, K9, K10, K11, K12; K12 computes the
   shadow rays' starts, so K2 shade_surface and K1 must not run) was
   launched, and each per-frame kernel once in every frame; prints the
   port's kernel launches per frame;
3. the DDA frame (`primary_raster="off", sun_mask="off"`: K1 for primary
   and shadow rays, K2 shade_surface for their starts) over the same
   scene, counters reset before it and read after, checked and printed the
   same way, its median printed beside the default frame's; fails unless
   each of its K1 launches traced by 8x4 tiles without the counters, the
   shadow trace with the one sun direction (no (N, 3) copy);
4. holds each kernel against its plain torch version on the card at the
   main path's shapes; K1 with and without its counters, flat and by 8x4
   tiles, on the primary and the shadow rays (one sun direction, and the
   direction per ray) at 1920x1080 and at 33x67; prints the registers and
   spills of K1 and K12 (`-Xptxas -v`); the raster (K9+K10) against K1's
   primary trace on every ray, with each ray where they differ traced by
   the numpy oracle
   (the raster must be the oracle's), and both against the oracle on a
   65,536-ray subset; K12 on the raster hits against its plain version,
   against K12 on K2's starts, against an every-lane K1 shadow trace and
   its mask against K2's, and prints the lanes each of its tests answers;
   the bloom pyramid's mip 2 against the plain pass-by-pass chain, at the
   main path's shape and at small odd shapes; the composite with bloom,
   without it and at an integer upscale of 2; the default frame against
   the DDA frame, and the kernel frame against the plain-torch frame;
5. times each kernel beside its plain version (CUDA events) and computes
   its bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the peak for their type;
6. drives the gather microbenchmark's path (vvr_tpu_torch.tools.
   microbench_gather: every experiment of the two reference tools at
   N = 2^21 lanes) with the launch counters reset just before and read
   just after, and fails unless each of K5-K8 was launched; the tool holds
   every kernel against its plain version bit for bit before timing it.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result. Before the last line
it prints {"kernels": [...]}, one row per kernel with its launches (from
the path that runs it), error against its plain version, times and bound;
the last line of stdout is {"ok": true, "device": {...}}.
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
# Operations per item of the frame's kernels (per trace sub-step, pixel,
# texel, K9 fragment, (face, texel) pair or shadow lane), counted by hand
# from csrc/ and rounded; K12 adds shade_surface's per pixel (it computes
# the starts) and jump_trace's per sub-step of its residue. The composite's
# 190 per pixel are three channels of the bloom's interpolation (7),
# strength (2), ACES (7 and an IEEE division, about 10), powf (about 30:
# log2 and exp2 in extended precision) and the clamp and quantization (6).
OPS_PER_ITEM = {"jump_trace": 30, "shade_surface": 40, "shade_pixel": 250,
                "write_skybox": 450, "write_clouds": 750,
                "bloom_pyramid": 220, "composite": 190,
                "raster_fragments": 70,
                "raster_resolve": 45, "sun_grids": 90, "masked_shadow": 60}
# the bloom pyramid's items are its downsampled texels (220 operations
# each) and its upsampled ones, at this many operations
BLOOM_UP_OPS = 40
# K1's primary rays that differ from the numpy oracle (JAX trace_jump
# gives the same answer: its jump and subcell steps place the cell by a
# floor, which can take an exact x/z crossing tie the other way); more than
# this many fails the run
K1_ORACLE_SLACK = 16
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
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sunshadow as ss
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

    # ---- 2. the main path: scene from cold, then frames, counters reset
    # before the Renderer is built (K11 runs once, in the first frame)
    wcfg = WorldConfig(depth=4)
    cfg = RenderConfig(width=1920, height=1080, shadow_samples=1,
                       max_ray_iterations=3)
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    renderer = Renderer(wcfg, cfg, device=dev, force_regenerate=True,
                        cache_path=repo / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    torch.cuda.synchronize()
    faces = renderer.scene.faces
    print(f"setup: {time.perf_counter() - t0:.2f} s (world generation, "
          f"jump grid {tuple(renderer.scene.jumpgrid.rows.shape)}, "
          f"{faces[0].shape[0]} merged faces)")
    check(renderer.use_raster and renderer.use_sunmask,
          "the default knobs must resolve to the rasterizer and classifier")
    grid = renderer.scene.jumpgrid

    def frames(r, label):
        r.render(cam, time=0.0)
        torch.cuda.synchronize()
        ms = []
        img = None
        for i in range(FRAMES):
            t0 = time.perf_counter()
            img = r.render(cam, time=i / 60.0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        med = sorted(ms)[FRAMES // 2]
        check(tuple(img.shape) == (1080, 1920, 3)
              and img.dtype == torch.uint8,
              f"{label} frame shape {tuple(img.shape)} {img.dtype}")
        check(float(img.float().std()) > 10, f"{label} frame is nearly "
              "constant")
        print(f"frames ({label}): {FRAMES} at {cfg.width}x{cfg.height}, "
              f"median {med:.3f} ms, mean {sum(ms) / FRAMES:.3f} ms, min "
              f"{min(ms):.3f} ms, max {max(ms):.3f} ms (host clock, "
              f"synchronized)")
        print(f"Mrays/s ({label}): "
              f"{r.rays_per_frame / (med * 1e-3) / 1e6:.3f} "
              f"({r.rays_per_frame} rays/frame at the median)")
        return med

    # the kernels of each frame, and those launched once in every frame (K3
    # only per sky bucket, K11 per sun); K12 computes the shadow rays'
    # starts itself, so K2 shade_surface runs only in the DDA frame
    frame_kernels = ["shade_pixel", "write_skybox", "write_clouds",
                     "bloom_pyramid", "composite", "raster_fragments",
                     "raster_resolve", "sun_grids", "masked_shadow"]
    per_frame = ["shade_pixel", "bloom_pyramid", "composite",
                 "raster_fragments", "raster_resolve", "masked_shadow"]
    dda_kernels = ["jump_trace", "shade_surface", "shade_pixel",
                   "bloom_pyramid", "composite"]
    dda_per_frame = ["shade_surface", "shade_pixel", "bloom_pyramid",
                     "composite"]
    n_frames = FRAMES + 1  # with the warm-up frame

    def frame_launches(label, kinds, every):
        got = dict(kernels.LAUNCHES)
        missing = [k for k in kinds if got[k] == 0]
        check(not missing, f"kernels not launched by the {label} frame: "
              f"{missing}")
        uneven = {k: got[k] for k in every if got[k] != n_frames}
        check(not uneven, f"{label} frame: per-frame kernels not launched "
              f"once in each of the {n_frames} frames: {uneven}")
        print(f"launches in the {label} frame ({n_frames} frames): "
              f"{ {k: v for k, v in got.items() if v} }")
        print(f"kernel launches per {label} frame: "
              f"{sum(got.values()) / n_frames:.2f} through kernels.launch")
        return got

    med = frames(renderer, "default knobs")
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    launches = frame_launches("default-knob", frame_kernels, per_frame)
    check(launches["shade_surface"] == 0 and launches["jump_trace"] == 0,
          "the default-knob frame launched K1 or K2 shade_surface")
    print(f"peak device memory: {peak_mb:.1f} MiB "
          f"(max_memory_allocated over setup and frames)")
    print(f"({len(per_frame)} per-frame kernels, plus K3 per sky bucket and "
          f"K11 per sun)")

    # ---- 3. the DDA frame over the same scene
    dda = Renderer(wcfg, RenderConfig(width=1920, height=1080,
                                      shadow_samples=1, max_ray_iterations=3,
                                      primary_raster="off", sun_mask="off"),
                   device=dev, scene=renderer.scene)
    # K1's launch arguments in these frames, read where the wrapper hands
    # them to kernels.launch: (direction stride, image width, counters)
    k1_args = []
    launch = kernels.launch

    def recorded(name, device, *args):
        if name == "jump_trace":
            k1_args.append((args[4], args[7], args[13] != 0))
        launch(name, device, *args)

    kernels.launch = recorded
    kernels.reset_launches()
    try:
        med_dda = frames(dda, "DDA")
    finally:
        kernels.launch = launch
    dda_launches = frame_launches("DDA", dda_kernels, dda_per_frame)
    check(dda_launches["jump_trace"] == 2 * n_frames,
          "the DDA frame did not launch K1 twice a frame")
    want = [(3, cfg.width, False), (0, cfg.width, False)] * n_frames
    check(k1_args == want, f"the DDA frame's K1 launches (direction stride, "
          f"width, counters) {sorted(set(k1_args))}, expected {want[:2]}")
    print(f"K1 in the DDA frame: {len(k1_args)} launches, each by 8x4 tiles "
          f"without counters; the shadow trace with one sun direction "
          f"(stride 0), no (N, 3) copy")
    for k in ("jump_trace", "shade_surface"):
        launches[k] = dda_launches[k]
    print(f"frame median: default knobs {med:.3f} ms, DDA {med_dda:.3f} ms "
          f"(same call, same card)")

    # ---- 4. each kernel against its plain version, main-path shapes
    sun3 = torch.from_numpy(renderer.sun[:3].copy())
    sun_np = renderer.sun[:3].copy()
    sun_d = sun3.to(dev)
    max_steps = cfg.traversal_max_steps * 8
    o, d = camera_rays(cam, cfg.width, cfg.height, dev)
    n = o.shape[0]
    fields = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
              "missed_pops")
    errs = {}

    def same_trace(a, b, what, names=fields):
        for f in names:
            x, y = getattr(a, f), getattr(b, f)
            check(bool((x == y).all()),
                  f"{what}: {f} differs on {int((x != y).sum())} rays")
        return float((a.t - b.t).abs().max())

    def k1_forms(o_, d_, width, what, active=None):
        """K1 flat and tiled, with and without counters, against the plain
        version; returns the flat trace with counters and the plain one."""
        ref_ = jump.trace_jump_plain(grid, o_, d_, max_steps, active=active)
        out = None
        for w_ in (None, width):
            for st in (True, False):
                got = jump.trace_jump(grid, o_, d_, max_steps, active=active,
                                      width=w_, stats=st)
                same_trace(got, ref_, f"{what} (width {w_}, counters {st})",
                           fields if st else fields[:4])
                check(st or got.iterations is None,
                      f"{what}: counters written without stats")
                out = got if (w_, st) == (None, True) else out
        return out, ref_

    res_k, res_p = k1_forms(o, d, cfg.width, "K1 primary")
    errs["jump_trace"] = same_trace(res_k, res_p, "K1 primary")
    occ = assemble_dense(renderer.scene.chunks, wcfg.size)
    sel = np.sort(np.random.default_rng(0).choice(n, ORACLE_RAYS,
                                                  replace=False))
    ref = trace_dense(occ, o.cpu().numpy()[sel], d.cpu().numpy()[sel])
    hm = ref["hit"]

    def oracle_check(res, what):
        sub = {f: getattr(res, f).cpu().numpy()[sel]
               for f in ("hit", "face", "axis_coord", "t")}
        bad = sub["hit"] != hm
        for f in ("face", "axis_coord", "t"):
            bad |= hm & (sub[f] != ref[f])
        return int(bad.sum())

    k1_off = oracle_check(res_k, "K1")
    check(k1_off <= K1_ORACLE_SLACK, f"K1 vs oracle: {k1_off} rays differ")
    print(f"K1 primary: {n} rays bit-exact vs plain (all 7 outputs); "
          f"{ORACLE_RAYS - k1_off} of {ORACLE_RAYS} rays bit-exact vs the "
          f"numpy oracle ({int(hm.sum())} hits)")

    # K9 + K10, the rasterizer, against its plain version, K1 and the oracle
    rcam = rt.raster_camera(cam)
    probe = renderer.scene.solid_at_host(cam.position)
    keys_k = rt.raster_fragments(faces, rcam, d, cfg.width, cfg.height)
    keys_p = rt.raster_fragments_plain(faces, rcam, d, cfg.width, cfg.height)
    check(torch.equal(keys_k, keys_p),
          f"K9 vs plain: {int((keys_k != keys_p).sum())} keys differ")
    ras_k = rt.raster_resolve(keys_k, rcam, d, probe, wcfg.size)
    ras_p = rt.raster_resolve_plain(keys_k, rcam, d, probe, wcfg.size)
    errs["raster_fragments"] = 0.0
    errs["raster_resolve"] = same_trace(ras_k, ras_p, "K10 vs plain")
    ras_off = oracle_check(ras_k, "raster")
    check(ras_off == 0, f"K9+K10 vs oracle: {ras_off} of {ORACLE_RAYS} "
          "rays differ")
    differ = ((ras_k.hit != res_k.hit) | (ras_k.axis_coord
                                          != res_k.axis_coord)
              | (ras_k.t != res_k.t) | (res_k.hit & (ras_k.face
                                                      != res_k.face)))
    idx = torch.nonzero(differ)[:, 0].cpu().numpy()
    k1_wrong = np.zeros(0, np.int64)
    if len(idx):
        oi = trace_dense(occ, o.cpu().numpy()[idx], d.cpu().numpy()[idx])
        rh = ras_k.hit.cpu().numpy()[idx]
        ok_r = rh == oi["hit"]
        for f in ("face", "axis_coord", "t"):
            ok_r &= ~oi["hit"] | (getattr(ras_k, f).cpu().numpy()[idx]
                                  == oi[f])
        check(bool(ok_r.all()), f"K9+K10 vs oracle on the rays where they "
              f"differ from K1: raster wrong on {int((~ok_r).sum())} "
              f"rays {idx[~ok_r][:8].tolist()}")
        k1_wrong = idx
    check(len(k1_wrong) <= K1_ORACLE_SLACK,
          f"K9+K10 differ from K1 on {len(k1_wrong)} rays")
    print(f"K9+K10 primary: {n} rays; keys bit-exact vs plain K9, outputs vs "
          f"plain K10; vs K1: hit, face (on hits), axis_coord and t equal on "
          f"{n - len(k1_wrong)} rays; on the {len(k1_wrong)} others "
          f"{k1_wrong[:8].tolist()} the numpy oracle agrees with the raster "
          f"(K1 wrong); {ORACLE_RAYS} rays bit-exact vs the oracle")

    # K11 against its plain version
    e1, e2, s_basis = ss.sun_basis(sun_np)
    grids_k = ss.sun_grids(faces, e1, e2, s_basis, wcfg.size)
    grids_p = ss.sun_grids_plain(faces, e1, e2, s_basis, wcfg.size)
    gk, gp = grids_k[0], grids_p[0]
    check(tuple(grids_k[1:]) == tuple(grids_p[1:]), "K11 grid frame differs")
    check(bool(((gk <= -3e38) == (gp <= -3e38)).all()),
          "K11 vs plain: written texels differ")
    fin = gk > -3e38
    errs["sun_grids"] = float((gk[fin] - gp[fin]).abs().max())
    check(errs["sun_grids"] <= 1e-4,
          f"K11 vs plain: max |diff| {errs['sun_grids']}")
    check(bool((gk[fin] < 0).any()), "no negative depths exercised")
    print(f"K11: {gk.shape[0]} texels, value-equal vs plain: "
          f"{bool((gk == gp).all())}, max |diff| {errs['sun_grids']}; "
          f"written share B {float(fin[:, 0].float().mean()):.4f}, C "
          f"{float(fin[:, 1].float().mean()):.4f}; depths "
          f"{float(gk[fin].min()):.3f}..{float(gk[fin].max()):.3f}")

    # K12 on the raster hits (the main path's entry, which computes the
    # starts itself) against its plain version (K2 surface, then the
    # query), against its entry on K2's starts, and against an every-lane
    # K1 shadow trace
    hits = (o, d, ras_k.hit, ras_k.face, ras_k.axis_coord)
    so_k, sa_k = shade.shade_surface(*hits, sun3)
    ms_k = ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2, grids_k,
                                      max_steps)
    ms_p = ss.masked_shadow_from_hits_plain(grid, *hits, sun_np, e1, e2,
                                            grids_k, max_steps)
    ms_s = ss.masked_shadow_hits(grid, so_k, sun_np, e1, e2, grids_k, sa_k,
                                 max_steps)
    every = jump.trace_jump(grid, so_k, sun_d, max_steps, active=sa_k,
                            width=cfg.width, stats=False).hit
    check(torch.equal(ms_k, ms_p),
          f"K12 vs plain: {int((ms_k != ms_p).sum())} lanes differ")
    check(torch.equal(ms_k, ms_s),
          f"K12 on the hits vs on K2's starts: "
          f"{int((ms_k != ms_s).sum())} lanes differ")
    check(torch.equal(ms_k & sa_k, every & sa_k),
          f"K12 vs every-lane K1: {int(((ms_k != every) & sa_k).sum())} "
          "active lanes differ")
    check(not bool((ms_k & ~sa_k).any()), "K12 hit on an inactive lane")
    # K12's own mask: under a gBC that claims certain shadow on every
    # texel, each active start inside the world is a hit, and no other
    dark = (torch.full_like(grids_k[0], 3e38),) + tuple(grids_k[1:])
    mask_k = ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2, dark,
                                        max_steps)
    inw = ((so_k >= 0) & (so_k < wcfg.size)).all(1)
    check(torch.equal(mask_k, sa_k & inw),
          f"K12's shadow mask differs from K2 shade_surface's on "
          f"{int((mask_k != (sa_k & inw)).sum())} lanes inside the world")
    errs["masked_shadow"] = 0.0
    branch = ss.shadow_branches(grid, so_k, sun_np, e1, e2, grids_k, sa_k)
    counts = torch.bincount(branch, minlength=len(ss.BRANCHES)).tolist()
    residue = branch == ss.BRANCHES.index("residue")
    print(f"K12: {int(sa_k.sum())} active lanes of {n} bit-exact vs plain, "
          f"vs K12 on K2's starts and vs an every-lane K1 shadow trace; its "
          f"mask equals K2 shade_surface's on the {int(inw.sum())} lanes "
          f"starting inside the world")
    print(f"K12 branches (lanes): {dict(zip(ss.BRANCHES, counts))}")

    so_d, sa_d = shade.shade_surface(o, d, res_k.hit, res_k.face,
                                     res_k.axis_coord, sun3)
    so_p, sa_p = shade.shade_surface_plain(o, d, res_k.hit, res_k.face,
                                           res_k.axis_coord, sun3)
    check(bool((sa_d == sa_p).all()), "K2 surface: shadow mask differs")
    check(torch.allclose(so_d, so_p, rtol=1e-4, atol=1e-4),
          "K2 surface: shadow origins differ")
    errs["shade_surface"] = float((so_d - so_p).abs().max())
    s_d = sun_d.expand(n, 3).contiguous()
    sh_k = k1_forms(so_d, sun_d, cfg.width, "K1 shadow", active=sa_d)[0]
    same_trace(jump.trace_jump(grid, so_d, s_d, max_steps, active=sa_d),
               sh_k, "K1 shadow, the direction per ray vs one direction")
    print(f"K1: {n} primary rays and {int(sa_d.sum())} active of {n} shadow "
          f"rays (one sun direction, and the same per ray) bit-exact vs "
          f"plain, flat and by 8x4 tiles, with and without the counters")
    # an odd image size: ragged tiles in both directions
    o_odd, d_odd = camera_rays(cam, 33, 67, dev)
    r_odd = k1_forms(o_odd, d_odd, 33, "K1 primary at 33x67")[0]
    so_odd, sa_odd = shade.shade_surface(o_odd, d_odd, r_odd.hit, r_odd.face,
                                         r_odd.axis_coord, sun3)
    k1_forms(so_odd, sun_d, 33, "K1 shadow at 33x67", active=sa_odd)
    print(f"K1 at 33x67: primary ({int(r_odd.hit.sum())} hits) and shadow "
          f"({int(sa_odd.sum())} active) rays bit-exact vs plain in all four "
          f"forms")
    for part in ("vvr_jump_trace_kernel", "vvr_masked_shadow_kernel"):
        for name, regs, st, ld in kernels.ptxas_usage(part):
            print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")

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
    # the pyramid's mip 2 against the plain chain, at the main path's shape
    # and at odd shapes (a mip side of 1; mips of odd sides)
    bloom_k = post.bloom_pyramid_p(hdr_k)
    bloom_p = post.bloom_pyramid_plain(hdr_k)
    check(bloom_k.shape == bloom_p.shape and torch.allclose(
        bloom_k, bloom_p, rtol=1e-5, atol=1e-5),
        "K4 bloom pyramid differs beyond rtol=atol=1e-5")
    errs["bloom_pyramid"] = float((bloom_k - bloom_p).abs().max())
    gen = torch.Generator(device=dev).manual_seed(0)
    for bh, bw in ((5, 700), (67, 33), (135, 241), (1080, 1917)):
        x = torch.rand((4, bh, bw), generator=gen, device=dev) * 2.0
        a, b = post.bloom_pyramid_p(x), post.bloom_pyramid_plain(x)
        check(a.shape == b.shape and torch.allclose(a, b, rtol=1e-5,
                                                    atol=1e-5),
              f"K4 bloom pyramid at {bh}x{bw} differs beyond 1e-5")
    # the composite within one u8 step of its plain version (torch's pow
    # and CUDA's powf may round a value across a step) with bloom, without
    # it and at an integer upscale of 2
    for label, b2, on, oh, ow in (("bloom", bloom_k, True, h, w),
                                  ("no bloom", torch.zeros_like(bloom_k),
                                   False, h, w),
                                  ("upscale 2", bloom_k, True, 2 * h, 2 * w)):
        img_k = post.composite_p(hdr_k, b2, oh, ow, 0.05, on)
        img_p = post.composite_p_plain(hdr_k, b2, oh, ow, 0.05, on)
        u8 = (img_k.int() - img_p.int()).abs()
        check(tuple(img_k.shape) == (oh, ow, 3) and int(u8.max()) <= 1,
              f"K4 composite ({label}): u8 differs by {int(u8.max())}")
        print(f"K4 composite ({label}, {ow}x{oh}): u8 within {int(u8.max())} "
              f"of plain; {int((u8 > 0).any(-1).sum())} pixels differ")
        if label == "bloom":
            errs["composite"] = float(u8.max())
    # a render width that is not a multiple of 4 (no float4 loads), as is
    # and upscaled
    x = torch.rand((4, 67, 33), generator=gen, device=dev) * 2.0
    bx = post.bloom_pyramid_p(x)
    for oh, ow in ((67, 33), (134, 66)):
        u8 = (post.composite_p(x, bx, oh, ow).int()
              - post.composite_p_plain(x, bx, oh, ow).int()).abs()
        check(int(u8.max()) <= 1, f"K4 composite at {ow}x{oh} from 33x67: "
              f"u8 differs by {int(u8.max())}")
    img_k = post.composite_p(hdr_k, bloom_k, h, w)
    print(f"kernel vs plain on the card: {errs}")

    # ---- the default frame against the DDA frame, same sky
    t = 0.25
    frame_sky = renderer._sky(t)
    raster = (faces, rcam, probe)
    sunmask = (e1, e2, grids_k)
    img_df, hdr_df = render_frame(grid, o, d, renderer.sun, t, cfg,
                                  sky=frame_sky, raster=raster,
                                  sunmask=sunmask)
    img_kf, hdr_kf = render_frame(grid, o, d, renderer.sun, t, dda.cfg,
                                  sky=frame_sky)
    pix = torch.zeros(n, dtype=torch.bool, device=dev)
    pix[torch.from_numpy(k1_wrong).to(dev)] = True
    pix = pix.reshape(h, w)
    hdr_off = (hdr_df != hdr_kf).any(-1)
    check(not bool((hdr_off & ~pix).any()),
          f"default vs DDA frame: HDR differs on "
          f"{int((hdr_off & ~pix).sum())} pixels where the primary "
          "visibility agrees")
    u8_off = int((img_df != img_kf).any(-1).sum())
    if not len(k1_wrong):
        check(u8_off == 0, f"default vs DDA frame: {u8_off} pixels differ")
    print(f"frame: default knobs vs DDA, HDR equal on every pixel but the "
          f"{int(hdr_off.sum())} where K1 misses the oracle; u8 pixels "
          f"that differ: {u8_off} (bloom spreads those pixels)")

    # ---- the kernel frame against the plain-torch frame (DDA knobs)
    pr = jump.trace_jump_plain(grid, o, d, max_steps)
    ps_o, ps_a = shade.shade_surface_plain(o, d, pr.hit, pr.face,
                                           pr.axis_coord, sun3)
    psh = jump.trace_jump_plain(grid, ps_o, sun_d, max_steps, active=ps_a,
                                stats=False)
    phdr = shade.shade_pixel_plain(
        o, d, pr.hit, pr.face, pr.axis_coord, psh.hit, wcfg.size,
        sky.write_skybox_plain(sun_d, cfg.skybox_resolution),
        sky.write_clouds_plain(sun_d, t, cfg.clouds_resolution), sun3,
        sun_col, h, w)
    img_pf = post.composite_p_plain(phdr, post.bloom_pyramid_plain(phdr),
                                    h, w)
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
    timed = {  # K1 as the DDA frame calls it, on the primary rays
        "jump_trace": (lambda: jump.trace_jump(grid, o, d, max_steps,
                                               width=w, stats=False),
                       lambda: jump.trace_jump_plain(grid, o, d, max_steps,
                                                     stats=False),
                       10, 1),
        "shade_surface": (
            lambda: shade.shade_surface(o, d, res_k.hit, res_k.face,
                                        res_k.axis_coord, sun3),
            lambda: shade.shade_surface_plain(o, d, res_k.hit, res_k.face,
                                              res_k.axis_coord, sun3),
            50, 5),
        "raster_fragments": (
            lambda: rt.raster_fragments(faces, rcam, d, w, h),
            lambda: rt.raster_fragments_plain(faces, rcam, d, w, h), 10, 1),
        "raster_resolve": (
            lambda: rt.raster_resolve(keys_k, rcam, d, probe, wcfg.size),
            lambda: rt.raster_resolve_plain(keys_k, rcam, d, probe,
                                            wcfg.size), 20, 3),
        "sun_grids": (
            lambda: ss.sun_grids(faces, e1, e2, s_basis, wcfg.size),
            lambda: ss.sun_grids_plain(faces, e1, e2, s_basis, wcfg.size),
            10, 1),
        "masked_shadow": (
            lambda: ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2,
                                               grids_k, max_steps),
            lambda: ss.masked_shadow_from_hits_plain(
                grid, *hits, sun_np, e1, e2, grids_k, max_steps),
            20, 1),
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
        "bloom_pyramid": (lambda: post.bloom_pyramid_p(hdr_k),
                          lambda: post.bloom_pyramid_plain(hdr_k), 50, 5),
        "composite": (lambda: post.composite_p(hdr_k, bloom_k, h, w),
                      lambda: post.composite_p_plain(hdr_k, bloom_k, h, w),
                      50, 5),
    }
    def nbytes(*ts):
        return float(sum(t.nbytes for t in ts))

    def texels(ms):
        return float(sum(sizes[m][0] * sizes[m][1] for m in ms))

    down_texels = texels(range(1, nm))
    up_texels = texels(range(nm - 2, 1, -1))
    # the data-dependent work: K9's fragments (its tight boxes; beside them
    # the JAX boxes of the plain version), K11's (face, texel) pairs, K12's
    # lanes plus its residue's DDA sub-steps (charged at K1's rate)
    def box_fragments(tight):
        use, imin, imax, jmin, jmax = rt.project_faces(faces, rcam, w, h,
                                                       tight)
        return float(torch.where(use, (imax - imin + 1) * (jmax - jmin + 1),
                                 0).sum())

    fragments, jax_fragments = box_fragments(True), box_fragments(False)
    fs = ss.face_setup(faces, e1, e2, s_basis, *grids_k[1:], ss.GRID)
    pairs = float(torch.where(fs["occl"], (fs["oi1"] - fs["oi0"] + 1)
                              * (fs["oj1"] - fs["oj0"] + 1), 0).sum())
    res_it = jump.trace_jump(grid, so_k, sun_d, max_steps,
                             active=residue).iterations[residue].float()
    res_steps = float(res_it.sum())
    print(f"K12 residue: {int(residue.sum())} lanes, DDA sub-steps sum "
          f"{res_steps:.0f}, mean {float(res_it.mean()):.2f}, max "
          f"{float(res_it.max()):.0f}")
    lanes = float(sa_k.sum())
    items = {  # (bytes moved, items for OPS_PER_ITEM) at this run's shapes
        "raster_fragments": (nbytes(*faces[:7], d, keys_k), fragments),
        "raster_resolve": (nbytes(keys_k, d, ras_k.hit, ras_k.face,
                                  ras_k.axis_coord, ras_k.t), n),
        "sun_grids": (nbytes(*faces[:8], gk), pairs),
        # the starts of every hit (K2 shade_surface's operations), the
        # lit lanes' tests, the residue's DDA sub-steps
        "masked_shadow": (nbytes(*hits, gk, grid.rows, ms_k),
                          lanes + (n * OPS_PER_ITEM["shade_surface"]
                                   + res_steps * OPS_PER_ITEM["jump_trace"])
                          / OPS_PER_ITEM["masked_shadow"]),
        # the frame's outputs (hit, face, axis_coord, t)
        "jump_trace": (nbytes(o, d, grid.rows,
                              *(getattr(res_k, f) for f in fields[:4])),
                       float(res_k.iterations.sum())),
        "shade_surface": (nbytes(o, d, res_k.hit, res_k.face,
                                 res_k.axis_coord, so_k, sa_k), n),
        "shade_pixel": (nbytes(o, d, res_k.hit, res_k.face, res_k.axis_coord,
                               sh_k.hit, sb_k, cl_k, hdr_k), n),
        "write_skybox": (nbytes(sb_k), sb_k.numel() / 3),
        "write_clouds": (nbytes(cl_k), cl_k.numel() / 4),
        # the HDR image read once and mip 2 written once
        "bloom_pyramid": (nbytes(hdr_k, bloom_k),
                          down_texels + up_texels * BLOOM_UP_OPS
                          / OPS_PER_ITEM["bloom_pyramid"]),
        # three of the four channels of the HDR image and of mip 2
        "composite": (nbytes(hdr_k[:3], bloom_k[:3], img_k), h * w),
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
    by_name = {r["name"]: r for r in rows}
    # K1's other forms: with the counters and flat (the call the kernel
    # table timed before the tiled form), and the frame's shadow trace
    # beside the form with counters and a direction per ray
    k1_runs = (
        ("primary, flat, with counters", o, d, None, None, True, res_k),
        ("shadow, frame form (tiled, one direction, no counters)", so_d,
         sun_d, sa_d, w, False, sh_k),
        ("shadow, flat, direction per ray, with counters", so_d, s_d, sa_d,
         None, True, sh_k))
    for label, ro, rd, ra, rw_, st, rr in k1_runs:
        k_ms = cuda_ms(lambda: jump.trace_jump(grid, ro, rd, max_steps,
                                               active=ra, width=rw_,
                                               stats=st), 10)
        outs = [getattr(rr, f) for f in (fields if st else fields[:4])]
        b_ms, b_by = bound_ms(nbytes(ro, rd, grid.rows, *outs),
                              OPS_PER_ITEM["jump_trace"]
                              * float(rr.iterations.sum()), "fp32")
        print(f"time jump_trace ({label}): kernel {k_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    print(f"K12 {by_name['masked_shadow']['ms']:.4f} ms on the lanes of the "
          f"raster hits")
    print(f"time primary visibility: K9+K10 "
          f"{by_name['raster_fragments']['ms'] + by_name['raster_resolve']['ms']:.4f}"
          f" ms vs K1 {by_name['jump_trace']['ms']:.4f} ms; K9 tests "
          f"{fragments:.0f} fragments ({fragments / n:.2f} per pixel; "
          f"{jax_fragments:.0f} in the JAX boxes of its plain version); K11 "
          f"{pairs:.0f} (face, texel) pairs")

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
    by_exp = {}
    for line in lines:
        by_exp.setdefault(line["name"], line)
    for name in gather_kernels:
        line = by_exp[GATHER_ROW[name]]
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
