"""Kernels held to their plain versions and timed, a case a redesign, to
compare two checkouts on one card.

    python3 vvr_tpu_torch/tools/kernel_ab.py [--root DIR] [CASE ...]

With the vvr_tpu_torch package found under DIR (default: this checkout),
builds its kernels and runs each case named (default: all), with this
checkout's timing helpers (tools/profile_frame.py) whatever DIR holds:

- raygen: K13 `camera_rays` on the bench camera at 1920x1080, 33x67, 1x1,
  5x3 and 257x3: one launch a call, the rays bit-exact against the plain
  version run on the CPU. Times at 1920x1080: device us a call back to
  back and with the L2 flushed before each call (L2_FLUSH_BYTES of
  another buffer written between the calls; both `device_us`, REPS calls
  after a warm-up), ms a call (`cuda_ms`, the host path included) and the
  host's us a call (`host_us`).
- texels: K18 through `invalidate_sun_texels` on config 5's brush (the
  123-voxel ball at (511, 314, 272) of the 1024^3 world, the default sun)
  on a seeded 2048^2 gBC, hard and cone (`cone_tan`): gBC bit for bit
  against `texel_rects` and `invalidate_texels_plain`; ms a call of the
  whole call (host path included), its device us, the host's us a call,
  the ms and host us a call of one `index_put_` of the same texels, in
  turns; and the host's us for two calls issued behind QUEUED_SPIN_CYCLES
  of device work still queued (the median of QUEUED_REPS), which shows
  whether a call waits for the launches before it.
- raster: K9 `raster_fragments` (the merged faces) and K22
  `raster_triangles` (the surface-nets mesh, straddlers clipped) at the
  bench view of the 256^3 world, 1920x1080, bit for bit against their
  plain versions; device us a call (the sum of each kernel's mean launch)
  and ms a call.
- pyramid: the brick pyramid's HDDA and every kernel that runs it, at the
  bench view of the 256^3 world, 1920x1080, the pyramid's own cap: K19
  `pyramid_trace` on the primary rays and on K2's shadow starts toward
  the default sun (the frame's tiled, counter-free form; flat with the
  counters against `trace_pyramid_plain`, every output bit for bit, with
  and without the FULL early-out), K12 `masked_shadow_pyramid` on the
  raster hits with the frame's sun grids (bit for bit), K14
  `soft_shadow_pyramid` with the cone gate (four samples: sample hits
  bit for bit, the factor within 1e-5 of the plain factor on the CPU),
  K15 `shade_bounce_pyramid` on the overlap AO frame's bounce 0 (alpha
  bit for bit, rgb within 1e-5) and K23 `shade_raster` on the raster
  view's winners (bit for bit); device us and ms a call of each. Beside
  K19's times: the fetches a ray and the share of them the masks a ray
  holds answer (the `answered` count of the plain walk the check runs
  without FULL), and the lanes busy per warp step (a warp's 8x4 tile:
  its rays' steps over 32 times its longest ray's).
- pyramid1024: K19 on config 5's primary rays at 1024^3 (its camera, the
  pyramid built on the card), bit for bit against the plain walk, timed,
  with the same counts beside.

A later redesign adds a case: a function of the run's `Ctx` that checks
its kernel against the plain version, prints its rows and returns the
names of the checks that failed. To compare two checkouts on one card,
run it in turns in one call (parent, change, change, parent). Prints the
card's name and power limit, then one JSON line per measurement; exits
non-zero without a CUDA device or when a kernel differs from its plain
version.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time
import types

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
# config 5's camera (tools/bench_scale.py:62-97)
CONFIG5_CAMERA = ([512.0, 400.0, 80.0], [512.0, 80.0, 720.0], 85.0)
# a trace's seven outputs (ops/jump.py TraceResult)
TRACE_FIELDS = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
                "missed_pops")
REPS = 50
RAY_SIZES = ((1920, 1080), (33, 67), (1, 1), (5, 3), (257, 3))
BRUSH = (511, 314, 272)        # config 5's brush centre (chip_smoke.py)
BRUSH_WORLD = 1024
QUEUED_SPIN_CYCLES = 2_000_000  # about 1 ms of an H100's clock
QUEUED_REPS = 9
RASTER_REPS = 20
WIDTH, HEIGHT = 1920, 1080
K9_PARTS = ("vvr_raster_project_kernel", "vvr_scan_top_kernel",
            "vvr_bin_kernel", "vvr_raster_tile_kernel")
K22_PARTS = ("vvr_mesh_project_kernel", "vvr_tri_setup_kernel",
             "vvr_tri_scan_kernel", "vvr_bin_kernel", "vvr_tri_tile_kernel")


@dataclasses.dataclass
class Ctx:
    root: pathlib.Path        # the checkout measured
    dev: object               # torch.device of the card
    out: pathlib.Path         # its build directory (traces, worlds)
    pf: types.ModuleType      # this checkout's tools/profile_frame.py

    def row(self, **fields) -> None:
        print(json.dumps({"root": str(self.root), **fields}), flush=True)


def own_profile_frame() -> types.ModuleType:
    """This checkout's tools/profile_frame.py (the timing helpers), loaded
    apart from the package that --root names."""
    name = "_kernel_ab_profile_frame"
    spec = importlib.util.spec_from_file_location(
        name, pathlib.Path(__file__).with_name("profile_frame.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def case_raygen(c: Ctx) -> list:
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.ops import raygen
    from vvr_tpu_torch.utils.camera import Camera
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    bad = []
    for w, h in RAY_SIZES:
        before = kernels.LAUNCHES["generate_rays"]
        ko, kd = raygen.camera_rays(cam, w, h, c.dev)
        po, pd = raygen.camera_rays(cam, w, h, "cpu")
        if kernels.LAUNCHES["generate_rays"] != before + 1 or not (
                torch.equal(ko.cpu(), po) and torch.equal(kd.cpu(), pd)):
            bad.append(f"K13 {w}x{h}")

    def rays():
        raygen.camera_rays(cam, WIDTH, HEIGHT, c.dev)
    trace = c.out / "kernel_ab_trace.json"
    scrap = torch.empty(c.pf.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=c.dev)
    c.row(kernel="generate_rays",
          device_us=c.pf.device_us(rays, ("vvr_generate_rays",), REPS,
                                   trace),
          l2_flushed_us=c.pf.device_us(rays, ("vvr_generate_rays",), REPS,
                                       trace,
                                       before=lambda: scrap.fill_(1.0)),
          ms=c.pf.cuda_ms(rays, REPS), host_us=c.pf.host_us(rays, REPS),
          sizes=RAY_SIZES, bit_exact=not bad)
    return bad


def case_texels(c: Ctx) -> list:
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.render.renderer import DEFAULT_SUN
    g = np.mgrid[-3:4, -3:4, -3:4].reshape(3, -1).T
    ball = g[(g ** 2).sum(1) <= 9] + np.asarray(BRUSH)
    sun = DEFAULT_SUN[:3] / np.linalg.norm(DEFAULT_SUN[:3])
    e1, e2, _ = ss.sun_basis(sun)
    a0, b0, ts = ss.grid_frame(e1, e2, BRUSH_WORLD, ss.GRID)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.uniform(-50, 50, (ss.GRID ** 2, 2)).astype(
        np.float32)).to(c.dev)
    bad = []
    for label, tan in (("hard", 0.0), ("cone", ss.CONE_TAN)):
        grids = (base.clone(), a0, b0, ts)
        ss.invalidate_sun_texels(grids, e1, e2, ball, BRUSH_WORLD, tan)
        rects = ss.texel_rects(e1, e2, ball, BRUSH_WORLD, ss.GRID, a0, b0,
                               ts, tan)
        plain = base.clone()
        ss.invalidate_texels_plain(plain, rects)
        if not torch.equal(grids[0], plain):
            bad.append(f"K18 {label}")
        tex = torch.nonzero((plain != base).any(1))[:, 0]
        amb = torch.tensor([ss.NEG, 3e38], dtype=torch.float32,
                           device=c.dev).expand(len(tex), 2).contiguous()
        work = base.clone()

        def whole():
            ss.invalidate_sun_texels((work, a0, b0, ts), e1, e2, ball,
                                     BRUSH_WORLD, tan)

        def library():
            work.index_put_((tex,), amb)

        def queued() -> float:
            torch.cuda.synchronize()
            torch.cuda._sleep(QUEUED_SPIN_CYCLES)
            t0 = time.perf_counter()
            whole()
            whole()
            us = (time.perf_counter() - t0) * 1e6
            torch.cuda.synchronize()
            return us
        before = kernels.LAUNCHES["invalidate_texels"]
        whole()
        launches = kernels.LAUNCHES["invalidate_texels"] - before
        c.row(kernel="invalidate_texels", grids=label,
              rectangles=len(rects), texels=len(tex),
              launches_a_call=launches, ms=c.pf.cuda_ms(whole, REPS),
              device_us=c.pf.device_us(whole, ("vvr_invalidate_texels",),
                                       REPS, c.out / "kernel_ab_trace.json"),
              index_put_ms=c.pf.cuda_ms(library, REPS),
              ms_again=c.pf.cuda_ms(whole, REPS),
              index_put_ms_again=c.pf.cuda_ms(library, REPS),
              host_us=c.pf.host_us(whole, REPS),
              index_put_host_us=c.pf.host_us(library, REPS),
              two_calls_behind_spin_host_us=statistics.median(
                  queued() for _ in range(QUEUED_REPS)),
              bit_exact=f"K18 {label}" not in bad)
    return bad


def case_raster(c: Ctx) -> list:
    import torch

    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import raster
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.utils.camera import Camera
    scene = build_scene(WorldConfig(depth=4), c.dev, force_regenerate=True,
                        cache_path=c.out / "map_256.npz")
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    _, d = camera_rays(cam, WIDTH, HEIGHT, c.dev)
    faces = scene.ensure_faces()
    rcam = rt.raster_camera(cam)
    mesh = Renderer(WorldConfig(depth=4), RenderConfig(
        width=WIDTH, height=HEIGHT, debug_type=0), device=c.dev,
        scene=scene).mesh
    m = raster.view_proj(cam, WIDTH, HEIGHT)
    ev, et = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                    cam.position, cam.basis()[2])
    evd, etd = torch.from_numpy(ev).to(c.dev), torch.from_numpy(et).to(c.dev)

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
    for name, fn, parts in (("raster_fragments", k9, K9_PARTS),
                            ("raster_triangles", k22, K22_PARTS)):
        c.row(kernel=name,
              device_us=c.pf.device_us(fn, parts, RASTER_REPS,
                                       c.out / "kernel_ab_trace.json",
                                       each=True),
              ms=c.pf.cuda_ms(fn, RASTER_REPS), differ=off)
    return [k for k, v in off.items() if v]


def answered_share(fetches, answered) -> tuple:
    """(fetches a ray that fetches, the share of them the held masks
    answer) from a plain walk's `fetches` and its `answered` rows."""
    fe = float(fetches.sum())
    live = float(fetches.gt(0).sum())
    return fe / max(live, 1.0), float(answered.sum()) / max(fe, 1.0)


def lanes_busy(iterations, width: int, height: int) -> float:
    """Steps over 32 times the longest ray's, summed over the warps of a
    tiled launch (8x4 pixel tiles)."""
    import torch

    from vvr_tpu_torch.ops.jump import tile_ray_index
    idx = tile_ray_index(width, height).to(iterations.device)
    it = torch.where(idx >= 0, iterations[idx.clamp(min=0)], 0).view(-1, 32)
    return float(it.sum()) / max(float(it.amax(1).sum()) * 32, 1.0)


def case_pyramid(c: Ctx) -> list:
    import dataclasses as dc

    import torch

    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import bounce, shade, softshadow
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sky as sky_ops
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops import traverse
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import frame as frame_mod
    from vvr_tpu_torch.render import raster
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.utils.camera import Camera
    trace = c.out / "kernel_ab_trace.json"
    wcfg = WorldConfig(depth=4)
    scene = build_scene(wcfg, c.dev, force_regenerate=True,
                        cache_path=c.out / "map_256.npz")
    pyr = scene.ensure_pyramid()
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, traversal="pyramid")
    cap = cfg.traversal_max_steps
    r = Renderer(wcfg, cfg, device=c.dev, scene=scene)
    sun_np = r.sun[:3].copy()
    sun3 = torch.from_numpy(sun_np)
    sun_d = sun3.to(c.dev)
    o, d = camera_rays(cam, WIDTH, HEIGHT, c.dev)
    bad, timed = [], {}

    def k19(label, ro, rd, ra):
        res = None
        ans = (torch.zeros(pyr.rows.shape[0], dtype=torch.int64,
                           device=c.dev),)
        for uf in (True, False):
            got = traverse.trace_pyramid(pyr, ro, rd, cap, active=ra,
                                         use_full=uf)
            ref = traverse.trace_pyramid_plain(
                pyr, ro, rd, cap, ra, use_full=uf,
                answered=None if uf else ans)
            lean = traverse.trace_pyramid(pyr, ro, rd, cap, active=ra,
                                          width=WIDTH, stats=False,
                                          use_full=uf)
            if not (all(torch.equal(getattr(got, f), getattr(ref, f))
                        for f in TRACE_FIELDS)
                    and all(torch.equal(getattr(lean, f), getattr(ref, f))
                            for f in TRACE_FIELDS[:4])):
                bad.append(f"K19 {label} full {uf}")
            res = got
        per_ray, share = answered_share(res.fetches, ans[0])
        timed[f"pyramid_trace {label}"] = (
            lambda: traverse.trace_pyramid(pyr, ro, rd, cap, active=ra,
                                           width=WIDTH, stats=False,
                                           use_full=False),
            ("vvr_trace_kernel", "VvrPyramidViewT"),
            dict(fetches_a_ray=per_ray, answered_share=share,
                 steps_a_ray=float(res.iterations.float().mean()),
                 lanes_busy=lanes_busy(res.iterations, WIDTH, HEIGHT)))
        return res

    prim = k19("primary", o, d, None)
    so, sa = shade.shade_surface(o, d, prim.hit, prim.face, prim.axis_coord,
                                 sun3)
    k19("shadow", so, sun_d, sa)

    # K12 and K14 on the raster hits, with the frame's sun and cone grids
    faces = scene.ensure_faces()
    ras = rt.trace_raster(faces, rt.raster_camera(cam), d,
                          scene.solid_at_host(cam.position), wcfg.size,
                          WIDTH, HEIGHT)
    hits = (o, d, ras.hit, ras.face, ras.axis_coord)
    e1, e2, _ = ss.sun_basis(sun_np)
    grids = r._sunmask()[2]
    ms_k = ss.masked_shadow_from_hits(pyr, *hits, sun_np, e1, e2, grids,
                                      cap)
    if not torch.equal(ms_k, ss.masked_shadow_from_hits_plain(
            pyr, *hits, sun_np, e1, e2, grids, cap)):
        bad.append("K12 pyramid")
    timed["masked_shadow_pyramid"] = (
        lambda: ss.masked_shadow_from_hits(pyr, *hits, sun_np, e1, e2, grids,
                                           cap),
        ("vvr_masked_shadow_kernel", "VvrPyramidViewT"), {})
    soft = Renderer(wcfg, dc.replace(cfg, shadow_samples=4), device=c.dev,
                    scene=scene)
    gate = (e1, e2, soft._sunmask()[2])
    _, clouds = r._sky(0.0)
    fk, hk = softshadow.soft_shadow(pyr, *hits, sun_np, 4, clouds, cap,
                                    False, gate, with_hits=True, width=WIDTH)
    hp = softshadow.sample_hits_plain(pyr, *hits, sun_np, 4, cap, False,
                                      gate)
    fp = softshadow.shadow_factor_plain(*(t.cpu() for t in hits), sun_np,
                                        hk.cpu(), clouds.cpu(), False)
    if not torch.equal(hk, hp) or float((fk.cpu() - fp).abs().max()) > 1e-5:
        bad.append("K14 pyramid")
    timed["soft_shadow_pyramid"] = (
        lambda: softshadow.soft_shadow(pyr, *hits, sun_np, 4, clouds, cap,
                                       gate=gate, width=WIDTH),
        ("vvr_soft_shadow_kernel", "VvrPyramidViewT"), {})

    # K15 on the overlap AO frame's bounce 0: its arguments recorded as
    # the frame calls it, the output buffers copied
    first = []
    orig = frame_mod.shade_bounce

    def rec(*args):
        if not first:
            first.extend(args)
            first[11] = args[11].clone()
            if args[21]:
                first[21] = tuple(x.clone() for x in args[21])
        orig(*args)
    frame_mod.shade_bounce = rec
    try:
        Renderer(wcfg, dc.replace(cfg, ambient_occlusion=True,
                                  ao_mode="overlap"), device=c.dev,
                 scene=scene).render(cam, time=0.25)
    finally:
        frame_mod.shade_bounce = orig

    def bounce_args():
        a = list(first)
        a[11] = first[11].clone()
        if first[21]:
            a[21] = tuple(x.clone() for x in first[21])
        return a
    ak, ap = bounce_args(), bounce_args()
    bounce.shade_bounce(*ak)
    bounce.shade_bounce_plain(*ap)
    if not (torch.equal(ak[11][3], ap[11][3])
            and float((ak[11][:3] - ap[11][:3]).abs().max()) <= 1e-5):
        bad.append("K15 pyramid")
    at = bounce_args()
    timed["shade_bounce_pyramid"] = (
        lambda: bounce.shade_bounce(*at),
        ("vvr_shade_bounce_kernel", "VvrPyramidViewT"), {})

    # K23 on the raster view's winners (the straddlers clipped)
    mesh = Renderer(wcfg, dc.replace(cfg, debug_type=0), device=c.dev,
                    scene=scene).mesh
    m = raster.view_proj(cam, WIDTH, HEIGHT)
    ev, et = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                    cam.position, cam.basis()[2])
    evd, etd = torch.from_numpy(ev).to(c.dev), torch.from_numpy(et).to(c.dev)
    _, win = raster.raster_triangles(mesh.verts, mesh.tris, m, WIDTH, HEIGHT,
                                     evd, etd)
    skybox, clouds_r = sky_ops.write_sky(sun_np, 0.0, cfg.skybox_resolution,
                                         cfg.clouds_resolution, c.dev)

    def k23():
        return raster.shade_raster(win, mesh.verts, mesh.tris, pyr,
                                   cam.position, d, sun_np, skybox, clouds_r,
                                   cap, WIDTH, HEIGHT, evd, etd)
    covered = (win != raster.NO_TRI).view(1, HEIGHT, WIDTH)
    hk23 = k23()
    hp23 = raster.shade_raster_plain(
        win, torch.cat([mesh.verts, evd]), torch.cat([mesh.tris, etd]), pyr,
        cam.position, d, sun3, skybox, clouds_r, cap, WIDTH, HEIGHT)
    if not (torch.equal(torch.where(covered, hk23, 0),
                        torch.where(covered, hp23, 0))
            and torch.allclose(hk23, hp23, rtol=1e-4, atol=1e-5)):
        bad.append("K23")
    timed["shade_raster"] = (k23, ("vvr_shade_raster_kernel",), {})
    for name, (fn, parts, extra) in timed.items():
        c.row(kernel=name, device_us=c.pf.device_us(fn, parts, REPS, trace),
              ms=c.pf.cuda_ms(fn, REPS), **extra, differ=bad)
    return bad


def case_pyramid1024(c: Ctx) -> list:
    import torch

    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import traverse
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.utils.camera import Camera
    pyr = build_scene(WorldConfig(depth=5), c.dev, force_regenerate=True,
                      cache_path=c.out / "map_1024.npz").ensure_pyramid()
    cam = Camera.look_at(*CONFIG5_CAMERA[:2], fov=CONFIG5_CAMERA[2])
    o, d = camera_rays(cam, WIDTH, HEIGHT, c.dev)
    cap = RenderConfig().traversal_max_steps
    got = traverse.trace_pyramid(pyr, o, d, cap, use_full=False)
    ans = (torch.zeros(pyr.rows.shape[0], dtype=torch.int64, device=c.dev),)
    ref = traverse.trace_pyramid_plain(pyr, o, d, cap, use_full=False,
                                       answered=ans)
    same = all(torch.equal(getattr(got, f), getattr(ref, f))
               for f in TRACE_FIELDS)
    per_ray, share = answered_share(ref.fetches, ans[0])

    def fn():
        traverse.trace_pyramid(pyr, o, d, cap, width=WIDTH, stats=False,
                               use_full=False)
    c.row(kernel="pyramid_trace primary 1024^3",
          device_us=c.pf.device_us(fn, ("vvr_trace_kernel",
                                        "VvrPyramidViewT"), REPS,
                                   c.out / "kernel_ab_trace.json"),
          ms=c.pf.cuda_ms(fn, REPS), fetches_a_ray=per_ray,
          answered_share=share,
          steps_a_ray=float(ref.iterations.float().mean()),
          lanes_busy=lanes_busy(ref.iterations, WIDTH, HEIGHT),
          bit_exact=same)
    return [] if same else ["K19 primary 1024^3"]


CASES = {"raygen": case_raygen, "texels": case_texels,
         "raster": case_raster, "pyramid": case_pyramid,
         "pyramid1024": case_pyramid1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2],
                    help="the checkout whose kernels are measured")
    ap.add_argument("cases", nargs="*", metavar="CASE",
                    help=f"of {', '.join(CASES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.cases) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    pf = own_profile_frame()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from vvr_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip())
    kernels.build()
    out = root / "build" / "vvr_tpu_torch"
    out.mkdir(parents=True, exist_ok=True)
    ctx = Ctx(root, torch.device("cuda", 0), out, pf)
    bad = [b for name in args.cases or CASES for b in CASES[name](ctx)]
    if bad:
        print(f"kernel_ab: differ from the plain versions: {bad}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
