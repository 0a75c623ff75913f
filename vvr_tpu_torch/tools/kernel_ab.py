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


CASES = {"raygen": case_raygen, "texels": case_texels,
         "raster": case_raster}


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
