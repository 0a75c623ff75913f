#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the port's CUDA
   kernels from vvr_tpu_torch/csrc (timed); fails if K11's kernels hold a
   global atomic (ATOMG, RED or ATOM in their SASS, tools/sass_count.py)
   or a fill or decode pass, if a K7 kernel's SASS has no HGMMA (wgmma) or
   any HMMA (mma.sync), if a K5 or K6 kernel spills (`-Xptxas -v`), or if
   a K6 kernel's SASS holds MUFU.RCP (the reciprocal of a division);
2. the main path: with every launch counter reset, builds the 256^3 world
   on the card from cold (timed) and renders frames of bench.py's
   default-knob configuration (1920x1080, face rasterizer for primary
   visibility, one hard shadow ray per lit pixel answered by the sun
   classifier, sky textures cached per 0.25 s bucket, bloom, ACES) through
   `Renderer.render`; reads the counters and fails unless each kernel of
   that path (K2 shade_pixel, K3, K4, K9, K10, K11, K12; K12 computes the
   shadow rays' starts, so K2 shade_surface and K1 must not run) was
   launched, each per-frame kernel once in every frame and K3 once per
   sky bucket (both textures in one launch); prints the port's kernel
   launches per frame and the slowest frame, with whether it rebuilt the
   sky;
3. the DDA frame (`primary_raster="off", sun_mask="off"`: K1 for primary
   and shadow rays, K2 shade_surface for their starts) over the same
   scene, counters reset before it and read after, checked and printed the
   same way, its median printed beside the default frame's; fails unless
   each of its K1 launches traced by 8x4 tiles without the counters, the
   shadow trace with the one sun direction (no (N, 3) copy); then the
   dragged sun: default-knob frames with `set_sun_dragging(True)`, the sun
   turned by a small step about the vertical every frame (as the app's
   middle-mouse drag turns it), counters reset before and read after;
   fails unless K11 (512^2 grids) and K3 launch once in every frame beside
   the per-frame kernels, or unless the last dragged frame's bytes equal a
   full-grid (2048^2) frame's at the same sun; prints the median and the
   slowest frame and K11's device time per dragged frame (torch.profiler);
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
   the DDA frame, and the kernel frame against the plain-torch frame; K11
   (written texels equal, values within 1e-4; prints whether value-equal)
   at 2048^2 and 512^2 under the frame's sun and a low one, at 509^2, and
   for a face set without occluders and one without faces (every texel
   NEG), once each, with the busiest tile's (face, texel) pairs against
   the mean; K3
   (one launch) bit-equal to a launch per texture, at 256/512 and 7/13
   and two suns within rtol 1e-4, atol 1e-5 of the plain versions run on
   the card, and within that plus the first-order effect of the card's
   and the CPU's exp and pow rounding of the plain versions run on the
   CPU; K8
   bit-exact against its plain version at odd shapes (1, 2, 3, 4, 16 and 17
   columns, 1000 and 33 lanes, indices negative and past the rows); K5, K6
   and K7 (u32 and int32 output) bit-exact against their plain versions at
   odd shapes (K5_ODD, K6_ODD, K7_ODD: K6 also where a K5_ODD table fits in
   a block's shared memory, K7 where the planes do; 1, 33, 1000 and
   2^21 + 17 lanes, table words of 2^31 and more, indices negative and past
   the rows); K6 and K7 bit-exact again with one kernel instance called at
   two sizes above 48 KB of shared memory in the order A, B, A
   (SHARED_IN_TURN); prints the registers and spills of K3 and K8;
5. times each kernel beside its plain version (CUDA events) and computes
   its bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the peak for their type (K3: its float32 and MUFU
   operations per texel path, the MUFU ones over 16 a clock on each SM at
   the card's maximum SM clock);
   times the host's microseconds per kernels.launch call, beside K8's
   wrapper and torch.index_select;
6. drives the gather microbenchmark's path (vvr_tpu_torch.tools.
   microbench_gather: every experiment of the two reference tools at
   N = 2^21 lanes) with the launch counters reset just before and read
   just after, and fails unless each of K5-K8 was launched; the tool holds
   every kernel against its plain version bit for bit before timing it.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result. Before the last line
it prints {"kernels": [...]}, one row per kernel with its launches (from
the path that runs it), error against its plain version, times and bound
(K11 twice: `sun_grids` at 2048^2 with the main path's launches,
`sun_grids_512` with the dragged frames');
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
                "bloom_pyramid": 220, "composite": 190,
                "raster_fragments": 70,
                "raster_resolve": 45, "sun_grids": 90, "masked_shadow": 60}
# K3's work per texel (sky_work), from csrc/sky.cu. SKY_LEAF: the fast path
# of each device function a texel calls, (float32 operations, MUFU
# operations), from `python3 vvr_tpu_torch/tools/sass_count.py --probe`
# (CUDA 12.9, sm_90a, -fmad=false; an FFMA counts two operations, as the
# float32 peak counts them). SKY_PARTS: each part of a texel's path as
# (the float32 instructions of its own code, counted by hand as written:
# no contraction, negations and fabsf free, a comparison and a select one
# each; {device function: calls}). A skybox texel is "skybox" plus its
# optical depths ("depth_up" or "depth_down" by optical_depth's branch)
# and "hit" where its ray hits the planet; a cloud texel is "cloud" (its
# ambient sky looks up: one optical depth, no hit). What every texel of a
# launch shares is computed once per block (under 0.5% of the work; not
# counted).
SKY_LEAF = {"expf": (10, 1), "sqrtf": (6, 1), "division": (11, 1),
            "powf_1.5": (73, 1), "powf_4": (72, 1),
            "scaled_depth": (92, 7), "vvr_sdnoise2": (109, 0),
            "vvr_hash12": (19, 0)}
SKY_PARTS = {
    # u, v, the direction's normalize; sky(): the planet, the scale by 4
    # and day; scatter() but its optical depths; the sun disc and stars
    "skybox": (9 + 17 + 81 + 43, {"division": 13, "sqrtf": 2, "expf": 3,
                                  "powf_1.5": 1, "vvr_hash12": 1}),
    "depth_up": (6, {"scaled_depth": 1}),
    "depth_down": (18, {"scaled_depth": 2}),
    "hit": (6, {}),
    # px, pz, five noise octaves, two normalizes, the scattered, reflected
    # and silver light, the colour; its sky() and scatter(), one optical
    # depth looking up
    "cloud": (112 + 17 + 81 + 6, {"division": 12, "sqrtf": 4, "expf": 3,
                                  "powf_1.5": 1, "powf_4": 1,
                                  "vvr_sdnoise2": 5, "scaled_depth": 1}),
}
MUFU_PER_CLOCK_PER_SM = 16
# K3 against its plain version on the CPU, where the only functions that
# round otherwise than the card's are exp and pow: ulps each result may be
# off, CUDA's documented maximum for expf (2) and powf (4) plus one for
# torch's CPU exp and pow (sky_rounding_bound)
SKY_ULPS = {"exp": 2 + 1, "pow": 4 + 1}
# K8 against its plain version at odd shapes: (rows, cols), lanes
K8_ODD = [(4099, c) for c in (1, 2, 3, 4, 16, 17)]
K8_ODD_LANES = (1000, 33)
# the chain kernels' odd shapes: lanes, K5's and K6's (rows, cols) (K6 where
# the table fits in a block's shared memory), K6's own (one row, a prime
# and a power of two near 4096 rows, and a 1-D table of SHARED_WORDS, which
# fills a block's shared memory) and K7's (rows, cols) (where the planes
# fit with their alignment, ops/gather.py onehot_plan)
CHAIN_ODD_LANES = (1, 33, 1000, (1 << 21) + 17)
K5_ODD = [(r, c) for r in (1000, 1024, 266305) for c in (1, 2, 3, 4, 16, 17)]
SHARED_WORDS = 58112
K6_ODD = [(r, c) for r in (1, 4093, 4096) for c in (1, 2)] + [
    (SHARED_WORDS, 1)]
K7_ODD = [(r, c) for r in (16, 48, 64, 4096) for c in (2, 4, 8, 16)]
# one K6 instance (a 1-D table, rows not a power of two) and one K7
# instance (8 plane columns, 8 k tiles a batch) each called at a larger,
# a smaller and again the larger size, all above 48 KB of shared memory:
# the per-kernel shared-memory limit the launch sets must follow each call
SHARED_IN_TURN = (("K6", [(SHARED_WORDS, 1), (20000, 1), (SHARED_WORDS, 1)]),
                  ("K7", [(8192, 2), (4096, 2), (8192, 2)]))
# name parts of K5's, K6's and K7's device kernels
K5_KERNEL, K6_KERNEL, K7_KERNEL = ("chain_kernel", "chain_shared_kernel",
                                   "onehot_kernel")
LAUNCH_CALLS = 10_000   # host timing of kernels.launch
# the bloom pyramid's items are its downsampled texels (220 operations
# each) and its upsampled ones, at this many operations
BLOOM_UP_OPS = 40
# K1's primary rays that differ from the numpy oracle (JAX trace_jump
# gives the same answer: its jump and subcell steps place the cell by a
# floor, which can take an exact x/z crossing tie the other way); more than
# this many fails the run
K1_ORACLE_SLACK = 16
# K11's rows: the 2048^2 build (once per sun direction) and the 512^2 one
# (every frame while the sun is dragged), both of the sun_grids kernel
ROW_KERNEL = {"sun_grids_512": "sun_grids"}
# name parts of K11's device kernels (and the scans it shares with K9)
K11_SASS = ("vvr_sun_", "vvr_scan_")
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


def nvidia_smi_clock() -> float:
    """The SM clock the card boosts to, in Hz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip()) * 1e6


def skybox_dirs(sky, r: int, sun):
    """The skybox's texel directions (6, r, r, 3), as write_skybox_plain
    forms them face by face."""
    import torch
    g = sky._texel_grid(r).to(sun.device) * 2.0 - 1.0
    vv, uu = torch.meshgrid(g, g, indexing="ij")
    d = torch.stack([sky._face_dirs(f, uu, vv) for f in range(6)])
    d = d / sky._norm(d)
    return d * sky._vec((-1.0, 1.0, -1.0), sun)


def sky_work(sky, sun, r_sky: int, r_clouds: int) -> tuple[float, float]:
    """K3's (float32 operations, MUFU operations) for one launch at these
    resolutions: every texel's parts (SKY_PARTS), the skybox's optical
    depths and planet hits by the branches its directions take."""
    import torch

    def part(name):
        glue, calls = SKY_PARTS[name]
        return (glue + sum(SKY_LEAF[f][0] * c for f, c in calls.items()),
                sum(SKY_LEAF[f][1] * c for f, c in calls.items()))

    d = skybox_dirs(sky, r_sky, sun)
    start = sky._vec((0.0, sky.CAM_POS_Y + sky.BOTTOM_RADIUS, 0.0),
                     sun).expand(d.shape)
    sd = (sun / sky._norm(sun)).expand(d.shape)
    planet = sky.planet_bounds(start, d)
    hit = planet >= 0.0
    end = start + d * planet[..., None]

    def ups(ray, direction, where):   # optical depths that take mid > 0
        return float(((sky._dot(ray, direction) > 0.0) & where).sum())

    every = torch.ones_like(hit)
    n_hit = float(hit.sum())
    up = ups(start, d, every) + ups(end, d, hit) + ups(end, sd, hit)
    down = d.shape[0] * r_sky * r_sky + 2 * n_hit - up
    counts = {"skybox": 6 * r_sky * r_sky, "depth_up": up,
              "depth_down": down, "hit": n_hit,
              "cloud": r_clouds * r_clouds}
    ops = mufu = 0.0
    for name, count in counts.items():
        o, m = part(name)
        ops, mufu = ops + o * count, mufu + m * count
    return ops, mufu


def sky_rounding_bound(sky, sun, time: float, r_sky: int, r_clouds: int):
    """(skybox, clouds), each shaped as its texture: how far each texel
    channel of the plain sky moves, to first order, when every exp and
    pow result moves by SKY_ULPS ulps (2^-23 of it a ulp). The plain sky
    runs on `sun`'s device with each texel-shaped exp and pow result
    multiplied by (1 + e), e zeros that autograd follows; a texel's
    channels depend only on its own e, so the gradient of a channel's sum
    is each texel's sensitivity. Results shaped as the sun alone (the sun
    colour) move every texel alike and stay inside rtol."""
    import torch
    from torch.overrides import TorchFunctionMode
    ulps = {torch.exp: SKY_ULPS["exp"], torch.pow: SKY_ULPS["pow"]}

    class Perturbed(TorchFunctionMode):
        def __init__(self, texels):
            super().__init__()
            self.texels, self.terms = texels, []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in ulps and out.numel() >= self.texels:
                e = torch.zeros_like(out, requires_grad=True)
                self.terms.append((e, ulps[func]))
                out = out * (1.0 + e)
            return out

    def bound(fn, texels):
        mode = Perturbed(texels)
        with mode:
            out = fn()
        lead = out.shape[:-1]
        b = torch.zeros(out.shape, dtype=torch.float64, device=out.device)
        es = [e for e, _ in mode.terms]
        for c in range(out.shape[-1]):
            grads = torch.autograd.grad(out[..., c].sum(), es,
                                        retain_graph=True, allow_unused=True)
            for (_, u), g in zip(mode.terms, grads):
                if g is not None:
                    b[..., c] += (u * 2.0 ** -23) * g.double().abs().reshape(
                        *lead, -1).sum(-1)
        return b

    d = skybox_dirs(sky, r_sky, sun)
    return (bound(lambda: sky.sky(sun.expand(d.shape), d, extra_light=True),
                  d[..., 0].numel()),
            bound(lambda: sky.write_clouds_plain(sun, time, r_clouds),
                  r_clouds * r_clouds))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def chain_odd(gather, dev) -> None:
    """K5, K6 and K7 bit for bit against their plain versions at odd shapes:
    CHAIN_ODD_LANES lanes, tables of full-range words (2^31 and more are
    negative int32 words, whose next index is their floor mod; the last
    word always is), starting indices negative and past the rows."""
    import torch
    check(SHARED_WORDS * 4 == gather.SHARED_BYTES,
          f"SHARED_WORDS {SHARED_WORDS} does not fill SHARED_BYTES")
    shared, onehot, skipped = 0, 0, []
    cases = [(kind, rc, n) for kind, shapes in (("chain", K5_ODD + K6_ODD),
                                                ("onehot", K7_ODD))
             for rc in shapes for n in CHAIN_ODD_LANES]
    for kind, (rows, cols), lanes in cases:
        gen = torch.Generator(device=dev).manual_seed(rows * 31 + cols * 7
                                                      + lanes)
        shape = (rows, cols) if cols > 1 else (rows,)
        t32 = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                            device=dev, dtype=torch.int32)
        t32.view(-1)[-1] |= -2 ** 31    # a one-row table has a word too
        tab = t32.view(torch.uint32)
        ix = torch.randint(-3 * rows, 3 * rows, (lanes,), generator=gen,
                           device=dev, dtype=torch.int32)
        check(bool((tab.view(torch.int32) < 0).any()),
              "chain odd shapes: no table word of 2^31 or more")
        check(lanes < 33 or bool((ix < 0).any() and (ix >= rows).any()),
              "chain odd shapes: no negative or out-of-range index")
        want = gather.gather_chain_plain(tab, ix)
        runs = []
        if kind == "chain":
            if (rows, cols) in K5_ODD:
                runs.append(("K5", lambda: gather.gather_chain(tab, ix)))
            if tab.numel() * 4 <= gather.SHARED_BYTES:
                shared += 1
                runs.append(("K6", lambda: gather.gather_chain_shared(
                    tab, ix)))
        else:
            try:
                gather.onehot_plan(rows, 4 * cols)
            except ValueError:
                skipped.append((rows, cols))
                continue
            onehot += 1
            planes = gather.u8_planes(tab.view(rows, cols))
            want = gather.gather_onehot_plain(planes, ix)
            runs.append(("K7", lambda: gather.gather_onehot(planes, ix)))
            runs.append(("K7 int32", lambda: gather.gather_onehot(
                planes, ix, torch.int32).view(torch.uint32)))
        for what, fn in runs:
            got = fn()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{what} at {rows}x{cols}, {lanes} lanes: differs from "
                  "plain")
    check(shared == len(CHAIN_ODD_LANES) * (len(K6_ODD) + sum(
        r * c * 4 <= gather.SHARED_BYTES for r, c in K5_ODD)),
          "K6 skipped an odd shape")
    print(f"K5: bit-exact vs plain at rows x cols {K5_ODD}; K6 at the "
          f"{shared // len(CHAIN_ODD_LANES) - len(K6_ODD)} of them that fit "
          f"in shared memory and at {K6_ODD}; K7 (u32 and int32) at "
          f"{onehot // len(CHAIN_ODD_LANES)} "
          f"of {K7_ODD} (planes too large for a block: "
          f"{sorted(set(skipped))}); lanes {list(CHAIN_ODD_LANES)}, words "
          f"of 2^31 and more, indices negative and past the rows")


def shared_in_turn(gather, dev) -> None:
    """K6 and K7 bit for bit against their plain versions with one kernel
    instance called at two shared-memory sizes above 48 KB, in the order
    A, B, A (SHARED_IN_TURN), at 4099 lanes."""
    import torch
    lanes = 4099
    for what, shapes in SHARED_IN_TURN:
        for rows, cols in shapes:
            gen = torch.Generator(device=dev).manual_seed(rows + cols)
            shape = (rows, cols) if cols > 1 else (rows,)
            tab = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                                device=dev, dtype=torch.int32
                                ).view(torch.uint32)
            ix = torch.randint(-3 * rows, 3 * rows, (lanes,), generator=gen,
                               device=dev, dtype=torch.int32)
            if what == "K6":
                check(tab.numel() * 4 > 48 * 1024,
                      f"K6 at {rows}x{cols} is not above 48 KB")
                got = gather.gather_chain_shared(tab, ix)
                want = gather.gather_chain_plain(tab, ix)
            else:
                check(gather.onehot_plan(rows, 4 * cols).smem > 48 * 1024,
                      f"K7 at {rows}x{cols} is not above 48 KB")
                planes = gather.u8_planes(tab.view(rows, cols))
                got = gather.gather_onehot(planes, ix)
                want = gather.gather_onehot_plain(planes, ix)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{what} at {rows}x{cols} in turn: differs from plain")
    print("K6 and K7: bit-exact vs plain with one instance called at two "
          "shared-memory sizes above 48 KB in turn: "
          + "; ".join(f"{what} {shapes}" for what, shapes in SHARED_IN_TURN))


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
    from vvr_tpu_torch.ops import gather, jump, post, shade, sky
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.tools import (microbench_gather, profile_frame,
                                     sass_count)
    from vvr_tpu_torch.tools.microbench_gather import bound_ms, cuda_ms
    from vvr_tpu_torch.utils.camera import Camera
    from vvr_tpu_torch.world.generator import assemble_dense

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    props = torch.cuda.get_device_properties(0)
    clock_hz = nvidia_smi_clock()
    print(f"device: {kind} | nvidia-smi: {smi}")

    # ---- 1. build
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    # K11's kernels: no fill or decode pass, no atomic on device memory
    sass = sass_count.disassemble(lib, pathlib.Path(kernels._nvcc()))
    k11_sass = sass_count.count(sass, K11_SASS)
    k11_atomics = {k: v["global_atomics"] for k, v in k11_sass.items()}
    check(any("vvr_sun_tile_kernel" in k for k in k11_sass),
          f"K11's tile kernel missing from the SASS: {sorted(k11_sass)}")
    check(not any(("fill" in k or "decode" in k) for k in k11_sass),
          f"K11 has a fill or decode kernel: {sorted(k11_sass)}")
    check(sum(k11_atomics.values()) == 0,
          f"K11's kernels hold global atomics (ATOMG, RED, ATOM): "
          f"{k11_atomics}")
    print(f"K11 SASS (sass_count.py): global atomic instructions (ATOMG, "
          f"RED, ATOM) {sum(k11_atomics.values())} in its "
          f"{len(k11_sass)} kernels {sorted(k11_sass)}")
    for name, regs, st, ld in kernels.ptxas_usage("vvr_sun_"):
        print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")
    # K7 multiplies with wgmma (HGMMA), never the per-warp mma.sync (HMMA);
    # K5 and K6 spill nothing
    k7_sass = sass_count.count(sass, (K7_KERNEL,))
    check(bool(k7_sass), "K7's kernels missing from the SASS")
    for name, counts in k7_sass.items():
        check(counts["tensor"]["HGMMA"] > 0 and counts["tensor"]["HMMA"] == 0,
              f"K7 {name}: tensor instructions {counts['tensor']}, expected "
              "HGMMA and no HMMA")
    k7_counts = list(k7_sass.values())
    print(f"K7 SASS (sass_count.py): {len(k7_counts)} kernels, HGMMA "
          f"{sorted(c['tensor']['HGMMA'] for c in k7_counts)}, HMMA "
          f"{sum(c['tensor']['HMMA'] for c in k7_counts)}, instructions "
          f"{sorted(c['instructions'] for c in k7_counts)}")
    for what, part in (("K5", K5_KERNEL), ("K6", K6_KERNEL)):
        usage = kernels.ptxas_usage(part)
        check(bool(usage), f"{what}'s kernels missing from the ptxas report")
        spills = [(n, st, ld) for n, _, st, ld in usage if st or ld]
        check(not spills, f"{what} spills: {spills}")
        print(f"ptxas: {what} {len(usage)} kernels, registers "
              f"{sorted({r for _, r, _, _ in usage})}, no spills")
    # K6's floor mod is a mask or a multiply-high, never a division
    k6_ops = sass_count.opcodes(sass, (K6_KERNEL,))
    check(bool(k6_ops), "K6's kernels missing from the SASS")
    rcp = {k: sum(v for op, v in ops.items() if op.startswith("MUFU.RCP"))
           for k, ops in k6_ops.items()}
    check(sum(rcp.values()) == 0, f"K6 kernels with MUFU.RCP: "
          f"{ {k: v for k, v in rcp.items() if v} }")
    print(f"K6 SASS (sass_count.py): {len(k6_ops)} kernels, MUFU.RCP 0, "
          f"instructions {sorted(sum(o.values()) for o in k6_ops.values())}")
    for name, regs, st, ld in kernels.ptxas_usage(K7_KERNEL):
        print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")

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
        ms, rebuilt = [], []
        img = None
        for i in range(FRAMES):
            before = kernels.LAUNCHES["write_sky"]
            t0 = time.perf_counter()
            img = r.render(cam, time=i / 60.0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rebuilt.append(kernels.LAUNCHES["write_sky"] > before)
        med = sorted(ms)[FRAMES // 2]
        slow = max(range(FRAMES), key=ms.__getitem__)
        check(tuple(img.shape) == (1080, 1920, 3)
              and img.dtype == torch.uint8,
              f"{label} frame shape {tuple(img.shape)} {img.dtype}")
        check(float(img.float().std()) > 10, f"{label} frame is nearly "
              "constant")
        print(f"frames ({label}): {FRAMES} at {cfg.width}x{cfg.height}, "
              f"median {med:.3f} ms, mean {sum(ms) / FRAMES:.3f} ms, min "
              f"{min(ms):.3f} ms, max {max(ms):.3f} ms (host clock, "
              f"synchronized)")
        print(f"slowest frame ({label}): index {slow} (t = {slow}/60 s), "
              f"{ms[slow]:.3f} ms, rebuilt the sky: "
              f"{'yes' if rebuilt[slow] else 'no'}; frames that rebuilt it: "
              f"{[i for i in range(FRAMES) if rebuilt[i]]}")
        print(f"Mrays/s ({label}): "
              f"{r.rays_per_frame / (med * 1e-3) / 1e6:.3f} "
              f"({r.rays_per_frame} rays/frame at the median)")
        return med

    # the kernels of each frame, and those launched once in every frame (K3
    # only per sky bucket, K11 per sun); K12 computes the shadow rays'
    # starts itself, so K2 shade_surface runs only in the DDA frame
    frame_kernels = ["shade_pixel", "write_sky",
                     "bloom_pyramid", "composite", "raster_fragments",
                     "raster_resolve", "sun_grids", "masked_shadow"]
    per_frame = ["shade_pixel", "bloom_pyramid", "composite",
                 "raster_fragments", "raster_resolve", "masked_shadow"]
    dda_kernels = ["jump_trace", "shade_surface", "shade_pixel",
                   "bloom_pyramid", "composite"]
    dda_per_frame = ["shade_surface", "shade_pixel", "bloom_pyramid",
                     "composite"]
    n_frames = FRAMES + 1  # with the warm-up frame
    # K3: one launch per sky bucket of the frames' times (the warm-up's
    # t = 0 is in the first)
    q = cfg.sky_cache_quantum
    buckets = len({int((i / 60.0) / q) for i in range(FRAMES)} | {0})

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
    check(launches["write_sky"] == buckets,
          f"the default-knob frames launched K3 {launches['write_sky']} "
          f"times over {buckets} sky buckets, expected one launch a bucket")
    print(f"K3 in the default-knob frames: {launches['write_sky']} launches "
          f"(write_sky) for {buckets} sky buckets, both textures each")
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

    # ---- 3b. the dragged sun: default knobs with set_sun_dragging(True),
    # the sun turned every frame as the app's middle-mouse drag turns it
    # (vvr_tpu/app.py:80-85), so each frame builds 512^2 sun grids (K11)
    # and the sky (K3, whose key holds the sun)
    drag = Renderer(wcfg, cfg, device=dev, scene=renderer.scene)
    drag.set_sun_dragging(True)
    start = drag.sun.copy()
    kernels.reset_launches()
    ms = []
    for i in range(n_frames):   # frame 0 warms up
        drag.sun = profile_frame.dragged_sun(start, i)
        t0 = time.perf_counter()
        img = drag.render(cam, time=i / 60.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms = ms[1:]
    drag_launches = frame_launches(
        "dragged-sun", frame_kernels, per_frame + ["sun_grids", "write_sky"])
    check(drag_launches["shade_surface"] == 0
          and drag_launches["jump_trace"] == 0,
          "the dragged-sun frame launched K1 or K2 shade_surface")
    check(drag._sunmask_cache[1][2][0].shape[0] == ss.GRID_DRAGGING ** 2,
          "the dragged-sun frame did not build 512^2 grids")
    slow = max(range(FRAMES), key=ms.__getitem__)
    print(f"frames (dragged sun, {profile_frame.DRAG_STEP} degrees a "
          f"frame): {FRAMES} at {cfg.width}x{cfg.height}, median "
          f"{sorted(ms)[FRAMES // 2]:.3f} ms, slowest {ms[slow]:.3f} ms "
          f"(frame {slow + 1}), min {min(ms):.3f} ms (host clock, "
          f"synchronized); per frame K11 (512^2) "
          f"{drag_launches['sun_grids'] / n_frames:.2f} and K3 "
          f"{drag_launches['write_sky'] / n_frames:.2f} launches")
    # the dragged frame against a full-grid frame at the same sun
    full = Renderer(wcfg, cfg, device=dev, scene=renderer.scene)
    full.sun = drag.sun.copy()
    img_full = full.render(cam, time=(n_frames - 1) / 60.0)
    check(full._sunmask_cache[1][2][0].shape[0] == ss.GRID ** 2,
          "the full-grid frame did not build 2048^2 grids")
    check(torch.equal(img, img_full),
          f"dragged-sun frame (512^2 grids) differs from the full-grid frame "
          f"at the same sun on {int((img != img_full).any(-1).sum())} pixels")
    print(f"dragged-sun frame (512^2 grids) equal to the full-grid frame "
          f"(2048^2) at the same sun, byte for byte")
    launches["sun_grids_512"] = drag_launches["sun_grids"]
    trace = repo / "build" / "vvr_tpu_torch" / "k11_trace.json"
    k11_us = {g: profile_frame.k11_window(faces, ss.sun_basis(drag.sun[:3]),
                                          wcfg.size, g, trace)
              for g in (ss.GRID_DRAGGING, ss.GRID)}
    print(f"K11 device time per dragged frame (512^2): "
          f"{k11_us[ss.GRID_DRAGGING]:.2f} us; per sun direction at "
          f"2048^2: {k11_us[ss.GRID]:.2f} us; 1 launch (kernels.launch) per "
          f"build")

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

    # K11 against its plain version: at 2048^2 and 512^2 (the dragged
    # sun's grid) under the frame's sun and frame_digest's low sun, at an
    # odd grid, and for a face set without occluders and one without faces
    # (every texel NEG); written texels equal, values within 1e-4
    low3 = np.asarray(profile_frame.LOW_SUN, np.float32)
    low3 = (low3 / np.linalg.norm(low3)).astype(np.float32)
    e1, e2, s_basis = ss.sun_basis(sun_np)
    errs["sun_grids"] = errs["sun_grids_512"] = 0.0
    fs0 = ss.face_setup(faces, e1, e2, s_basis,
                        *ss.grid_frame(e1, e2, wcfg.size, ss.GRID), ss.GRID)
    no_occl = tuple(a[~fs0["occl"]].contiguous() for a in faces[:8])
    no_faces = tuple(a[:0].contiguous() for a in faces[:8])
    k11_cases = [(f"{lbl} sun", sun_, g_, faces)
                 for lbl, sun_ in (("frame", sun_np), ("low", low3))
                 for g_ in (ss.GRID, ss.GRID_DRAGGING)]
    k11_cases += [("frame sun", sun_np, 509, faces),
                  ("no occluder", sun_np, ss.GRID, no_occl),
                  ("no face", sun_np, ss.GRID_DRAGGING, no_faces)]
    for label, sun_, g_, faces_ in k11_cases:
        basis = ss.sun_basis(sun_)
        before = kernels.LAUNCHES["sun_grids"]
        grids_k = ss.sun_grids(faces_, *basis, wcfg.size, g_)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["sun_grids"] == before + 1,
              f"K11 ({label}, {g_}^2) did not launch once")
        grids_p = ss.sun_grids_plain(faces_, *basis, wcfg.size, g_)
        gk, gp = grids_k[0], grids_p[0]
        check(tuple(grids_k[1:]) == tuple(grids_p[1:]),
              "K11 grid frame differs")
        check(bool(((gk <= -3e38) == (gp <= -3e38)).all()),
              f"K11 vs plain ({label}, {g_}^2): written texels differ")
        fin = gk > -3e38
        err = float((gk[fin] - gp[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
        check(err <= 1e-4, f"K11 vs plain ({label}, {g_}^2): max |diff| "
              f"{err}")
        if faces_ is not faces:
            check(not bool(fin.any()) and torch.equal(gk, gp),
                  f"K11 ({label}): a texel is not NEG")
            print(f"K11 {label} ({faces_[0].shape[0]} faces, {g_}^2): "
                  f"every texel NEG, equal to plain")
            continue
        key = "sun_grids_512" if g_ == ss.GRID_DRAGGING else "sun_grids"
        errs[key] = max(errs[key], err)
        tile = ss.sun_tiling(g_)[0]
        per = profile_frame.tile_pairs(
            ss.face_setup(faces, *basis, *grids_k[1:], g_), g_,
            tile).flatten().double()
        print(f"K11 {label}, {g_}^2: value-equal vs plain: "
              f"{bool(torch.equal(gk, gp))}, max |diff| {err}; written share "
              f"B {float(fin[:, 0].float().mean()):.4f}, C "
              f"{float(fin[:, 1].float().mean()):.4f}; depths "
              f"{float(gk[fin].min()):.3f}..{float(gk[fin].max()):.3f}; "
              f"{tile}^2-texel tiles: busiest {float(per.max()):.0f} (face, "
              f"texel) pairs, mean {float(per.mean()):.1f} (over the tiles "
              f"with pairs {float(per[per > 0].mean()):.1f}), busiest / mean "
              f"{float(per.max() / per.mean()):.2f}")
    grids_k = ss.sun_grids(faces, e1, e2, s_basis, wcfg.size)
    gk = grids_k[0]
    check(bool((gk[gk > -3e38] < 0).any()), "no negative depths exercised")
    grids_512 = ss.sun_grids(faces, e1, e2, s_basis, wcfg.size,
                             ss.GRID_DRAGGING)

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

    # K3: both textures from one launch, bit-equal to a launch per texture
    # (the separate write_skybox and write_clouds), at the main path's
    # resolutions and at odd ones (ragged tiles), at the frame's sun and a
    # low one; at every size held to the plain versions twice: run on the
    # card (the kernel's own exp and pow) within rtol 1e-4, atol 1e-5, and
    # run on the CPU (the version the tests hold to the JAX package) within
    # rtol 1e-4, atol 1e-5 plus the first-order effect of the two devices'
    # exp and pow rounding (sky_rounding_bound)
    rs, rc = cfg.skybox_resolution, cfg.clouds_resolution
    low = torch.tensor([0.6, 0.05, 0.8]) / float(np.linalg.norm([0.6, 0.05,
                                                                 0.8]))
    errs["write_sky"] = 0.0
    for s_, t_, r_s, r_c in ((sun3, 0.25, rs, rc), (low, 1.75, rs, rc),
                             (sun3, 0.25, 7, 13), (low, 1.75, 7, 13)):
        before = kernels.LAUNCHES["write_sky"]
        sb_, cl_ = sky.write_sky(s_, t_, r_s, r_c, dev)
        check(kernels.LAUNCHES["write_sky"] == before + 1,
              "write_sky did not launch K3 once")
        check(torch.equal(sb_, sky.write_skybox(s_, t_, r_s, dev))
              and torch.equal(cl_, sky.write_clouds(s_, t_, r_c, dev)),
              f"K3 at {r_s}/{r_c}: one launch differs from a launch per "
              "texture")
        sd_ = s_.to(dev)
        bounds = sky_rounding_bound(sky, sd_, t_, r_s, r_c)
        cpu = (sky.write_skybox_plain(s_, r_s),
               sky.write_clouds_plain(s_, t_, r_c))
        card = (sky.write_skybox_plain(sd_, r_s),
                sky.write_clouds_plain(sd_, t_, r_c))
        for what, k_, p_card, p_cpu, bnd in zip(
                (f"skybox at {r_s}", f"clouds at {r_c}"), (sb_, cl_), card,
                cpu, bounds):
            check(torch.allclose(k_, p_card, rtol=1e-4, atol=1e-5),
                  f"K3 {what} differs beyond rtol 1e-4, atol 1e-5 from its "
                  "plain version on the card")
            ref = p_cpu.to(dev).double().abs()
            diff = (k_.double() - p_cpu.to(dev).double()).abs()
            tol = 1e-5 + 1e-4 * ref
            share = float((diff / (tol + bnd)).max())
            check(share <= 1.0,
                  f"K3 {what} differs from its plain version on the CPU "
                  f"beyond rtol 1e-4, atol 1e-5 and the rounding bound "
                  f"({share:.3f} of the allowance)")
            print(f"K3 {what}, sun {tuple(round(float(c), 3) for c in s_)}: "
                  f"max |diff| {float((k_ - p_card).abs().max()):.3e} vs "
                  f"plain on the card; vs plain on the CPU "
                  f"{int((diff > tol).sum())} of {diff.numel()} values beyond "
                  f"rtol 1e-4, atol 1e-5, max |diff| {float(diff.max()):.3e}, "
                  f"max rel "
                  f"{float((diff / ref.clamp(min=1e-30)).max()):.3e}, "
                  f"rounding bound up to {float(bnd.max()):.3e}, largest "
                  f"share of the allowance {share:.3f}")
            errs["write_sky"] = max(errs["write_sky"], float(diff.max()))
    sb_k, cl_k = sky.write_sky(sun3, 0.25, rs, rc, dev)
    print(f"K3: one launch bit-equal to a launch per texture, within rtol "
          f"1e-4, atol 1e-5 of plain on the card and within that plus the "
          f"exp/pow rounding bound of plain on the CPU at {rs}/{rc} and "
          f"7/13, two suns; max |diff| {errs['write_sky']:.3e}")
    for part in ("vvr_sky_kernel", "rows_kernel"):
        for name, regs, st, ld in kernels.ptxas_usage(part):
            print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
    # K8 at odd shapes: indices negative and past the table's rows
    for (rows_, cols_), lanes_ in ((rc_, l_) for rc_ in K8_ODD
                                   for l_ in K8_ODD_LANES):
        g8 = torch.Generator(device=dev).manual_seed(cols_ * 7 + lanes_)
        tab = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows_, cols_),
                            generator=g8, device=dev,
                            dtype=torch.int32).view(torch.uint32)
        ix = torch.randint(-3 * rows_, 3 * rows_, (lanes_,), generator=g8,
                           device=dev, dtype=torch.int32)
        check(bool((ix < 0).any() and (ix >= rows_).any()),
              "K8 odd shapes: no negative or out-of-range index")
        got = gather.gather_rows(tab, ix)
        want = gather.gather_rows_plain(tab, ix)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K8 at {rows_}x{cols_}, {lanes_} lanes: differs from plain")
    print(f"K8: bit-exact vs plain at {rows_} rows x "
          f"{[c for _, c in K8_ODD]} columns, {list(K8_ODD_LANES)} lanes, "
          f"indices negative and past the rows")
    chain_odd(gather, dev)
    shared_in_turn(gather, dev)

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
        "sun_grids_512": (
            lambda: ss.sun_grids(faces, e1, e2, s_basis, wcfg.size,
                                 ss.GRID_DRAGGING),
            lambda: ss.sun_grids_plain(faces, e1, e2, s_basis, wcfg.size,
                                       ss.GRID_DRAGGING),
            20, 3),
        "masked_shadow": (
            lambda: ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2,
                                               grids_k, max_steps),
            lambda: ss.masked_shadow_from_hits_plain(
                grid, *hits, sun_np, e1, e2, grids_k, max_steps),
            20, 1),
        "shade_pixel": (lambda: shade.shade_pixel(*args),
                        lambda: shade.shade_pixel_plain(*args), 50, 5),
        "write_sky": (
            lambda: sky.write_sky(sun3, 0.25, rs, rc, dev),
            lambda: (sky.write_skybox_plain(sun_d, rs),
                     sky.write_clouds_plain(sun_d, 0.25, rc)),
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
    def k11_pairs(grids_, g_):
        fs = ss.face_setup(faces, e1, e2, s_basis, *grids_[1:], g_)
        return float(torch.where(fs["occl"], (fs["oi1"] - fs["oi0"] + 1)
                                 * (fs["oj1"] - fs["oj0"] + 1), 0).sum())

    pairs = k11_pairs(grids_k, ss.GRID)
    pairs_512 = k11_pairs(grids_512, ss.GRID_DRAGGING)
    res_it = jump.trace_jump(grid, so_k, sun_d, max_steps,
                             active=residue).iterations[residue].float()
    res_steps = float(res_it.sum())
    print(f"K12 residue: {int(residue.sum())} lanes, DDA sub-steps sum "
          f"{res_steps:.0f}, mean {float(res_it.mean()):.2f}, max "
          f"{float(res_it.max()):.0f}")
    lanes = float(sa_k.sum())
    sky_ops, sky_mufu = sky_work(sky, sun_d, rs, rc)
    items = {  # (bytes moved, items for OPS_PER_ITEM) at this run's shapes
        "raster_fragments": (nbytes(*faces[:7], d, keys_k), fragments),
        "raster_resolve": (nbytes(keys_k, d, ras_k.hit, ras_k.face,
                                  ras_k.axis_coord, ras_k.t), n),
        "sun_grids": (nbytes(*faces[:8], gk), pairs),
        "sun_grids_512": (nbytes(*faces[:8], grids_512[0]), pairs_512),
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
        # K3: its float32 operations themselves (sky_work)
        "write_sky": (nbytes(sb_k, cl_k), sky_ops),
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
        if name == "write_sky":
            # bytes, float32 operations, and the SFU term: MUFU operations
            # over 16 a clock on each SM
            b_ms, b_by = bound_ms(moved, count, "fp32")
            sfu_ms = sky_mufu / (props.multi_processor_count
                                 * MUFU_PER_CLOCK_PER_SM * clock_hz) * 1e3
            print(f"K3 bound terms: bytes {bound_ms(moved, 0, 'fp32')[0]:.6f}"
                  f" ms, float32 {bound_ms(0, count, 'fp32')[0]:.6f} ms "
                  f"({count:.0f} operations), SFU {sfu_ms:.6f} ms "
                  f"({sky_mufu:.0f} MUFU operations, "
                  f"{props.multi_processor_count} SMs at "
                  f"{clock_hz / 1e6:.0f} MHz); the "
                  f"{'SFU' if sfu_ms > b_ms else b_by} term binds")
            if sfu_ms > b_ms:
                b_ms, b_by = sfu_ms, "operations"
        else:
            b_ms, b_by = bound_ms(moved, OPS_PER_ITEM[ROW_KERNEL.get(
                name, name)] * count, "fp32")
        k = kernels.KERNELS[ROW_KERNEL.get(name, name)]
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
          f"{pairs:.0f} (face, texel) pairs at {ss.GRID}^2, {pairs_512:.0f} "
          f"at {ss.GRID_DRAGGING}^2")

    # the host's cost of one launch through kernels.launch (K8 on a 64x2
    # table, 32 lanes: the device's part is negligible), beside K8's whole
    # wrapper and torch.index_select on the same inputs
    tab = torch.randint(0, 1 << 30, (64, 2), device=dev,
                        dtype=torch.int32).view(torch.uint32)
    ix = torch.randint(0, 64, (32,), device=dev, dtype=torch.int32)
    out8 = torch.empty((32, 2), dtype=torch.uint32, device=dev)
    cargs = (tab.data_ptr(), 64, 2, ix.data_ptr(), 32, out8.data_ptr())
    host = {}
    for label, fn in (
            ("kernels.launch", lambda: kernels.launch("gather_rows", dev,
                                                      *cargs)),
            ("gather_rows", lambda: gather.gather_rows(tab, ix)),
            ("index_select", lambda: torch.index_select(
                tab.view(torch.int32), 0, ix))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(LAUNCH_CALLS):
            fn()
        host[label] = (time.perf_counter_ns() - t0) / LAUNCH_CALLS / 1e3
        torch.cuda.synchronize()
    print(f"host us per call over {LAUNCH_CALLS} (64x2 table, 32 lanes): "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))

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
