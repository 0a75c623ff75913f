#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the port's CUDA
   kernels from vvr_tpu_torch/csrc (timed); fails if K11's kernels hold a
   global atomic (ATOMG, RED, REDG or ATOM in their SASS, sass_count.py)
   but in the cone grids' support pass (its 256 KB grid), or a fill or
   decode pass, if a K7 kernel's SASS has no HGMMA (wgmma) or
   any HMMA (mma.sync), if a K5 or K6 kernel spills (`-Xptxas -v`), or if
   a K6 kernel's SASS holds MUFU.RCP (the reciprocal of a division);
2. the main path: with every launch counter reset, builds the 256^3 world
   on the card from cold (timed) and renders frames of bench.py's
   default-knob configuration (1920x1080, face rasterizer for primary
   visibility, one hard shadow ray per lit pixel answered by the sun
   classifier, sky textures cached per 0.25 s bucket, bloom, ACES) through
   `Renderer.render`; reads the counters and fails unless each kernel of
   that path (K13 for the rays, K2 shade_pixel, K3, K4, K9, K10, K11, K12;
   K12 computes the shadow rays' starts, so K2 shade_surface and K1 must
   not run) was
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
   then soft and pixelated shadows (SOFT_FRAMES), each configuration's
   counters reset before its frames and read after: four jittered samples
   a lit pixel with the cone classifier (K11's cone grids once, K14 in its
   gate mode), the same through every sample's DDA (K14's DDA mode),
   pixelated shadows with four samples (K14) and with one (K2
   shade_surface from the quarter-voxel floor, then K1); fails unless
   each per-frame kernel, K13 included, launched once in every frame, or
   unless the cone frame equals the per-sample DDA frame byte for byte;
   then soft cone frames while the sun is dragged (the 512^2 cone grids,
   K11, and K3 in every frame beside K14); then config 4 (CONFIG4: four
   soft samples with the cone grids, four mirror bounces, the filtered
   AO; `mirror_materials=True`), its counters reset before its frames and
   read after: fails unless K13, K9, K10 and K4 launch once a frame, K14
   and K15 once a bounce, K1 once a bounce after the first, K11's cone
   grids once, K3 once a sky bucket and nothing else; prints its median
   and, under torch.profiler, its device time per kernel and K15's per
   bounce; then frames with point lights set near the view's surface
   and wavy reflections (LIGHTS_FRAME: hard shadows, so K12 at every
   bounce), counted the same way;
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
   K13's rays bit-exact against the plain version run on the CPU at
   RAY_SIZES and its device time back to back and with the L2 flushed,
   and camera_rays on the card one K13 launch with no host-to-device copy
   (a CUDA graph, torch.profiler); K11's cone grids (the kernel's
   tight boxes) bit for bit against the plain cone build over the present
   boxes at 2048^2 and 512^2 under two suns, and the cone build's device
   time split into its support pass and the rest (launch order,
   torch.profiler); K14 at 1920x1080 as the frame calls it, with four
   samples in its DDA mode, its cone-gate mode and pixelated (and
   pixelated with one sample), and in those three modes at odd shapes
   (SOFT_ODD) with SOFT_ODD_SAMPLES samples: every sample's hit equal to the
   plain version's on the card, the factor within SOFT_FACTOR_TOL of the
   plain factor computed on the CPU from those hits, and the gate mode's
   hits and factor equal to the DDA mode's on every lane; K14's time
   against a copy without its sample traces (tools/k14_split.py) in each
   mode; config 4 at 1920x1080 through render_frame with every bounce's
   K15 held to shade_bounce_plain on copies of that bounce's inputs
   (alpha, the continuation and the rgb of every lane but the shaded
   hits bit for bit, those within BOUNCE_TOL), with each bounce's live,
   hit, mirror and shaded lanes; the cone ("auto") frame against the
   per-sample DDA ("off") frame: the same rays at every bounce, each
   sample hit of a shaded lane equal but at C8 ties, each printed with
   the oracle's answer, and the HDR equal off those lanes; the kernel
   path's frame against the plain path's on the card (every wrapper's
   plain version, no launch): alpha equal, HDR within rtol=atol=1e-4;
   the lights frame the same way (K15 every bounce, kernel path against
   plain path) and against the frame with its lights far away; the AO
   frame without mirrors (K15 once, in place of K2) the same way;
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
7. config 5 (tools/bench_scale.py:62-97 without its edits: the 1024^3
   world, 1920x1080, its camera; `traversal="auto"`, so the paged grid):
   builds one 1024^3 scene and prints each setup step's host time (world
   generation, assemble_dense, the merged faces, the paged grid, the
   density field), then over it, each configuration's counters reset
   before its frames and read after (C5_PHASES): the default-knob frame,
   the DDA frame, the soft cone frame, config 4's knobs and the lights
   frame; fails unless each per-frame kernel launched as that table says
   (K16 `paged_trace` for every DDA, the paged K12, K14 and K15), K11 once
   where the frame classifies, K3 once, and nothing else (no K1, no
   jump-grid K12, K14 or K15), or unless the Renderer builds no jump grid;
   prints each median and a profiled window (device busy, K16's device
   time); then K16 bit for bit against trace_paged_plain on the primary
   and the shadow rays (one sun direction) at 1920x1080 and 33x67, with
   and without counters, flat and tiled, with the rays at the cap; the
   raster against K16 on every primary ray, each ray where they differ
   printed with the oracle's answer; the paged K12 against its plain
   version and against an every-lane K16 shadow trace on every lit lane
   (C6 at 1024^3); the paged K14 in its three modes as in 4., and its cone
   gate's hits equal to its DDA mode's; the paged K15 at every bounce of
   config 4's knobs and of the lights frame (BounceCheck); rows for the
   kernels line (K16 on the primary and on the shadow rays, paged K12 on
   the raster hits, paged K14's cone gate, paged K15 at the lights frame's
   bounce 0) and the peak device
   memory (run before 6.);
8. the dynamic world (ROADMAP A12; tools/bench_scale.py:61-150), on a
   copy of the 256^3 world's chunks (the jump grid) and then on config
   5's (the paged grid): a WorldEditor over the chunks builds the grid
   and the region faces the scene takes, `Renderer(...,
   dynamic_world=True)` the sparse voxel texture; each setup step timed;
   a radius-3 ball on the surface where the centre ray lands is added,
   removed, added, then added and removed in turn, `apply_edits` and a
   frame a step, counters reset before the steps and read after: fails
   unless every per-frame kernel and K17 launched once a step, K18 once an
   edit, and nothing else (no sun grids, no sky), or unless after each
   edit the frame equals one with K11's grids rebuilt from the patched
   faces, byte for byte, and the raster's hits equal the trace's on the
   patched grid but at ties the oracle takes the raster's way; prints
   each edit's timings and frame time, the median, and under
   torch.profiler a window of steps' device busy time and K17's and K18's
   device time; then fails unless the editor's occupancy equals the
   script's own copy, and the patched grid answers like a fresh build
   (the jump grid's rows equal; K16 on the patched paged grid gives every
   primary ray's hit, face, axis_coord and t of a fresh build); K17 on
   three bricks (one at the world's far edge) and twice on one, and K18
   on fresh hard and cone grids (one launch, its rectangles formed on the
   card equal to `texel_rects`'), against their plain versions byte for
   byte; their rows for the kernels line (K18 from the positions, its
   device time, the whole `invalidate_sun_texels` call and its library
   call `index_put_` of the texel list, in one call);
9. the brick pyramid (ROADMAP A13, `traversal="pyramid"`; run before 7.)
   over the 256^3 scene: prints the registers and spills of every kernel
   that runs the HDDA (K19, the pyramid forms of K12, K14, K15, K23) and
   fails if one spills to local memory; builds the pyramid on the card
   (timed) and holds it to the CPU build row for row; renders the frames
   of PYR_PHASES (the default knobs, the DDA frame, soft cone and DDA,
   pixelated, config 4's knobs, the lights frame, the overlap AO frame and
   the five debug heatmaps) through `Renderer.render`, counters reset
   before each and read after: fails unless each launched as that table
   says (K19 for every DDA, the pyramid forms of K12, K14 and K15, K21
   once a debug frame, no bloom there, no K1), K11 once where the frame
   classifies, K3 once, and unless every pyramid form ran at the pyramid's
   own cap (traversal_max_steps) and K19 walked the any masks by 8x4
   tiles, its counters written only for a heatmap's primary rays; prints
   each median and a profiled window of the DDA frame; then K19 bit for
   bit against trace_pyramid_plain on the primary and the shadow rays at
   1920x1080 and 33x67, with and without counters, flat and tiled, with
   and without the FULL early-out, and at a cap most rays reach (the lower
   quartile of the primary rays' steps), printing the share of the fetches
   the masks a ray holds answer (the plain walk's `answered`); K19's hits
   against K1's on every primary ray, each ray where they differ printed
   with the numpy oracle's answer (an exact tie, the oracle's answer one
   of the two) or counted as capped by the pyramid's steps; each pyramid
   frame of PYR_VS_JUMP against the jump grid's frame of the same knobs
   (the cone frames against its per-sample DDA frames), call by call: the
   same rays at every DDA call, K12's answers and K14's sample hits equal,
   every lane where they part a printed tie or capped ray, the HDR equal
   on every other pixel; K21's five images, K20's overlap_ao, cube and
   planar densities on the primary hits (the overlap library's entry
   points, counters reset: its path's launches) and overlap_ao through the
   jump grid's voxels, the pyramid K12 (and an every-lane K19 shadow trace
   but on capped lanes), the pyramid K14 in its three modes (the cone
   gate's hits equal to its DDA mode's), the pyramid K15 at every bounce
   of config 4's knobs, the lights frame and the overlap AO frame
   (BounceCheck), each against its plain version; the kernel path's frames
   against the plain path's; rows for the kernels line (K19 on the primary
   and the shadow rays, the pyramid K12, K14's cone gate, K15 at the
   overlap AO frame's bounce 0, K20's overlap_ao, K21's world image) with
   their device time (torch.profiler) and a launch's time with the L2
   cache flushed before it (`flushed_us`); and in 7., at 1024^3, builds
   config 5's pyramid on the card (timed, its size) and holds K19 on the
   primary rays to its plain version and to K16 (ties printed with the
   oracle, capped rays counted).
10. the raster debug view (ROADMAP A14, debug_type 0; run after 9.):
   meshes the 256^3 world (surface nets, host, timed; its vertices and
   triangles) and, at 1920x1080 on the bench camera, a camera 1.6 voxels
   above the ground (triangles wider than a tile) and one whose near
   plane cuts the terrain (straddlers; `raster_views`), prints the
   straddlers and holds K22 `raster_triangles` to its plain version
   (z-buffer bits and winner equal) and K23 `shade_raster` to its plain
   version (the covered pixels' HDR equal, the sky within K3's rtol 1e-4),
   and the kernel path's frame to the plain path's (a covered pixel may
   flip, or a sky pixel take another texel, only where the plain rays,
   torch on the card, differ from K13's); renders RASTER_FRAMES frames
   through `Renderer.render`, counters reset before and read after, and
   fails unless K13, K22, K3, K23 and K4 each launched once a frame and
   nothing else, and no plain version ran; prints their median, a
   profiled window (device busy, each kernel's device time) and the rows
   of K22 and K23 for the kernels line (device time from torch.profiler,
   K22's the sum of its six kernels); and, after 7., one raster frame of
   1024^3 on config 5's chunks and camera (the pyramid built on the card,
   the mesh's host time, its triangles, K22's and K23's device time).
11. setup and the app (ROADMAP A15, B9; run after 8.): K24
   `height_field` bit for bit against its plain version run on the card
   and on the host's CPU at 256^2 and 1024^2 (the differing columns
   printed, 0), with its time, device time, bound and share; the 256^3
   and 1024^3 worlds generated from cold (`build_scene`,
   force_regenerate), counters reset before each, failing unless K24
   launched once a world, each step's host time printed beside the plain
   torch world's (PERF.md section 5); each world's SVO tree
   (`Scene.ensure_tree`, flattened on the card), failing unless
   `verify_popcount_invariant` passes and every node's bitmask equals
   the any mask of its cell in the scene's brick pyramid, its node
   counts per level printed; then
   `App(Renderer(...))` at 256^3 and 1920x1080 with the default knobs on
   a scripted flight from APP_START (APP_SEGMENTS: W/A/S/D with boost, H
   through all seven views, then G, the middle-mouse drag turning the
   sun every frame, L until its 2 s capture ends, J, U, O, I, then Q),
   counters reset before each segment and read after: fails unless each
   segment launched what its view's frame needs once a frame (APP_VIEW:
   the default frame's kernels, the raster view's, the heatmaps' with
   K21), K11 (512^2) and K3 once in every dragged frame, and nothing
   else; prints each segment's median frame time.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result. Before the last line
it prints {"kernels": [...]}, one row per kernel with its launches (from
the path that runs it), error against its plain version, times and bound
(K11 four times: `sun_grids` at 2048^2 with the main path's launches,
`sun_grids_512` with the dragged frames', `sun_grids_cone` at 2048^2 with
the cone frames', `sun_grids_cone_512` with the dragged soft frames', the
cone rows' bounds from the kernel's tight boxes; K14 three times:
`soft_shadow` in its DDA mode,
`soft_shadow_cone`, `soft_shadow_pixelated`, each with its frames'
launches; K14's bound counts this run's DDA sub-steps of its samples;
K15 twice: `shade_bounce` at config 4's bounce 0 with its frames'
launches, `shade_bounce_lights` at the lights frame's bounce 0, its
bound counting the lights' DDA sub-steps; K16 twice, `paged_trace` with
config 5's traces but the DDA frame's shadow rays, and
`paged_trace_shadow` with those; K17 and K18 with the launches
of config 5's dynamic steps; K19 twice, `pyramid_trace` and
`pyramid_trace_shadow`, with the pyramid forms of K12, K14 and K15, K20
`overlap_density` and K21 `debug_image`, and K22 `raster_triangles` and
K23 `shade_raster` with the raster frames' launches, each also with its
device time; K24 `height_field` with the main path's launch, its world
from cold);
the last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
                "raster_resolve": 45, "sun_grids": 90, "masked_shadow": 60,
                "generate_rays": 75, "soft_shadow": 140,
                "shade_bounce": 340, "pyramid_trace": 40,
                "overlap_density": 25, "debug_image": 40}
# K13's 75 per pixel: two IEEE divisions (11 each), a correctly rounded
# sqrtf (6) and three more divisions, and the sums and products of u, v
# and the direction. K14's 140 per (lit pixel, sample): the jitter (two
# hash chains, three divisions, a sqrtf, powf about 30), the start and the
# cloud texel; each DDA sub-step of its samples, and each near-walk step,
# at jump_trace's rate. K11's support pass: 25 per (face, coarse texel)
# pair (four affine corners, their least, the clamp). K15's 340 per lane:
# shade_pixel's 250, the mirror hash (20), the AO's eight taps, trilinear
# weights and powf (70); each (lane, light) pair within reach 40 (a
# sqrtf, a division, the smoothstep and n.l), each of its DDA sub-steps at
# jump_trace's rate.
SUN_SUPPORT_OPS = 25
LIGHT_OPS = 40
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
RAY_CALLS = 20          # camera_rays calls under the profiler
# K13's shapes held to the plain version: the frame's, an odd one, and
# three whose last span ends inside a float4 (1x1, 5x3, 257x3)
RAY_SIZES = ((1920, 1080), (33, 67), (1, 1), (5, 3), (257, 3))
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
ROW_KERNEL = {"sun_grids_512": "sun_grids", "sun_grids_cone": "sun_grids",
              "pyramid_trace_shadow": "pyramid_trace",
              "paged_trace_shadow": "paged_trace",
              "shade_bounce_lights": "shade_bounce",
              "sun_grids_cone_512": "sun_grids",
              "soft_shadow_cone": "soft_shadow",
              "soft_shadow_pixelated": "soft_shadow"}
# the soft-shadow frames (phase 3c): four jittered samples a lit pixel with
# the cone classifier, the same through every sample's DDA, pixelated
# shadows with four samples and with one
SOFT_FRAMES = {"soft, cone": dict(shadow_samples=4),
               "soft, DDA": dict(shadow_samples=4, sun_mask="off"),
               "pixelated, 4 samples": dict(shadow_samples=4,
                                            pixelated_shadows=True),
               "pixelated, 1 sample": dict(shadow_samples=1,
                                           pixelated_shadows=True)}
SOFT_SAMPLES = 4
# config 4 (BASELINE.md:29-32, tools/bench_scale.py:33-50) with mirror
# materials: four soft samples, four bounces, the filtered AO; and the
# frame with the point lights and wavy reflections, with hard shadows (the
# sun classifier, K12, at every bounce)
CONFIG4 = dict(shadow_samples=4, max_ray_iterations=4,
               ambient_occlusion=True)
LIGHTS_FRAME = dict(shadow_samples=1, max_ray_iterations=3,
                    ambient_occlusion=True, point_lights=True,
                    wavy_reflections=True)
LIGHTS_FRAMES = 4    # timed frames of the lights phase
# K15's shaded lanes against plain (the lighting's and the AO's powf
# against pow); every other lane and output bit for bit
BOUNCE_TOL = 1e-5
# K14's odd shapes: a small image by tiles, flat lanes (width 0), and the
# sample counts: powers of two and not, one for each of K14's lane groups
# (1, 2, 4, 8, 16 and 32 lanes a pixel), and 33 for rounds of more samples
# than a warp's lanes
SOFT_ODD = ((33, 67), 4099)
SOFT_ODD_SAMPLES = (1, 2, 3, 4, 5, 9, 33)
# K14's factor against its plain version on the CPU (from the same
# per-sample hits): the strength powf(cos, 40) on the card and pow on the
# CPU may differ by a few ulps, within this
SOFT_FACTOR_TOL = 1e-5
# name parts of K11's device kernels (and the scans it shares with K9), and
# of its cone grids' support pass
K11_SASS = ("vvr_sun_", "vvr_scan_")
K11_SUPPORT = "vvr_sun_support_kernel"
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


def sample_ties(softshadow, trace_dense, occ, hits, h_gate, h_dda, sun_d,
                width: int, label: str, used=None) -> list[int]:
    """The lanes where K14's cone gate and its per-sample DDA disagree on a
    sample's hit (S, N), on the hits `hits`, among the lanes `used` (N,)
    bool whose shadow the frame shades with (all if None): each such
    sample ray must cross an exact tie that the jump-grid DDA takes the
    other way (ROADMAP C8), the numpy oracle agreeing with the gate's near
    walk. Prints each with the oracle's answer, and how many lanes outside
    `used` disagree; returns the lanes, sorted."""
    import torch
    off = h_gate != h_dda
    if used is not None:
        unused = int((off.any(0) & ~used).sum())
        print(f"{label}: the cone gate and the DDA disagree on {unused} "
              "lanes whose shadow the frame does not use (mirror lanes; "
              "ROADMAP C13)")
        off = off & used
    ties = torch.nonzero(off).cpu().numpy()
    p_q = softshadow.query_points(*hits, sun_d, False)[0]
    for k, lane in ties:
        q = p_q[lane:lane + 1].unbind(1)
        dirs = softshadow.sample_dir(int(k), *q, sun_d)[:3]
        start = torch.stack(softshadow.ray_start(*q, *dirs, sun_d), -1)
        ora = trace_dense(occ, start.cpu().numpy(),
                          torch.stack(dirs, -1).cpu().numpy())
        check(bool(ora["hit"][0]) == bool(h_gate[k, lane]),
              f"{label}: sample {k} of lane {lane}: the cone gate says "
              f"{'hit' if h_gate[k, lane] else 'miss'}, the DDA and the "
              "oracle the other")
        print(f"{label}: sample {k} of lane {lane} (pixel {lane % width}, "
              f"{lane // width}), start {start[0].tolist()}: the DDA "
              f"{'hits' if h_dda[k, lane] else 'misses'}, the cone gate "
              f"and the numpy oracle say "
              f"{'hit' if h_gate[k, lane] else 'miss'} (an exact tie)")
    return sorted({int(lane) for _, lane in ties})


@contextlib.contextmanager
def plain_path(kernels):
    """Within it every wrapper runs its plain torch version, on the card
    too: the frame's plain path, its tensors where the kernels' are."""
    on_cuda = kernels.on_cuda
    kernels.on_cuda = lambda where: False
    try:
        yield
    finally:
        kernels.on_cuda = on_cuda


@contextlib.contextmanager
def recorded_soft(frame_mod, calls: list):
    """Within it the frame's K14 calls also return each sample's hit: each
    call appends (its hits (o, d, hit, face, axis_coord), copied, the
    sample hits (S, N)) to `calls`."""
    soft_shadow = frame_mod.soft_shadow

    def rec(*args, **kw):
        factor, hits_s = soft_shadow(*args, with_hits=True, **kw)
        calls.append((tuple(t.clone() for t in args[1:6]), hits_s))
        return factor

    frame_mod.soft_shadow = rec
    try:
        yield
    finally:
        frame_mod.soft_shadow = soft_shadow


def rows_bytes(grid, label: str, run) -> float:
    """The bytes of the distinct table rows a kernel's work loads:
    `run(read)` runs its plain version with `rows_read=read` (one bool
    tensor per table, ops/trace.py `trace_plain`), which marks every row
    it loads; ROW_READ bytes a row. Prints the counts."""
    import torch

    from vvr_tpu_torch.ops import trace as tracer
    read = tuple(torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
                 for t in tracer.tensors(grid))
    run(read)
    tables = ROW_READ[tracer.kind(grid)]
    counts = [int(r.sum()) for r in read]
    print(f"{label}: loads " + " and ".join(
        f"{c} of {r.numel()} {name}" for c, r, (name, _) in
        zip(counts, read, tables)))
    return float(sum(c * b for c, (_, b) in zip(counts, tables)))


def k15_bytes(n: int, live: int, hits: int, mirrors: int, shaded: int,
              first: bool, shadow, ao: bool, mirror: bool) -> int:
    """The bytes one K15 launch over `n` lanes must move, from its lane
    counts: the live lanes' rays and hit flags (and colours after bounce
    0); the hits' face and axis_coord; the shaded hits' shadow and, with
    AO, the eight u8 taps they read; the HDR out, every lane's four
    channels at bounce 0 (the image is not cleared before) and after it
    the rgb of the shaded and missed lanes and the misses' alpha; with
    mirrors the mirror lanes' continuation (origin, direction, colour, 36
    B) and the live lanes' flags, every lane's at bounce 0; after bounce
    0 one flag byte of every lane read. The textures and the density
    field stay in L2: only the AO taps are counted."""
    miss = live - hits
    moved = (live * (24 + 1) + hits * 8
             + shaded * ((0 if shadow is None else shadow.element_size())
                         + (8 if ao else 0)))
    if first:
        moved += n * 16
    else:
        moved += n + live * 12 + (shaded + miss) * 12 + miss * 4
    if mirror:
        moved += mirrors * 36 + (n if first else live)
    return moved


class BounceCheck:
    """Within `with BounceCheck(...)`, each K15 call of the frame is held to
    shade_bounce_plain on copies of its inputs (every bounce's real
    inputs): alpha, the continuation (rays, colours, live flags) and the
    rgb of every lane that is no shaded hit bit for bit, the shaded hits'
    rgb (powf against pow) within BOUNCE_TOL. `bounces` gets, per call,
    (live lanes, hits, mirrors, shaded, rgb max |diff|, shaded lanes not
    bit-equal, k15_bytes); `first` the first call's arguments, its output and
    continuation buffers copied (to time K15 on them)."""

    def __init__(self, frame_mod, bounce_mod, kernels):
        self.frame_mod, self.bounce, self.kernels = (frame_mod, bounce_mod,
                                                     kernels)
        self.bounces, self.first = [], None

    def __enter__(self):
        self.orig = self.frame_mod.shade_bounce
        self.frame_mod.shade_bounce = self.call
        return self

    def __exit__(self, *exc):
        self.frame_mod.shade_bounce = self.orig

    def call(self, *args):
        import torch
        (grid, o, d, hit, face, ac, shadow, skybox, clouds, sun, sun_col,
         out, col, active, pix, dens, lights, ms, mirror, wavy, t,
         nxt, ov) = args
        if self.first is None:
            self.first = args[:11] + (out.clone(), col, active) + args[14:21] \
                + ((tuple(x.clone() for x in nxt),) if nxt else (None,)) \
                + (ov,)
        out_p = out.clone()
        nxt_p = tuple(x.clone() for x in nxt) if nxt else None
        live = (torch.ones_like(hit) if active is None else active.clone())
        ins = (o, d, col, active) if active is None else nxt_p
        self.bounce.shade_bounce_plain(
            grid, ins[0], ins[1], hit, face, ac, shadow, skybox, clouds, sun,
            sun_col, out_p, ins[2], ins[3], pix, dens, lights, ms, mirror,
            wavy, t, nxt_p, ov)
        launched = self.kernels.LAUNCHES
        forms = ("shade_bounce", "shade_bounce_paged",
                 "shade_bounce_pyramid")
        before = sum(launched[f] for f in forms)
        self.orig(*args)
        check(sum(launched[f] for f in forms) == before + 1,
              "K15 did not launch once")
        k = len(self.bounces)
        a, b = out.view(4, -1), out_p.view(4, -1)
        check(torch.equal(a[3], b[3]), f"K15 bounce {k}: alpha differs on "
              f"{int((a[3] != b[3]).sum())} lanes")
        hits = hit & live
        mirrors = (nxt_p[3] & live) if nxt else torch.zeros_like(hits)
        shaded = hits & ~mirrors
        if nxt:
            for name, x, y in zip(("origins", "directions", "colours",
                                   "live flags"), nxt, nxt_p):
                lanes = int((x != y).reshape(x.shape[0], -1).any(1).sum())
                check(torch.equal(x, y), f"K15 bounce {k}: {name} differ "
                      f"on {lanes} lanes")
        rgb_off = (a[:3] != b[:3]).any(0)
        check(not bool((rgb_off & ~shaded).any()), f"K15 bounce {k}: rgb "
              f"differs on {int((rgb_off & ~shaded).sum())} lanes that are "
              "no shaded hit")
        diff = float((a[:3] - b[:3]).abs().max())
        check(bool(torch.isclose(a[:3], b[:3], rtol=BOUNCE_TOL,
                                 atol=BOUNCE_TOL).all()),
              f"K15 bounce {k}: rgb differs beyond {BOUNCE_TOL} (max |diff| "
              f"{diff})")
        counts = (int(live.sum()), int(hits.sum()), int(mirrors.sum()),
                  int(shaded.sum()))
        self.bounces.append(counts + (
            diff, int((rgb_off & shaded).sum()),
            k15_bytes(hit.numel(), *counts, active is None, shadow,
                      dens is not None, bool(nxt))))


# config 5 (tools/bench_scale.py:62-97) without its edits: the reference's
# own 1024^3 world (depth 5), 1920x1080, its camera (:96-97); the paged
# grid under traversal "auto". Its frames over one scene: the default
# knobs, the DDA frame, the soft cone frame, config 4's knobs and the
# lights frame; each configuration's kernels a frame (K3 and K11 apart)
C5_CAMERA = ([512.0, 400.0, 80.0], [512.0, 80.0, 720.0], 85.0)
C5_FRAMES = 6        # timed frames a configuration, after a warm-up
_C5_RASTER = {"generate_rays": 1, "raster_fragments": 1,
              "raster_resolve": 1, "bloom_pyramid": 1, "composite": 1}
C5_PHASES = {
    "config 5": ({}, False, {**_C5_RASTER, "masked_shadow_paged": 1,
                             "shade_pixel": 1}),
    "config 5 DDA": (dict(primary_raster="off", sun_mask="off"), False,
                     {"generate_rays": 1, "paged_trace": 2,
                      "shade_surface": 1, "shade_pixel": 1,
                      "bloom_pyramid": 1, "composite": 1}),
    "config 5 soft cone": (dict(shadow_samples=4), False,
                           {**_C5_RASTER, "soft_shadow_paged": 1,
                            "shade_pixel": 1}),
    "config 5 config-4 knobs": (CONFIG4, True, {
        **_C5_RASTER, "soft_shadow_paged": 4, "paged_trace": 3,
        "shade_bounce_paged": 4}),
    "config 5 lights": (LIGHTS_FRAME, True, {
        **_C5_RASTER, "masked_shadow_paged": 3, "paged_trace": 2,
        "shade_bounce_paged": 3}),
}
# K16's oracle slack: primary rays where the raster (the oracle's answer)
# and K16 differ (an exact x/z tie the paged DDA places as the JAX tracer
# does, ROADMAP C8)
K16_ORACLE_SLACK = 64
# the tables of each grid, and the bytes of a row of each that a kernel
# needs (a bound counts each distinct row its plain version records
# loading once, rows_bytes): a jump-grid row's 16 voxel words, its
# subcell words 16-19 and the four octant distances of the ray's half (96
# of its 128 B); a page row's words 0-3 (mask, pool base, octant radii:
# one 16-byte load); a pool row's words 0-17 (voxel words, subcell mask)
ROW_READ = {"jump": (("rows", 96),),
            "paged": (("page rows", 16), ("pool rows", 72)),
            "pyramid": (("node rows", 8),)}


def config5_phase(repo, dev, errs: dict, launches: dict):
    """Phase 7 (module docstring): the 1024^3 scene built once, each setup
    step timed; the frames of C5_PHASES, counters reset before each
    configuration and read after; then K16, the paged K12, K14 and K15
    against their plain versions. Returns the kernels line's rows of the
    paged kernels and the world's chunks (phase 8 edits them); fills
    `errs` and `launches`."""
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import bounce, paged, shade, softshadow
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops import trace as tracer
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import frame as frame_mod
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.tools import profile_frame
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import cuda_ms
    from vvr_tpu_torch.utils.camera import Camera

    # the registers and spills of K16 and of every paged instantiation
    # (their jump-grid twins are printed with their kernels' checks)
    for name, regs, st, ld in kernels.ptxas_usage("vvr_"):
        if "VvrPagedView" in name:
            print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
    wcfg = WorldConfig(depth=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    setup = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        setup[label] = time.perf_counter() - t0
        return out

    scene = timed("world generation", lambda: build_scene(
        wcfg, dev, force_regenerate=True,
        cache_path=repo / "build" / "vvr_tpu_torch" / "map_1024.npz"))
    occ = timed("assemble_dense", scene.dense)
    faces = timed("merged faces", scene.ensure_faces)
    grid = timed("paged grid", scene.ensure_paged)
    timed("density field", scene.ensure_density)
    print("setup (config 5, 1024^3, host clock): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in setup.items()) + f"; "
        f"{faces[0].shape[0]} merged faces, page table "
        f"{tuple(grid.prows.shape)}, pool {tuple(grid.brows.shape)}, "
        f"{grid.memory_bytes() / 2**20:.2f} MiB")
    cfg = RenderConfig(width=1920, height=1080, shadow_samples=1,
                       max_ray_iterations=3)
    check(cfg.use_paged(wcfg.size) and not cfg.use_jump(wcfg.size),
          "traversal 'auto' must resolve to the paged grid at 1024^3")
    cam = Camera.look_at(*C5_CAMERA[:2], fov=C5_CAMERA[2])
    w, h, n = cfg.width, cfg.height, cfg.width * cfg.height
    max_steps = cfg.traversal_max_steps * 8
    o, d = camera_rays(cam, w, h, dev)
    first = paged.trace_paged(grid, o, d, max_steps, width=w, stats=False)
    seeded = np.random.default_rng(11).choice(
        torch.nonzero(first.hit)[:, 0].cpu().numpy(), 10, replace=False)
    scene.lights[:10, :3] = (o + d * (first.t[:, None] - 2.0))[
        seeded].cpu().numpy()
    lights0 = scene.lights.copy()

    # ---- the frames; K16's launch arguments recorded (a shadow trace
    # has one direction for every ray, a direction stride of 0)
    rend, meds = {}, {}
    k16 = []
    launch = kernels.launch

    def recorded(name, device, *args):
        if name == "paged_trace":
            k16.append(args)
        launch(name, device, *args)

    kernels.launch = recorded
    try:
        for label, (knobs, mirrors, per_frame) in C5_PHASES.items():
            scene.lights[:] = lights0
            k16.clear()
            kernels.reset_launches()
            r = Renderer(wcfg, dataclasses.replace(cfg, **knobs),
                         device=dev, scene=scene, mirror_materials=mirrors)
            check(r.use_paged and r.grid is grid
                  and scene.jumpgrid is None, f"{label}: the Renderer must "
                  "trace the scene's paged grid and build no jump grid")
            ms = []
            for i in range(C5_FRAMES + 1):   # frame 0 warms up (K11, K3)
                t1 = time.perf_counter()
                img = r.render(cam, time=i / 60.0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            check(tuple(img.shape) == (h, w, 3)
                  and float(img.float().std()) > 10, f"{label}: the frame "
                  "is wrong")
            got = dict(kernels.LAUNCHES)
            shadow = sum(a[6] == 0 for a in k16)
            primary = sum(a[6] != 0 for a in k16)
            frames_ = C5_FRAMES + 1
            uneven = {k: got[k] for k, v in per_frame.items()
                      if got[k] != v * frames_}
            check(not uneven, f"{label}: kernels not launched {per_frame} "
                  f"times a frame over {frames_} frames: {uneven}")
            check(primary + shadow == got["paged_trace"], f"{label}: "
                  f"{primary + shadow} K16 launches recorded, "
                  f"{got['paged_trace']} counted")
            # the DDA frame traces its shadow rays, one launch a frame
            dda = knobs.get("sun_mask") == "off"
            check(shadow == (frames_ if dda else 0), f"{label}: {shadow} "
                  f"K16 shadow launches over {frames_} frames")
            once = [] if knobs.get("sun_mask") == "off" else ["sun_grids"]
            for k in once:
                check(got[k] == 1, f"{label}: {k} launched {got[k]} times")
            check(got["write_sky"] == 1, f"{label}: K3 launched "
                  f"{got['write_sky']} times in one sky bucket")
            others = {k: v for k, v in got.items() if v and k not in
                      per_frame and k not in once and k != "write_sky"}
            check(not others, f"{label}: launched {others} (the flat K1 and "
                  "the jump-grid forms of K12, K14 and K15 must not run)")
            for k, v in got.items():
                if (k in per_frame or k in once) and k != "paged_trace":
                    launches[f"c5 {k}"] = launches.get(f"c5 {k}", 0) + v
            # K16's rows from the record: the primary and the shadow traces
            for k, v in (("paged_trace", primary),
                         ("paged_trace_shadow", shadow)):
                launches[f"c5 {k}"] = launches.get(f"c5 {k}", 0) + v
            meds[label] = sorted(ms[1:])[C5_FRAMES // 2]
            print(f"{label}: {C5_FRAMES} frames after a warm-up of "
                  f"{ms[0]:.1f} ms (K11 and K3), median "
                  f"{meds[label]:.3f} ms (host clock, synchronized); "
                  f"launches { {k: v for k, v in got.items() if v} }, "
                  f"{shadow} of K16's on shadow rays")
            rend[label] = r
            profile_frame.window(label, r, cam, repo / "build"
                                 / "vvr_tpu_torch" / "c5_trace.json")
    finally:
        kernels.launch = launch
    scene.lights[:] = lights0

    # ---- K16 against its plain version: primary and shadow rays at
    # 1920x1080 and 33x67, with and without counters, flat and tiled
    fields = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
              "missed_pops")
    sun_np = rend["config 5"].sun[:3].copy()
    sun3 = torch.from_numpy(sun_np)
    sun_d = sun3.to(dev)

    def k16_check(ro, rd, ra, width, label):
        full = paged.trace_paged(grid, ro, rd, max_steps, active=ra)
        ref = paged.trace_paged_plain(grid, ro, rd, max_steps, ra)
        lean = paged.trace_paged(grid, ro, rd, max_steps, active=ra,
                                 width=width, stats=False)
        for f in fields:
            check(torch.equal(getattr(full, f), getattr(ref, f)),
                  f"K16 ({label}): {f} differs from plain on "
                  f"{int((getattr(full, f) != getattr(ref, f)).sum())} rays")
        for f in fields[:4]:
            check(torch.equal(getattr(lean, f), getattr(ref, f)),
                  f"K16 ({label}, tiled, no counters): {f} differs")
        capped = int((full.iterations >= max_steps).sum())
        print(f"K16 ({label}): {ro.shape[0]} rays, hits "
              f"{int(full.hit.sum())}, bit-exact vs plain (seven outputs; "
              f"tiled without counters the four); sub-steps mean "
              f"{float(full.iterations.float().mean()):.2f} max "
              f"{int(full.iterations.max())}, fetches mean "
              f"{float(full.fetches.float().mean()):.2f}; rays at the "
              f"{max_steps} cap: {capped}")
        return full, capped

    res_k, cap_p = k16_check(o, d, None, w, "primary, 1920x1080")
    so_k, sa_k = shade.shade_surface(o, d, res_k.hit, res_k.face,
                                     res_k.axis_coord, sun3)
    sh_k, cap_s = k16_check(so_k, sun_d, sa_k, w, "shadow, 1920x1080, one "
                            "sun direction")
    o_s, d_s = camera_rays(cam, 33, 67, dev)
    r_s, _ = k16_check(o_s, d_s, None, 33, "primary, 33x67")
    so_s, sa_s = shade.shade_surface(o_s, d_s, r_s.hit, r_s.face,
                                     r_s.axis_coord, sun3)
    k16_check(so_s, sun_d, sa_s, 33, "shadow, 33x67")
    errs["paged_trace"] = errs["paged_trace_shadow"] = 0.0

    # the raster against K16 on every primary ray, each ray where they
    # differ against the numpy oracle
    rcam = rt.raster_camera(cam)
    probe = scene.solid_at_host(cam.position)
    ras = rt.trace_raster(faces, rcam, d, probe, wcfg.size, w, h)
    off = ((ras.hit != res_k.hit) | (ras.hit & (
        (ras.face != res_k.face) | (ras.axis_coord != res_k.axis_coord))))
    bad = torch.nonzero(off)[:, 0].cpu().numpy()
    check(len(bad) <= K16_ORACLE_SLACK, f"the raster and K16 differ on "
          f"{len(bad)} primary rays")
    if len(bad):
        ora = trace_dense(occ, o[bad].cpu().numpy(), d[bad].cpu().numpy())
        for k, ray in enumerate(bad):
            agree = (bool(ora["hit"][k]) == bool(ras.hit[ray])
                     and int(ora["axis_coord"][k]) == int(ras.axis_coord[ray]))
            check(agree, f"ray {ray}: the raster is not the oracle's answer")
            print(f"primary ray {ray} (pixel {ray % w}, {ray // w}): K16 "
                  f"hit {bool(res_k.hit[ray])} face {int(res_k.face[ray])} "
                  f"axis {int(res_k.axis_coord[ray])}; the raster and the "
                  f"oracle: hit {bool(ora['hit'][k])} face "
                  f"{int(ora['face'][k])} axis {int(ora['axis_coord'][k])} "
                  "(an exact tie, ROADMAP C8)")
    print(f"raster vs K16 at 1024^3: {n - len(bad)} of {n} primary rays "
          f"equal; {len(bad)} differ, each the oracle's tie (above)")

    # the brick pyramid of this world (traversal="pyramid" at 1024^3, as
    # the JAX renderer allows): built on the card from the dense
    # occupancy, K19 on the primary rays (the frame's form, and flat with
    # the counters) against its plain version and against K16, each ray
    # where they differ an exact tie or a ray the pyramid's walk caps
    from vvr_tpu_torch.ops import traverse
    from vvr_tpu_torch.world.pyramid import build_brick_pyramid
    t0 = time.perf_counter()
    pyr5 = build_brick_pyramid(occ, dev)
    torch.cuda.synchronize()
    t_pyr = time.perf_counter() - t0
    cap5 = cfg.traversal_max_steps
    k19_t = traverse.trace_pyramid(pyr5, o, d, cap5, width=w, stats=False,
                                   use_full=False)
    k19_s = traverse.trace_pyramid(pyr5, o, d, cap5, use_full=False)
    ans19 = (torch.zeros(pyr5.rows.shape[0], dtype=torch.int64, device=dev),)
    ref19 = traverse.trace_pyramid_plain(pyr5, o, d, cap5, use_full=False,
                                         answered=ans19)
    for f in fields:
        check(torch.equal(getattr(k19_s, f), getattr(ref19, f)),
              f"K19 at 1024^3: {f} differs from plain")
    for f in fields[:4]:
        check(torch.equal(getattr(k19_t, f), getattr(ref19, f)),
              f"K19 at 1024^3 (tiled, no counters): {f} differs")
    off19 = (ref19.hit != res_k.hit) | (ref19.hit & (
        (ref19.face != res_k.face) | (ref19.axis_coord != res_k.axis_coord)))
    capped19 = (ref19.iterations >= cap5) & ~ref19.hit
    ties19 = torch.nonzero(off19 & ~capped19)[:, 0].cpu().numpy()
    check(len(ties19) <= K16_ORACLE_SLACK, f"K19 and K16 differ on "
          f"{len(ties19)} uncapped primary rays at 1024^3")
    if len(ties19):
        ora = trace_dense(occ, o[ties19].cpu().numpy(),
                          d[ties19].cpu().numpy())
        for k, ray in enumerate(ties19):
            o_ans = ((int(ora["face"][k]), int(ora["axis_coord"][k]))
                     if ora["hit"][k] else "miss")
            mine = [((int(r.face[ray]), int(r.axis_coord[ray]))
                     if bool(r.hit[ray]) else "miss") for r in (ref19, res_k)]
            check(o_ans in mine, f"K19 ray {ray} at 1024^3: the oracle "
                  "agrees with neither K19 nor K16")
            print(f"primary ray {ray} at 1024^3: K19 {mine[0]}, K16 "
                  f"{mine[1]}, the numpy oracle {o_ans} (an exact tie)")
    print(f"pyramid at 1024^3: built on the card in {t_pyr:.2f} s (host "
          f"clock, from the dense occupancy), {tuple(pyr5.rows.shape)} "
          f"rows, {pyr5.memory_bytes() / 2**20:.2f} MiB; K19 on the {n} "
          f"primary rays bit-exact vs plain (seven outputs; the frame's "
          f"tiled form the four), steps mean "
          f"{float(ref19.iterations.float().mean()):.2f} max "
          f"{int(ref19.iterations.max())}, fetches "
          f"{float(ref19.fetches.sum()):.0f} of which the held masks answer "
          f"{float(ans19[0].sum()) / max(float(ref19.fetches.sum()), 1.0):.4f}"
          f"; against K16: "
          f"{int((off19 & capped19).sum())} rays capped by the pyramid's "
          f"{cap5} steps ({int(capped19.sum())} capped in all), "
          f"{len(ties19)} exact ties, the rest equal")
    del pyr5, k19_t, k19_s, ref19, ans19

    # the paged K12 on the raster hits: against its plain version and
    # against an every-lane K16 shadow trace on every lit lane (C6)
    hits = (o, d, ras.hit, ras.face, ras.axis_coord)
    e1, e2, s_b = ss.sun_basis(sun_np)
    grids_k = rend["config 5"]._sunmask()[2]
    ms_k = ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2, grids_k,
                                      max_steps)
    ms_p = ss.masked_shadow_from_hits_plain(grid, *hits, sun_np, e1, e2,
                                            grids_k, max_steps)
    check(torch.equal(ms_k, ms_p), f"paged K12 vs plain: "
          f"{int((ms_k != ms_p).sum())} lanes differ")
    so_r, sa_r = shade.shade_surface(*hits, sun3)
    every = paged.trace_paged(grid, so_r, sun_d, max_steps, active=sa_r,
                              width=w, stats=False).hit
    c6 = torch.nonzero((ms_k != every) & sa_r)[:, 0].cpu().numpy()
    for lane in c6:
        ora = trace_dense(occ, so_r[lane:lane + 1].cpu().numpy(),
                          sun_np[None])
        print(f"K12 lane {lane}: K12 {bool(ms_k[lane])}, the every-lane "
              f"K16 trace {bool(every[lane])}, the oracle "
              f"{bool(ora['hit'][0])}")
    check(len(c6) == 0, f"paged K12 and an every-lane K16 shadow trace "
          f"differ on {len(c6)} lit lanes (printed above)")
    branch = ss.shadow_branches(grid, so_r, sun_np, e1, e2, grids_k, sa_r)
    counts = torch.bincount(branch, minlength=len(ss.BRANCHES)).tolist()
    residue = branch == ss.BRANCHES.index("residue")
    res_it = paged.trace_paged(grid, so_r, sun_d, max_steps,
                               active=residue).iterations[residue]
    print(f"paged K12: {int(sa_r.sum())} lit lanes of {n} bit-exact vs "
          f"plain and vs an every-lane K16 shadow trace; branches "
          f"{dict(zip(ss.BRANCHES, counts))}; residue DDA sub-steps "
          f"{int(res_it.sum())}")
    errs["masked_shadow_paged"] = 0.0

    # the paged K14 in its three modes: every sample's hit equal to the
    # plain version's on the card, the factor within SOFT_FACTOR_TOL of the
    # plain factor on the CPU; the cone gate's hits equal to the DDA mode's
    # on every lane (no near walk on the paged grid, so no C8 tie between
    # them)
    _, cl_k = rend["config 5"]._sky(0.0)
    cl_cpu = cl_k.cpu()
    cone_k = rend["config 5 soft cone"]._sunmask()[2]
    gate = (e1, e2, cone_k)
    modes = {"DDA": (False, None), "cone gate": (False, gate),
             "pixelated": (True, None)}

    def k14_check(hits_, ns, pix, g, width, what):
        before = kernels.LAUNCHES["soft_shadow_paged"]
        fk, hk = softshadow.soft_shadow(grid, *hits_, sun_np, ns, cl_k,
                                        max_steps, pix, g, with_hits=True,
                                        width=width)
        check(kernels.LAUNCHES["soft_shadow_paged"] == before + 1,
              f"paged K14 ({what}) did not launch once")
        hp = softshadow.sample_hits_plain(grid, *hits_, sun_np, ns,
                                          max_steps, pix, g)
        check(torch.equal(hk, hp), f"paged K14 ({what}): "
              f"{int((hk != hp).sum())} sample hits differ from plain")
        fp = softshadow.shadow_factor_plain(
            *(t.cpu() for t in hits_), sun_np, hk.cpu(), cl_cpu, pix)
        err = float((fk.cpu() - fp).abs().max())
        check(err <= SOFT_FACTOR_TOL, f"paged K14 ({what}): factor off the "
              f"plain factor by {err}")
        return fk, hk, err

    soft = {}
    for name, (pix, g) in modes.items():
        soft[name] = k14_check(hits, SOFT_SAMPLES, pix, g, w, name)
        print(f"paged K14 ({name}): {SOFT_SAMPLES} sample hits of {n} "
              f"lanes equal to plain ({int(soft[name][1].sum())} hits), "
              f"factor max |diff| {soft[name][2]:.3e} vs plain on the CPU")
    check(torch.equal(soft["DDA"][1], soft["cone gate"][1]),
          f"paged K14: the cone gate's sample hits differ from the DDA "
          f"mode's on {int((soft['DDA'][1] != soft['cone gate'][1]).sum())}")
    # and at K14's odd shapes, as its jump-grid form is held (SOFT_ODD)
    ras_s = rt.trace_raster(faces, rcam, d_s, probe, wcfg.size,
                            *SOFT_ODD[0])
    flat = slice(n // 2, n // 2 + SOFT_ODD[1])
    odd = {f"{SOFT_ODD[0][0]}x{SOFT_ODD[0][1]} tiled":
           ((o_s, d_s, ras_s.hit, ras_s.face, ras_s.axis_coord),
            SOFT_ODD[0][0]),
           f"{SOFT_ODD[1]} flat lanes": (tuple(t[flat].contiguous()
                                              for t in hits), 0)}
    worst = 0.0
    for label, (hits_, width) in odd.items():
        for name, (pix, g) in modes.items():
            for ns in SOFT_ODD_SAMPLES:
                worst = max(worst, k14_check(hits_, ns, pix, g, width,
                                             f"{name}, {label}, {ns} "
                                             "samples")[2])
    print(f"paged K14 at odd shapes ({', '.join(odd)}; its three modes; "
          f"{SOFT_ODD_SAMPLES} samples): every sample hit equal to plain, "
          f"factor max |diff| {worst:.3e} vs plain on the CPU")
    errs["soft_shadow_paged"] = soft["cone gate"][2]

    # the paged K15: config 4's knobs and the lights frame at 1024^3, every
    # bounce held to shade_bounce_plain (BounceCheck)
    checks = {}
    for label in ("config 5 config-4 knobs", "config 5 lights"):
        r = rend[label]
        scene.lights[:] = lights0
        with BounceCheck(frame_mod, bounce, kernels) as bc:
            _, hdr_b = render_frame(
                grid, o, d, r.sun, 0.0, r.cfg, sky=r._sky(0.0),
                raster=(faces, rcam, probe), sunmask=r._sunmask(),
                density=scene.density,
                lights=scene.lights if r.cfg.point_lights else None,
                mirror_materials=True)
        check(bool(torch.isfinite(hdr_b).all()), f"{label}: HDR not finite")
        check(len(bc.bounces) == r.cfg.max_ray_iterations,
              f"{label}: {len(bc.bounces)} bounces")
        for k, (live, hit_n, mir, shd, diff, nbe, _) in enumerate(
                bc.bounces):
            print(f"{label} bounce {k}: {live} live lanes, {hit_n} hits, "
                  f"{mir} mirrors, {shd} shaded; paged K15 vs plain: bit "
                  f"for bit but the shaded rgb, max |diff| {diff:.3e} "
                  f"({nbe} shaded lanes not bit-equal)")
        checks[label] = bc
    errs["shade_bounce_paged"] = max(b[4] for b in
                                     checks["config 5 lights"].bounces)
    scene.lights[:] = lights0

    # ---- the rows: kernel and plain times (CUDA events), bounds
    def nbytes(*ts):
        return float(sum(t.nbytes for t in ts))

    lanes = float(sa_r.sum())
    soft_steps = 0.0
    p_q, act_q = softshadow.query_points(*hits, sun_d, False)
    kh, km = ss.soft_shadow_gate(p_q, sun_np, e1, e2, cone_k, act_q,
                                 wcfg.size)
    traced = act_q & ~kh & ~km
    for k in range(SOFT_SAMPLES):
        dirs = softshadow.sample_dir(k, *p_q.unbind(1), sun_d)[:3]
        start = torch.stack(softshadow.ray_start(*p_q.unbind(1), *dirs,
                                                 sun_d), -1)
        it = paged.trace_paged(grid, start, torch.stack(dirs, -1),
                               max_steps, active=traced).iterations
        soft_steps += float(it[traced].sum())
    lf_args = checks["config 5 lights"].first
    light_steps = near_n = 0.0
    _, world_, block_ = shade._reconstruct(*lf_args[1:3], *lf_args[4:6])
    shaded_ = lf_args[3] & ~bounce.mirror_lanes(lf_args[3], block_)
    q_ = torch.stack(world_, -1)
    table = bounce.light_table(lf_args[16])
    for li in range(table.shape[0]):
        lp = torch.as_tensor(table[li, :3], device=dev)
        dist = (q_ - lp).norm(dim=-1)
        near = shaded_ & (dist < bounce.LIGHT_RADIUS)
        dirs = (q_ - lp) / dist.clamp(min=1e-6)[:, None]
        it = paged.trace_paged(grid, lp.expand(n, 3).contiguous(),
                               dirs.contiguous(), max_steps,
                               active=near).iterations
        near_n += float(near.sum())
        light_steps += float(it[near].sum())
    print(f"config 5 work: K14 cone gate {int(act_q.sum())} lit lanes, "
          f"{int(traced.sum())} traced, {soft_steps:.0f} DDA sub-steps; "
          f"K15 lights at bounce 0: {near_n:.0f} (lane, light) pairs, "
          f"{light_steps:.0f} DDA sub-steps")
    k15_moved = float(checks["config 5 lights"].bounces[0][6])
    timed_rows = {
        "paged_trace": (
            lambda: paged.trace_paged(grid, o, d, max_steps, width=w,
                                      stats=False),
            lambda: paged.trace_paged_plain(grid, o, d, max_steps,
                                            stats=False),
            nbytes(o, d, *(getattr(res_k, f) for f in fields[:4]))
            + rows_bytes(grid, "K16 primary", lambda r: paged.
                         trace_paged_plain(grid, o, d, max_steps,
                                           stats=False, rows_read=r)),
            float(res_k.iterations.sum()) * OPS_PER_ITEM["jump_trace"]),
        "paged_trace_shadow": (
            lambda: paged.trace_paged(grid, so_k, sun_d, max_steps,
                                      active=sa_k, width=w, stats=False),
            lambda: paged.trace_paged_plain(grid, so_k, sun_d, max_steps,
                                            sa_k, stats=False),
            nbytes(so_k, sa_k, *(getattr(sh_k, f) for f in fields[:4]))
            + rows_bytes(grid, "K16 shadow", lambda r: paged.
                         trace_paged_plain(grid, so_k, sun_d, max_steps,
                                           sa_k, stats=False, rows_read=r)),
            float(sh_k.iterations.sum()) * OPS_PER_ITEM["jump_trace"]),
        "masked_shadow_paged": (
            lambda: ss.masked_shadow_from_hits(grid, *hits, sun_np, e1, e2,
                                               grids_k, max_steps),
            lambda: ss.masked_shadow_from_hits_plain(
                grid, *hits, sun_np, e1, e2, grids_k, max_steps),
            nbytes(*hits, grids_k[0], ms_k)
            + rows_bytes(grid, "paged K12", lambda r: ss.
                         masked_shadow_from_hits_plain(
                             grid, *hits, sun_np, e1, e2, grids_k,
                             max_steps, rows_read=r)),
            lanes * OPS_PER_ITEM["masked_shadow"]
            + n * OPS_PER_ITEM["shade_surface"]
            + float(res_it.sum()) * OPS_PER_ITEM["jump_trace"]),
        "soft_shadow_paged": (
            lambda: softshadow.soft_shadow(grid, *hits, sun_np,
                                           SOFT_SAMPLES, cl_k, max_steps,
                                           gate=gate, width=w),
            lambda: softshadow.soft_shadow_plain(
                grid, *hits, sun_np, SOFT_SAMPLES, cl_k, max_steps,
                gate=gate),
            nbytes(*hits, cl_k, cone_k[0], soft["cone gate"][0])
            + rows_bytes(grid, "paged K14, cone gate", lambda r: softshadow.
                         soft_shadow_plain(grid, *hits, sun_np,
                                           SOFT_SAMPLES, cl_k, max_steps,
                                           gate=gate, rows_read=r)),
            float(act_q.sum()) * SOFT_SAMPLES * OPS_PER_ITEM["soft_shadow"]
            + soft_steps * OPS_PER_ITEM["jump_trace"]),
        "shade_bounce_paged": (
            lambda: bounce.shade_bounce(*lf_args),
            lambda: bounce.shade_bounce_plain(*lf_args),
            k15_moved + rows_bytes(grid, "paged K15, lights", lambda r:
                                   bounce.shade_bounce_plain(*lf_args,
                                                             rows_read=r)),
            n * OPS_PER_ITEM["shade_bounce"] + near_n * LIGHT_OPS
            + light_steps * OPS_PER_ITEM["jump_trace"]),
    }
    rows = []
    for name, (kfn, pfn, moved, ops) in timed_rows.items():
        k_ms, p_ms = cuda_ms(kfn, 10), cuda_ms(pfn, 1)
        b_ms, b_by = bound_ms(moved, ops, "fp32")
        k = kernels.KERNELS[ROW_KERNEL.get(name, name)]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces,
                     "launches": launches.get(f"c5 {name}", 0),
                     "max_abs_err": errs[name], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"time {name} (1024^3): kernel {k_ms:.4f} ms, plain torch "
              f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    scene.release_dense()
    print(f"config 5 phase: {time.perf_counter() - t_phase:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f}"
          f" MiB; rays at the cap: primary {cap_p}, shadow {cap_s}; frame "
          f"medians {meds}")
    return rows, scene.chunks


# the dynamic world (ROADMAP A12; phase 8 of the module docstring): config
# 5 with its per-frame edits (tools/bench_scale.py:61-150): the 1024^3
# world at 1920x1080, one hard shadow ray, max_ray_iterations 3,
# `dynamic_world`, traversal "auto" (the paged grid), its camera; the
# radius-3 ball of `_brush` (:52) 4 voxels above the surface of the column
# the centre pixel's ray hits (dynamic_run), added, removed and added
# again, then DYN_FRAMES frames adding and
# removing it in turn (:103-125), an edit before each frame. Then the
# 256^3 bench world (bench.py's camera) with the same steps on the jump
# grid. The editor is made before the Renderer, and the scene takes its
# paged grid (or jump grid) and region faces: each is built once.
DYN_CFG = dict(width=1920, height=1080, shadow_samples=1,
               max_ray_iterations=3)
DYN_FRAMES = 8
DYN_PROFILED = 6     # edit-and-frame steps under torch.profiler
# each world's depth, camera and tools/bench_scale.py's brush column (x, z)
DYN_WORLDS = {"config 5": (5, C5_CAMERA, (512, 400)),
              "256^3": (4, CAMERA, (128, 100))}
_DYN_FRAME = {"generate_rays": 1, "raster_fragments": 1,
              "raster_resolve": 1, "shade_pixel": 1, "bloom_pyramid": 1,
              "composite": 1, "svt_update_brick": 1}
# K17's operations a voxel: a blurred one 27 taps of 4 channels (a
# multiply and an add each), the blur's multiply and the output's FMA a
# channel; a solid one the block colour (SHADE's hash and normalize) and
# the output's FMA a channel
SVT_BLUR_OPS = 27 * 4 * 2 + 4 + 4 * 2
SVT_SOLID_OPS = 45 + 4 * 2


def brush(center, radius: int = 3):
    """tools/bench_scale.py `_brush`: the voxel ball around `center`."""
    import numpy as np
    g = np.mgrid[-radius:radius + 1, -radius:radius + 1,
                 -radius:radius + 1].reshape(3, -1).T
    return (np.asarray(center, np.int64)[None]
            + g[(g ** 2).sum(1) <= radius * radius])


def dynamic_run(label, repo, dev, chunks, errs, launches) -> dict:
    """One world of DYN_WORLDS through the dynamic path: the editor, its
    structures in the scene, the Renderer with `dynamic_world`; counters
    reset before the steps and read after (the checks between them
    restore the counts they add); after each edit, the frame against one
    with K11's grids rebuilt from the patched faces (byte for byte) and
    the raster's hits against the trace on the patched grid (each ray
    where they differ against the oracle); after the steps, the editor's
    occupancy against the host copy the script keeps, and the patched
    grid against one built afresh from it (the paged grid's traces of
    every primary ray; the jump grid's rows). Returns what the kernels
    line and the checks of K17 and K18 need."""
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops import trace as tracer
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import Scene
    from vvr_tpu_torch.tools.profile_frame import trace_events, union_us
    from vvr_tpu_torch.utils.camera import Camera
    from vvr_tpu_torch.world.edit import WorldEditor
    from vvr_tpu_torch.world.generator import assemble_dense
    from vvr_tpu_torch.world.jumpgrid import build_jump_grid
    from vvr_tpu_torch.world.paged import build_paged_grid

    depth, camera, (bx, bz) = DYN_WORLDS[label]
    wcfg = WorldConfig(depth=depth)
    size = wcfg.size
    cfg = RenderConfig(**DYN_CFG)
    paged = cfg.use_paged(size)
    cam = Camera.look_at(*camera[:2], fov=camera[2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    setup = {}

    def timed(step, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        setup[step] = time.perf_counter() - t0
        return out

    occ = timed("assemble_dense (the script's host copy)",
                lambda: assemble_dense(chunks, size))
    scene = Scene(wcfg, chunks, device=dev)
    editor = WorldEditor(chunks, None, size=size, device=dev)
    if paged:
        scene.paged = timed("editor.attach_paged", editor.attach_paged)
    else:
        scene.jumpgrid = timed("jump grid + editor.attach_jump_grid",
                               lambda: editor.attach_jump_grid(
                                   build_jump_grid(occ, dev)))
    scene.faces = timed("editor.attach_faces_incremental",
                        editor.attach_faces_incremental)
    r = timed("Renderer (the sparse voxel texture)", lambda: Renderer(
        wcfg, cfg, device=dev, scene=scene, dynamic_world=True))
    check(r.use_paged == paged and r.use_raster and r.use_sunmask,
          f"{label}: the dynamic Renderer must rasterize, classify and "
          f"trace the {'paged' if paged else 'jump'} grid")
    check(r.grid is (editor.paged if paged else editor.jumpgrid)
          and scene.faces is editor.faces, f"{label}: the scene must hold "
          "the editor's grid and faces")
    # the brush lands where the camera looks (tools/bench_scale.py:98): on
    # the surface of the column the centre pixel's ray hits. Its own
    # column (512, 400) lies behind a hill from the camera, and its y
    # (:99-101) reads occ[:, :, x][:, z], the voxels at y = z, which puts
    # the ball 166 voxels under the surface
    w, h, n = cfg.width, cfg.height, cfg.width * cfg.height
    o, d = camera_rays(cam, w, h, dev)
    mid = (h // 2) * w + w // 2
    probe0 = scene.solid_at_host(cam.position)
    centre = rt.trace_raster(scene.faces, rt.raster_camera(cam), d, probe0,
                             size, w, h)
    check(bool(centre.hit[mid]), f"{label}: the centre ray hits nothing")
    hx, _, hz = (int(v) for v in torch.floor(
        o[mid] + d[mid] * centre.t[mid]).cpu())
    col = np.nonzero(occ[hz, :, hx])[0]
    top = int(col.max()) if len(col) else 0
    ball = brush((hx, top + 4, hz))
    at_col = np.nonzero(occ[bz, :, bx])[0]
    bench_col = np.nonzero(occ[:, bz, bx])[0]
    print(f"dynamic {label}: setup (host clock) " + ", ".join(
        f"{k} {v:.2f} s" for k, v in setup.items())
        + f"; {editor.faces[0].shape[0]} face rows "
        f"({int((editor.faces[5] > 0).sum())} faces), "
        + (f"pool {tuple(editor.paged.brows.shape)}, "
           f"{editor.paged.memory_bytes() / 2**20:.2f} MiB; " if paged
           else "")
        + f"SVT {r.svt.num_bricks} bricks, "
        f"{r.svt.memory_bytes() / 2**20:.2f} MiB; brush of {len(ball)} "
        f"voxels at ({hx}, {top + 4}, {hz}), the centre ray's column "
        f"(surface y {top}); tools/bench_scale.py's column ({bx}, {bz}) has "
        f"its surface at y {int(at_col.max()) if len(at_col) else -1}, its "
        f"expression gives y "
        f"{int(bench_col.max()) + 4 if len(bench_col) else 104})")

    max_steps = cfg.traversal_max_steps * 8
    rcam = rt.raster_camera(cam)
    e1, e2, s = ss.sun_basis(r.sun[:3])
    for _ in range(2):       # warm-up: K11 and K3, the first K17 passes
        r.render(cam, time=0.0)
    torch.cuda.synchronize()
    solids = [True, False, True] + [i % 2 == 0 for i in range(DYN_FRAMES)]
    marked, ties = [], 0

    def after_edit(k, t, img):
        """The checks of one step (their launches not counted)."""
        nonlocal ties
        saved = dict(kernels.LAUNCHES)
        grids = r._sunmask_cache[1][2]
        fresh = ss.sun_grids(scene.faces, e1, e2, s, size, ss.GRID)
        probe = scene.solid_at_host(cam.position)
        ref, _ = render_frame(r.grid, o, d, r.sun, t, r.cfg, sky=r._sky(t),
                              raster=(scene.faces, rcam, probe),
                              sunmask=(e1, e2, fresh))
        check(torch.equal(img, ref), f"{label} step {k}: the frame with the "
              f"repaired grids differs from the rebuilt grids' on "
              f"{int((img != ref).any(-1).sum())} pixels")
        marked.append(int((grids[0] != fresh[0]).any(1).sum()))
        ras = rt.trace_raster(scene.faces, rcam, d, probe, size, w, h)
        tr = tracer.trace(r.grid, o, d, max_steps, width=w, stats=False)
        off = ((ras.hit != tr.hit) | (ras.hit & (
            (ras.face != tr.face) | (ras.axis_coord != tr.axis_coord))))
        bad = torch.nonzero(off)[:, 0].cpu().numpy()
        if len(bad):
            ora = trace_dense(occ, o[bad].cpu().numpy(),
                              d[bad].cpu().numpy())
            for q, ray in enumerate(bad):
                check(bool(ora["hit"][q]) == bool(ras.hit[ray])
                      and int(ora["axis_coord"][q])
                      == int(ras.axis_coord[ray]),
                      f"{label} step {k}: ray {ray}, the raster is not the "
                      "oracle's answer")
        check(len(bad) <= K16_ORACLE_SLACK, f"{label} step {k}: the raster "
              f"and the trace differ on {len(bad)} primary rays")
        ties = max(ties, len(bad))
        kernels.LAUNCHES.update(saved)

    kernels.reset_launches()
    ms, infos, changed, prev = [], [], [], None
    for k, solid in enumerate(solids):
        t = (k + 1) / 60.0
        t1 = time.perf_counter()
        info = r.apply_edits(editor, ball, solid)
        img = r.render(cam, time=t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        occ[ball[:, 2], ball[:, 1], ball[:, 0]] = solid
        infos.append(info)
        after_edit(k, t, img)
        changed.append(prev is not None and not torch.equal(img, prev))
        prev = img
    got = dict(kernels.LAUNCHES)
    steps = len(solids)
    want = {**_DYN_FRAME, ("masked_shadow_paged" if paged
                           else "masked_shadow"): 1}
    uneven = {k: got[k] for k, v in want.items() if got[k] != v * steps}
    check(not uneven, f"{label}: kernels not launched {want} times a step "
          f"over {steps} steps: {uneven}")
    check(got["invalidate_texels"] == steps, f"{label}: K18 launched "
          f"{got['invalidate_texels']} times for {steps} edits")
    others = {k: v for k, v in got.items() if v and k not in want
              and k != "invalidate_texels"}
    check(not others, f"{label}: launched {others} (no sun grids, sky, or "
          "other trace may run between the edits)")
    for k in ("svt_update_brick", "invalidate_texels"):
        launches[f"dyn {label} {k}"] = got[k]
    check(tuple(img.shape) == (h, w, 3) and float(img.float().std()) > 10,
          f"{label}: the frame is wrong")
    check(changed[1], f"{label}: removing the ball left the frame as it was "
          "(the brush is out of view)")
    for k, info in enumerate(infos):
        print(f"dynamic {label} step {k} ({'add' if solids[k] else 'remove'}"
              f"): " + json.dumps({**info, "edit_ms": round(
                  info["edit_ms"], 3), "frame_ms": round(ms[k], 3),
                  "texels_off_rebuilt": marked[k],
                  "frame_changed": changed[k]}))
    med = sorted(ms)[steps // 2]
    print(f"dynamic {label}: {steps} steps (edit + frame, host clock, "
          f"synchronized), median {med:.3f} ms, edit_ms median "
          f"{sorted(i['edit_ms'] for i in infos)[steps // 2]:.3f}; "
          f"launches {({k: v for k, v in got.items() if v})}; each frame "
          f"equal to the rebuilt grids' frame; raster and trace apart on at "
          f"most {ties} rays a step, each the oracle's tie")

    # a profiled window of edit-and-frame steps: device busy a step, K17's
    # and K18's device time. A step's device work runs from one frame's
    # K17 (the frame's first kernel) to the next frame's: the frame, then
    # the next edit's copies, scatters and K18; the busy time a step is the
    # union of the device events between the first and the last K17 the
    # trace recorded, over the steps between them
    base = len(solids)

    def run():
        for q in range(DYN_PROFILED + 1):
            solid = (base + q) % 2 == 0
            r.apply_edits(editor, ball, solid)
            r.render(cam, time=(base + q + 1) / 60.0)
            torch.cuda.synchronize()
            occ[ball[:, 2], ball[:, 1], ball[:, 0]] = solid

    t1 = time.perf_counter()
    events = trace_events(repo / "build" / "vvr_tpu_torch"
                          / "dyn_trace.json", run)
    wall = (time.perf_counter() - t1) * 1e3 / (DYN_PROFILED + 1)
    per = {}
    for e in events:
        for key, part in (("K17", "vvr_svt_update_kernel"),
                          ("K17 copy", "Memcpy DtoD"),
                          ("K18", "vvr_invalidate_texels_kernel")):
            if part in e["name"]:
                per.setdefault(key, []).append(e)
    starts = sorted(e["ts"] for e in per.get("K17", []))
    check(len(starts) >= 2, f"{label}: the trace recorded "
          f"{len(starts)} K17 launches of {DYN_PROFILED + 1}")
    busy = union_us((e["ts"], e["ts"] + e["dur"]) for e in events
                    if starts[0] <= e["ts"] < starts[-1])
    print(f"dynamic {label}: profiled window of {DYN_PROFILED + 1} steps, "
          f"host {wall:.4f} ms a step (profiled), device busy "
          f"{busy / (len(starts) - 1) / 1e3:.4f} ms a step over the "
          f"{len(starts) - 1} steps between the first and last K17 the "
          f"trace recorded; " + ", ".join(
              f"{k} {sum(e['dur'] for e in v) / len(v):.2f} us a launch "
              f"({len(v)} launches recorded)" for k, v in per.items()))

    # after the steps: the world, and the grid against a fresh build
    check(np.array_equal(editor.occupancy(), occ), f"{label}: the editor's "
          "occupancy differs from the script's copy")
    if paged:
        fresh = timed("fresh build_paged_grid", lambda: build_paged_grid(
            occ, dev))
        a = tracer.trace(r.grid, o, d, max_steps, width=w, stats=False)
        b = tracer.trace(fresh, o, d, max_steps, width=w, stats=False)
        for f in ("hit", "face", "axis_coord", "t"):
            check(torch.equal(getattr(a, f), getattr(b, f)), f"{label}: K16 "
                  f"on the patched grid and on a fresh build differ in {f}")
        print(f"dynamic {label}: K16 on the patched paged grid (pool "
              f"{tuple(r.grid.brows.shape)}) answers all {n} primary rays "
              f"as on a fresh build (pool {tuple(fresh.brows.shape)}; "
              f"{setup['fresh build_paged_grid']:.2f} s)")
    else:
        fresh = build_jump_grid(occ, dev)
        check(torch.equal(r.grid.rows, fresh.rows), f"{label}: the patched "
              "jump grid's rows differ from a fresh build's")
        print(f"dynamic {label}: the patched jump grid's rows equal a fresh "
              "build's")
    print(f"dynamic {label}: {time.perf_counter() - t_phase:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f}"
          f" MiB")
    return {"renderer": r, "ball": ball,
            "k17_us": [e["dur"] for e in per.get("K17", [])],
            "k18_us": [e["dur"] for e in per.get("K18", [])]}


def dynamic_phase(repo, dev, errs: dict, launches: dict, chunks_1024,
                  chunks_256) -> list:
    """Phase 8 (module docstring): the dynamic runs of both worlds, then
    K17 and K18 against their plain versions and their rows of the
    kernels line (launches from config 5's dynamic run)."""
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import cuda_ms, device_us
    from vvr_tpu_torch.world import bricks

    run_256 = dynamic_run("256^3", repo, dev, chunks_256, errs, launches)
    del run_256
    got = dynamic_run("config 5", repo, dev, chunks_1024, errs, launches)
    r, ball = got["renderer"], got["ball"]
    size = r.scene.cfg.size

    # K17: three bricks (the first, a middle one, one at the world's far
    # edge) once each, then the first again, against the plain version on
    # copies of the same bricks, every byte
    svt = r.svt
    edge = int(np.argmax(svt.origins_host.max(1)))
    check(int(svt.origins_host[edge].max()) == size - 64, "no SVT brick "
          "touches the world's far edge")
    sel = [0, svt.num_bricks // 2, edge]
    sub = dataclasses.replace(svt, bricks=svt.bricks[sel].clone(),
                              origins_host=svt.origins_host[sel],
                              scratch=None)
    plain = sub.bricks.clone()
    for slot in (0, 1, 2, 0):
        bricks.svt_update_brick(sub, slot)
        bricks.svt_update_brick_plain(plain, slot, sub.origins_host[slot])
        check(torch.equal(sub.bricks, plain), f"K17 slot {sel[slot]}: "
              f"{int((sub.bricks != plain).sum())} bytes differ from plain")
    errs["svt_update_brick"] = 0.0
    solid_n = int((sub.bricks[0, ..., 3] == 255).sum())
    print(f"K17: bricks {sel} (origins {sub.origins_host.tolist()}), one "
          f"pass each and a second on brick {sel[0]}: every byte equal to "
          f"plain; brick {sel[0]}: {solid_n} solid voxels of {64 ** 3}")

    # K18: the hard and the cone grids of config 5's patched faces at the
    # frame's sun, built afresh, on copies, the brush's texels through the
    # entry the Renderer calls: one launch, its rectangles (formed on the
    # card) equal to texel_rects', gBC equal to the plain version's
    e1, e2, s = ss.sun_basis(r.sun[:3])
    hard = ss.sun_grids(r.scene.faces, e1, e2, s, size, ss.GRID)
    cone = ss.sun_grids(r.scene.faces, e1, e2, s, size, ss.GRID,
                        ss.CONE_TAN)
    for name, g, tan in (("hard", hard, 0.0), ("cone", cone, ss.CONE_TAN)):
        a = (g[0].clone(),) + tuple(g[1:])
        b = (g[0].clone(),) + tuple(g[1:])
        before = kernels.LAUNCHES["invalidate_texels"]
        got_rects = ss.invalidate_texels(a[0], e1, e2, ball, size, *g[1:],
                                         tan, want_rects=True)
        check(kernels.LAUNCHES["invalidate_texels"] == before + 1,
              f"K18 ({name}) did not launch once")
        rects = ss.texel_rects(e1, e2, ball, size, ss.GRID, *g[1:], tan)
        check(np.array_equal(got_rects.cpu().numpy(), rects),
              f"K18 ({name}): the card's rectangles "
              f"{got_rects.cpu().tolist()} differ from texel_rects' "
              f"{rects.tolist()}")
        ss.invalidate_texels_plain(b[0], rects)
        check(torch.equal(a[0], b[0]), f"K18 ({name}): gBC differs from "
              "plain")
        print(f"K18 ({name} grids): {len(rects)} rectangles formed on the "
              f"card equal to texel_rects', {int((a[0] != g[0]).any(1).sum())}"
              f" texels changed, gBC equal to plain")
    # an edit without positions: no launch, no rectangle, gBC unchanged
    a = hard[0].clone()
    before = kernels.LAUNCHES["invalidate_texels"]
    got_rects = ss.invalidate_texels(a, e1, e2, np.zeros((0, 3), np.int64),
                                     size, *hard[1:], want_rects=True)
    check(kernels.LAUNCHES["invalidate_texels"] == before
          and got_rects.shape == (0, 4) and torch.equal(a, hard[0]),
          "K18: an edit without positions launched or changed gBC")
    print("K18 (no positions): no launch, gBC unchanged")
    errs["invalidate_texels"] = 0.0

    # the rows; K18 from the positions (host grouping, the pinned copy and
    # the launch), its device time, the whole invalidate_sun_texels call
    # and one index_put_ of the same texels, in turns on the same gBC
    g0 = hard[0].clone()
    grids = (g0,) + tuple(hard[1:])
    whole = cuda_ms(lambda: ss.invalidate_sun_texels(grids, e1, e2, ball,
                                                     size), 20)
    rects = ss.texel_rects(e1, e2, ball, size, ss.GRID, *hard[1:])
    mask = np.zeros((ss.GRID, ss.GRID), bool)
    for i0, i1, j0, j1 in rects.tolist():
        mask[j0:j1 + 1, i0:i1 + 1] = True
    jj, ii = np.nonzero(mask)
    tex = torch.from_numpy((jj * ss.GRID + ii).astype(np.int64)).to(dev)
    amb = torch.tensor([ss.NEG, 3e38], dtype=torch.float32,
                       device=dev).expand(len(jj), 2).contiguous()

    def k18():
        ss.invalidate_texels(g0, e1, e2, ball, size, *hard[1:])

    def k18_plain():
        ss.invalidate_texels_plain(g0, ss.texel_rects(
            e1, e2, ball, size, ss.GRID, *hard[1:]))
    k18_dev = device_us(k18, ("vvr_invalidate_texels",), 20,
                        repo / "build" / "vvr_tpu_torch" / "k18_trace.json")
    n_solid = float((sub.bricks[0, ..., 3] == 255).sum())
    rows = []
    timed_rows = {
        "svt_update_brick": (
            lambda: bricks.svt_update_brick(sub, 0),
            lambda: bricks.svt_update_brick_plain(plain, 0,
                                                  sub.origins_host[0]),
            None, 2.0 * bricks.BRICK_BYTES,
            n_solid * SVT_SOLID_OPS + (64 ** 3 - n_solid) * SVT_BLUR_OPS),
        # bytes: the texels written, the offsets and positions read (the
        # timed call asks for no rectangles; the float64 projections, 16
        # a corner, are below the bytes term at any float rate)
        "invalidate_texels": (
            k18, k18_plain, lambda: g0.index_put_((tex,), amb),
            8.0 * len(jj) + 4.0 * (len(rects) + 1 + 3 * len(ball)), 0.0),
    }
    for name, (kfn, pfn, lfn, moved, ops) in timed_rows.items():
        k_ms, p_ms = cuda_ms(kfn, 20), cuda_ms(pfn, 2)
        l_ms = cuda_ms(lfn, 20) if lfn else None
        b_ms, b_by = bound_ms(moved, ops, "fp32")
        k = kernels.KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces,
                     "launches": launches[f"dyn config 5 {name}"],
                     "max_abs_err": errs[name], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": l_ms})
        print(f"time {name} (config 5): kernel {k_ms:.4f} ms (wrapper), "
              f"plain torch {p_ms:.4f} ms, "
              + (f"index_put_ of the {len(jj)} texels {l_ms:.4f} ms, "
                 if l_ms else "")
              + (f"invalidate_sun_texels whole {whole:.4f} ms, "
                 f"device {k18_dev:.2f} us a call back to back, "
                 if name == "invalidate_texels" else "")
              + f"bound {b_ms:.6f} ms ({b_by}); device "
              + (f"{sum(got['k17_us']) / max(len(got['k17_us']), 1):.2f}"
                 if name == "svt_update_brick" else
                 f"{sum(got['k18_us']) / max(len(got['k18_us']), 1):.2f}")
              + " us a launch in the profiled steps")
    return rows


# the brick pyramid (ROADMAP A13; phase 9 of the module docstring):
# `traversal="pyramid"` over the 256^3 scene, each configuration's kernels
# a frame (K3 and K11 apart): K19 for every DDA, the pyramid forms of K12,
# K14 and K15, K21 once a debug frame and no bloom there
PYR_FRAMES = 4       # timed frames a configuration, after a warm-up
_PYR_RASTER = {"generate_rays": 1, "raster_fragments": 1,
               "raster_resolve": 1, "bloom_pyramid": 1, "composite": 1}
_PYR_SOFT = {**_PYR_RASTER, "soft_shadow_pyramid": 1, "shade_pixel": 1}
_PYR_DEBUG = {"generate_rays": 1, "pyramid_trace": 1,
              "masked_shadow_pyramid": 1, "shade_pixel": 1,
              "debug_image": 1, "composite": 1}
PYR_PHASES = {
    "default knobs": ({}, False, {**_PYR_RASTER, "masked_shadow_pyramid": 1,
                                  "shade_pixel": 1}),
    "DDA": (dict(primary_raster="off", sun_mask="off"), False,
            {"generate_rays": 1, "pyramid_trace": 2, "shade_surface": 1,
             "shade_pixel": 1, "bloom_pyramid": 1, "composite": 1}),
    "soft, cone": (dict(shadow_samples=4), False, _PYR_SOFT),
    "soft, DDA": (dict(shadow_samples=4, sun_mask="off"), False, _PYR_SOFT),
    "pixelated": (dict(shadow_samples=4, pixelated_shadows=True), False,
                  _PYR_SOFT),
    "config-4 knobs": (CONFIG4, True, {
        **_PYR_RASTER, "soft_shadow_pyramid": 4, "pyramid_trace": 3,
        "shade_bounce_pyramid": 4}),
    "lights": (LIGHTS_FRAME, True, {
        **_PYR_RASTER, "masked_shadow_pyramid": 3, "pyramid_trace": 2,
        "shade_bounce_pyramid": 3}),
    "overlap AO": (dict(ambient_occlusion=True, ao_mode="overlap"), False,
                   {**_PYR_RASTER, "masked_shadow_pyramid": 1,
                    "shade_bounce_pyramid": 1}),
    **{f"debug {t}": (dict(debug_type=t), False, _PYR_DEBUG)
       for t in range(1, 6)},
}
# the jump-grid frame each pyramid frame is held to byte for byte: the
# same knobs, but the jump grid's per-sample DDA where the pyramid's frame
# has the cone gate (the pyramid walks no near segment, so its gate
# answers each sample as the DDA)
PYR_VS_JUMP = {"default knobs": {}, "DDA": {},
               "soft, cone": dict(sun_mask="off"), "soft, DDA": {},
               "pixelated": {}, "config-4 knobs": dict(sun_mask="off"),
               "lights": {}, "overlap AO": {}}
# the index of max_steps among each pyramid form's launch arguments
# (kernels.KERNELS): the frame passes the pyramid's own cap,
# traversal_max_steps, where the grids take it times 8
PYR_MAX_STEPS_ARG = {"pyramid_trace": 10, "masked_shadow_pyramid": 26,
                     "soft_shadow_pyramid": 17, "shade_bounce_pyramid": 28}
# lanes a frame comparison may part at exact ties and at the cap
PYR_SLACK = 64
# the kernels that run the HDDA inline and the instantiations of each
# with the pyramid's view that the build must hold: K19 with and without
# FULL and the counters, the pyramid K12, K14 and K15, and K23
PYR_WALK_KERNELS = {"vvr_trace_kernel": 4, "vvr_masked_shadow_kernel": 1,
                    "vvr_soft_shadow_kernel": 1,
                    "vvr_shade_bounce_kernel": 1,
                    "vvr_shade_raster_kernel": 1}
# the overlap AO's cells a lane: two squares of (2k+1)^2, k = 1 and 3
OVERLAP_AO_CELLS = 9 + 49


@contextlib.contextmanager
def recorded_traces(frame_mod, rec: dict):
    """Within it the frame's DDA calls (`trace`), its K12 calls and its K14
    calls (with their sample hits) are appended to rec["trace"],
    rec["k12"] and rec["k14"], their inputs copied (a later bounce writes
    its rays in place)."""
    tr, k12, k14 = (frame_mod.trace, frame_mod.masked_shadow_from_hits,
                    frame_mod.soft_shadow)

    def trace_(grid, o, d, max_steps, active=None, width=None, stats=True):
        res = tr(grid, o, d, max_steps, active=active, width=width,
                 stats=stats)
        rec["trace"].append((o.clone(), d.clone(),
                             None if active is None else active.clone(),
                             max_steps, res))
        return res

    def k12_(grid, *args):
        out = k12(grid, *args)
        rec["k12"].append((tuple(t.clone() for t in args[:5]), out.clone(),
                           args[-1]))
        return out

    def k14_(*args, **kw):
        factor, hits = k14(*args, with_hits=True, **kw)
        rec["k14"].append((tuple(t.clone() for t in args[1:6]), hits,
                           args[10], args[9]))
        return factor

    frame_mod.trace = trace_
    frame_mod.masked_shadow_from_hits = k12_
    frame_mod.soft_shadow = k14_
    try:
        yield
    finally:
        frame_mod.trace = tr
        frame_mod.masked_shadow_from_hits = k12
        frame_mod.soft_shadow = k14


def pyramid_phase(repo, dev, renderer, cam, occ, lights_np, errs: dict,
                  launches: dict, frames: int = PYR_FRAMES) -> list:
    """Phase 9 (module docstring): the 256^3 scene's brick pyramid built
    on the card; the frames of PYR_PHASES through `Renderer.render`,
    counters reset before each configuration and read after; K19 against
    its plain version and against K1; each pyramid frame against the jump
    grid's (PYR_VS_JUMP), every parted lane an exact tie or a capped ray;
    K20, K21 and the pyramid forms of K12, K14 and K15 against their
    plain versions, the kernel path's frames against the plain path's.
    Returns the kernels line's rows of K19-K21 and the pyramid forms."""
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.ops import bounce, debug, jump, overlap, shade
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import softshadow
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops import traverse
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import frame as frame_mod
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer, use_sunmask
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import (cuda_ms, device_us,
                                                   flushed_us)
    from vvr_tpu_torch.world.pyramid import build_brick_pyramid

    t_phase = time.perf_counter()
    # every kernel that runs the HDDA inline (K20 reads the pyramid's
    # voxels only): each found in the build's ptxas report, its spills
    # reported and none to local memory
    found = {k: set() for k in PYR_WALK_KERNELS}
    for name, regs, st, ld in kernels.ptxas_usage("vvr_"):
        kind = next((k for k in PYR_WALK_KERNELS if k in name and (
            "VvrPyramidViewT" in name or k == "vvr_shade_raster_kernel")),
                    None)
        if kind is None:
            continue
        found[kind].add(name)
        print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")
        check(st == 0 and ld == 0, f"{name}: spill stores {st} B, loads "
              f"{ld} B (-1: not reported)")
    missing = {k: f"{len(v)} of {PYR_WALK_KERNELS[k]}"
               for k, v in found.items() if len(v) < PYR_WALK_KERNELS[k]}
    check(not missing, f"kernels that run the HDDA missing from the ptxas "
          f"report: {missing}")
    scene = renderer.scene
    wcfg = scene.cfg
    jgrid = scene.jumpgrid
    cfg = dataclasses.replace(renderer.cfg, traversal="pyramid")
    w, h = cfg.width, cfg.height
    n = w * h
    cap = cfg.traversal_max_steps
    trace_path = repo / "build" / "vvr_tpu_torch" / "pyr_trace.json"

    # ---- the pyramid, built on the card from the dense occupancy
    t0 = time.perf_counter()
    dense = scene.dense()
    t1 = time.perf_counter()
    pyr = build_brick_pyramid(dense, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scene.pyramid = pyr
    scene.release_dense()
    check(torch.equal(pyr.rows, build_brick_pyramid(occ, "cpu").rows.to(
        dev)), "the pyramid built on the card differs from the CPU build")
    print(f"pyramid setup (256^3, host clock): assemble_dense "
          f"{t1 - t0:.3f} s, build on the card {t2 - t1:.3f} s; rows "
          f"{tuple(pyr.rows.shape)}, {pyr.memory_bytes() / 2**20:.2f} MiB, "
          f"depth {pyr.depth}; equal to the CPU build row for row")

    # ---- the frames through Renderer.render, each configuration's
    # counters reset before its frames and read after; the pyramid forms'
    # launch arguments recorded (the cap, the any-only walk, the width,
    # the counters)
    scene.lights[:] = lights_np
    args_of = {k: [] for k in PYR_MAX_STEPS_ARG}
    launch = kernels.launch

    def recorded(name, device, *args):
        if name in args_of:
            args_of[name].append(args)
        launch(name, device, *args)

    rend, meds = {}, {}
    kernels.launch = recorded
    try:
        for label, (knobs, mirrors, per_frame) in PYR_PHASES.items():
            scene.lights[:] = lights_np
            for v in args_of.values():
                v.clear()
            kernels.reset_launches()
            r = Renderer(wcfg, dataclasses.replace(cfg, **knobs),
                         device=dev, scene=scene, mirror_materials=mirrors)
            check(r.use_pyramid and r.grid is pyr, f"pyramid {label}: the "
                  "Renderer must trace the scene's pyramid")
            ms = []
            for i in range(frames + 1):   # frame 0 warms up (K11, K3)
                t1 = time.perf_counter()
                img = r.render(cam, time=i / 60.0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            check(tuple(img.shape) == (h, w, 3)
                  and float(img.float().std()) > 10,
                  f"pyramid {label}: the frame is wrong")
            got = dict(kernels.LAUNCHES)
            frames_ = frames + 1
            uneven = {k: got[k] for k, v in per_frame.items()
                      if got[k] != v * frames_}
            check(not uneven, f"pyramid {label}: kernels not launched "
                  f"{per_frame} times a frame over {frames_} frames: "
                  f"{uneven}")
            once = ["sun_grids"] if r.use_sunmask else []
            for k in once:
                check(got[k] == 1, f"pyramid {label}: {k} launched {got[k]}"
                      " times")
            check(got["write_sky"] == 1, f"pyramid {label}: K3 launched "
                  f"{got['write_sky']} times in one sky bucket")
            others = {k: v for k, v in got.items() if v and k not in
                      per_frame and k not in once and k != "write_sky"}
            check(not others, f"pyramid {label}: launched {others} (no K1, "
                  "no jump-grid or paged forms, no bloom in a debug frame)")
            caps = {k: sorted({a[i] for a in args_of[k]})
                    for k, i in PYR_MAX_STEPS_ARG.items() if args_of[k]}
            check(all(c == [cap] for c in caps.values()),
                  f"pyramid {label}: the pyramid forms' caps {caps}, "
                  f"expected {cap}")
            k19 = args_of["pyramid_trace"]
            stats = debug.needs_stats(r.cfg.debug_type)
            check(all(a[3] == 0 and a[9] == w for a in k19),
                  f"pyramid {label}: K19 must walk the any masks by 8x4 "
                  "tiles")
            check(all((a[15] != 0) == (stats and a[6] == 3) for a in k19),
                  f"pyramid {label}: K19's counters written "
                  f"{[a[15] != 0 for a in k19]}, expected only for the "
                  "heatmap's primary trace")
            for k, v in got.items():
                if k in per_frame or k in once:
                    launches[f"pyr {k}"] = launches.get(f"pyr {k}", 0) + v
            launches["pyr shadow"] = (launches.get("pyr shadow", 0)
                                      + sum(a[6] == 0 for a in k19))
            meds[label] = sorted(ms[1:])[frames // 2]
            print(f"pyramid {label}: {frames} frames after a warm-up of "
                  f"{ms[0]:.1f} ms, median {meds[label]:.3f} ms (host "
                  f"clock, synchronized); launches "
                  f"{ {k: v for k, v in got.items() if v} }; caps {caps}")
            rend[label] = r
    finally:
        kernels.launch = launch
    scene.lights[:] = lights_np
    from vvr_tpu_torch.tools import profile_frame
    profile_frame.window("pyramid DDA", rend["DDA"], cam, trace_path)

    # ---- K19 against its plain version: primary and shadow rays at
    # 1920x1080 and 33x67, with and without counters, flat and tiled, with
    # the FULL early-out and without, and at a cap most rays reach
    fields = ("hit", "face", "axis_coord", "t", "iterations", "fetches",
              "missed_pops")
    sun_np = renderer.sun[:3].copy()
    sun3 = torch.from_numpy(sun_np)
    sun_d = sun3.to(dev)
    o, d = camera_rays(cam, w, h, dev)

    def k19_check(ro, rd, ra, width, label, cap_=cap):
        out = {}
        answered = (torch.zeros(pyr.rows.shape[0], dtype=torch.int64,
                                device=dev),)
        for uf in (True, False):
            full = traverse.trace_pyramid(pyr, ro, rd, cap_, active=ra,
                                          use_full=uf)
            ref = traverse.trace_pyramid_plain(
                pyr, ro, rd, cap_, ra, use_full=uf,
                answered=None if uf else answered)
            lean = traverse.trace_pyramid(pyr, ro, rd, cap_, active=ra,
                                          width=width, stats=False,
                                          use_full=uf)
            for f in fields:
                check(torch.equal(getattr(full, f), getattr(ref, f)),
                      f"K19 ({label}, full {uf}): {f} differs from plain on "
                      f"{int((getattr(full, f) != getattr(ref, f)).sum())}"
                      " rays")
            for f in fields[:4]:
                check(torch.equal(getattr(lean, f), getattr(ref, f)),
                      f"K19 ({label}, full {uf}, tiled, no counters): {f} "
                      "differs")
            check(lean.iterations is None, "K19 wrote counters without "
                  "stats")
            out[uf] = full
        any_ = out[False]
        capped = int((any_.iterations >= cap_).sum())
        check(torch.equal(out[True].hit, any_.hit) or capped,
              f"K19 ({label}): the FULL early-out changes a hit")
        print(f"K19 ({label}): {ro.shape[0]} rays, hits "
              f"{int(any_.hit.sum())}, bit-exact vs plain (seven outputs; "
              f"tiled without counters the four), with and without the FULL"
              f" early-out; steps mean "
              f"{float(any_.iterations.float().mean()):.2f}"
              f" max {int(any_.iterations.max())} (FULL: mean "
              f"{float(out[True].iterations.float().mean()):.2f}), fetches "
              f"mean {float(any_.fetches.float().mean()):.2f}; rays at the "
              f"{cap_} cap: {capped}")
        fetches = max(float(any_.fetches.sum()), 1.0)
        ans = float(answered[0].sum())
        root = float(answered[0][pyr.bases[pyr.depth]])
        rays = max(int((any_.fetches > 0).sum()), 1)
        print(f"K19 ({label}): the masks a ray holds answer "
              f"{ans / fetches:.4f} of the {fetches:.0f} fetches (the root "
              f"{root / fetches:.4f}, empty nodes "
              f"{(ans - root) / fetches:.4f}); fetches {fetches / rays:.2f}"
              f" a ray, {(fetches - ans) / rays:.2f} of them not answered")
        return any_, capped

    res_p, cap_p = k19_check(o, d, None, w, f"primary, {w}x{h}")
    so_p, sa_p = shade.shade_surface(o, d, res_p.hit, res_p.face,
                                     res_p.axis_coord, sun3)
    sh_p, cap_s = k19_check(so_p, sun_d, sa_p, w, f"shadow, {w}x{h}, one "
                            "sun direction")
    o_s, d_s = camera_rays(cam, 33, 67, dev)
    r_s, _ = k19_check(o_s, d_s, None, 33, "primary, 33x67")
    so_s, sa_s = shade.shade_surface(o_s, d_s, r_s.hit, r_s.face,
                                     r_s.axis_coord, sun3)
    k19_check(so_s, sun_d, sa_s, 33, "shadow, 33x67")
    # a cap most rays reach: the lower quartile of the primary rays' steps
    cap_most = int(res_p.iterations.float().quantile(0.25))
    _, at_cap = k19_check(o, d, None, w, f"primary at a cap of {cap_most}",
                          cap_most)
    check(at_cap * 2 > n, f"K19 at a cap of {cap_most}: {at_cap} of {n} "
          "rays reach it, not most")
    errs["pyramid_trace"] = errs["pyramid_trace_shadow"] = 0.0

    # the oracle's answer for a lane the two grids answer apart: an exact
    # tie (the oracle's answer is one of theirs) or a ray the pyramid's
    # walk caps
    def verify(what, ro, rd, got_p, got_j, cap_, shadow):
        ora = trace_dense(occ, ro, rd)
        o_ans = (bool(ora["hit"][0]) if shadow else
                 ((int(ora["face"][0]), int(ora["axis_coord"][0]))
                  if ora["hit"][0] else "miss"))
        pl = traverse.trace_pyramid_plain(
            pyr, torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev),
            cap_, use_full=False)
        capped = int(pl.iterations[0]) >= cap_ and not bool(pl.hit[0])
        kind_ = ("capped" if capped else "tie" if o_ans in (got_p, got_j)
                 else "neither")
        print(f"{what}: the pyramid {got_p}, the jump grid {got_j}, the "
              f"numpy oracle {o_ans}: {kind_}")
        check(kind_ != "neither", f"{what}: the oracle agrees with neither "
              "grid, and the pyramid's ray is not capped")
        return kind_

    def answer(res, lane, shadow):
        if shadow:
            return bool(res.hit[lane])
        return ((int(res.face[lane]), int(res.axis_coord[lane]))
                if bool(res.hit[lane]) else "miss")

    # K19 against K1 on every primary ray
    res_j = jump.trace_jump(jgrid, o, d, cap * 8, width=w, stats=False)
    off = (res_p.hit != res_j.hit) | (res_p.hit & (
        (res_p.face != res_j.face) | (res_p.axis_coord != res_j.axis_coord)))
    bad = torch.nonzero(off)[:, 0].cpu().numpy()
    check(len(bad) <= PYR_SLACK, f"K19 and K1 differ on {len(bad)} primary "
          "rays")
    kinds = [verify(f"primary ray {ray} (pixel {ray % w}, {ray // w})",
                    o[ray:ray + 1].cpu().numpy(),
                    d[ray:ray + 1].cpu().numpy(), answer(res_p, ray, False),
                    answer(res_j, ray, False), cap, False) for ray in bad]
    print(f"K19 vs K1 on every primary ray: {n - len(bad)} of {n} equal "
          f"(hit, face, axis_coord); {kinds.count('tie')} exact ties, "
          f"{kinds.count('capped')} capped by the pyramid's {cap} steps "
          "(printed above)")

    # ---- each pyramid frame against the jump grid's (PYR_VS_JUMP): the
    # same rays at every DDA call but on lanes parted at a tie or a cap,
    # K12's answers and K14's sample hits equal off them, each lane where
    # they differ a tie or a capped ray, and the HDR equal off the parted
    # lanes
    sky = renderer._sky(0.25)
    faces = scene.ensure_faces()
    rcam = rt.raster_camera(cam)
    probe = scene.solid_at_host(cam.position)
    dens = scene.ensure_density()

    def frame_kw(cfg_, sunmask):
        return dict(
            sky=sky, raster=((faces, rcam, probe) if cfg_.primary_raster
                             != "off" and cfg_.debug_type == 6 else None),
            sunmask=sunmask, density=dens,
            lights=lights_np if cfg_.point_lights else None)

    def shaded_of(h, mirrors):
        """The lanes shaded with a bounce's shadow: the hits, but the
        mirrors of a frame with mirrors (whose continuation may start
        inside solid, ROADMAP C13, where the cone gate claims light)."""
        if not mirrors:
            return h[2]
        block = shade._reconstruct(*h[:2], *h[3:])[2]
        return h[2] & ~bounce.mirror_lanes(h[2], block)

    def pyr_vs_jump(label):
        knobs, mirrors, _ = PYR_PHASES[label]
        r = rend[label]
        cfg_j = dataclasses.replace(r.cfg, traversal="auto",
                                    **PYR_VS_JUMP[label])
        sm = r._sunmask() if r.use_sunmask else None
        sm_j = sm if use_sunmask(cfg_j) else None
        recs = []
        for g, c, s in ((pyr, r.cfg, sm), (jgrid, cfg_j, sm_j)):
            rec = {"trace": [], "k12": [], "k14": []}
            with recorded_traces(frame_mod, rec):
                img_, hdr_ = render_frame(g, o, d, r.sun, 0.25, c,
                                          mirror_materials=mirrors,
                                          **frame_kw(c, s))
            recs.append((img_, hdr_, rec))
        (img_p, hdr_p, rp), (img_j, hdr_j, rj) = recs
        parted = torch.zeros(n, dtype=torch.bool, device=dev)
        why = []
        for key in ("trace", "k12", "k14"):
            check(len(rp[key]) == len(rj[key]), f"pyramid {label}: "
                  f"{len(rp[key])} {key} calls against {len(rj[key])}")
        for k, (cp, cj) in enumerate(zip(rp["trace"], rj["trace"])):
            (op, dp, ap, msp, resp), (oj, dj, aj, _, resj) = cp, cj
            shadow = dp.dim() == 1
            live = torch.ones(n, dtype=torch.bool, device=dev) \
                if ap is None else ap.clone()
            live &= ~parted
            same_in = (op == oj).all(1) & ((dp == dj).all() if shadow
                                           else (dp == dj).all(1))
            check(bool((same_in | ~live).all()), f"pyramid {label} trace "
                  f"{k}: other rays than the jump frame's")
            diff = resp.hit != resj.hit
            if not shadow:
                diff |= resp.hit & ((resp.face != resj.face)
                                    | (resp.axis_coord != resj.axis_coord))
            for lane in torch.nonzero(diff & live)[:, 0].tolist():
                why.append(verify(
                    f"pyramid {label} trace {k} lane {lane}",
                    op[lane:lane + 1].cpu().numpy(),
                    (dp if shadow else dp[lane]).reshape(1, 3).cpu()
                    .numpy(), answer(resp, lane, shadow),
                    answer(resj, lane, shadow), msp, shadow))
                parted[lane] = True
        for k, ((hp, outp, msp), (hj, outj, _)) in enumerate(
                zip(rp["k12"], rj["k12"])):
            used = shaded_of(hp, mirrors)
            lanes = torch.nonzero((outp != outj) & used & ~parted)[:, 0]\
                .tolist()
            s_o, _ = shade.shade_surface_plain(*hp, sun3)
            for lane in lanes:
                why.append(verify(
                    f"pyramid {label} K12 call {k} lane {lane}",
                    s_o[lane:lane + 1].cpu().numpy(), sun_np[None],
                    bool(outp[lane]), bool(outj[lane]), msp, True))
                parted[lane] = True
        for k, ((hp, sp, pix, msp), (_, sj, _, _)) in enumerate(
                zip(rp["k14"], rj["k14"])):
            p_q = softshadow.query_points(*hp, sun_d, pix)[0]
            used = shaded_of(hp, mirrors) & ~parted
            for s_k, lane in torch.nonzero((sp != sj) & used[None])\
                    .tolist():
                q = p_q[lane:lane + 1].unbind(1)
                dirs = softshadow.sample_dir(s_k, *q, sun_d)[:3]
                start = torch.stack(softshadow.ray_start(*q, *dirs, sun_d),
                                    -1)
                why.append(verify(
                    f"pyramid {label} K14 call {k} sample {s_k} lane {lane}",
                    start.cpu().numpy(),
                    torch.stack(dirs, -1).cpu().numpy(), bool(sp[s_k, lane]),
                    bool(sj[s_k, lane]), msp, True))
                parted[lane] = True
        check(int(parted.sum()) <= PYR_SLACK, f"pyramid {label}: "
              f"{int(parted.sum())} lanes parted")
        px = (hdr_p != hdr_j).any(-1).reshape(-1) & ~parted
        check(not bool(px.any()), f"pyramid {label}: the HDR differs from "
              f"the jump grid's frame on {int(px.sum())} pixels off the "
              f"parted lanes {torch.nonzero(px)[:8, 0].tolist()}")
        u8_off = int((img_p != img_j).any(-1).sum())
        unused = sum(int(((sp != sj).any(0) & ~shaded_of(hp, mirrors))
                         .sum()) for (hp, sp, _, _), (_, sj, _, _)
                     in zip(rp["k14"], rj["k14"]))
        if unused:
            print(f"pyramid {label}: K14's sample hits differ from the jump "
                  f"grid's on {unused} mirror lanes whose shadow the frame "
                  "does not use (ROADMAP C13)")
        knobs_j = ", ".join(f"{k}={v}" for k, v in
                            PYR_VS_JUMP[label].items()) or "the same knobs"
        print(f"pyramid {label} vs the jump grid's frame ({knobs_j}): "
              f"{len(rp['trace'])} DDA calls, {len(rp['k12'])} K12 and "
              f"{len(rp['k14'])} K14 calls; {int(parted.sum())} lanes "
              f"parted ({why.count('tie')} ties, {why.count('capped')} "
              f"capped, printed above), the HDR equal on every other pixel; "
              f"u8 pixels that differ: {u8_off}")

    for label in PYR_VS_JUMP:
        pyr_vs_jump(label)

    # ---- K21 against its plain version on the DDA primary trace (with
    # the counters), each debug type
    res_c = traverse.trace_pyramid(pyr, o, d, cap, width=w, use_full=False)
    check(torch.equal(res_c.iterations, res_p.iterations),
          "K19 tiled with counters differs from flat")
    for t in range(1, 6):
        counter = (getattr(res_c, debug.HEATMAPS[t][0])
                   if debug.needs_stats(t) else None)
        out_k = torch.zeros((4, h, w), device=dev)
        out_p = torch.zeros((4, h, w), device=dev)
        before = kernels.LAUNCHES["debug_image"]
        debug.debug_image(o, d, res_c.face, res_c.axis_coord, counter, t,
                          out_k)
        check(kernels.LAUNCHES["debug_image"] == before + 1,
              "K21 did not launch once")
        debug.debug_image_plain(o, d, res_c.face, res_c.axis_coord, counter,
                                t, out_p)
        check(torch.equal(out_k, out_p), f"K21 debug {t}: "
              f"{int((out_k != out_p).any(0).sum())} pixels differ from "
              "plain")
    errs["debug_image"] = 0.0
    print(f"K21: the five debug images of the {w}x{h} primary trace (its "
          f"misses' far points included) bit-exact vs plain")

    # ---- K20 on the primary hits: overlap_ao, the cube and the planar
    # densities, through the overlap library's entry points with the
    # counters reset, each against its plain version
    hit_lanes = torch.nonzero(res_p.hit)[:, 0]
    normal_, world_, _ = shade._reconstruct(o, d, res_p.face,
                                            res_p.axis_coord)
    wpos = torch.stack(world_, -1)[hit_lanes].contiguous()
    wnrm = torch.stack(normal_, -1)[hit_lanes].contiguous()
    wface = res_p.face[hit_lanes].contiguous()
    kernels.reset_launches()
    ao_k = overlap.overlap_ao(pyr, wpos, wnrm, wface)
    cube_k = overlap.cube_overlap_density(pyr, wpos, 1.5)
    plane_k = overlap.planar_overlap_density(pyr, wpos, 0.8, wface)
    launches["overlap_density"] = kernels.LAUNCHES["overlap_density"]
    check(launches["overlap_density"] == 3, "K20 did not launch once a call")
    for what, got_, ref_ in (
            ("overlap_ao", ao_k, overlap.overlap_ao_plain(pyr, wpos, wnrm,
                                                          wface)),
            ("cube 1.5", cube_k, overlap.cube_overlap_density_plain(
                pyr, wpos, 1.5)),
            ("planar 0.8", plane_k, overlap.planar_overlap_density_plain(
                pyr, wpos, 0.8, wface))):
        check(torch.equal(got_, ref_), f"K20 {what}: "
              f"{int((got_ != ref_).sum())} of {got_.numel()} differ from "
              "plain")
    ao_j = overlap.overlap_ao_plain(jgrid, wpos, wnrm, wface)
    check(torch.equal(ao_k, ao_j), "overlap_ao through the jump grid's "
          "voxels differs from the pyramid's")
    errs["overlap_density"] = 0.0
    print(f"K20 on the {hit_lanes.numel()} primary hits: overlap_ao, the cube"
          f" (half 1.5) and the planar (half 0.8) densities bit-exact vs "
          f"plain; overlap_ao equal through the jump grid's voxels; AO mean "
          f"{float(ao_k.mean()):.4f}")

    # ---- the pyramid K12 on the raster hits: against its plain version
    # and an every-lane K19 shadow trace on every lit lane
    ras = rt.trace_raster(faces, rcam, d, probe, wcfg.size, w, h)
    hits = (o, d, ras.hit, ras.face, ras.axis_coord)
    e1, e2, _ = ss.sun_basis(sun_np)
    grids_k = rend["default knobs"]._sunmask()[2]
    ms_k = ss.masked_shadow_from_hits(pyr, *hits, sun_np, e1, e2, grids_k,
                                      cap)
    ms_p = ss.masked_shadow_from_hits_plain(pyr, *hits, sun_np, e1, e2,
                                            grids_k, cap)
    check(torch.equal(ms_k, ms_p), f"pyramid K12 vs plain: "
          f"{int((ms_k != ms_p).sum())} lanes differ")
    so_r, sa_r = shade.shade_surface(*hits, sun3)
    every = traverse.trace_pyramid(pyr, so_r, sun_d, cap, active=sa_r,
                                   width=w, stats=False,
                                   use_full=False).hit
    # a lane where they differ must be a shadow ray the walk caps before
    # the occluder the sun grids are certain of
    apart = torch.nonzero((ms_k & sa_r) != every)[:, 0]
    if apart.numel():
        it_a = traverse.trace_pyramid_plain(pyr, so_r[apart], sun_d, cap,
                                            use_full=False).iterations
        check(bool((it_a >= cap).all()), f"pyramid K12 and an every-lane "
              f"K19 shadow trace differ on {apart.numel()} lanes, not all "
              "capped")
    print(f"pyramid K12 vs an every-lane K19 shadow trace: equal but on "
          f"{apart.numel()} lanes the walk caps")
    branch = ss.shadow_branches(pyr, so_r, sun_np, e1, e2, grids_k, sa_r)
    counts = torch.bincount(branch, minlength=len(ss.BRANCHES)).tolist()
    residue = branch == ss.BRANCHES.index("residue")
    res_it = traverse.trace_pyramid(pyr, so_r, sun_d, cap, active=residue,
                                    use_full=False).iterations[residue]
    errs["masked_shadow_pyramid"] = 0.0
    print(f"pyramid K12: {int(sa_r.sum())} lit lanes bit-exact vs plain; "
          f"branches "
          f"{dict(zip(ss.BRANCHES, counts))}; residue steps "
          f"{int(res_it.sum())}")

    # ---- the pyramid K14 in its three modes, as the paged form is held
    _, cl_k = renderer._sky(0.0)
    cl_cpu = cl_k.cpu()
    cone_k = rend["soft, cone"]._sunmask()[2]
    gate = (e1, e2, cone_k)
    soft = {}
    for name, (pix, g) in {"DDA": (False, None), "cone gate": (False, gate),
                           "pixelated": (True, None)}.items():
        before = kernels.LAUNCHES["soft_shadow_pyramid"]
        fk, hk = softshadow.soft_shadow(pyr, *hits, sun_np, SOFT_SAMPLES,
                                        cl_k, cap, pix, g, with_hits=True,
                                        width=w)
        check(kernels.LAUNCHES["soft_shadow_pyramid"] == before + 1,
              f"pyramid K14 ({name}) did not launch once")
        hp = softshadow.sample_hits_plain(pyr, *hits, sun_np, SOFT_SAMPLES,
                                          cap, pix, g)
        check(torch.equal(hk, hp), f"pyramid K14 ({name}): "
              f"{int((hk != hp).sum())} sample hits differ from plain")
        fp = softshadow.shadow_factor_plain(
            *(t.cpu() for t in hits), sun_np, hk.cpu(), cl_cpu, pix)
        err = float((fk.cpu() - fp).abs().max())
        check(err <= SOFT_FACTOR_TOL, f"pyramid K14 ({name}): factor off "
              f"the plain factor by {err}")
        soft[name] = (fk, hk, err)
        print(f"pyramid K14 ({name}): {SOFT_SAMPLES} sample hits of {n} "
              f"lanes equal to plain ({int(hk.sum())} hits), factor max "
              f"|diff| {err:.3e} vs plain on the CPU")
    check(torch.equal(soft["DDA"][1], soft["cone gate"][1]),
          "pyramid K14: the cone gate's sample hits differ from the DDA "
          "mode's")
    errs["soft_shadow_pyramid"] = soft["cone gate"][2]

    # ---- the pyramid K15 at every bounce (BounceCheck) of config 4's
    # knobs, the lights frame and the overlap AO frame; and the kernel
    # path's frames against the plain path's
    checks = {}
    for label in ("config-4 knobs", "lights", "overlap AO"):
        r = rend[label]
        mirrors = PYR_PHASES[label][1]
        kw = frame_kw(r.cfg, r._sunmask() if r.use_sunmask else None)
        with BounceCheck(frame_mod, bounce, kernels) as bc:
            img_k, hdr_k = render_frame(pyr, o, d, r.sun, 0.25, r.cfg,
                                        mirror_materials=mirrors, **kw)
        check(len(bc.bounces) == (r.cfg.max_ray_iterations if mirrors
                                  else 1), f"pyramid {label}: "
              f"{len(bc.bounces)} bounces")
        for k, (live, hit_n, mir, shd, diff, nbe, _) in enumerate(
                bc.bounces):
            print(f"pyramid {label} bounce {k}: {live} live lanes, {hit_n} "
                  f"hits, {mir} mirrors, {shd} shaded; K15 vs plain bit for"
                  f" bit but the shaded rgb, max |diff| {diff:.3e} ({nbe} "
                  f"lanes not bit-equal)")
        checks[label] = bc
    errs["shade_bounce_pyramid"] = max(b[4] for b in
                                       checks["overlap AO"].bounces)
    for label in ("config-4 knobs", "lights", "overlap AO", "DDA",
                  "debug 1", "debug 4"):
        r = rend[label]
        mirrors = PYR_PHASES[label][1]
        kw = frame_kw(r.cfg, r._sunmask() if r.use_sunmask else None)
        img_k, hdr_k = render_frame(pyr, o, d, r.sun, 0.25, r.cfg,
                                    mirror_materials=mirrors, **kw)
        before = dict(kernels.LAUNCHES)
        with plain_path(kernels):
            img_q, hdr_q = render_frame(pyr, o, d, r.sun, 0.25, r.cfg,
                                        mirror_materials=mirrors, **kw)
        check(kernels.LAUNCHES == before, f"pyramid {label}: the plain "
              "path launched a kernel")
        check(torch.equal(hdr_k[..., 3], hdr_q[..., 3]),
              f"pyramid {label}: alpha differs from the plain path")
        close = torch.isclose(hdr_k, hdr_q, rtol=1e-4, atol=1e-4).all(-1)
        check(bool(close.all()), f"pyramid {label}: kernel vs plain path: "
              f"{int((~close).sum())} pixels beyond rtol=atol=1e-4")
        print(f"pyramid {label}: kernel path vs plain path on the card: "
              f"alpha equal, HDR within rtol=atol=1e-4 (max |diff| "
              f"{float((hdr_k - hdr_q).abs().max()):.3e}); u8 pixels that "
              f"differ: {int((img_k != img_q).any(-1).sum())}")

    # ---- the rows: kernel and plain times (CUDA events), device time
    # (torch.profiler), bounds
    def nbytes(*ts):
        return float(sum(t.nbytes for t in ts))

    lanes = float(sa_r.sum())
    p_q, act_q = softshadow.query_points(*hits, sun_d, False)
    kh, km = ss.soft_shadow_gate(p_q, sun_np, e1, e2, cone_k, act_q,
                                 wcfg.size)
    traced = act_q & ~kh & ~km
    soft_steps = 0.0
    for k in range(SOFT_SAMPLES):
        dirs = softshadow.sample_dir(k, *p_q.unbind(1), sun_d)[:3]
        start = torch.stack(softshadow.ray_start(*p_q.unbind(1), *dirs,
                                                 sun_d), -1)
        it = traverse.trace_pyramid(pyr, start, torch.stack(dirs, -1), cap,
                                    active=traced,
                                    use_full=False).iterations
        soft_steps += float(it[traced].sum())
    ov_args = checks["overlap AO"].first
    ov_shaded = float(checks["overlap AO"].bounces[0][3])
    trace_ops = OPS_PER_ITEM["pyramid_trace"]
    out_w = torch.zeros((4, h, w), device=dev)
    timed_rows = {
        "pyramid_trace": (
            lambda: traverse.trace_pyramid(pyr, o, d, cap, width=w,
                                           stats=False, use_full=False),
            lambda: traverse.trace_pyramid_plain(pyr, o, d, cap, stats=False,
                                                 use_full=False),
            nbytes(o, d, *(getattr(res_p, f) for f in fields[:4]))
            + rows_bytes(pyr, "K19 primary", lambda r: traverse.
                         trace_pyramid_plain(pyr, o, d, cap, stats=False,
                                             use_full=False, rows_read=r)),
            float(res_p.iterations.sum()) * trace_ops,
            ("vvr_trace_kernel", "VvrPyramidViewT"),
            launches.get("pyr pyramid_trace", 0) - launches.get("pyr shadow",
                                                                0)),
        "pyramid_trace_shadow": (
            lambda: traverse.trace_pyramid(pyr, so_p, sun_d, cap,
                                           active=sa_p, width=w, stats=False,
                                           use_full=False),
            lambda: traverse.trace_pyramid_plain(pyr, so_p, sun_d, cap, sa_p,
                                                 stats=False,
                                                 use_full=False),
            nbytes(so_p, sa_p, *(getattr(sh_p, f) for f in fields[:4]))
            + rows_bytes(pyr, "K19 shadow", lambda r: traverse.
                         trace_pyramid_plain(pyr, so_p, sun_d, cap, sa_p,
                                             stats=False, use_full=False,
                                             rows_read=r)),
            float(sh_p.iterations.sum()) * trace_ops,
            ("vvr_trace_kernel", "VvrPyramidViewT"),
            launches.get("pyr shadow", 0)),
        "masked_shadow_pyramid": (
            lambda: ss.masked_shadow_from_hits(pyr, *hits, sun_np, e1, e2,
                                               grids_k, cap),
            lambda: ss.masked_shadow_from_hits_plain(
                pyr, *hits, sun_np, e1, e2, grids_k, cap),
            nbytes(*hits, grids_k[0], ms_k)
            + rows_bytes(pyr, "pyramid K12", lambda r: ss.
                         masked_shadow_from_hits_plain(
                             pyr, *hits, sun_np, e1, e2, grids_k, cap,
                             rows_read=r)),
            lanes * OPS_PER_ITEM["masked_shadow"]
            + n * OPS_PER_ITEM["shade_surface"]
            + float(res_it.sum()) * trace_ops,
            ("vvr_masked_shadow_kernel", "VvrPyramidViewT"),
            launches.get("pyr masked_shadow_pyramid", 0)),
        "soft_shadow_pyramid": (
            lambda: softshadow.soft_shadow(pyr, *hits, sun_np, SOFT_SAMPLES,
                                           cl_k, cap, gate=gate, width=w),
            lambda: softshadow.soft_shadow_plain(
                pyr, *hits, sun_np, SOFT_SAMPLES, cl_k, cap, gate=gate),
            nbytes(*hits, cl_k, cone_k[0], soft["cone gate"][0])
            + rows_bytes(pyr, "pyramid K14, cone gate", lambda r: softshadow.
                         soft_shadow_plain(pyr, *hits, sun_np, SOFT_SAMPLES,
                                           cl_k, cap, gate=gate,
                                           rows_read=r)),
            float(act_q.sum()) * SOFT_SAMPLES * OPS_PER_ITEM["soft_shadow"]
            + soft_steps * trace_ops,
            ("vvr_soft_shadow_kernel", "VvrPyramidViewT"),
            launches.get("pyr soft_shadow_pyramid", 0)),
        "shade_bounce_pyramid": (
            lambda: bounce.shade_bounce(*ov_args),
            lambda: bounce.shade_bounce_plain(*ov_args),
            float(checks["overlap AO"].bounces[0][6])
            + rows_bytes(pyr, "pyramid K15, overlap AO", lambda r: bounce.
                         shade_bounce_plain(*ov_args, rows_read=r)),
            n * OPS_PER_ITEM["shade_bounce"]
            + ov_shaded * OVERLAP_AO_CELLS * OPS_PER_ITEM["overlap_density"],
            ("vvr_shade_bounce_kernel", "VvrPyramidViewT"),
            launches.get("pyr shade_bounce_pyramid", 0)),
        "overlap_density": (
            lambda: overlap.overlap_ao(pyr, wpos, wnrm, wface),
            lambda: overlap.overlap_ao_plain(pyr, wpos, wnrm, wface),
            nbytes(wpos, wnrm, wface, ao_k)
            + rows_bytes(pyr, "K20 overlap_ao", lambda r: overlap.
                         overlap_ao_plain(pyr, wpos, wnrm, wface,
                                          rows_read=r)),
            float(hit_lanes.numel()) * OVERLAP_AO_CELLS
            * OPS_PER_ITEM["overlap_density"],
            ("vvr_overlap_density_kernel",),
            launches["overlap_density"]),
        "debug_image": (
            lambda: debug.debug_image(o, d, res_c.face, res_c.axis_coord,
                                      None, 4, out_w),
            lambda: debug.debug_image_plain(o, d, res_c.face,
                                            res_c.axis_coord, None, 4,
                                            out_w),
            nbytes(o, d, res_c.face, res_c.axis_coord, out_w[:3]),
            n * OPS_PER_ITEM["debug_image"],
            ("vvr_debug_image_kernel",),
            launches.get("pyr debug_image", 0)),
    }
    rows = []
    for name, (kfn, pfn, moved, ops, parts, count) in timed_rows.items():
        k_ms, p_ms = cuda_ms(kfn, 10), cuda_ms(pfn, 1)
        dev_us = device_us(kfn, parts, 20, trace_path)
        cold_us = flushed_us(kfn, 20, dev)
        b_ms, b_by = bound_ms(moved, ops, "fp32")
        k = kernels.KERNELS[ROW_KERNEL.get(name, name)]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": count,
                     "max_abs_err": errs[name], "ms": k_ms,
                     "device_us": dev_us, "l2_flushed_us": cold_us,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"time {name} (pyramid, 256^3): kernel {k_ms:.4f} ms, device "
              f"{dev_us:.2f} us, {cold_us:.2f} us a launch with the L2 "
              f"flushed, plain torch {p_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by}; {moved:.0f} B), {count} launches in the frames")
    print(f"pyramid phase: {time.perf_counter() - t_phase:.1f} s; rays at "
          f"the cap: primary {cap_p}, shadow {cap_s}; frame medians {meds}")
    return rows


# the raster debug view (ROADMAP A14; phase 10 of the module docstring):
# debug_type 0 at 1920x1080, each frame K13, K22, K3 (the sky at the
# frame's own time), K23 and K4 once and nothing else
RASTER_FRAMES = 24
RASTER_PER_FRAME = ("generate_rays", "raster_triangles", "write_sky",
                    "shade_raster", "composite")
# K22's and K23's device kernels (csrc/meshraster.cu; K22's bin kernel
# is K9's, csrc/tilebin.cuh)
K22_PARTS = ("vvr_mesh_project_kernel", "vvr_tri_setup_kernel",
             "vvr_tri_scan_kernel", "vvr_bin_kernel", "vvr_tri_tile_kernel")
K23_PARTS = ("vvr_shade_raster_kernel",)
# operations per item, counted by hand from csrc/meshraster.cu: a vertex's
# projection (12 products and sums, two IEEE divisions, two FMAs), a
# triangle's setup (its area, reciprocal, box and flags), a box pixel's
# fragment test (two edge functions, three barycentrics, three IEEE
# divisions and the depth's reciprocal), a covered fragment's band test
# (the product, the compare and the id's min), a covered pixel's plane
# hit (the cross product, the norm's sqrtf, three divisions by it, two
# dots and the division of tplane, the start) and a sky pixel's two texel
# lookups and blend (five divisions); each HDDA step at pyramid_trace's
# rate. The function needs each fragment's test once: K22's second sweep
# repeats it, which the bound does not count.
RASTER_OPS = {"vertex": 45, "triangle": 40, "fragment": 70, "band": 3,
              "plane": 90, "sky": 70}


def raster_views(occ):
    """The bench camera, a camera 1.6 voxels above the ground at the
    world's centre column looking along it (triangles wider than a tile)
    and one 0.4 voxels above it looking down the slope (its near plane
    cuts the terrain: straddlers), as (label, Camera)."""
    import numpy as np

    from vvr_tpu_torch.utils.camera import Camera
    c = occ.shape[0] // 2
    h = int(np.max(np.nonzero(occ[c, :, c])[0]))
    ht = int(np.max(np.nonzero(occ[c, :, c + 4])[0]))
    return [("bench", Camera.look_at(*CAMERA[:2], fov=CAMERA[2])),
            ("close-up", Camera.look_at([c + 0.5, h + 1.6, c + 0.5],
                                        [c + 0.5, ht + 0.5, c + 4.5],
                                        fov=85.0)),
            ("straddling", Camera.look_at([c + 0.5, h + 0.4, c + 0.5],
                                          [c + 6.5, h - 0.2, c + 6.5],
                                          fov=100.0))]


def raster_phase(repo, dev, scene, occ, errs: dict,
                 launches: dict) -> list:
    """Phase 10 (module docstring) at 256^3: the mesh, K22 and K23 against
    their plain versions on the three views of `raster_views`, the kernel
    path's frames against the plain path's, the frames through
    `Renderer.render` with their launches, a profiled window. Returns the
    kernels line's rows of K22 and K23."""
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import sky as sky_ops
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.ops.traverse import trace_pyramid_plain
    from vvr_tpu_torch.render import raster
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.tools import profile_frame
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import (cuda_ms, device_us,
                                                   flushed_us)

    t_phase = time.perf_counter()
    trace_path = repo / "build" / "vvr_tpu_torch" / "raster_trace.json"
    for part in ("vvr_mesh_project", "vvr_tri_", "vvr_bin_kernel",
                 "vvr_shade_raster"):
        for name, regs, st, ld in kernels.ptxas_usage(part):
            print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
    cfg = RenderConfig(width=1920, height=1080, debug_type=0)
    w, h, n = cfg.width, cfg.height, cfg.width * cfg.height
    r = Renderer(WorldConfig(depth=4), cfg, device=dev, scene=scene)
    check(r.raster_view and r.grid is scene.pyramid,
          "debug_type 0 must draw the raster view over the pyramid")
    t0 = time.perf_counter()
    mesh = r.mesh
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    nv, nt = mesh.verts.shape[0], mesh.tris.shape[0]
    print(f"raster view mesh (256^3, surface nets, host): {t_mesh:.3f} s, "
          f"{nv} vertices, {nt} triangles, {len(mesh.buffers.ranges)} "
          f"partial chunks, {mesh.nbytes() / 2**20:.2f} MiB on the card")
    pyr = scene.pyramid
    sun3 = r.sun[:3]
    skybox, clouds = sky_ops.write_sky(sun3, 0.0, cfg.skybox_resolution,
                                       cfg.clouds_resolution, dev)
    cap = cfg.traversal_max_steps
    k22_err = k23_err = 0.0
    timing = None
    for label, cam in raster_views(occ):
        m = raster.view_proj(cam, w, h)
        ev, et = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                        cam.position, cam.basis()[2])
        evd, etd = torch.from_numpy(ev).to(dev), torch.from_numpy(et).to(dev)
        va, ta = torch.cat([mesh.verts, evd]), torch.cat([mesh.tris, etd])
        z, win = raster.raster_triangles(mesh.verts, mesh.tris, m, w, h, evd,
                                         etd)
        zp, wp = raster.raster_triangles_plain(va, ta, m, w, h)
        zdiff = int((z.view(torch.int32) != zp.view(torch.int32)).sum())
        wdiff = int((win != wp).sum())
        check(zdiff == 0 and wdiff == 0,
              f"{label}: K22 differs from its plain version: z-buffer bits "
              f"at {zdiff} pixels, winner at {wdiff}")
        ts = raster.triangle_setup(*raster.project_verts(va, m, w, h), ta)
        wide = int((((ts.x1 - ts.x0 > 32) | (ts.y1 - ts.y0 > 32))
                    & ts.draws).sum())
        frags = raster.raster_plan(ts, w, h)[3]
        cov_frags = sum(len(f[0]) for f in
                        raster.covered_fragments(va, ta, m, w, h))
        covered = win != raster.NO_TRI
        _, d = camera_rays(cam, w, h, dev)
        hk = raster.shade_raster(win, mesh.verts, mesh.tris, pyr,
                                 cam.position, d, sun3, skybox, clouds, cap,
                                 w, h, evd, etd)
        hp = raster.shade_raster_plain(win, va, ta, pyr, cam.position, d,
                                       torch.from_numpy(sun3), skybox, clouds,
                                       cap, w, h)
        hk2, hp2 = hk.reshape(4, n), hp.reshape(4, n)
        cov_diff = int((hk2[:, covered] != hp2[:, covered]).sum())
        sky_err = float((hk2[:3, ~covered] - hp2[:3, ~covered]).abs().max()) \
            if bool((~covered).any()) else 0.0
        sky_ok = bool(torch.allclose(hk2[:, ~covered], hp2[:, ~covered],
                                     rtol=1e-4, atol=1e-5))
        check(cov_diff == 0 and sky_ok,
              f"{label}: K23 differs from its plain version: {cov_diff} "
              f"values on covered pixels, sky max {sky_err}")
        k23_err = max(k23_err, float((hk - hp).abs().max()))
        white = int((hk2[0, covered] == 1.0).sum())
        print(f"raster view, {label}: {len(et)} straddler triangles (from "
              f"{len(ev) // 2} straddlers), {wide} drawing triangles wider "
              f"than a 32-pixel tile, {frags} box fragments "
              f"({cov_frags} covered), "
              f"{int(covered.sum())} covered pixels ({white} in shadow); "
              f"K22 equals its plain version (z-buffer bits, winner), K23 "
              f"equals its plain version (HDR, sky max abs err {sky_err})")
        # the kernel path's frame against the plain path's: the same
        # winners; the plain path's rays (torch on the card) and sky
        # textures differ from K13's and K3's in the last ulp
        kernels.reset_launches()
        img_k, hdr_k = raster.raster_debug_frame(mesh, pyr, cam, r.sun, 0.0,
                                                 cfg)
        with plain_path(kernels):
            img_p, hdr_p = raster.raster_debug_frame(mesh, pyr, cam, r.sun,
                                                     0.0, cfg)
            _, d_p = camera_rays(cam, w, h, dev)
        check(kernels.LAUNCHES["raster_triangles"] == 1
              and kernels.LAUNCHES["shade_raster"] == 1,
              f"{label}: the plain path launched a kernel")
        a, b = hdr_k.reshape(4, n), hdr_p.reshape(4, n)
        ray_moved = (d != d_p).any(1)
        flips = covered & (a[0] != b[0])
        # sky pixels: within K3's tolerance, or a neighbouring texel where
        # the ray moved
        sky_off = ~covered & ~torch.isclose(a[:3], b[:3], rtol=1e-4,
                                            atol=1e-4).all(0)
        check(not bool(((flips | sky_off) & ~ray_moved).any())
              and bool(torch.equal(a[3], b[3])),
              f"{label}: the kernel and plain frames differ where the rays "
              f"agree: {int((flips & ~ray_moved).sum())} covered, "
              f"{int((sky_off & ~ray_moved).sum())} sky pixels")
        check(int((flips | sky_off).sum()) <= n // 10000 + 8,
              f"{label}: kernel frame against the plain frame: "
              f"{int(flips.sum())} shadow flips, {int(sky_off.sum())} sky "
              f"texels moved")
        u8 = (img_k.int() - img_p.int()).abs().amax(-1)
        print(f"raster view, {label}: kernel path's frame against the plain "
              f"path's: {int(flips.sum())} covered pixels flip and "
              f"{int(sky_off.sum())} sky pixels take another texel, each "
              f"where the plain rays differ from K13's "
              f"({int(ray_moved.sum())} such rays); u8 off by more than 1 "
              f"at "
              f"{int((u8 > 1).sum())} pixels, max {int(u8.max())}")
        if label == "bench":
            s_o, _ = raster.shadow_rays(win, va, ta, cam.position, d, sun3)
            sun_d = torch.from_numpy(sun3).to(dev)
            rays_it = trace_pyramid_plain(pyr, s_o, sun_d, cap,
                                          active=covered, stats=True,
                                          use_full=False).iterations
            sky_px = float((~covered).sum())
            rows_b = rows_bytes(pyr, "K23 shadow rays", lambda rd:
                                trace_pyramid_plain(
                                    pyr, s_o, sun_d, cap, active=covered,
                                    stats=False, use_full=False,
                                    rows_read=rd))
            tex = float(skybox.nbytes + clouds.nbytes)
            # the winning triangles and their corners, each read once
            won = torch.unique(win[covered].long())
            mesh_b = float(won.numel() * 12
                           + torch.unique(ta[won].long()).numel() * 12)
            # the bench view's inputs bound now: the loop goes on to the
            # other views
            timing = dict(
                k22=(lambda m=m, evd=evd, etd=etd: raster.raster_triangles(
                    mesh.verts, mesh.tris, m, w, h, evd, etd),
                     lambda m=m, va=va, ta=ta: raster.raster_triangles_plain(
                         va, ta, m, w, h),
                     float(va.nbytes + ta.nbytes + 8 * n),
                     float(va.shape[0]) * RASTER_OPS["vertex"]
                     + float(ta.shape[0]) * RASTER_OPS["triangle"]
                     + float(frags) * RASTER_OPS["fragment"]
                     + float(cov_frags) * RASTER_OPS["band"]),
                k23=(lambda win=win, pos=cam.position, d=d, evd=evd,
                     etd=etd: raster.shade_raster(
                         win, mesh.verts, mesh.tris, pyr, pos, d, sun3,
                         skybox, clouds, cap, w, h, evd, etd),
                     lambda win=win, va=va, ta=ta, pos=cam.position, d=d:
                     raster.shade_raster_plain(
                         win, va, ta, pyr, pos, d, torch.from_numpy(sun3),
                         skybox, clouds, cap, w, h),
                     float(win.nbytes + d.nbytes + hk.nbytes) + mesh_b
                     + rows_b + min(sky_px * 28, tex),
                     float(covered.sum()) * RASTER_OPS["plane"]
                     + sky_px * RASTER_OPS["sky"]
                     + float(rays_it.sum()) * OPS_PER_ITEM["pyramid_trace"]))

    # ---- the frames through Renderer.render, counters reset before and
    # read after; no plain version runs
    cam = raster_views(occ)[0][1]
    plain_calls = []
    saved = raster.raster_triangles_plain, raster.shade_raster_plain
    raster.raster_triangles_plain = \
        lambda *a, **k: plain_calls.append("K22") or saved[0](*a, **k)
    raster.shade_raster_plain = \
        lambda *a, **k: plain_calls.append("K23") or saved[1](*a, **k)
    try:
        r.render(cam, time=0.0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        ms = []
        img = None
        for i in range(RASTER_FRAMES):
            t0 = time.perf_counter()
            img = r.render(cam, time=i / 60.0, timed=True)
            ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        raster.raster_triangles_plain, raster.shade_raster_plain = saved
    check(not plain_calls, f"the raster frames ran plain versions: "
          f"{plain_calls}")
    check(got == {k: RASTER_FRAMES for k in RASTER_PER_FRAME},
          f"raster frames: launches {got}, expected each of "
          f"{RASTER_PER_FRAME} once in each of {RASTER_FRAMES} frames")
    check(tuple(img.shape) == (h, w, 3) and float(img.float().std()) > 10,
          "the raster frame is empty or constant")
    for k in ("raster_triangles", "shade_raster"):
        launches[k] = got[k]
    med = sorted(ms)[RASTER_FRAMES // 2]
    print(f"raster view frames (bench camera, 256^3): {RASTER_FRAMES} at "
          f"{w}x{h}, median {med:.4f} ms, min {min(ms):.4f}, max "
          f"{max(ms):.4f} (host clock around Renderer.render(timed=True), "
          f"which synchronizes); launches {got}; no plain version ran")
    wall, events = profile_frame.profiled_window(r, cam, 8, trace_path)
    dev_ev = [e for e in events if e.get("cat") in profile_frame.DEVICE_CATS]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"]
                                                         for e in events)
    busy = profile_frame.union_us((e["ts"], e["ts"] + e["dur"])
                                  for e in dev_ev)
    per = {}
    for e in dev_ev:
        per[e["name"]] = per.get(e["name"], 0.0) + e["dur"] / 8
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    print(f"raster view profiled window: 8 synchronized frames, host "
          f"{wall:.4f} ms a frame, device busy {busy / 8 / 1e3:.4f} ms a "
          f"frame, busy share {busy / span:.4f}; device us a frame by "
          f"kernel: " + ", ".join(f"{k[:40]} {v:.2f}" for k, v in top))

    rows = []
    for name, key, parts in (("raster_triangles", "k22", K22_PARTS),
                             ("shade_raster", "k23", K23_PARTS)):
        kfn, pfn, moved, ops = timing[key]
        k_ms, p_ms = cuda_ms(kfn, 10), cuda_ms(pfn, 1)
        dev_us = device_us(kfn, parts, 20, trace_path, each=True)
        cold_us = flushed_us(kfn, 20, dev)
        b_ms, b_by = bound_ms(moved, ops, "fp32")
        k = kernels.KERNELS[name]
        errs[name] = k22_err if key == "k22" else k23_err
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k_ms,
                     "device_us": dev_us, "l2_flushed_us": cold_us,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"time {name} (raster view, bench camera, 256^3): kernel "
              f"{k_ms:.4f} ms, device {dev_us:.2f} us, {cold_us:.2f} us a "
              f"call with the L2 flushed, plain torch "
              f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {moved:.0f} B, "
              f"{ops:.0f} operations), {launches[name]} launches in the "
              f"frames")
    print(f"raster phase (256^3): {time.perf_counter() - t_phase:.1f} s")
    return rows


def raster_phase_1024(repo, dev, chunks) -> None:
    """Phase 10 at 1024^3: one raster frame over config 5's chunks (its
    camera) through `Renderer.render`, the pyramid built on the card, the
    mesh's host time, its triangles; then K22's and K23's device time on
    that frame's inputs."""
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.ops import sky as sky_ops
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import raster
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.render.scene import Scene
    from vvr_tpu_torch.tools.profile_frame import device_us
    from vvr_tpu_torch.utils.camera import Camera

    t_phase = time.perf_counter()
    trace_path = repo / "build" / "vvr_tpu_torch" / "raster_trace.json"
    wcfg = WorldConfig(depth=5)
    cfg = RenderConfig(width=1920, height=1080, debug_type=0)
    w, h = cfg.width, cfg.height
    scene = Scene(wcfg, chunks, device=dev)
    t0 = time.perf_counter()
    r = Renderer(wcfg, cfg, device=dev, scene=scene)
    torch.cuda.synchronize()
    t_pyr = time.perf_counter() - t0
    check(scene.paged is None and scene.jumpgrid is None
          and scene.pyramid is not None,
          "the 1024^3 raster view must build the pyramid and no grid")
    t0 = time.perf_counter()
    mesh = r.mesh
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    cam = Camera.look_at(*C5_CAMERA[:2], fov=C5_CAMERA[2])
    kernels.reset_launches()
    t0 = time.perf_counter()
    img = r.render(cam, time=0.0, timed=True)
    t_frame = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(got == {k: 1 for k in RASTER_PER_FRAME},
          f"1024^3 raster frame launches {got}")
    check(float(img.float().std()) > 10, "the 1024^3 raster frame is empty")
    m = raster.view_proj(cam, w, h)
    ev, et = raster.clip_straddlers(mesh.verts_host, mesh.tris_host,
                                    cam.position, cam.basis()[2])
    evd, etd = torch.from_numpy(ev).to(dev), torch.from_numpy(et).to(dev)
    _, win = raster.raster_triangles(mesh.verts, mesh.tris, m, w, h, evd, etd)
    _, d = camera_rays(cam, w, h, dev)
    skybox, clouds = sky_ops.write_sky(r.sun[:3], 0.0, cfg.skybox_resolution,
                                       cfg.clouds_resolution, dev)
    us = {"K22": device_us(lambda: raster.raster_triangles(
        mesh.verts, mesh.tris, m, w, h, evd, etd), K22_PARTS, 10,
        trace_path, each=True), "K23": device_us(
            lambda: raster.shade_raster(
                win, mesh.verts, mesh.tris, scene.pyramid, cam.position, d,
                r.sun[:3], skybox, clouds, cfg.traversal_max_steps, w, h,
                evd, etd), K23_PARTS, 10, trace_path)}
    print(f"raster view at 1024^3 (config 5's chunks and camera): pyramid "
          f"on the card {t_pyr:.2f} s (with the dense occupancy), mesh "
          f"{t_mesh:.2f} s (host, {len(mesh.buffers.ranges)} partial "
          f"chunks), {mesh.verts.shape[0]} vertices, {mesh.tris.shape[0]} "
          f"triangles ({len(et)} straddler triangles), "
          f"{mesh.nbytes() / 2**20:.1f} MiB; one frame through "
          f"Renderer.render {t_frame:.3f} ms (synchronized; host clipping "
          f"included); device us a call: K22 {us['K22']:.2f}, K23 "
          f"{us['K23']:.2f}; phase {time.perf_counter() - t_phase:.1f} s")

# setup from cold and the app shell (ROADMAP A15, B9; phase 11 of the
# module docstring)
# K24's operations a column: each corner's lattice hash (15 integer
# operations), gradient (6) and dot (4); each octave's coordinates,
# floors, fades, lerps and sum (28); the terrace and the detail (12)
TERRAIN_OPS = {"corner": 25, "octave": 28, "column": 12}
APP_DEFAULT = ("generate_rays", "raster_fragments", "raster_resolve",
               "masked_shadow", "shade_pixel", "bloom_pyramid", "composite")
# the kernels each view launches once a frame in the App: the main view's
# (the rasterizer and the classifier, as its Renderer was made), the
# raster debug view's (RASTER_PER_FRAME) and a heatmap's (the main view's
# primary and shadow kernels, K21, the composite without bloom)
APP_VIEW = {6: APP_DEFAULT, 0: RASTER_PER_FRAME}
APP_VIEW.update({v: ("generate_rays", "raster_fragments", "raster_resolve",
                     "masked_shadow", "shade_pixel", "debug_image",
                     "composite") for v in range(1, 6)})
# the scripted flight: (label, frames, keys pressed at its first frame,
# keys released there, keys held through it); the view is the Renderer's
# debug_type after its first frame's keys
APP_SEGMENTS = (("fly, W with boost", 8, ("w", "shift"), (), ()),
                ("S and A", 4, ("s", "a"), ("w", "shift"), ()),
                ("D", 4, ("d",), ("s", "a"), ()),
                *((f"H -> view {(6 + k) % 7}", 4, ("h",), ("h", "d"), ())
                  for k in range(1, 8)),
                ("G -> view 5", 4, ("g",), ("h",), ()),
                ("H -> view 6", 2, ("h",), ("g",), ()),
                ("middle-mouse drag", 6, ("mouse_middle",), ("h",),
                 ("mouse",)),
                ("release, L (capture), J, U", 4, ("l", "j", "u"),
                 ("mouse_middle",), ()),
                ("O, I", 2, ("o", "i"), ("l", "j", "u"), ()))
APP_CAPTURE_MAX = 2000   # frames the L capture may take to end
# where the flight starts: above the 256^3 terrain, looking along -z (the
# App's first pose, snapshot 0 scaled to 256^3, lies inside the terrain,
# and its rotation comes from the mouse alone, as in the JAX App)
APP_START = (128.0, 100.0, 240.0)


def terrain_ops(cfg) -> float:
    """K24's operations for one call (TERRAIN_OPS per column)."""
    octaves = cfg.fbm_octaves + cfg.detail_octaves
    per_column = (octaves * (4 * TERRAIN_OPS["corner"]
                             + TERRAIN_OPS["octave"])
                  + TERRAIN_OPS["column"])
    return float(cfg.size) ** 2 * per_column


def setup_phase(repo, dev, errs: dict, main_launches: int) -> list:
    """Phase 11's first half (module docstring): K24 against its plain
    versions, the worlds from cold and their SVO trees. Returns K24's row
    of the kernels line, its launches the main path's (its world from
    cold, phase 2)."""
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.config import WorldConfig
    from vvr_tpu_torch.render.scene import build_scene
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import cuda_ms, device_us
    from vvr_tpu_torch.world import generator
    from vvr_tpu_torch.world import tree as tree_mod

    t_phase = time.perf_counter()
    trace_path = repo / "build" / "vvr_tpu_torch" / "setup_trace.json"
    row = None
    for depth in (4, 5):
        wcfg = WorldConfig(depth=depth)
        s = wcfg.size
        kernels.reset_launches()
        k = generator.height_field(wcfg, dev)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["height_field"] == 1,
              f"height_field at {s}^2: {kernels.LAUNCHES['height_field']} "
              "launches of K24, expected 1")
        plain_dev = generator.height_field_plain(wcfg, dev)
        t0 = time.perf_counter()
        plain_cpu = generator.height_field_plain(wcfg, "cpu")
        t_cpu = time.perf_counter() - t0
        kb = k.cpu().numpy().view(np.uint32)
        diff_dev = int((kb != plain_dev.cpu().numpy().view(np.uint32))
                       .sum())
        diff_cpu = int((kb != plain_cpu.numpy().view(np.uint32)).sum())
        err = float((k.cpu() - plain_cpu).abs().max())
        check(diff_dev == 0 and diff_cpu == 0,
              f"K24 at {s}^2: {diff_dev} columns differ from the plain "
              f"version on the card, {diff_cpu} from it on the CPU")
        check(bool(torch.isfinite(k).all()), "K24 wrote a non-finite height")
        k_ms = cuda_ms(lambda: generator.height_field(wcfg, dev), 10)
        p_ms = cuda_ms(lambda: generator.height_field_plain(wcfg, dev), 1)
        dev_us = device_us(lambda: generator.height_field(wcfg, dev),
                           ("vvr_height_field",), 20, trace_path)
        ops = terrain_ops(wcfg)
        b_ms, b_by = bound_ms(4.0 * s * s, ops, "fp32")
        print(f"K24 height_field at {s}^2: columns differing from the plain "
              f"version on the card {diff_dev}, on the host CPU {diff_cpu} "
              f"(plain on the CPU {t_cpu:.2f} s), max abs err {err}; kernel "
              f"{k_ms:.4f} ms, device {dev_us:.2f} us, plain torch on the "
              f"card {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {ops:.0f} "
              f"operations), share {b_ms * 1e3 / dev_us:.3f}")
        if depth == 5:
            errs["height_field"] = err
            kk = kernels.KERNELS["height_field"]
            row = {"name": "height_field", "route": "cuda",
                   "source": kk.source, "replaces": kk.replaces,
                   "launches": main_launches, "max_abs_err": err,
                   "ms": k_ms, "device_us": dev_us, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del k, plain_dev, plain_cpu

    earlier = {4: "not measured", 5: "3.02-5.49 s (PERF.md section 5)"}
    for depth in (4, 5):
        wcfg = WorldConfig(depth=depth)
        s = wcfg.size
        steps = {}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        scene = build_scene(wcfg, dev, force_regenerate=True,
                            cache_path=repo / "build" / "vvr_tpu_torch"
                            / f"map_{s}.npz")
        steps["world from cold (K24, the host's chunk split, the cache "
              "file)"] = time.perf_counter() - t0
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(got == {"height_field": 1},
              f"the {s}^3 world from cold launched {got}, expected K24 "
              "once")
        t0 = time.perf_counter()
        generator.height_field(wcfg, dev).cpu()
        steps["height field alone (K24 and its copy to the host)"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        t = scene.ensure_tree()
        torch.cuda.synchronize()
        steps["SVO tree (dense occupancy, pyramids, flatten on the card)"] \
            = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree_mod.verify_popcount_invariant(t)
        steps["verify_popcount_invariant"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pyr = scene.ensure_pyramid()
        torch.cuda.synchronize()
        steps["brick pyramid"] = time.perf_counter() - t0
        masks = tree_mod.brick_pyramid_masks(t, pyr)
        bad = int((masks != t.bitmasks).sum())
        check(bad == 0, f"{s}^3 tree: {bad} of {t.num_nodes} node bitmasks "
              "differ from the brick pyramid's any masks")
        counts = t.metrics["level_counts"]
        print(f"setup {s}^3 (host clock, synchronized): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in steps.items())
            + f"; world generation with plain torch before K24: "
            f"{earlier[depth]}")
        mib = t.memory_bytes() / 2 ** 20
        print(f"SVO tree {s}^3: {t.num_nodes} nodes, per level "
              f"{counts}, {t.metrics['full_nodes']} full, avg bits set "
              f"{t.metrics['avg_bits_set']:.3f}, {mib:.2f} MiB on the card; "
              f"popcount invariant holds; every bitmask equals its cell's "
              f"any mask in the brick pyramid")
        del scene, t, pyr, masks
    print(f"setup phase: {time.perf_counter() - t_phase:.1f} s")
    return [row]


def app_phase(repo, dev, scene) -> None:
    """Phase 11's second half (module docstring): the App's scripted
    flight over the 256^3 scene at 1920x1080, the default knobs."""
    import numpy as np
    import torch

    from vvr_tpu_torch import kernels
    from vvr_tpu_torch.app import App
    from vvr_tpu_torch.config import RenderConfig, WorldConfig
    from vvr_tpu_torch.render.renderer import Renderer

    t_phase = time.perf_counter()
    r = Renderer(WorldConfig(depth=4), RenderConfig(width=1920, height=1080),
                 device=dev, scene=scene)
    app = App(r)
    app.movement.position = np.array(APP_START, np.float32)
    plan = []
    for label, n, press, release, hold in APP_SEGMENTS:
        plan += [(label, i, press, release, hold) for i in range(n)]
    # the first frame and the raster view's first must show terrain
    shown = {0, next(j for j, p in enumerate(plan) if p[0] == "H -> view 0")}
    segs = []          # (label, view, frames, launches, dragged, ms)
    state = {"frame_t": None, "ms": [], "views": set(), "drag": []}

    def close(label):
        torch.cuda.synchronize()
        segs.append((label, sorted(state["views"]), len(state["ms"]),
                     {k: v for k, v in kernels.LAUNCHES.items() if v},
                     list(state["drag"]), list(state["ms"])))
        kernels.reset_launches()
        state.update(ms=[], views=set(), drag=[])

    def script(frame, inp):
        if frame < len(plan):
            label, i, press, release, hold = plan[frame]
            if i == 0:
                if frame:
                    close(plan[frame - 1][0])
                for key in release:
                    inp.key_up(key)
                for key in press:
                    inp.key_down(key)
            if "mouse" in hold:
                inp.mouse_move(40.0, 6.0)
        elif frame == len(plan):
            close(plan[-1][0])
            inp.key_up("o")
            inp.key_up("i")
        if frame >= len(plan) and r.stats.benchmark is None:
            inp.key_down("q")

    def sink(frame, img):
        now = time.perf_counter()
        if state["frame_t"] is not None:
            state["ms"].append((now - state["frame_t"]) * 1e3)
        else:
            state["ms"].append(float("nan"))
        state["frame_t"] = now
        state["views"].add(r.cfg.debug_type)
        state["drag"].append(r._sun_dragging)
        if frame in shown:
            check(tuple(img.shape) == (1080, 1920, 3)
                  and float(img.float().std()) > 10,
                  f"App frame {frame} is empty or constant")

    torch.cuda.synchronize()
    kernels.reset_launches()
    n = app.run(max_frames=len(plan) + APP_CAPTURE_MAX, script=script,
                frame_sink=sink)
    close("L capture until it ends, then Q")
    check(not app.running, "the App did not quit on Q")
    check(r.stats.last_result is not None,
          "the L capture did not end within the run")
    seen_views = sorted({v for s_ in segs for v in s_[1]})
    check(seen_views == list(range(7)), f"the flight saw views {seen_views}")
    for label, views, frames, got, drag, ms in segs:
        check(len(views) == 1, f"App segment {label!r}: views {views}")
        need = APP_VIEW[views[0]]
        want = {k: frames for k in need}
        dragged = sum(drag)
        if dragged:
            check(dragged == frames, f"App segment {label!r}: the sun was "
                  f"dragged in {dragged} of {frames} frames")
            want["sun_grids"] = frames
            want["write_sky"] = frames
        extra = {k: v for k, v in got.items() if k not in want}
        # the classifier's full grids come back once after a drag, and the
        # first frame builds the sun grids and the sky
        allowed = {"sun_grids": 1, "write_sky": 1} if views[0] == 6 else {}
        check(all(k in allowed and v <= allowed[k] for k, v in extra.items())
              and all(got.get(k, 0) == v for k, v in want.items()),
              f"App segment {label!r} (view {views[0]}, {frames} frames): "
              f"launches {got}, expected {want}")
        timed = [x for x in ms if x == x]
        med = sorted(timed)[len(timed) // 2] if timed else float("nan")
        print(f"App segment {label!r}: view {views[0]}, {frames} frames, "
              f"median frame {med:.3f} ms (host clock from one frame's end "
              f"to the next's, each frame synchronized), launches {got}")
    res = r.stats.last_result or {}
    print(f"App flight: {n} frames through App.run (256^3, 1920x1080, the "
          f"default knobs), quit on Q; L capture: {res}; memory report "
          f"{ {k: round(v, 2) for k, v in r.memory_report().items()} }; "
          f"camera at {np.round(app.movement.position, 2).tolist()} "
          f"(fixed snapshot {app.movement.fixed_mode_snapshot_index}); "
          f"phase {time.perf_counter() - t_phase:.1f} s")


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
    from vvr_tpu_torch.ops import (bounce, gather, jump, post, shade, sky,
                                   softshadow)
    from vvr_tpu_torch.ops import rastertrace as rt
    from vvr_tpu_torch.ops import raygen
    from vvr_tpu_torch.ops import sunshadow as ss
    from vvr_tpu_torch.ops.raygen import camera_rays
    from vvr_tpu_torch.render import frame as frame_mod
    from vvr_tpu_torch.render.frame import render_frame
    from vvr_tpu_torch.render.oracle import trace_dense
    from vvr_tpu_torch.render.renderer import Renderer
    from vvr_tpu_torch.tools import (k14_split, microbench_gather,
                                     profile_frame, sass_count)
    from vvr_tpu_torch.tools.microbench_gather import bound_ms
    from vvr_tpu_torch.tools.profile_frame import (L2_FLUSH_BYTES, cuda_ms,
                                                   device_us)
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
    # the cone grids' support pass takes its least depths with atomicMin on
    # its 256 KB grid; no other K11 kernel may touch device memory so
    k11_atomics = {k: v["global_atomics"] for k, v in k11_sass.items()
                   if K11_SUPPORT not in k}
    support_atomics = {k: v["global_atomics"] for k, v in k11_sass.items()
                       if K11_SUPPORT in k}
    support_ops = {op: c for ops in sass_count.opcodes(
        sass, (K11_SUPPORT,)).values() for op, c in ops.items()
        if "RED" in op or "ATOM" in op}
    check(len(support_atomics) == 1
          and sum(support_atomics.values()) > 0,
          f"K11's support pass: {support_atomics} ({support_ops}), expected "
          "one kernel with global atomics")
    check(any("vvr_sun_tile_kernel" in k for k in k11_sass),
          f"K11's tile kernel missing from the SASS: {sorted(k11_sass)}")
    check(not any(("fill" in k or "decode" in k) for k in k11_sass),
          f"K11 has a fill or decode kernel: {sorted(k11_sass)}")
    check(sum(k11_atomics.values()) == 0,
          f"K11's kernels hold global atomics (ATOMG, RED, REDG, ATOM): "
          f"{k11_atomics}")
    print(f"K11 SASS (sass_count.py): global atomic instructions (ATOMG, "
          f"RED, REDG, ATOM) {sum(k11_atomics.values())} in its "
          f"{len(k11_atomics)} grid kernels {sorted(k11_atomics)}, "
          f"{sum(support_atomics.values())} in the support pass "
          f"{support_ops}")
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
          f"jump grid {tuple(renderer.grid.rows.shape)}, "
          f"{faces[0].shape[0]} merged faces)")
    check(renderer.use_raster and renderer.use_sunmask,
          "the default knobs must resolve to the rasterizer and classifier")
    grid = renderer.grid

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
    frame_kernels = ["generate_rays", "shade_pixel", "write_sky",
                     "bloom_pyramid", "composite", "raster_fragments",
                     "raster_resolve", "sun_grids", "masked_shadow"]
    per_frame = ["generate_rays", "shade_pixel", "bloom_pyramid",
                 "composite", "raster_fragments", "raster_resolve",
                 "masked_shadow"]
    dda_kernels = ["generate_rays", "jump_trace", "shade_surface",
                   "shade_pixel", "bloom_pyramid", "composite"]
    dda_per_frame = ["generate_rays", "shade_surface", "shade_pixel",
                     "bloom_pyramid", "composite"]
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
        per = sum(v for k, v in got.items()
                  if kernels.KERNELS[k].path != "setup") / n_frames
        print(f"kernel launches per {label} frame: {per:.2f} through "
              f"kernels.launch (the world's K24 not counted)")
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
    check(launches["height_field"] == 1, f"the world from cold launched K24 "
          f"{launches['height_field']} times, expected once")
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

    # ---- 3c. soft and pixelated shadows over the same scene, each
    # configuration's counters reset before its frames and read after:
    # K13, K9, K10, K14, K2 shade_pixel and K4 once in every frame (with
    # one pixelated sample, K2 shade_surface and K1's shadow trace in place
    # of K14), K3 once a sky bucket, the cone grids (K11) once
    soft_per_frame = ["generate_rays", "raster_fragments", "raster_resolve",
                      "soft_shadow", "shade_pixel", "bloom_pyramid",
                      "composite"]
    pix1_per_frame = ["generate_rays", "raster_fragments", "raster_resolve",
                      "shade_surface", "jump_trace", "shade_pixel",
                      "bloom_pyramid", "composite"]
    soft_r, soft_launches, soft_med = {}, {}, {}
    for label, extra in SOFT_FRAMES.items():
        r = Renderer(wcfg, RenderConfig(width=cfg.width, height=cfg.height,
                                        max_ray_iterations=3, **extra),
                     device=dev, scene=renderer.scene)
        kernels.reset_launches()
        soft_med[label] = frames(r, label)
        every = (soft_per_frame if extra["shadow_samples"] > 1
                 else pix1_per_frame)
        got = frame_launches(label, every + ["write_sky"], every)
        check(got["write_sky"] == buckets, f"the {label} frames launched K3 "
              f"{got['write_sky']} times over {buckets} sky buckets")
        check(got["masked_shadow"] == 0 and got["raster_fragments"]
              == n_frames, f"the {label} frame launched K12, or no K9")
        if r.use_sunmask:
            check(got["sun_grids"] == 1 and r._sunmask_cache[0][3],
                  f"the {label} frames did not build the cone grids once")
        else:
            check(got["sun_grids"] == 0, f"the {label} frames built sun "
                  "grids")
        soft_r[label], soft_launches[label] = r, got
    print(f"frame medians (same call, same card): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in soft_med.items()))
    launches["soft_shadow"] = soft_launches["soft, DDA"]["soft_shadow"]
    launches["soft_shadow_cone"] = soft_launches["soft, cone"]["soft_shadow"]
    launches["soft_shadow_pixelated"] = \
        soft_launches["pixelated, 4 samples"]["soft_shadow"]
    launches["sun_grids_cone"] = soft_launches["soft, cone"]["sun_grids"]

    # ---- 3d. the dragged sun with soft shadows: the soft cone frame with
    # set_sun_dragging(True), the sun turned every frame, so each frame
    # builds the 512^2 cone grids (K11's cone build) beside K14
    drag_soft = Renderer(wcfg, RenderConfig(width=cfg.width,
                                            height=cfg.height,
                                            max_ray_iterations=3,
                                            **SOFT_FRAMES["soft, cone"]),
                         device=dev, scene=renderer.scene)
    drag_soft.set_sun_dragging(True)
    kernels.reset_launches()
    ms = []
    for i in range(n_frames):   # frame 0 warms up
        drag_soft.sun = profile_frame.dragged_sun(start, i)
        t0 = time.perf_counter()
        drag_soft.render(cam, time=i / 60.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms = ms[1:]
    got = frame_launches("dragged-sun soft cone", soft_per_frame
                         + ["sun_grids", "write_sky"],
                         soft_per_frame + ["sun_grids", "write_sky"])
    key = drag_soft._sunmask_cache[0]
    check(key[2] and key[3] and drag_soft._sunmask_cache[1][2][0].shape[0]
          == ss.GRID_DRAGGING ** 2, "the dragged soft frame did not build "
          "512^2 cone grids")
    print(f"frames (dragged sun, soft cone): {FRAMES}, median "
          f"{sorted(ms)[FRAMES // 2]:.3f} ms, slowest {max(ms):.3f} ms (host "
          f"clock, synchronized); K11 (512^2 cone) "
          f"{got['sun_grids'] / n_frames:.2f} launches a frame")
    launches["sun_grids_cone_512"] = got["sun_grids"]

    # ---- 3e. config 4 (tools/bench_scale.py:33-50): four soft samples with
    # the cone grids, four mirror bounces, the filtered AO; counters reset
    # before its frames and read after. Bounce 0 runs K13, K9, K10, K14 and
    # K15; each later bounce K1 over the live lanes, K14 and K15; K11's cone
    # grids once, K3 once a sky bucket
    c4 = Renderer(wcfg, RenderConfig(width=cfg.width, height=cfg.height,
                                     **CONFIG4),
                  device=dev, scene=renderer.scene, mirror_materials=True)
    bounces = CONFIG4["max_ray_iterations"]
    c4_per_frame = {"generate_rays": 1, "raster_fragments": 1,
                    "raster_resolve": 1, "soft_shadow": bounces,
                    "jump_trace": bounces - 1, "shade_bounce": bounces,
                    "bloom_pyramid": 1, "composite": 1}

    def bounce_launches(label, per_frame, frames_, once):
        got = dict(kernels.LAUNCHES)
        uneven = {k: got[k] for k, v in per_frame.items()
                  if got[k] != v * frames_}
        check(not uneven, f"{label} frames: kernels not launched "
              f"{per_frame} times a frame over {frames_} frames: {uneven}")
        for k in once:
            check(got[k] == 1, f"{label} frames launched {k} {got[k]} "
                  "times, expected once")
        others = {k: v for k, v in got.items()
                  if v and k not in per_frame and k not in once
                  and k != "write_sky"}
        check(not others, f"{label} frames launched {others}")
        print(f"launches in the {label} frames ({frames_} frames): "
              f"{ {k: v for k, v in got.items() if v} }; per frame "
              f"{sum(got.values()) / frames_:.2f} through kernels.launch")
        return got

    kernels.reset_launches()
    c4_med = frames(c4, "config 4")
    got = bounce_launches("config 4", c4_per_frame, n_frames, ["sun_grids"])
    check(got["write_sky"] == buckets, f"the config-4 frames launched K3 "
          f"{got['write_sky']} times over {buckets} sky buckets")
    check(c4._sunmask_cache[0][3], "config 4 did not build the cone grids")
    launches["shade_bounce"] = got["shade_bounce"]
    print(f"frame medians (same call, same card): default knobs {med:.3f} "
          f"ms, soft cone {soft_med['soft, cone']:.3f} ms, config 4 "
          f"{c4_med:.3f} ms")
    profile_frame.window("config 4", c4, cam, repo / "build"
                         / "vvr_tpu_torch" / "c4_trace.json")

    # ---- 3f. point lights and wavy reflections: the ten first lights set
    # near the view's surface (2 units back along ten seeded camera rays
    # from their hits), hard shadows from the sun classifier, so K12 answers
    # every bounce's shadows; K15 walks each light's DDA
    lf = Renderer(wcfg, RenderConfig(width=cfg.width, height=cfg.height,
                                     **LIGHTS_FRAME),
                  device=dev, scene=renderer.scene, mirror_materials=True)
    o_l, d_l = camera_rays(cam, cfg.width, cfg.height, dev)
    first = jump.trace_jump(grid, o_l, d_l, cfg.traversal_max_steps * 8,
                            width=cfg.width, stats=False)
    seeded = np.random.default_rng(11).choice(
        torch.nonzero(first.hit)[:, 0].cpu().numpy(), 10, replace=False)
    near_lights = (o_l + d_l * (first.t[:, None] - 2.0))[seeded].cpu()
    lf.scene.lights[:10, :3] = near_lights.numpy()
    lights_np = lf.scene.lights.copy()
    lf_bounces = LIGHTS_FRAME["max_ray_iterations"]
    lf_per_frame = {"generate_rays": 1, "raster_fragments": 1,
                    "raster_resolve": 1, "masked_shadow": lf_bounces,
                    "jump_trace": lf_bounces - 1,
                    "shade_bounce": lf_bounces, "bloom_pyramid": 1,
                    "composite": 1}
    kernels.reset_launches()
    ms = []
    for i in range(LIGHTS_FRAMES + 1):   # frame 0 warms up
        t0 = time.perf_counter()
        img = lf.render(cam, time=i / 60.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    check(tuple(img.shape) == (cfg.height, cfg.width, 3)
          and float(img.float().std()) > 10, "the lights frame is wrong")
    got = bounce_launches("point-light", lf_per_frame, LIGHTS_FRAMES + 1,
                          ["sun_grids"])
    launches["shade_bounce_lights"] = got["shade_bounce"]
    print(f"frames (point lights, wavy reflections): {LIGHTS_FRAMES} after a "
          f"warm-up, median {sorted(ms[1:])[LIGHTS_FRAMES // 2]:.3f} ms "
          f"(host clock, synchronized); the lights moved "
          f"{float(np.abs(lf.scene.lights - lights_np).max()):.3f} units "
          f"at most over the frames")

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
    for part in ("vvr_trace_kernelI11VvrFlatView",
                 "vvr_masked_shadow_kernel"):
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

    # K13: the rays bit-exact against the plain version run on the CPU,
    # at RAY_SIZES (1920x1080, 33x67 and three tails: a span's last whole
    # float4 and its scalar stores), one launch each; its device time at
    # 1920x1080 back to back and with the L2 flushed; on the card
    # camera_rays is one K13 kernel and copies nothing from the host: it
    # captures into a CUDA graph (a copy from host memory cannot be
    # captured) whose replay gives the same rays, and under torch.profiler
    # RAY_CALLS calls show RAY_CALLS K13 kernels and no other device work
    for w_, h_ in RAY_SIZES:
        before = kernels.LAUNCHES["generate_rays"]
        ko, kd = camera_rays(cam, w_, h_, dev)
        check(kernels.LAUNCHES["generate_rays"] == before + 1,
              f"K13 at {w_}x{h_} did not launch once")
        po, pd = camera_rays(cam, w_, h_, "cpu")
        check(torch.equal(ko.cpu(), po) and torch.equal(kd.cpu(), pd),
              f"K13 at {w_}x{h_}: {int((ko.cpu() != po).sum())} origin and "
              f"{int((kd.cpu() != pd).sum())} direction components differ "
              "from the plain version")
    # device time from the profiler's trace, back to back and with
    # L2_FLUSH_BYTES of another buffer written before each call (CUDA
    # events would time camera_rays' host path: 67-140 us a call against
    # K13's 18.5 us on an H100 80GB HBM3 at 700 W, PERF.md section 6)
    scrap = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    k13_dev_us = [device_us(
        lambda: camera_rays(cam, cfg.width, cfg.height, dev),
        ("vvr_generate_rays",), RAY_CALLS,
        repo / "build" / "vvr_tpu_torch" / "k13s_trace.json", before=flush)
        for flush in (None, lambda: scrap.fill_(1.0))]
    del scrap
    print(f"K13: rays bit-exact vs plain on the CPU at {RAY_SIZES}; device "
          f"{k13_dev_us[0]:.2f} us a call at {cfg.width}x{cfg.height} back "
          f"to back, {k13_dev_us[1]:.2f} us with the L2 flushed")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        go, gd = camera_rays(cam, cfg.width, cfg.height, dev)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(go, o) and torch.equal(gd, d),
          "K13 replayed from a CUDA graph differs")

    def rays_calls():
        for _ in range(RAY_CALLS):
            camera_rays(cam, cfg.width, cfg.height, dev)
        torch.cuda.synchronize()

    ray_dev = profile_frame.trace_events(
        repo / "build" / "vvr_tpu_torch" / "k13_trace.json", rays_calls)
    other = sorted({e["name"][:40] for e in ray_dev
                    if "vvr_generate_rays_kernel" not in e["name"]})
    check(not other, f"camera_rays on the card ran {other} beside K13")
    k13_us = [e["dur"] for e in ray_dev]
    print(f"K13: camera_rays captured into a CUDA graph and replayed equal "
          f"(no host-to-device copy); under the profiler {RAY_CALLS} calls "
          f"ran {len(k13_us)} device events, all K13"
          + (f", median {sorted(k13_us)[len(k13_us) // 2]:.2f} us"
             if k13_us else " (the profiler recorded none)"))
    errs["generate_rays"] = 0.0

    # K11's cone grids (soft shadows, the kernel's tight boxes) against the
    # plain cone build over the present boxes at 2048^2 and 512^2, the
    # frame's sun and the low sun: bit for bit
    errs["sun_grids_cone"] = errs["sun_grids_cone_512"] = 0.0
    for lbl, sun_ in (("frame", sun_np), ("low", low3)):
        basis = ss.sun_basis(sun_)
        for g_ in (ss.GRID, ss.GRID_DRAGGING):
            before = kernels.LAUNCHES["sun_grids"]
            gk_ = ss.sun_grids(faces, *basis, wcfg.size, g_, ss.CONE_TAN)[0]
            check(kernels.LAUNCHES["sun_grids"] == before + 1,
                  "K11 (cone) did not launch once")
            gp_ = ss.sun_grids_plain(faces, *basis, wcfg.size, g_,
                                     ss.CONE_TAN)[0]
            check(torch.equal(gk_, gp_), f"K11 cone vs plain ({lbl} sun, "
                  f"{g_}^2): {int((gk_ != gp_).any(1).sum())} texels differ")
            fin = gk_ > -3e38
            print(f"K11 cone, {lbl} sun, {g_}^2: bit for bit equal to the "
                  f"plain build over the present boxes; written share B "
                  f"{float(fin[:, 0].float().mean()):.4f}, C "
                  f"{float(fin[:, 1].float().mean()):.4f}")
    # the cone build's time split by launch order: the support pass, then
    # the cone build (setup, scans, bin, tiles)
    for g_ in (ss.GRID, ss.GRID_DRAGGING):
        profile_frame.k11_window(faces, (e1, e2, s_basis), wcfg.size, g_,
                                 repo / "build" / "vvr_tpu_torch"
                                 / "k11c_trace.json", cone_tan=ss.CONE_TAN)
    cone_k = ss.sun_grids(faces, e1, e2, s_basis, wcfg.size, ss.GRID,
                          ss.CONE_TAN)
    cone_gate = (e1, e2, cone_k)

    # K14 in each mode, on the raster hits at 1920x1080 as the frame calls
    # it (the image's width: 8x4 pixel tiles), four samples (and one,
    # pixelated), and at odd shapes (SOFT_ODD: 33x67 by tiles, 4099 flat
    # lanes) with SOFT_ODD_SAMPLES samples: every sample's hit exactly that
    # of its plain version on the card, and the factor within
    # SOFT_FACTOR_TOL of the plain factor computed on the CPU from those
    # hits (the plain version's cloud lookup on the card divides by
    # multiplying with a reciprocal)
    soft_modes = {"soft_shadow": (SOFT_SAMPLES, False, None),
                  "soft_shadow_cone": (SOFT_SAMPLES, False, cone_gate),
                  "soft_shadow_pixelated": (SOFT_SAMPLES, True, None),
                  "pixelated, 1 sample": (1, True, None)}
    cl_cpu = cl_k.cpu()

    def k14_check(hits_, ns, pix, gate, width, what):
        before = kernels.LAUNCHES["soft_shadow"]
        fk, hk = softshadow.soft_shadow(grid, *hits_, sun_np, ns, cl_k,
                                        max_steps, pix, gate, with_hits=True,
                                        width=width)
        check(kernels.LAUNCHES["soft_shadow"] == before + 1,
              f"K14 ({what}) did not launch once")
        hp = softshadow.sample_hits_plain(grid, *hits_, sun_np, ns,
                                          max_steps, pix, gate)
        check(torch.equal(hk, hp), f"K14 ({what}): {int((hk != hp).sum())} "
              "sample hits differ from the plain version")
        fp = softshadow.shadow_factor_plain(
            *(t.cpu() for t in hits_), sun_np, hk.cpu(), cl_cpu, pix)
        err = float((fk.cpu() - fp).abs().max())
        check(err <= SOFT_FACTOR_TOL, f"K14 ({what}): factor differs from "
              f"the plain factor by {err}")
        return fk, hk, err

    soft_hits, soft_out = {}, {}
    for name, (ns, pix, gate) in soft_modes.items():
        fk, hk, err = k14_check(hits, ns, pix, gate, cfg.width, name)
        errs[name] = err
        soft_hits[name], soft_out[name] = hk, fk
        lit = int(hk.any(0).sum())
        print(f"K14 ({name}): {ns} sample hits of {n} lanes equal to plain "
              f"({int(hk.sum())} hits; {lit} lanes with one or more); factor "
              f"max |diff| {err:.3e} vs plain on the CPU")
    o_s, d_s = camera_rays(cam, *SOFT_ODD[0], dev)
    ras_s = rt.trace_raster(faces, rcam, d_s, probe, wcfg.size,
                            *SOFT_ODD[0])
    flat = slice(n // 2, n // 2 + SOFT_ODD[1])
    odd = {f"{SOFT_ODD[0][0]}x{SOFT_ODD[0][1]} tiled":
           ((o_s, d_s, ras_s.hit, ras_s.face, ras_s.axis_coord),
            SOFT_ODD[0][0]),
           f"{SOFT_ODD[1]} flat lanes": (tuple(t[flat].contiguous()
                                              for t in hits), 0)}
    worst = 0.0
    for label, (hits_, width) in odd.items():
        for name, (_, pix, gate) in list(soft_modes.items())[:3]:
            for ns in SOFT_ODD_SAMPLES:
                worst = max(worst, k14_check(hits_, ns, pix, gate, width,
                                             f"{name}, {label}, {ns} "
                                             "samples")[2])
    print(f"K14 at odd shapes ({', '.join(odd)}; its three modes; "
          f"{SOFT_ODD_SAMPLES} samples): every sample hit equal to plain, "
          f"factor max |diff| {worst:.3e} vs plain on the CPU")
    # K14's time split: the launch against the same kernel with each
    # sample's trace replaced by a miss (tools/k14_split.py), for timing
    # only, at the bench view in each mode
    split_fns = k14_split.build_pair(kernels,
                                     repo / "build" / "vvr_tpu_torch"
                                     / "k14_split")
    for name, (ns, pix, gate) in list(soft_modes.items())[:3]:
        us = k14_split.time_pair(split_fns, kernels, softshadow, grid, hits,
                                 sun_np, ns, cl_k, max_steps, pix, gate,
                                 cfg.width)
        print(f"K14 split ({name}): full {us['full']} us, without the "
              f"sample traces {us['no trace']} us (CUDA events, in turns)")
    # the cone gate's sample hits against the DDA mode's on every lane:
    # where they differ, the sample ray must cross an exact tie that the
    # jump-grid DDA takes the other way (ROADMAP C8), the numpy oracle
    # agreeing with the gate's near walk
    h_dda, h_cone = soft_hits["soft_shadow"], soft_hits["soft_shadow_cone"]
    tie_lanes = sample_ties(softshadow, trace_dense, occ, hits, h_cone,
                            h_dda, sun_d, cfg.width, "K14")
    check(len(tie_lanes) <= K1_ORACLE_SLACK,
          f"K14: the cone gate and the DDA differ on {len(tie_lanes)} lanes")
    other = torch.ones(n, dtype=torch.bool, device=dev)
    other[tie_lanes] = False
    check(torch.equal(soft_out["soft_shadow"][other],
                      soft_out["soft_shadow_cone"][other]),
          "K14: the cone gate's factor differs from the DDA's off the ties")
    print(f"K14: the cone gate's sample hits and factor equal the per-sample "
          f"DDA's on every lane but {len(tie_lanes)} {tie_lanes}, where the "
          f"oracle agrees with the gate")

    # the soft frames: the cone frame against the per-sample DDA frame, one
    # sky: HDR equal on every pixel but those lanes
    soft_sky = renderer._sky(0.25)
    hdr_soft, soft_calls = {}, {}

    def soft_frame(grid_, label):
        r = soft_r[label]
        return render_frame(
            grid_, o, d, renderer.sun, 0.25, r.cfg, sky=soft_sky,
            raster=(faces, rt.raster_camera(cam), probe),
            sunmask=r._sunmask() if r.use_sunmask else None)

    for label in ("soft, cone", "soft, DDA"):
        soft_calls[label] = []
        with recorded_soft(frame_mod, soft_calls[label]):
            hdr_soft[label] = soft_frame(grid, label)
    (img_c, hdr_c), (img_s, hdr_s) = hdr_soft.values()
    hdr_off = (hdr_c != hdr_s).any(-1).reshape(-1)
    check(not bool((hdr_off & other).any()), f"soft frames: the cone frame's "
          f"HDR differs from the DDA frame's on "
          f"{int((hdr_off & other).sum())} pixels off the ties")
    u8_off = int((img_c != img_s).any(-1).sum())
    if not tie_lanes:
        check(u8_off == 0, f"soft frames: {u8_off} pixels differ")
    print(f"soft frames ({cfg.width}x{cfg.height}, {SOFT_SAMPLES} "
          f"samples): the cone frame's HDR equals the per-sample DDA "
          f"frame's on every pixel but the {int(hdr_off.sum())} tie lanes; "
          f"u8 pixels that differ: {u8_off}"
          f"{' (byte for byte)' if u8_off == 0 else ' (bloom spreads them)'}")

    # the same frames on the paged grid of this world: with no near walk
    # before its DDA (the JAX frame walks only the jump grid), the paged
    # K14 answers each sample as the per-sample DDA. So at every K14 call
    # the paged frame traces the jump frame's rays, its sample hits on the
    # lanes the frame shades with equal the jump grid's DDA frame's, its
    # HDR equals that frame's, and it differs from the jump grid's cone
    # frame only on lanes where the jump gate's near walk and the DDA part
    # at an exact tie (ROADMAP C8): each such sample ray goes to the
    # oracle (sample_ties), which must agree with the walk. A bounce's
    # ray that K16 and K1 answer apart (another hit, or the face or cell
    # of a hit: a miss's face is the last face crossed, which the grids
    # do not share) must be an exact tie that the oracle answers as one
    # of them; its lane is printed and left out from there on.
    pgrid = renderer.scene.ensure_paged()

    def hit_of(h, lane):
        return ((int(h[3][lane]), int(h[4][lane])) if bool(h[2][lane])
                else "miss")

    def paged_vs_jump(label, render, gate_calls, dda_calls, gate_frame,
                      hdr_dda, shaded_of=lambda h: None):
        img_gate, hdr_gate = gate_frame
        calls = []
        with recorded_soft(frame_mod, calls):
            img_p, hdr_p = render(pgrid)
        check(len(calls) == len(gate_calls) == len(dda_calls),
              f"{label}: {len(calls)} paged K14 calls against "
              f"{len(gate_calls)}")
        ties, parted = set(), torch.zeros(n, dtype=torch.bool, device=dev)
        for k, ((h_p, s_p), (h_g, s_g), (_, s_d)) in enumerate(
                zip(calls, gate_calls, dda_calls)):
            same = ((h_p[0] == h_g[0]).all(1) & (h_p[1] == h_g[1]).all(1)
                    & (h_p[2] == h_g[2])
                    & (~h_g[2] | ((h_p[3] == h_g[3]) & (h_p[4] == h_g[4]))))
            check(bool((same | parted).all()), f"{label} call {k}: the "
                  "paged frame traces other rays than the jump frame's")
            for lane in torch.nonzero(~same & ~parted)[:, 0].tolist():
                ora = trace_dense(occ, h_g[0][lane:lane + 1].cpu().numpy(),
                                  h_g[1][lane:lane + 1].cpu().numpy())
                o_hit = ((int(ora["face"][0]), int(ora["axis_coord"][0]))
                         if ora["hit"][0] else "miss")
                print(f"{label} call {k}: lane {lane} (pixel "
                      f"{lane % cfg.width}, {lane // cfg.width}): K16 "
                      f"{hit_of(h_p, lane)}, K1 {hit_of(h_g, lane)}, the "
                      f"numpy oracle {o_hit} (face, cell; an exact tie)")
                check(o_hit in (hit_of(h_p, lane), hit_of(h_g, lane)),
                      f"{label} call {k}: lane {lane}: the oracle agrees "
                      "with neither grid")
                parted[lane] = True
            check(int(parted.sum()) <= K1_ORACLE_SLACK, f"{label}: "
                  f"{int(parted.sum())} lanes parted")
            used = shaded_of(h_g)
            used = ~parted if used is None else used & ~parted
            ties |= set(sample_ties(softshadow, trace_dense, occ, h_g, s_g,
                                    s_p, sun_d, cfg.width,
                                    f"{label} call {k}, paged grid", used))
            apart = (s_p != s_d).any(0) & used
            check(not bool(apart.any()), f"{label} call {k}: the paged "
                  f"K14's sample hits differ from the jump grid's DDA "
                  f"frame's on {int(apart.sum())} lanes")
        px = (hdr_p != hdr_dda).any(-1).reshape(-1) & ~parted
        check(not bool(px.any()), f"{label}: the paged frame's HDR "
              f"differs from the jump grid's DDA frame's on "
              f"{int(px.sum())} pixels")
        off = (hdr_p != hdr_gate).any(-1).reshape(-1)
        away = off & ~parted
        away[sorted(ties)] = False
        check(not bool(away.any()), f"{label}: the paged frame's HDR "
              f"differs from the jump cone frame's on {int(away.sum())} "
              f"pixels off the tie lanes {sorted(ties)}")
        print(f"{label}, paged against jump grid ({cfg.width}x{cfg.height})"
              f": at all {len(calls)} K14 calls the same rays but on "
              f"{int(parted.sum())} lanes parted at a tie (above); off "
              f"them sample hits and HDR equal to the jump grid's DDA "
              f"frame's; against its cone frame HDR equal on every pixel "
              f"but {int(off.sum())}, the parted lanes and the tie lanes "
              f"{sorted(ties)} where the oracle agrees with the jump gate's "
              f"near walk; u8 pixels that differ: "
              f"{int((img_p != img_gate).any(-1).sum())}")

    paged_vs_jump("soft cone", lambda g: soft_frame(g, "soft, cone"),
                  soft_calls["soft, cone"], soft_calls["soft, DDA"],
                  (img_c, hdr_c), hdr_s)
    for name, regs, st, ld in (kernels.ptxas_usage("vvr_soft_shadow")
                               + kernels.ptxas_usage("vvr_generate_rays")):
        print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")

    # config 4 on the card: every bounce's K15 against shade_bounce_plain
    # on that bounce's inputs (BounceCheck), with the per-bounce live and
    # mirror lanes; the cone frame ("auto") against the per-sample DDA
    # frame ("off"), bounce by bounce: the same rays and hits at every
    # bounce (shadows do not steer a ray), each sample hit equal but at C8
    # ties the oracle answers as the gate, the HDR equal off those lanes;
    # and the kernel path's frame against the plain path's (every wrapper's
    # plain version on the card, no launch)
    c4_sky = renderer._sky(0.25)
    raster = (faces, rcam, probe)
    dens = renderer.scene.ensure_density()
    c4_kw = dict(sky=c4_sky, raster=raster, density=dens,
                 mirror_materials=True)
    soft_auto, soft_off, c4_dem = [], [], {}
    with BounceCheck(frame_mod, bounce, kernels) as c4_check, \
            recorded_soft(frame_mod, soft_auto):
        img4, hdr4 = render_frame(grid, o, d, renderer.sun, 0.25, c4.cfg,
                                  sunmask=c4._sunmask(), demand=c4_dem,
                                  **c4_kw)
    check(bool(torch.isfinite(hdr4).all()), "config-4 HDR not finite")
    for k, (live, hit_n, mir, shd, diff, nbe, _) in enumerate(
            c4_check.bounces):
        check(live == int(c4_dem[f"b{k}_active"])
              and mir == int(c4_dem[f"b{k}_mirror"]),
              f"config 4 bounce {k}: demand counts disagree")
        print(f"config 4 bounce {k}: {live} live lanes, {hit_n} hits, {mir} "
              f"mirrors, {shd} shaded; K15 vs plain: alpha, continuation and "
              f"every lane but the shaded hits bit for bit, shaded rgb max "
              f"|diff| {diff:.3e} ({nbe} shaded lanes not bit-equal, tol "
              f"{BOUNCE_TOL})")
    # K15's bound per bounce in the bytes its lanes need (k15_bytes)
    for k, b in enumerate(c4_check.bounces):
        moved = b[6]
        print(f"K15 bound, config 4 bounce {k}: {moved / 1e6:.3f} MB of its "
              f"lanes, {bound_ms(moved, 0, 'fp32')[0] * 1e3:.2f} us")
    check(len(c4_check.bounces) == CONFIG4["max_ray_iterations"]
          and c4_check.bounces[-1][0] > 0,
          f"config 4 ran {len(c4_check.bounces)} bounces, the last with no "
          "live lane")
    with recorded_soft(frame_mod, soft_off):
        img4_off, hdr4_off = render_frame(
            grid, o, d, renderer.sun, 0.25,
            dataclasses.replace(c4.cfg, sun_mask="off"), **c4_kw)
    c4_ties = set()

    def shaded_of(h):
        """The lanes shaded with a bounce's shadow: hits that are no
        mirror."""
        block = shade._reconstruct(*h[:2], *h[3:])[2]
        return h[2] & ~bounce.mirror_lanes(h[2], block)

    for k, ((h_a, s_a), (h_o, s_o)) in enumerate(zip(soft_auto, soft_off)):
        check(all(torch.equal(x, y) for x, y in zip(h_a, h_o)),
              f"config 4 bounce {k}: the cone and DDA frames trace other "
              "rays")
        c4_ties |= set(sample_ties(softshadow, trace_dense, occ, h_a, s_a,
                                   s_o, sun_d, cfg.width,
                                   f"config 4 bounce {k}", shaded_of(h_a)))
    off4 = (hdr4 != hdr4_off).any(-1).reshape(-1)
    away = off4.clone()
    away[sorted(c4_ties)] = False
    check(len(soft_auto) == len(soft_off) == CONFIG4["max_ray_iterations"]
          and not bool(away.any()), f"config 4: the cone frame's HDR "
          f"differs from the DDA frame's on {int(away.sum())} pixels off "
          f"the tie lanes {sorted(c4_ties)}")
    print(f"config 4, sun_mask auto vs off: the same rays at all "
          f"{len(soft_auto)} bounces; sample hits equal but at "
          f"{len(c4_ties)} tie lanes {sorted(c4_ties)}; HDR equal on every "
          f"pixel but {int(off4.sum())}, all of them tie lanes; u8 pixels "
          f"that differ: {int((img4 != img4_off).any(-1).sum())}")
    paged_vs_jump("config 4", lambda g: render_frame(
        g, o, d, renderer.sun, 0.25, c4.cfg, sunmask=c4._sunmask(),
        **c4_kw), soft_auto, soft_off, (img4, hdr4), hdr4_off, shaded_of)

    def kernel_vs_plain(label, cfg_, img_k, hdr_k_, **kw):
        before = dict(kernels.LAUNCHES)
        with plain_path(kernels):
            img_p, hdr_p = render_frame(grid, o, d, renderer.sun, 0.25,
                                        cfg_, **kw)
        check(kernels.LAUNCHES == before, f"{label}: the plain path "
              "launched a kernel")
        check(torch.equal(hdr_k_[..., 3], hdr_p[..., 3]),
              f"{label}: alpha differs from the plain path")
        close = torch.isclose(hdr_k_, hdr_p, rtol=1e-4, atol=1e-4).all(-1)
        off = float(((img_k.int() - img_p.int()).abs() > 2).any(-1)
                    .float().mean())
        check(bool(close.all()),
              f"{label}: kernel vs plain path: {int((~close).sum())} pixels "
              f"beyond rtol=atol=1e-4 "
              f"{torch.nonzero(~close)[:8].tolist()}")
        print(f"{label}: kernel path vs plain path on the card: alpha "
              f"equal; HDR within rtol=atol=1e-4 on every pixel (max |diff| "
              f"{float((hdr_k_ - hdr_p).abs().max()):.3e}); {off:.6f} of u8 "
              f"pixels off by more than 2")

    kernel_vs_plain("config 4", c4.cfg, img4, hdr4, sunmask=c4._sunmask(),
                    **c4_kw)

    # the lights frame: K15 on every bounce against plain, the kernel path
    # against the plain path, and the pixels the lights change (against
    # the same frame with the lights far from everything)
    lf_kw = dict(sky=c4_sky, raster=raster, density=dens,
                 mirror_materials=True, sunmask=lf._sunmask())
    with BounceCheck(frame_mod, bounce, kernels) as lf_check:
        img_l, hdr_l = render_frame(grid, o, d, renderer.sun, 0.25, lf.cfg,
                                    lights=lights_np, **lf_kw)
    for k, (live, hit_n, mir, shd, diff, nbe, _) in enumerate(
            lf_check.bounces):
        print(f"lights frame bounce {k}: {live} live lanes, {hit_n} hits, "
              f"{mir} mirrors, {shd} shaded; K15 vs plain bit for bit but "
              f"the shaded rgb, max |diff| {diff:.3e} ({nbe} lanes not "
              f"bit-equal)")
    kernel_vs_plain("lights frame", lf.cfg, img_l, hdr_l, lights=lights_np,
                    **lf_kw)
    far = lights_np.copy()
    far[:, :3] = -1000.0
    _, hdr_far = render_frame(grid, o, d, renderer.sun, 0.25, lf.cfg,
                              lights=far, **lf_kw)
    lit = int((hdr_far != hdr_l).any(-1).sum())
    check(lit > 0, "the lights changed no pixel")
    print(f"lights frame: the ten lights change {lit} pixels against the "
          f"same frame with the lights far away")
    # the filtered AO without mirrors: K15 once, in place of K2, in its
    # form without a continuation
    ao_kw = dict(sky=c4_sky, raster=raster, density=dens,
                 sunmask=c4._sunmask())
    with BounceCheck(frame_mod, bounce, kernels) as ao_check:
        img_ao, hdr_ao = render_frame(grid, o, d, renderer.sun, 0.25, c4.cfg,
                                      **ao_kw)
    check(len(ao_check.bounces) == 1 and ao_check.bounces[0][2] == 0,
          "the AO frame without mirrors ran more than one bounce")
    print(f"AO frame without mirrors: K15 once, vs plain bit for bit but "
          f"the shaded rgb, max |diff| {ao_check.bounces[0][4]:.3e}")
    kernel_vs_plain("AO frame", c4.cfg, img_ao, hdr_ao, **ao_kw)
    for name, regs, st, ld in kernels.ptxas_usage("vvr_shade_bounce"):
        print(f"ptxas: {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")
    errs["shade_bounce"] = max(b[4] for b in c4_check.bounces)
    errs["shade_bounce_lights"] = max(b[4] for b in lf_check.bounces)

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
    right, up, forward = cam.basis()
    ray_args = tuple(torch.as_tensor(np.asarray(v, np.float32), device=dev)
                     for v in (cam.position, right, up, forward)) + (
        torch.tensor(np.float32(np.tan(np.radians(cam.fov) / 2.0)),
                     device=dev), w, h)
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
        "generate_rays": (
            lambda: camera_rays(cam, w, h, dev),
            lambda: raygen.generate_rays(*ray_args), 50, 5),
        "soft_shadow": (
            lambda: softshadow.soft_shadow(grid, *hits, sun_np,
                                           SOFT_SAMPLES, cl_k, max_steps,
                                           width=w),
            lambda: softshadow.soft_shadow_plain(grid, *hits, sun_np,
                                                 SOFT_SAMPLES, cl_k,
                                                 max_steps), 20, 1),
        "soft_shadow_cone": (
            lambda: softshadow.soft_shadow(grid, *hits, sun_np,
                                           SOFT_SAMPLES, cl_k, max_steps,
                                           gate=cone_gate, width=w),
            lambda: softshadow.soft_shadow_plain(
                grid, *hits, sun_np, SOFT_SAMPLES, cl_k, max_steps,
                gate=cone_gate), 20, 1),
        "soft_shadow_pixelated": (
            lambda: softshadow.soft_shadow(grid, *hits, sun_np,
                                           SOFT_SAMPLES, cl_k, max_steps,
                                           True, width=w),
            lambda: softshadow.soft_shadow_plain(grid, *hits, sun_np,
                                                 SOFT_SAMPLES, cl_k,
                                                 max_steps, True), 20, 1),
        "sun_grids_cone": (
            lambda: ss.sun_grids(faces, e1, e2, s_basis, wcfg.size, ss.GRID,
                                 ss.CONE_TAN),
            lambda: ss.sun_grids_plain(faces, e1, e2, s_basis, wcfg.size,
                                       ss.GRID, ss.CONE_TAN), 10, 1),
        "sun_grids_cone_512": (
            lambda: ss.sun_grids(faces, e1, e2, s_basis, wcfg.size,
                                 ss.GRID_DRAGGING, ss.CONE_TAN),
            lambda: ss.sun_grids_plain(faces, e1, e2, s_basis, wcfg.size,
                                       ss.GRID_DRAGGING, ss.CONE_TAN), 20, 3),
        # K15 at config 4's bounce 0 and the lights frame's, on the
        # inputs the frames gave it (BounceCheck.first)
        "shade_bounce": (lambda: bounce.shade_bounce(*c4_check.first),
                         lambda: bounce.shade_bounce_plain(*c4_check.first),
                         20, 1),
        "shade_bounce_lights": (
            lambda: bounce.shade_bounce(*lf_check.first),
            lambda: bounce.shade_bounce_plain(*lf_check.first), 20, 1),
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
    # the cone build's (face, texel) pairs in the kernel's tight boxes (and
    # in the present boxes, the bound before them), and its support pass's
    # (face, coarse texel) pairs in units of a main pair's operations
    def cone_items(g_):
        frame = ss.grid_frame(e1, e2, wcfg.size, g_)
        fs = ss.face_setup(faces, e1, e2, s_basis, *frame, g_, ss.CONE_TAN,
                           wcfg.size)
        sg = ss.support_grid_plain(fs, *frame, g_)
        i0, i1, j0, j1 = ss.cone_boxes_plain(fs, sg, *frame, g_,
                                             ss.CONE_TAN)
        tight = float(torch.where(fs["occl"] & (i0 <= i1), (i1 - i0 + 1)
                                  * (j1 - j0 + 1), 0).sum())
        loose = float(torch.where(fs["occl"], (fs["oi1"] - fs["oi0"] + 1)
                                  * (fs["oj1"] - fs["oj0"] + 1), 0).sum())
        support = float(((fs["si1"] - fs["si0"] + 1)
                         * (fs["sj1"] - fs["sj0"] + 1)).sum())
        extra = support * SUN_SUPPORT_OPS / OPS_PER_ITEM["sun_grids"]
        before = bound_ms(0, (loose + extra) * OPS_PER_ITEM["sun_grids"],
                          "fp32")[0]
        print(f"K11 cone {g_}^2: (face, texel) pairs {tight:.0f} in the "
              f"tight boxes, {loose:.0f} in the present ones; support pass "
              f"{support:.0f} (face, coarse texel) pairs; bound before the "
              f"tight boxes {before:.6f} ms (operations)")
        return tight + extra

    cone_work = {"sun_grids_cone": cone_items(ss.GRID),
                 "sun_grids_cone_512": cone_items(ss.GRID_DRAGGING)}

    def soft_work(pix, gate):
        """K14's items at this run's data, in units of its per-(lit pixel,
        sample) operations: those items plus the near walk's steps and the
        DDA sub-steps (K1 with counters on the same starts and directions,
        bit-equal to K14's) at jump_trace's rate."""
        p_, act = softshadow.query_points(*hits, sun_d, pix)
        traced = act
        if gate is not None:
            kh, km = ss.soft_shadow_gate(p_, sun_np, e1, e2, cone_k, act,
                                         wcfg.size)
            traced = act & ~kh & ~km
            row_c = ss.surface_row_c(p_, sun_np, e1, e2, cone_k, wcfg.size)
        steps = 0.0
        for k in range(SOFT_SAMPLES):
            dirs = softshadow.sample_dir(k, *p_.unbind(1), sun_d)[:3]
            start = torch.stack(softshadow.ray_start(*p_.unbind(1), *dirs,
                                                     sun_d), -1)
            dirs = torch.stack(dirs, -1)
            run = traced
            if gate is not None:
                steps += float(traced.sum()) * ss.NEAR_K
                wh, wm = ss.near_walk_classify(grid, start, dirs, row_c,
                                               sun_np, wcfg.size)
                run = traced & ~wh & ~wm
            it = jump.trace_jump(grid, start, dirs, max_steps,
                                 active=run).iterations
            steps += float(it[run].sum())
        print(f"K14 work ({'pixelated' if pix else 'surface'}, "
              f"{'cone gate' if gate is not None else 'every sample'}): "
              f"{int(act.sum())} lit lanes, {int(traced.sum())} traced, "
              f"{steps:.0f} walk and DDA sub-steps")
        return (float(act.sum()) * SOFT_SAMPLES + steps
                * OPS_PER_ITEM["jump_trace"] / OPS_PER_ITEM["soft_shadow"])

    soft_items = {"soft_shadow": soft_work(False, None),
                  "soft_shadow_cone": soft_work(False, cone_gate),
                  "soft_shadow_pixelated": soft_work(True, None)}
    def k15_work(bc):
        """(bytes, items) of K15 at bounce 0 (BounceCheck `bc`): the bytes
        its lanes need (k15_bytes), its lanes and, with lights, each near
        light's lane and its DDA sub-steps (K1 with counters on the same
        rays), in units of a lane's operations."""
        args = bc.first
        (_, o_, d_, hit_, face_, ac_) = args[:6]
        lights_ = args[16]
        moved = float(bc.bounces[0][6])
        count = float(hit_.numel())
        if lights_ is not None:
            moved += rows_bytes(grid, "K15, lights", lambda r: bounce.
                                shade_bounce_plain(*args, rows_read=r))
            _, world_, block_ = shade._reconstruct(o_, d_, face_, ac_)
            shaded_ = hit_ & ~bounce.mirror_lanes(hit_, block_)
            q_ = torch.stack(world_, -1)
            table = bounce.light_table(lights_)
            near_n = steps = 0.0
            for li in range(table.shape[0]):
                lp = torch.as_tensor(table[li, :3], device=dev)
                dist = (q_ - lp).norm(dim=-1)
                near = shaded_ & (dist < bounce.LIGHT_RADIUS)
                dirs = ((q_ - lp) / dist.clamp(min=1e-6)[:, None])
                it = jump.trace_jump(grid, lp.expand(n, 3).contiguous(),
                                     dirs.contiguous(), max_steps,
                                     active=near).iterations
                near_n += float(near.sum())
                steps += float(it[near].sum())
            print(f"K15 lights work at bounce 0: {near_n:.0f} (lane, light) "
                  f"pairs within {bounce.LIGHT_RADIUS} units, DDA sub-steps "
                  f"{steps:.0f}")
            count += (near_n * LIGHT_OPS + steps * OPS_PER_ITEM["jump_trace"]
                      ) / OPS_PER_ITEM["shade_bounce"]
        return moved, count

    def soft_rows(label, pix, gate):
        return rows_bytes(grid, label, lambda r: softshadow.soft_shadow_plain(
            grid, *hits, sun_np, SOFT_SAMPLES, cl_k, max_steps, pix,
            gate=gate, rows_read=r))

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
        "masked_shadow": (nbytes(*hits, gk, ms_k) + rows_bytes(
            grid, "K12", lambda r: ss.masked_shadow_from_hits_plain(
                grid, *hits, sun_np, e1, e2, grids_k, max_steps,
                rows_read=r)),
                          lanes + (n * OPS_PER_ITEM["shade_surface"]
                                   + res_steps * OPS_PER_ITEM["jump_trace"])
                          / OPS_PER_ITEM["masked_shadow"]),
        # the frame's outputs (hit, face, axis_coord, t)
        "jump_trace": (nbytes(o, d, *(getattr(res_k, f) for f in fields[:4]))
                       + rows_bytes(grid, "K1 primary", lambda r: jump.
                                    trace_jump_plain(grid, o, d, max_steps,
                                                     stats=False,
                                                     rows_read=r)),
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
        "generate_rays": (nbytes(o, d), n),
        "soft_shadow": (nbytes(*hits, cl_k, soft_out["soft_shadow"])
                        + soft_rows("K14, every sample", False, None),
                        soft_items["soft_shadow"]),
        "soft_shadow_cone": (nbytes(*hits, cl_k, cone_k[0],
                                    soft_out["soft_shadow_cone"])
                             + soft_rows("K14, cone gate", False, cone_gate),
                             soft_items["soft_shadow_cone"]),
        "soft_shadow_pixelated": (nbytes(*hits, cl_k,
                                         soft_out["soft_shadow_pixelated"])
                                  + soft_rows("K14, pixelated", True, None),
                                  soft_items["soft_shadow_pixelated"]),
        "shade_bounce": k15_work(c4_check),
        "shade_bounce_lights": k15_work(lf_check),
        "sun_grids_cone": (nbytes(*faces[:8], cone_k[0]),
                           cone_work["sun_grids_cone"]),
        "sun_grids_cone_512": (nbytes(*faces[:8], grids_512[0]),
                               cone_work["sun_grids_cone_512"]),
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
        moved = nbytes(ro, rd, *outs) + rows_bytes(
            grid, f"K1 {label}", lambda r: jump.trace_jump_plain(
                grid, ro, rd, max_steps, ra, stats=False, rows_read=r))
        b_ms, b_by = bound_ms(moved,
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

    # ---- 5a. the brick pyramid over the 256^3 scene (phase 9 of the
    # module docstring), its counters reset before each configuration
    rows += pyramid_phase(repo, dev, renderer, cam, occ, lights_np, errs,
                          launches)

    # ---- 5d. the raster debug view at 256^3 (phase 10 of the module
    # docstring) over the same scene
    rows += raster_phase(repo, dev, renderer.scene, occ, errs, launches)

    # ---- 5b. config 5, the 1024^3 world on the paged grid (phase 7 of
    # the module docstring), its counters reset before each configuration
    c5_rows, c5_chunks = config5_phase(repo, dev, errs, launches)
    rows += c5_rows
    # ---- 5e. the raster debug view at 1024^3 on config 5's chunks
    raster_phase_1024(repo, dev, c5_chunks)

    # ---- 5c. the dynamic world (phase 8 of the module docstring): the
    # 256^3 world's edits on a copy of its chunks, then config 5's
    from vvr_tpu_torch.world.chunk import Chunk
    rows += dynamic_phase(repo, dev, errs, launches, c5_chunks, [
        Chunk(c.position, c.voxels.copy()) for c in renderer.scene.chunks])
    del c5_chunks

    # ---- 11. setup from cold and the app shell (phase 11 of the module
    # docstring): K24, the worlds and their trees, then the App's flight
    rows += setup_phase(repo, dev, errs, launches["height_field"])
    app_phase(repo, dev, renderer.scene)

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
