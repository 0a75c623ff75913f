"""Lane use of K1's loop and of K14's sample rays, and the paths of K19's
walk, counted from the plain tracers' trips.

    python3 -m vvr_tpu_torch.tools.lane_use [--device cuda]

Traces bench.py's view (the 256^3 world, the bench camera, 1920x1080) and
the DDA frame's shadow rays (K2 `shade_surface`'s starts toward the
renderer's sun) with `trace_jump_plain`, whose trips are the kernel's
per-warp trips, and counts for warps of 32 rays, as a flat launch (32x1
rows) and a tiled one (8x4 pixel tiles) group them:

- the earlier loop, one sub-step a trip (a row load or an in-brick
  step): the share of a warp's trips whose lanes run both bodies, the
  lanes busy per trip, and the same with a trip that runs both bodies
  counted twice;
- the box-exit loop (load the row if needed, then one box exit): the
  lanes busy per trip.

Then K14's sample rays at the same view (four jittered samples a pixel,
surface and pixelated query points; every sample's DDA, and with the cone
gate the near walk's steps and the DDA of what it leaves), each sample
ray's trips (a trip: one row load or box exit of the DDA, or one crossing
of the near walk), and for three maps of (pixel, sample) onto lanes the
lanes busy per warp trip: 32x1 pixel rows with a lane running its pixel's
samples in turn (a warp's trips are the sum over the samples of its
slowest lane's), 8x4 pixel tiles the same way, and K14's rounds of a lane
per (pixel, sample) (softshadow.soft_lane_map: a warp's 8x4 tile, its
pixels that trace first, 8 pixels x 4 samples a round).

Then K19's walk on the brick pyramid (the frame's any-only HDDA at the
pyramid's own cap, 8x4 tiles) on the same primary and shadow rays: the
share of a warp's trips in which some lane takes each path of the walk
(an in-node step, a node exit, a descend, a hit, a step out of the world,
a row load; `trace_pyramid_plain`'s trips, one step of every active ray,
are a warp's trips in lockstep) and the lanes busy per warp trip. A trip
costs the union of the paths its lanes take.

These are counts of the algorithm on these rays, not device measurements.
It prints one JSON line per (rays, warp shape).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import softshadow
from vvr_tpu_torch.ops import sunshadow as ss
from vvr_tpu_torch.ops.jump import tile_ray_index, trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.shade import shade_surface_plain
from vvr_tpu_torch.ops.traverse import PATHS, trace_pyramid_plain
from vvr_tpu_torch.render.renderer import DEFAULT_SUN
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.utils.camera import Camera

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
WARP = 32
SOFT_SAMPLES = 4   # K14's samples a pixel (the JAX quick start's)


def warps(n: int, width: int, tiled: bool) -> torch.Tensor:
    """The warp that traces each of n row-major rays."""
    if not tiled:
        return torch.arange(n) // WARP
    idx = tile_ray_index(width, n // width)
    warp = torch.empty(n, dtype=torch.int64)
    thread = torch.arange(idx.numel())
    warp[idx[idx >= 0]] = thread[idx >= 0] // WARP
    return warp


def lane_use(grid, o, d, active, warp_of, max_steps: int) -> dict:
    """Trace once, counting each warp's trips in both loop forms."""
    dev = o.device
    warp_of = warp_of.to(dev)
    nw = int(warp_of.max()) + 1
    kcap = max_steps + 1
    # the old loop's trip k of warp w: lanes in the load body, in-brick body
    load = torch.zeros(nw * kcap, dtype=torch.int32, device=dev)
    brick = torch.zeros_like(load)
    done = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    new = {"trips": 0, "lanes": 0}

    def on_trip(loaded, stepped):
        for rays, acc in ((loaded, load), (stepped, brick)):
            acc.index_add_(0, warp_of[rays] * kcap + done[rays],
                           torch.ones_like(rays, dtype=torch.int32))
            done[rays] += 1
        busy = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
        busy[loaded] = True
        busy[stepped] = True
        per_warp = torch.bincount(warp_of[busy], minlength=nw)
        new["trips"] += int((per_warp > 0).sum())
        new["lanes"] += int(busy.sum())

    res = trace_jump_plain(grid, o, d, max_steps, active, on_trip=on_trip)
    if not torch.equal(done, res.iterations.to(torch.int64)):
        raise AssertionError("the trips' sub-steps differ from the counters")
    lanes = load + brick
    trips = int((lanes > 0).sum())
    both = int(((load > 0) & (brick > 0)).sum())
    total = int(lanes.sum())
    it = res.iterations.float()[res.iterations > 0]
    twice = total / (WARP * (trips + both))
    return {"traced": int(it.numel()),
            "sub_steps_mean": round(float(it.mean()), 2),
            "sub_steps_max": int(it.max()),
            "old_trips_both_bodies": round(both / trips, 4),
            "old_lane_use_one_body": round(total / (WARP * trips), 4),
            "old_lane_use_both_counted": round(twice, 4),
            "new_lane_use": round(new["lanes"] / (WARP * new["trips"]), 4),
            "warp_trips_old": trips, "warp_trips_new": new["trips"]}


def pyramid_paths(pyr, o, d, active, warp_of, max_steps: int) -> dict:
    """Trace once on the brick pyramid (the any-only walk), counting the
    warp trips in which some lane takes each path of PATHS or loads a
    row, and the lanes busy per warp trip."""
    warp_of = warp_of.to(o.device)
    nw = int(warp_of.max()) + 1
    count = dict.fromkeys(("warp_trips", "lanes", "load", *PATHS), 0)

    def trips(rays) -> int:
        return int((torch.bincount(warp_of[rays], minlength=nw) > 0).sum())

    record = []
    trace_pyramid_plain(pyr, o, d, max_steps, active, stats=False,
                        use_full=False, trips=record)
    for idx, loaded, path in record:
        count["warp_trips"] += trips(idx)
        count["lanes"] += idx.numel()
        count["load"] += trips(idx[loaded])
        for k, name in enumerate(PATHS):
            count[name] += trips(idx[path == k])
    n = max(count["warp_trips"], 1)
    return {"warp_trips": count["warp_trips"],
            "lane_use": round(count["lanes"] / (WARP * n), 4),
            **{f"trips with a {name}": round(count[name] / n, 4)
               for name in ("load", *PATHS)}}


def sample_trips(grid, hits, sun, samples: int, max_steps: int,
                 pixelated: bool = False, gate=None):
    """(trips, traced, adds): each K14 sample ray's trips (S, N) int64, 0
    for a sample that traces nothing: its near walk's crossings (with
    `gate`, the cone gate's (e1, e2, grids)) and its DDA's trips (the plain
    tracer's, where a trip is busy for a ray that loads a row or takes a
    step); the pixels that trace and those with samples to add (N,)
    bool."""
    sun_t = torch.as_tensor(np.asarray(sun, np.float32),
                            device=grid.rows.device)
    p, act = softshadow.query_points(*hits, sun_t, pixelated)
    traced, adds = act, hits[2].clone()
    if gate is not None:
        e1, e2, grids = gate
        kh, km = ss.soft_shadow_gate(p, sun, e1, e2, grids, act, grid.size)
        traced = act & ~kh & ~km
        adds &= ~kh
        row_c = ss.surface_row_c(p, sun, e1, e2, grids, grid.size)
    n = p.shape[0]
    out = torch.zeros((samples, n), dtype=torch.int64, device=p.device)
    for s in range(samples):
        dirs = softshadow.sample_dir(s, *p.unbind(1), sun_t)[:3]
        start = torch.stack(softshadow.ray_start(*p.unbind(1), *dirs, sun_t),
                            -1)
        dirs = torch.stack(dirs, -1)
        run = traced
        if gate is not None:
            inw = ((start >= 0) & (start < grid.size)).all(1)
            walk = traced & inw
            out[s] += walk.long()     # the first crossing's test
            for k in range(1, ss.NEAR_K):
                hit_k, exit_k, _ = ss.near_segment_plain(grid, start, dirs, k)
                out[s] += (walk & ~hit_k & ~exit_k).long()
            wh, wm = ss.near_walk_classify(grid, start, dirs, row_c, sun,
                                           grid.size)
            run = traced & ~wh & ~wm
        busy = torch.zeros(n, dtype=torch.int64, device=p.device)
        idx = torch.nonzero(run)[:, 0]

        def on_trip(loaded, stepped):
            b = torch.zeros(idx.numel(), dtype=torch.bool, device=p.device)
            b[loaded] = True
            b[stepped] = True
            busy[idx[b]] += 1

        trace_jump_plain(grid, start[idx], dirs[idx], max_steps, stats=False,
                         on_trip=on_trip)
        out[s] += busy
    return out, traced, adds


def soft_maps(n: int, width: int, samples: int, traced, adds) -> dict:
    """K14's three maps of (pixel, sample) onto lanes: name -> (pixel,
    sample), each (threads, rounds) int64, -1 where a thread has none; a
    thread's rounds run in turn, and a warp's trips in a round are those
    of its slowest lane. `traced`, `adds`: as sample_trips returns them
    (the third map ranks the pixels by them)."""
    flat = torch.arange(-(-n // WARP) * WARP)
    out = {}
    for name, thread in (
            ("32x1, samples in turn", torch.where(flat < n, flat, -1)),
            ("8x4 tiles, samples in turn", tile_ray_index(width, n // width))):
        pix = thread[:, None].expand(-1, samples)
        s = torch.arange(samples).expand(thread.numel(), -1)
        out[name] = (pix, torch.where(pix >= 0, s, -1))
    out["lane per (pixel, sample)"] = softshadow.soft_lane_map(
        n, width, samples, traced, adds)
    return out


def soft_lane_use(trips: torch.Tensor, pix: torch.Tensor,
                  samp: torch.Tensor) -> dict:
    """Lanes busy per warp trip of K14 under one map (soft_maps) of the
    sample rays' trips (S, N) (sample_trips)."""
    trips = trips.cpu()
    t = torch.where(pix >= 0, trips[samp.clamp(min=0), pix.clamp(min=0)], 0)
    per_warp = t.view(-1, WARP, t.shape[1]).amax(1)   # (warps, rounds)
    warp_trips = int(per_warp.sum())
    busy = int(t.sum())
    if busy != int(trips.sum()):
        raise AssertionError("the map drops a traced (pixel, sample)")
    return {"warp_trips": warp_trips, "busy_lane_trips": busy,
            "lane_use": round(busy / (WARP * max(warp_trips, 1)), 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = RenderConfig(width=1920, height=1080)
    max_steps = cfg.traversal_max_steps * 8
    repo = pathlib.Path(__file__).resolve().parents[2]
    scene = build_scene(WorldConfig(depth=4), dev, force_regenerate=True,
                        cache_path=repo / "build" / "vvr_tpu_torch"
                        / "map_256.npz")
    grid = scene.ensure_jumpgrid()
    cam = Camera.look_at(*CAMERA[:2], fov=CAMERA[2])
    o, d = camera_rays(cam, cfg.width, cfg.height, dev)
    n = o.shape[0]
    primary = trace_jump_plain(grid, o, d, max_steps, stats=False)
    sun = DEFAULT_SUN[:3] / np.linalg.norm(DEFAULT_SUN[:3])
    sun = torch.from_numpy(sun.astype(np.float32))
    s_o, s_a = shade_surface_plain(o, d, primary.hit, primary.face,
                                   primary.axis_coord, sun)
    for label, ro, rd, act in (("primary", o, d, None),
                               ("shadow", s_o, sun.to(dev), s_a)):
        for tiled in (False, True):
            out = lane_use(grid, ro, rd, act, warps(n, cfg.width, tiled),
                           max_steps)
            print(json.dumps({"rays": label,
                              "warp": "8x4 tiles" if tiled else "32x1",
                              "device": str(dev), **out}))
    # K19's walk on the brick pyramid, the same rays, 8x4 tiles
    pyr = scene.ensure_pyramid()
    cap = cfg.traversal_max_steps
    p_res = trace_pyramid_plain(pyr, o, d, cap, stats=False, use_full=False)
    p_o, p_a = shade_surface_plain(o, d, p_res.hit, p_res.face,
                                   p_res.axis_coord, sun)
    for label, ro, rd, act in (("pyramid primary", o, d, None),
                               ("pyramid shadow", p_o, sun.to(dev), p_a)):
        out = pyramid_paths(pyr, ro, rd, act, warps(n, cfg.width, True),
                            cap)
        print(json.dumps({"rays": label, "warp": "8x4 tiles",
                          "device": str(dev), **out}))
    # K14's sample rays: every sample's DDA, the cone gate, pixelated
    hits = (o, d, primary.hit, primary.face, primary.axis_coord)
    e1, e2, s = ss.sun_basis(sun.numpy())
    cone = ss.sun_grids(scene.ensure_faces(), e1, e2, s, grid.size, ss.GRID,
                        ss.CONE_TAN)
    for label, pix, gate in (("K14 samples, every sample's DDA", False, None),
                             ("K14 samples, cone gate", False,
                              (e1, e2, cone)),
                             ("K14 samples, pixelated", True, None)):
        trips, traced, adds = sample_trips(grid, hits, sun.numpy(),
                                           SOFT_SAMPLES, max_steps, pix, gate)
        maps = soft_maps(n, cfg.width, SOFT_SAMPLES, traced, adds)
        for name, (mp, ms) in maps.items():
            print(json.dumps({"rays": label, "warp": name,
                              "device": str(dev),
                              "traced": int((trips > 0).sum()),
                              **soft_lane_use(trips, mp, ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
