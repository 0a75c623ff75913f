"""Lane use of K1's loop, counted from the plain tracer's trips.

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
from vvr_tpu_torch.ops.jump import tile_ray_index, trace_jump_plain
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.ops.shade import shade_surface_plain
from vvr_tpu_torch.render.renderer import DEFAULT_SUN
from vvr_tpu_torch.render.scene import build_scene
from vvr_tpu_torch.utils.camera import Camera

CAMERA = ([128.0, 100.0, 20.0], [128.0, 20.0, 180.0], 85.0)  # bench.py:33
WARP = 32


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
    grid = scene.jumpgrid
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
