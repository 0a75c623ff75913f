"""Renderer — the frame orchestrator and the library's entry point.

Counterpart of vvr_tpu/render/renderer.py for the slice:
`Renderer(WorldConfig, RenderConfig, device=...).render(camera)`. It owns
the scene, the sun, the cross-frame sky and sun-grid caches and the frame
statistics. `primary_raster` and `sun_mask` resolve as in the JAX package
(renderer.py:79-98): at their "auto" defaults the main view rasterizes its
primary visibility and answers hard shadows with the sun classifier.
Configurations outside the slice raise NotImplementedError naming the
ROADMAP item that adds them.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import sky as sky_ops
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops.rastertrace import raster_camera
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.frame import check_frame_config, render_frame
from vvr_tpu_torch.render.scene import Scene, build_scene
from vvr_tpu_torch.utils.camera import Camera
from vvr_tpu_torch.utils.statistics import Statistics, mrays_per_sec

log = logging.getLogger(__name__)

DEFAULT_SUN = np.array([-0.28, 0.65, -0.71, 0.0], np.float32)


def use_raster(cfg: RenderConfig) -> bool:
    """Rasterized primary visibility: on for the main view (the debug
    heatmaps need the DDA's counters)."""
    return cfg.primary_raster == "on" or (cfg.primary_raster == "auto"
                                          and cfg.debug_type == 6)


def use_sunmask(cfg: RenderConfig) -> bool:
    """The sun classifier answers the shadow rays, unless shadows are off
    or pixelated (the quarter-voxel floor can bury the query in solid,
    where a certain-light claim is unsound)."""
    return (cfg.sun_mask != "off" and cfg.shadow_samples >= 1
            and not cfg.pixelated_shadows)


def check_slice(world_cfg: WorldConfig, cfg: RenderConfig,
                mirror_materials: bool = False,
                dynamic_world: bool = False) -> None:
    """Raise NotImplementedError unless the configuration is the slice the
    port renders; each message names the ROADMAP item that adds the
    feature."""
    if use_sunmask(cfg) and cfg.shadow_samples > 1:
        raise NotImplementedError(
            "sun_mask with soft shadows (shadow_samples > 1) needs the cone "
            "grids, which are not ported yet: ROADMAP A9")
    if mirror_materials:
        raise NotImplementedError(
            "mirror materials are not ported yet: ROADMAP A10")
    if dynamic_world:
        raise NotImplementedError(
            "the dynamic world is not ported yet: ROADMAP A12")
    if cfg.traversal == "jump2":
        raise NotImplementedError(
            "traversal 'jump2' is a measured negative result the port does "
            "not carry (ROADMAP 'Not to port')")
    if not (cfg.traversal == "jump" or cfg.use_jump(world_cfg.size)):
        raise NotImplementedError(
            f"traversal {cfg.traversal!r} at size {world_cfg.size} is not "
            "ported yet: ROADMAP A11 (paged grid) and A13 (brick pyramid)")
    check_frame_config(cfg)


class Renderer:
    def __init__(self, world_cfg: WorldConfig, render_cfg: RenderConfig,
                 device="cuda", scene: Scene | None = None,
                 force_regenerate: bool = False,
                 mirror_materials: bool = False,
                 dynamic_world: bool = False, cache_path=None):
        check_slice(world_cfg, render_cfg, mirror_materials, dynamic_world)
        self.world_cfg = world_cfg
        self.cfg = render_cfg
        self.device = torch.device(device)
        self.scene = scene or build_scene(world_cfg, self.device,
                                          force_regenerate=force_regenerate,
                                          cache_path=cache_path)
        self.use_raster = use_raster(render_cfg)
        self.use_sunmask = use_sunmask(render_cfg)
        if self.use_raster or self.use_sunmask:
            self.scene.ensure_faces()
        self.stats = Statistics()
        self.frame_count = 0
        self.elapsed = 0.0
        sun = DEFAULT_SUN[:3] / np.linalg.norm(DEFAULT_SUN[:3])
        self.sun = np.concatenate([sun, [0.0]]).astype(np.float32)
        self._sky_cache = None  # (key, (skybox, clouds))
        self._sunmask_cache = None  # (key, (e1, e2, grids))
        self._sun_dragging = False

    @property
    def rays_per_frame(self) -> int:
        """Primary + shadow rays per frame (the Mrays/s denominator)."""
        n = self.cfg.render_width * self.cfg.render_height
        return n * (1 + max(self.cfg.shadow_samples, 0))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sky(self, t: float):
        """Cross-frame sky/cloud texture cache: the textures depend only on
        (sun, time), so time is quantized to cfg.sky_cache_quantum and the
        textures are rebuilt only when (sun, bucket) changes. Quantum 0
        disables the cache (textures per frame at the frame's time)."""
        q = self.cfg.sky_cache_quantum
        if q <= 0.0:
            return None
        tq = float(int(t / q) * q)
        key = (self.sun[:3].tobytes(), tq)
        if self._sky_cache is None or self._sky_cache[0] != key:
            sky = sky_ops.write_sky(self.sun[:3], tq,
                                    self.cfg.skybox_resolution,
                                    self.cfg.clouds_resolution, self.device)
            self._sky_cache = (key, sky)
        return self._sky_cache[1]

    def set_sun_dragging(self, dragging: bool) -> None:
        """While the sun is dragged, _sunmask builds 512^2 grids instead of
        2048^2: cheaper per sun direction, and as exact (a coarser grid
        only widens the ambiguous residue the DDA answers)."""
        self._sun_dragging = bool(dragging)

    def _sunmask(self):
        """(e1, e2, grids) of the sun classifier, rebuilt only when the
        key (sun, scene epoch, reduced resolution, cone) changes."""
        lo = self._sun_dragging
        key = (self.sun[:3].tobytes(), self.scene.epoch, lo,
               self.cfg.shadow_samples > 1)
        if self._sunmask_cache is None or self._sunmask_cache[0] != key:
            e1, e2, s = sunshadow.sun_basis(self.sun[:3])
            grids = sunshadow.sun_grids(
                self.scene.ensure_faces(), e1, e2, s, self.scene.cfg.size,
                sunshadow.GRID_DRAGGING if lo else sunshadow.GRID)
            self._sunmask_cache = (key, (e1, e2, grids))
        return self._sunmask_cache[1]

    def render(self, camera: Camera, time: float | None = None,
               timed: bool = False, fetch: bool = False):
        """One frame -> (H, W, 3) u8 on the render device (a numpy array
        with fetch=True). With timed=True the frame is synchronized and its
        wall time pushed into Statistics."""
        t = self.elapsed if time is None else time
        t0 = _time.monotonic()
        o, d = camera_rays(camera, self.cfg.render_width,
                           self.cfg.render_height, self.device)
        raster = None
        if self.use_raster:
            raster = (self.scene.ensure_faces(), raster_camera(camera),
                      self.scene.solid_at_host(camera.position))
        sunmask = self._sunmask() if self.use_sunmask else None
        img, _ = render_frame(self.scene.jumpgrid, o, d, self.sun, t,
                              self.cfg, sky=self._sky(t), raster=raster,
                              sunmask=sunmask)
        if timed:
            self._sync()
            self.stats.push_timing((_time.monotonic() - t0) * 1e3)
        self.frame_count += 1
        res = self.stats.end_of_frame(self.frame_count)
        if res is not None:
            log.info("Sample Count: %d, Avg: %.3fms, StdDev: %.4f",
                     res["samples"], res["avg_ms"], res["stddev"])
        return img.cpu().numpy() if fetch else img

    def benchmark(self, camera: Camera, duration_s: float = 2.0,
                  warmup: int = 2) -> dict:
        """Timed capture (reference L-key benchmark, statistics.rs:43-64)."""
        for _ in range(warmup):
            self.render(camera, timed=True)
        self.stats.benchmark_duration_s = duration_s
        self.stats.start_benchmarking(self.frame_count)
        result = None
        while self.stats.benchmark is not None:
            self.render(camera, timed=True)
            result = self.stats.last_result
        result = dict(result)
        result["mrays_per_s"] = mrays_per_sec(self.rays_per_frame,
                                              result["avg_ms"])
        result["fps"] = 1000.0 / result["avg_ms"]
        self.stats.last_result = None
        return result
