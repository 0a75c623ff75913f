"""Renderer — the frame orchestrator and the library's entry point.

Counterpart of vvr_tpu/render/renderer.py for what the port renders:
`Renderer(WorldConfig, RenderConfig, device=..., mirror_materials=...)
.render(camera)`. It owns the scene, the sun, the cross-frame sky and
sun-grid caches, the animated point lights and the frame statistics.
`primary_raster` and `sun_mask` resolve as in the JAX package
(renderer.py:79-98): at their "auto" defaults the main view rasterizes its
primary visibility and answers shadows with the sun classifier (its cone
grids for soft shadows); a debug heatmap (debug_type 1-5) traces its
primary rays. `traversal` resolves as there (:49-75, :163-165): "auto"
traces the jump grid up to 512^3 and the paged grid past it (the 1024^3
world), "pyramid" the brick pyramid at any size; the scene builds only
the grid the Renderer reads. With `ambient_occlusion` and ao_mode
"filtered" the scene builds its density field; "overlap" reads the
grid's own voxels (the JAX renderer builds a pyramid for it on the other
grids, :166-169, :197); the lights move every frame, as in the JAX renderer
(:159-160), and with `point_lights` the frame reads the first ten.
With `dynamic_world` the Renderer builds the sparse voxel texture and runs
its update pass (K17) on one brick at the start of each frame, round-robin
(:66-69, :152-158); `apply_edits` applies a world editor's edits
(world/edit.py) and repairs the cached sun grids (K18). With debug_type 0
the Renderer draws the raster debug view instead (render/raster.py, K22
and K23, as the JAX renderer does at :150-151, :329-345): it builds the
brick pyramid the view traces its shadows through and no other grid, and
meshes the world at the first such frame (`mesh`, uploaded once). The
view is read from `cfg.debug_type` at every frame, as there, so a change
of `cfg` between frames (the App's H and G keys, app.py) switches it and
builds what the new view reads at its first frame; the other decisions
(the traversal, the rasterizer, the classifier, the density field) are
made once, at construction, as the JAX renderer makes them.
`camera_for_snapshot`, `profile_frame` (a torch.profiler Chrome trace)
and `memory_report` serve the command line (cli.py). `jump2` raises
NotImplementedError (ROADMAP "Not to port").
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.ops import sky as sky_ops
from vvr_tpu_torch.ops import sunshadow
from vvr_tpu_torch.ops.bounce import bounce_buffers
from vvr_tpu_torch.ops.rastertrace import raster_camera
from vvr_tpu_torch.ops.raygen import camera_rays
from vvr_tpu_torch.render.frame import check_frame_config, render_frame
from vvr_tpu_torch.render.raster import RasterMesh, raster_debug_frame
from vvr_tpu_torch.render.scene import Scene, build_scene
from vvr_tpu_torch.utils.camera import Camera, load_snapshots
from vvr_tpu_torch.utils.statistics import Statistics, mrays_per_sec
from vvr_tpu_torch.world.bricks import build_svt, svt_update_brick
from vvr_tpu_torch.world.mesher import VoxelMeshBuffers

log = logging.getLogger(__name__)

DEFAULT_SUN = np.array([-0.28, 0.65, -0.71, 0.0], np.float32)


def use_raster(cfg: RenderConfig) -> bool:
    """Rasterized primary visibility: on for the main view (the debug
    heatmaps need the DDA's counters; the raster debug view draws its
    mesh instead)."""
    if cfg.debug_type == 0:
        return False
    return cfg.primary_raster == "on" or (cfg.primary_raster == "auto"
                                          and cfg.debug_type == 6)


def use_sunmask(cfg: RenderConfig) -> bool:
    """The sun classifier answers the main view's shadow rays, unless
    shadows are off or pixelated (the quarter-voxel floor can bury the
    query in solid, where a certain-light claim is unsound). The raster
    debug view traces its own and never reads it."""
    return (cfg.sun_mask != "off" and cfg.shadow_samples >= 1
            and not cfg.pixelated_shadows)


def check_slice(world_cfg: WorldConfig, cfg: RenderConfig) -> None:
    """Raise NotImplementedError unless the port renders the configuration;
    each message names the ROADMAP item that adds the feature."""
    if cfg.traversal == "jump2":
        raise NotImplementedError(
            "traversal 'jump2' is a measured negative result the port does "
            "not carry (ROADMAP 'Not to port')")
    if cfg.traversal not in ("auto", "jump", "paged", "pyramid"):
        raise ValueError(f"unknown traversal {cfg.traversal!r}")
    check_frame_config(cfg)


class Renderer:
    def __init__(self, world_cfg: WorldConfig, render_cfg: RenderConfig,
                 device="cuda", scene: Scene | None = None,
                 force_regenerate: bool = False,
                 mirror_materials: bool = False,
                 dynamic_world: bool = False, cache_path=None):
        check_slice(world_cfg, render_cfg)
        self.world_cfg = world_cfg
        self.cfg = render_cfg
        self.device = torch.device(device)
        self.mirror_materials = mirror_materials
        self.scene = scene or build_scene(world_cfg, self.device,
                                          force_regenerate=force_regenerate,
                                          cache_path=cache_path)
        self.dynamic_world = dynamic_world
        self.svt = (build_svt(self.scene.chunks, self.scene.cfg.size,
                              self.device) if dynamic_world else None)
        # decided once, as the JAX renderer decides them (:51-98); the
        # view (debug_type) is read at every frame
        self.use_paged = render_cfg.use_paged(world_cfg.size)
        self.use_pyramid = render_cfg.traversal == "pyramid"
        self.use_raster = use_raster(render_cfg)
        self.use_sunmask = use_sunmask(render_cfg)
        self.use_density = (render_cfg.ambient_occlusion
                            and render_cfg.ao_mode == "filtered")
        self._ensure_view()
        self.stats = Statistics()
        self.frame_count = 0
        self.elapsed = 0.0
        sun = DEFAULT_SUN[:3] / np.linalg.norm(DEFAULT_SUN[:3])
        self.sun = np.concatenate([sun, [0.0]]).astype(np.float32)
        self._sky_cache = None  # (key, (skybox, clouds))
        self._sunmask_cache = None  # (key, (e1, e2, grids))
        self._sun_dragging = False
        self._nxt = None  # the mirror bounces' continuation buffers
        self._mesh = None
        self._snapshots = None

    @property
    def raster_view(self) -> bool:
        """The present frame is the raster debug view: cfg.debug_type 0,
        read at every frame as the JAX renderer reads it (:150), so the
        App's H and G keys switch views between frames."""
        return self.cfg.debug_type == 0

    def _ensure_view(self) -> None:
        """Build what the present view reads and the scene lacks, then drop
        the dense occupancy: the raster debug view traces its shadows
        through the brick pyramid and reads no other grid
        (vvr_tpu/render/raster.py:289-291; its mesh comes at its first
        frame); the main and heatmap views read the traversal's grid, the
        faces of the rasterizer and the sun classifier, and the density
        field of the filtered AO."""
        sc = self.scene
        if self.use_pyramid or self.raster_view:
            sc.ensure_pyramid()
        if not self.raster_view:
            if self.use_paged and not self.use_pyramid:
                sc.ensure_paged()
            elif not self.use_pyramid:
                sc.ensure_jumpgrid()
            if self.use_raster or self.use_sunmask:
                sc.ensure_faces()
            if self.use_density:
                sc.ensure_density()
        sc.release_dense()

    @property
    def snapshots(self) -> list:
        """The canned camera poses (assets/snapshots.json), loaded once."""
        if self._snapshots is None:
            self._snapshots = load_snapshots()
        return self._snapshots

    @property
    def grid(self):
        """The DDA's grid, read from the scene at every frame: an edit
        patches it in place or, when the paged grid is rebuilt, replaces
        it (apply_edits)."""
        if self.use_pyramid or self.raster_view:
            return self.scene.pyramid
        return self.scene.paged if self.use_paged else self.scene.jumpgrid

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
        key (sun, scene epoch, reduced resolution, cone) changes: the cone
        grids with soft shadows, the hard grids otherwise."""
        lo = self._sun_dragging
        cone = self.cfg.shadow_samples > 1
        key = (self.sun[:3].tobytes(), self.scene.epoch, lo, cone)
        if self._sunmask_cache is None or self._sunmask_cache[0] != key:
            e1, e2, s = sunshadow.sun_basis(self.sun[:3])
            grids = sunshadow.sun_grids(
                self.scene.ensure_faces(), e1, e2, s, self.scene.cfg.size,
                sunshadow.GRID_DRAGGING if lo else sunshadow.GRID,
                sunshadow.CONE_TAN if cone else 0.0)
            self._sunmask_cache = (key, (e1, e2, grids))
        return self._sunmask_cache[1]

    def _bounce_buffers(self):
        """The mirror bounces' continuation buffers, made once, zero-filled
        (None without mirrors)."""
        if self.mirror_materials and self._nxt is None:
            self._nxt = bounce_buffers(
                self.cfg.render_width * self.cfg.render_height, self.device)
        return self._nxt

    @property
    def mesh(self) -> RasterMesh:
        """The surface-nets world mesh of the raster debug view, built on
        the host and uploaded to the device at first use (the JAX
        renderer's lazy `mesh`, :329)."""
        if self._mesh is None:
            self._mesh = RasterMesh.upload(
                VoxelMeshBuffers.build(self.scene.chunks), self.device)
        return self._mesh

    def camera_for_snapshot(self, index: int) -> Camera:
        """The camera of snapshot `index` (modulo their count), its
        position scaled from the 1024^3 world the poses were authored for
        to this one (vvr_tpu/render/renderer.py:125)."""
        snap = self.snapshots[index % len(self.snapshots)]
        cam = Camera.from_snapshot(snap)
        cam.position = cam.position * (self.scene.cfg.size / 1024.0)
        return cam

    def render(self, camera: Camera, time: float | None = None,
               timed: bool = False, fetch: bool = False):
        """One frame -> (H, W, 3) u8 on the render device (a numpy array
        with fetch=True). With timed=True the frame is synchronized and its
        wall time pushed into Statistics."""
        t = self.elapsed if time is None else time
        self._ensure_view()
        if self.raster_view:
            return self._render_raster(camera, t, timed, fetch)
        # the dynamic world's pass on one brick, round-robin
        # (renderer.rs:581-609)
        if self.svt is not None:
            svt_update_brick(self.svt, self.frame_count % self.svt.num_bricks)
        # animated point lights (renderer.rs:494-505), every frame
        self.scene.animate_lights(camera.position, t, 1.0 / 60.0)
        o, d = camera_rays(camera, self.cfg.render_width,
                           self.cfg.render_height, self.device)
        raster = None
        if self.use_raster:
            raster = (self.scene.ensure_faces(), raster_camera(camera),
                      self.scene.solid_at_host(camera.position))
        sunmask = self._sunmask() if self.use_sunmask else None
        sky = self._sky(t)
        # the clock spans the frame call, as the JAX renderer's does
        # (vvr_tpu/render/renderer.py:188): the rays, the sun grids and the
        # sky are enqueued before it, and the synchronize below waits for
        # them too
        t0 = _time.monotonic()
        img, _ = render_frame(
            self.grid, o, d, self.sun, t, self.cfg, sky=sky,
            raster=raster, sunmask=sunmask,
            density=self.scene.density if self.use_density else None,
            lights=self.scene.lights if self.cfg.point_lights else None,
            mirror_materials=self.mirror_materials, nxt=self._bounce_buffers())
        return self._finish_frame(img, t0, timed, fetch)

    def _render_raster(self, camera: Camera, t: float, timed: bool,
                       fetch: bool):
        """The debug_type 0 frame (render/raster.py). Its clock spans the
        whole frame call, host clipping included, as the JAX renderer's
        does (:341-345): the first frame's also meshes the world."""
        t0 = _time.monotonic()
        img, _ = raster_debug_frame(self.mesh, self.scene.ensure_pyramid(),
                                    camera, self.sun, t, self.cfg)
        return self._finish_frame(img, t0, timed, fetch)

    def _finish_frame(self, img, t0: float, timed: bool, fetch: bool):
        if timed:
            self._sync()
            self.stats.push_timing((_time.monotonic() - t0) * 1e3)
        self.frame_count += 1
        res = self.stats.end_of_frame(self.frame_count)
        if res is not None:
            log.info("Sample Count: %d, Avg: %.3fms, StdDev: %.4f",
                     res["samples"], res["avg_ms"], res["stddev"])
        return img.cpu().numpy() if fetch else img

    def profile_frame(self, camera: Camera, trace_path="vvr_trace.json"):
        """One frame under torch.profiler (the CPU, and the card's kernels
        on a CUDA device), after one outside it, written as a Chrome trace
        to `trace_path` (open it in Perfetto or chrome://tracing); returns
        the frame."""
        from torch.profiler import ProfilerActivity, profile
        self.render(camera, timed=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            img = self.render(camera, timed=True)
        prof.export_chrome_trace(str(trace_path))
        log.info("profile written to %s", trace_path)
        return img

    def memory_report(self) -> dict:
        """Device-buffer sizes in MB (MiB) of the structures built so far:
        the grids, the pyramid, the density field, the SVT bricks, the
        raster view's mesh and the SVO tree (the J-key allocator report
        analog, src/renderer.rs:451-454), and the lights in KB."""
        mib = 2 ** 20
        sc = self.scene
        rep = {}
        if sc.pyramid is not None:
            rep["pyramid_rows_mb"] = sc.pyramid.rows.nbytes / mib
        if sc.jumpgrid is not None:
            rep["jumpgrid_rows_mb"] = sc.jumpgrid.rows.nbytes / mib
        if sc.paged is not None:
            rep["paged_mb"] = sc.paged.memory_bytes() / mib
        if sc.faces is not None:
            rep["faces_mb"] = sum(t.nbytes for t in sc.faces) / mib
        if sc.density is not None:
            rep["density_mb"] = sc.density.nbytes / mib
        if self.svt is not None:
            rep["svt_bricks_mb"] = self.svt.bricks.nbytes / mib
        if self._mesh is not None:
            rep["mesh_mb"] = self._mesh.nbytes() / mib
        if sc.tree is not None:
            rep["tree_mb"] = sc.tree.memory_bytes() / mib
        rep["lights_kb"] = sc.lights.nbytes / 1024
        return rep

    def apply_edits(self, editor, positions, solid: bool) -> dict:
        """Set (solid) or clear the voxels at (K, 3) int positions through
        `editor` (world/edit.py WorldEditor over this scene's chunks, its
        structures the scene's), then point the scene at the editor's
        pyramid, grids and faces, advance the scene's epoch and repair the
        cached sun grids in place (K18: the texels the edit can change become
        ambiguous, so their lanes run the DDA against the patched grid;
        the next sun move rebuilds them). The repaired grids keep their
        key but for the epoch, and are repaired in their own basis, not
        the present sun's (ROADMAP C2: the JAX renderer stamps the present
        sun on grids built for another). Returns patched_rows, edit_ms,
        set_voxels_ms, invalidate_ms and the editor's last_timings
        (host clock; the device work is enqueued, and the next frame's
        synchronize waits for it)."""
        t0 = _time.monotonic()
        positions = np.atleast_2d(np.asarray(positions, np.int64))
        n = editor.set_voxels(positions, solid)
        t_sv = _time.monotonic()
        if editor.pyramid is not None:
            self.scene.pyramid = editor.pyramid
        if editor.paged is not None:
            self.scene.paged = editor.paged
        if editor.jumpgrid is not None:
            self.scene.jumpgrid = editor.jumpgrid
        if editor.faces is not None:
            self.scene.faces = editor.faces
        self.scene.epoch += 1
        self.scene._chunk_index = None     # an edit may create chunks
        self.scene.release_dense()
        cache = self._sunmask_cache
        if self.use_sunmask and cache is not None \
                and cache[0][1] == self.scene.epoch - 1:
            # grids current before this edit (others stay stale: rebuilt)
            key, (e1, e2, grids) = cache
            grids = sunshadow.invalidate_sun_texels(
                grids, e1, e2, positions, self.scene.cfg.size,
                sunshadow.CONE_TAN if key[3] else 0.0)
            self._sunmask_cache = ((key[0], self.scene.epoch) + key[2:],
                                   (e1, e2, grids))
        return {"patched_rows": int(n),
                "edit_ms": (_time.monotonic() - t0) * 1e3,
                "set_voxels_ms": round((t_sv - t0) * 1e3, 1),
                "invalidate_ms": round((_time.monotonic() - t_sv) * 1e3,
                                       1),
                **editor.last_timings}

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
