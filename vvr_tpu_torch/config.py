"""Configuration — the single source of render/world knobs.

Field-for-field copy of vvr_tpu/config.py (same names, same defaults), so a
config built for one package means the same frame in the other. The port
renders only a slice of these knobs; render/renderer.py raises
NotImplementedError for the rest.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """World/scene shape. Reference: src/voxel/util.rs:5-6 (SVO_DEPTH=5 ->
    1024^3 world of 16^3 chunks of 64^3 voxels)."""

    depth: int = 5                  # tree depth; world size = 4**depth
    seed: int = 0                   # worldgen seed (reference uses seed 0)
    # FBM terrain parameters (reference: src/voxel.rs:60-91)
    fbm_octaves: int = 6
    fbm_frequency: float = 0.001
    fbm_amplitude: float = 700.0
    fbm_offset: float = 80.0
    terrace_step: float = 10.0
    detail_octaves: int = 3
    detail_frequency: float = 0.01

    @property
    def size(self) -> int:
        """World edge length in voxels (1 << (depth*2))."""
        return 1 << (2 * self.depth)

    @property
    def chunk_count(self) -> int:
        """Chunks per edge; reference caps at 16 (src/voxel.rs:68)."""
        return min(self.size // 64, 16)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render quality knobs. Field-for-field parity with the reference CLI
    (src/main.rs:36-79) plus the JAX package's own knobs; the port renders
    only the slice render/renderer.py names."""

    width: int = 800                # reference window (renderer.rs:205)
    height: int = 600
    downscale_factor: int = 1       # render at (w/h)/downscale, composite up
    shadow_samples: int = 1         # 0 = off, 1 = hard, N>1 = jittered soft
    max_ray_iterations: int = 3     # bounce loop cap (1-8)
    round_normals: bool = False     # kept for parity; no-op in reference too
    ambient_occlusion: bool = False
    ao_mode: str = "filtered"       # "filtered": SVT trilinear sample along
                                    # the normal (raytracer.slang:274-277,
                                    # the reference's live path); "overlap":
                                    # planar overlap-query estimator
                                    # (ops/overlap.py; the reference's
                                    # library AO, ray_stuff_other.slang:
                                    # 450-520 + raytracer.slang:283-297)
    wavy_reflections: bool = False
    pixelated_shadows: bool = False
    enable_debug_stuff: bool = False
    point_lights: bool = False      # the reference's (disabled) 10-light loop
    debug_type: int = 6             # reference DebugType enum numbering
                                    # (raytracer.slang:46-53): 0=raster dbg
                                    # ("Combined" dispatches the raster path,
                                    # renderer.rs:694), 1=iterations,
                                    # 2=buffer fetches, 3=normals, 4=world,
                                    # 5=exit type; 6=main raytraced frame
    # the JAX package's knobs (no reference analog)
    ray_tile: int = 4096            # JAX traversal batch; unused here
    traversal_max_steps: int = 256  # x8 = the jump tracer's sub-step cap
    traversal: str = "auto"         # "jump", "paged" (the port's two
                                    # tracers), "pyramid", "jump2"; "auto"
                                    # picks jump up to (size/8)^3 = 65536
                                    # superbricks and paged beyond, as the
                                    # JAX package does
    primary_raster: str = "auto"    # face rasterizer for primary rays:
                                    # "auto" = on for the main view
    sun_mask: str = "auto"          # sun-space hard-shadow classifier
                                    # ("auto" = on with hard shadows)
    # Sky resources (reference: src/skybox.rs:43-45)
    skybox_resolution: int = 256
    clouds_resolution: int = 512
    sky_cache_quantum: float = 0.25  # sky/cloud textures are regenerated
                                    # only when (sun, quantize(time)) moves
                                    # to a new bucket (the reference shades
                                    # with the previous frame's sky, the
                                    # same class of lag). 0 disables.
    # Post (reference: post_process_compute.slang)
    bloom_enabled: bool = True
    bloom_strength: float = 0.05
    bloom_sample_mip: int = 2

    def use_jump(self, world_size: int) -> bool:
        """Resolve the traversal knob for a world of `world_size` voxels."""
        if self.traversal == "jump":
            return True
        if self.traversal in ("pyramid", "jump2", "paged"):
            return False
        return (world_size // 8) ** 3 <= 65536

    def use_paged(self, world_size: int) -> bool:
        """The paged two-level grid: explicit, or "auto" past 65536
        superbricks (worlds past 512^3)."""
        if self.traversal == "paged":
            return True
        return self.traversal == "auto" and (world_size // 8) ** 3 > 65536

    @property
    def render_width(self) -> int:
        return self.width // self.downscale_factor

    @property
    def render_height(self) -> int:
        return self.height // self.downscale_factor


# the main raytraced view in the reference's DebugType numbering
# (shaders/raytracer.slang:46-53); the other modes are not ported
DEBUG_MAIN = 6
