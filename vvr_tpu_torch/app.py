"""App shell — the interactive loop, headless.

Counterpart of vvr_tpu/app.py over the port's Renderer. The reference's
winit ApplicationHandler (src/main.rs:89-141) drives pre_render/render
per RedrawRequested; this shell drives the same loop without a window:
scripted or programmatic input feeds the Input system, Movement updates
the camera, the Renderer draws frames, and the reference's keybinds are
honoured (InternalApp::pre_render, src/renderer.rs:420-463):

  P  print CPU delta vs rolling pass average      L  start 2 s benchmark
  H/G  debug view next/prev                        J  memory report
  U  print camera snapshot   I  fixed mode   O  cycle snapshots
  Q  quit                    F5 fullscreen (accepted, headless no-op)
  middle mouse (held): the sun follows the camera's forward direction

H and G replace the Renderer's `cfg` between frames; the Renderer reads
the view from it at every frame (render/renderer.py `raster_view`).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.utils.input import Input
from vvr_tpu_torch.utils.movement import Movement
from vvr_tpu_torch.utils.ticker import Ticker

log = logging.getLogger(__name__)

DEFAULT_BINDINGS = {
    "w": "forward", "s": "back", "a": "left", "d": "right",
    "shift": "boost",
    "p": "print_timings", "l": "benchmark", "h": "debug_next",
    "g": "debug_prev", "j": "memory_report", "q": "quit",
    "u": "print_snapshot", "i": "toggle_fixed", "o": "cycle_snapshot",
    "f5": "fullscreen", "mouse_middle": "set_sun",
}


@dataclasses.dataclass
class App:
    renderer: Renderer
    input: Input = dataclasses.field(default_factory=Input)
    movement: Movement = dataclasses.field(default_factory=Movement)
    ticker: Ticker = dataclasses.field(default_factory=Ticker)
    running: bool = True

    def __post_init__(self):
        for key, name in DEFAULT_BINDINGS.items():
            self.input.bind_button(name, key)
        # start at the first snapshot pose, scaled to the world
        self.movement.snapshots = self.renderer.snapshots
        cam = self.renderer.camera_for_snapshot(0)
        self.movement.position = cam.position.copy()
        self.movement.rotation = cam.rotation.copy()
        self.movement.fov = self.movement.target_fov = cam.fov

    def pre_render(self, delta: float):
        """Keybind handling (renderer.rs:420-463) + camera update."""
        r = self.renderer
        inp = self.input
        if inp.get_button("quit").pressed():
            self.running = False
        if inp.get_button("print_timings").pressed():
            log.info("rolling avg: %.3f ms", r.stats.average_ms())
        if inp.get_button("benchmark").pressed():
            r.stats.start_benchmarking(r.frame_count)
        if inp.get_button("debug_next").pressed():
            r.cfg = dataclasses.replace(
                r.cfg, debug_type=(r.cfg.debug_type + 1) % 7)
            log.info("debug view: %d", r.cfg.debug_type)
        if inp.get_button("debug_prev").pressed():
            r.cfg = dataclasses.replace(
                r.cfg, debug_type=(r.cfg.debug_type - 1) % 7)
        if inp.get_button("memory_report").pressed():
            log.info("device buffers: %s", r.memory_report())
        self.movement.update(inp, delta)
        # middle mouse (held): the sun follows the camera's forward
        # direction (renderer.rs:455-457); while held the classifier
        # builds its reduced-resolution grids
        dragging = inp.get_button("set_sun").held()
        r.set_sun_dragging(dragging)
        if dragging:
            f = self.movement.forward().astype(np.float32)
            f = f / max(np.linalg.norm(f), 1e-6)
            r.sun = np.concatenate([f, [0.0]]).astype(np.float32)

    def run(self, max_frames: int = 60, script=None, frame_sink=None):
        """Drive the loop. `script`: optional callable(frame, input)
        injecting events; `frame_sink`: optional callable(frame, image).
        Returns the number of frames drawn."""
        last = time.monotonic()
        frame = 0
        while self.running and frame < max_frames:
            now = time.monotonic()
            delta = min(now - last, 0.1) or 1e-3
            last = now
            if script is not None:
                script(frame, self.input)
            self.pre_render(delta)
            self.ticker.update(delta)
            img = self.renderer.render(self.movement.camera(), timed=True)
            if frame_sink is not None:
                frame_sink(frame, img)
            self.input.update()
            frame += 1
        return frame
