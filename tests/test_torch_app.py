"""The port's headless app shell (app.py) and its host utilities
(utils/input.py, utils/movement.py, utils/ticker.py) against the JAX
package's, and the view switch of the H and G keys (ROADMAP C20)."""

import dataclasses

import numpy as np
import pytest
import torch

from vvr_tpu.utils.input import Input as JaxInput
from vvr_tpu.utils.movement import Movement as JaxMovement
from vvr_tpu.utils.ticker import Ticker as JaxTicker
from vvr_tpu_torch.app import DEFAULT_BINDINGS, App
from vvr_tpu_torch.config import RenderConfig, WorldConfig
from vvr_tpu_torch.render.renderer import Renderer
from vvr_tpu_torch.render.scene import Scene
from vvr_tpu_torch.utils.input import ButtonState, Input
from vvr_tpu_torch.utils.movement import Movement
from vvr_tpu_torch.utils.ticker import Ticker
from vvr_tpu_torch.world.chunk import Chunk

torch.set_num_threads(1)

SMALL = dict(width=64, height=48, skybox_resolution=16, clouds_resolution=16)


def _script(frame, inp):
    """Forty frames of flight: W with boost and scroll, strafing, mouse
    look, fov scroll, U, I (fixed mode), O (the next snapshot), I again."""
    events = {
        0: [("down", "w")],
        3: [("down", "shift"), ("scroll", 2.0)],
        6: [("mouse", (35.0, -12.0))],
        9: [("up", "shift"), ("down", "a")],
        12: [("up", "a"), ("down", "d"), ("scroll", -1.5)],
        15: [("up", "d"), ("up", "w"), ("down", "s"), ("mouse", (-80, 4))],
        18: [("down", "u")],
        20: [("up", "u"), ("down", "i")],
        22: [("up", "i"), ("down", "o")],
        24: [("up", "o")],
        27: [("down", "i")],
        29: [("up", "i"), ("up", "s"), ("down", "shift"), ("scroll", -3.0)],
        33: [("down", "w"), ("mouse", (5.0, 60.0))],
    }
    for kind, arg in events.get(frame, []):
        if kind == "down":
            inp.key_down(arg)
        elif kind == "up":
            inp.key_up(arg)
        elif kind == "scroll":
            inp.scroll(arg)
        else:
            inp.mouse_move(*arg)


def test_input_movement_ticker_equal_jax():
    """Under one scripted input the port's Input, Movement and Ticker have
    the JAX ones' state at every frame (the App's bindings)."""
    sides = []
    for inp, mov, tick in ((Input(), Movement(), Ticker()),
                           (JaxInput(), JaxMovement(), JaxTicker())):
        for key, name in DEFAULT_BINDINGS.items():
            inp.bind_button(name, key)
        mov.position = np.array([100.0, 80.0, 40.0], np.float32)
        states = []
        for frame in range(40):
            delta = 1.0 / 60.0 + 0.002 * (frame % 3)
            _script(frame, inp)
            mov.update(inp, delta)
            fired = tick.update(delta)
            states.append((
                {k: v.name for k, v in inp.buttons.items()},
                dict(inp.axes), mov.position.copy(), mov.rotation.copy(),
                mov.velocity.copy(), mov.summed_mouse.copy(), mov.boost,
                mov.fov, mov.target_fov, mov.fixed_mode_snapshot_index,
                mov._cycle, fired, tick.accumulator, tick.tick_count))
            inp.update()
        sides.append(states)
    for frame, (a, b) in enumerate(zip(*sides)):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=str(frame))
            else:
                assert x == y, frame
    assert sides[0][-1][9] is None and sides[0][25][9] == 1
    assert Input().get_button("w") is ButtonState.NONE


@pytest.fixture(scope="module")
def scene64(small_world):
    cfg, chunks, _ = small_world
    return Scene(WorldConfig(depth=3),
                 [Chunk(c.position, c.voxels) for c in chunks],
                 device="cpu")


def test_app_quits_and_switches_views(scene64):
    """The port App at 64^3 and 64x48: H switches to the raster debug
    view (debug_type 0) at the next frame and builds its pyramid then, G
    switches back, Q ends the run; each frame equals a Renderer's frame
    at the same camera and cfg, and the raster frame one from a Renderer
    made with debug_type 0."""
    r = Renderer(WorldConfig(depth=3), RenderConfig(**SMALL), device="cpu",
                 scene=scene64)
    assert not r.raster_view and scene64.pyramid is None
    app = App(r)

    def script(frame, inp):
        if frame == 1:
            inp.key_down("h")
        if frame == 2:
            inp.key_up("h")
            inp.key_down("g")
        if frame == 3:
            inp.key_up("g")
            inp.key_down("w")
            inp.key_down("q")

    recs = []
    n = app.run(max_frames=10, script=script,
                frame_sink=lambda f, img: recs.append(
                    (app.movement.camera(), r.cfg, img.numpy().copy(),
                     scene64.pyramid is not None)))
    assert n == 4 and not app.running
    assert [c.debug_type for _, c, _, _ in recs] == [6, 0, 6, 6]
    assert [p for *_, p in recs] == [False, True, True, True]
    assert r.frame_count == 4 and r.mesh is not None
    other = Renderer(WorldConfig(depth=3), RenderConfig(**SMALL),
                     device="cpu", scene=scene64)
    for cam, cfg, img, _ in recs:
        other.cfg = cfg
        np.testing.assert_array_equal(
            other.render(cam, time=0.0, fetch=True), img)
    raster = Renderer(WorldConfig(depth=3),
                      RenderConfig(**SMALL, debug_type=0), device="cpu",
                      scene=scene64)
    np.testing.assert_array_equal(
        raster.render(recs[1][0], time=0.0, fetch=True), recs[1][2])
    assert np.abs(recs[1][2].astype(int) - recs[0][2].astype(int)).max() \
        > 50
    rep = r.memory_report()
    assert "pyramid_rows_mb" in rep and "mesh_mb" in rep
    assert "tree_mb" not in rep
    scene64.ensure_tree()
    assert r.memory_report()["tree_mb"] > 0


def test_app_keys_reach_the_renderer(scene64):
    """L starts the capture, the middle mouse drags the sun (reduced
    grids while held) and J, U, O, I are taken, as the JAX App does."""
    r = Renderer(WorldConfig(depth=3), RenderConfig(**SMALL), device="cpu",
                 scene=scene64)
    app = App(r)
    sun0 = r.sun.copy()
    seen = []

    keys = {0: "l", 1: "mouse_middle", 2: "j", 3: "u", 4: "o", 5: "i"}

    def script(frame, inp):
        inp.key_down(keys[frame])
        if frame == 3:
            inp.key_up("mouse_middle")

    app.run(max_frames=6, script=script,
            frame_sink=lambda f, img: seen.append(
                (r._sun_dragging, r.stats.benchmark is not None,
                 app.movement.fixed_mode_snapshot_index)))
    assert [s[0] for s in seen] == [False, True, True, False, False, False]
    assert seen[0][1] and not np.array_equal(r.sun, sun0)
    assert seen[5][2] == 1
    np.testing.assert_array_equal(app.movement.position,
                                  r.snapshots[1].position)
    assert dataclasses.asdict(r.cfg)["debug_type"] == 6
