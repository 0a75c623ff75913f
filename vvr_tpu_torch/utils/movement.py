"""Camera movement — WASD fly-cam with boost, smoothed look, fov control.

Counterpart of vvr_tpu/utils/movement.py (host NumPy, the same state
per frame), a rebuild of src/movement.rs: shift-boost scaled 2^boost
adjusted by scroll (:56-79), exponential mouse smoothing (:81-93),
scroll-controlled target fov with rate-limited approach (:96-103),
velocity lerp (:112-117), and the camera snapshot system (U print / I
toggle fixed mode / O cycle the canned poses, :124-151)."""

from __future__ import annotations

import json
import logging

import numpy as np

from vvr_tpu_torch.utils.camera import (Camera, Snapshot, load_snapshots,
                                        quat_to_mat3)
from vvr_tpu_torch.utils.input import Input

log = logging.getLogger(__name__)


def _clamp01(x):
    return min(max(x, 0.0), 1.0)


class Movement:
    def __init__(self, snapshots=None, fov: float = 90.0):
        self.position = np.zeros(3, np.float32)
        self.rotation = np.array([0, 0, 0, 1], np.float32)
        self.velocity = np.zeros(3, np.float32)
        self.local_velocity = np.zeros(2, np.float32)
        self.summed_mouse = np.zeros(2, np.float32)
        self.boost = 0.0
        self.fov = fov
        self.target_fov = fov
        self.snapshots = (snapshots if snapshots is not None
                          else load_snapshots())
        self.fixed_mode_snapshot_index: int | None = None
        self._cycle = 0

    def camera(self) -> Camera:
        return Camera(self.position.copy(), self.rotation.copy(), self.fov)

    def forward(self) -> np.ndarray:
        """World-space camera forward (movement.rs `forward()`; the
        middle-mouse sun-direction source, renderer.rs:455-457)."""
        return self.camera().basis()[2]

    def update(self, inp: Input, delta: float):
        self.local_velocity[:] = 0.0
        boosted = inp.get_button("boost").held()
        speed = 2.0 ** self.boost if boosted else 1.0

        if inp.get_button("forward").held():
            self.local_velocity[1] = 1.0
        elif inp.get_button("back").held():
            self.local_velocity[1] = -1.0
        if inp.get_button("left").held():
            self.local_velocity[0] = 1.0
        elif inp.get_button("right").held():
            self.local_velocity[0] = -1.0

        if boosted:
            self.boost = float(np.clip(
                self.boost + inp.get_axis("scroll") * 0.2, -5.0, 5.0))
        else:
            self.target_fov -= inp.get_axis("scroll") * 5.0

        # smoothed mouse -> yaw/pitch quaternion (movement.rs:81-93)
        target = np.array([inp.get_axis("mouse_x") * 0.003,
                           inp.get_axis("mouse_y") * -0.003], np.float32)
        k = _clamp01(40.0 * delta)
        self.summed_mouse += (target - self.summed_mouse) * k
        if self.fixed_mode_snapshot_index is None:
            yaw, pitch = self.summed_mouse
            qy = np.array([0, np.sin(yaw / 2), 0, np.cos(yaw / 2)], np.float32)
            qx = np.array([np.sin(pitch / 2), 0, 0, np.cos(pitch / 2)],
                          np.float32)
            x1, y1, z1, w1 = qy
            x2, y2, z2, w2 = qx
            self.rotation = np.array([
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], np.float32)

        self.target_fov = float(np.clip(self.target_fov, 0.05, 179.5))
        self.fov += float(np.clip(self.target_fov - self.fov, -100.0, 100.0)) \
            * delta * 20.0

        r = quat_to_mat3(self.rotation)
        forward = r @ np.array([0, 0, -1], np.float32)
        right = r @ np.array([1, 0, 0], np.float32)
        vel = forward * self.local_velocity[1] + right * self.local_velocity[0]
        self.velocity += (vel * 20.0 * speed - self.velocity) * k
        if self.fixed_mode_snapshot_index is None:
            self.position += self.velocity * delta

        # snapshot keys (movement.rs:124-151)
        if inp.get_button("print_snapshot").pressed():
            log.info("snapshot: %s", json.dumps(self.snapshot().to_json()))
        if inp.get_button("toggle_fixed").pressed():
            self.fixed_mode_snapshot_index = (
                None if self.fixed_mode_snapshot_index is not None
                else self._cycle)
            self._apply_fixed()
        if inp.get_button("cycle_snapshot").pressed() and self.snapshots:
            self._cycle = (self._cycle + 1) % len(self.snapshots)
            if self.fixed_mode_snapshot_index is not None:
                self.fixed_mode_snapshot_index = self._cycle
            self._apply_fixed()

    def _apply_fixed(self):
        if self.fixed_mode_snapshot_index is None or not self.snapshots:
            return
        s = self.snapshots[self.fixed_mode_snapshot_index]
        self.position = np.asarray(s.position, np.float32).copy()
        self.rotation = np.asarray(s.rotation, np.float32).copy()
        self.fov = self.target_fov = float(s.fov)

    def snapshot(self) -> Snapshot:
        return Snapshot(self.position.copy(), self.rotation.copy(), self.fov)
