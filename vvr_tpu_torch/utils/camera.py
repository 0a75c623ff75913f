"""Camera and snapshots.

Mirrors src/movement.rs: quaternion camera rotation and the JSON
camera-snapshot system
(movement.rs:7-14,124-151; fixtures src/snapshots.json) used as the golden
test poses (SURVEY.md §4). A numpy copy of vvr_tpu/utils/camera.py.

The snapshot fixtures stay in the JAX package's assets; they are read by
path, never imported (importing vvr_tpu pulls in jax).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

ASSETS = (pathlib.Path(__file__).resolve().parents[2] / "vvr_tpu"
          / "assets")


def quat_to_mat3(q) -> np.ndarray:
    """(x, y, z, w) quaternion -> rotation matrix (column vectors)."""
    x, y, z, w = (float(v) for v in q)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


@dataclasses.dataclass
class Snapshot:
    """Serializable camera pose (movement.rs:7-14)."""
    position: np.ndarray     # (3,) f32
    rotation: np.ndarray     # (4,) quaternion x,y,z,w
    fov: float               # horizontal fov, degrees

    @classmethod
    def from_json(cls, d: dict) -> "Snapshot":
        return cls(np.array([d["position"][k] for k in "xyz"], np.float32),
                   np.array([d["rotation"][k] for k in "xyzw"], np.float32),
                   float(d["fov"]))


def load_snapshots(path: pathlib.Path | None = None) -> list[Snapshot]:
    path = path or (ASSETS / "snapshots.json")
    with open(path) as f:
        return [Snapshot.from_json(d) for d in json.load(f)]


@dataclasses.dataclass
class Camera:
    position: np.ndarray                    # (3,) f32 world
    rotation: np.ndarray                    # (4,) quat x,y,z,w
    fov: float = 90.0                       # horizontal degrees

    @classmethod
    def from_snapshot(cls, s: Snapshot) -> "Camera":
        return cls(np.asarray(s.position, np.float32),
                   np.asarray(s.rotation, np.float32), s.fov)

    @classmethod
    def look_at(cls, position, target, fov=90.0) -> "Camera":
        """Convenience: build the quaternion looking from position->target."""
        position = np.asarray(position, np.float32)
        f = np.asarray(target, np.float32) - position
        f = f / np.linalg.norm(f)
        yaw = np.arctan2(-f[0], -f[2])
        pitch = np.arcsin(np.clip(f[1], -1, 1))
        qy = np.array([0, np.sin(yaw / 2), 0, np.cos(yaw / 2)])
        qx = np.array([np.sin(pitch / 2), 0, 0, np.cos(pitch / 2)])
        # q = qy * qx (movement.rs:92: rotation_y(yaw) * rotation_x(pitch))
        x1, y1, z1, w1 = qy
        x2, y2, z2, w2 = qx
        q = np.array([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ], np.float32)
        return cls(position, q, fov)

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(right, up, forward) world-space camera axes; forward = -Z
        (movement.rs:107-110)."""
        r = quat_to_mat3(self.rotation)
        right = r @ np.array([1, 0, 0], np.float32)
        up = r @ np.array([0, 1, 0], np.float32)
        forward = r @ np.array([0, 0, -1], np.float32)
        return right, up, forward
