"""SE(3) poses for the simulator's agent and camera (host-side numpy).

The part of the JAX package's `sensor_data.py` that the exploration loop
needs: quaternions [w, x, y, z], `Pose`, and the agent -> camera offset
[0, 0.88, 0].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

AGENT_TO_SENSOR_TRANSLATION = np.array([0.0, 0.88, 0.0])


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_from_yaw(yaw: float) -> np.ndarray:
    """Rotation around +Y (the agent's heading)."""
    return np.array([np.cos(yaw / 2.0), 0.0, np.sin(yaw / 2.0), 0.0])


@dataclass
class Pose:
    """SE(3) pose: world_T_frame."""

    position: np.ndarray  # [3]
    orientation: np.ndarray  # quaternion [w, x, y, z]
    reference: str = "agent"

    def matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = quat_to_rotmat(self.orientation)
        T[:3, 3] = np.asarray(self.position, dtype=np.float64)
        return T

    def camera_pose(self) -> "Pose":
        """Camera pose = agent pose lifted by the sensor offset rotated
        into the world frame."""
        R = quat_to_rotmat(self.orientation)
        return Pose(
            position=np.asarray(self.position) + R @ AGENT_TO_SENSOR_TRANSLATION,
            orientation=np.asarray(self.orientation),
            reference="cam",
        )
