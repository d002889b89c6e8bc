"""Typed observation data model ("Sense" classes) and camera geometry,
host-side numpy: the modality registry, SE(3) poses with the agent ->
camera offset [0, 0.88, 0], pinhole intrinsics from the horizontal field of
view, and the 6 target COCO classes with their local-id remaps. Detections
travel as the fixed-capacity `ops.detections.Detections`; a `bbs` payload
is its `to_numpy_dict`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from .config import CLASS_NAMES, COCO_CLASS_IDS, COCO_TO_LOCAL, LOCAL_TO_COCO
from .utils.obs_store import SenseInfo, get_sense_info

# --------------------------------------------------------------------------
# Quaternions, stored as np.ndarray [w, x, y, z]
# --------------------------------------------------------------------------


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


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0))
        vals = np.zeros(3)
        vals[i] = 0.25 * s
        vals[j] = (R[j, i] + R[i, j]) / s
        vals[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = vals
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quat_from_yaw(yaw: float) -> np.ndarray:
    """Rotation around +Y (the agent's heading)."""
    return np.array([np.cos(yaw / 2.0), 0.0, np.sin(yaw / 2.0), 0.0])


# --------------------------------------------------------------------------
# Intrinsics
# --------------------------------------------------------------------------


@dataclass
class Intrinsics:
    """Pinhole camera intrinsics."""

    xc: float
    yc: float
    fx: float
    fy: float
    width: int
    height: int

    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.xc], [0.0, self.fy, self.yc], [0.0, 0.0, 1.0]]
        )

    @staticmethod
    def from_hfov(width: int, height: int, hfov_deg: float) -> "Intrinsics":
        """HFOV-based pinhole: fx = W/2 / tan(hfov/2),
        fy = H/2 / tan(hfov/2)."""
        xc = (width - 1.0) / 2.0
        yc = (height - 1.0) / 2.0
        t = np.tan(np.deg2rad(hfov_deg) / 2.0)
        return Intrinsics(xc, yc, width / 2.0 / t, height / 2.0 / t, width, height)


# --------------------------------------------------------------------------
# Poses
# --------------------------------------------------------------------------

AGENT_TO_SENSOR_TRANSLATION = np.array([0.0, 0.88, 0.0])


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

    def transformation_to(self, other: "Pose") -> np.ndarray:
        """T_other_self: maps points in this frame into `other`'s frame."""
        return np.linalg.inv(other.matrix()) @ self.matrix()

    def camera_pose(self) -> "Pose":
        """Camera pose = agent pose lifted by the sensor offset rotated
        into the world frame."""
        R = quat_to_rotmat(self.orientation)
        return Pose(
            position=np.asarray(self.position) + R @ AGENT_TO_SENSOR_TRANSLATION,
            orientation=np.asarray(self.orientation),
            reference="cam",
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"position": np.asarray(self.position),
                "orientation": np.asarray(self.orientation)}

    @staticmethod
    def from_any(obj: Any) -> "Pose":
        """Accept Pose | dict | 4x4 matrix | (position, orientation) pair."""
        if isinstance(obj, Pose):
            return obj
        if isinstance(obj, dict):
            return Pose(np.asarray(obj["position"]), np.asarray(obj["orientation"]))
        arr = np.asarray(obj)
        if arr.shape == (4, 4):
            return Pose(arr[:3, 3], rotmat_to_quat(arr[:3, :3]))
        if arr.dtype == object and arr.shape == (2,):
            return Pose(np.asarray(arr[0]), np.asarray(arr[1]))
        raise TypeError(f"cannot interpret pose from {type(obj)} shape {arr.shape}")


# --------------------------------------------------------------------------
# Sense hierarchy
# --------------------------------------------------------------------------


class Sense:
    """Base typed observation."""

    CODE = ""

    def __init__(self, data: Any = None, path: Optional[str] = None,
                 sense_info: Optional[SenseInfo] = None):
        if sense_info is None and path is not None:
            sense_info = get_sense_info(path)
        self.sense_info = sense_info
        self.data = data

    @property
    def name(self) -> str:
        if self.sense_info is None:
            return ""
        si = self.sense_info
        return f"{si.episode}-{si.mod}-{si.camera_id}"

    def raw(self) -> Any:
        """Payload to write into the npz store."""
        return self.data

    @classmethod
    def load(cls, path: str) -> "Sense":
        data = np.load(path, allow_pickle=True)["arr_0"]
        return cls(data, path=path)


class VisualSense(Sense):
    HFOV_DEG = 90.0

    def intrinsics(self, hfov_deg: Optional[float] = None) -> Intrinsics:
        h, w = self.data.shape[:2]
        return Intrinsics.from_hfov(w, h, hfov_deg or self.HFOV_DEG)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


class RGBSense(VisualSense):
    """RGB frame, HWC uint8, stored channel-last RGB; `.bgr` gives the
    channel-reversed view."""

    CODE = "rgb"

    @classmethod
    def load(cls, path: str) -> "RGBSense":
        img = np.load(path, allow_pickle=True)["arr_0"]
        if img.ndim == 3 and img.shape[0] in (1, 3, 4):
            img = img.transpose(1, 2, 0)
        if img.shape[-1] > 3:
            img = img[:, :, :3]
        return cls(np.ascontiguousarray(img), path=path)

    @property
    def bgr(self) -> np.ndarray:
        return self.data[:, :, ::-1]


class DepthSense(VisualSense):
    """Depth in meters, HW float32."""

    CODE = "depth"

    @classmethod
    def load(cls, path: str) -> "DepthSense":
        depth = np.load(path, allow_pickle=True)["arr_0"]
        return cls(np.asarray(depth, dtype=np.float32).squeeze(), path=path)


class SemanticSense(VisualSense):
    """Per-pixel semantic class id."""

    CODE = "semantic"


class SemanticInstancesSense(VisualSense):
    """Per-pixel instance id + instance->class mapping."""

    CODE = "semanticinstances"

    def __init__(self, data=None, mapping=None, path=None, sense_info=None):
        super().__init__(data, path, sense_info)
        self.mapping = mapping or {}

    def raw(self) -> Any:
        return {"semantic_instances": self.data, "mapping": self.mapping}

    @classmethod
    def load(cls, path: str) -> "SemanticInstancesSense":
        payload = np.load(path, allow_pickle=True)["arr_0"].item()
        return cls(payload["semantic_instances"], payload["mapping"], path=path)


class EgomapSense(VisualSense):
    """2-channel (obstacle, explored) egocentric map."""

    CODE = "egomap"


class AgentPoseSense(Sense):
    """Agent pose observation; `load` returns the *camera* pose."""

    CODE = "position"

    def __init__(self, position=None, orientation=None, path=None, sense_info=None):
        pose = Pose(np.asarray(position), np.asarray(orientation))
        super().__init__(pose, path=path, sense_info=sense_info)

    @property
    def pose(self) -> Pose:
        return self.data

    def raw(self) -> Any:
        return np.array(self.pose.to_dict(), dtype=object)

    @classmethod
    def load(cls, path: str) -> "Sense":
        payload = np.load(path, allow_pickle=True)["arr_0"]
        try:
            d = payload.item()
            position, orientation = d["position"], d["orientation"]
        except (AttributeError, ValueError, KeyError):
            position, orientation = payload[0], payload[1]
        sense = cls(position, orientation, path=path)
        cam = sense.pose.camera_pose()
        out = Sense.__new__(AgentPoseSense)
        Sense.__init__(out, cam, path=path)
        return out


class BBSense(Sense):
    """Per-frame detections. The payload is the dict form of
    :class:`ops.detections.Detections` (numpy arrays)."""

    CODE = "bbs"
    CLASSES = {c: n for c, n in zip(COCO_CLASS_IDS, CLASS_NAMES)}
    REMAP = dict(LOCAL_TO_COCO)
    CLASSES_TO_IDX = dict(COCO_TO_LOCAL)

    def raw(self) -> Any:
        payload = self.data
        if hasattr(payload, "to_numpy_dict"):
            payload = payload.to_numpy_dict()
        return np.array({"instances": payload}, dtype=object)

    @classmethod
    def load(cls, path: str) -> "BBSense":
        payload = np.load(path, allow_pickle=True)["arr_0"].item()["instances"]
        return cls(payload, path=path)


MODALITY_REGISTRY = {
    "rgb": RGBSense,
    "depth": DepthSense,
    "semantic": SemanticSense,
    "semanticinstances": SemanticInstancesSense,
    "bbs": BBSense,
    "bbsgt": BBSense,
    "bbsf": BBSense,
    "position": AgentPoseSense,
    "egomap": EgomapSense,
}


def get_class_from_modality_code(code: str):
    """The Sense class of a modality code."""
    return MODALITY_REGISTRY[code]
