"""Sensor suite: derived observations over the simulator state.

Each sensor is a function `sensor(env, obs) -> np.ndarray | dict |
Detections` registered by name, the JAX package's names: ground-truth
detections (and a variant that drops occluded instances), the learned
detector, poses (absolute, relative, in map pixels, with Gaussian noise),
collision, movement, proximity, the egocentric and top-down maps, and
per-pixel instances. Host values come back as numpy; detections stay
tensors on the env's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.geometry import backproject_depth


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

SENSOR_REGISTRY: Dict[str, Callable] = {}


def register_sensor(name: str):
    def deco(fn):
        SENSOR_REGISTRY[name] = fn
        return fn

    return deco


def get_sensor(name: str) -> Callable:
    return SENSOR_REGISTRY[name]


# ---------------------------------------------------------------------------
# detection sensors
# ---------------------------------------------------------------------------


@register_sensor("object_detector_gt")
def object_detector_gt(env, obs, max_instances: int = 16):
    """Ground-truth instances from the per-pixel render, with the
    min-area filter ('bbsgt')."""
    return env.sim.gt_detections(obs, max_instances=max_instances)


@register_sensor("object_detector_gt_discard_occlusions")
def object_detector_gt_discard_occlusions(env, obs, max_instances: int = 16,
                                          tolerance: float = 1.0):
    """Drops instances whose visible depth is >= `tolerance` meters closer
    than the object's center distance, i.e. mostly seen through or behind
    an occluder."""
    det = env.sim.gt_detections(obs, max_instances=max_instances)
    depth = _host(obs["depth"])
    masks = _host(det.masks) > 0.5
    valid = _host(det.valid).copy()
    anns = {a["instance_id"]: a for a in env.get_semantic_annotations()}
    obj_ids = _host(det.object_ids)
    agent = env.sim.agent
    for i in np.nonzero(valid)[0]:
        ann = anns.get(int(obj_ids[i]))
        if ann is None or not masks[i].any():
            continue
        center = (np.asarray(ann["aabb_min"]) +
                  np.asarray(ann["aabb_max"])) / 2
        center_dist = np.hypot(center[0] - agent.x, center[2] - agent.z)
        med_depth = float(np.median(depth[masks[i]]))
        if center_dist - med_depth >= tolerance:
            valid[i] = False
    return det.replace(valid=torch.from_numpy(valid).to(det.valid.device))


@register_sensor("object_detector_detectron")
def object_detector_detectron(env, obs, perceiver=None):
    """The learned detector on one env's frame ('bbs'); the trainers run
    it batched (`perception.perceive`)."""
    if perceiver is None:
        raise ValueError("object_detector_detectron needs a Perceiver")
    result = perceiver.process(obs["rgb"])
    return result.detections


# ---------------------------------------------------------------------------
# pose sensors
# ---------------------------------------------------------------------------


@register_sensor("position_sensor_origin")
def position_sensor_origin(env, obs):
    """Absolute pose."""
    p = env.get_agent_position()
    return {"position": p["position"], "orientation": p["orientation"]}


@register_sensor("position_sensor")
def position_sensor(env, obs):
    """Pose relative to the episode start."""
    p = env.get_agent_position()
    start = getattr(env, "_start_position", None)
    if start is None:
        env._start_position = np.asarray(p["position"]).copy()
        start = env._start_position
    return {"position": np.asarray(p["position"]) - start,
            "orientation": p["orientation"]}


@register_sensor("position_sensor_pixels")
def position_sensor_pixels(env, obs, resolution: Optional[float] = None):
    """Agent position in top-down map pixels (row, col)."""
    res = resolution or env.cfg.map.voxel_size
    p = env.get_agent_position()["position"]
    lower = _host(env.map_state.lower)
    return np.asarray([(p[2] - lower[2]) / res, (p[0] - lower[0]) / res],
                      np.float32)  # (row, col)


@register_sensor("noisy_position_sensor")
def noisy_position_sensor(env, obs, sigma_pos: float = 0.05,
                          sigma_rot: float = 0.02):
    """Gaussian pose noise + map-bounds clamping."""
    rng = getattr(env, "_noise_rng", None)
    if rng is None:
        env._noise_rng = rng = np.random.default_rng(env.env_id + 91)
    p = env.get_agent_position()
    pos = np.asarray(p["position"], np.float64).copy()
    pos[0] += rng.normal(0, sigma_pos)
    pos[2] += rng.normal(0, sigma_pos)
    lower, upper = env.sim.bounds()
    pos = np.clip(pos, lower, upper)
    # rotation noise as a YAW-ANGLE perturbation: perturbing only the
    # quaternion w component and renormalizing yields exactly zero noise at
    # identity orientation and a yaw-dependent magnitude elsewhere
    q = np.asarray(p["orientation"], np.float64)
    yaw = 2.0 * np.arctan2(q[2], q[0]) + rng.normal(0, sigma_rot)
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
    return {"position": pos, "orientation": q}


@register_sensor("noisy_position_sensor2")
def noisy_position_sensor2(env, obs):
    return noisy_position_sensor(env, obs, sigma_pos=0.1, sigma_rot=0.05)


# ---------------------------------------------------------------------------
# motion / contact sensors
# ---------------------------------------------------------------------------


@register_sensor("agent_collision_sensor")
def agent_collision_sensor(env, obs):
    """Collision flag from the sim's blocked-move check (a forward move
    the sim rejected)."""
    return bool(env.collided())


@register_sensor("movement_sensor")
def movement_sensor(env, obs):
    """Displacement since the previous step."""
    p = np.asarray(env.get_agent_position()["position"])
    prev = getattr(env, "_prev_position", None)
    env._prev_position = p.copy()
    if prev is None:
        return np.zeros(3, np.float32)
    return (p - prev).astype(np.float32)


@register_sensor("proximity_sensor")
def proximity_sensor(env, obs, max_range: float = 2.0):
    """Distance to the nearest obstacle straight ahead, from the depth
    centre of the depth frame."""
    depth = _host(obs["depth"])
    h, w = depth.shape
    strip = depth[h // 2 - 2: h // 2 + 3, w // 2 - 2: w // 2 + 3]
    return float(min(strip.min(), max_range))


# ---------------------------------------------------------------------------
# map sensors
# ---------------------------------------------------------------------------


@register_sensor("gt_ego_map")
def gt_ego_map(env, obs, map_size: int = 64, map_scale: float = 0.1,
               height_band=(0.1, 1.5)):
    """2-channel egocentric (obstacle, explored) map from depth:
    back-project depth with the camera intrinsics, rotate into the agent
    frame, bin into an egocentric grid ahead of the agent."""
    depth = torch.as_tensor(obs["depth"], device=env.device)
    pts, valid = backproject_depth(depth, env.camera_pose(),
                                   env.cfg.sensors.hfov_deg,
                                   env.cfg.sensors.min_depth,
                                   env.cfg.sensors.max_depth)
    pts = _host(pts)
    valid = _host(valid)
    a = env.sim.agent
    # world -> agent frame (yaw only)
    dx = pts[..., 0] - a.x
    dz = pts[..., 2] - a.z
    c, s = np.cos(-a.yaw), np.sin(-a.yaw)
    fwd = -(c * dz - s * dx)   # distance ahead
    lat = c * dx + s * dz      # lateral
    rows = (map_size - 1 - (fwd / map_scale)).astype(np.int32)
    cols = (lat / map_scale + map_size / 2).astype(np.int32)
    inb = (rows >= 0) & (rows < map_size) & (cols >= 0) & (cols < map_size)
    y = pts[..., 1]
    obstacle_sel = valid & inb & (y > height_band[0]) & (y < height_band[1])
    explored_sel = valid & inb & (y < height_band[1])
    ego = np.zeros((map_size, map_size, 2), np.float32)
    ego[rows[obstacle_sel], cols[obstacle_sel], 0] = 1.0
    ego[rows[explored_sel], cols[explored_sel], 1] = 1.0
    return ego


@register_sensor("map_sensor")
def map_sensor(env, obs, disc_radius: int = 3):
    """Top-down obstacle/explored map with the agent disc drawn."""
    maps = env.get_and_update_disagreement_map()
    top = 0.5 * (maps[..., 0] > 0.5) + 0.25 * (maps[..., 1] > 0.5)
    p = env.get_agent_position()["position"]
    lower = _host(env.map_state.lower)
    res = env.cfg.map.voxel_size
    r = int((p[2] - lower[2]) / res)
    c = int((p[0] - lower[0]) / res)
    rr, cc = np.ogrid[: top.shape[0], : top.shape[1]]
    disc = (rr - r) ** 2 + (cc - c) ** 2 <= disc_radius ** 2
    return np.where(disc, 1.0, top).astype(np.float32)


@register_sensor("semantic_instances")
def semantic_instances(env, obs):
    """Per-pixel instance ids + instance->class mapping."""
    mapping = {a["instance_id"]: a["class_id"]
               for a in env.get_semantic_annotations()}
    return {"semantic_instances": _host(obs["instances"]),
            "mapping": mapping}


@register_sensor("object_detector_features")
def object_detector_features(env, obs, perceiver=None, max_detections=10):
    """Per-detection feature rows ('bbsf'): box(4) + class(1) + score(1)
    + logits(C) + embedding(D), zero for invalid slots."""
    if perceiver is None:
        raise ValueError("object_detector_features needs a Perceiver")
    result = perceiver.process(obs["rgb"])
    det = result.detections
    n = min(max_detections, det.valid.shape[-1])
    rows = np.concatenate([
        _host(det.boxes[0, :n].float()),
        _host(det.classes[0, :n])[:, None].astype(np.float32),
        _host(det.scores[0, :n])[:, None],
        _host(det.logits[0, :n]),
        _host(det.embeddings[0, :n]) if det.embeddings is not None
        else np.zeros((n, 0), np.float32),
    ], axis=1)
    return rows * _host(det.valid[0, :n])[:, None]
