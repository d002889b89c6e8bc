"""Environment: simulator + per-episode device voxel map + reward.

The RPC surface the agents call through VectorEnv: `get_agent_position`,
`get_upper_and_lower_map_bounds`, `update_pointcloud`,
`get_and_update_disagreement_map`, `get_reward` (= disagreement sum /
1000), `get_scene`, `get_episode_id`, `get_step`, `get_path`, plus the
KL-scored variant `get_kl_reward`. The 3D fusion state is a
`VoxelMapState` of tensors on the env's device, updated by
`integrate_frame`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..mapping import voxel_map as V
from ..ops.detections import Detections
from ..ops.image import resize_bilinear
from .sim import RaycastSim


def _match_raster(depth: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Bring sensor-resolution depth [H, W] to the detection-mask raster:
    an exact stride subsample when the ratio is integral (bilinear would
    average across depth discontinuities and invent 3D points), else a
    bilinear resize."""
    if depth.shape[-1] == masks.shape[-1]:
        return depth
    stride = depth.shape[-1] // masks.shape[-1]
    if stride * masks.shape[-1] == depth.shape[-1]:
        return depth[::stride, ::stride]
    return resize_bilinear(depth[..., None], masks.shape[-2],
                           masks.shape[-1])[..., 0]


class EmbodiedEnv:
    """One environment = one scene + one agent + one voxel map, on
    `device`."""

    def __init__(self, cfg: ExperimentConfig, env_id: int = 0,
                 seed: Optional[int] = None, device="cuda",
                 render_mode: str = "onehot"):
        self.cfg = cfg
        self.render_mode = render_mode
        self.env_id = env_id
        self.device = torch.device(device)
        self._seed = (seed if seed is not None
                      else cfg.sim.scene_seed + 1000 * env_id)
        self.sim: RaycastSim = None  # type: ignore
        self.map_state: V.VoxelMapState = None  # type: ignore
        # episode ids are unique across envs: the npz store keys on them
        self._episode_base = env_id * 100000
        self.episode_id = self._episode_base - 1
        self.step_count = 0
        self._collision = False
        self._trav = None
        self.reset()

    # -- episode lifecycle ------------------------------------------------
    def reset(self) -> Dict[str, torch.Tensor]:
        self.episode_id += 1
        self.step_count = 0
        self.sim = RaycastSim(self.cfg.sim, self.cfg.sensors,
                              seed=self._seed + self.episode_id,
                              device=self.device,
                              render_mode=self.render_mode)
        lower, _ = self.sim.bounds()
        self.map_state = V.create(self.cfg.map, lower,
                                  episode=self.episode_id, device=self.device)
        self._trav = None
        self._collision = False
        # the position and movement sensors' caches belong to the old
        # episode
        for attr in ("_start_position", "_prev_position"):
            if hasattr(self, attr):
                delattr(self, attr)
        return self.observe()

    def observe(self) -> Dict[str, torch.Tensor]:
        return self.sim.observe()

    def traversability(self, resolution: float = 0.1) -> np.ndarray:
        """Free-space grid, cached per resolution."""
        if self._trav is None or self._trav[0] != resolution:
            self._trav = (resolution, self.sim.traversability(resolution))
        return self._trav[1]

    def step_state(self, action: int) -> Tuple[float, bool, Dict]:
        """Advance the agent without rendering: VectorEnv renders every
        env's frame in one batched call."""
        self._collision = self.sim.step(int(action))
        self.step_count += 1
        done = self.step_count >= self.cfg.sim.episode_steps
        info = {"collision": self._collision, "step": self.step_count}
        return 0.0, done, info

    def step(self, action: int) -> Tuple[Dict[str, torch.Tensor], float,
                                         bool, Dict]:
        reward, done, info = self.step_state(action)
        return self.observe(), reward, done, info

    # -- RPC surface ------------------------------------------------------
    def set_goals(self, goals) -> None:
        """Store navigation goals [(x, z), ...]."""
        self.goals = [tuple(g) for g in goals]

    def get_goals(self):
        return getattr(self, "goals", [])

    def get_agent_position(self) -> Dict[str, np.ndarray]:
        pose = self.sim.agent.pose()
        return {"position": pose.position, "orientation": pose.orientation}

    def get_upper_and_lower_map_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lower, upper = self.sim.bounds()
        return upper, lower

    def get_scene(self) -> str:
        return f"raycast-{self._seed}"

    def get_episode_id(self) -> int:
        return self.episode_id

    def get_step(self) -> int:
        return self.step_count

    def collided(self) -> bool:
        return self._collision

    def camera_pose(self) -> torch.Tensor:
        """[4, 4] float32 T_world_cam of the agent's camera, on the env's
        device."""
        return torch.from_numpy(self.sim.agent.camera_matrix()).float().to(
            self.device)

    def update_pointcloud(self, detections: Detections,
                          depth: Optional[torch.Tensor] = None,
                          pose: Optional[torch.Tensor] = None) -> None:
        """Fuse one frame's (captioned, embedded) detections into the voxel
        map; without depth and pose, the current view's."""
        if depth is None or pose is None:
            depth = self.sim.observe()["depth"]
            pose = self.camera_pose()
        emb = detections.embeddings
        if emb is None:
            emb = torch.zeros(detections.capacity, self.cfg.map.embed_dim,
                              device=self.device)
        depth = _match_raster(depth, detections.masks)
        self.map_state = V.integrate_frame(
            self.map_state, depth, pose, detections.masks,
            detections.classes, detections.logits, emb, detections.valid,
            self.cfg.map, hfov_deg=self.cfg.sensors.hfov_deg,
            min_depth=self.cfg.sensors.min_depth,
            max_depth=self.cfg.sensors.max_depth)

    def get_and_update_disagreement_map(self) -> np.ndarray:
        """4-channel top-down map [Z, X, 4] on the host; channel 3 is the
        disagreement."""
        return V.topdown_maps(self.map_state, self.cfg.map).cpu().numpy()

    def get_reward(self) -> float:
        """The disagreement map's sum times `ppo.reward_scale` (1/1000)."""
        return float(V.disagreement_reward(
            self.map_state, self.cfg.map, scale=self.cfg.ppo.reward_scale))

    def get_kl_reward(self, detections: Detections, depth: torch.Tensor,
                      pose: torch.Tensor) -> float:
        """Summed KL between the frame's detections and the map's
        consensus."""
        depth = _match_raster(depth, detections.masks)
        kls = V.kl_score(self.map_state, depth, pose, detections.masks,
                         detections.logits, detections.valid, self.cfg.map,
                         hfov_deg=self.cfg.sensors.hfov_deg)
        return float(kls.sum())

    def get_path(self, start_xz: Tuple[float, float],
                 goal_xz: Tuple[float, float],
                 resolution: float = 0.1) -> np.ndarray:
        """Shortest path on the traversability grid: [K, 2] (x, z)
        waypoints in meters (empty if unreachable)."""
        from ..agents.planner import astar

        grid = self.traversability(resolution)

        def to_cell(p):
            return (int(np.clip(p[1] / resolution, 0, grid.shape[0] - 1)),
                    int(np.clip(p[0] / resolution, 0, grid.shape[1] - 1)))

        path = astar(grid, to_cell(start_xz), to_cell(goal_xz))
        if len(path) == 0:
            return np.zeros((0, 2), np.float32)
        return np.asarray([[(c + 0.5) * resolution, (r + 0.5) * resolution]
                           for r, c in path], np.float32)

    def get_semantic_annotations(self):
        """The scene's object boxes: instance id, class id, AABB."""
        s = self.sim._scene_np
        out = []
        for i in range(len(s.valid)):
            if s.valid[i] and s.class_id[i] >= 0:
                out.append({
                    "instance_id": int(s.instance_id[i]),
                    "class_id": int(s.class_id[i]),
                    "aabb_min": s.box_min[i].tolist(),
                    "aabb_max": s.box_max[i].tolist(),
                })
        return out

    def object_disagreements(self) -> np.ndarray:
        return V.object_disagreement(self.map_state,
                                     self.cfg.map).cpu().numpy()
