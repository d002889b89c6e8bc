"""Named environment registry and the reward-variant envs.

`Habitat3Env` (the main env, disagreement-sum reward), `GymHabitatEnv-v2`
(objectnav distance and a greedy goal follower), `SemanticDisagreement-v0`
(adds the explored-area ratio), `SemanticDisagreement-kl` (KL reward) and
the replay envs `Viz-v0` (frames of a recorded npz store in place of the
simulator's, `sim.replay_dir`) and `Viz-v1` (with the top-down map, the
recorded trajectory and a PNG frame per step). All share the EmbodiedEnv
core.
"""

from __future__ import annotations

import os
from typing import Dict, Type

import numpy as np
import torch

from ..config import ExperimentConfig
from .env import EmbodiedEnv

ENV_REGISTRY: Dict[str, Type] = {}


def register_env(name: str):
    def deco(cls):
        ENV_REGISTRY[name] = cls
        return cls

    return deco


def make_env(name: str, cfg: ExperimentConfig, env_id: int = 0,
             **kw) -> EmbodiedEnv:
    """An env of the registered class `name`; `kw` goes to its
    constructor (`seed`, `device`)."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"unknown env {name!r}; known: "
                       f"{sorted(ENV_REGISTRY)}")
    return ENV_REGISTRY[name](cfg, env_id=env_id, **kw)


# main env (disagreement-sum reward)
register_env("Habitat3Env")(EmbodiedEnv)


@register_env("GymHabitatEnv-v2")
class GymHabitatEnvV2(EmbodiedEnv):
    """Objectnav `get_distance` (distance to the nearest top-down semantic
    cell of the goal class, 10.0 when the class was never mapped) and a
    greedy goal follower (`set_goals` / `get_action_to_goal`)."""

    NO_GOAL_DISTANCE = 10.0

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        from ..agents.baselines import SubGoalFollower

        self._follower = SubGoalFollower(self.cfg.sim.turn_angle_deg)
        self._v2_goal = None

    def get_distance(self, object_class: int) -> float:
        """Distance from the agent to the nearest mapped cell of
        `object_class` on the top-down semantic channel (class + 1
        coding)."""
        maps = np.asarray(self.get_and_update_disagreement_map())
        cells = np.argwhere(maps[..., 2] == object_class + 1)  # [K, (z, x)]
        if cells.size == 0:
            return self.NO_GOAL_DISTANCE
        lower = self.map_state.lower.cpu().numpy()
        vox = self.cfg.map.voxel_size
        world = np.stack([lower[0] + (cells[:, 1] + 0.5) * vox,
                          lower[2] + (cells[:, 0] + 0.5) * vox], axis=-1)
        a = self.sim.agent
        return float(np.min(np.hypot(world[:, 0] - a.x, world[:, 1] - a.z)))

    def set_goals(self, goals) -> None:
        self._v2_goal = goals

    def get_action_to_goal(self):
        """(action, goal_reached) greedy step toward the current goal;
        turns left in place while no goal is set; action 0 = reached."""
        if self._v2_goal is None:
            return 2, False
        a = self.sim.agent
        act = self._follower.act((a.x, a.z), a.yaw, tuple(self._v2_goal))
        return act, act == 0


@register_env("SemanticDisagreement-v0")
class SemanticDisagreementEnv(EmbodiedEnv):
    """Adds `area_ratio`, the explored share of the free space, to each
    step's info."""

    def area_ratio(self) -> float:
        maps = self.get_and_update_disagreement_map()
        explored = float((maps[..., 1] > 0.5).sum())
        # free-space denominator from the traversability grid
        trav = self.traversability(0.1)
        vox = self.cfg.map.voxel_size
        total_free = float(trav.sum()) * (0.1 / vox) ** 2
        return explored / max(total_free, 1.0)

    def step(self, action):
        obs, r, done, info = super().step(action)
        info["area_ratio"] = self.area_ratio()
        return obs, r, done, info


@register_env("SemanticDisagreement-kl")
class SemanticDisagreementKLEnv(SemanticDisagreementEnv):
    """Reward = summed KL between the current detections and the map's
    consensus. Call `set_last_frame` with each step's detections before
    `get_reward`."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._last = None

    def set_last_frame(self, detections, depth, pose) -> None:
        self._last = (detections, depth, pose)

    def get_reward(self) -> float:
        if self._last is None:
            return 0.0
        det, depth, pose = self._last
        return self.get_kl_reward(det, depth, pose)


@register_env("Viz-v0")
class VizEnv(EmbodiedEnv):
    """Replay env: each observation is a frame of a recorded npz store
    (`cfg.sim.replay_dir`, read through `SampleLoader`) in place of the
    simulator's: the env's episode is the store's episode env_id modulo
    their count, the rgb camera found by modality, the depth where the
    store holds it (zeros otherwise), instances and classes -1. A step
    advances one recorded frame; the episode ends when they run out."""

    def __init__(self, cfg: ExperimentConfig, env_id: int = 0, **kw):
        from ..utils.obs_store import SampleLoader

        if not cfg.sim.replay_dir:
            raise ValueError("Viz-v0 needs sim.replay_dir")
        self.loader = SampleLoader(cfg.sim.replay_dir)
        eps = self.loader.episodes
        self._replay_episode = eps[env_id % len(eps)]
        # the store gives each modality its own camera id, so rgb is not
        # necessarily camera 0
        self._rgb_cam = self.loader.camera_of(self._replay_episode, "rgb")
        if self._rgb_cam is None:
            raise ValueError(
                f"replay dir {cfg.sim.replay_dir} episode "
                f"{self._replay_episode} has no rgb modality")
        self._steps = self.loader.steps(self._replay_episode, self._rgb_cam,
                                        "rgb")
        self._cursor = 0
        super().__init__(cfg, env_id=env_id, **kw)

    def reset(self):
        # rewind first: the base reset ends with observe()
        self._cursor = 0
        return super().reset()

    def _step_id(self) -> int:
        return self._steps[min(self._cursor, len(self._steps) - 1)]

    def observe(self) -> Dict[str, torch.Tensor]:
        if not hasattr(self, "loader"):
            return super().observe()
        step, ep = self._step_id(), self._replay_episode
        rgb = self.loader.get_sample(ep, self._rgb_cam, "rgb", step).data
        out = {"rgb": torch.as_tensor(rgb, device=self.device)}
        for cam in self.loader.cameras(ep):
            mods = self.loader.modalities(ep, cam)
            if "depth" in mods and step in self.loader.paths[ep][cam]["depth"]:
                out["depth"] = torch.as_tensor(
                    self.loader.get_sample(ep, cam, "depth", step).data,
                    device=self.device)
        if "depth" not in out:
            out["depth"] = torch.zeros(rgb.shape[:2], dtype=torch.float32,
                                       device=self.device)
        for k in ("instances", "classes"):
            out[k] = torch.full(rgb.shape[:2], -1, dtype=torch.int32,
                                device=self.device)
        return out

    def step(self, action):
        self._cursor += 1
        self.step_count += 1
        done = self._cursor >= len(self._steps)
        return self.observe(), 0.0, done, {"replay_step": self._cursor}


@register_env("Viz-v1")
class VizTrajectoryEnv(VizEnv):
    """`Viz-v0` with, on every observation, the class-normalised top-down
    semantic map as "pcd" (a host array [Z, X]), the agent's trajectory
    from the recorded positions (`position` modality), and a top-down
    frame of map and trajectory written to
    `<runtime.obs_dir or sim.replay_dir>/viz/trajectory_%04d.png`."""

    def __init__(self, cfg: ExperimentConfig, env_id: int = 0, **kw):
        # set before the base constructor, whose reset augments
        self._traj_cells = []
        self._viz_dir = os.path.join(cfg.runtime.obs_dir or cfg.sim.replay_dir,
                                     "viz")
        super().__init__(cfg, env_id=env_id, **kw)

    def reset(self):
        obs = super().reset()
        self._traj_cells = []
        return self._augment(obs)

    def _position_cell(self):
        """The map cell (row z, column x) of the recorded agent position at
        the current replay step, None where no position was stored."""
        ep, step = self._replay_episode, self._step_id()
        for cam in self.loader.cameras(ep):
            mods = self.loader.paths[ep][cam]
            if "position" in mods and step in mods["position"]:
                data = self.loader.get_sample(ep, cam, "position", step).data
                pos = np.asarray(data.position if hasattr(data, "position")
                                 else data["position"], np.float64)
                _, lower = self.get_upper_and_lower_map_bounds()
                res = self.cfg.map.voxel_size
                return (int((pos[2] - lower[2]) / res),
                        int((pos[0] - lower[0]) / res))
        return None

    def _augment(self, obs):
        from ..config import NUM_CLASSES
        from ..utils.image_io import render_topdown, write_png

        maps = self.get_and_update_disagreement_map()  # [Z, X, 4]
        cell = self._position_cell()
        if cell is not None:
            self._traj_cells.append(cell)
        img = render_topdown(maps, self._traj_cells, cell)
        os.makedirs(self._viz_dir, exist_ok=True)
        write_png(os.path.join(self._viz_dir,
                               f"trajectory_{self.step_count:04d}.png"), img)
        obs["pcd"] = np.asarray(maps[..., 2], np.float32) / NUM_CLASSES
        return obs

    def step(self, action):
        obs, reward, done, info = super().step(action)
        return self._augment(obs), reward, done, info
