"""Named environment registry and the reward-variant envs.

`Habitat3Env` (the main env, disagreement-sum reward), `GymHabitatEnv-v2`
(objectnav distance and a greedy goal follower), `SemanticDisagreement-v0`
(adds the explored-area ratio) and `SemanticDisagreement-kl` (KL reward).
All share the EmbodiedEnv core. The replay envs (`Viz-v0`, `Viz-v1`) are
not ported.
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np

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
