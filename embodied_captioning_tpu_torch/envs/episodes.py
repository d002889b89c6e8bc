"""Episode dataset: deterministic episode specs per scene and split.

A dataset is an ordered list of episode specs (scene, start pose,
optional goals) that the env iterates; splits are disjoint deterministic
seed ranges.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class EpisodeSpec:
    episode_id: int
    scene_seed: int
    start_position: Tuple[float, float]  # (x, z)
    start_yaw: float
    goals: List[Tuple[float, float]] = field(default_factory=list)
    split: str = "train"


class EpisodeDataset:
    """Deterministic episode generator."""

    SPLIT_OFFSETS = {"train": 0, "val": 10_000, "test": 20_000}

    def __init__(self, num_episodes: int = 100, split: str = "train",
                 scene_size: float = 12.0, scenes: Optional[List[int]] = None,
                 seed: int = 0):
        self.split = split
        base = self.SPLIT_OFFSETS.get(split, 0) + seed
        scenes = scenes or list(range(8))
        rng = np.random.default_rng(base)
        self.episodes: List[EpisodeSpec] = []
        for i in range(num_episodes):
            scene = scenes[i % len(scenes)]
            self.episodes.append(EpisodeSpec(
                episode_id=base + i,
                scene_seed=base + scene,
                start_position=(float(rng.uniform(0.6, scene_size - 0.6)),
                                float(rng.uniform(0.6, scene_size - 0.6))),
                start_yaw=float(rng.uniform(0, 2 * np.pi)),
                goals=[(float(rng.uniform(0.6, scene_size - 0.6)),
                        float(rng.uniform(0.6, scene_size - 0.6)))],
                split=split,
            ))

    def __len__(self) -> int:
        return len(self.episodes)

    def __iter__(self) -> Iterator[EpisodeSpec]:
        return iter(self.episodes)

    def __getitem__(self, i: int) -> EpisodeSpec:
        return self.episodes[i]

    # -- persistence (json) ------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump([asdict(e) for e in self.episodes], fh)

    @staticmethod
    def load(path: str) -> "EpisodeDataset":
        ds = EpisodeDataset(num_episodes=0)
        with open(path) as fh:
            rows = json.load(fh)
        ds.episodes = [EpisodeSpec(**{**r,
                                      "start_position": tuple(r["start_position"]),
                                      "goals": [tuple(g) for g in r["goals"]]})
                       for r in rows]
        return ds


def apply_episode(env, spec: EpisodeSpec) -> None:
    """Reset an EmbodiedEnv onto a spec: rebuild the scene from the spec's
    seed and place the agent at its start pose."""
    from ..mapping import voxel_map as V
    from .sim import RaycastSim

    env.episode_id = spec.episode_id
    env.step_count = 0
    env.sim = RaycastSim(env.cfg.sim, env.cfg.sensors, seed=spec.scene_seed,
                         device=env.device, render_mode=env.render_mode)
    x, z = spec.start_position
    if not env.sim._blocked(x, z):
        env.sim.agent.x, env.sim.agent.z = x, z
    env.sim.agent.yaw = spec.start_yaw
    lower, _ = env.sim.bounds()
    env.map_state = V.create(env.cfg.map, lower_bound=lower,
                             episode=spec.episode_id, device=env.device)
    env._trav = None
