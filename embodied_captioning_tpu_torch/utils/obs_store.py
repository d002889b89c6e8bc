"""Observation store: one npz file per (episode, step, modality, camera).

The file names and payloads are the JAX package's schema,
``episode_%06d_step_%05d_modality_%s_id_%d.npz``, so a directory written
by either package loads in the other. :class:`SampleLoader` indexes such a
directory for replay.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

FILENAME_RE = re.compile(
    r"episode_(?P<episode>\d+)_step_(?P<step>\d+)_modality_(?P<mod>[A-Za-z0-9]+)_id_(?P<camera_id>\d+)\.npz$"
)


@dataclass
class SenseInfo:
    """Identity of one stored observation."""

    base_path: str
    mod: str
    episode: int = 0
    camera_id: int = 0
    step: int = 0

    def get_path(self) -> str:
        return os.path.join(
            self.base_path,
            f"episode_{self.episode:06d}_step_{self.step:05d}"
            f"_modality_{self.mod}_id_{self.camera_id}.npz",
        )


def get_sense_info(path: str) -> SenseInfo:
    """Parse a stored observation path back into a SenseInfo."""
    m = FILENAME_RE.search(os.path.basename(path))
    if not m:
        raise ValueError(f"not an observation path: {path}")
    return SenseInfo(
        base_path=os.path.dirname(path),
        mod=m.group("mod"),
        episode=int(m.group("episode")),
        camera_id=int(m.group("camera_id")),
        step=int(m.group("step")),
    )


def save_obs(exp_path: str, episode_id: int, observations: Dict[str, Any],
             timestamp: int, compressed: bool = True) -> List[str]:
    """Save one step's observations, one npz per modality. `observations`
    maps modality code -> payload; camera_id is the enumeration index."""
    os.makedirs(exp_path, exist_ok=True)
    paths = []
    for camera_id, (modality, payload) in enumerate(observations.items()):
        info = SenseInfo(exp_path, modality, int(episode_id), camera_id,
                         int(timestamp))
        path = info.get_path()
        if hasattr(payload, "raw"):
            payload = payload.raw()
        saver = np.savez_compressed if compressed else np.savez
        saver(path, payload)
        paths.append(path)
    return paths


def mask_more_n(arr, n: int) -> np.ndarray:
    """Boolean mask keeping at most the first `n` entries of every run of
    consecutive equal values (the duplicate-step filter of the dense
    sample list)."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return np.zeros(arr.shape, bool)
    change = np.ones(arr.shape[0], bool)
    change[1:] = arr[1:] != arr[:-1]
    idx = np.arange(arr.shape[0])
    run_start = idx[change][np.cumsum(change) - 1]
    return (idx - run_start) < n


class SampleLoader:
    """Index an experiment directory into
    ``paths[episode][camera][modality][step]``."""

    def __init__(self, exp_path: str):
        self.exp_path = exp_path
        self.paths: Dict[int, Dict[int, Dict[str, Dict[int, str]]]] = {}
        eps: List[int] = []
        steps: List[int] = []
        self._load_paths(eps, steps)
        # flat per-file lists in walk order
        self.episode_list = np.asarray(eps, np.int64)
        self.steps_list = np.asarray(steps, np.int64)

    def _load_paths(self, eps: List[int], steps: List[int]) -> None:
        for root, _dirs, files in os.walk(self.exp_path):
            for fname in sorted(files):
                m = FILENAME_RE.search(fname)
                if not m:
                    continue
                ep = int(m.group("episode"))
                cam = int(m.group("camera_id"))
                mod = m.group("mod")
                step = int(m.group("step"))
                self.paths.setdefault(ep, {}).setdefault(cam, {}).setdefault(
                    mod, {}
                )[step] = os.path.join(root, fname)
                eps.append(ep)
                steps.append(step)

    def get_episode_and_steps_dense_list(
            self, filter_episodes: Optional[Iterable[int]] = None,
            max_repeat: int = 1):
        """Flat (episodes, steps) over all indexed files, keeping at most
        `max_repeat` consecutive duplicates of a step (one entry per step
        instead of one per modality). Runs are
        keyed on (episode, step), not the bare step — a run keyed on step
        alone would swallow the next episode's identical first step."""
        key = self.episode_list * 100000 + self.steps_list  # step < 1e5
        mask = mask_more_n(key, max_repeat)
        if filter_episodes is not None:
            allowed = set(int(e) for e in filter_episodes)
            mask &= np.asarray([int(e) in allowed for e in self.episode_list])
        return self.episode_list[mask], self.steps_list[mask]

    def __len__(self) -> int:
        return len(self.get_episode_and_steps_dense_list()[0])

    # -- queries ----------------------------------------------------------
    @property
    def episodes(self) -> List[int]:
        return sorted(self.paths)

    def cameras(self, episode: int) -> List[int]:
        return sorted(self.paths.get(episode, {}))

    def modalities(self, episode: int, camera: int = 0) -> List[str]:
        return sorted(self.paths.get(episode, {}).get(camera, {}))

    def steps(self, episode: int, camera: int = 0,
              modality: Optional[str] = None) -> List[int]:
        mods = self.paths.get(episode, {}).get(camera, {})
        if modality is not None:
            return sorted(mods.get(modality, {}))
        common: Optional[set] = None
        for steps in mods.values():
            common = set(steps) if common is None else common & set(steps)
        return sorted(common or [])

    def get_path(self, episode: int, camera: int, modality: str,
                 step: int) -> str:
        return self.paths[episode][camera][modality][step]

    def get_sample(self, episode: int, camera: int, modality: str, step: int):
        from ..sensor_data import get_class_from_modality_code

        path = self.get_path(episode, camera, modality, step)
        return get_class_from_modality_code(modality).load(path)

    def camera_of(self, episode: int, modality: str,
                  prefer: int = 0) -> Optional[int]:
        """Camera id holding `modality`: save_obs enumerates ONE camera id
        per modality, so rgb and depth live under different ids."""
        cams = self.paths.get(episode, {})
        if modality in cams.get(prefer, {}):
            return prefer
        for cam in sorted(cams):
            if modality in cams[cam]:
                return cam
        return None

    def iter_steps(self, episode: int, camera: int = 0,
                   modalities: Optional[Iterable[str]] = None):
        """Yield (step, {modality: Sense}) over steps where all requested
        modalities exist. Modalities are located across camera ids
        (`camera` is only the preferred id): one id per modality is the
        on-disk schema, so an intersection within a single camera would
        always be empty for multi-modality requests."""
        if modalities is None:
            mods = sorted({m for cams in self.paths.get(episode, {}).values()
                           for m in cams})
        else:
            mods = list(modalities)
        cam_of = {m: self.camera_of(episode, m, camera) for m in mods}
        if any(c is None for c in cam_of.values()):
            return
        step_sets = [set(self.steps(episode, cam_of[m], m)) for m in mods]
        common = sorted(set.intersection(*step_sets)) if step_sets else []
        for step in common:
            yield step, {m: self.get_sample(episode, cam_of[m], m, step)
                         for m in mods}
