"""Exploration baselines and the observation-generation loop.

The trainers `randombaseline`, `bouncebaseline` (turn for 16 steps on a
collision), `rotatebaseline`, `frontierbaseline-v1` (frontiers on the
explored map, information-gain goal choice, A* subgoals),
`randomgoalsbaseline` (uniform random map goal) and `observeobjectbaseline`
(orbit a ground-truth object), with the `SubGoalFollower` polar pointgoal
controller. Each exposes `.generate()`: it walks the envs, runs
perception, fuses the voxel maps and writes npz observations.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..envs.sim import (
    ACTION_FORWARD, ACTION_LEFT, ACTION_RIGHT, ACTION_STOP,
)
from ..envs.vector_env import VectorEnv
from ..mapping.matching import IdAllocator, unique_ids
from ..ops.image import resize_bilinear
from ..perception import Perceiver
from ..sensor_data import Pose
from ..utils.obs_store import save_obs
from .planner import skeleton_waypoints
from .registry import register_trainer


class SubGoalFollower:
    """Polar pointgoal controller: turn until the heading error is below the
    turn angle, then move forward; STOP within `goal_radius`."""

    def __init__(self, turn_deg: float = 10.0, goal_radius: float = 0.3):
        self.turn = np.deg2rad(turn_deg)
        self.goal_radius = goal_radius

    def act(self, agent_xz: Tuple[float, float], yaw: float,
            goal_xz: Tuple[float, float]) -> int:
        dx = goal_xz[0] - agent_xz[0]
        dz = goal_xz[1] - agent_xz[1]
        if np.hypot(dx, dz) < self.goal_radius:
            return ACTION_STOP
        # heading: yaw=0 faces -Z; forward = (-sin yaw, -cos yaw)
        desired = np.arctan2(-dx, -dz)
        err = (desired - yaw + np.pi) % (2 * np.pi) - np.pi
        if err > self.turn / 2:
            return ACTION_LEFT
        if err < -self.turn / 2:
            return ACTION_RIGHT
        return ACTION_FORWARD


class StepTimer:
    """Adds the seconds since the previous lap to `timings[key]`, after
    synchronising the caller's current stream on the card (not the whole
    device: the VectorEnv worker's render may still run); does nothing
    without a timings dict."""

    def __init__(self, timings: Optional[Dict[str, float]], device):
        self.timings = timings
        self.on_card = torch.device(device).type == "cuda"
        self.clock = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.timings is None:
            return
        if self.on_card:
            torch.cuda.current_stream().synchronize()
        now = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + now - self.clock
        self.clock = now


class BaseTrainer:
    """Shared loop: vector envs + perception + voxel fusion + obs store,
    on `device`."""

    def __init__(self, cfg: ExperimentConfig, perceiver: Optional[Perceiver]
                 = None, with_perception: bool = True, device="cuda",
                 w8a8: bool = False, int8_kv: bool = True,
                 render_mode: Optional[str] = None):
        """`w8a8` and `int8_kv` go to the perceiver made here (a handed
        `perceiver` keeps its own), `render_mode` to the envs' renders."""
        self.cfg = cfg
        self.envs = VectorEnv(cfg, device=device, env_ids=self._env_ids(),
                              render_mode=render_mode)
        self.perceiver = perceiver or (
            Perceiver(cfg, seed=cfg.runtime.seed, device=device, w8a8=w8a8,
                      int8_kv=int8_kv)
            if with_perception else None)
        self.id_alloc = IdAllocator()
        self.follower = SubGoalFollower(cfg.sim.turn_angle_deg)
        self.obs_dir = cfg.runtime.obs_dir
        self.saved_paths: List[str] = []
        self._step = 0

    def _env_ids(self) -> Optional[List[int]]:
        """The ids of the envs this process steps (None: all of
        `runtime.num_envs`)."""
        return None

    # -- policy interface (override per baseline) -------------------------
    def actions(self, obs) -> List[int]:
        raise NotImplementedError

    def on_episode_reset(self, i: int) -> None:
        """Env `i` auto-reset into a NEW episode/scene this step: per-env
        plan/goal state derived from the old scene must be discarded."""

    def on_step(self, obs, infos) -> None:
        pass

    # -- perception + fusion ----------------------------------------------
    def perceive_and_fuse(self, obs, timer: Optional["StepTimer"] = None
                          ) -> Optional[object]:
        """Run perception on the env batch's frames (on the device, as they
        are) and integrate each env's detections into its voxel map at
        sensor resolution: masks upsampled from the detector's raster,
        boxes scaled (in their own type, bf16) to sensor pixels. `timer`
        takes a "perceive" and a "fuse" lap."""
        if self.perceiver is None:
            return None
        result = self.perceiver.process(obs["rgb"])
        if timer is not None:
            timer.lap("perceive")
        det = result.detections
        for i, env in enumerate(self.envs.envs):
            d_i = obs["depth"][i]
            pose = env.camera_pose()
            per_env = det.index(i)
            if per_env.masks.shape[-1] != d_i.shape[-1]:
                m = resize_bilinear(per_env.masks.movedim(0, -1),
                                    d_i.shape[0], d_i.shape[1])
                scale = d_i.shape[0] / self.cfg.detector.image_size
                per_env = per_env.replace(masks=m.movedim(-1, 0),
                                          boxes=per_env.boxes * scale)
            env.update_pointcloud(per_env, depth=d_i, pose=pose)
            if hasattr(env, "set_last_frame"):
                # the KL-reward env reads the frame's detections
                env.set_last_frame(per_env, d_i, pose)
        if timer is not None:
            timer.lap("fuse")
        return result

    def save_step_obs(self, obs, result) -> None:
        """Write each env's frame (rgb, depth, pose and, with perception,
        detections with ids and captions) to `obs_dir`/env<i>. One copy to
        the host per field for the whole batch."""
        if not self.obs_dir:
            return
        rgb = obs["rgb"].cpu().numpy()
        depth = obs["depth"].cpu().numpy()
        if result is not None:
            dets = result.detections.to_numpy_dict()
            caps = self.perceiver.captions(result)
        for i, env in enumerate(self.envs.envs):
            # the dispatch-time snapshot, not the live getters: the
            # VectorEnv worker is already stepping frame t+1
            snap = self.envs.snapshot_at(i)
            payload: Dict[str, object] = {
                "rgb": rgb[i],
                "depth": depth[i],
                "position": np.array(
                    Pose(**snap["position"]).to_dict(), dtype=object),
            }
            if result is not None:
                nd = {k: v[i] for k, v in dets.items()}
                obj_ids, ep_ids = unique_ids(result.detections.index(i),
                                             self.id_alloc,
                                             snap["episode_id"])
                nd["object_ids"] = obj_ids
                nd["episode_ids"] = ep_ids
                nd["captions"] = np.array(caps[i], dtype=object)
                payload["bbs"] = np.array({"instances": nd}, dtype=object)
            if self.cfg.runtime.save_gt_obs and "instances" in obs:
                # the ground-truth detection sensor ('bbsgt'): persistent
                # per-scene instance ids
                from ..envs.sensors import get_sensor

                gt = get_sensor("object_detector_gt")(
                    env, {k: obs[k][i] for k in ("instances", "classes",
                                                 "depth", "rgb")
                          if k in obs})
                payload["bbsgt"] = np.array({"instances": gt.to_numpy_dict()},
                                            dtype=object)
            dir_i = os.path.join(self.obs_dir, f"env{i}")
            self.saved_paths += save_obs(dir_i, snap["episode_id"],
                                         payload, snap["step"])

    # -- loops -------------------------------------------------------------
    def generate(self, num_steps: Optional[int] = None,
                 timings: Optional[Dict[str, float]] = None) -> List[str]:
        """Exploration + observation recording.

        Double-buffered: after fusing frame t and choosing actions, frame
        t+1's simulation and render go to the VectorEnv worker
        (`step_async`) while this thread reads back frame t and writes its
        observations.

        With `timings` (a dict), the caller's stream is synchronised after
        each part of a step and the seconds are added under "perceive",
        "fuse" (upsample and fusion), "save" (`save_step_obs`) and "wait"
        (`step_wait`), and the worker's under "worker" (agent steps,
        render and resets, to its stream's end); without it nothing
        synchronises."""
        steps = num_steps or self.cfg.sim.episode_steps
        self.envs.timings = timings
        obs = self.envs.observe()
        for _ in range(steps):
            timer = StepTimer(timings, self.envs.device)
            result = self.perceive_and_fuse(obs, timer)
            acts = self.actions(obs)
            self.envs.step_async(acts)         # sim t+1 in flight
            self.save_step_obs(obs, result)    # host IO overlaps the render
            timer.lap("save")
            obs, _, dones, infos = self.envs.step_wait()
            timer.lap("wait")
            for i in np.flatnonzero(np.asarray(dones)):
                self.on_episode_reset(int(i))
            self.on_step(obs, infos)
            self._step += 1
        self.envs.timings = None
        return sorted(self.saved_paths)

    def train(self, num_steps: Optional[int] = None):
        """A baseline learns nothing: training is `generate`."""
        return self.generate(num_steps)

    def rewards(self) -> np.ndarray:
        return np.asarray([env.get_reward() for env in self.envs.envs])

    # -- fused stepping -----------------------------------------------------
    def fused_window(self, window: int) -> np.ndarray:
        """Run `window` env+perception+fusion steps through
        `envs.device_loop.rollout_fused` instead of `window` iterations of
        the loop above.

        The controller (`self.actions`) reads only host state, so the
        window's action plan is computed by stepping the host sims without
        rendering (env.step_state); the device then executes the same plan
        with perception and voxel fusion. After the window the device pose
        is copied back over the host's so float32-vs-float64 drift cannot
        accumulate across windows.

        An episode end must land on the window's last step (choose window
        | episode_steps). Returns the per-env done mask for the window.
        """
        from ..envs.device_loop import rollout_fused, states_from_sims
        from ..mapping.voxel_map import VoxelMapState

        e = self.envs.num_envs
        scenes, state0 = states_from_sims([env.sim for env in self.envs.envs])
        maps0 = VoxelMapState(*(torch.stack(xs) for xs in zip(
            *(env.map_state for env in self.envs.envs))))
        plan = np.zeros((window, e), np.int32)
        win_done = np.zeros(e, bool)
        for k in range(window):
            acts = self.actions(None)
            plan[k] = acts
            for i, env in enumerate(self.envs.envs):
                _, d, _ = env.step_state(int(acts[i]))
                win_done[i] |= d
            assert not (win_done.any() and k < window - 1), (
                "episode end mid-window: choose window | episode_steps")
        state1, maps1, _, collided = rollout_fused(
            self.perceiver.params, scenes, state0, maps0,
            torch.from_numpy(plan), self.cfg, w8a8=self.perceiver.w8a8,
            int8_kv=self.perceiver.int8_kv)
        xs, zs, yaws = (t.cpu().numpy() for t in (state1.x, state1.z,
                                                   state1.yaw))
        last_hit = collided[-1].cpu().numpy()
        for i, env in enumerate(self.envs.envs):
            env.map_state = VoxelMapState(*(x[i] for x in maps1))
            if win_done[i]:
                env.reset()  # fresh scene and map; the device pose is stale
                self.on_episode_reset(i)
            else:
                env.sim.agent.x = float(xs[i])
                env.sim.agent.z = float(zs[i])
                env.sim.agent.yaw = float(yaws[i])
                env._collision = bool(last_hit[i])
        self._step += window
        return win_done


@register_trainer("randombaseline")
class RandomBaseline(BaseTrainer):
    """Uniform random discrete actions."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._rng = np.random.default_rng(cfg.runtime.seed)

    def actions(self, obs) -> List[int]:
        return list(self._rng.integers(1, 4, self.envs.num_envs))


@register_trainer("rotatebaseline")
class RotateBaseline(BaseTrainer):
    """Turn in place."""

    def actions(self, obs) -> List[int]:
        return [ACTION_LEFT] * self.envs.num_envs


@register_trainer("bouncebaseline")
class BounceBaseline(BaseTrainer):
    """Go straight; on collision turn for 16 steps in a random
    direction."""

    TURN_STEPS = 16

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._rng = np.random.default_rng(cfg.runtime.seed)
        self._turning = np.zeros(self.envs.num_envs, np.int32)
        self._dir = np.full(self.envs.num_envs, ACTION_LEFT, np.int32)

    def actions(self, obs) -> List[int]:
        acts = []
        for i, env in enumerate(self.envs.envs):
            if env.collided() and self._turning[i] == 0:
                self._turning[i] = self.TURN_STEPS
                self._dir[i] = (ACTION_LEFT if self._rng.random() < 0.5
                                else ACTION_RIGHT)
            if self._turning[i] > 0:
                self._turning[i] -= 1
                acts.append(int(self._dir[i]))
            else:
                acts.append(ACTION_FORWARD)
        return acts


class _GoalDirectedTrainer(BaseTrainer):
    """Shared machinery: per-env goal, A* waypoints, follower control."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._rng = np.random.default_rng(cfg.runtime.seed + 7)
        n = self.envs.num_envs
        self._waypoints: List[List[Tuple[float, float]]] = [[] for _ in
                                                            range(n)]
        self.plan_resolution = 0.1

    def _plan_to(self, i: int, goal_xz: Tuple[float, float]) -> None:
        env = self.envs.envs[i]
        grid = env.traversability(self.plan_resolution)
        res = self.plan_resolution
        a = env.sim.agent
        start = (int(a.z / res), int(a.x / res))
        goal = (int(goal_xz[1] / res), int(goal_xz[0] / res))
        wps = skeleton_waypoints(grid, start, goal, every=8)
        self._waypoints[i] = [((c + 0.5) * res, (r + 0.5) * res)
                              for r, c in wps][1:]

    def on_episode_reset(self, i: int) -> None:
        self._waypoints[i] = []

    def _follow(self, i: int) -> int:
        env = self.envs.envs[i]
        a = env.sim.agent
        while self._waypoints[i]:
            gx, gz = self._waypoints[i][0]
            if np.hypot(gx - a.x, gz - a.z) < 0.3:
                self._waypoints[i].pop(0)
                continue
            return self.follower.act((a.x, a.z), a.yaw, (gx, gz))
        return ACTION_STOP

    def new_goal(self, i: int) -> Tuple[float, float]:
        raise NotImplementedError

    def actions(self, obs) -> List[int]:
        acts = []
        for i in range(self.envs.num_envs):
            if not self._waypoints[i]:
                self._plan_to(i, self.new_goal(i))
            a = self._follow(i)
            if a == ACTION_STOP:
                self._waypoints[i] = []
                a = ACTION_LEFT  # scan while waiting for a new goal
            acts.append(a)
        return acts


@register_trainer("randomgoalsbaseline")
class RandomGoalsBaseline(_GoalDirectedTrainer):
    """Uniform random reachable map goals + A*."""

    def new_goal(self, i: int) -> Tuple[float, float]:
        size = self.cfg.sim.scene_size
        for _ in range(50):
            g = (self._rng.uniform(0.4, size - 0.4),
                 self._rng.uniform(0.4, size - 0.4))
            if not self.envs.envs[i].sim._blocked(*g):
                return g
        return (size / 2, size / 2)


@register_trainer("frontierbaseline-v1")
class FrontierBaseline(_GoalDirectedTrainer):
    """Frontier exploration: frontiers = free cells adjacent to unexplored
    space on the env's top-down map; goal = the frontier with the largest
    unexplored neighborhood (information gain)."""

    def _gain_field(self, maps: np.ndarray) -> np.ndarray:
        """Per-cell information value integrated around each frontier;
        v1 counts unexplored cells."""
        return (~(maps[..., 1] > 0.5)).astype(np.float64)

    def new_goal(self, i: int) -> Tuple[float, float]:
        env = self.envs.envs[i]
        maps = env.get_and_update_disagreement_map()  # [Z, X, 4]
        explored = maps[..., 1] > 0.5
        obstacle = maps[..., 0] > 0.5
        free = explored & ~obstacle
        # frontier: free cell with an unexplored 4-neighbor
        unexp = ~explored
        nb = (np.roll(unexp, 1, 0) | np.roll(unexp, -1, 0)
              | np.roll(unexp, 1, 1) | np.roll(unexp, -1, 1))
        frontier = free & nb
        ys, xs = np.nonzero(frontier)
        if len(ys) == 0:
            return RandomGoalsBaseline.new_goal(self, i)  # fallback
        # information gain in an 11x11 window: the whole map at once with a
        # box filter over the summed-area table
        field = self._gain_field(np.asarray(maps))
        ii = np.zeros((field.shape[0] + 1, field.shape[1] + 1), np.float64)
        ii[1:, 1:] = np.cumsum(np.cumsum(field, 0), 1)
        h, w = field.shape
        y0 = np.clip(ys - 5, 0, h)
        y1 = np.clip(ys + 6, 0, h)
        x0 = np.clip(xs - 5, 0, w)
        x1 = np.clip(xs + 6, 0, w)
        gains = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
        j = int(np.argmax(gains))
        vox = self.cfg.map.voxel_size
        lower = env.map_state.lower.cpu().numpy()
        # +0.5: the cell's centre, as every other cell -> world conversion
        return ((xs[j] + 0.5) * vox + lower[0],
                (ys[j] + 0.5) * vox + lower[2])


@register_trainer("observeobjectbaseline")
class ObserveObjectBaseline(_GoalDirectedTrainer):
    """Scripted object-orbiting tracker: pick a ground-truth object, walk
    viewpoints around it to gather multi-view captions."""

    ORBIT_RADIUS = 1.6
    ORBIT_POINTS = 8

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._orbits: List[List[Tuple[float, float]]] = [
            [] for _ in range(self.envs.num_envs)]

    def on_episode_reset(self, i: int) -> None:
        super().on_episode_reset(i)
        self._orbits[i] = []  # old scene's object viewpoints

    def new_goal(self, i: int) -> Tuple[float, float]:
        env = self.envs.envs[i]
        if not self._orbits[i]:
            anns = env.get_semantic_annotations()
            if anns:
                k = self._rng.integers(0, len(anns))
                mn = np.asarray(anns[k]["aabb_min"])
                mx = np.asarray(anns[k]["aabb_max"])
                c = (mn + mx) / 2
                angles = np.linspace(0, 2 * np.pi, self.ORBIT_POINTS,
                                     endpoint=False)
                pts = [(float(c[0] + self.ORBIT_RADIUS * np.cos(a)),
                        float(c[2] + self.ORBIT_RADIUS * np.sin(a)))
                       for a in angles]
                self._orbits[i] = [p for p in pts
                                   if not env.sim._blocked(*p)]
        if self._orbits[i]:
            return self._orbits[i].pop(0)
        return RandomGoalsBaseline.new_goal(self, i)
