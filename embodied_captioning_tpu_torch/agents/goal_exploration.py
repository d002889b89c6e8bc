"""goalexplorationbaseline-v0..v3: disagreement-driven RL exploration.

Each step perception detects, captions and embeds; the voxel maps fuse
the detections and give the disagreement reward (sum / 1000). Every
`num_global_steps` env steps a PPO "global policy" over [S, S, 2] maps
(the resized disagreement map and the top-down map with the agent's
disc) and a 72-bin orientation embedding chooses an (x, y) in [0, 1]^2
map goal, which becomes an A* waypoint plan for the SubGoalFollower.
`train()` adds GAE and PPO updates every few decisions and checkpoints;
`generate()` is the same loop without updates, writing npz observations.

Variants:
  -v1 delayed reward   the absolute disagreement at the decision boundary
  -v2 trajectory       the window's cumulative reward, undiscounted
  -v3 image-history    the policy input stacks the last 4 map frames

The policy's forward and the PPO update run on the trainer's device;
the rollout storage, the policy maps and the GRU state live on the host.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..ops.image import resize_bilinear
from ..params import from_jax, load_pickle, to_numpy
from ..utils.profiling import PROFILER
from .baselines import _GoalDirectedTrainer
from .policy import act as policy_act
from .policy import init_policy, policy_forward
from .ppo import PPOState, create_state, ppo_update
from .registry import register_trainer
from .storage import RolloutStorage


def make_policy_inputs(topdown: np.ndarray, agent_xz: Tuple[float, float],
                       lower: np.ndarray, voxel_size: float,
                       map_size: int, device="cpu") -> np.ndarray:
    """[Z, X, 4] env maps -> [map_size, map_size, 2] policy input:
    ch0 = disagreement map, ch1 = topdown (obstacle 0.5 / explored 0.25)
    with the agent's disc stamped at 1.0; resized on `device`."""
    dis = topdown[..., 3]
    top = 0.5 * (topdown[..., 0] > 0.5) + 0.25 * (topdown[..., 1] > 0.5)
    r = int((agent_xz[1] - lower[2]) / voxel_size)
    c = int((agent_xz[0] - lower[0]) / voxel_size)
    rr, cc = np.ogrid[:top.shape[0], :top.shape[1]]
    disc = (rr - r) ** 2 + (cc - c) ** 2 <= 9
    top = np.where(disc, 1.0, top)
    stack = np.stack([dis, top], axis=-1).astype(np.float32)
    out = resize_bilinear(torch.from_numpy(stack).to(device), map_size,
                          map_size)
    return out.cpu().numpy()


def orientation_bin(yaw: float, bins: int = 72) -> int:
    deg = np.rad2deg(yaw) % 360.0
    return int(deg / (360.0 / bins)) % bins


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@register_trainer("goalexplorationbaseline-v0")
class GoalExplorationTrainer(_GoalDirectedTrainer):
    REWARD_MODE = "delta"  # per-window disagreement delta

    RNN_DIM = 256  # GRU hidden width (policy.init_gru)

    def __init__(self, cfg: ExperimentConfig, **kw):
        super().__init__(cfg, **kw)
        self.device = self.envs.device
        self.pcfg = cfg.policy
        seed = cfg.runtime.seed
        self.g_params = init_policy(
            torch.Generator(device=self.device).manual_seed(seed + 42),
            cfg.policy, device=self.device)
        self.ppo_state: PPOState = create_state(self.g_params, cfg.ppo)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 77)
        self._last_reward = np.zeros(self.envs.num_envs, np.float32)
        self._pending_goal: List[Optional[Tuple[float, float]]] = [
            None] * self.envs.num_envs
        self.metrics_log: List[Dict[str, float]] = []
        # recurrent trunk state, on the host
        self._rnn = (np.zeros((self.envs.num_envs, self.RNN_DIM), np.float32)
                     if cfg.policy.recurrent else None)
        ckpt = cfg.runtime.checkpoint_dir
        if ckpt and os.path.exists(os.path.join(ckpt, "policy.pkl")):
            self.load_checkpoint(os.path.join(ckpt, "policy.pkl"))

    # -- policy plumbing ---------------------------------------------------
    def _tensors(self, maps, orients) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(np.asarray(maps, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(orients)).to(self.device))

    def _act(self, maps, orients, deterministic: bool = False):
        """One policy decision, drawn from the trainer's generator; advances
        the GRU state when recurrent. Returns host arrays (action, raw,
        log_prob, value, pre-step GRU state or None): PPO evaluates again
        against the pre-step state."""
        m, o = self._tensors(maps, orients)
        if self._rnn is None:
            a, raw, lp, v = policy_act(self.ppo_state.params, self._gen, m, o,
                                       deterministic=deterministic)
            return _host(a), _host(raw), _host(lp), _host(v), None
        pre = self._rnn.copy()
        a, raw, lp, v, h = policy_act(
            self.ppo_state.params, self._gen, m, o,
            deterministic=deterministic,
            rnn_state=torch.from_numpy(pre).to(self.device))
        self._rnn = _host(h)
        return _host(a), _host(raw), _host(lp), _host(v), pre

    def _frame_obs(self):
        """Current-frame policy maps [E, S, S, 2] + orientation bins [E]."""
        maps, orients = [], []
        for env in self.envs.envs:
            td = env.get_and_update_disagreement_map()
            a = env.sim.agent
            maps.append(make_policy_inputs(
                td, (a.x, a.z), env.map_state.lower.cpu().numpy(),
                self.cfg.map.voxel_size, self.pcfg.map_size, self.device))
            orients.append(orientation_bin(a.yaw, self.pcfg.orientation_bins))
        return np.stack(maps), np.asarray(orients, np.int32)

    def _policy_obs(self):
        with PROFILER.range("policy_inputs"):
            return self._frame_obs()

    def _goals_from_actions(self, actions: np.ndarray) -> None:
        """(x, y) in [0,1]^2 -> world map goal -> A* plan."""
        for i, env in enumerate(self.envs.envs):
            lower = env.map_state.lower.cpu().numpy()
            gx = lower[0] + float(actions[i, 0]) * (
                self.cfg.map.grid[0] * self.cfg.map.voxel_size)
            gz = lower[2] + float(actions[i, 1]) * (
                self.cfg.map.grid[2] * self.cfg.map.voxel_size)
            gx = float(np.clip(gx, 0.3, self.cfg.sim.scene_size - 0.3))
            gz = float(np.clip(gz, 0.3, self.cfg.sim.scene_size - 0.3))
            self._pending_goal[i] = (gx, gz)
            self._plan_to(i, (gx, gz))

    def new_goal(self, i: int) -> Tuple[float, float]:
        if self._pending_goal[i] is not None:
            return self._pending_goal[i]
        size = self.cfg.sim.scene_size
        return (size / 2, size / 2)

    def _window_rewards(self) -> np.ndarray:
        cur = self.rewards()
        if self.REWARD_MODE == "delta":
            r = cur - self._last_reward
        else:
            r = cur
        self._last_reward = cur
        return r.astype(np.float32)

    # -- main loops --------------------------------------------------------
    def generate(self, num_steps: Optional[int] = None) -> List[str]:
        steps = num_steps or self.cfg.sim.episode_steps
        replan = self.cfg.ppo.replanning_steps
        obs = self.envs.observe()
        for t in range(steps):
            result = self.perceive_and_fuse(obs)
            if t % replan == 0:
                maps, orients = self._policy_obs()
                a = self._act(maps, orients)[0]
                self._goals_from_actions(a)
            acts = self.actions(obs)
            self.envs.step_async(acts)         # sim t+1 overlaps obs writes
            self.save_step_obs(obs, result)
            obs, _, dones, infos = self.envs.step_wait()
            for i in np.flatnonzero(np.asarray(dones)):
                self.on_episode_reset(int(i))
            self._step += 1
        return sorted(self.saved_paths)

    def _unfused_window(self, obs, window: int):
        """`window` iterations of the unfused loop: (obs after the
        window, per-env done mask over it)."""
        win_done = np.zeros(self.envs.num_envs, bool)
        for _ in range(window):
            result = self.perceive_and_fuse(obs)
            acts = self.actions(obs)
            self.envs.step_async(acts)
            self.save_step_obs(obs, result)
            obs, _, dones, infos = self.envs.step_wait()
            win_done |= np.asarray(dones)
            for i in np.flatnonzero(np.asarray(dones)):
                self.on_episode_reset(int(i))
            self._step += 1
        return obs, win_done

    def train(self, num_updates: int = 4,
              decisions_per_update: Optional[int] = None,
              fused: bool = False) -> List[Dict]:
        """PPO training: a global decision every `num_global_steps` env
        steps, a PPO update every `decisions_per_update` decisions (8 by
        default).

        fused=True runs each window's env+perception+fusion steps through
        `BaseTrainer.fused_window` (`rollout_fused`): it needs
        num_global_steps | episode_steps and records no observations
        inside the windows. PROFILER times each update's "rollout" (with
        "policy_inputs" inside it) and "update"."""
        cfg = self.cfg
        window = cfg.ppo.num_global_steps
        if fused and cfg.sim.episode_steps % window:
            raise ValueError("fused training needs num_global_steps | "
                             "episode_steps")
        horizon = decisions_per_update or 8
        storage = RolloutStorage(
            horizon, self.envs.num_envs, self.pcfg.map_size,
            self.pcfg.input_channels,
            rnn_dim=self.RNN_DIM if self._rnn is not None else 0)
        obs = self.envs.observe()
        maps, orients = self._policy_obs()
        storage.insert_obs(maps, orients)
        self._last_reward = self.rewards()

        for update in range(num_updates):
            with PROFILER.range("rollout"):
                for _ in range(horizon):
                    a, raw, lp, v, pre_rnn = self._act(
                        storage.maps[storage.t],
                        storage.orientation[storage.t])
                    self._goals_from_actions(a)
                    if fused:
                        win_done = self.fused_window(window)
                    else:
                        obs, win_done = self._unfused_window(obs, window)
                    rewards = self._window_rewards()
                    # episode ends: GAE does not bootstrap across them
                    # (mask 0; the env auto-reset, so the maps are the
                    # new episode's) and the GRU state restarts
                    if self._rnn is not None:
                        self._rnn = np.where(win_done[:, None], 0.0,
                                             self._rnn).astype(np.float32)
                    maps, orients = self._policy_obs()
                    storage.insert_step(
                        raw, lp, v, rewards,
                        (~win_done).astype(np.float32), maps, orients,
                        rnn_state=pre_rnn)
            with PROFILER.range("update"):
                # bootstrap value (a value query: the GRU does not advance)
                m, o = self._tensors(storage.maps[-1],
                                     storage.orientation[-1])
                rnn = (None if self._rnn is None
                       else torch.from_numpy(self._rnn).to(self.device))
                last_v = _host(policy_forward(self.ppo_state.params, m, o,
                                              rnn).value)
                rollout = self._prepare_rollout(storage.as_rollout(last_v))
                self.ppo_state, metrics = ppo_update(self.ppo_state, rollout,
                                                     self._gen, cfg.ppo)
                self.metrics_log.append({k: float(v)
                                         for k, v in metrics.items()})
            storage.after_update()
            if self._after_update(update):
                break
        self._finalize_train()
        return self.metrics_log

    # -- hooks ---------------------------------------------------------------
    def _prepare_rollout(self, rollout):
        return rollout

    def _after_update(self, update: int) -> bool:
        """Post-update bookkeeping; return True to stop training early."""
        cfg = self.cfg
        if (cfg.runtime.checkpoint_dir
                and (update + 1) % max(1, cfg.runtime.save_periodic) == 0):
            self.save_checkpoint()
        return False

    def _finalize_train(self) -> None:
        if self.cfg.runtime.checkpoint_dir:
            self.save_checkpoint()

    # -- checkpointing: a pickled numpy tree in the JAX package's layout ---
    def save_checkpoint(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.cfg.runtime.checkpoint_dir,
                                    "policy.pkl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(to_numpy(self.ppo_state.params), fh)
        return path

    def load_checkpoint(self, path: str) -> None:
        params = from_jax(load_pickle(path), self.device)
        self.ppo_state = create_state(params, self.cfg.ppo)


@register_trainer("goalexplorationbaseline-v1")
class GoalExplorationDelayed(GoalExplorationTrainer):
    """Delayed reward: the absolute disagreement at the decision boundary
    instead of the delta."""

    REWARD_MODE = "absolute"


@register_trainer("goalexplorationbaseline-v2")
class GoalExplorationTrajectory(GoalExplorationTrainer):
    """Trajectory-cumulative reward: the sum of per-step deltas across the
    window, which with this window bookkeeping equals the window delta,
    granted undiscounted."""

    REWARD_MODE = "delta"


@register_trainer("goalexplorationbaseline-v3")
class GoalExplorationImageHistory(GoalExplorationTrainer):
    """Image history: the policy input stacks the last HISTORY=4
    (disagreement, topdown) map frames channel-wise (2 * HISTORY input
    channels)."""

    HISTORY = 4
    REWARD_MODE = "delta"

    def __init__(self, cfg: ExperimentConfig, **kw):
        base_ch = cfg.policy.input_channels
        cfg = dataclasses.replace(
            cfg, policy=dataclasses.replace(
                cfg.policy, input_channels=base_ch * self.HISTORY))
        self._frames: Optional[List[np.ndarray]] = None
        super().__init__(cfg, **kw)

    def _policy_obs(self):
        maps, orients = super()._policy_obs()
        if self._frames is None:
            self._frames = [maps] * self.HISTORY
        else:
            self._frames = self._frames[1:] + [maps]
        return np.concatenate(self._frames, axis=-1), orients
