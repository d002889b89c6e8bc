"""Rollout storage and GAE.

`RolloutStorage` keeps fixed-horizon host (numpy) buffers of policy
maps, orientations, pre-squash actions, log-probs, values, rewards, masks
and, for recurrent policies, the GRU states at decision time, as the JAX
package does; `as_rollout` hands them to the PPO update, which moves them
to the policy's device. `compute_gae` is the reverse float32 recursion
of the JAX package's `lax.scan`. `FIFOMemory` is a bounded deque.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Rollout(NamedTuple):
    maps: np.ndarray        # [T+1, E, H, W, C]
    orientation: np.ndarray  # [T+1, E]
    raw_actions: np.ndarray  # [T, E, A] pre-squash samples
    log_probs: np.ndarray   # [T, E]
    values: np.ndarray      # [T+1, E]
    rewards: np.ndarray     # [T, E]
    masks: np.ndarray       # [T+1, E] 1 = not done
    # GRU states at decision time (recurrent policies only): PPO evaluates
    # the log-probs again against these
    rnn_states: "np.ndarray | None" = None  # [T, E, D]


class RolloutStorage:
    def __init__(self, num_steps: int, num_envs: int, map_size: int,
                 channels: int, action_dim: int = 2,
                 rnn_dim: int = 0):
        self.t = 0
        self.num_steps = num_steps
        self.maps = np.zeros((num_steps + 1, num_envs, map_size, map_size,
                              channels), np.float32)
        self.orientation = np.zeros((num_steps + 1, num_envs), np.int32)
        self.raw_actions = np.zeros((num_steps, num_envs, action_dim),
                                    np.float32)
        self.log_probs = np.zeros((num_steps, num_envs), np.float32)
        self.values = np.zeros((num_steps + 1, num_envs), np.float32)
        self.rewards = np.zeros((num_steps, num_envs), np.float32)
        self.masks = np.ones((num_steps + 1, num_envs), np.float32)
        self.rnn_states = (np.zeros((num_steps, num_envs, rnn_dim),
                                    np.float32) if rnn_dim else None)

    def insert_obs(self, maps, orientation) -> None:
        self.maps[self.t] = np.asarray(maps)
        self.orientation[self.t] = np.asarray(orientation)

    def insert_step(self, raw_actions, log_probs, values, rewards, masks,
                    next_maps, next_orientation, rnn_state=None) -> None:
        t = self.t
        self.raw_actions[t] = np.asarray(raw_actions)
        self.log_probs[t] = np.asarray(log_probs)
        self.values[t] = np.asarray(values)
        self.rewards[t] = np.asarray(rewards)
        self.masks[t + 1] = np.asarray(masks)
        self.maps[t + 1] = np.asarray(next_maps)
        self.orientation[t + 1] = np.asarray(next_orientation)
        if rnn_state is not None and self.rnn_states is not None:
            self.rnn_states[t] = np.asarray(rnn_state)
        self.t += 1

    def after_update(self) -> None:
        self.maps[0] = self.maps[-1]
        self.orientation[0] = self.orientation[-1]
        self.masks[0] = self.masks[-1]
        self.t = 0

    def as_rollout(self, last_value: np.ndarray) -> Rollout:
        values = self.values.copy()
        values[self.num_steps] = np.asarray(last_value)
        return Rollout(self.maps, self.orientation, self.raw_actions,
                       self.log_probs, values, self.rewards, self.masks,
                       self.rnn_states)


def compute_gae(rewards: torch.Tensor, values: torch.Tensor,
                masks: torch.Tensor, gamma: float, tau: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE returns and advantages: rewards [T, E], values [T+1, E], masks
    [T+1, E] float32 -> (returns, advantages), each [T, E]. A reverse
    loop over t with the JAX scan body's operations in its order; XLA
    contracts the recursion `delta + (gamma * tau * mask) * gae` into a
    fused multiply-add, so it is one here too: the float32 product is
    exact in float64, and the sum is rounded to float64, then to float32
    (the same bits as one rounding but where the float64 sum lies on a
    float32 halfway point, a chance near 2**-29)."""
    t_len = rewards.shape[0]
    gae = torch.zeros_like(rewards[0])
    adv = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        delta = (rewards[t] + gamma * values[t + 1] * masks[t + 1]
                 - values[t])
        decay = gamma * tau * masks[t + 1]
        gae = (delta.double() + decay.double() * gae.double()).float()
        adv[t] = gae
    advantages = torch.stack(adv)
    returns = advantages + values[:-1]
    return returns, advantages


class FIFOMemory:
    """Bounded FIFO of (obs, label) pairs."""

    def __init__(self, capacity: int):
        self.buffer: deque = deque(maxlen=capacity)

    def push(self, item) -> None:
        self.buffer.append(item)

    def sample(self, rng: np.random.Generator, n: int):
        idx = rng.choice(len(self.buffer), size=min(n, len(self.buffer)),
                         replace=False)
        return [self.buffer[i] for i in idx]

    def __len__(self) -> int:
        return len(self.buffer)
