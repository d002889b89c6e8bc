"""PPO: clipped surrogate, clipped value loss, entropy bonus, gradients
clipped by their global norm, Adam; `ppo_epoch` epochs of
`num_mini_batch` minibatches.

The optimizer is the JAX package's `optax.chain(clip_by_global_norm(
max_grad_norm), adam(lr, eps=eps))`, written out on the parameter tree in
`train/optim.py`. `ppo_update` draws one permutation per epoch from a
`torch.Generator` and hands them to `ppo_update_with`, which is
deterministic given (state, rollout, permutations).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import PPOConfig
from ..train.optim import (  # tree_leaves: callers take it from here too
    AdamState, adam_init, adam_update, tree_leaves, value_and_grad,
)
from .policy import evaluate_actions
from .storage import Rollout, compute_gae


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

class PPOState(NamedTuple):
    params: dict
    opt_state: AdamState


def create_state(params: dict, cfg: PPOConfig) -> PPOState:
    return PPOState(params, adam_init(params))


def adam_step(state: PPOState, grads, cfg: PPOConfig) -> PPOState:
    """One step of the clip-then-Adam chain: new params and moments."""
    return PPOState(*adam_update(state.params, state.opt_state, grads,
                                 cfg.lr, cfg.max_grad_norm, cfg.eps))


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

class Batch(NamedTuple):
    """A rollout flattened over (time, env), on the policy's device."""

    maps: torch.Tensor        # [N, H, W, C]
    orientation: torch.Tensor  # [N]
    actions: torch.Tensor     # [N, A]
    old_log_probs: torch.Tensor  # [N]
    old_values: torch.Tensor  # [N]
    returns: torch.Tensor     # [N]
    advantages: torch.Tensor  # [N], normalised
    rnn_states: Optional[torch.Tensor]  # [N, D]


def prepare_batch(rollout: Rollout, cfg: PPOConfig, device) -> Batch:
    """GAE, advantage normalisation (population std) and flattening."""
    t_len, e = rollout.rewards.shape
    n = t_len * e

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    returns, advantages = compute_gae(
        dev(rollout.rewards), dev(rollout.values), dev(rollout.masks),
        cfg.gamma, cfg.tau)
    adv = ((advantages - advantages.mean())
           / (advantages.std(correction=0) + 1e-5))

    def flat(x):
        x = dev(x[:t_len])
        return x.reshape(n, *x.shape[2:])

    return Batch(
        maps=flat(rollout.maps), orientation=flat(rollout.orientation),
        actions=flat(rollout.raw_actions),
        old_log_probs=flat(rollout.log_probs),
        old_values=flat(rollout.values), returns=returns.reshape(n),
        advantages=adv.reshape(n),
        rnn_states=(None if rollout.rnn_states is None
                    else flat(rollout.rnn_states)))


def ppo_loss(params: dict, batch: Batch, idx: torch.Tensor, cfg: PPOConfig,
             categorical: bool = False):
    """(total, (action_loss, value_loss, entropy)) on the rows `idx`."""
    lp, ent, v = evaluate_actions(
        params, batch.maps[idx], batch.orientation[idx], batch.actions[idx],
        categorical,
        rnn_state=None if batch.rnn_states is None else batch.rnn_states[idx])
    adv = batch.advantages[idx]
    old_v = batch.old_values[idx]
    ret = batch.returns[idx]
    ratio = torch.exp(lp - batch.old_log_probs[idx])
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv
    action_loss = -torch.mean(torch.minimum(s1, s2))
    v_clip = old_v + torch.clamp(v - old_v, -cfg.clip_param, cfg.clip_param)
    vl = torch.square(v - ret)
    vl_clip = torch.square(v_clip - ret)
    value_loss = 0.5 * torch.mean(torch.maximum(vl, vl_clip))
    total = (action_loss + cfg.value_loss_coef * value_loss
             - cfg.entropy_coef * ent)
    return total, (action_loss, value_loss, ent)


def ppo_grads(params: dict, batch: Batch, idx: torch.Tensor, cfg: PPOConfig,
              categorical: bool = False):
    """(gradients as a tree like `params`, loss, aux) of one minibatch;
    a leaf the loss does not reach gets zeros."""
    total, aux, grads = value_and_grad(
        lambda p: ppo_loss(p, batch, idx, cfg, categorical), params)
    return grads, total, aux


def ppo_update_with(state: PPOState, rollout: Rollout,
                    perms: Sequence[torch.Tensor], cfg: PPOConfig,
                    categorical: bool = False):
    """One PPO update with the given per-epoch permutations of the N =
    T * E rows: minibatch m of an epoch takes rows perm[m*mb:(m+1)*mb],
    mb = N // num_mini_batch (the remainder rows sit out). Returns (new
    state, metrics averaged over epochs and minibatches)."""
    batch = prepare_batch(rollout, cfg, state.params["log_std"].device)
    n = batch.returns.shape[0]
    mb = n // cfg.num_mini_batch
    rows = []
    for perm in perms:
        perm = perm.to(batch.returns.device)
        for m in range(cfg.num_mini_batch):
            idx = perm[m * mb:(m + 1) * mb]
            grads, loss, aux = ppo_grads(state.params, batch, idx, cfg,
                                         categorical)
            state = adam_step(state, grads, cfg)
            rows.append(torch.stack([loss, *aux]))
    means = torch.stack(rows).mean(dim=0)
    return state, dict(zip(("loss", "action_loss", "value_loss", "entropy"),
                           means.unbind()))


def ppo_update(state: PPOState, rollout: Rollout,
               generator: torch.Generator, cfg: PPOConfig,
               categorical: bool = False):
    """One full PPO update (ppo_epoch x num_mini_batch) over a rollout,
    minibatch order drawn from `generator`."""
    perms = [torch.randperm(rollout.rewards.size, generator=generator,
                            device=generator.device)
             for _ in range(cfg.ppo_epoch)]
    return ppo_update_with(state, rollout, perms, cfg, categorical)
