"""Distributed PPO trainer ("myppo"): data-parallel PPO over
torch.distributed, one process per device.

Rank r of W steps the envs [r*E/W, (r+1)*E/W) of `runtime.num_envs` = E,
each seeded by its global id, and draws its action noise as rows of the
one draw a single process would make for all E envs, so W ranks step the
same envs as one. The update keeps the single-process arithmetic of
`ppo.ppo_update`: the advantages are normalised by statistics over all
ranks' rows, rank 0's per-epoch permutations of all T*E rows are
broadcast, each rank sums the loss over its rows of each global minibatch
divided by the global minibatch size, the gradients are summed over the
ranks before clipping and Adam, and the metrics are summed likewise. At
world size 1 (no process group, or a group of one) the trainer runs
`goalexplorationbaseline-v0`'s update as it is, with no collective.

Preemption: SIGTERM / SIGUSR1 set the guard's flag; the ranks agree on it
at each update boundary (max over the ranks), rank 0 writes the resume
state (params and optimizer state) under `runtime.checkpoint_dir/ddppo`
while the others wait at a barrier, `ECAP_REQUEUE_CMD` runs on rank 0, and
a fresh trainer resumes at the saved update index.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import ExperimentConfig, PPOConfig
from ..ops.geometry import reciprocal32
from ..parallel.mesh import axis_group, make_mesh
from ..train.optim import tree_leaves, tree_unflatten, value_and_grad
from ..utils.checkpoint import CheckpointManager, PreemptionGuard
from .goal_exploration import GoalExplorationTrainer
from .policy import evaluate_actions, gaussian_entropy
from .ppo import Batch, PPOState, adam_step, prepare_batch
from .registry import register_trainer
from .storage import Rollout

METRICS = ("loss", "action_loss", "value_loss", "entropy")


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _global_normalise(group, n_total: int):
    """`ppo.normalise` over every rank's advantages: mean and population
    std from sums over the group. Each sum is divided as the jitted
    `jnp.mean` divides, by a product with the float32 reciprocal."""
    inv_n = reciprocal32(n_total)

    def normalise(adv: torch.Tensor) -> torch.Tensor:
        mean = _all_sum(adv.sum(), group) * inv_n
        var = _all_sum(torch.square(adv - mean).sum(), group) * inv_n
        return (adv - mean) / (torch.sqrt(var) + 1e-5)

    return normalise


def _partial_loss(params: dict, batch: Batch, rows: torch.Tensor, mb: int,
                  world: int, cfg: PPOConfig):
    """This rank's share of `ppo.ppo_loss` on a global minibatch of `mb`
    rows, of which `rows` are this rank's: the per-row terms summed over
    them and divided by mb, the entropy (a function of log_std alone)
    divided by the world size. The ranks' shares sum to the loss."""
    ent = gaussian_entropy(params["log_std"]) * reciprocal32(world)
    if rows.numel() == 0:
        zero = params["log_std"].sum() * 0.0
        return zero - cfg.entropy_coef * ent, (zero, zero, ent)
    lp, _, v = evaluate_actions(
        params, batch.maps[rows], batch.orientation[rows],
        batch.actions[rows],
        rnn_state=None if batch.rnn_states is None
        else batch.rnn_states[rows])
    adv = batch.advantages[rows]
    old_v = batch.old_values[rows]
    ret = batch.returns[rows]
    ratio = torch.exp(lp - batch.old_log_probs[rows])
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv
    action_loss = -torch.sum(torch.minimum(s1, s2)) * reciprocal32(mb)
    v_clip = old_v + torch.clamp(v - old_v, -cfg.clip_param, cfg.clip_param)
    value_loss = 0.5 * torch.sum(torch.maximum(
        torch.square(v - ret), torch.square(v_clip - ret))) * reciprocal32(mb)
    total = (action_loss + cfg.value_loss_coef * value_loss
             - cfg.entropy_coef * ent)
    return total, (action_loss, value_loss, ent)


def ddppo_update_with(state: PPOState, rollout: Rollout,
                      perms: Sequence[torch.Tensor], cfg: PPOConfig, group,
                      first_env: int, num_envs: int):
    """`ppo.ppo_update_with` over the ranks of `group`: `rollout` holds
    this rank's envs [first_env, first_env + E_local) of `num_envs`, and
    `perms` (the same on every rank) permute the global rows t*num_envs +
    env. Returns (new state, metrics), both the same on every rank."""
    world = dist.get_world_size(group)
    t_len, e_local = rollout.rewards.shape
    n = t_len * num_envs
    batch = prepare_batch(rollout, cfg, state.params["log_std"].device,
                          _global_normalise(group, n))
    mb = n // cfg.num_mini_batch
    rows_out = []
    for perm in perms:
        perm = perm.to(batch.returns.device)
        for m in range(cfg.num_mini_batch):
            idx = perm[m * mb:(m + 1) * mb]
            env = idx % num_envs - first_env
            mine = (env >= 0) & (env < e_local)
            rows = ((idx // num_envs) * e_local + env)[mine]
            loss, aux, grads = value_and_grad(
                lambda p: _partial_loss(p, batch, rows, mb, world, cfg),
                state.params)
            leaves = tree_leaves(grads)
            flat = _all_sum(torch.cat([g.reshape(-1) for g in leaves]),
                            group)
            summed, at = [], 0
            for g in leaves:
                summed.append(flat[at:at + g.numel()].reshape(g.shape))
                at += g.numel()
            state = adam_step(state, tree_unflatten(grads, summed), cfg)
            rows_out.append(_all_sum(torch.stack([loss, *aux]), group))
    means = torch.stack(rows_out).mean(dim=0)
    return state, dict(zip(METRICS, means.unbind()))


@register_trainer("myppo")
class DistributedPPOTrainer(GoalExplorationTrainer):
    """Goal-exploration PPO with the envs and the update split over the
    ranks of the default process group (world size 1 without one)."""

    def __init__(self, cfg: ExperimentConfig, **kw):
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        e = cfg.runtime.num_envs
        if e % self.world:
            raise ValueError(f"myppo splits the envs over the ranks: "
                             f"runtime.num_envs={e} is not divisible by "
                             f"the world size {self.world}")
        self.num_envs_total = e
        self.first_env = self.rank * (e // self.world)
        self.mesh = (make_mesh((self.world,), ("data",))
                     if dist.is_initialized() else None)
        self.group = axis_group(self.mesh, "data")
        if self.group is not None:
            self._sample_rows = (self.first_env, e)
        super().__init__(cfg, **kw)
        self.guard = PreemptionGuard(on_exit=self._requeue)
        self.guard.install()
        self.ckpt_mgr: Optional[CheckpointManager] = None
        self._update_idx = 0
        if cfg.runtime.checkpoint_dir:
            self.ckpt_mgr = CheckpointManager(
                os.path.join(cfg.runtime.checkpoint_dir, "ddppo"))
            self._maybe_resume()

    def _env_ids(self) -> List[int]:
        return list(range(self.first_env,
                          self.first_env + self.num_envs_total // self.world))

    # -- elastic resume ----------------------------------------------------
    def _maybe_resume(self) -> None:
        if self.ckpt_mgr.latest_step() is not None:
            restored = self.ckpt_mgr.restore(self.ppo_state)
            if restored is not None:
                self.ppo_state = restored
                self._update_idx = int(self.ckpt_mgr.latest_step())

    def _save_resume_state(self) -> None:
        if self.ckpt_mgr is None:
            return
        if self.rank == 0:
            self.ckpt_mgr.save(self._update_idx, self.ppo_state)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _requeue(self) -> None:
        """Preemption hook: save the resume state; rank 0 runs
        ECAP_REQUEUE_CMD, where a cluster scheduler's requeue goes."""
        self._save_resume_state()
        cmd = os.environ.get("ECAP_REQUEUE_CMD")
        if cmd and self.rank == 0:
            os.system(cmd)

    # -- the update ----------------------------------------------------------
    def _ppo_update(self, rollout: Rollout):
        if self.group is None:
            return super()._ppo_update(rollout)
        n = rollout.rewards.shape[0] * self.num_envs_total
        perms = [torch.randperm(n, generator=self._gen,
                                device=self._gen.device)
                 for _ in range(self.cfg.ppo.ppo_epoch)]
        src = dist.get_global_rank(self.group, 0)
        for p in perms:
            dist.broadcast(p, src=src, group=self.group)
        return ddppo_update_with(self.ppo_state, rollout, perms,
                                 self.cfg.ppo, self.group, self.first_env,
                                 self.num_envs_total)

    def _agree_exit(self) -> bool:
        """Whether any rank was signalled (every rank then is): one rank
        leaving alone would leave the others waiting in a collective."""
        if self.group is not None:
            flag = torch.tensor([float(self.guard.should_exit)],
                                device=self._gen.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            self.guard.should_exit = bool(flag.item())
        return self.guard.should_exit

    def _after_update(self, update: int) -> bool:
        self._update_idx += 1
        stop = self._agree_exit()
        if self.ckpt_mgr and self._update_idx % max(
                1, self.cfg.runtime.save_periodic) == 0:
            self._save_resume_state()
        return stop

    def _finalize_train(self) -> None:
        self._agree_exit()
        self.guard.finalize()
        self._save_resume_state()
