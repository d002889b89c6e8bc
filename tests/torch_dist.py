"""Rank workers for the port's multi-rank CPU tests.

`run(task, world, tmp, payload)` spawns `world` processes joined in a gloo
process group over a file:// store under `tmp`, runs TASKS[task](rank,
world, payload) on each and returns their results in rank order (numpy
trees, pickled through `tmp`). This module imports no JAX: the JAX
package's references are computed in the test process and handed over in
`payload` as numpy arrays.
"""

from __future__ import annotations

import datetime
import pickle
import signal
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails the test instead of
# hanging the run
TIMEOUT = datetime.timedelta(seconds=120)


def run(task: str, world: int, tmp, payload: Any = None) -> List[Any]:
    tmp = Path(tmp) / task
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "payload.pkl", "wb") as fh:
        pickle.dump(payload, fh)
    mp.spawn(_entry, args=(world, task, str(tmp)), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _entry(rank: int, world: int, task: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        with open(f"{tmp}/payload.pkl", "rb") as fh:
            payload = pickle.load(fh)
        out = TASKS[task](rank, world, payload, tmp)
        with open(f"{tmp}/rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np(v) for v in t]
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().numpy()
    return t


def _tensors(tree):
    from embodied_captioning_tpu_torch.params import from_jax

    return from_jax(tree, "cpu")


# ---------------------------------------------------------------------------
# the parallel layer (tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------

def tanh_block(p, h):
    """A float32 block both packages compute the same way."""
    return h + torch.tanh(h @ p["w1"]) @ p["w2"]


def _pipeline(pl, mesh, block_fn, layers_key: str, micro: int):
    from embodied_captioning_tpu_torch.parallel import pipeline as PP
    from embodied_captioning_tpu_torch.parallel.mesh import axis_size
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    s = axis_size(mesh, "pipe")
    stacked = PP.shard_stacked(PP.stack_stages(
        _tensors(pl[layers_key]), s), mesh)
    leaves = tree_leaves(stacked)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(pl["x"]).requires_grad_(True)
    out = PP.pipeline_apply(stacked, x, block_fn, mesh, microbatches=micro)
    torch.sum(torch.square(out)).backward()
    return dict(out=_np(out), grads=[_np(t.grad) for t in leaves],
                x_grad=_np(x.grad))


def parallel(rank: int, world: int, pl: Dict, tmp: str) -> Dict:
    from embodied_captioning_tpu_torch.config import load_config, merge
    from embodied_captioning_tpu_torch.models.common import block
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.parallel import moe as MOE
    from embodied_captioning_tpu_torch.parallel import sequence as SQ
    from embodied_captioning_tpu_torch.params import PerceptionParams
    from embodied_captioning_tpu_torch.perception import perceive_sharded

    out = {}
    dm = M.make_mesh()                       # (2, 1): data x model
    out["mesh"] = (tuple(dm.shape), tuple(dm.mesh_dim_names))
    tp = M.make_mesh((1, 2))                 # model 2
    out["shard_params"] = _np(M.shard_params(_tensors(pl["cap"]), tp))
    out["shard_params_dp"] = _np(M.shard_params(_tensors(pl["cap"]), dm))
    out["shard_batch"] = _np(M.shard_batch(
        {"x": torch.from_numpy(pl["batch"])}, dm))
    out["allgather"] = M.process_allgather(np.array([rank, 10 * rank]))

    heads = pl["heads"]
    pm = M.make_mesh((2,), ("pipe",))
    one = M.make_mesh((2, 1), ("data", "pipe"))  # a pipe axis of 1
    out["pipe_tanh"] = _pipeline(pl, pm, tanh_block, "tanh_layers", 8)
    out["pipe_block"] = _pipeline(
        pl, pm, lambda p, h: block(p, h, heads,
                                   compute_dtype=torch.float32)[0],
        "layers", 8)
    out["pipe_block_1"] = _pipeline(
        pl, one, lambda p, h: block(p, h, heads,
                                    compute_dtype=torch.float32)[0],
        "layers", 2)

    sm = M.make_mesh((2,), ("seq",))
    q, k, v = (torch.from_numpy(pl[n]) for n in "qkv")
    valid = torch.from_numpy(pl["valid"])
    tl = q.shape[2] // world
    blk = slice(rank * tl, (rank + 1) * tl)
    out["ring"] = _np(SQ.ring_attention(q[:, :, blk], k[:, :, blk],
                                        v[:, :, blk], sm,
                                        key_valid=valid[:, blk]))
    out["ring_all_valid"] = _np(SQ.ring_attention(
        q[:, :, blk], k[:, :, blk], v[:, :, blk], sm))
    vcfg = pl["vit_cfg"]
    out["vit_sp"] = _np(SQ.vit_features_seqparallel(
        _tensors(pl["vit"]), torch.from_numpy(pl["vit_tokens"]), vcfg, sm))

    em = M.make_mesh((2,), ("expert",))
    group = M.axis_group(em, "expert")
    mp_ = _tensors(pl["moe"])
    x = torch.from_numpy(pl["moe_x"])
    out["moe_local"] = _np(MOE.shard_experts(mp_, group))
    out["moe_ep"] = _np(MOE.moe_mlp(MOE.shard_experts(mp_, group), x,
                                    group=group,
                                    compute_dtype=torch.float32))
    out["moe_single"] = _np(MOE.moe_mlp(mp_, x, compute_dtype=torch.float32))

    cfg = merge(load_config("tiny"), pl["perceive_over"])
    params = PerceptionParams(**{k: _tensors(v)
                                 for k, v in pl["perception"].items()})
    res = perceive_sharded(params,
                           torch.from_numpy(pl["frames"]), cfg, dm)
    d = res.detections
    out["perceive"] = dict(
        valid=_np(d.valid), boxes=_np(d.boxes), classes=_np(d.classes),
        embeddings=_np(d.embeddings), tokens=_np(res.caption_tokens),
        lengths=_np(res.caption_lengths))
    return out


# ---------------------------------------------------------------------------
# the distributed PPO trainer (tests/test_torch_ddppo.py)
# ---------------------------------------------------------------------------

def ddppo(rank: int, world: int, pl: Dict, tmp: str) -> Dict:
    from embodied_captioning_tpu_torch.agents import ddppo as D
    from embodied_captioning_tpu_torch.agents import get_trainer
    from embodied_captioning_tpu_torch.agents.ppo import create_state
    from embodied_captioning_tpu_torch.agents.storage import Rollout
    from embodied_captioning_tpu_torch.config import PPOConfig, load_config
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    out = {}
    # the update on a handed rollout and permutations
    ro = Rollout(*pl["rollout"])
    e = ro.rewards.shape[1]
    per = e // world
    cols = slice(rank * per, (rank + 1) * per)
    local = Rollout(*(None if a is None else a[:, cols] for a in ro))
    cfg = PPOConfig(**pl["ppo"])
    state, metrics = D.ddppo_update_with(
        create_state(_tensors(pl["policy"]), cfg), local,
        [torch.from_numpy(p) for p in pl["perms"]], cfg, dist.group.WORLD,
        rank * per, e)
    out["update"] = dict(params=[_np(t) for t in tree_leaves(state.params)],
                         metrics={k: float(v) for k, v in metrics.items()},
                         count=state.opt_state.count)

    # the trainer: rollouts as one process steps them
    tcfg = load_config("tiny", overrides=pl["overrides"] + [
        f"runtime.checkpoint_dir={tmp}/ckpt"])
    tr = get_trainer("myppo")(tcfg, with_perception=False, device="cpu")
    seen = []
    update = tr._ppo_update

    def record(rollout):
        seen.append(_np(rollout._asdict()))
        return update(rollout)

    tr._ppo_update = record
    metrics = tr.train(num_updates=pl["updates"], decisions_per_update=2)
    out["trainer"] = dict(
        env_ids=[env.env_id for env in tr.envs.envs], rollouts=seen,
        metrics=metrics, params=[_np(t) for t in tree_leaves(
            tr.ppo_state.params)],
        saved=tr.ckpt_mgr.all_steps(), update_idx=tr._update_idx)
    tr.envs.close()
    tr2 = get_trainer("myppo")(tcfg, with_perception=False, device="cpu")
    out["resumed_idx"] = tr2._update_idx
    if rank == 1:  # one rank signalled: every rank stops at the boundary
        signal.raise_signal(signal.SIGTERM)
    more = tr2.train(num_updates=5, decisions_per_update=2)
    out["preempted"] = dict(updates=len(more), idx=tr2._update_idx,
                            saved=tr2.ckpt_mgr.latest_step(),
                            should_exit=tr2.guard.should_exit)
    tr2.envs.close()

    bad = load_config("tiny", overrides=pl["overrides"] + [
        "runtime.num_envs=3"])
    try:
        get_trainer("myppo")(bad, with_perception=False, device="cpu")
        out["refusal"] = None
    except ValueError as exc:
        out["refusal"] = str(exc)
    return out


TASKS: Dict[str, Callable] = {"parallel": parallel, "ddppo": ddppo}
