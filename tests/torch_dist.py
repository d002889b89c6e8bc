"""Rank workers for the port's multi-rank CPU tests (the parallel layer,
myppo, the tensor-parallel captioner).

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


# ---------------------------------------------------------------------------
# the tensor-parallel captioner (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------

def _cap_cfg(d: Dict):
    from embodied_captioning_tpu_torch.config import (
        CaptionerConfig, TextDecoderConfig, VitConfig)

    return CaptionerConfig(vision=VitConfig(**d["vision"]),
                           text=TextDecoderConfig(**d["text"]),
                           max_caption_len=d["max_caption_len"])


def _tp_forward(case: Dict) -> Dict:
    """The TP forward on `case["mesh"]` beside the mesh-less forward of
    the whole leaves: both outputs, the local leaves' shapes and which of
    them are cut blocks."""
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    cfg = _cap_cfg(case["cfg"])
    mesh = M.make_mesh(tuple(case["mesh"]))
    params = _tensors(case["params"])
    imgs, toks = (torch.from_numpy(case[k]) for k in ("imgs", "toks"))
    sp = M.shard_params(params, mesh)
    with torch.no_grad():
        want = CAP.forward(params, imgs, toks, cfg)
        got = CAP.forward(sp, imgs, toks, cfg, mesh)
    return dict(shapes=[tuple(t.shape) for t in tree_leaves(sp)],
                cut=CAP.tp_cut_leaves(sp, cfg, mesh),
                host_copies=dict(M.host_copies), got=_np(list(got)),
                want=_np(list(want)))


def _tp_train(case: Dict) -> Dict:
    """One DP x TP `train_step` on `case["mesh"]`: the aux, and (first data
    rank) the updated local leaves; every rank a checksum of each."""
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    cfg = _cap_cfg(case["cfg"])
    mesh = M.make_mesh(tuple(case["mesh"]))
    sp = M.shard_params(_tensors(case["params"]), mesh)
    batch = M.shard_batch(tuple(torch.from_numpy(case[k]) for k in (
        "imgs", "toks", "obj", "valid")), mesh)
    state, aux = TT.train_step(TT.create_train_state(sp), *batch, cfg,
                               lr=case["lr"],
                               triplet_weight=case["triplet"], mesh=mesh)
    leaves = tree_leaves(state.params)
    out = dict(aux={k: float(v) for k, v in aux.items()},
               shapes=[tuple(t.shape) for t in leaves],
               cut=CAP.tp_cut_leaves(sp, cfg, mesh),
               sums=[float(t.double().sum()) for t in leaves],
               finite=all(bool(torch.isfinite(t).all()) for t in leaves),
               step=state.step, count=state.opt_state.count)
    if M.axis_rank(mesh, "data") == 0:
        out["leaves"] = _np(leaves)
    return out


def _tp_world_one(case: Dict) -> Dict:
    """`forward` and `train_step` with a (1, 1) mesh against the mesh-less
    calls: bit for bit."""
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    cfg = _cap_cfg(case["cfg"])
    mesh = M.make_mesh((1, 1))
    params = _tensors(case["params"])
    batch = tuple(torch.from_numpy(case[k]) for k in (
        "imgs", "toks", "obj", "valid"))
    with torch.no_grad():
        f1 = CAP.forward(params, *batch[:2], cfg, mesh)
        f0 = CAP.forward(params, *batch[:2], cfg)
    kw = dict(lr=case["lr"], triplet_weight=case["triplet"])
    s1, a1 = TT.train_step(TT.create_train_state(params), *batch, cfg,
                           mesh=mesh, **kw)
    s0, a0 = TT.train_step(TT.create_train_state(params), *batch, cfg, **kw)
    return dict(
        forward=all(torch.equal(a, b) for a, b in zip(f1, f0)),
        aux=all(torch.equal(a1[k], a0[k]) for k in a0) and set(a1) == set(a0),
        params=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(s1.params), tree_leaves(s0.params))),
        moments=all(torch.equal(a, b) for a, b in zip(
            tree_leaves((s1.opt_state.mu, s1.opt_state.nu)),
            tree_leaves((s0.opt_state.mu, s0.opt_state.nu)))))


def _tp_units(rank: int, case: Dict) -> Dict:
    """The vocabulary-parallel cross-entropy and its gradient against the
    full one; the global norm of a cut tree against the whole tree's; the
    differentiable batch gather; the max all-reduce; the refusal of cached
    decoding under a TP context."""
    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.models.common import (
        TP, KVCache, block)
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.train.optim import (
        clip_by_global_norm, tree_leaves)

    mesh = M.make_mesh((1, 2))
    group = M.axis_group(mesh, "model")
    cfg = CaptionerConfig.tiny()
    out = {}

    logits = torch.from_numpy(case["logits"]).requires_grad_(True)
    toks = torch.from_numpy(case["ce_toks"])
    v = logits.shape[-1] // 2
    local = logits.detach()[..., rank * v:(rank + 1) * v].clone(
        ).requires_grad_(True)
    nll, mask = CAP.caption_nll(local, toks, cfg, group)
    ce = (nll * mask).sum() / mask.sum()
    ce.backward()
    full, fmask = CAP.caption_nll(logits, toks, cfg)
    fce = (full * fmask).sum() / fmask.sum()
    fce.backward()
    out["ce"] = dict(nll=_np(nll), full=_np(full), mask=_np(mask),
                     grad=_np(local.grad),
                     full_grad=_np(logits.grad[..., rank * v:(rank + 1) * v]))

    tree = {k: torch.from_numpy(a) for k, a in case["norm_tree"].items()}
    cut = {"head": True, "ln": False, "fc": True}
    blocks = {k: (t[..., rank * (t.shape[-1] // 2):
                    (rank + 1) * (t.shape[-1] // 2)].contiguous()
                  if cut[k] else t) for k, t in tree.items()}
    got = clip_by_global_norm(blocks, 1.0, group,
                              [cut[k] for k in sorted(tree)])
    want = clip_by_global_norm(tree, 1.0)
    out["norm"] = dict(got={k: _np(t) for k, t in got.items()},
                       want={k: _np(want[k][..., rank * (t.shape[-1] // 2):
                                             (rank + 1) * (t.shape[-1] // 2)]
                                     if cut[k] else want[k])
                             for k, t in tree.items()})

    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = M.gather_batch(x, group)
    (y * torch.arange(1.0, 5.0)[:, None]).sum().backward()
    out["gather"] = dict(y=_np(y), grad=_np(x.grad))
    out["max"] = _np(M.max_replicated(torch.tensor([rank, -rank, 3.0]),
                                      group))

    tp = TP(group, 4 * cfg.text.width)
    blk = _tensors(case["block"])
    xb = torch.zeros(2, 1, cfg.text.width, dtype=torch.bfloat16)
    refusals = []
    for kw in (dict(cache=KVCache.create(2, 4, 1, cfg.text.width, "cpu")),
               dict(cross_kv=object())):
        try:
            block(blk, xb, cfg.text.heads, tp=tp, **kw)
            refusals.append(None)
        except ValueError as exc:
            refusals.append(str(exc))
    out["refusals"] = refusals
    return out


def tp(rank: int, world: int, pl: Dict, tmp: str) -> Dict:
    out = {}
    for name, case in pl.items():
        if case["kind"] == "forward":
            out[name] = _tp_forward(case)
        elif case["kind"] == "train":
            out[name] = _tp_train(case)
        elif case["kind"] == "world_one":
            out[name] = _tp_world_one(case)
        else:
            out[name] = _tp_units(rank, case)
    return out


TASKS: Dict[str, Callable] = {"parallel": parallel, "ddppo": ddppo,
                              "tp": tp}
