"""RL advantage self-check: PPO-train the goal-exploration policy, then
evaluate it against `randomgoalsbaseline` and `frontierbaseline-v1` on
fixed eval scenes with the same trained perception stack and step budget
(disagreement reward and area coverage per arm, over training seeds), on
the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/selfcheck_rl.py`, with its
arguments (and `--device`), its configuration and its JSON line. The arms
share the perception weights (`selfcheck_loop.train_stack`), the eval
scenes (scene seed 4000, control seeds 900 + seed, the
`SemanticDisagreement-v0` env) and the episode length; they differ only
in the goal policy. A PPO arm trains per seed (scene seed 3000 + 100 *
seed) and per `--entropy` coefficient, its per-window training rewards
traced through `_window_rewards`; `--fused` trains in scan-fused windows.
Policies draw from `torch.Generator`s (jax.random never gives the same
numbers), so the arms' figures are statistics, not the JAX script's.

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_rl [--preset base] \\
      [--seeds 0,1] [--det-steps 400] [--cap-steps 300] \\
      [--ppo-updates 10] [--decisions-per-update 8] [--eval-steps 120] \\
      [--eval-scenes 2] [--fused] [--entropy 0.01,0.05] \\
      [--device cpu] [key.path=value ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def evaluate(cfg, trainer_name: str, seed: int, eval_steps: int, make,
             ppo_state=None) -> dict:
    """`eval_steps` of the arm's policy on the fixed eval scenes (scene
    seed 4000, the disagreement env, control seed 900 + seed) with the
    perceiver `make(cfg)`: the cumulative disagreement reward, the mean
    area ratio and the mapped objects."""
    from .agents import get_trainer

    ecfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, scene_seed=4000),
        runtime=dataclasses.replace(
            cfg.runtime, env_name="SemanticDisagreement-v0",
            seed=900 + seed, obs_dir=None))
    p = make(ecfg)
    tr = get_trainer(trainer_name)(ecfg, perceiver=p, device=p.device)
    if ppo_state is not None:
        tr.ppo_state = ppo_state
    tr.generate(eval_steps)
    rewards = tr.rewards()
    areas = [env.area_ratio() for env in tr.envs.envs]
    objs = [int(env.map_state.num_objects) for env in tr.envs.envs]
    tr.envs.close()
    return {"disagreement_reward": round(float(np.sum(rewards)), 5),
            "area_ratio_mean": round(float(np.mean(areas)), 4),
            "mapped_objects": int(np.sum(objs))}


def train_ppo_arm(cfg, seed: int, entropy: float, make, ppo_updates: int,
                  decisions_per_update: int, fused: bool):
    """One PPO arm's training (scene seed 3000 + 100 * seed, the entropy
    coefficient, control seed `seed`): (trainer, the mean reward of every
    training window as `_window_rewards` returned it)."""
    from .agents import get_trainer

    tcfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, scene_seed=3000 + 100 * seed),
        ppo=dataclasses.replace(cfg.ppo, entropy_coef=entropy),
        runtime=dataclasses.replace(cfg.runtime, seed=seed, obs_dir=None))
    p = make(tcfg)
    tr = get_trainer("goalexplorationbaseline-v0")(tcfg, perceiver=p,
                                                   device=p.device)
    trace = []
    window_rewards = tr._window_rewards

    def traced():
        r = window_rewards()
        trace.append(float(np.mean(r)))
        return r

    tr._window_rewards = traced
    tr.train(num_updates=ppo_updates,
             decisions_per_update=decisions_per_update, fused=fused)
    return tr, trace


def summarize(arms: dict) -> dict:
    """The JAX script's summary: per arm the mean and spread of the reward
    and the area, the best PPO arm by mean reward, and whether it beats
    the random-goals and frontier arms."""
    def agg(rows, k):
        vals = [r[k] for r in rows]
        return round(float(np.mean(vals)), 5), round(float(np.std(vals)), 5)

    summary = {}
    for arm, rows in arms.items():
        m_r, s_r = agg(rows, "disagreement_reward")
        m_a, s_a = agg(rows, "area_ratio_mean")
        summary[arm] = {"reward_mean": m_r, "reward_std": s_r,
                        "area_mean": m_a, "area_std": s_a}
    best = max((k for k in summary if k.startswith("ppo")),
               key=lambda k: summary[k]["reward_mean"])
    ppo_r = summary[best]["reward_mean"]
    return {"summary": summary, "best_ppo_arm": best,
            "ppo_beats_random": bool(
                ppo_r > summary["random_goals"]["reward_mean"]),
            "ppo_beats_frontier": bool(
                ppo_r > summary["frontier_v1"]["reward_mean"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="base", choices=["tiny", "base"])
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--det-steps", type=int, default=400)
    ap.add_argument("--cap-steps", type=int, default=300)
    ap.add_argument("--ppo-updates", type=int, default=10)
    ap.add_argument("--decisions-per-update", type=int, default=8)
    ap.add_argument("--eval-steps", type=int, default=120)
    ap.add_argument("--eval-scenes", type=int, default=2,
                    help="eval envs (one fixed scene seed each)")
    ap.add_argument("--fused", action="store_true",
                    help="scan-fused training windows (one fused rollout "
                         "per num_global_steps window)")
    ap.add_argument("--entropy", default="",
                    help="comma list of entropy coefficients: one PPO arm "
                         "per value per seed ('' = the config's only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("selfcheck_rl: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .selfcheck_loop import train_stack, trained_perceiver

    common = [
        "sim.num_objects=8", "sim.scene_size=8.0", "map.voxel_size=0.1",
        f"runtime.num_envs={args.eval_scenes}",
        "ppo.num_global_steps=10", "ppo.replanning_steps=10",
        "detector.score_threshold=0.2",
        f"sim.episode_steps={max(args.eval_steps, 300)}",
    ]
    cfg = load_config(args.preset, overrides=common + list(args.overrides))
    dev = torch.device(args.device)

    t0 = time.time()
    det_params, state, _, _ = train_stack(cfg, args.det_steps,
                                          args.cap_steps, dev)
    print(f"[rl] perception stack trained ({time.time() - t0:.0f}s)",
          flush=True)

    def make(c):
        return trained_perceiver(c, det_params, state.params, dev)

    results = {"eval_steps": args.eval_steps, "preset": args.preset,
               "arms": {}}
    seeds = [int(s) for s in args.seeds.split(",")]
    entropies = ([float(x) for x in args.entropy.split(",") if x]
                 or [cfg.ppo.entropy_coef])
    for ent in entropies:
        rows = []
        arm = ("ppo" if len(entropies) == 1 and ent == cfg.ppo.entropy_coef
               else f"ppo_ent{ent:g}")
        for seed in seeds:
            t0 = time.time()
            tr, trace = train_ppo_arm(cfg, seed, ent, make, args.ppo_updates,
                                      args.decisions_per_update, args.fused)
            tr.envs.close()
            row = evaluate(cfg, "goalexplorationbaseline-v0", seed,
                           args.eval_steps, make, ppo_state=tr.ppo_state)
            row["train_seconds"] = round(time.time() - t0, 1)
            row["env_steps"] = (args.ppo_updates * args.decisions_per_update
                                * cfg.ppo.num_global_steps
                                * cfg.runtime.num_envs)
            q = max(1, len(trace) // 4)
            row["train_reward_first_quarter"] = round(
                float(np.mean(trace[:q])), 5)
            row["train_reward_last_quarter"] = round(
                float(np.mean(trace[-q:])), 5)
            rows.append(row)
            print(f"[rl] {arm} seed {seed}: {json.dumps(row)}", flush=True)
        results["arms"][arm] = rows

    for name, key in (("randomgoalsbaseline", "random_goals"),
                      ("frontierbaseline-v1", "frontier_v1")):
        rows = []
        for seed in seeds:
            rows.append(evaluate(cfg, name, seed, args.eval_steps, make))
            print(f"[rl] {key} seed {seed}: {json.dumps(rows[-1])}",
                  flush=True)
        results["arms"][key] = rows

    results.update(summarize(results["arms"]))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
