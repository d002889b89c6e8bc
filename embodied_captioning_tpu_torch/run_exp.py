"""Run an exploration experiment: a registered trainer's `generate` or
`train` on the GPU (or on the CPU with --device cpu).

Usage:
  python -m embodied_captioning_tpu_torch.run_exp --trainer randombaseline \
      --mode generate --preset tiny --steps 20 --obs-dir DIR \
      [--device cpu] [key.path=value ...]
  python -m embodied_captioning_tpu_torch.run_exp \
      --trainer goalexplorationbaseline-v0 --mode train --preset tiny \
      --steps 1 ppo.num_global_steps=2 [--device cpu] [key.path=value ...]

Prints one JSON line. generate: saved files, frames, seconds, frames/s
and each env's reward; train: the number of PPO updates (`--steps`, 2 by
default), the metrics of the last three and the seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", default="goalexplorationbaseline-v0")
    ap.add_argument("--mode", choices=["train", "generate"],
                    default="generate")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--config", default=None, help="YAML overlay path")
    ap.add_argument("--steps", type=int, default=None,
                    help="env steps for generate / updates for train")
    ap.add_argument("--obs-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = ap.parse_args(argv)

    if args.trainer == "myppo":
        print("run_exp: the distributed PPO trainer 'myppo' needs the "
              "parallel layer, which is not ported yet (ROADMAP A.15)",
              file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("run_exp: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2

    from .agents import get_trainer  # (importing fills the registry)
    from .config import load_config

    overrides = list(args.overrides)
    if args.obs_dir:
        overrides.append(f"runtime.obs_dir={args.obs_dir}")
    cfg = load_config(args.preset, yaml_path=args.config, overrides=overrides)

    t0 = time.time()
    trainer = get_trainer(args.trainer)(cfg, device=args.device)
    print(f"[run_exp] trainer={args.trainer} mode={args.mode} "
          f"preset={args.preset} device={args.device} "
          f"init={time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    if args.mode == "generate":
        paths = trainer.generate(args.steps)
        dt = time.time() - t0
        n_frames = (args.steps or cfg.sim.episode_steps) * \
            cfg.runtime.num_envs
        print(json.dumps({
            "mode": "generate", "saved_files": len(paths),
            "frames": n_frames, "seconds": round(dt, 2),
            "fps": round(n_frames / max(dt, 1e-6), 2),
            "rewards": [float(r) for r in trainer.rewards()],
        }))
    else:
        metrics = trainer.train(args.steps or 2)
        print(json.dumps({"mode": "train", "updates": len(metrics),
                          "metrics": metrics[-3:],
                          "seconds": round(time.time() - t0, 2)}))
    trainer.envs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
