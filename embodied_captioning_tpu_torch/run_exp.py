"""Run an exploration experiment: a registered trainer's `generate` or
`train` on the GPU (or on the CPU with --device cpu).

Usage:
  python -m embodied_captioning_tpu_torch.run_exp --trainer randombaseline \
      --mode generate --preset tiny --steps 20 --obs-dir DIR \
      [--w8a8] [--no-int8-kv] [--render-mode MODE] [--device cpu] \
      [key.path=value ...]
  python -m embodied_captioning_tpu_torch.run_exp \
      --trainer goalexplorationbaseline-v0 --mode train --preset tiny \
      --steps 1 ppo.num_global_steps=2 [--device cpu] [key.path=value ...]
  torchrun --nproc_per_node N -m embodied_captioning_tpu_torch.run_exp \
      --trainer myppo --mode train ...   (one process per card; the
      distributed PPO trainer splits runtime.num_envs over the N ranks)

Prints one JSON line. generate: saved files, frames, seconds, frames/s
and each env's reward; train: the number of PPO updates (`--steps`, 2 by
default), the metrics of the last three and the seconds. `--w8a8`,
`--no-int8-kv` and `--render-mode` take the place of the JAX package's
ECAP_W8A8, ECAP_INT8_KV and ECAP_RENDER_MODE (`perception.perceive`,
`envs.sim.resolve_attr_mode`).
"""

from __future__ import annotations

import argparse
import json
import os
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
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 activations into every product with an "
                         "int8 weight (the JAX package's ECAP_W8A8=1)")
    ap.add_argument("--no-int8-kv", dest="int8_kv", action="store_false",
                    help="bf16 cross-attention K/V under int8 weights "
                         "(the JAX package's ECAP_INT8_KV=0)")
    ap.add_argument("--render-mode", default=None,
                    help="the simulator's render mode (envs.sim."
                         "render_batch), e.g. onehot@160x48")
    ap.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("run_exp: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2

    from .agents import get_trainer  # (importing fills the registry)
    from .config import load_config
    from .parallel.mesh import initialize_distributed

    # under torchrun: one process per device, joined into one group
    initialize_distributed("env://", int(os.environ.get("WORLD_SIZE", 1)),
                           int(os.environ.get("RANK", 0)))

    overrides = list(args.overrides)
    if args.obs_dir:
        overrides.append(f"runtime.obs_dir={args.obs_dir}")
    cfg = load_config(args.preset, yaml_path=args.config, overrides=overrides)

    t0 = time.time()
    trainer = get_trainer(args.trainer)(
        cfg, device=args.device, w8a8=args.w8a8, int8_kv=args.int8_kv,
        render_mode=args.render_mode)
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
