"""Teacher-student detector distillation: rounds of explore (where the
store is missing) -> pseudo-label -> fit the student -> refresh the
teacher, on the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/train_detector.py`, with its
arguments (and `--device`), its per-round lines and its JSON line. The
student's weights start from the seeded init (generator seed 0), the
labeler's perceiver from its own (seed 0); `--save` writes the teacher
and the student as numpy trees in the JAX package's layout.

Usage:
  python -m embodied_captioning_tpu_torch.train_detector --obs-dir DIR \\
      [--pipeline default|online|gt|swa] [--consensus soft] \\
      [--head focal] [--trainer randombaseline] [--preset tiny] \\
      [--rounds 1] [--epochs 1] [--steps N] [--ema] [--save PATH] \\
      [--device cpu] [key.path=value ...]

Prints one line a round and then one JSON line: rounds, train_steps, last
(the last step's losses), saved.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--obs-dir", required=True,
                    help="exploration dataset dir (generated if missing)")
    ap.add_argument("--pipeline", default="default",
                    choices=["default", "online", "gt", "swa"])
    ap.add_argument("--consensus", default="soft",
                    choices=["vanilla", "soft", "majority", "max_score",
                             "semantic_map"])
    ap.add_argument("--head", default="focal",
                    choices=["ce", "focal", "soft", "softfocal", "msefocal"])
    ap.add_argument("--trainer", default="randombaseline")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=None,
                    help="exploration steps when generating")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--save", default=None, help="teacher/student pickle")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("train_detector: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .train.pipelines import (
        GTPipeline, OnlinePipeline, Pipeline, SWAPipeline,
    )

    cfg = load_config(args.preset, overrides=list(args.overrides))
    cls = {"default": Pipeline, "online": OnlinePipeline, "gt": GTPipeline,
           "swa": SWAPipeline}[args.pipeline]
    pipe = cls(cfg, trainer_name=args.trainer, consensus=args.consensus,
               head=args.head, use_ema=args.ema, device=args.device)

    all_logs = []
    for r in range(args.rounds):
        logs = pipe.run_round(args.obs_dir, num_steps=args.steps,
                              epochs=args.epochs)
        all_logs += logs
        print(f"[round {r}] {len(logs)} steps, "
              f"last loss={logs[-1]['loss']:.4f}" if logs else
              f"[round {r}] no batches", flush=True)
    if args.save:
        pipe.save(args.save)
    print(json.dumps({"rounds": args.rounds, "train_steps": len(all_logs),
                      "last": all_logs[-1] if all_logs else None,
                      "saved": args.save}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
