"""Distill the grouped multi-view captions of a recorded experiment into
one pseudo-caption per object, on the GPU (or on the CPU with --device
cpu).

The counterpart of the JAX package's `scripts/pseudocaption.py`, with its
arguments (and `--device`, `--llm-path`) and its JSON line. Captions come
from the store's `bbs` and `bbsgt` payloads, grouped by (episode, object
id). No crops are handed to the consensus, so `clip` and `itc` fall back
to `sbert`, as in the JAX script; `llm` without a model at `--llm-path`
(the JAX script's ECAP_LLM_PATH), or without `transformers`, does too.
The sentence encoder's weights are the seeded random init (generator seed
0).

Usage:
  python -m embodied_captioning_tpu_torch.pseudocaption EXP_PATH \\
      [--method sbert] [--out pseudo_captions.json] [--preset tiny] \\
      [--llm-path DIR] [--device cpu] [key.path=value ...]

Prints one JSON line: objects, method, out.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path", help="recorded experiment dir with bbs npz")
    ap.add_argument("--method", default="sbert",
                    choices=["sbert", "clip", "itc", "tfidf", "llm"])
    ap.add_argument("--out", default="pseudo_captions.json")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--llm-path", default=None,
                    help="a local Hugging Face causal LM for the llm "
                         "method (sbert without one)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("pseudocaption: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .labeling.pseudocaptioner import (
        PseudoCaptioner, group_captions, records_from_store,
    )

    cfg = load_config(args.preset, overrides=list(args.overrides))
    records = records_from_store(args.exp_path)
    groups = group_captions(records)
    print(f"[pseudocaption] {len(records)} captions over "
          f"{len(groups)} objects", flush=True)
    pc = PseudoCaptioner(cfg, method=args.method, device=args.device,
                         llm_path=args.llm_path)
    result = pc.consensus(groups)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps({"objects": len(result), "method": args.method,
                      "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
