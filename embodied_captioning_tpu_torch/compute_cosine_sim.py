"""Multi-view caption consistency of a recorded experiment: the mean
pairwise sentence-embedding cosine of each (episode, object)'s captions,
read from the store's `bbs` and `bbsgt` payloads.

The counterpart of the JAX package's `scripts/compute_cosine_sim.py`,
with its arguments (and `--device`) and its JSON line. The sentence
encoder's weights are the seeded random init (generator seed 0). It runs
on the GPU (the flash attention and LayerNorm kernels) unless `--device
cpu` is given, and exits 2 where there is no card.

Usage:
  python -m embodied_captioning_tpu_torch.compute_cosine_sim EXP_PATH \\
      [--preset tiny] [--min-views 2] [--out per_object.json] \\
      [--device cpu]

Prints one JSON line: objects, mean_consistency. `--out` writes
{"per_object": {"<episode>_<object>": {"views", "mean_pairwise_cosine"}},
"summary": ...}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def per_object_consistency(exp_path: str, encoder, min_views: int) -> dict:
    """{"<episode>_<object>": {"views", "mean_pairwise_cosine"}} over the
    objects with at least `min_views` captions."""
    from .labeling.pseudocaptioner import group_captions, records_from_store
    from .utils.metrics import mean_pairwise_cosine

    out = {}
    for (ep, obj), caps in group_captions(records_from_store(exp_path)
                                          ).items():
        if len(caps) < min_views:
            continue
        out[f"{ep}_{obj}"] = {
            "views": len(caps),
            "mean_pairwise_cosine": mean_pairwise_cosine(encoder.encode(caps)),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--min-views", type=int, default=2)
    ap.add_argument("--out", default=None, help="per-object json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("compute_cosine_sim: no CUDA device (pass --device cpu to run "
              "on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .models.sbert import SentenceEncoder

    cfg = load_config(args.preset)
    enc = SentenceEncoder.create(0, cfg.sentence_encoder, device=args.device)
    per_object = per_object_consistency(args.exp_path, enc, args.min_views)
    values = [v["mean_pairwise_cosine"] for v in per_object.values()]
    summary = {
        "objects": len(per_object),
        "mean_consistency": float(np.mean(values)) if values else 0.0,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"per_object": per_object, "summary": summary}, fh,
                      indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
