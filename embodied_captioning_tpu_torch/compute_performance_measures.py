"""Caption quality against annotated references: BLEU, METEOR, ROUGE-1/2/L
(`utils/metrics.caption_scores`) and the sentence-embedding cosine of
each proposed caption and its reference, over a results CSV.

The counterpart of the JAX package's `scripts/compute_performance_measures.py`,
with its arguments (and `--device`) and its JSON line. The sentence
encoder's weights are the seeded random init (generator seed 0). It runs
on the GPU (the flash attention and LayerNorm kernels) unless `--device
cpu` is given, and exits 2 where there is no card.

Usage:
  python -m embodied_captioning_tpu_torch.compute_performance_measures \\
      RESULTS.csv [--proposed-col proposed] [--reference-col reference] \\
      [--preset tiny] [--out per_row.csv] [--device cpu]

Prints one JSON line: the mean of every score and n (or {"error":
"empty csv"}). `--out` writes the per-row scores as CSV.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csv_path")
    ap.add_argument("--proposed-col", default="proposed")
    ap.add_argument("--reference-col", default="reference")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--out", default=None, help="per-row scores CSV")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("compute_performance_measures: no CUDA device (pass --device "
              "cpu to run on the CPU)", file=sys.stderr)
        return 2

    with open(args.csv_path) as fh:
        rows = [(r[args.proposed_col], r[args.reference_col])
                for r in csv.DictReader(fh)]
    if not rows:
        print(json.dumps({"error": "empty csv"}))
        return 0

    from .config import load_config
    from .models.sbert import SentenceEncoder
    from .utils.metrics import caption_scores

    cfg = load_config(args.preset)
    enc = SentenceEncoder.create(0, cfg.sentence_encoder, device=args.device)
    ep = enc.encode([p for p, _ in rows])
    er = enc.encode([r for _, r in rows])
    cos = np.sum(ep * er, axis=1)  # the diagonal of proposed x reference

    per_row = []
    for (p, r), c in zip(rows, cos):
        s = caption_scores(p, r)
        s["sbert_cosine"] = float(c)
        per_row.append(s)
    agg = {k: float(np.mean([s[k] for s in per_row])) for k in per_row[0]}
    agg["n"] = len(per_row)
    if args.out:
        with open(args.out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(per_row[0]))
            w.writeheader()
            w.writerows(per_row)
    print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
