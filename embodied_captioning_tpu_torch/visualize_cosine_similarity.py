"""Violin plots of per-object caption consistency across experiment
variants: one violin per per-object JSON of `compute_cosine_sim --out`.

The counterpart of the JAX package's `scripts/visualize_cosine_similarity.py`,
with its arguments, its figure and its JSON line. It needs matplotlib,
imported when it runs; without it, it says so and exits 2.

Usage:
  python -m embodied_captioning_tpu_torch.visualize_cosine_similarity \\
      baseline=va.json finetuned=vb.json [--out cosine_violins.png] \\
      [--title TEXT]

Each input is `name=path` or a bare path (named by its file stem). Prints
one JSON line: out, and each variant's objects, mean and median.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_values(path: str) -> list:
    """The mean pairwise cosines of a per-object JSON (the whole file of
    `compute_cosine_sim --out`, or its `per_object` dict alone)."""
    with open(path) as fh:
        d = json.load(fh)
    return [v["mean_pairwise_cosine"]
            for v in d.get("per_object", d).values()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+", help="name=path or path JSONs from "
                    "compute_cosine_sim --out")
    ap.add_argument("--out", default="cosine_violins.png")
    ap.add_argument("--title", default="Multi-view caption consistency "
                    "(mean pairwise SBERT cosine per object)")
    args = ap.parse_args(argv)

    try:
        import matplotlib
    except ImportError:
        print("visualize_cosine_similarity: matplotlib is not installed; "
              "it draws the violins", file=sys.stderr)
        return 2
    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    names, series = [], []
    for item in args.inputs:
        name, _, path = item.rpartition("=")
        path = path or item
        name = name or os.path.splitext(os.path.basename(path))[0]
        vals = load_values(path)
        if not vals:
            print(f"[visualize] {name}: no objects, skipped")
            continue
        names.append(name)
        series.append(np.asarray(vals))
    if not series:
        print(json.dumps({"error": "no data"}))
        return 0

    fig, ax = plt.subplots(figsize=(1.8 + 1.6 * len(series), 4.0))
    ax.violinplot(series, showmeans=True, showextrema=True)
    ax.set_xticks(range(1, len(names) + 1))
    ax.set_xticklabels(names, rotation=15)
    ax.set_ylabel("mean pairwise cosine")
    ax.set_ylim(-0.05, 1.05)
    ax.set_title(args.title, fontsize=10)
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(json.dumps({
        "out": args.out,
        "variants": {n: {"objects": int(len(s)), "mean": float(s.mean()),
                         "median": float(np.median(s))}
                     for n, s in zip(names, series)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
