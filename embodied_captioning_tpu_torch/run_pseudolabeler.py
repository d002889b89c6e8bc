"""Pseudo-label a recorded exploration dataset: a consensus labeler's
`predict` over the store's frames, its consensus, and the per-frame
`bbs` label files, on the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/run_pseudolabeler.py`, with
its arguments (and `--device`) and its JSON line. The perceiver's weights
are the seeded random init (generator seed 0).

Usage:
  python -m embodied_captioning_tpu_torch.run_pseudolabeler EXP_PATH \\
      --out DIR [--consensus semantic_map] [--preset tiny] [--batch 8] \\
      [--device cpu] [key.path=value ...]

Prints one JSON line: frames, instances, files, out.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

CONSENSUS = ("vanilla", "soft", "majority", "max_score", "semantic_map",
             "semantic_map_captioner")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path")
    ap.add_argument("--out", required=True, help="pseudo-label output dir")
    ap.add_argument("--consensus", default="semantic_map", choices=CONSENSUS)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 activations into every product with an "
                         "int8 weight (the JAX package's ECAP_W8A8=1)")
    ap.add_argument("--no-int8-kv", dest="int8_kv", action="store_false",
                    help="bf16 cross-attention K/V under int8 weights "
                         "(the JAX package's ECAP_INT8_KV=0)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("run_pseudolabeler: no CUDA device (pass --device cpu to run "
              "on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .labeling.datasets import EpisodeDetectionDataset
    from .labeling.pseudolabeler import CONSENSUS_REGISTRY
    from .perception import Perceiver

    cfg = load_config(args.preset, overrides=list(args.overrides))
    labeler = CONSENSUS_REGISTRY[args.consensus](
        cfg, perceiver=Perceiver(cfg, device=args.device, w8a8=args.w8a8,
                                 int8_kv=args.int8_kv))
    dataset = EpisodeDetectionDataset(args.exp_path, label_modality="bbs",
                                      with_depth_pose=True)
    print(f"[pseudolabeler] {len(dataset)} frames, consensus="
          f"{args.consensus}", flush=True)
    preds = labeler.predict(dataset, args.batch)
    pseudo = labeler.get_pseudo_labels(preds)
    paths = labeler.save_pseudo_labels(pseudo, args.out)
    n_inst = int(sum(p.valid.sum() for p in pseudo))
    print(json.dumps({"frames": len(pseudo), "instances": n_inst,
                      "files": len(paths), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
