"""Evaluate a trained detector artifact on three unseen-scene corpora, on
the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/eval_artifact.py`, with its
arguments (and `--device`) and its JSON line. The artifact is a pickle of
`selfcheck_detector --save` (either package's) or a compact serving export;
the default is the committed `det_serving_256.pkl`, which holds only the
served (affine-folded, int8) weights. The configuration is the large
preset at 1280^2 sensors, merged with the artifact's serving
configuration, then the `key.path=value` overrides. Corpora, each
rendered by the port's simulator at the sensor size and resized to the
detector's input (`selfcheck_detector.collect`), or loaded from its npz
cache where that exists (either package's file):

  protocol  8 scenes from seed 500 (`--eval-cache`)
  wide      `--wide` scenes from `--wide-seed` (`--wide-cache`)
  stress    `--stress` scenes from `--stress-seed` with distractor
            objects, extra interior walls and boosted texture contrast
            (`--stress-distractors`, `--stress-walls`, `--stress-tex`;
            `--stress-cache`)

Variants: the raw or EMA weights of a full save ("best", under the
norm they were trained with) and its calibrated affine weights
("affine"), and the served weights ("served_int8"), each evaluated with
and without the horizontal-flip merge (`forward_tta`), mAP@50 over
whole batches of `--batch` frames (the remainder is dropped).

A cache path that is not given is not written: the corpus is rendered
afresh on every run.

Usage:
  python -m embodied_captioning_tpu_torch.eval_artifact \\
      [--artifact art.pkl] [--eval-cache p.npz] [--wide 24] \\
      [--wide-cache w.npz] [--stress 16] [--stress-cache s.npz] \\
      [--batch 16] [--device cpu] [key.path=value ...]

Prints one JSON line: artifact, serving_img, artifact_metrics, corpora
(frames, sha a corpus) and results (mAP a corpus and variant).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARTIFACT = str(Path(__file__).resolve().parents[1] / "embodied_captioning_tpu"
               / "models" / "data" / "det_serving_256.pkl")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=ARTIFACT)
    ap.add_argument("--eval-cache", default=None,
                    help="npz of the protocol corpus: rendered and saved on "
                         "first use, loaded afterwards")
    ap.add_argument("--wide", type=int, default=24)
    ap.add_argument("--wide-seed", type=int, default=100000)
    ap.add_argument("--wide-cache", default=None)
    ap.add_argument("--stress", type=int, default=16)
    ap.add_argument("--stress-seed", type=int, default=200000)
    ap.add_argument("--stress-cache", default=None)
    ap.add_argument("--stress-distractors", type=int, default=6)
    ap.add_argument("--stress-walls", type=int, default=5)
    ap.add_argument("--stress-tex", type=float, default=0.18)
    ap.add_argument("--eval-ep-steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("eval_artifact: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2

    from .config import apply_dotlist, load_config, merge
    from .params import from_jax, load_pickle
    from .selfcheck_detector import (
        collect, corpus_checksum, eval_map, load_corpus, save_corpus,
    )

    artifact = load_pickle(args.artifact)
    cfg = load_config("large", overrides=["sensors.height=1280",
                                          "sensors.width=1280"])
    cfg = merge(cfg, {"detector": artifact["serving_cfg"]})
    if args.overrides:
        cfg = apply_dotlist(cfg, list(args.overrides))
    dcfg = cfg.detector
    eval_cfg = dataclasses.replace(dcfg, score_threshold=0.05)

    def get_corpus(path, scenes, seed0, stress=False):
        if path and os.path.exists(path):
            return load_corpus(path)
        c = cfg
        if stress:
            c = apply_dotlist(cfg, [
                f"sim.num_distractors={args.stress_distractors}",
                f"sim.interior_walls={args.stress_walls}",
                f"sim.tex_boost={args.stress_tex}"])
        frames = collect(c, scenes, args.eval_ep_steps, seed0,
                         np.random.default_rng(seed0), dev)
        if path:
            save_corpus(path, frames)
        return frames

    corpora = {"protocol": get_corpus(args.eval_cache, 8, 500)}
    if args.wide:
        corpora["wide"] = get_corpus(args.wide_cache, args.wide,
                                     args.wide_seed)
    if args.stress:
        corpora["stress"] = get_corpus(args.stress_cache, args.stress,
                                       args.stress_seed, stress=True)

    variants = {}  # name -> (params, norm or None: the serving config's)
    if "params" in artifact:  # a full save: the raw / EMA float weights
        best = (artifact.get("ema") if artifact.get("best") == "ema"
                else None) or artifact["params"]
        # raw / EMA weights were trained under train_cfg's norm; the
        # serving config may say affine (the calibrated artifact's)
        train_norm = (artifact.get("train_cfg") or {}).get("norm", "gn")
        variants["best"] = (from_jax(best, dev), train_norm)
        if artifact.get("affine") is not None:
            variants["affine"] = (from_jax(artifact["affine"], dev),
                                  "affine")
    if "served" in artifact:  # the serving export: folded and int8
        variants["served_int8"] = (from_jax(artifact["served"], dev), None)

    out = {"artifact": os.path.basename(args.artifact),
           "serving_img": dcfg.image_size,
           "artifact_metrics": artifact.get("metrics"),
           "corpora": {}, "results": {}}
    for cname, frames in corpora.items():
        out["corpora"][cname] = {"frames": len(frames),
                                 "sha": corpus_checksum(frames)}
        row = {}
        for vname, (params, norm) in variants.items():
            vcfg = (dataclasses.replace(eval_cfg, norm=norm) if norm
                    else eval_cfg)
            t0 = time.time()
            row[vname] = round(eval_map(params, frames, vcfg, args.batch,
                                        dev), 4)
            row[vname + "_tta"] = round(eval_map(params, frames, vcfg,
                                                 args.batch, dev, tta=True),
                                        4)
            print(f"[eval] {cname}/{vname}: {row[vname]} "
                  f"(tta {row[vname + '_tta']}) {time.time() - t0:.0f}s",
                  flush=True)
        out["results"][cname] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
