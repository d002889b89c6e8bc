"""Detection statistics of a recorded experiment: per-class counts and the
mean score of the valid `bbs` detections, and the mAP@50 of `bbs` against
`bbsgt` on the steps that have both. Host numpy only.

The counterpart of the JAX package's `scripts/compute_detection_statistics.py`,
with its argument and its JSON line.

Usage:
  python -m embodied_captioning_tpu_torch.compute_detection_statistics \\
      EXP_PATH

Prints one JSON line: detections_per_class, total, mean_score, and
map_50 where some step has both predictions and labels.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def detection_statistics(exp_path: str) -> dict:
    from .config import CLASS_NAMES, NUM_CLASSES
    from .utils.metrics import average_precision
    from .utils.obs_store import SampleLoader

    loader = SampleLoader(exp_path)
    counts = np.zeros(NUM_CLASSES, np.int64)
    scores = []
    pb, ps, pc, gb, gc = [], [], [], [], []
    for ep in loader.episodes:
        cams = loader.cameras(ep)
        gt_cam = next((c for c in cams
                       if "bbsgt" in loader.modalities(ep, c)), None)
        for cam in cams:
            if "bbs" not in loader.modalities(ep, cam):
                continue
            for step in loader.steps(ep, cam, "bbs"):
                d = loader.get_sample(ep, cam, "bbs", step).data
                v = np.asarray(d.get("valid", []), bool)
                if v.size == 0:
                    continue
                cls = np.asarray(d["classes"])[v]
                for c in cls:
                    if 0 <= c < NUM_CLASSES:
                        counts[c] += 1
                sc = np.asarray(d.get("scores", np.ones(v.sum())))[v]
                scores += list(sc)
                if gt_cam is not None and \
                        step in loader.paths[ep][gt_cam]["bbsgt"]:
                    g = loader.get_sample(ep, gt_cam, "bbsgt", step).data
                    gv = np.asarray(g.get("valid", []), bool)
                    pb.append(np.asarray(d["boxes"])[v])
                    ps.append(sc)
                    pc.append(cls)
                    gb.append(np.asarray(g["boxes"])[gv])
                    gc.append(np.asarray(g["classes"])[gv])
    out = {
        "detections_per_class": {CLASS_NAMES[i]: int(counts[i])
                                 for i in range(NUM_CLASSES)},
        "total": int(counts.sum()),
        "mean_score": float(np.mean(scores)) if scores else 0.0,
    }
    if pb:
        out["map_50"] = average_precision(pb, ps, pc, gb, gc,
                                          NUM_CLASSES)["map"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path")
    args = ap.parse_args(argv)
    print(json.dumps(detection_statistics(args.exp_path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
