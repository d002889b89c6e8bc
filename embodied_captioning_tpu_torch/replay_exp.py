"""Replay a recorded experiment directory (the npz store of `run_exp
--mode generate`): list its rgb frames, or, with --perceive, run batched
detection and captioning (`Perceiver.process`) over them on the GPU (or
on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/replay_exp.py`, with its
arguments (and `--device`), its lines and its JSON line. The perceiver's
weights are the seeded random init (generator seed 0). Without --perceive
nothing runs on a device.

Usage:
  python -m embodied_captioning_tpu_torch.replay_exp EXP_PATH [--perceive]
      [--preset tiny] [--batch 8] [--max-frames 500] [--device cpu]
      [key.path=value ...]

Prints `[replay] episodes=... files=...` and `[replay] N rgb frames`, then
the first ten frames' shapes, or with --perceive one JSON line: frames,
detections (valid detection slots), seconds, fps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

Frame = Tuple[int, int, int]  # (episode, camera, step)


def rgb_frames(loader, max_frames: int) -> List[Frame]:
    """The store's rgb frames in episode, camera and step order, at most
    `max_frames`."""
    frames = []
    for ep in loader.episodes:
        for cam in loader.cameras(ep):
            if "rgb" not in loader.modalities(ep, cam):
                continue
            for step in loader.steps(ep, cam, "rgb"):
                frames.append((ep, cam, step))
    return frames[:max_frames]


def load_batch(loader, frames: List[Frame]) -> np.ndarray:
    """The frames' rgb images stacked [N, H, W, 3] uint8."""
    return np.stack([loader.get_sample(ep, cam, "rgb", st).data
                     for ep, cam, st in frames])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--perceive", action="store_true",
                    help="re-run detection+captioning on replayed frames")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 activations into every product with an "
                         "int8 weight (the JAX package's ECAP_W8A8=1)")
    ap.add_argument("--no-int8-kv", dest="int8_kv", action="store_false",
                    help="bf16 cross-attention K/V under int8 weights "
                         "(the JAX package's ECAP_INT8_KV=0)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from .utils.obs_store import SampleLoader

    loader = SampleLoader(args.exp_path)
    n_files = len(loader.episode_list)  # len(loader) = dense step count
    print(f"[replay] episodes={loader.episodes} files={n_files}")
    frames = rgb_frames(loader, args.max_frames)
    print(f"[replay] {len(frames)} rgb frames")

    if not args.perceive:
        for ep, cam, step in frames[:10]:
            s = loader.get_sample(ep, cam, "rgb", step)
            print(f"  ep {ep} cam {cam} step {step}: rgb {s.data.shape}")
        return 0

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("replay_exp: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .perception import Perceiver

    cfg = load_config(args.preset, overrides=list(args.overrides))
    p = Perceiver(cfg, device=args.device, w8a8=args.w8a8,
                  int8_kv=args.int8_kv)
    t0 = time.time()
    n_det = 0
    for i in range(0, len(frames), args.batch):
        result = p.process(load_batch(loader, frames[i:i + args.batch]))
        n_det += int(result.detections.valid.sum())
    dt = time.time() - t0
    print(json.dumps({"frames": len(frames), "detections": n_det,
                      "seconds": round(dt, 2),
                      "fps": round(len(frames) / max(dt, 1e-6), 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
