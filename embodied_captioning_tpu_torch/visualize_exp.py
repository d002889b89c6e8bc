"""Annotated PNG frames of a recorded experiment: each rgb frame with its
detection boxes, class names and captions drawn on it, beside a colour
map of its depth. Host work with PIL.

The counterpart of the JAX package's `scripts/visualize_exp.py`, with its
arguments, its drawing and its JSON line.

Usage:
  python -m embodied_captioning_tpu_torch.visualize_exp EXP_PATH \\
      [--out viz_frames] [--max-frames 50]

Writes `ep<episode>_step<step>.png` into --out and prints one JSON line:
frames, out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

PALETTE = [(255, 80, 80), (80, 255, 80), (80, 80, 255), (255, 255, 80),
           (255, 80, 255), (80, 255, 255)]


def draw_frame(rgb, depth, bbs, class_names):
    """A PIL image [H, 2W + 4]: rgb with the valid boxes of `bbs` (a
    payload dict or None) and their labels, then the depth colour map."""
    from PIL import Image, ImageDraw

    h, w = rgb.shape[:2]
    canvas = Image.new("RGB", (w * 2 + 4, h), (30, 30, 30))
    img = Image.fromarray(rgb.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    if bbs is not None:
        valid = np.asarray(bbs.get("valid", []), bool)
        boxes = np.asarray(bbs.get("boxes", np.zeros((0, 4))))
        classes = np.asarray(bbs.get("classes", []))
        captions = bbs.get("captions")
        for i in np.nonzero(valid)[0]:
            x1, y1, x2, y2 = [float(v) for v in boxes[i]]
            c = PALETTE[int(classes[i]) % len(PALETTE)]
            draw.rectangle([x1, y1, x2, y2], outline=c, width=2)
            label = class_names[int(classes[i])]
            if captions is not None and i < len(captions):
                label = f"{label}: {captions[i]}"[:48]
            draw.text((x1 + 2, max(0, y1 - 10)), label, fill=c)
    canvas.paste(img, (0, 0))
    if depth is not None:
        d = np.asarray(depth, np.float32)
        dn = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        dm = (np.stack([dn, 1 - dn, np.ones_like(dn) * 0.3], -1) * 255
              ).astype(np.uint8)
        canvas.paste(Image.fromarray(dm), (w + 4, 0))
    return canvas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path")
    ap.add_argument("--out", default="viz_frames")
    ap.add_argument("--max-frames", type=int, default=50)
    args = ap.parse_args(argv)

    from .config import CLASS_NAMES
    from .utils.obs_store import SampleLoader

    loader = SampleLoader(args.exp_path)
    os.makedirs(args.out, exist_ok=True)
    n = 0
    for ep in loader.episodes:
        cams = loader.cameras(ep)
        rgb_cam = next((c for c in cams
                        if "rgb" in loader.modalities(ep, c)), None)
        if rgb_cam is None:
            continue
        for step in loader.steps(ep, rgb_cam, "rgb"):
            if n >= args.max_frames:
                break
            rgb = loader.get_sample(ep, rgb_cam, "rgb", step).data
            depth = bbs = None
            # the last camera holding each modality at this step wins, and
            # bbsgt over bbs, as in the JAX script
            for c in cams:
                mods = loader.modalities(ep, c)
                if "depth" in mods and step in loader.paths[ep][c]["depth"]:
                    depth = loader.get_sample(ep, c, "depth", step).data
                for m in ("bbs", "bbsgt"):
                    if m in mods and step in loader.paths[ep][c][m]:
                        bbs = loader.get_sample(ep, c, m, step).data
            draw_frame(rgb, depth, bbs, CLASS_NAMES).save(
                os.path.join(args.out, f"ep{ep:06d}_step{step:05d}.png"))
            n += 1
    print(json.dumps({"frames": n, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
