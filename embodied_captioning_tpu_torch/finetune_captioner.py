"""Fine-tune the captioner on the caption-crop pairs of a recorded
experiment: CoCa loss (captioning cross-entropy + contrastive) plus the
triplet loss, AdamW, on the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/finetune_captioner.py`, with
the same arguments and the same JSON line. Each rgb frame of the store
with `bbs` labels gives one pair per valid box that has a caption: the
crop is the box expanded by 0.2 of its size on each side, resized to the
ViT's input; the caption is the box's entry in `--pseudo-captions`
(keyed "<episode>_<object id>"), else the box's caption in the store.
Weights start from the seeded init (generator seed 0). The saved pickle
is a numpy tree in the JAX package's layout, which loads in either
package.

Usage:
  python -m embodied_captioning_tpu_torch.finetune_captioner EXP_PATH \
      [--pseudo-captions pseudo_captions.json] [--preset tiny] \
      [--epochs 1] [--batch 8] [--lr 1e-4] [--triplet-weight 0.1] \
      [--save captioner_finetuned.pkl] [--device cpu] [key.path=value ...]

Prints one JSON line: pairs, steps, first_loss, last_loss, saved.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from typing import List, Tuple

import numpy as np
import torch


def build_pairs(exp_path: str, pseudo: dict, size: int, device
                ) -> Tuple[List[np.ndarray], List[str], List[int]]:
    """(uint8 crops [size, size, 3], captions, object ids) of every valid
    box with a caption, in the dataset's order."""
    from .labeling.datasets import EpisodeDetectionDataset
    from .ops.detections import expand_boxes
    from .ops.image import crop_and_resize

    ds = EpisodeDetectionDataset(exp_path, label_modality="bbs")
    crops, caps, obj_ids = [], [], []
    for i in range(len(ds)):
        s = ds[i]
        raw = ds.loader.get_sample(s.episode, ds._find_cam(s.episode, "bbs"),
                                   "bbs", s.step).data
        caption_list = raw.get("captions")
        h, w = s.image.shape[:2]
        image = None
        for j in np.nonzero(s.valid)[0]:
            cap = pseudo.get(f"{s.episode}_{int(s.object_ids[j])}")
            if cap is None and caption_list is not None and j < len(
                    caption_list):
                cap = str(caption_list[j])
            if not cap:
                continue
            if image is None:
                image = torch.from_numpy(s.image).to(device).float()
            box = expand_boxes(torch.tensor(s.boxes[j:j + 1], device=device),
                               0.2, h, w)
            crop = crop_and_resize(image, box, size)[0]
            crops.append(crop.cpu().numpy().astype(np.uint8))
            caps.append(cap)
            obj_ids.append(int(s.object_ids[j]))
    return crops, caps, obj_ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("exp_path", help="recorded experiment with bbs npz")
    ap.add_argument("--pseudo-captions", default=None,
                    help="pseudo_captions.json (fallback: per-view captions "
                         "from the store)")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--triplet-weight", type=float, default=0.1)
    ap.add_argument("--save", default="captioner_finetuned.pkl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("finetune_captioner: no CUDA device (pass "
                           "--device cpu to run on the CPU)")

    from .config import load_config
    from .models.captioner import init_captioner
    from .models.tokenizer import default_tokenizer
    from .params import to_numpy
    from .train.captioner_train import create_train_state, train_step

    cfg = load_config(args.preset, overrides=list(args.overrides))
    ccfg = cfg.captioner
    tok = default_tokenizer(ccfg.text.vocab_size)

    pseudo = {}
    if args.pseudo_captions and os.path.exists(args.pseudo_captions):
        with open(args.pseudo_captions) as fh:
            pseudo = json.load(fh)

    t0 = time.perf_counter()
    crops, caps, obj_ids = build_pairs(args.exp_path, pseudo,
                                       ccfg.vision.image_size, dev)
    if not crops:
        print(json.dumps({"error": "no training triples found"}))
        return 0
    print(f"[finetune] {len(crops)} caption-crop pairs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    params = init_captioner(torch.Generator(device=dev).manual_seed(0), ccfg,
                            dev)
    state = create_train_state(params)
    tokens = tok.encode_batch(caps, ccfg.text.context_length)
    images = np.stack(crops)
    ids = np.asarray(obj_ids, np.int32)
    n = len(crops)
    losses = []
    t0 = time.perf_counter()
    for ep in range(args.epochs):
        order = np.random.default_rng(ep).permutation(n)
        for i in range(0, n - args.batch + 1, args.batch):
            sel = order[i:i + args.batch]
            state, aux = train_step(
                state, torch.from_numpy(images[sel]).to(dev),
                torch.from_numpy(tokens[sel]).to(dev),
                torch.from_numpy(ids[sel]).to(dev),
                torch.ones(len(sel), dtype=torch.bool, device=dev), ccfg,
                lr=args.lr, triplet_weight=args.triplet_weight)
            losses.append(float(aux["loss"]))
    print(f"[finetune] {len(losses)} steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with open(args.save, "wb") as fh:
        pickle.dump(to_numpy(state.params), fh)
    print(f"[finetune] saved in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"pairs": n, "steps": len(losses),
                      "first_loss": losses[0] if losses else None,
                      "last_loss": losses[-1] if losses else None,
                      "saved": args.save}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
