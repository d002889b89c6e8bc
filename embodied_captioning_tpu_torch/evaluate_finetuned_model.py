"""Caption annotated boxes with a (fine-tuned or ported) captioner and
write the results CSV (proposed, reference, perplexity) for the caption
metrics, on the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/evaluate_finetuned_model.py`,
with its arguments (and `--device`), its CSV and its JSON line. The
annotations JSON is a list of {"image", "box": [x1, y1, x2, y2],
"caption"}; "image" is an `.npz` (array "arr_0") or `.npy` path, or
"exp_dir:episode:camera:step" into an npz store. Each box is expanded by
0.2 of its size on each side, cropped and resized to the ViT's input,
and captioned greedily in batches; the perplexity is that of the chosen
tokens.

Weights: `--ported-dir` (a `port_checkpoint` directory: its params,
inferred config and tokenizer), else `--checkpoint` (a captioner params
pickle in the JAX package's layout, as `finetune_captioner` writes it)
with the `--preset` config and the framework tokenizer, else the seeded
random init (generator seed 0). Float32 leaves are served as they are.

Usage:
  python -m embodied_captioning_tpu_torch.evaluate_finetuned_model \
      ANNOTATIONS.json [--ported-dir DIR | --checkpoint PKL] \
      [--preset tiny] [--batch 16] [--out captions_eval.csv] \
      [--device cpu] [key.path=value ...]

Prints one JSON line: rows, out.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch


def load_image(ref: str) -> np.ndarray:
    """An annotation's image: an npz / npy path, or
    "exp_dir:episode:camera:step" into an npz store."""
    if ":" in ref and not os.path.exists(ref):
        from .utils.obs_store import SampleLoader

        exp, ep, cam, step = ref.rsplit(":", 3)
        return SampleLoader(exp).get_sample(int(ep), int(cam), "rgb",
                                            int(step)).data
    if ref.endswith(".npz"):
        return np.load(ref)["arr_0"]
    return np.load(ref)


def crop_batch(anns: list, size: int, dev) -> torch.Tensor:
    """uint8 crops [N, size, size, 3] of the annotations' boxes expanded
    by 0.2 (the float crop truncated to uint8, as the JAX script casts
    it)."""
    from .ops.detections import expand_boxes
    from .ops.image import crop_and_resize

    crops = []
    for a in anns:
        img = torch.from_numpy(np.asarray(load_image(a["image"]))).to(dev)
        h, w = img.shape[:2]
        box = expand_boxes(torch.tensor([a["box"]], dtype=torch.float32,
                                        device=dev), 0.2, h, w)
        crops.append(crop_and_resize(img.float(), box, size)[0])
    return torch.stack(crops).to(torch.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("annotations", help="JSON list of image/box/caption")
    ap.add_argument("--checkpoint", default=None,
                    help="captioner params pickle (from fine-tuning)")
    ap.add_argument("--ported-dir", default=None,
                    help="ported real-checkpoint directory from "
                         "port_checkpoint (overrides --preset/--checkpoint; "
                         "uses the ported tokenizer and ids)")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--out", default="captions_eval.csv")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate_finetuned_model: no CUDA device (pass "
                           "--device cpu to run on the CPU)")

    from .config import load_config
    from .models.captioner import generate, init_captioner, perplexity
    from .models.tokenizer import default_tokenizer
    from .params import from_jax, load_pickle

    if args.ported_dir:
        from .tools.port import load_ported

        params, cfg, tok = load_ported(args.ported_dir)
        params = from_jax(params, dev)
    else:
        cfg = load_config(args.preset,
                          overrides=list(args.overrides)).captioner
        if args.checkpoint:
            params = from_jax(load_pickle(args.checkpoint), dev)
        else:
            params = init_captioner(
                torch.Generator(device=dev).manual_seed(0), cfg, dev)
        tok = default_tokenizer(cfg.text.vocab_size)

    with open(args.annotations) as fh:
        anns = json.load(fh)

    rows = []
    for i in range(0, len(anns), args.batch):
        chunk = anns[i:i + args.batch]
        crops = crop_batch(chunk, cfg.vision.image_size, dev)
        toks, logp, _ = generate(params, crops, cfg)
        ppl = perplexity(logp, toks, pad_id=cfg.text.pad_id).cpu().numpy()
        for a, t, p in zip(chunk, toks.cpu().numpy(), ppl):
            rows.append({"proposed": tok.decode(t),
                         "reference": a["caption"],
                         "perplexity": float(p)})

    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["proposed", "reference",
                                           "perplexity"])
        w.writeheader()
        w.writerows(rows)
    print(json.dumps({"rows": len(rows), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
