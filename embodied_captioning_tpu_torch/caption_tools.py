"""Caption utilities over a recorded experiment, as subcommands:

  filter-boxes  count the valid `bbs` / `bbsgt` boxes an area and
                containment filter keeps and drops (host numpy)
  save-logits   caption the crops of the valid `bbs` boxes and write the
                tokens, every step's logits and the crops' metadata (npz)
  perplexity    caption the same crops and write each caption and its
                perplexity (CSV)
  triage        rank the (episode, object) caption sets by multi-view
                consistency for human review (JSON)

The counterpart of the JAX package's `scripts/caption_tools.py`, with its
subcommands, arguments (and `--device`) and JSON lines. `save-logits` and
`perplexity` crop on the device (`expand_boxes` by 0.2, `crop_and_resize`
to the captioner's input size, truncated to uint8 as the JAX script's
numpy cast does) and run `captioner.generate` through the kernels: the
ViT's preprocess, flash attention and LayerNorm, then the decode loop's
self block, cross block and decode MLP. `triage` runs the sentence encoder
(flash attention and LayerNorm). These three run on the GPU unless
`--device cpu` is given, and exit 2 where there is no card;
`filter-boxes` is host numpy.
The captioner's and the encoder's weights are the seeded random init
(generator seed 0). The bf16 logits are saved as the JAX script's npz
holds its bf16 array: two raw bytes an element (numpy dtype "V2"; view
them as uint16 and shift left by 16 for float32).

Usage:
  python -m embodied_captioning_tpu_torch.caption_tools SUBCOMMAND \\
      EXP_PATH [--preset tiny] [--out PATH] [--max-crops 64] \\
      [--min-area 100] [--max-area-frac 0.95] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

import numpy as np
import torch

# where each subcommand runs unless --device says otherwise
DEVICE = {"filter-boxes": "cpu", "save-logits": "cuda",
          "perplexity": "cuda", "triage": "cuda"}


def _iter_bbs(loader):
    """(episode, camera, modality, step, payload) of every `bbs` and
    `bbsgt` file."""
    for ep in loader.episodes:
        for cam in loader.cameras(ep):
            for mod in ("bbs", "bbsgt"):
                if mod in loader.modalities(ep, cam):
                    for step in loader.steps(ep, cam, mod):
                        yield ep, cam, mod, step, loader.get_sample(
                            ep, cam, mod, step).data


def cmd_filter_boxes(args) -> dict:
    """Drop boxes of area <= --min-area and boxes lying over 90% inside a
    larger one. --max-area-frac is taken and unused, as in the JAX
    script (a frame's size is not in the payload)."""
    from .utils.obs_store import SampleLoader

    kept = dropped = frames = 0
    for _ep, _cam, _mod, _step, d in _iter_bbs(SampleLoader(args.exp_path)):
        v = np.asarray(d.get("valid", []), bool)
        if not v.any():
            continue
        b = np.asarray(d.get("boxes", np.zeros((0, 4))))[np.nonzero(v)[0]]
        areas = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
            b[:, 3] - b[:, 1], 0)
        ok = areas > args.min_area
        for i in range(len(b)):
            for j in range(len(b)):
                if i == j or areas[j] <= areas[i]:
                    continue
                x1 = max(b[i, 0], b[j, 0])
                y1 = max(b[i, 1], b[j, 1])
                x2 = min(b[i, 2], b[j, 2])
                y2 = min(b[i, 3], b[j, 3])
                inter = max(0, x2 - x1) * max(0, y2 - y1)
                if areas[i] > 0 and inter / areas[i] > 0.9:
                    ok[i] = False
        kept += int(ok.sum())
        dropped += int((~ok).sum())
        frames += 1
    return {"kept": kept, "dropped": dropped, "frames": frames}


def load_crops(exp_path: str, size: int, max_crops: int, device):
    """uint8 crops [N, size, size, 3] on `device` of the valid `bbs` boxes
    of every frame with an rgb image, each box expanded by 0.2 of its size
    a side, and their {episode, step, object_id}. Frames are taken whole
    until N reaches `max_crops` (so N may pass it)."""
    from .ops.detections import expand_boxes
    from .ops.image import crop_and_resize
    from .utils.obs_store import SampleLoader

    loader = SampleLoader(exp_path)
    crops, meta = [], []
    for ep, _cam, mod, step, d in _iter_bbs(loader):
        if mod != "bbs":
            continue
        rgb_cam = next((c for c in loader.cameras(ep)
                        if "rgb" in loader.modalities(ep, c)), None)
        if rgb_cam is None or step not in loader.paths[ep][rgb_cam]["rgb"]:
            continue
        rgb = loader.get_sample(ep, rgb_cam, "rgb", step).data
        v = np.asarray(d.get("valid", []), bool)
        boxes = np.asarray(d.get("boxes", np.zeros((0, 4))), np.float32)
        ids = np.asarray(d.get("object_ids", np.full(len(v), -1)))
        h, w = rgb.shape[:2]
        img = torch.as_tensor(rgb, device=device).float()
        for i in np.nonzero(v)[0]:
            eb = expand_boxes(torch.as_tensor(boxes[i][None], device=device),
                              0.2, h, w)
            crops.append(crop_and_resize(img, eb, size)[0].to(torch.uint8))
            meta.append({"episode": ep, "step": step,
                         "object_id": int(ids[i])})
        if len(crops) >= max_crops:
            break
    if not crops:
        return None, meta
    return torch.stack(crops), meta


def captioner_params(cfg, device) -> dict:
    """The captioner's seeded random weights (generator seed 0)."""
    from .models.captioner import init_captioner

    g = torch.Generator(device=device).manual_seed(0)
    return init_captioner(g, cfg.captioner, device)


def _caption(args, full_logits: bool):
    from .config import load_config
    from .models.captioner import generate

    cfg = load_config(args.preset)
    crops, meta = load_crops(args.exp_path, cfg.captioner.vision.image_size,
                             args.max_crops, args.device)
    if crops is None:
        return None
    params = captioner_params(cfg, args.device)
    toks, out, _ = generate(params, crops, cfg.captioner,
                            full_logits=full_logits)
    return cfg, meta, toks, out


def cmd_save_logits(args) -> dict:
    got = _caption(args, full_logits=True)
    if got is None:
        return {"error": "no crops"}
    _, meta, toks, logits = got
    logits = logits.contiguous().view(torch.int16).cpu().numpy().view("V2")
    np.savez_compressed(args.out, tokens=toks.cpu().numpy(), logits=logits,
                        meta=np.array(meta, dtype=object))
    return {"crops": len(meta), "out": args.out,
            "logits_shape": list(logits.shape)}


def cmd_perplexity(args) -> dict:
    from .models.captioner import perplexity
    from .models.tokenizer import default_tokenizer

    got = _caption(args, full_logits=False)
    if got is None:
        return {"error": "no crops"}
    cfg, meta, toks, logp = got
    tok = default_tokenizer(cfg.captioner.text.vocab_size)
    ppl = perplexity(logp, toks).cpu().numpy()
    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["episode", "step", "object_id",
                                           "caption", "perplexity"])
        w.writeheader()
        for m, t, p in zip(meta, toks.cpu().numpy(), ppl):
            w.writerow({**m, "caption": tok.decode(t),
                        "perplexity": float(p)})
    return {"crops": len(meta), "out": args.out,
            "mean_perplexity": float(ppl.mean())}


def cmd_triage(args) -> dict:
    from .config import load_config
    from .labeling.pseudocaptioner import group_captions, records_from_store
    from .models.sbert import SentenceEncoder
    from .utils.metrics import mean_pairwise_cosine

    cfg = load_config(args.preset)
    enc = SentenceEncoder.create(0, cfg.sentence_encoder, device=args.device)
    rows = []
    for (ep, obj), caps in group_captions(
            records_from_store(args.exp_path)).items():
        if len(caps) < 2:
            continue
        sim = mean_pairwise_cosine(enc.encode(caps))
        rows.append({"episode": ep, "object_id": obj, "views": len(caps),
                     "consistency": round(sim, 4), "captions": caps})
    rows.sort(key=lambda r: r["consistency"])
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=2)
    return {"objects": len(rows), "out": args.out,
            "least_consistent": rows[0]["consistency"] if rows else None}


COMMANDS = {"filter-boxes": cmd_filter_boxes, "save-logits": cmd_save_logits,
            "perplexity": cmd_perplexity, "triage": cmd_triage}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS.items():
        p = sub.add_parser(name)
        p.add_argument("exp_path")
        p.add_argument("--preset", default="tiny")
        p.add_argument("--out", default=f"{name.replace('-', '_')}_out")
        p.add_argument("--max-crops", type=int, default=64)
        p.add_argument("--min-area", type=float, default=100.0)
        p.add_argument("--max-area-frac", type=float, default=0.95)
        p.add_argument("--device", default=DEVICE[name])
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"caption_tools {args.cmd}: no CUDA device (pass --device cpu "
              "to run on the CPU)", file=sys.stderr)
        return 2
    print(json.dumps(args.fn(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
