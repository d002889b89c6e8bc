"""The explore -> caption -> consensus -> fine-tune -> re-caption cycle,
measured end to end: multi-view consistency (the mean pairwise sentence
cosine of each object's captions) and caption accuracy on unseen labelled
crops, before and after a fine-tune on consensus pseudo-captions, per
seed, on the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/selfcheck_cycle.py`, with
its arguments (and `--device`), its configuration and its JSON lines (one
a seed, then the summary). Per seed: the perception stack trains on
simulator ground truth (`selfcheck_loop.train_stack`, numpy draws from
`default_rng(seed)`); goal exploration records the npz store with its
ground-truth sensor; each recorded detection matched (IoU > 0.3) to a
ground-truth instance gives a view crop keyed by (episode, instance)
(`view_crops`); the views are captioned before the fine-tune, grouped per
object and distilled by `PseudoCaptioner.consensus`; the captioner
fine-tunes on (view, pseudo-caption) pairs with the same numpy generator
and Adam state; the same views are captioned again. Consistency before
and after reads the same views, so its change is the model's alone.

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_cycle [--preset base] \\
      [--seeds 0,1] [--det-steps 400] [--cap-steps 300] \\
      [--finetune-steps 200] [--explore-steps 48] [--min-views 2] \\
      [--method sbert|tfidf|clip] [--lr 3e-4] [--triplet-weight W] \\
      [--ft-batch 16] [--explore-envs 2] [--workdir DIR] \\
      [--device cpu] [key.path=value ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def view_crops(obs_dir: str, det_size: int, crop_size: int
               ) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
    """Every recorded detection of the store at `obs_dir` whose box
    matches a recorded ground-truth instance (IoU > 0.3 at sensor scale):
    its crop (box expanded by 0.2, `crop_size`^2 uint8) and its key
    (episode, ground-truth instance id), in the store's order."""
    from .ops.detections import expand_boxes, pairwise_iou
    from .ops.image import crop_and_resize
    from .utils.obs_store import SampleLoader

    crops, keys = [], []
    loader = SampleLoader(obs_dir)
    for ep in loader.episodes:
        for cam in loader.cameras(ep):
            if "bbs" not in loader.modalities(ep, cam):
                continue
            rgb_cam = loader.camera_of(ep, "rgb")
            gt_cam = loader.camera_of(ep, "bbsgt")
            for step in loader.steps(ep, cam, "bbs"):
                inst = loader.get_sample(ep, cam, "bbs", step).data
                rgb = loader.get_sample(ep, rgb_cam, "rgb", step).data
                h, w = rgb.shape[:2]
                boxes = np.asarray(inst["boxes"], np.float32)
                scale = h / det_size
                valid = np.asarray(inst["valid"])
                if gt_cam is None or step not in loader.paths[ep][gt_cam][
                        "bbsgt"]:
                    continue
                gt = loader.get_sample(ep, gt_cam, "bbsgt", step).data
                gtb = np.asarray(gt["boxes"], np.float32)
                gtv = np.asarray(gt["valid"], bool)
                gti = np.asarray(gt["object_ids"])
                iou = pairwise_iou(torch.from_numpy(boxes * scale),
                                   torch.from_numpy(gtb)).numpy()
                iou = iou * gtv[None, :]
                for j in np.nonzero(valid)[0]:
                    k = int(np.argmax(iou[j])) if iou.shape[1] else 0
                    if not iou.shape[1] or iou[j, k] <= 0.3:
                        continue  # unmatched: no stable identity
                    eb = expand_boxes(torch.from_numpy(boxes[j][None] * scale),
                                      0.2, h, w)
                    crop = crop_and_resize(
                        torch.from_numpy(np.asarray(rgb, np.float32)), eb,
                        crop_size)[0]
                    crops.append(crop.numpy().astype(np.uint8))
                    keys.append((int(ep), int(gti[k])))
    return crops, keys


def caption_crops(params: dict, crops: Sequence[np.ndarray], ccfg, device,
                  batch: int = 32) -> List[str]:
    """Greedy captions of `crops`, `batch` at a time."""
    from .models.captioner import generate
    from .models.tokenizer import default_tokenizer

    tok = default_tokenizer(ccfg.text.vocab_size)
    arr, out = np.stack(crops), []
    for i in range(0, len(arr), batch):
        t, _, _ = generate(params, torch.from_numpy(arr[i:i + batch]).to(
            device), ccfg)
        out += [tok.decode(x) for x in t.cpu().numpy()]
    return out


def group_by_key(captions: Sequence[str], keys: Sequence) -> Dict:
    groups: Dict = {}
    for cap, key in zip(captions, keys):
        groups.setdefault(key, []).append(cap)
    return groups


def consistency(captions: Sequence[str], keys: Sequence, encoder,
                min_views: int) -> Tuple[float, int]:
    """The mean over objects with at least `min_views` views of the mean
    pairwise cosine of their captions' sentence embeddings, and the number
    of such objects (0.0 where there is none)."""
    from .utils.metrics import mean_pairwise_cosine

    vals = [mean_pairwise_cosine(encoder.encode(caps))
            for caps in group_by_key(captions, keys).values()
            if len(caps) >= min_views]
    return (float(np.mean(vals)) if vals else 0.0), len(vals)


def accuracy(params: dict, crops: Sequence[np.ndarray], caps: Sequence[str],
             classes: Sequence[int], ccfg, encoder, device
             ) -> Tuple[float, float]:
    """Greedy captions of labelled crops: (the share naming the class's
    first word, the mean cosine of their embeddings to the references')."""
    from .config import CLASS_NAMES

    preds = caption_crops(params, crops, ccfg, device, batch=len(crops))
    hits = sum(1 for p, c in zip(preds, classes)
               if CLASS_NAMES[c].split()[0] in p)
    cos = float(np.mean(np.sum(encoder.encode(preds) * encoder.encode(caps),
                               axis=1)))
    return hits / max(len(preds), 1), cos


def run_seed(cfg, args, seed: int, device) -> dict:
    from .agents import get_trainer
    from .labeling.pseudocaptioner import PseudoCaptioner
    from .models.sbert import SentenceEncoder
    from .models.tokenizer import default_tokenizer
    from .selfcheck_loop import train_stack, trained_perceiver
    from .selfcheck_training import collect as collect_caps
    from .train.captioner_train import train_step

    rng = np.random.default_rng(seed)
    ccfg = cfg.captioner
    tok = default_tokenizer(ccfg.text.vocab_size)

    # ---- phase 0: the perception stack on simulator ground truth --------
    t0 = time.time()
    det_params, state, _, cap_loss = train_stack(
        cfg, args.det_steps, args.cap_steps, device, rng=rng,
        seed0=seed * 10, init_seed=seed, lr=args.lr)
    print(f"[cycle s{seed}] stack trained ({time.time() - t0:.0f}s, "
          f"cap loss {cap_loss:.3f})", flush=True)

    # ---- phase 1: explore and record (fresh scenes) ---------------------
    t0 = time.time()
    obs_dir = os.path.join(args.workdir, f"seed{seed}")
    ecfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, scene_seed=7000 + 100 * seed),
        runtime=dataclasses.replace(cfg.runtime, obs_dir=obs_dir,
                                    save_gt_obs=True))
    perceiver = trained_perceiver(ecfg, det_params, state.params, device)
    trainer = get_trainer("goalexplorationbaseline-v0")(
        ecfg, perceiver=perceiver, device=device)
    trainer.generate(args.explore_steps)
    trainer.envs.close()
    print(f"[cycle s{seed}] explored {args.explore_steps} steps "
          f"({time.time() - t0:.0f}s)", flush=True)

    # ---- phase 2: per-view crops per object from the store --------------
    crops, keys = view_crops(obs_dir, cfg.detector.image_size,
                             ccfg.vision.image_size)
    if len(crops) < 4:
        return {"seed": seed, "error": "too few recorded views"}
    enc = SentenceEncoder.create(0, cfg.sentence_encoder, device)
    enc.params = perceiver.params.sbert
    caps_before = caption_crops(state.params, crops, ccfg, device)
    cons_before, n_objects = consistency(caps_before, keys, enc,
                                         args.min_views)
    # labelled unseen-scene crops (scene seeds 9000..)
    acc_crops, acc_caps, acc_cls = collect_caps(cfg, 3, 8, 9000, 48, device)
    acc_before, cos_gt_before = accuracy(state.params, acc_crops, acc_caps,
                                         acc_cls, ccfg, enc, device)

    # ---- phase 3: consensus pseudo-captions ------------------------------
    pc = PseudoCaptioner(cfg, method=args.method, perceiver=perceiver,
                         device=device)
    pseudo = pc.consensus(group_by_key(caps_before, keys))

    # ---- phase 4: fine-tune on (view crop, object pseudo-caption) -------
    ft_caps = [pseudo.get(f"{ep}_{obj}") for ep, obj in keys]
    keep = [i for i, c in enumerate(ft_caps) if c]
    ft_imgs = torch.from_numpy(np.stack([crops[i] for i in keep])).to(device)
    ft_tokens = torch.from_numpy(np.asarray(tok.encode_batch(
        [ft_caps[i] for i in keep], ccfg.text.context_length))).to(device)
    key_ids: Dict = {}
    ft_oids = torch.tensor([key_ids.setdefault(keys[i], len(key_ids))
                            for i in keep], dtype=torch.int32, device=device)
    t0 = time.time()
    bsz = min(args.ft_batch, len(keep))
    ones = torch.ones(bsz, dtype=torch.bool, device=device)
    for _ in range(args.finetune_steps):
        sel = torch.from_numpy(rng.choice(len(keep), bsz, replace=False)
                               ).to(device)
        state, _ = train_step(state, ft_imgs[sel], ft_tokens[sel],
                              ft_oids[sel], ones, ccfg, lr=args.lr,
                              triplet_weight=args.triplet_weight)
    print(f"[cycle s{seed}] fine-tuned {args.finetune_steps} steps on "
          f"{len(keep)} pseudo-captioned views ({time.time() - t0:.0f}s)",
          flush=True)

    # ---- phase 5: the same views after ----------------------------------
    caps_after = caption_crops(state.params, crops, ccfg, device)
    cons_after, _ = consistency(caps_after, keys, enc, args.min_views)
    acc_after, cos_gt_after = accuracy(state.params, acc_crops, acc_caps,
                                       acc_cls, ccfg, enc, device)
    return {
        "seed": seed,
        "objects": n_objects,
        "views": len(crops),
        "consistency_before": round(cons_before, 4),
        "consistency_after": round(cons_after, 4),
        "consistency_delta": round(cons_after - cons_before, 4),
        "gt_class_accuracy_before": round(acc_before, 3),
        "gt_class_accuracy_after": round(acc_after, 3),
        "gt_cosine_before": round(cos_gt_before, 4),
        "gt_cosine_after": round(cos_gt_after, 4),
        "example_pseudo": next(iter(pseudo.values()), None),
        "example_before": caps_before[0],
        "example_after": caps_after[0],
    }


def summary(results: Sequence[dict], args) -> dict:
    deltas = [r["consistency_delta"] for r in results
              if "consistency_delta" in r]
    cos_deltas = [r["gt_cosine_after"] - r["gt_cosine_before"]
                  for r in results if "gt_cosine_after" in r]
    return {
        "preset": args.preset,
        "seeds": len(results),
        "triplet_weight": args.triplet_weight,
        "explore_envs": args.explore_envs,
        "mean_consistency_delta": (round(float(np.mean(deltas)), 4)
                                   if deltas else None),
        "mean_gt_cosine_delta": (round(float(np.mean(cos_deltas)), 4)
                                 if cos_deltas else None),
        "all_positive": bool(deltas and all(d > 0 for d in deltas)),
        # coherent AND accurate: consistency rises while the GT cosine
        # holds
        "coherent_and_accurate": bool(
            deltas and cos_deltas and all(d > 0 for d in deltas)
            and float(np.mean(cos_deltas)) >= -0.005),
        "per_seed": list(results),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="base", choices=["tiny", "base"])
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--det-steps", type=int, default=400)
    ap.add_argument("--cap-steps", type=int, default=300)
    ap.add_argument("--finetune-steps", type=int, default=200)
    ap.add_argument("--explore-steps", type=int, default=48)
    ap.add_argument("--min-views", type=int, default=2)
    ap.add_argument("--method", default="sbert",
                    choices=["sbert", "tfidf", "clip"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--triplet-weight", type=float, default=0.0,
                    help="contrastive triplet loss weight during the "
                         "pseudo-caption fine-tune")
    ap.add_argument("--ft-batch", type=int, default=16)
    ap.add_argument("--explore-envs", type=int, default=2,
                    help="parallel exploration envs = distinct scenes in "
                         "the pseudo-caption pool")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "cycle_store"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("selfcheck_cycle: no CUDA device (pass --device cpu to run "
              "on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config

    cfg = load_config(args.preset, overrides=[
        "sim.num_objects=8", "sim.scene_size=8.0", "map.voxel_size=0.1",
        f"runtime.num_envs={args.explore_envs}", "ppo.replanning_steps=8",
        "detector.score_threshold=0.2",
    ] + list(args.overrides))
    dev = torch.device(args.device)
    results = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        results.append(run_seed(cfg, args, seed, dev))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(summary(results, args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
