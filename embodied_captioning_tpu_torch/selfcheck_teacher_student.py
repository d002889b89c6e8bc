"""Teacher-student self-check: a trained detector (the teacher, a
`selfcheck_detector --save` artifact) pseudo-labels an unlabelled scene
pool through each consensus mode (vanilla, soft, semantic_map and its
hybrid and fine variants), a student trains from scratch on each mode's
pseudo-labels with the matching loss head, and teacher and students are
evaluated on the fixed unseen-scene corpus, on the GPU (or on the CPU with
--device cpu).

The counterpart of the JAX package's `scripts/selfcheck_teacher_student.py`,
with its arguments (and `--device`) and its JSON line. The pool's frames
keep depth and camera pose (`collect_with_pose`: the semantic_map modes
fuse in 3D) and their ground truth, used only to give predictions their
association ids (IoU > 0.3), never as labels (`label_pool`). A student
trains on the device corpus with `ops.augment` (crop, flip, jitter) drawn
from a `torch.Generator` and batches drawn by the numpy generator, under
clip 5 + Adam on a warmup-cosine schedule (`selfcheck_detector.train`).
`--generations` > 1 makes each mode's student the next teacher of the
same pool. Weights start from seeded `torch.Generator`s (numbers differ
from jax.random).

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_teacher_student \\
      --teacher det.pkl [--modes vanilla,soft,semantic_map] \\
      [--generations 1] [--scenes 128] [--pool-seed 2000] [--steps 12000] \\
      [--batch 16] [--lr 1e-3] [--seed 0] [--eval-cache c.npz] \\
      [--teacher-threshold 0.5] [--device cpu] [key.path=value ...]
The teacher artifact comes from `selfcheck_detector --save`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

FIELDS = ("boxes", "classes", "scores", "logits", "valid", "masks",
          "object_ids")


def collect_with_pose(cfg, episodes: int, steps_per_ep: int, seed0: int,
                      rng, device, chunk: int = 24) -> List[dict]:
    """`selfcheck_detector.collect`'s frames with depth and camera pose
    kept (the semantic_map consensus fuses in 3D): walks of `episodes`
    scenes (seeds seed0..) drawn from `rng`, rendered `chunk` at a time;
    rgb, boxes and masks (bilinear, >= 0.5, uint8) at the detector's
    input, depth subsampled to it. Returns per frame {"episode", "rgb",
    "depth", "pose", "gt": numpy ground-truth fields with object ids}."""
    from .envs.sim import gt_detections
    from .ops.image import resize_bilinear
    from .selfcheck_training import min_pixels, render_jobs, walk

    sims, jobs = walk(cfg, episodes, steps_per_ep, seed0, rng, device)
    n_det = cfg.detector.max_detections
    size = cfg.detector.image_size
    sensor = cfg.sensors.height
    min_px = min_pixels(cfg)
    frames = []
    for i in range(0, len(jobs), chunk):
        part = jobs[i:i + chunk]
        out = render_jobs(sims, part, cfg, device)
        for b, (ep, pose) in enumerate(part):
            det = gt_detections(out["instances"][b], out["classes"][b],
                                max_instances=n_det, min_pixels=min_px)
            rgb, depth = out["rgb"][b], out["depth"][b]
            if sensor != size:
                rgb = torch.clamp(resize_bilinear(rgb.float(), size, size),
                                  0, 255).to(torch.uint8)
                depth = depth[::sensor // size, ::sensor // size]
                det = det.replace(boxes=det.boxes * (size / sensor))
            m = resize_bilinear(det.masks.permute(1, 2, 0), size, size)
            det = det.replace(masks=(m >= 0.5).permute(2, 0, 1).to(
                torch.uint8))
            frames.append({
                "episode": ep, "rgb": rgb.cpu().numpy(),
                "depth": depth.cpu().numpy(), "pose": pose,
                "gt": {f: getattr(det, f).cpu().numpy() for f in FIELDS}})
    return frames


def label_pool(teacher: dict, pool: Sequence[dict], t_cfg, batch: int,
               device) -> list:
    """The teacher's detections of every pool frame as `Sample`s (full-frame
    masks > 0.5), each valid one given an association id: episode * 1000 +
    the ground-truth instance it overlaps with IoU > 0.3, else a fresh id
    from 5,000,000."""
    from .labeling.datasets import Sample
    from .mapping.matching import IdAllocator
    from .models import detector as DET
    from .ops.detections import pairwise_iou

    alloc = IdAllocator()
    out = []
    for i in range(0, len(pool), batch):
        part = pool[i:i + batch]
        images = torch.from_numpy(np.stack([f["rgb"] for f in part])).to(
            device)
        det = DET.forward(teacher, images, t_cfg, with_masks=True)
        fmasks = (DET.full_masks(det, t_cfg.image_size) > 0.5).cpu().numpy()
        host = {f: (lambda x: (x.float() if x.dtype == torch.bfloat16
                               else x).cpu().numpy())(getattr(det, f))
                for f in ("boxes", "classes", "logits", "valid", "scores")}
        for b, f in enumerate(part):
            n = host["valid"].shape[1]
            pred = Sample(
                image=f["rgb"], boxes=host["boxes"][b].copy(),
                classes=host["classes"][b].copy(),
                logits=host["logits"][b].copy(),
                masks=fmasks[b].astype(np.float32),
                valid=host["valid"][b].copy(),
                scores=host["scores"][b].copy(),
                object_ids=np.full((n,), -1, np.int64),
                episode=int(f["episode"]), step=i + b,
                depth=f["depth"], pose=f["pose"])
            gt = f["gt"]
            iou = pairwise_iou(torch.from_numpy(pred.boxes),
                               torch.from_numpy(gt["boxes"])).numpy()
            iou = iou * np.asarray(gt["valid"])[None, :]
            for j in np.nonzero(pred.valid)[0]:
                k = int(np.argmax(iou[j])) if iou.shape[1] else 0
                if iou.shape[1] and iou[j, k] > 0.3:
                    pred.object_ids[j] = (f["episode"] * 1000
                                          + int(gt["object_ids"][k]))
                else:
                    pred.object_ids[j] = 5_000_000 + alloc.take(1)[0]
            out.append(pred)
    return out


def clone_samples(src: Sequence) -> list:
    return [dataclasses.replace(
        s, boxes=s.boxes.copy(), classes=s.classes.copy(),
        logits=s.logits.copy(), valid=s.valid.copy(),
        scores=None if s.scores is None else s.scores.copy(),
        object_ids=s.object_ids.copy()) for s in src]


def graft_frame_masks(pseudo: list, src: Sequence) -> list:
    """semantic_map_hybrid: keep the raytraced consensus classes and
    logits, graft the teacher's frame-level boxes and masks onto the
    pseudo-instances they overlap with IoU > 0.3."""
    from .ops.detections import pairwise_iou

    by_key = {(s.episode, s.step): s for s in src}
    for p in pseudo:
        s = by_key.get((p.episode, p.step))
        if s is None or not s.valid.any():
            continue
        iou = pairwise_iou(torch.from_numpy(np.asarray(p.boxes)),
                           torch.from_numpy(np.asarray(s.boxes))).numpy()
        iou = iou * s.valid[None, :]
        for j in np.nonzero(p.valid)[0]:
            k = int(np.argmax(iou[j])) if iou.shape[1] else 0
            if iou.shape[1] and iou[j, k] > 0.3:
                p.boxes[j] = s.boxes[k]
                p.masks[j] = s.masks[k]
    return pseudo


# the consensus stages never predict, so no perceiver is built: a truthy
# sentinel stands in for one
_NO_PERCEIVER = object()


def consensus(mode: str, src: Sequence, cfg, device):
    """Mode `mode`'s pseudo-labelled samples of `src` and the student's
    loss head: vanilla -> ce, soft -> soft, the semantic_map family -> ce
    (one full-size voxel map per episode, freed before the next;
    semantic_map_fine at 2.5 cm voxels)."""
    from .config import merge
    from .labeling.pseudolabeler import (
        SemanticMapConsensusLabeler, SoftConsensusLabeler,
        VanillaConsensusLabeler,
    )

    if mode == "vanilla":
        return VanillaConsensusLabeler(
            cfg, perceiver=_NO_PERCEIVER, device=device).get_pseudo_labels(
                clone_samples(src)), "ce"
    if mode == "soft":
        return SoftConsensusLabeler(
            cfg, perceiver=_NO_PERCEIVER, device=device).get_pseudo_labels(
                clone_samples(src)), "soft"
    if mode in ("semantic_map", "semantic_map_hybrid", "semantic_map_fine"):
        c = cfg
        if mode == "semantic_map_fine":
            c = merge(cfg, {"map": {"voxel_size": 0.025,
                                    "grid": (512, 128, 512)}})
        pseudo, by_ep = [], {}
        for s in src:
            by_ep.setdefault(s.episode, []).append(s)
        for ep in sorted(by_ep):
            lab = SemanticMapConsensusLabeler(c, perceiver=_NO_PERCEIVER,
                                              device=device)
            pseudo += lab.get_pseudo_labels(clone_samples(by_ep[ep]))
            lab.global_maps.clear()
        if mode == "semantic_map_hybrid":
            pseudo = graft_frame_masks(pseudo, src)
        return pseudo, "ce"
    raise ValueError(mode)


def to_frames(pseudo: Sequence) -> list:
    """Pseudo-labelled samples as training frames (rgb, numpy ground
    truth; masks > 0.5 as uint8, scores the validity where absent)."""
    return [(s.image, {
        "boxes": np.asarray(s.boxes, np.float32),
        "classes": np.asarray(s.classes, np.int32),
        "scores": np.asarray(s.scores if s.scores is not None else s.valid,
                             np.float32),
        "logits": np.asarray(s.logits, np.float32),
        "valid": np.asarray(s.valid, bool),
        "masks": (np.asarray(s.masks) > 0.5).astype(np.uint8)})
        for s in pseudo]


def train_student(frames: Sequence, head: str, dcfg, steps: int,
                  batch: int, lr: float, seed: int, rng, device,
                  params=None) -> dict:
    """A student from scratch (a generator seeded `seed + 1`, or `params`
    where handed) on the device corpus `frames`: `steps` steps of clip 5 +
    Adam on the warmup-cosine schedule (0 -> lr over min(500, steps // 10)
    steps, down to lr / 20), batches drawn by `rng`, each augmented
    (crop, flip, jitter) from a generator seeded `seed + 7`."""
    from .models import detector as DET
    from .selfcheck_detector import train
    from .train.optim import warmup_cosine_decay_schedule

    if params is None:
        params = DET.init_detector(
            torch.Generator(device=device).manual_seed(seed + 1), dcfg,
            device)
    sched = warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 10),
                                         steps, lr / 20)
    gen = torch.Generator(device=device).manual_seed(seed + 7)

    def log(msg: str) -> None:  # the loss at step 0, then every 2000
        step = int(msg.split()[1].rstrip(":"))
        if step == 0 or (step + 1) % 2000 == 0:
            print(f"  [{head}] {msg.strip()}", flush=True)

    params, _, _ = train(params, frames, dcfg, steps, batch, sched, head,
                         rng, device, augment=True, augment_crop=True,
                         device_train=True, generator=gen, log=log)
    return params


def load_teacher(path: str, device):
    """(teacher params: the artifact's EMA weights where they were the
    better, else its raw ones; its training config as a dict)."""
    from .params import from_jax, load_pickle

    art = load_pickle(path)
    best = art.get("ema") if art.get("best") == "ema" else None
    return from_jax(best or art["params"], device), art["train_cfg"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher", required=True,
                    help="pickle artifact from selfcheck_detector --save")
    ap.add_argument("--modes", default="vanilla,soft,semantic_map",
                    help="consensus modes; semantic_map_hybrid grafts the "
                         "teacher's frame masks and boxes onto the "
                         "raytraced instances, semantic_map_fine raytraces "
                         "2.5 cm voxels")
    ap.add_argument("--generations", type=int, default=1,
                    help=">1: each student becomes the next generation's "
                         "teacher of the same pool")
    ap.add_argument("--scenes", type=int, default=128,
                    help="unlabelled scene pool (seeds --pool-seed..)")
    ap.add_argument("--pool-seed", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-cache",
                    default=os.path.join(tempfile.gettempdir(),
                                         "det_eval_corpus_128px.npz"))
    ap.add_argument("--teacher-threshold", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("selfcheck_teacher_student: no CUDA device (pass --device cpu "
              "to run on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config, merge
    from .selfcheck_detector import (
        collect, corpus_checksum, eval_map, load_corpus, save_corpus,
    )

    dev = torch.device(args.device)
    teacher, train_cfg = load_teacher(args.teacher, dev)
    cfg = load_config("tiny", overrides=list(args.overrides))
    # the full-size voxel map: the semantic_map consensus fuses the whole
    # room
    cfg = merge(cfg, {"detector": train_cfg,
                      "map": {"grid": (256, 64, 256), "max_objects": 128}})
    dcfg = cfg.detector
    rng = np.random.default_rng(args.seed)

    if os.path.exists(args.eval_cache):
        test_frames = load_corpus(args.eval_cache)
    else:
        test_frames = collect(cfg, 8, 12, 500, np.random.default_rng(500),
                              dev)
        save_corpus(args.eval_cache, test_frames)
    eval_sha = corpus_checksum(test_frames)
    print(f"[ts] eval corpus {len(test_frames)} frames sha {eval_sha}",
          flush=True)
    eval_cfg = dataclasses.replace(dcfg, score_threshold=0.05)

    def score(params) -> float:
        return eval_map(params, test_frames, eval_cfg, args.batch, dev)

    teacher_map = score(teacher)
    print(f"[ts] teacher unseen mAP@50 {teacher_map:.4f}", flush=True)

    t0 = time.time()
    pool = collect_with_pose(cfg, args.scenes, 16, args.pool_seed, rng, dev)
    print(f"[ts] pool {len(pool)} frames ({time.time() - t0:.0f}s)",
          flush=True)
    t_cfg = dataclasses.replace(dcfg, score_threshold=args.teacher_threshold)
    t0 = time.time()
    samples = label_pool(teacher, pool, t_cfg, args.batch, dev)
    n_pred = int(sum(s.valid.sum() for s in samples))
    print(f"[ts] teacher labeled {n_pred} detections over {len(samples)} "
          f"frames ({time.time() - t0:.0f}s)", flush=True)

    results: Dict = {"teacher_map50": round(teacher_map, 4),
                     "eval_sha": eval_sha, "pool_frames": len(samples),
                     "teacher_detections": n_pred, "steps": args.steps,
                     "scenes": args.scenes, "generations": args.generations}
    for mode in args.modes.split(","):
        cur = samples  # the first teacher's labels, shared by every mode
        for gen in range(1, args.generations + 1):
            t0 = time.time()
            pseudo, head = consensus(mode, cur, cfg, dev)
            pseudo = [p for p in pseudo if p.valid.any()]
            tag = (f"student_{mode}_map50" if gen == 1
                   else f"student_{mode}_gen{gen}_map50")
            if not pseudo:
                results[tag] = None
                break
            student = train_student(to_frames(pseudo), head, dcfg,
                                    args.steps, args.batch, args.lr,
                                    args.seed, rng, dev)
            m = score(student)
            results[tag] = round(m, 4)
            print(f"[ts] mode={mode} gen={gen}: student unseen mAP@50 "
                  f"{m:.4f} ({time.time() - t0:.0f}s)", flush=True)
            if gen < args.generations:
                cur = label_pool(student, pool, t_cfg, args.batch, dev)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
