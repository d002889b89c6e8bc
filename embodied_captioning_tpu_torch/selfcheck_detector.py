"""Detector learning self-check: train the FPN/RPN/ROI detector on
simulator ground truth and measure its mAP, on the GPU (or on the CPU with
--device cpu).

The counterpart of the JAX package's `scripts/selfcheck_detector.py`, with
its arguments (and `--device`) and its JSON line. Frames of labelled
scenes are rendered, their ground truth (boxes, classes, full-frame masks)
resized to the detector's input on the device; the detector trains with
`detector_loss` under clip-by-global-norm(5) then Adam (constant or
warmup-cosine step size), on host batches (optionally flipped, jittered
and zoom-cropped with numpy draws, the JAX script's) or with
`--device-train` on a corpus kept on the device and augmented there
(`ops/augment`, drawn from a `torch.Generator`), with an optional EMA of
the weights. It reports mAP@50 on unseen scenes before and after, on
training frames, and the mask IoU of matched detections; `--calibrate`
adds the frozen-affine artifact and its folded int8 serving form, `--save`
writes the artifact as numpy trees in the JAX package's layout. Weights
start from a seeded `torch.Generator` (numbers differ from jax.random);
the walks and batch order are numpy draws, the same in both packages.

Flags of the JAX script whose modules are not ported exit with code 2:
`--tta` (ROADMAP A.14), `--eval-wide`, `--eval-wide-cache`,
`--eval-serving`, `--ckpt`, `--affine-finetune`, `--pack-masks`
(ROADMAP A.15).

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_detector \\
      [--preset tiny] [--steps 300] [--episodes 6] [--head ce] \\
      [--device-train [--augment [--augment-crop]] [--ema D] \\
       [--scan-steps K]] [--calibrate] [--save art.pkl] [--device cpu] \\
      [key.path=value ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Frame = Tuple[np.ndarray, Dict[str, np.ndarray]]
FIELDS = ("boxes", "classes", "scores", "logits", "valid", "masks")
MAX_GRAD_NORM = 5.0


def collect(cfg, episodes: int, steps_per_ep: int, seed0: int, rng, device,
            chunk: Optional[int] = None,
            skip_seeds: Tuple[int, int] = ()) -> List[Frame]:
    """Frames of `episodes` scenes (seeds seed0.., those in the
    `skip_seeds` block (start, n) moved past it), `steps_per_ep` walk
    positions each, the walks drawn from `rng`. `chunk` frames are
    rendered and resized a time; by default as many as keep ~1.5 GB of
    full-resolution float32 instance masks (4-32)."""
    if chunk is None:
        px = cfg.sensors.height * cfg.sensors.width
        n_det = cfg.detector.max_detections
        chunk = max(4, min(32, int(1.5e9 / (px * n_det * 4))))
    return _collect(cfg, episodes, steps_per_ep, seed0, rng, device, chunk,
                    skip_seeds)


def _collect(cfg, episodes, steps_per_ep, seed0, rng, device, chunk,
             skip_seeds) -> List[Frame]:
    """Walk every sim on the host, then render the (scene, pose) pairs in
    chunks; rgb, boxes and masks are resized to the detector's input on
    the device (masks by bilinear weights, then >= 0.5, as uint8) before
    one copy to the host a chunk. Returns (rgb [S, S, 3] uint8, ground
    truth as numpy arrays) a frame."""
    from .envs.sim import gt_detections
    from .ops.image import resize_bilinear
    from .selfcheck_training import min_pixels, render_jobs, walk

    sims, jobs = walk(cfg, episodes, steps_per_ep, seed0, rng, device,
                      skip_seeds)
    n_det = cfg.detector.max_detections
    size = cfg.detector.image_size
    sensor = cfg.sensors.height
    min_px = min_pixels(cfg)
    scale = size / sensor
    frames: List[Frame] = []
    t0 = time.time()
    for i in range(0, len(jobs), chunk):
        out = render_jobs(sims, jobs[i:i + chunk], cfg, device)
        for b in range(out["rgb"].shape[0]):
            det = gt_detections(out["instances"][b], out["classes"][b],
                                max_instances=n_det, min_pixels=min_px)
            rgb = out["rgb"][b]
            boxes = det.boxes
            if sensor != size:
                rgb = torch.clamp(resize_bilinear(rgb.float(), size, size),
                                  0, 255).to(torch.uint8)
                boxes = boxes * scale
            m = resize_bilinear(det.masks.permute(1, 2, 0), size, size)
            masks = (m >= 0.5).permute(2, 0, 1).to(torch.uint8)
            gt = det.replace(boxes=boxes, masks=masks)
            frames.append((rgb.cpu().numpy(), {
                f: getattr(gt, f).cpu().numpy() for f in FIELDS}))
        if i // chunk % 32 == 31:
            rate = len(frames) / (time.time() - t0)
            print(f"  [collect] {len(frames)}/{len(jobs)} frames "
                  f"({rate:.1f}/s)", flush=True)
    return frames


def save_corpus(path: str, frames: Sequence[Frame]) -> None:
    """One npz of the frames (rgb and the ground-truth fields), the JAX
    script's layout: either package loads the other's."""
    np.savez_compressed(path, rgb=np.stack([f[0] for f in frames]), **{
        k: np.stack([np.asarray(f[1][k]) for f in frames]) for k in FIELDS})


def load_corpus(path: str) -> List[Frame]:
    z = np.load(path)
    a = {k: z[k] for k in ("rgb",) + FIELDS}  # decompress each key once
    return [(a["rgb"][i], {k: a[k][i] for k in FIELDS})
            for i in range(a["rgb"].shape[0])]


def corpus_checksum(frames: Sequence[Frame]) -> str:
    """Content hash of rgb, boxes and validity (the JAX script's)."""
    h = hashlib.sha256()
    for rgb, det in frames:
        h.update(np.ascontiguousarray(rgb))
        h.update(np.ascontiguousarray(np.asarray(det["boxes"], np.float32)))
        h.update(np.ascontiguousarray(np.asarray(det["valid"])))
    return h.hexdigest()[:16]


def stack_detections(dets: Sequence[Dict[str, np.ndarray]], device):
    """Per-frame numpy ground truth -> batched `Detections` on `device`."""
    from .ops.detections import Detections

    return Detections(**{f: torch.from_numpy(np.stack(
        [np.asarray(d[f]) for d in dets])).to(device) for f in FIELDS})


def host_augment(rgb: np.ndarray, det: Dict[str, np.ndarray], rng,
                 crop: bool) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The JAX script's numpy augmentation of one frame, draw for draw:
    with `crop`, half the time a zoom-in crop (scale 0.55-0.95, nearest
    resampling of rgb and masks, boxes moved and clipped, boxes under 4
    pixels a side dropped); half the time a horizontal flip; always a
    brightness factor in [0.75, 1.25] and a shift in [-15, 15] a
    channel."""
    det = dict(det)
    if crop and rng.random() < 0.5:
        h0, w0 = rgb.shape[:2]
        s = rng.uniform(0.55, 0.95)
        ch, cw = max(int(h0 * s), 8), max(int(w0 * s), 8)
        oy = int(rng.integers(0, h0 - ch + 1))
        ox = int(rng.integers(0, w0 - cw + 1))
        yi = oy + (np.arange(h0) * ch) // h0
        xi = ox + (np.arange(w0) * cw) // w0
        rgb = rgb[yi][:, xi]
        bx = np.asarray(det["boxes"], np.float32)
        sx, sy = w0 / cw, h0 / ch
        nb = np.stack([
            np.clip((bx[:, 0] - ox) * sx, 0, w0),
            np.clip((bx[:, 1] - oy) * sy, 0, h0),
            np.clip((bx[:, 2] - ox) * sx, 0, w0),
            np.clip((bx[:, 3] - oy) * sy, 0, h0)], axis=1)
        det["valid"] = ((nb[:, 2] - nb[:, 0] >= 4) & (nb[:, 3] - nb[:, 1] >= 4)
                        & np.asarray(det["valid"]))
        det["boxes"] = nb
        det["masks"] = np.asarray(det["masks"])[:, yi][:, :, xi]
    if rng.random() < 0.5:
        w = rgb.shape[1]
        rgb = np.ascontiguousarray(rgb[:, ::-1])
        bx = np.asarray(det["boxes"])
        det["boxes"] = np.stack([w - bx[:, 2], bx[:, 1], w - bx[:, 0],
                                 bx[:, 3]], axis=1)
        det["masks"] = np.asarray(det["masks"])[:, :, ::-1]
    rgb = np.clip(rgb.astype(np.float32) * rng.uniform(0.75, 1.25)
                  + rng.uniform(-15, 15, size=(1, 1, 3)),
                  0, 255).astype(np.uint8)
    return rgb, det


def batch_of(frames: Sequence[Frame], idx, size: int, device, rng=None,
             augment: bool = False, augment_crop: bool = False):
    """(uint8 images [B, size, size, 3], batched ground truth) of frames
    `idx` on `device`, augmented on the host with `rng`'s draws; frames
    not at `size` are resized (boxes scaled)."""
    from .ops.image import resize_bilinear

    imgs, dets = [], []
    for i in idx:
        rgb, det = frames[i]
        if augment:
            rgb, det = host_augment(rgb, det, rng, augment_crop)
        img = torch.from_numpy(np.ascontiguousarray(rgb)).to(device)
        if rgb.shape[0] != size:
            scale = size / rgb.shape[0]
            img = torch.clamp(resize_bilinear(img.float(), size, size),
                              0, 255).to(torch.uint8)
            det = dict(det, boxes=np.asarray(det["boxes"], np.float32)
                       * np.float32(scale))
        imgs.append(img)
        dets.append({k: np.ascontiguousarray(v) for k, v in det.items()})
    return torch.stack(imgs), stack_detections(dets, device)


def loss_and_grads(params: dict, images: torch.Tensor, gt, dcfg,
                   head: str = "ce"):
    """(gradients as a tree like `params`, loss, aux) of `detector_loss`;
    leaves the loss does not reach get zeros."""
    from .models.detector import detector_loss
    from .train.optim import value_and_grad

    loss, aux, grads = value_and_grad(
        lambda p: detector_loss(p, images, gt, dcfg, head=head), params)
    return grads, loss, aux


def train_step(params: dict, opt, images: torch.Tensor, gt, dcfg, head: str,
               lr_at: Callable[[int], float]):
    """One step of clip-by-global-norm(5) then Adam at the step size
    `lr_at(count)` (count: the optimizer's steps so far, as optax's
    schedule reads it): (params, optimizer state, loss)."""
    from .train.optim import adam_update

    grads, loss, _ = loss_and_grads(params, images, gt, dcfg, head)
    params, opt = adam_update(params, opt, grads, lr_at(opt.count),
                              MAX_GRAD_NORM)
    return params, opt, loss


def train(params: dict, frames: Sequence[Frame], dcfg, steps: int,
          batch: int, lr_at: Callable[[int], float], head: str, rng, device,
          augment: bool = False, augment_crop: bool = False,
          device_train: bool = False, ema: float = 0.0, scan_steps: int = 1,
          generator: Optional[torch.Generator] = None,
          log: Callable[[str], None] = print):
    """The JAX script's two training loops. Host: per step, a batch drawn
    without replacement by `rng`, augmented on the host (`batch_of`); the
    loss read back every step. `device_train`: the corpus on the device
    once; gathers, `ops.augment` (draws from `generator`) and the step
    there, with an EMA of the weights at decay `ema` (> 0); the loss read
    back only at the log points, every `scan_steps` steps at most.
    Returns (params, EMA params, {step: loss} of the read-backs)."""
    from .ops.augment import augment_batch
    from .train.optim import adam_init, tree_map

    opt = adam_init(params)
    ema_params = params
    read: Dict[int, float] = {}
    size = dcfg.image_size
    if not device_train:
        for s in range(steps):
            idx = rng.choice(len(frames), batch, replace=False)
            images, gt = batch_of(frames, idx, size, device, rng, augment,
                                  augment_crop)
            params, opt, loss = train_step(params, opt, images, gt, dcfg,
                                           head, lr_at)
            read[s] = float(loss)
            if s % 50 == 0:
                log(f"  step {s}: loss={read[s]:.3f}")
        return params, ema_params, read

    data_rgb = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    data_det = stack_detections([f[1] for f in frames], device)
    k_scan, s = max(1, scan_steps), 0
    while s < steps:
        k = min(k_scan, steps - s)
        idxs = torch.from_numpy(np.stack([
            rng.choice(len(frames), batch, replace=False)
            for _ in range(k)])).to(device)
        losses = []
        for i in range(k):
            images = data_rgb[idxs[i]]
            gt = data_det.replace(**{f: getattr(data_det, f)[idxs[i]]
                                     for f in FIELDS})
            if augment:
                images, gt = augment_batch(generator, images, gt,
                                           crop=augment_crop)
            params, opt, loss = train_step(params, opt, images, gt, dcfg,
                                           head, lr_at)
            if ema > 0:
                ema_params = tree_map(
                    lambda e, p: e * ema + p * (1.0 - ema), ema_params,
                    params)
            losses.append(loss)
        if s == 0 or (s // 50) != ((s + k) // 50) or s + k >= steps:
            vals = torch.stack(losses).cpu().tolist()  # the read-back
            read.update({s + i: v for i, v in enumerate(vals)})
            log(f"  step {s + k - 1}: loss={vals[-1]:.3f}")
        s += k
    return params, ema_params, read


def eval_map(params: dict, frames: Sequence[Frame], cfg_, batch: int,
             device) -> float:
    """mAP@50 of `forward` (no masks) over whole batches of `frames`."""
    from .models.detector import forward
    from .utils.metrics import evaluate_detections

    preds, gts = [], []
    for i in range(0, len(frames) - batch + 1, batch):
        images, gt = batch_of(frames, range(i, i + batch), cfg_.image_size,
                              device)
        det = forward(params, images, cfg_, with_masks=False)
        for b in range(images.shape[0]):
            preds.append(det.index(b))
            gts.append(gt.index(b))
    return evaluate_detections(preds, gts, cfg_.num_classes)["map"]


def eval_mask_iou(params: dict, frames: Sequence[Frame], dcfg, batch: int,
                  device) -> Tuple[float, int]:
    """Mean mask IoU of the detections that match a ground-truth box of
    their class at IoU >= 0.5 (its best match), and their count. Masks
    pasted at the detector's size; ground truth resampled to it by
    nearest neighbour."""
    from .models.detector import forward, full_masks

    size = dcfg.image_size
    tot, cnt = 0.0, 0
    for i in range(0, len(frames) - batch + 1, batch):
        images, gt = batch_of(frames, range(i, i + batch), size, device)
        det = forward(params, images, dcfg, with_masks=True)
        fm = (full_masks(det, size) > 0.5).cpu().numpy()   # [B, N, S, S]
        gmask = gt.masks.cpu().numpy()
        sel = (np.arange(size) * gmask.shape[-1]) // size
        gmasks = gmask[:, :, sel][:, :, :, sel] > 0.5
        gboxes, gvalid = gt.boxes.cpu().numpy(), gt.valid.cpu().numpy()
        gcls = gt.classes.cpu().numpy()
        dvalid, dcls = det.valid.cpu().numpy(), det.classes.cpu().numpy()
        dboxes = det.boxes.float().cpu().numpy()
        for b in range(images.shape[0]):
            for d in np.flatnonzero(dvalid[b]):
                pb, gb = dboxes[b, d], gboxes[b]
                ix1 = np.maximum(pb[0], gb[:, 0])
                iy1 = np.maximum(pb[1], gb[:, 1])
                ix2 = np.minimum(pb[2], gb[:, 2])
                iy2 = np.minimum(pb[3], gb[:, 3])
                inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
                pa = max((pb[2] - pb[0]) * (pb[3] - pb[1]), 1e-6)
                ga = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                iou = inter / np.maximum(pa + ga - inter, 1e-6)
                iou = np.where(gvalid[b] & (gcls[b] == int(dcls[b, d])),
                               iou, 0.0)
                g = int(np.argmax(iou))
                if iou[g] < 0.5:
                    continue
                pm, gm = fm[b, d], gmasks[b, g]
                union = np.logical_or(pm, gm).sum()
                if union == 0:
                    continue
                tot += np.logical_and(pm, gm).sum() / union
                cnt += 1
    return (tot / cnt if cnt else 0.0), cnt


# flags of the JAX script that need modules not ported yet
UNPORTED = (("tta", "--tta needs detector.forward_tta", "A.14"),
            ("eval_wide", "--eval-wide (the wide eval corpus)", "A.15"),
            ("eval_wide_cache", "--eval-wide-cache (the wide eval corpus)",
             "A.15"),
            ("eval_serving", "--eval-serving (the approximate top-k serving "
             "evaluation)", "A.15"),
            ("ckpt", "--ckpt needs utils/checkpoint.py", "A.15"),
            ("affine_finetune", "--affine-finetune", "A.15"),
            ("pack_masks", "--pack-masks", "A.15"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--head", default="ce")
    ap.add_argument("--split", default="scenes", choices=["scenes", "frames"],
                    help="test on unseen scenes, or on held-out frames of "
                         "the training scenes")
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--augment", action="store_true",
                    help="flip + colour-jitter training batches")
    ap.add_argument("--augment-crop", action="store_true",
                    help="add the zoom-in crop (0.55-0.95) to --augment")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay of an evaluation weight average "
                         "(--device-train only; 0 disables)")
    ap.add_argument("--device-train", action="store_true",
                    help="keep the training corpus on the device; gather, "
                         "augmentation and step run there")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed: init, walks, batch order, "
                         "augmentation draws")
    ap.add_argument("--eval-scenes", type=int, default=8)
    ap.add_argument("--eval-ep-steps", type=int, default=12)
    ap.add_argument("--eval-seed", type=int, default=500,
                    help="scene-seed origin of the unseen-scene eval corpus "
                         "(its walks draw from a generator of their own)")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--eval-cache", default=None,
                    help="npz of the eval corpus: collected and saved on "
                         "first use, loaded afterwards")
    ap.add_argument("--eval-wide", type=int, default=0)
    ap.add_argument("--eval-wide-seed", type=int, default=100000)
    ap.add_argument("--eval-wide-cache", default=None)
    ap.add_argument("--eval-serving", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate the GroupNorm weights to a frozen "
                         "affine norm; report its mAP and that of the "
                         "folded int8 serving form")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=4000)
    ap.add_argument("--affine-finetune", type=int, default=0)
    ap.add_argument("--pack-masks", action="store_true")
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="--device-train: train steps between two loss "
                         "read-backs at most")
    ap.add_argument("--train-cache", default=None,
                    help="npz of the training corpus: collected and saved "
                         "on first use, loaded afterwards")
    ap.add_argument("--save", default=None,
                    help="pickle of the trained artifact (numpy trees in "
                         "the JAX package's layout)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    for name, what, item in UNPORTED:
        if getattr(args, name):
            print(f"selfcheck_detector: {what}, not ported yet (ROADMAP "
                  f"{item})", file=sys.stderr)
            return 2
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("selfcheck_detector: no CUDA device (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config, to_dict
    from .models import detector as DET
    from .models.quantize import quantize_params
    from .params import to_numpy
    from .train.optim import warmup_cosine_decay_schedule

    cfg = load_config(args.preset, overrides=list(args.overrides))
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    if args.split == "scenes":
        if args.train_cache and os.path.exists(args.train_cache):
            train_frames = load_corpus(args.train_cache)
            print(f"[selfcheck-det] train corpus loaded from "
                  f"{args.train_cache}", flush=True)
        else:
            train_frames = collect(cfg, args.episodes, 16, 0, rng, dev,
                                   skip_seeds=(args.eval_seed,
                                               args.eval_scenes))
            if args.train_cache:
                save_corpus(args.train_cache, train_frames)
        if args.eval_cache and os.path.exists(args.eval_cache):
            test_frames = load_corpus(args.eval_cache)
        else:
            test_frames = collect(cfg, args.eval_scenes, args.eval_ep_steps,
                                  args.eval_seed,
                                  np.random.default_rng(args.eval_seed), dev)
            if args.eval_cache:
                save_corpus(args.eval_cache, test_frames)
        print(f"[selfcheck-det] eval corpus {len(test_frames)} frames, "
              f"sha {corpus_checksum(test_frames)}", flush=True)
    else:  # held-out frames of the same scenes
        all_frames = collect(cfg, args.episodes, 20, 0, rng, dev)
        order = rng.permutation(len(all_frames))
        n_test = max(8, len(all_frames) // 6)
        test_frames = [all_frames[i] for i in order[:n_test]]
        train_frames = [all_frames[i] for i in order[n_test:]]
    print(f"[selfcheck-det] {len(train_frames)} train / "
          f"{len(test_frames)} test frames ({time.time() - t0:.0f}s)",
          flush=True)

    dcfg = cfg.detector
    params = DET.init_detector(torch.Generator(device=dev).manual_seed(
        args.seed), dcfg, dev)
    if args.lr_schedule == "cosine":
        sched = warmup_cosine_decay_schedule(
            0.0, args.lr, min(500, args.steps // 10), args.steps,
            args.lr / 20)
    else:
        def sched(count: int) -> float:
            return args.lr
    # mAP sweeps the PR curve: evaluate at a low score threshold
    eval_cfg = dataclasses.replace(dcfg, score_threshold=0.05)
    map_before = eval_map(params, test_frames, eval_cfg, args.batch, dev)
    print(f"[selfcheck-det] mAP@50 before: {map_before:.4f}", flush=True)
    t0 = time.time()
    params, ema_params, losses = train(
        params, train_frames, dcfg, args.steps, args.batch, sched, args.head,
        rng, dev, augment=args.augment, augment_crop=args.augment_crop,
        device_train=args.device_train, ema=args.ema,
        scan_steps=args.scan_steps,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 7),
        log=lambda m: print(m, flush=True))
    first, last = losses[min(losses)], losses[max(losses)]
    map_after = eval_map(params, test_frames, eval_cfg, args.batch, dev)
    with_ema = args.device_train and args.ema > 0
    map_ema = (eval_map(ema_params, test_frames, eval_cfg, args.batch, dev)
               if with_ema else None)
    # serve the better of the raw and EMA weights on this corpus
    best_p = (ema_params if (map_ema is not None and map_ema >= map_after)
              else params)
    serving = {}
    affine_art = None
    if args.calibrate:
        calib = [batch_of(train_frames, range(i, i + args.batch),
                          dcfg.image_size, dev)[0]
                 for i in range(0, min(8 * args.batch, len(train_frames)
                                       - args.batch + 1), args.batch)]
        affine_art = DET.calibrate_affine(best_p, calib, dcfg)
        aff_cfg = dataclasses.replace(eval_cfg, norm="affine")
        serving["map50_affine"] = round(
            eval_map(affine_art, test_frames, aff_cfg, args.batch, dev), 4)
        served_cfg = dataclasses.replace(aff_cfg, pre_nms_topk=1024,
                                         num_proposals=128, approx_topk=True)
        served = quantize_params(DET.fold_affine(affine_art, served_cfg),
                                 min_size=64)
        serving["map50_served_int8"] = round(
            eval_map(served, test_frames, served_cfg, args.batch, dev), 4)
    if args.save:
        art = {
            "params": to_numpy(params),
            "ema": to_numpy(ema_params) if with_ema else None,
            "best": "ema" if best_p is not params else "raw",
            "affine": (to_numpy(affine_art) if affine_art is not None
                       else None),
            "train_cfg": to_dict(dcfg),
            "serving_cfg": to_dict(dataclasses.replace(
                dcfg, norm=("affine" if affine_art is not None
                            else dcfg.norm),
                pre_nms_topk=1024, num_proposals=128, approx_topk=True)),
            "recipe": vars(args),
        }
        with open(args.save, "wb") as fh:
            pickle.dump(art, fh)
        print(f"[selfcheck-det] artifact saved to {args.save}", flush=True)

    probe = train_frames[:len(test_frames)]
    map_train = eval_map(params, probe, eval_cfg, args.batch, dev)
    mask_iou, mask_n = eval_mask_iou(params, probe, dcfg, args.batch, dev)
    print(json.dumps({
        "seed": args.seed,
        "map50_after_ema": (round(map_ema, 4) if map_ema is not None
                            else None),
        "map50_after_tta": None, "map50_after_ema_tta": None,
        "eval_sha": (corpus_checksum(test_frames)
                     if args.split == "scenes" else None),
        "frames": len(train_frames), "steps": args.steps,
        "first_loss": round(first, 3), "last_loss": round(last, 3),
        "map50_before": round(map_before, 4),
        "map50_after": round(map_after, 4),
        "map50_train": round(map_train, 4),
        "mask_iou": round(float(mask_iou), 4),
        "mask_matched": mask_n,
        "train_seconds": round(time.time() - t0, 1),
        **serving,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
