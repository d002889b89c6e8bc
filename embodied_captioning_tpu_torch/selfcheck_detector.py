"""Detector learning self-check: train the detector (the FPN/RPN/ROI
stack, or with `detector.family=query` the Mask2Former-class set
predictor) on simulator ground truth and measure its mAP, on the GPU (or
on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/selfcheck_detector.py`, with
its arguments (and `--device`) and its JSON line. Frames of labelled
scenes are rendered, their ground truth (boxes, classes, full-frame masks)
resized to the detector's input on the device; the detector trains with
`detector_loss` under clip-by-global-norm(5) then Adam (constant or
warmup-cosine step size), on host batches (optionally flipped, jittered
and zoom-cropped with numpy draws, the JAX script's) or with
`--device-train` on a corpus kept on the device and augmented there
(`ops/augment`, drawn from a `torch.Generator`), with an optional EMA of
the weights; there `--pack-masks` keeps the corpus's masks bit-packed on
the device (unpacked after each batch's gather, exact) and `--ckpt`
writes a checkpoint every `--ckpt-every` steps and resumes from it when
the file exists. It reports mAP@50 on unseen scenes before and after, on
training frames, and the mask IoU of matched detections; `--tta` adds
the unseen-scene mAP of the horizontal-flip merge (`forward_tta`);
`--eval-wide N` adds a second unseen-scene corpus of N scenes from
`--eval-wide-seed` (cached in `--eval-wide-cache`), evaluated on the same
weights; `--eval-serving` adds the serving inference settings (1024
pre-NMS proposals, 128 kept) on the better of the raw and EMA weights,
float and int8 (the port's proposal top-k is exact, so its "approx" mAP
is the exact one, as the JAX package's is off the TPU); `--calibrate`
adds the frozen-affine artifact and its folded int8 serving form (with
`--tta`, also its merge), with `--affine-finetune N` after N steps of
training under the frozen affine norm (served where they score at least
as well); `--save` writes the artifact as numpy trees in the JAX
package's layout. Weights start from a seeded `torch.Generator` (numbers
differ from jax.random); the walks and batch order are numpy draws, the
same in both packages.

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_detector \\
      [--preset tiny] [--steps 300] [--episodes 6] [--head ce] \\
      [--device-train [--augment [--augment-crop]] [--ema D] \\
       [--scan-steps K] [--pack-masks] [--ckpt c.pkl [--ckpt-every N]]] \\
      [--tta] [--eval-wide N [--eval-wide-seed S] [--eval-wide-cache w.npz]] \\
      [--eval-serving] [--calibrate [--affine-finetune N]] \\
      [--save art.pkl] [--device cpu] [key.path=value ...]
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


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """uint8 {0, 1} masks [..., S] -> bits [..., S/8], the first pixel in
    the lowest bit (the JAX script's host bit-pack)."""
    return np.packbits(np.asarray(masks, np.uint8), axis=-1,
                       bitorder="little")


def unpack_masks(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_masks`, on the tensor's device: uint8 [..., S]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def save_checkpoint(path: str, step: int, params: dict, ema_params: dict,
                    opt, rng, generator: Optional[torch.Generator]) -> None:
    """The training state after `step` steps as numpy trees (the weights in
    the JAX package's layout): weights, their EMA, Adam's count and
    moments, the augmentation generator's and the batch draws' states.
    Written to a temporary file, then moved into place."""
    from .params import dump_tree, to_numpy

    state = {"step": step, "params": to_numpy(params),
             "ema": to_numpy(ema_params),
             "opt_state": {"count": opt.count, "mu": to_numpy(opt.mu),
                           "nu": to_numpy(opt.nu)},
             "generator": (None if generator is None
                           else generator.get_state().numpy()),
             "rng_state": rng.bit_generator.state}
    dump_tree(state, path)


def load_checkpoint(path: str, device, rng,
                    generator: Optional[torch.Generator]):
    """(params, EMA params, optimizer state, step) of `save_checkpoint`'s
    file; the batch draws and the generator continue from their saved
    states."""
    from .params import from_jax, load_pickle
    from .train.optim import AdamState

    ck = load_pickle(path)
    opt = ck["opt_state"]
    if generator is not None and ck["generator"] is not None:
        generator.set_state(torch.from_numpy(ck["generator"]))
    rng.bit_generator.state = ck["rng_state"]
    return (from_jax(ck["params"], device), from_jax(ck["ema"], device),
            AdamState(int(opt["count"]), from_jax(opt["mu"], device),
                      from_jax(opt["nu"], device)), int(ck["step"]))


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
          log: Callable[[str], None] = print, packed: bool = False,
          ckpt: Optional[str] = None, ckpt_every: int = 0):
    """The JAX script's two training loops. Host: per step, a batch drawn
    without replacement by `rng`, augmented on the host (`batch_of`); the
    loss read back every step. `device_train`: the corpus on the device
    once (with `packed`, its masks bit-packed, unpacked after each gather);
    gathers, `ops.augment` (draws from `generator`) and the step there,
    with an EMA of the weights at decay `ema` (> 0); the loss read back
    only at the log points, every `scan_steps` steps at most; with `ckpt`,
    resumed from that checkpoint where it exists and one written when a
    step group crosses a multiple of `ckpt_every`. Returns (params, EMA
    params, {step: loss} of the read-backs)."""
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
    data_det = stack_detections(
        [dict(f[1], masks=pack_masks(f[1]["masks"])) if packed else f[1]
         for f in frames], device)
    k_scan, s = max(1, scan_steps), 0
    if ckpt and os.path.exists(ckpt):
        params, ema_params, opt, s = load_checkpoint(ckpt, device, rng,
                                                     generator)
        log(f"[selfcheck-det] resumed from {ckpt} at step {s}")
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
            if packed:
                gt = gt.replace(masks=unpack_masks(gt.masks))
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
        if ckpt and ckpt_every and s // ckpt_every != (s + k) // ckpt_every:
            save_checkpoint(ckpt, s + k, params, ema_params, opt, rng,
                            generator)
            log(f"[selfcheck-det] checkpoint @ step {s + k}")
        s += k
    return params, ema_params, read


def affine_finetune(params: dict, frames: Sequence[Frame], dcfg, steps: int,
                    batch: int, lr: float, head: str, rng, device,
                    augment: bool = False, augment_crop: bool = False,
                    log: Callable[[str], None] = print):
    """`steps` steps of the detector under the frozen affine norm, from
    calibrated weights: clip-by-global-norm(5) then Adam on a warmup-cosine
    schedule from 0 to lr / 10 (warmup min(50, steps // 5)) and down to
    lr / 200, each batch drawn without replacement by `rng` (after the
    main loop's draws) and augmented on the host as the main loop's.
    Returns (params, the losses [steps])."""
    from .train.optim import adam_init, warmup_cosine_decay_schedule

    aff_cfg = dataclasses.replace(dcfg, norm="affine")
    sched = warmup_cosine_decay_schedule(0.0, lr / 10, min(50, steps // 5),
                                         steps, lr / 200)
    opt, losses = adam_init(params), []
    for s in range(steps):
        idx = rng.choice(len(frames), batch, replace=False)
        images, gt = batch_of(frames, idx, dcfg.image_size, device, rng,
                              augment, augment_crop)
        params, opt, loss = train_step(params, opt, images, gt, aff_cfg,
                                       head, sched)
        losses.append(loss)
        if s % 100 == 0:
            log(f"  [affine-ft] step {s}: loss={float(loss):.3f}")
    return params, torch.stack(losses).cpu().tolist() if losses else []


def eval_map(params: dict, frames: Sequence[Frame], cfg_, batch: int,
             device, tta: bool = False) -> float:
    """mAP@50 of `forward` (no masks) over whole batches of `frames`; of
    `forward_tta` (the horizontal-flip merge) with `tta`."""
    from .models.detector import forward, forward_tta
    from .utils.metrics import evaluate_detections

    preds, gts = [], []
    for i in range(0, len(frames) - batch + 1, batch):
        images, gt = batch_of(frames, range(i, i + batch), cfg_.image_size,
                              device)
        det = (forward_tta if tta else forward)(params, images, cfg_,
                                               with_masks=False)
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
    ap.add_argument("--eval-wide", type=int, default=0,
                    help="scenes of a second, wider unseen-scene eval "
                         "corpus evaluated on the same weights (0: off)")
    ap.add_argument("--eval-wide-seed", type=int, default=100000,
                    help="scene-seed origin of the wide corpus, above any "
                         "training seed (asserted)")
    ap.add_argument("--eval-wide-cache", default=None,
                    help="npz of the wide corpus (like --eval-cache)")
    ap.add_argument("--eval-serving", action="store_true",
                    help="also report the unseen-scene mAP under the "
                         "serving settings (1024 pre-NMS proposals, 128 "
                         "kept), float and int8, on the better of the raw "
                         "and EMA weights")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate the GroupNorm weights to a frozen "
                         "affine norm; report its mAP and that of the "
                         "folded int8 serving form")
    ap.add_argument("--ckpt", default=None,
                    help="--device-train: checkpoint pickle of the port's "
                         "training state (weights, EMA, Adam state, torch "
                         "generator and numpy draw states) written every "
                         "--ckpt-every steps, and resumed from when the "
                         "file exists. It resumes within the port only: a "
                         "JAX script's checkpoint does not resume here (the "
                         "random streams differ)")
    ap.add_argument("--ckpt-every", type=int, default=4000)
    ap.add_argument("--affine-finetune", type=int, default=0,
                    help="with --calibrate: N training steps under the "
                         "frozen affine norm; the fine-tuned weights are "
                         "served where they score at least as well")
    ap.add_argument("--pack-masks", action="store_true",
                    help="--device-train: keep the corpus's masks bit-packed "
                         "on the device (8x smaller), unpacked after each "
                         "batch's gather (exact)")
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
    wide_frames = None
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
        if args.eval_wide > 0:
            # leak guard: training scene seeds reach at most episodes +
            # eval_scenes (after the skip remap); the wide block starts
            # above that and clears the primary block
            assert args.eval_wide_seed > args.episodes + args.eval_scenes, \
                "--eval-wide-seed inside the training seed range"
            assert (args.eval_wide_seed >= args.eval_seed + args.eval_scenes
                    or args.eval_wide_seed + args.eval_wide <= args.eval_seed)
            if args.eval_wide_cache and os.path.exists(args.eval_wide_cache):
                wide_frames = load_corpus(args.eval_wide_cache)
            else:
                wide_frames = collect(
                    cfg, args.eval_wide, args.eval_ep_steps,
                    args.eval_wide_seed,
                    np.random.default_rng(args.eval_wide_seed), dev)
                if args.eval_wide_cache:
                    save_corpus(args.eval_wide_cache, wide_frames)
            print(f"[selfcheck-det] wide eval corpus {len(wide_frames)} "
                  f"frames, sha {corpus_checksum(wide_frames)}", flush=True)
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
        log=lambda m: print(m, flush=True), packed=args.pack_masks,
        ckpt=args.ckpt, ckpt_every=args.ckpt_every)
    # a run resumed at its last step reads back no loss
    first = losses[min(losses)] if losses else None
    last = losses[max(losses)] if losses else None
    map_after = eval_map(params, test_frames, eval_cfg, args.batch, dev)
    with_ema = args.device_train and args.ema > 0
    map_ema = (eval_map(ema_params, test_frames, eval_cfg, args.batch, dev)
               if with_ema else None)
    map_tta = (eval_map(params, test_frames, eval_cfg, args.batch, dev,
                        tta=True) if args.tta else None)
    map_ema_tta = (eval_map(ema_params, test_frames, eval_cfg, args.batch,
                            dev, tta=True)
                   if args.tta and map_ema is not None else None)
    wide = {}
    if wide_frames is not None:
        wide["map50_wide"] = round(eval_map(params, wide_frames, eval_cfg,
                                            args.batch, dev), 4)
        if with_ema:
            wide["map50_wide_ema"] = round(eval_map(
                ema_params, wide_frames, eval_cfg, args.batch, dev), 4)
        if args.tta:
            wide["map50_wide_tta"] = round(eval_map(
                params, wide_frames, eval_cfg, args.batch, dev, tta=True), 4)
            if with_ema:
                wide["map50_wide_ema_tta"] = round(eval_map(
                    ema_params, wide_frames, eval_cfg, args.batch, dev,
                    tta=True), 4)
        wide["eval_wide_sha"] = corpus_checksum(wide_frames)
    # serve the better of the raw and EMA weights on this corpus
    best_p = (ema_params if (map_ema is not None and map_ema >= map_after)
              else params)
    serving = {}
    if args.eval_serving:
        s_cfg = dataclasses.replace(eval_cfg, pre_nms_topk=1024,
                                    num_proposals=128)
        serving["map50_serving_exact"] = round(
            eval_map(best_p, test_frames, s_cfg, args.batch, dev), 4)
        # the port's proposal top-k is exact: the JAX script's approximate
        # top-k setting evaluates the same proposals
        serving["map50_serving_approx"] = serving["map50_serving_exact"]
        serving["map50_gn_int8"] = round(eval_map(
            quantize_params(best_p, min_size=64), test_frames, s_cfg,
            args.batch, dev), 4)
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
        if args.affine_finetune > 0:
            aft, _ = affine_finetune(
                affine_art, train_frames, dcfg, args.affine_finetune,
                args.batch, args.lr, args.head, rng, dev, args.augment,
                args.augment_crop, log=lambda m: print(m, flush=True))
            m_ft = eval_map(aft, test_frames, aff_cfg, args.batch, dev)
            serving["map50_affine_ft"] = round(m_ft, 4)
            if m_ft >= serving["map50_affine"]:
                affine_art = aft  # serve the fine-tuned affine weights
        served_cfg = dataclasses.replace(aff_cfg, pre_nms_topk=1024,
                                         num_proposals=128, approx_topk=True)
        served = quantize_params(DET.fold_affine(affine_art, served_cfg),
                                 min_size=64)
        serving["map50_served_int8"] = round(
            eval_map(served, test_frames, served_cfg, args.batch, dev), 4)
        if args.tta:
            serving["map50_served_int8_tta"] = round(
                eval_map(served, test_frames, served_cfg, args.batch, dev,
                         tta=True), 4)
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
        "map50_after_tta": (round(map_tta, 4) if map_tta is not None
                            else None),
        "map50_after_ema_tta": (round(map_ema_tta, 4)
                                if map_ema_tta is not None else None),
        "eval_sha": (corpus_checksum(test_frames)
                     if args.split == "scenes" else None),
        "frames": len(train_frames), "steps": args.steps,
        "first_loss": None if first is None else round(first, 3),
        "last_loss": None if last is None else round(last, 3),
        "map50_before": round(map_before, 4),
        "map50_after": round(map_after, 4),
        "map50_train": round(map_train, 4),
        "mask_iou": round(float(mask_iou), 4),
        "mask_matched": mask_n,
        "train_seconds": round(time.time() - t0, 1),
        **wide,
        **serving,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
