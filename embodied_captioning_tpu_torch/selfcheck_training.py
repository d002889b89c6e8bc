"""Captioner learning self-check: train the captioner on simulator ground
truth and measure that its captions become right, on the GPU (or on the
CPU with --device cpu).

The counterpart of the JAX package's `scripts/selfcheck_training.py`, with
the same arguments (and `--device`) and the same JSON line. The simulator
renders labelled scenes; every ground-truth instance of a frame gives a
crop (its box expanded by 0.2 of its size, resized to the ViT's input)
captioned "a {colour} {class}"; the captioner trains with
`train/captioner_train.train_step` (zero object ids, every sample
valid); held-out crops of unseen scenes are scored by class-word
accuracy, the sentence encoder's cosine to the reference captions and
BLEU, in float and through int8 weights. Weights start from a seeded
`torch.Generator`, so the numbers differ from the JAX script's
(jax.random); the scene walks and batch order are numpy draws, the same
in both.

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_training \\
      [--preset tiny] [--steps 300] [--batch 16] [--scan-steps K] \\
      [--train-cache c.npz] [--eval-cache e.npz] [--speculative] \\
      [--device cpu] [key.path=value ...]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def _color_word(albedo) -> str:
    r, g, b = [float(x) for x in albedo]
    if g > r and g > b:
        return "green"
    if r > 0.8 and g > 0.8 and b > 0.8:
        return "white"
    if r < 0.2 and g < 0.2 and b < 0.25:
        return "black"
    if b > r and b > g:
        return "blue"
    return "brown"


def walk(cfg, episodes: int, steps: int, seed0: int, rng, device,
         skip_seeds: Tuple[int, int] = ()) -> Tuple[list, list]:
    """Step a simulator per scene on the host: (sims, jobs), a job being
    (scene index, [4, 4] float32 camera pose) after 2-5 random moves.
    Scene seeds in [start, start + n) of `skip_seeds` move past the block."""
    from .envs.sim import RaycastSim

    sims, jobs = [], []
    for ep in range(episodes):
        seed = seed0 + ep
        if skip_seeds and seed >= skip_seeds[0]:
            seed += skip_seeds[1]
        sim = RaycastSim(cfg.sim, cfg.sensors, seed=seed, device=device)
        sims.append(sim)
        for _ in range(steps):
            for _ in range(int(rng.integers(2, 6))):
                sim.step(int(rng.integers(1, 4)))
            jobs.append((ep, np.asarray(sim.agent.camera_matrix(),
                                        np.float32)))
    return sims, jobs


def render_jobs(sims, jobs, cfg, device):
    """Render `jobs` at once through the chunked batch render: rgb,
    instances and classes [J, H, W]."""
    from .envs.sim import Scene, render_batch_chunked

    scenes = Scene(*(torch.stack(xs) for xs in zip(
        *[sims[e].scene for e, _ in jobs])))
    poses = torch.from_numpy(np.stack([p for _, p in jobs])).to(device)
    s = cfg.sensors
    return render_batch_chunked(scenes, poses, s.height, s.width,
                                s.hfov_deg, s.max_depth)


def min_pixels(cfg) -> int:
    return max(50, (cfg.sensors.height * cfg.sensors.width) // 2184)


def collect(cfg, episodes: int, steps: int, seed0: int, max_crops: int,
            device) -> Tuple[List[np.ndarray], List[str], List[int]]:
    """Ground-truth caption crops of `episodes` scenes (seeds seed0..):
    every walk first, then (scene, pose) chunks rendered together, up to
    8 instances a frame; stops at `max_crops`. Returns uint8 crops, "a
    {colour} {class}" captions and class ids. The colour is the albedo of
    each instance's first box (the primary part of composite furniture)."""
    from .config import CLASS_NAMES
    from .envs.sim import gt_detections
    from .ops.detections import expand_boxes
    from .ops.image import crop_and_resize

    size = cfg.captioner.vision.image_size
    sensor, width = cfg.sensors.height, cfg.sensors.width
    sims, jobs = walk(cfg, episodes, steps, seed0,
                      np.random.default_rng(seed0), device)
    albedos = []
    for sim in sims:
        by_iid = {}
        for i, a in zip(sim._scene_np.instance_id, sim._scene_np.albedo):
            if i >= 0 and int(i) not in by_iid:
                by_iid[int(i)] = a
        albedos.append(by_iid)
    min_px = min_pixels(cfg)
    chunk = 16 if sensor >= 1024 else 64
    crops, caps, classes = [], [], []
    for i in range(0, len(jobs), chunk):
        part = jobs[i:i + chunk]
        out = render_jobs(sims, part, cfg, device)
        for b, (ep, _) in enumerate(part):
            det = gt_detections(out["instances"][b], out["classes"][b],
                                max_instances=8, min_pixels=min_px)
            eb = expand_boxes(det.boxes, 0.2, sensor, width)
            c8 = torch.clamp(crop_and_resize(out["rgb"][b].float(), eb,
                                             size), 0, 255).to(torch.uint8)
            c8, cls8 = c8.cpu().numpy(), det.classes.cpu().numpy()
            iid8 = det.object_ids.cpu().numpy()
            for j in np.nonzero(det.valid.cpu().numpy())[0]:
                color = _color_word(albedos[ep].get(int(iid8[j]),
                                                    (0.5, 0.4, 0.3)))
                crops.append(c8[j])
                caps.append(f"a {color} {CLASS_NAMES[int(cls8[j])]}")
                classes.append(int(cls8[j]))
                if len(crops) >= max_crops:
                    return crops, caps, classes
    return crops, caps, classes


def eval_checksum(crops: Sequence[np.ndarray], caps: Sequence[str]) -> str:
    """The eval corpus's sha, as the JAX script prints it."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.stack(crops)))
    h.update("|".join(caps).encode())
    return h.hexdigest()[:16]


def train(params: dict, images: np.ndarray, tokens: np.ndarray, ccfg,
          steps: int, batch: int, lr: float, seed: int, scan_steps: int,
          device, log: Callable[[str], None] = print):
    """`steps` train steps on batches drawn without replacement by
    `np.random.default_rng(seed)` (the JAX script's draws), the corpus on
    `device` once. The loss is read back once every `scan_steps` steps
    (the same steps, not fused). Returns (train state, per-step losses,
    per-step seconds of every window but the first)."""
    from .train.captioner_train import create_train_state, train_step

    state = create_train_state(params)
    corpus_img = torch.from_numpy(images).to(device)
    corpus_tok = torch.from_numpy(tokens).to(device)
    zeros = torch.zeros(batch, dtype=torch.int32, device=device)
    ones = torch.ones(batch, dtype=torch.bool, device=device)
    rng = np.random.default_rng(seed)
    n, k_scan = len(images), max(1, scan_steps)
    losses, step_times, step = [], [], 0
    while step < steps:
        k = min(k_scan, steps - step)
        idx = torch.from_numpy(np.stack([
            rng.choice(n, batch, replace=False) for _ in range(k)])).to(device)
        ts = time.time()
        window = []
        for i in range(k):
            state, aux = train_step(state, corpus_img[idx[i]],
                                    corpus_tok[idx[i]], zeros, ones, ccfg,
                                    lr=lr)
            window.append(aux["loss"])
        window = torch.stack(window).cpu().tolist()  # fences the window
        if step > 0:
            step_times += [(time.time() - ts) / k] * k
        losses += window
        if k_scan > 1 or step % 50 == 0:
            log(f"  step {step}: loss={window[-1]:.3f}")
        step += k
    return state, losses, step_times


def evaluate(params: dict, crops: np.ndarray, caps: Sequence[str],
             classes: Sequence[int], cfg, device):
    """Greedy captions of `crops`: (captions, class-word accuracy, mean
    cosine of their sentence embeddings to those of `caps`, mean BLEU)."""
    from .config import CLASS_NAMES
    from .models.captioner import generate
    from .models.sbert import SentenceEncoder
    from .models.tokenizer import default_tokenizer
    from .utils.metrics import caption_scores

    ccfg = cfg.captioner
    tok = default_tokenizer(ccfg.text.vocab_size)
    toks, _, _ = generate(params, torch.from_numpy(crops).to(device), ccfg)
    preds = [tok.decode(t) for t in toks.cpu().numpy()]
    hits = sum(1 for p, c in zip(preds, classes)
               if CLASS_NAMES[c].split()[0] in p)
    enc = SentenceEncoder.create(0, cfg.sentence_encoder, device)
    cos = float(np.mean(np.sum(enc.encode(preds) * enc.encode(caps), axis=1)))
    bleu = float(np.mean([caption_scores(p, r)["bleu"]
                          for p, r in zip(preds, caps)]))
    return preds, hits / len(preds), cos, bleu


def fenced_ms(fn: Callable, device, reps: int = 5) -> float:
    """Median wall time of `reps` calls after a warm one, each ended by a
    synchronise of the card (nothing to wait for on the CPU)."""
    def fence():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    fn()
    fence()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        fence()
        times.append(time.perf_counter() - t0)
    return 1000.0 * sorted(times)[len(times) // 2]


def speculative(qparams: dict, crops: np.ndarray, ccfg, device) -> dict:
    """`generate_speculative` against greedy `generate` on the int8 model
    at batch 1 and 4: equal tokens, and each one's median latency."""
    from .models.captioner import generate, generate_speculative

    out = {}
    for bsz in (1, 4):
        imgs = torch.from_numpy(crops[:bsz]).to(device)
        tg = generate(qparams, imgs, ccfg)[0]
        ts = generate_speculative(qparams, imgs, ccfg)[0]
        exact = bool(torch.equal(tg.cpu(), ts.cpu()))
        g_ms = fenced_ms(lambda: generate(qparams, imgs, ccfg), device)
        s_ms = fenced_ms(lambda: generate_speculative(qparams, imgs, ccfg),
                         device)
        out[f"b{bsz}"] = {"exact": exact, "greedy_ms": round(g_ms, 1),
                          "speculative_ms": round(s_ms, 1),
                          "speedup": round(g_ms / max(s_ms, 1e-9), 2)}
    return out


def memory_gb(device) -> Tuple[float, float]:
    """(peak allocated, total) device memory in GiB; 0.0 on the CPU."""
    if torch.device(device).type != "cuda":
        return 0.0, 0.0
    dev = torch.device(device)
    total = torch.cuda.get_device_properties(dev).total_memory
    return (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2),
            round(total / 2 ** 30, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--train-crops", type=int, default=192)
    ap.add_argument("--train-scenes", type=int, default=6,
                    help="training scene pool (seeds 0..N-1)")
    ap.add_argument("--train-steps-per-scene", type=int, default=12)
    ap.add_argument("--train-cache", default=None,
                    help="npz of the train crops: collected and saved on "
                         "first use, loaded afterwards")
    ap.add_argument("--test-crops", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="train steps between two loss read-backs")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--speculative", action="store_true",
                    help="also check speculative against greedy decoding "
                         "on the trained int8 model: equal tokens, latency")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init and batch order); the scenes "
                         "have seeds of their own")
    ap.add_argument("--eval-seed", type=int, default=1000,
                    help="scene-seed origin of the unseen-scene eval crops")
    ap.add_argument("--eval-scenes", type=int, default=3)
    ap.add_argument("--eval-cache", default=None,
                    help="npz of the eval crops: collected and saved on "
                         "first use, loaded afterwards")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("selfcheck_training: no CUDA device (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 2

    from .config import load_config
    from .models.captioner import init_captioner
    from .models.quantize import quantize_params
    from .models.tokenizer import default_tokenizer

    cfg = load_config(args.preset, overrides=list(args.overrides))
    t0 = time.time()
    if args.train_cache and os.path.exists(args.train_cache):
        z = np.load(args.train_cache, allow_pickle=False)
        tr_crops, tr_caps = list(z["crops"]), [str(s) for s in z["caps"]]
        print(f"[selfcheck] train corpus loaded from {args.train_cache}",
              flush=True)
    else:
        tr_crops, tr_caps, _ = collect(cfg, args.train_scenes,
                                       args.train_steps_per_scene, 0,
                                       args.train_crops, dev)
        if args.train_cache:
            np.savez_compressed(args.train_cache, crops=np.stack(tr_crops),
                                caps=np.asarray(tr_caps))
    if args.eval_cache and os.path.exists(args.eval_cache):
        z = np.load(args.eval_cache, allow_pickle=False)
        te_crops, te_caps = list(z["crops"]), [str(s) for s in z["caps"]]
        te_cls = [int(c) for c in z["classes"]]
    else:
        te_crops, te_caps, te_cls = collect(cfg, args.eval_scenes, 8,
                                            args.eval_seed, args.test_crops,
                                            dev)
        if args.eval_cache:
            np.savez_compressed(args.eval_cache, crops=np.stack(te_crops),
                                caps=np.asarray(te_caps),
                                classes=np.asarray(te_cls))
    eval_sha = eval_checksum(te_crops, te_caps) if te_crops else ""
    print(f"[selfcheck] {len(tr_crops)} train / {len(te_crops)} test crops "
          f"({time.time() - t0:.0f}s) eval_sha {eval_sha}", flush=True)
    if len(tr_crops) < args.batch or not te_crops:
        print(json.dumps({"error": "not enough crops"}))
        return 0
    if args.eval_seed < args.train_scenes:
        raise ValueError("eval scenes leak into train (--eval-seed must be "
                         "at least --train-scenes)")

    ccfg = cfg.captioner
    tok = default_tokenizer(ccfg.text.vocab_size)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_captioner(torch.Generator(device=dev).manual_seed(
        args.seed), ccfg, dev)
    t0 = time.time()
    state, losses, step_times = train(
        params, np.stack(tr_crops), tok.encode_batch(
            tr_caps, ccfg.text.context_length), ccfg, args.steps, args.batch,
        args.lr, args.seed, args.scan_steps, dev,
        log=lambda m: print(m, flush=True))
    print(f"[selfcheck] trained {args.steps} steps in "
          f"{time.time() - t0:.0f}s", flush=True)
    step_ms = (1000.0 * sorted(step_times)[len(step_times) // 2]
               if step_times else 0.0)
    hbm_peak_gb, hbm_limit_gb = memory_gb(dev)

    crops = np.stack(te_crops)
    preds, acc, cos, bleu = evaluate(state.params, crops, te_caps, te_cls,
                                     cfg, dev)
    qparams = quantize_params(state.params)
    _, acc_q, cos_q, bleu_q = evaluate(qparams, crops, te_caps, te_cls, cfg,
                                       dev)
    spec = speculative(qparams, crops, ccfg, dev) if args.speculative else {}
    print(json.dumps({
        "train_crops": len(tr_crops), "test_crops": len(te_crops),
        "seed": args.seed, "eval_sha": eval_sha,
        "preset": args.preset, "batch": args.batch,
        "step_ms_median": round(step_ms, 1),
        "hbm_peak_gb": hbm_peak_gb, "hbm_limit_gb": hbm_limit_gb,
        "first_loss": round(losses[0], 3), "last_loss": round(losses[-1], 3),
        "class_word_accuracy": round(acc, 3),
        "sbert_cosine": round(cos, 4), "bleu": round(bleu, 4),
        "int8_class_word_accuracy": round(acc_q, 3),
        "int8_sbert_cosine": round(cos_q, 4), "int8_bleu": round(bleu_q, 4),
        "examples": [{"pred": p, "ref": r}
                     for p, r in list(zip(preds, te_caps))[:4]],
        **({"speculative": spec} if spec else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
