"""Full-loop self-check: train the detector and the captioner on simulator
ground truth, then run the goal-exploration loop with the trained
perception stack and show the disagreement reward producing signal, on
the GPU (or on the CPU with --device cpu).

The counterpart of the JAX package's `scripts/selfcheck_loop.py`, with its
arguments (and `--device`), its configuration and its JSON line. The
stages are functions that take weights, so the JAX package's initial
weights can be handed across: `train_stack` (detector with the ce head
under clip 5 + Adam 2e-3 on 8-frame batches, then the captioner on
template captions, every batch drawn from one numpy generator in the JAX
script's order) and `run_loop` (`perceive_and_fuse` each step, a goal
replanned through `policy.act` every `ppo.replanning_steps`, drawn from a
`torch.Generator` seeded with the step in place of `PRNGKey(step)`).
Weights start from seeded `torch.Generator`s (numbers differ from
jax.random).

Usage:
  python -m embodied_captioning_tpu_torch.selfcheck_loop [--preset tiny] \\
      [--det-steps 400] [--cap-steps 300] [--loop-steps 24] \\
      [--device cpu] [key.path=value ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

# the JAX script's configuration (its `base_over` and common overrides)
PRESET_OVERRIDES = {"tiny": ["sensors.height=64", "sensors.width=64"],
                    "base": []}
LOOP_OVERRIDES = ["sim.num_objects=8", "sim.scene_size=8.0",
                  "map.voxel_size=0.1", "runtime.num_envs=2",
                  "ppo.replanning_steps=8", "detector.score_threshold=0.2"]


def _quiet(_msg: str) -> None:
    pass


def train_stack(cfg, det_steps: int, cap_steps: int, device, rng=None,
                seed0: int = 0, init_seed: int = 0, lr: float = 3e-4,
                det_params: Optional[dict] = None,
                cap_params: Optional[dict] = None):
    """The JAX scripts' perception training on simulator ground truth
    (`selfcheck_rl.train_stack`, inlined in `selfcheck_loop` and, per
    seed, in `selfcheck_cycle`): detector frames of 6 scenes x 16 walk
    positions from scene seed `seed0` (walks drawn from `rng`), `det_steps`
    steps of the ce head under clip-by-global-norm(5) + Adam(2e-3) on
    8-frame batches drawn by `rng`; then 256 caption crops of 6 scenes x
    12 positions from `seed0` and `cap_steps` captioner steps at `lr` on
    16-crop batches drawn by `rng` (zero object ids, every row valid).
    `rng` defaults to `np.random.default_rng(0)`; weights start from
    `det_params` / `cap_params` where handed, else seeded generators
    (`init_seed`, `init_seed + 1`, as the JAX scripts' PRNG keys).
    Returns (detector params, captioner train state, last detector loss,
    last captioner loss)."""
    from .models import detector as DET
    from .models.captioner import init_captioner
    from .models.tokenizer import default_tokenizer
    from .selfcheck_detector import collect
    from .selfcheck_detector import train as train_detector
    from .selfcheck_training import collect as collect_caps
    from .train.captioner_train import create_train_state, train_step

    rng = np.random.default_rng(0) if rng is None else rng
    frames = collect(cfg, 6, 16, seed0, rng, device)
    dcfg = cfg.detector
    if det_params is None:
        det_params = DET.init_detector(
            torch.Generator(device=device).manual_seed(init_seed), dcfg,
            device)
    det_params, _, read = train_detector(
        det_params, frames, dcfg, det_steps, 8, lambda _c: 2e-3, "ce", rng,
        device, log=_quiet)
    det_loss = read[det_steps - 1] if det_steps else float("nan")

    crops, caps, _ = collect_caps(cfg, 6, 12, seed0, 256, device)
    ccfg = cfg.captioner
    tok = default_tokenizer(ccfg.text.vocab_size)
    if cap_params is None:
        cap_params = init_captioner(
            torch.Generator(device=device).manual_seed(init_seed + 1), ccfg,
            device)
    state = create_train_state(cap_params)
    tokens = torch.from_numpy(np.asarray(tok.encode_batch(
        caps, ccfg.text.context_length))).to(device)
    images = torch.from_numpy(np.stack(crops)).to(device)
    zeros = torch.zeros(16, dtype=torch.int32, device=device)
    ones = torch.ones(16, dtype=torch.bool, device=device)
    cap_loss = float("nan")
    for s in range(cap_steps):
        sel = torch.from_numpy(rng.choice(len(images), 16, replace=False)
                               ).to(device)
        state, aux = train_step(state, images[sel], tokens[sel], zeros, ones,
                                ccfg, lr=lr)
        if s == cap_steps - 1:
            cap_loss = float(aux["loss"])
    return det_params, state, det_loss, cap_loss


def trained_perceiver(cfg, det_params: dict, cap_params: dict, device):
    """A `Perceiver` of `cfg` (its seeded sentence encoder) serving the
    trained detector and captioner."""
    from .perception import Perceiver

    p = Perceiver(cfg, device=device)
    p.params = p.params._replace(detector=det_params, captioner=cap_params)
    return p


def run_loop(trainer, loop_steps: int,
             log: Callable[[str], None] = _quiet) -> dict:
    """The JAX script's exploration loop on a goal-exploration trainer:
    each step `perceive_and_fuse` on the current frames, the summed
    disagreement reward read, a goal replanned through `policy.act` every
    `ppo.replanning_steps` steps (drawn from a generator seeded with the
    step), the follower's actions stepped. Returns the loop's figures:
    the reward trace, the captioned detections, the example caption, each
    env's mapped objects and disagreement reward, and the seconds."""
    from .agents.policy import act

    cfg = trainer.cfg
    dev = trainer.device
    t0 = time.time()
    obs = trainer.envs.observe()
    n_caps, example, trace = 0, None, []
    for step in range(loop_steps):
        result = trainer.perceive_and_fuse(obs)
        trace.append(float(np.sum(trainer.rewards())))
        if result is not None:
            valid = result.detections.valid.cpu().numpy()
            if valid.any() and example is None:
                e, i = np.argwhere(valid)[0]
                example = trainer.perceiver.captions(result)[e][i]
            n_caps += int(valid.sum())
        if step % cfg.ppo.replanning_steps == 0:
            maps, orients = trainer._policy_obs()
            m, o = trainer._tensors(maps, orients)
            a = act(trainer.ppo_state.params,
                    torch.Generator(device=dev).manual_seed(step), m, o)[0]
            trainer._goals_from_actions(a.cpu().numpy())
        obs, _, _, _ = trainer.envs.step(trainer.actions(obs))
    return {"trace": trace, "captioned": n_caps, "example": example,
            "objects": [int(env.map_state.num_objects)
                        for env in trainer.envs.envs],
            "rewards": [float(r) for r in trainer.rewards()],
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "base"],
                    help="base = ViT-B captioner + 256^2 detector")
    ap.add_argument("--det-steps", type=int, default=400)
    ap.add_argument("--cap-steps", type=int, default=300)
    ap.add_argument("--loop-steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("selfcheck_loop: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 2

    from .agents import get_trainer
    from .config import load_config

    cfg = load_config(args.preset, overrides=PRESET_OVERRIDES[args.preset]
                      + LOOP_OVERRIDES + list(args.overrides))
    dev = torch.device(args.device)

    t0 = time.time()
    det_params, state, dloss, closs = train_stack(
        cfg, args.det_steps, args.cap_steps, dev)
    print(f"[loop] perception trained: detector {args.det_steps} steps "
          f"(loss={dloss:.3f}), captioner {args.cap_steps} steps "
          f"(loss={closs:.3f}) ({time.time() - t0:.0f}s)", flush=True)

    perceiver = trained_perceiver(cfg, det_params, state.params, dev)
    trainer = get_trainer("goalexplorationbaseline-v0")(
        cfg, perceiver=perceiver, device=dev)
    out = run_loop(trainer, args.loop_steps)
    trainer.envs.close()
    trace, dt = out["trace"], out["seconds"]
    half = len(trace) // 2
    print(json.dumps({
        "preset": args.preset,
        "loop_steps": args.loop_steps,
        "seconds": round(dt, 1),
        "loop_fps": round(cfg.runtime.num_envs * args.loop_steps / dt, 2),
        "reward_mean_first_half": round(
            float(np.mean(trace[:half])) if half else 0.0, 5),
        "reward_mean_second_half": round(float(np.mean(trace[half:])), 5),
        "captioned_detections": out["captioned"],
        "mapped_objects_per_env": out["objects"],
        "disagreement_rewards": [round(r, 5) for r in out["rewards"]],
        "example_caption": out["example"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
