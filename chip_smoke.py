#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's perception path, fused exploration loop,
caption-generation modes, exploration entry point (`generate`), PPO
training entry point (`train`), captioner fine-tune
(`finetune_captioner`) and learning self-checks (`selfcheck_training`,
`selfcheck_detector`) on one NVIDIA GPU.

Phases, each of which must pass:
  1. build the hand-written Hopper kernels from the sources in the checkout;
  2. hold every kernel against its plain PyTorch version on the card at the
     shapes the main paths give it: max error, kernel / plain / library
     time, the kernel's and the library call's device time per call
     (torch.profiler over its timing loop), and the least time the card
     could take (bound). Flash attention at head dims 32, 64, 128 and T =
     1, 16, 65, 257 (and 640 at D = 128, the streaming kernel), causal and
     with valid_len < T; the decode MLP at 1, 16, 17 and 64 rows with int8
     and bf16 weights, each run twice for equal bits; the decode
     self-attention at a cache of 30 (positions 29 and 14) and of 1024
     (position 1023: the tiled kernel), each run twice for equal bits,
     timed beside its bound over the live keys and the bound over all T,
     the tiled kernel's bits against the whole-head kernel's; the decode
     cross-attention kernel with int8 and bf16 K/V at the serving shape,
     the tiny preset's heads and 11 keys (copied element by element); the
     self-attention, the cross-attention and the ViT LayerNorm also timed
     with their inputs cold in L2 (copies read in turn). The
     raycast kernel must equal its plain version bit for bit (16 envs x
     1280^2 rays x 96 boxes, and adversarial inputs), and its box loop's
     instructions are counted in the built library (cuobjdump -sass);
     LayerNorm is checked in both statistics modes at the ViT, decoder and
     sentence-encoder shapes (timed beside a copy of the same bytes), with
     the output in the other type, and on its scalar path ([37, 100], a
     base 2 bytes past 16-byte alignment, [8, 4096]), each run twice for
     equal bits, with the host time of one wrapper call at the decoder and
     sentence-encoder shapes split into its pieces beside F.layer_norm's;
     the self block at cache positions 0, 1 and 29 and the cross block,
     both with int8 and bf16 weights and (cross) K/V, at 1, 17 and 64 rows
     and at the tiny preset's width, each run twice for equal bits, with
     their device time per launch; `common.block` where the route takes
     only some fused kernels (96 wide with 2 heads, 64 with 16, and 768
     with 12 at a cache of 1024 positions, too long for the self block) and
     at 768 with the preset's cache, on the card against the CPU; the fused
     preprocess at the 64 crops of a batch (equal bit for bit) and on true
     resizes (from sources of 150, 333 and 1280 pixels, patch 16 and 7),
     with its instructions counted in the built library (cuobjdump -sass);
     the LayerNorm backward at the fine-tune step's shapes (ViT [8*257,
     1024], pool [8*256, 1024], decoder [8*77, 768], bf16), the ViT
     [64*257, 1024] and decoder [64, 768] bf16 shapes and the sentence
     encoder's [64, 64, 384] f32 (dx, dg, db against the plain version,
     twice for equal bits, timed warm and cold in L2 beside
     native_layer_norm_backward, with its launch plan, its launches per
     call and the bytes of its float32 partials), on its generic path
     ([37, 100] bf16 and f32, [64, 1024] f32) and with a float32 cotangent
     of bf16 input;
  3. drive `perceive` at full width -- the serving configuration of
     bench.py: the large preset (ViT-L/14 at 224^2, 768-wide 12+12-layer
     decoder, 49,408-token vocabulary, post-LN MiniLM-class sentence
     encoder), the committed R50/FPN detector artifact, int8 weights and
     int8 cross K/V, 4 caption slots per frame, 1280^2 frames -- on frames
     rendered by the port's simulator (16 seeded 96-box scenes) with random
     captioner weights from a seeded generator, decoding through the
     whole-block kernels (the default route); count each kernel's
     launches in that run, check the outputs are finite and well shaped,
     and compare with the plain versions: the ViT embeddings, the sentence
     embeddings of the rows whose free-running tokens agree, and a
     teacher-forced decode (the plain path fed the kernel path's tokens:
     per-step argmax and chosen-token log-probs); then the route of
     separate calls (`decode_blocks=False`: LayerNorm, projections and the
     decode attention kernels) on the same frames in turns with the
     default route, with its launch counts;
  4. drive the exploration loop at full width: the render through the
     raycast kernel against the render through its plain version (equal
     depth, instances, classes and rgb); one window of
     `rollout_perception`; one warm-up and two timed windows of
     `rollout_fused` (step -> render -> perceive -> voxel-map fusion ->
     disagreement reward; 16 envs, 256 x 64 x 256 voxel grids) with the
     launch counts of all kernels, the per-step time split and peak device
     memory; then the map fusion and reward on the card against the same
     functions on the CPU, fed the same detections;
  5. run the tiny preset through the kernels on the card and through the
     plain versions on the CPU (the path the CPU tests hold to the JAX
     package) and compare: `perceive`, and four steps of
     `randombaseline`'s unfused loop (2 envs, 128^2 frames, 3-step
     episodes: both envs auto-reset, on the VectorEnv's worker stream):
     frames, tokens, and the CPU's fusion of the card's detections against
     the card's rewards (rtol 1e-4, atol 1e-5);
  6. profile one full-width perceive batch on each decode route and one
     rollout_fused step: device time by kernel, the ported kernels' share,
     the device's idle share (device time is the union of the kernels'
     intervals: a launch that starts early under programmatic dependent
     launch waits inside its own interval); LayerNorm launches and device
     time of a perceive batch by parameter and input shape;
  7. drive the other generation modes at full width: `generate_beam`
     (16 crops x 4 beams), sampled `generate` (64 crops, temperature 0.7,
     top-k 50, top-p 0.9, seeded generator) and `generate_speculative`
     (16 crops, 4 drafts) beside greedy `generate` on the same crops:
     shapes, finite scores, BOS first, PAD after EOS, lengths, launches;
  8. drive the exploration entry point at full width: `randombaseline`'s
     `generate` (what `python -m embodied_captioning_tpu_torch.run_exp`
     runs) on 16 envs with the serving configuration of phase 3, writing
     the npz observations to a temporary directory: first, on fresh envs,
     the frames of `step_async`/`step_wait` (with perception and readbacks
     in flight on the caller's stream) against a synchronous `step`, and
     the batched chunked render against each env's own render, bit for bit
     (the chunked render's peak memory within its budget), and the port's
     native library (connected components, A*); then one warm-up step and
     GEN_STEPS timed steps: frames/s, the per-step split (perceive,
     upsample and fusion, `save_step_obs`, the wait in `step_wait`, the
     worker's agent steps and render), launch counts (the raycast kernel
     and the six `perceive` kernels each launched, the two standalone
     decode attention kernels not), peak device memory, saved files,
     finite rewards; one step under the profiler for the idle share;
  9. drive PPO training at full width: first `ppo_update` on the card
     against the CPU on the same rollout, weights and permutations (the
     first backward the port runs on the card: first-minibatch gradients,
     parameters after the update and metrics within the CPU tests'
     limits, feed-forward and GRU policies); then
     `goalexplorationbaseline-v0`'s `train` on 16 envs with the serving
     configuration of phase 3 and the policy at its defaults (128^2 maps,
     72 orientation bins): 2 updates of 2 decisions of 2 steps unfused,
     then the same fused (`rollout_fused` windows), each with finite
     metrics, moved parameters, launch counts (raycast and the six
     `perceive` kernels launched, the two standalone decode attentions
     not), the split of an update (rollout, policy inputs, update), env
     steps/s, peak memory, and `policy.pkl` written and read back equal,
     then one decision and its update under the profiler for the idle
     share; one PPO update at the reference's batch (8 decisions x 16
     envs, 4 epochs x 2 minibatches), timed and profiled; and `run_exp
     --mode train` at the tiny preset in process on the card;
 10. drive the captioner fine-tune: `train_step` at the tiny preset on the
     card against the CPU (every leaf's gradient within limits set from
     the CPU's own spread, every leaf with a non-zero CPU gradient non-zero
     and finite on the card, the loss and its parts, the parameters after
     one step within 2 lr an element, and to rounding where both gradients
     share a sign); one timed `train_step` at the large
     preset at the fine-tune's batch of 8 with `remat` off and then on (ms
     a step, peak memory, LayerNorm forward and backward launches, device
     busy and idle share under the profiler); then `finetune_captioner`
     at the large preset on the store phase 8 wrote: its JSON line and
     its pickle read back;
 11. drive the two learning self-checks: (a) `detector_loss` at the tiny
     preset on the card against the CPU for the five ROI heads with masks
     (the loss, its five parts and every leaf's gradient within limits set
     from the CPU's own spread), then the parameters after one clip + Adam
     step; (b) one timed detector training step at the large preset (R50
     bottleneck FPN P3-P6, affine norm, 1024^2, 128 proposals, masks) and
     at the base preset (GroupNorm, 256^2), batch 8, on frames of the
     port's simulator: ms a step, peak memory, device busy and idle share,
     device time by kernel family; (c) `selfcheck_training` whole at the
     tiny preset with the JAX script's defaults and --speculative: its
     JSON line, held-out sbert_cosine > 0.8 with int8 within 0.01, the
     launches of the run; then 20 steps at the large preset on 64 crops:
     step_ms_median, hbm_peak_gb; (d) `selfcheck_detector --steps 700
     --episodes 4` at the tiny preset: map50_train > 0.4, mask_iou > 0.5
     on more than 5 matched detections; (e) on the captioner (c) trained,
     free-running greedy decoding of the held-out crops through the
     kernels and through their plain versions, float and int8: equal
     tokens on at least 90% of rows, every sublayer on a fused kernel, and
     speculative decoding beside greedy.

Float32 products and convolutions run without TF32 so the comparisons see
the kernels' own error. Prints the card's name and power limit, frames/s
lines, one JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when a
phase fails or no CUDA device is present.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --sass LIB   (instructions of the preprocess
                                           kernel in a built kernel
                                           library, by cuobjdump)
       python3 chip_smoke.py --self-attention ROOT
                                          (phase 2's decode_self_attention
                                           cases through the kernels of
                                           the checkout at ROOT)
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float32 operations that are no fused multiply-add (multiplies, min/max,
# compares, selects): 67 TFLOP/s counts an FMA as two operations, and each
# of these takes a lane for at least one clock, so at most half that rate
# (min/max may issue slower still, which would only raise a bound)
FP32_OP_PER_S = FP32_FLOP_PER_S / 2
REPO = Path(__file__).resolve().parent
TPU_KERNELS = "embodied_captioning_tpu/ops/pallas/"
PORT_KERNELS = "embodied_captioning_tpu_torch/kernels/csrc/"
FRAMES = 16                    # sensor frames per perceive batch (bench.py)
SLOTS = 4                      # caption slots per frame
ROWS = FRAMES * SLOTS          # crops / decode rows per batch
BATCHES = 2                    # timed perceive batches
DECODE_LEN = 30                # large preset's max caption tokens
LOOP_STEPS = 2                 # K: env steps per rollout window
LOOP_WINDOWS = 2               # timed rollout_fused windows after a warm-up
GEN_STEPS = 3                  # timed `generate` steps after a warm-up step
# rgb pixels allowed more than one level apart between the card's render
# and the CPU's: the texture noise is fract(sin(x) * 43758.5453), so the
# sine's last bits (CUDA's sinf is within 2 ulp, the CPU's closer) shift
# the noise by ~5e-3 and wrap it past 1 on about that share of the pixels
# (6.0e-3 read on an H100 at the tiny preset); depth, instances and
# classes must be equal
RGB_SHARE = 2e-2
# FP32 operations of the slab test per ray and box, none of them a fused
# multiply-add, so counted at FP32_OP_PER_S: the built box loop's FP32
# instructions per box where cuobjdump reads them (raycast_loop_sass),
# else this count of them in the sm_90a build (6 FMUL, 11 FMNMX, 4 FSETP,
# 1 FSEL)
RAYCAST_OPS = 22
RAYCAST_FP32_OPCODES = ("FMUL", "FMNMX", "FSETP", "FSEL", "FADD", "FFMA")
# Kernel path vs plain path (see perceive_full_width). Readings on an H100
# at 64 rows, frame seeds 100 and 101: argmax agreement 0.9720 and 0.9709
# of 1856 steps; log-prob max 2.001 and 2.029 ulps; ViT cosine min
# 0.9999792 and 0.9999852.
MIN_ARGMAX_AGREE = 0.9
# Logits are bf16: the two paths' hidden states differ in the last bits,
# so chosen log-probs differ by a few bf16 ulps of the logits' magnitude
# (0.03125 for |logit| in [4, 8)).
MAX_LOGPROB_ULPS = 4.0
MIN_IMG_COSINE = 0.9999
# equal tokens go through the same sentence encoder (no ported kernel)
MIN_EMB_COSINE = 0.9999
# speculative decoding against greedy on the same crops: the first token
# comes from the verify pass (plain multi-token attention) in one and from
# the block kernels in the other, a teacher-forced comparison of one step
MIN_SPEC_FIRST_TOKEN = 0.8
BEAMS = 4
# the port's kernels, as the profiler names them
PORTED_KERNELS = ("flash_head", "flash_stream", "self_attn_tiled_kernel",
                  "cross_attn_kernel", "cross_attn_tiled_kernel",
                  "mlp_ln_kernel", "mlp_gemm_kernel",
                  "self_qkv_kernel", "self_attn_kernel", "block_out_kernel",
                  "cross_q_kernel", "layernorm_kernel", "layernorm_vec_kernel",
                  "layernorm_bwd_regs", "layernorm_bwd_sum",
                  "layernorm_bwd_rows", "layernorm_bwd_cols",
                  "raycast_kernel", "preprocess_kernel")
# the self block's and the cross block's three launches (decode_block.cu);
# both end in block_out_kernel, which belongs to the block whose first
# launch came last before it
SELF_BLOCK_KERNELS = ("self_qkv_kernel", "self_attn_kernel",
                      "block_out_kernel")
CROSS_BLOCK_KERNELS = ("cross_q_kernel", "cross_attn_kernel",
                       "block_out_kernel")
# a kernel's name with its template arguments, out of a profiler key
KERNEL_NAME = re.compile(r"\w+(<[^>]*>)?(?=[(])")


def kernel_name(key: str) -> str:
    """A kernel's name with its template arguments, out of a profiler key
    (the key itself where it names no kernel)."""
    m = KERNEL_NAME.search(key)
    return m.group(0) if m else key


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def busy_us(events) -> float:
    """Device busy time of profiler events: the union of their intervals.
    A kernel started early by programmatic dependent launch waits inside
    its interval for the one before it, so summing durations would count
    that wait twice."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


# A trace can lose the records of the kernels at its two ends: the first
# kernel after the profiler starts (in every trace of one run), now and
# then the one after it, or the last one or two before it stops. So each
# traced loop starts and ends with a margin of marker kernels, a spin of
# MARKER_CYCLES and two empty ones, which the readings leave out. A traced
# loop of n calls of one wrapper launches the same kernels on every call,
# so a trace in which some kernel's launches are not a whole multiple of
# n lost one all the same: the loop is traced again (`traced_calls`), and
# every retaken trace is logged and counted in RETRACES.
MARKER = "spin_kernel"
MARKER_CYCLES = 20_000
TRACE_TRIES = 5
RETRACES: list = []  # (first kernel, traces taken) where one was retaken


def trace_marker() -> None:
    """Launch the margin of marker kernels (torch.cuda._sleep's
    spin_kernel) that starts or ends a traced loop."""
    torch.cuda._sleep(MARKER_CYCLES)
    for _ in range(2):
        torch.cuda._sleep(1)


def device_events(prof) -> list:
    return [e for e in prof.events()
            if e.device_type.name == "CUDA" and MARKER not in e.name]


def lost_launches(events, calls: int) -> dict:
    """{kernel: launches} of the kernels whose launches in a trace of
    `calls` calls are not a whole multiple of `calls`."""
    counts = collections.Counter(e.name for e in events)
    return {k: n for k, n in counts.items() if n % calls}


def traced_calls(fn, calls: int):
    """Device events of a torch.profiler trace of `calls` calls of `fn`,
    between markers, in which every kernel launched a whole multiple of
    `calls` times; traced again, TRACE_TRIES times at most, where a trace
    comes back without device events or short of a launch (see MARKER)."""
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_marker()
            for _ in range(calls):
                fn()
            trace_marker()
            torch.cuda.synchronize()
        events = device_events(prof)
        lost = lost_launches(events, calls)
        if events and not lost:
            if tries > 1:
                RETRACES.append((kernel_name(events[0].name), tries))
            return events
        log(f"  (trace {tries} of {calls} calls: "
            + (", ".join(f"{kernel_name(k)} {n} launches"
                         for k, n in lost.items()) or "no device events")
            + "; traced again)")
    raise AssertionError(f"no whole trace of {calls} calls in {TRACE_TRIES} "
                         f"tries")


def device_profile(fn, iters: int = 10) -> tuple:
    """(device busy time per call of `fn`, {kernel: device time per call})
    from a torch.profiler run of its timing loop: the kernels' own time,
    without the host's cost of enqueueing them (see MARKER)."""
    fn()
    torch.cuda.synchronize()
    events = traced_calls(fn, iters)
    by_kernel: dict = {}
    for e in events:
        k = kernel_name(e.name)
        by_kernel[k] = (by_kernel.get(k, 0.0)
                        + (e.time_range.end - e.time_range.start) / iters)
    return busy_us(events) / iters, by_kernel


def device_us(fn, iters: int = 10) -> float:
    """Device busy time per call of `fn` (see device_profile)."""
    return device_profile(fn, iters)[0]


def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> dict:
    """A kernel wrapper's time per call in a timing loop (host cost
    included) and its device time per call."""
    return dict(ms=time_ms(fn, iters, warmup), device_us=device_us(fn))


def library(fn, iters: int = 20) -> dict:
    """The yardstick of one PyTorch call computing a kernel's function:
    its timing-loop time (host cost included) and its device time per
    call, the latter to set beside the kernel's own device time."""
    return dict(library_ms=time_ms(fn, iters), library_device_us=device_us(fn))


NO_LIBRARY = dict(library_ms=None, library_device_us=None)


def cold_l2(fn, inputs: tuple, iters: int = 20) -> dict:
    """A kernel wrapper's timing-loop time and device time per call with
    its inputs cold in L2, as a caller finds them that reads other data
    between calls: fn(*inputs) runs on copies of the tensors `inputs` in
    turn, so many that together they are over twice the L2's size, so each
    call reads a copy last read that many bytes ago."""
    n = max(2, math.ceil(2 * L2_BYTES / nbytes(*inputs)))
    copies = [inputs] + [tuple(x.clone() for x in inputs)
                         for _ in range(n - 1)]
    turn = itertools.cycle(copies)

    def call():
        return fn(*next(turn))

    return dict(cold_ms=time_ms(call, iters), cold_device_us=device_us(call),
                cold_copies=n)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def to_device(x, dev):
    """Tensors, dicts, lists and named tuples of them, on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, dev) for v in x]
    if x is None:
        return None
    return type(x)(*(to_device(v, dev) for v in x))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float) -> float:
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    rel = (diff / want.float().abs().clamp(min=1e-6)).max().item()
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {atol:.1e}), "
        f"max_rel_err {rel:.3e}")
    if not math.isfinite(err) or err > atol:
        raise AssertionError(f"{name}: max_abs_err {err} > {atol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# decode_self_attention's cases at ROWS rows and 12 heads of 64: (case,
# cache positions, position). a: the last step of a caption, as the
# earlier rows timed it; b: the decode loop's average position; c: a cache
# too long for the self block, the route check's (tiled kernel)
SELF_ATTENTION_CASES = (("a", DECODE_LEN, DECODE_LEN - 1),
                        ("b", DECODE_LEN, 14), ("c", 1024, 1023))


def self_attention_cases(K, dev) -> list:
    """decode_self_attention at SELF_ATTENTION_CASES and at edge shapes
    against its plain version (f32 out; tolerance 1e-3 covers summation
    order), run twice for equal bits; the cases timed warm and with their
    inputs cold in L2, beside the bound over the live keys (q, the K/V of
    positions 0..pos, the output), the bound over all T positions (as
    earlier rows counted it), the plain version and SDPA over the same
    live keys."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, dh = ROWS, 12, 64

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    cases = []
    for case, t, pos in SELF_ATTENTION_CASES:
        q, kc, vc = rn(b, h, dh), rn(b, h, dh, t), rn(b, t, h, dh)
        name = (f"decode_self_attention case {case} [{b},{h},{dh}] T={t} "
                f"pos={pos}")
        got = K.decode_self_attention(q, kc, vc, pos)
        err = check_close(name, got, K.decode_self_attention_plain(
            q, kc, vc, pos), 1e-3)
        if not torch.equal(got, K.decode_self_attention(q, kc, vc, pos)):
            raise AssertionError(f"{name}: two runs on the same inputs "
                                 f"differ")
        live = pos + 1
        out = torch.empty(b, h, dh, device=dev)
        lb, lf = bound_ms(nbytes(q, out) + 2 * 2 * b * h * dh * live,
                          4 * b * h * dh * live)
        ab = bound_ms(nbytes(q, kc, vc, out), 4 * b * h * dh * t)[0]
        k_l = kc.transpose(-1, -2)[:, :, :live]
        v_l = vc.permute(0, 2, 1, 3)[:, :, :live]
        iters = 100 if t <= DECODE_LEN else 20
        cases.append(dict(
            case=case, shape=[b, h, dh], cache=t, pos=pos, max_abs_err=err,
            **kernel_ms(lambda: K.decode_self_attention(q, kc, vc, pos),
                        iters),
            **cold_l2(lambda *a: K.decode_self_attention(*a, pos),
                      (q, kc, vc), iters),
            plain_ms=time_ms(lambda: K.decode_self_attention_plain(
                q, kc, vc, pos), iters),
            bound_ms=lb, bound_by=lf, bound_all_t_ms=ab,
            **library(lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k_l, v_l), iters)))
        del q, kc, vc, k_l, v_l
    # edges: caches not a multiple of 8 long (the tiled kernel's K rows at
    # every granule offset), heads 8 wide (16 PV groups), 48 wide (tiles
    # of 128 keys), 256 and 512 wide (tiles of 24 and 8 keys, 2 and 4 PV
    # chunks), early positions of a long cache
    for n, hh, dd, tt, pos in ((3, 2, 8, 30, 17), (2, 3, 64, 1001, 1000),
                               (2, 3, 64, 1001, 517), (2, 2, 48, 2000, 1999),
                               (1, 2, 256, 901, 450), (1, 2, 512, 200, 199),
                               (2, 3, 64, 4096, 40)):
        q, kc, vc = rn(n, hh, dd), rn(n, hh, dd, tt), rn(n, tt, hh, dd)
        name = f"decode_self_attention [{n},{hh},{dd}] T={tt} pos={pos}"
        got = K.decode_self_attention(q, kc, vc, pos)
        check_close(name, got, K.decode_self_attention_plain(
            q, kc, vc, pos), 1e-3)
        if not torch.equal(got, K.decode_self_attention(q, kc, vc, pos)):
            raise AssertionError(f"{name}: two runs on the same inputs "
                                 f"differ")
    log(f"  decode_self_attention: two runs give equal bits at every case")
    # the tiled kernel (a cache of 840) sums in the whole-head kernel's
    # order (a cache of 839 holding the same live keys): the same bits
    kc, vc = rn(4, h, dh, 840), rn(4, 840, h, dh)
    q = rn(4, h, dh)
    tiled = K.decode_self_attention(q, kc, vc, 700)
    whole = K.decode_self_attention(q, kc[..., :839].contiguous(),
                                    vc[:, :839].contiguous(), 700)
    if not torch.equal(tiled, whole):
        raise AssertionError("decode_self_attention: the tiled kernel "
                             "differs from the whole-head kernel")
    log("  decode_self_attention: the tiled kernel at a cache of 840 gives "
        "the whole-head kernel's bits at 839")
    return cases


def kernel_checks(K, QZ, dev) -> dict:
    """Kernel vs plain at the main path's shapes: FRAMES x SLOTS = ROWS
    crops; ViT-L attention [ROWS, 16, 257, 64]; decode batch ROWS, 12 heads
    of 64, self cache T=30, cross K=256 int8; MLP 768 -> 3072 -> 768 int8."""
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}

    # flash attention ------------------------------------------------------
    # tolerance: bf16 outputs of |o| < 2 whose f32 sums run in another
    # order (a flipped rounding of p or o is 1-2 bf16 ulps). Edges: every
    # head dim at T = 1, 16, 65, 257 (one key and one query past a tile),
    # causal and valid_len < T; T = 640 at D = 128 goes through the
    # streaming kernel, whose K/V do not fit one block
    for d in (32, 64, 128):
        for tt in (1, 16, 65, 257) + ((640,) if d == 128 else ()):
            for causal, vl in ((False, None), (True, None),
                               (False, max(1, tt - 5)), (True, max(1, tt - 5))):
                if tt == 1 and vl is not None:
                    continue
                qs, ks, vs = rn(2, 4, tt, d), rn(2, 4, tt, d), rn(2, 4, tt, d)
                n = vl or tt
                check_close(f"flash_attention [2,4,{tt},{d}] causal={causal} "
                            f"valid_len={vl}",
                            K.flash_attention(qs, ks, vs, causal, vl)[:, :, :n],
                            K.flash_attention_plain(qs, ks, vs, causal,
                                                    vl)[:, :, :n], 2e-2)
    b, h, t, d = ROWS, 16, 257, 64
    q, k, v = rn(b, h, t, d), rn(b, h, t, d), rn(b, h, t, d)
    err = check_close(f"flash_attention [{b},{h},{t},{d}]",
                      K.flash_attention(q, k, v),
                      K.flash_attention_plain(q, k, v), 2e-2)
    for causal, tt, vl in ((True, 257, None), (False, 640, 600),
                           (True, 640, 600)):
        qs, ks, vs = rn(2, 4, tt, d), rn(2, 4, tt, d), rn(2, 4, tt, d)
        check_close(f"flash_attention [2,4,{tt},64] causal={causal} "
                    f"valid_len={vl}",
                    K.flash_attention(qs, ks, vs, causal, vl)[:, :, :vl or tt],
                    K.flash_attention_plain(qs, ks, vs, causal,
                                            vl)[:, :, :vl or tt], 2e-2)
    fb, ff = bound_ms(4 * nbytes(q), 4 * b * h * t * t * d)
    qt, kt_, vt = (x.contiguous() for x in (q, k, v))
    rows["flash_attention"] = dict(
        source=PORT_KERNELS + "flash_attention.cu",
        replaces=TPU_KERNELS + "flash_attention.py:147",
        max_abs_err=err,
        **kernel_ms(lambda: K.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: K.flash_attention_plain(q, k, v), 5, 1),
        bound_ms=fb, bound_by=ff,
        **library(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt_, vt)))

    # the same kernel at T = 640, where the TPU package switches to its
    # blocked kernel (not reached at ViT-L, T = 257): timed for the record
    t6 = 640
    q6, k6, v6 = rn(b, h, t6, d), rn(b, h, t6, d), rn(b, h, t6, d)
    err6 = check_close(f"flash_attention [{b},{h},{t6},{d}]",
                       K.flash_attention(q6, k6, v6),
                       K.flash_attention_plain(q6, k6, v6), 2e-2)
    fb6, ff6 = bound_ms(4 * nbytes(q6), 4 * b * h * t6 * t6 * d)
    rows["flash_attention"]["cases"] = [dict(
        shape=[b, h, t6, d], replaces=TPU_KERNELS + "flash_attention.py:166",
        max_abs_err=err6,
        **kernel_ms(lambda: K.flash_attention(q6, k6, v6), 5, 1),
        plain_ms=time_ms(lambda: K.flash_attention_plain(q6, k6, v6), 3, 1),
        bound_ms=fb6, bound_by=ff6,
        **library(lambda: torch.nn.functional.scaled_dot_product_attention(
            q6, k6, v6)))]
    del q6, k6, v6

    # decode self-attention: cases a-c (self_attention_cases) ---------------
    cases = self_attention_cases(K, dev)
    rows["decode_self_attention"] = dict(
        source=PORT_KERNELS + "attention.cuh",
        replaces=TPU_KERNELS + "decode_attention.py:82",
        **cases[0], cases=cases[1:])
    b, h, dh = ROWS, 12, 64
    out = torch.empty(b, h, dh, device=dev)

    # decode cross-attention over int8 K/V ---------------------------------
    nk = 256
    q = rn(b, h, dh)
    qkv = QZ.quantize_kv(rn(b, h, dh, nk), rn(b, nk, h, dh))
    kt8, v8 = qkv.kt.contiguous(), qkv.v.permute(0, 2, 1, 3).contiguous()
    ks, vs = qkv.kt_scale.contiguous(), qkv.v_scale.contiguous()
    err = check_close("decode_cross_attention int8",
                      K.decode_cross_attention(q, kt8, v8, ks, vs),
                      K.decode_cross_attention_plain(q, kt8, v8, ks, vs),
                      1e-3)
    ktb, vb = rn(b, h, dh, nk), rn(b, h, nk, dh)
    check_close("decode_cross_attention bf16",
                K.decode_cross_attention(q, ktb, vb),
                K.decode_cross_attention_plain(q, ktb, vb), 1e-3)
    # the tiny preset's heads (2 of 32 over 16 keys); then the shapes of
    # the tiled kernel: 11 keys (one tile, copied element by element into
    # rows padded to 12), heads 8 wide, and K/V beyond one block's shared
    # memory, which go through in tiles of keys with an online softmax:
    # 4096 keys (tiles of 16-byte rows), 1001 (rows copied element by
    # element) and heads 4096 wide (one group of PV threads, tiles of 8
    # keys at bf16)
    for n, hh, dd, kk in ((4, 2, 32, 16), (3, 2, 32, 11), (3, 4, 64, 11),
                          (3, 2, 8, 11), (2, 3, 64, 4096),
                          (2, 3, 64, 1001), (1, 2, 4096, 37)):
        qx = rn(n, hh, dd)
        sx = QZ.quantize_kv(rn(n, hh, dd, kk), rn(n, kk, hh, dd))
        args8 = (sx.kt.contiguous(), sx.v.permute(0, 2, 1, 3).contiguous(),
                 sx.kt_scale.contiguous(), sx.v_scale.contiguous())
        args16 = (rn(n, hh, dd, kk), rn(n, hh, kk, dd))
        for kind, ax in (("int8", args8), ("bf16", args16)):
            check_close(f"decode_cross_attention {kind} [{n},{hh},{dd}] x "
                        f"{kk} keys", K.decode_cross_attention(qx, *ax),
                        K.decode_cross_attention_plain(qx, *ax), 1e-3)
    cb, cf = bound_ms(nbytes(q, kt8, v8, ks, vs, out), 4 * b * h * dh * nk)
    rows["decode_cross_attention"] = dict(
        source=PORT_KERNELS + "decode_attention.cu",
        replaces=TPU_KERNELS + "decode_attention.py:137",
        max_abs_err=err,
        **kernel_ms(lambda: K.decode_cross_attention(q, kt8, v8, ks, vs),
                    100),
        plain_ms=time_ms(lambda: K.decode_cross_attention_plain(
            q, kt8, v8, ks, vs), 100),
        bound_ms=cb, bound_by=cf,
        **cold_l2(K.decode_cross_attention, (q, kt8, v8, ks, vs), 100),
        **NO_LIBRARY)  # no PyTorch call takes int8 K/V with scales

    # decode MLP (tolerance: bf16 output of |x + y| < 8): int8 and bf16
    # weights at every row count the decode paths use (64: perceive and
    # 16 crops x 4 beams; 16: speculative; 1-8: tiny) and one past a
    # multiple of 16; two runs on the same inputs give the same bits (the
    # split-K reduction sums in a fixed order)
    dm, f = 768, 3072
    lg, lb = 1.0 + rn(dm, scale=0.1, dtype=torch.float32), rn(
        dm, scale=0.1, dtype=torch.float32)
    wfc = QZ.quantize_array(rn(dm, f, scale=dm ** -0.5, dtype=torch.float32))
    wpj = QZ.quantize_array(rn(f, dm, scale=f ** -0.5, dtype=torch.float32))
    bfc, bpj = rn(f, scale=0.02, dtype=torch.float32), rn(
        dm, scale=0.02, dtype=torch.float32)
    w8 = (wfc.q, wfc.scale, bfc, wpj.q, wpj.scale, bpj)
    w16 = (wfc.dequantize(), torch.ones_like(wfc.scale), bfc,
           wpj.dequantize(), torch.ones_like(wpj.scale), bpj)
    for n in (1, 16, 17, b):
        xr = rn(n, dm)
        for kind, ws in (("int8", w8), ("bf16", w16)):
            args = (xr, lg, lb, *ws)
            got = K.decode_mlp(*args)
            e = check_close(f"decode_mlp {kind} [{n},{dm}]", got,
                            K.decode_mlp_plain(*args), 5e-2)
            if not torch.equal(got, K.decode_mlp(*args)):
                raise AssertionError(f"decode_mlp {kind} [{n},{dm}]: two runs "
                                     f"on the same inputs differ")
            if n == b and kind == "int8":
                err, x = e, xr
    # the tiny preset's width (D=64, F=256: one-step contraction slices)
    xt = rn(4, 64)
    lgt = 1.0 + rn(64, scale=0.1, dtype=torch.float32)
    lbt = rn(64, scale=0.1, dtype=torch.float32)
    wft = QZ.quantize_array(rn(64, 256, scale=0.125, dtype=torch.float32))
    wpt = QZ.quantize_array(rn(256, 64, scale=0.0625, dtype=torch.float32))
    targs = (xt, lgt, lbt, wft.q, wft.scale, rn(256, scale=0.02,
                                                 dtype=torch.float32),
             wpt.q, wpt.scale, rn(64, scale=0.02, dtype=torch.float32))
    got = K.decode_mlp(*targs)
    check_close("decode_mlp int8 [4,64] -> 256", got,
                K.decode_mlp_plain(*targs), 5e-2)
    if not torch.equal(got, K.decode_mlp(*targs)):
        raise AssertionError("decode_mlp [4,64]: two runs differ")
    log(f"  decode_mlp: two runs give equal bits at every shape above")
    margs = (x, lg, lb, *w8)
    mb, mf = bound_ms(nbytes(x, lg, lb, wfc.q, wfc.scale, bfc, wpj.q,
                             wpj.scale, bpj, x), 4 * b * dm * f)
    w1, w2 = wfc.dequantize(), wpj.dequantize()
    xn = x.clone()

    def two_matmuls():
        hh = torch.nn.functional.gelu(torch.matmul(xn, w1), approximate="tanh")
        return x + torch.matmul(hh, w2)

    rows["decode_mlp"] = dict(
        source=PORT_KERNELS + "decode_mlp.cu",
        replaces=TPU_KERNELS + "decode_attention.py:186",
        max_abs_err=err,
        **kernel_ms(lambda: K.decode_mlp(*margs), 100),
        plain_ms=time_ms(lambda: K.decode_mlp_plain(*margs), 100),
        bound_ms=mb, bound_by=mf,
        **library(two_matmuls, 100))
    log_rows(rows)
    return rows


def log_rows(rows: dict) -> None:
    for name, r in rows.items():
        for c in [r] + r.get("cases", []):
            lib = ("n/a" if c["library_ms"] is None
                   else f"{c['library_ms'] * 1e3:.1f} us "
                   f"({c['library_device_us']:.1f} us on the device)")
            what = f"{name} {c['case']}" if "case" in c else (
                f"{name} {c['shape']}" if "shape" in c else name)
            copy = (f", a copy of the same bytes "
                    f"{c['copy_device_us']:.1f} us on the device"
                    if "copy_device_us" in c else "")
            cold = (f", inputs cold in L2 {c['cold_ms'] * 1e3:.1f} us "
                    f"({c['cold_device_us']:.1f} us on the device; "
                    f"{c['cold_copies']} copies)" if "cold_ms" in c else "")
            all_t = (f", over all T {c['bound_all_t_ms'] * 1e3:.2f} us"
                     if "bound_all_t_ms" in c else "")
            extra = (f" ({c['partials_bytes'] / 1e3:.0f} kB of float32 "
                     f"partials written and read besides: the design's "
                     f"overhead, not in the bound)"
                     if "partials_bytes" in c else "")
            log(f"  {what}: {c['ms'] * 1e3:.1f} us kernel "
                f"({c['device_us']:.1f} us on the device){cold}, "
                f"{c['plain_ms'] * 1e3:.1f} us plain, bound "
                f"{c['bound_ms'] * 1e3:.2f} us ({c['bound_by']}){extra}"
                f"{all_t}, library {lib}{copy}")


def generation_kernel_checks(K, QZ, dev) -> dict:
    """The whole-block decode kernels and the fused preprocess against
    their plain versions at the decode shapes (ROWS rows, D=768, 12 heads
    of 64, cache T=30, cross K=256; also 1 and 17 rows and the tiny
    preset's width) and at the ROWS crops of a batch.
    `unfused_ms` is the same sublayer on the route of separate calls
    (LayerNorm, projections, decode attention kernel), host cost
    included: a yardstick, as no one PyTorch call computes a sublayer."""
    from embodied_captioning_tpu_torch.models import common as TC

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    b, d, h, t, nk = ROWS, 768, 12, DECODE_LEN, 256
    dh = d // h
    x = rn(b, d)
    lg = 1.0 + rn(d, scale=0.1, dtype=torch.float32)
    lb = rn(d, scale=0.1, dtype=torch.float32)
    p_ln = {"g": lg, "b": lb}

    def weights(names, int8, width=d):
        """(flat kernel arguments, the params dict `mha` takes)."""
        flat, p = [], {}
        for n in names:
            w = rn(width, width, scale=width ** -0.5, dtype=torch.float32)
            bias = rn(width, scale=0.02, dtype=torch.float32)
            if int8:
                q = QZ.quantize_array(w)
                flat += [q.q, q.scale.float(), bias]
                p[n] = {"w": q, "b": bias}
            else:
                flat += [w.to(bf), torch.ones(width, device=dev), bias]
                p[n] = {"w": w.to(bf), "b": bias}
        return flat, p

    # tolerance: bf16 outputs of |x + y| < 8 (an ulp is 1/32) and cache
    # entries of |k|, |v| < 4 (1/64); the tensor cores sum in another order
    # than the plain version's matmul, so a rounding flips here and there
    def self_case(name, xx, g_ln, b_ln, ws, heads, cache_len, pos):
        """The self block against its twin on copies of the same seeded
        caches, then a second run, which must give the same bits (its
        split-K and attention sums run in a fixed order)."""
        n, width = xx.shape
        kc = rn(n, heads, width // heads, cache_len)
        vc = rn(n, cache_len, heads, width // heads)
        kc2, vc2, kc3, vc3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        args = (xx, g_ln, b_ln, *ws)
        out, _, _ = K.decode_self_block(*args, kc, vc, pos, heads)
        ref, _, _ = K.decode_self_block_plain(*args, kc2, vc2, pos, heads)
        err = check_close(name, out, ref, 1 / 16)
        check_close("  cache k", kc, kc2, 1 / 32)
        check_close("  cache v", vc, vc2, 1 / 32)
        again, _, _ = K.decode_self_block(*args, kc3, vc3, pos, heads)
        if not (torch.equal(out, again) and torch.equal(kc, kc3)
                and torch.equal(vc, vc3)):
            raise AssertionError(f"{name}: two runs on the same inputs "
                                 f"differ")
        return err

    errs = {}
    for int8 in (True, False):
        ws, p_attn = weights("qkvo", int8)
        for pos in (0, 1, t - 1):
            name = f"decode_self_block {'int8' if int8 else 'bf16'} pos={pos}"
            errs[name] = self_case(name, x, lg, lb, ws, h, t, pos)
        if int8:
            kc, vc = rn(b, h, dh, t), rn(b, t, h, dh)
            args = (x, lg, lb, *ws, kc, vc, t - 1, h)
            x3 = x[:, None]
            sb, sf = bound_ms(nbytes(x, lg, lb, *ws, kc, vc, x)
                              + 2 * b * d * 2,
                              4 * 2 * b * d * d + 4 * b * h * dh * t)
            # a single crop, one past a row tile of 16 (speculative decoding
            # runs 16 rows, beam search 64) and the tiny preset's width
            for n, width, heads, tt in ((1, d, h, t), (17, d, h, t),
                                        (4, 64, 2, 12)):
                g_n = 1.0 + rn(width, scale=0.1, dtype=torch.float32)
                b_n = rn(width, scale=0.1, dtype=torch.float32)
                xn = rn(n, width)
                for w8 in (True, False):
                    wn, _ = weights("qkvo", w8, width)
                    for pos in (0, 1, tt - 1):
                        name = (f"decode_self_block "
                                f"{'int8' if w8 else 'bf16'} [{n},{width}] "
                                f"pos={pos}")
                        errs[name] = self_case(name, xn, g_n, b_n, wn, heads,
                                               tt, pos)
            log("  decode_self_block: two runs give equal bits at every "
                "shape above")
            self_busy, self_launches = device_profile(
                lambda: K.decode_self_block(*args), 20)
            rows["decode_self_block"] = dict(
                source=PORT_KERNELS + "decode_block.cu",
                replaces=TPU_KERNELS + "decode_attention.py:267",
                max_abs_err=max(v for k, v in errs.items() if "self" in k),
                device_us_by_launch=self_launches,
                **kernel_ms(lambda: K.decode_self_block(*args), 100),
                plain_ms=time_ms(lambda: K.decode_self_block_plain(*args),
                                 20),
                bound_ms=sb, bound_by=sf, **NO_LIBRARY,
                unfused_ms=time_ms(lambda: x3 + TC.mha(
                    p_attn, TC.layernorm(p_ln, x3), h,
                    cache=TC.KVCache(kc, vc, t - 1))[0], 100))

    def cross_kv(n, heads, width, keys, kv8):
        """(the kernel's kt, v, kt_scale, v_scale, the K/V `mha` takes)."""
        dd = width // heads
        if kv8:
            qkv = QZ.quantize_kv(rn(n, heads, dd, keys),
                                 rn(n, keys, heads, dd))
            ckv = qkv._replace(kt=qkv.kt.contiguous(),
                               v=qkv.v.permute(0, 2, 1, 3).contiguous(),
                               kt_scale=qkv.kt_scale.contiguous(),
                               v_scale=qkv.v_scale.contiguous())
            return (ckv.kt, ckv.v, ckv.kt_scale, ckv.v_scale), ckv
        ckv = (rn(n, heads, dd, keys), rn(n, heads, keys, dd))
        return (*ckv, None, None), ckv

    def cross_case(name, xx, g_ln, b_ln, ws, heads, kv):
        """The cross block against its twin, then a second run, which must
        give the same bits."""
        args = (xx, g_ln, b_ln, *ws, *kv)
        out = K.decode_cross_block(*args, heads=heads)
        err = check_close(name, out,
                          K.decode_cross_block_plain(*args, heads=heads),
                          1 / 16)
        if not torch.equal(out, K.decode_cross_block(*args, heads=heads)):
            raise AssertionError(f"{name}: two runs on the same inputs "
                                 f"differ")
        return err

    for int8 in (True, False):
        ws, p_x = weights("qo", int8)
        for kv8 in (True, False):
            kv, ckv = cross_kv(b, h, d, nk, kv8)
            name = (f"decode_cross_block {'int8' if int8 else 'bf16'} weights "
                    f"{'int8' if kv8 else 'bf16'} K/V")
            errs[name] = cross_case(name, x, lg, lb, ws, h, kv)
            if int8 and kv8:
                cargs = (x, lg, lb, *ws, *kv)
                x3 = x[:, None]
                cb, cf = bound_ms(nbytes(x, lg, lb, *ws, *kv, x),
                                  2 * 2 * b * d * d + 4 * b * h * dh * nk)
                timed = dict(
                    **kernel_ms(lambda: K.decode_cross_block(*cargs, heads=h),
                                100),
                    plain_ms=time_ms(lambda: K.decode_cross_block_plain(
                        *cargs, heads=h), 20),
                    bound_ms=cb, bound_by=cf, **NO_LIBRARY,
                    unfused_ms=time_ms(lambda: x3 + TC.mha(
                        p_x, TC.layernorm(p_ln, x3), h,
                        kv_precomputed=ckv)[0], 100))
    # a single crop, one past a row tile of 16, the tiny preset's width
    # (2 heads of 32 over 16 keys) and cross K/V too long for one block's
    # shared memory (tiles of keys), every weight and K/V type
    for n, width, heads, keys in ((1, d, h, nk), (17, d, h, nk),
                                  (4, 64, 2, 16), (4, d, h, 2048)):
        g_n = 1.0 + rn(width, scale=0.1, dtype=torch.float32)
        b_n = rn(width, scale=0.1, dtype=torch.float32)
        xn = rn(n, width)
        for w8 in (True, False):
            wn, _ = weights("qo", w8, width)
            for kv8 in (True, False):
                kv, _ = cross_kv(n, heads, width, keys, kv8)
                name = (f"decode_cross_block {'int8' if w8 else 'bf16'} "
                        f"weights {'int8' if kv8 else 'bf16'} K/V "
                        f"[{n},{width}]")
                errs[name] = cross_case(name, xn, g_n, b_n, wn, heads, kv)
    log("  decode_cross_block: two runs give equal bits at every shape above")
    cross_busy, cross_launches = device_profile(
        lambda: K.decode_cross_block(*cargs, heads=h), 20)
    rows["decode_cross_block"] = dict(
        source=PORT_KERNELS + "decode_block.cu",
        replaces=TPU_KERNELS + "decode_attention.py:338",
        max_abs_err=max(v for k, v in errs.items() if "cross" in k),
        device_us_by_launch=cross_launches, **timed)

    # fused preprocess: equal bit for bit (every operation spelled with
    # its rounding, IEEE divisions, the taps shared with the plain
    # version)
    def crops(n, size):
        return torch.randint(0, 256, (n, size, size, 3), generator=g,
                             device=dev, dtype=torch.uint8)

    # true resizes up and down, sources whose rows are not a multiple of 4
    # pixels (150, 333: staged byte by byte), patch 16, and an odd patch
    # (the run-time patch instance, stored float by float); a frame-sized
    # downsize is timed below
    for n, size, out_size, patch in ((8, 320, 224, 14), (8, 150, 224, 14),
                                     (3, 40, 64, 8), (4, 224, 224, 16),
                                     (4, 333, 224, 14), (3, 50, 63, 7)):
        img = crops(n, size)
        check_close(f"fused_preprocess [{n},{size},{size},3] -> {out_size}",
                    K.fused_preprocess(img, out_size, patch),
                    K.fused_preprocess_plain(img, out_size, patch), 0.0)
    img = crops(ROWS, 224)
    tokens = K.fused_preprocess(img, 224, 14)
    err = check_close(f"fused_preprocess [{ROWS},224,224,3] -> 224", tokens,
                      K.fused_preprocess_plain(img, 224, 14), 0.0)
    pb, pf = bound_ms(nbytes(img, tokens), 12 * tokens.numel(),
                      FP32_FLOP_PER_S)
    sass = preprocess_sass(K.build())
    log_preprocess_sass(sass)
    rows["fused_preprocess"] = dict(
        source=PORT_KERNELS + "preprocess.cu",
        replaces=TPU_KERNELS + "preprocess.py:83",
        max_abs_err=err,
        **kernel_ms(lambda: K.fused_preprocess(img, 224, 14), 50),
        plain_ms=time_ms(lambda: K.fused_preprocess_plain(img, 224, 14), 10),
        bound_ms=pb, bound_by=pf, **NO_LIBRARY,
        sass=sass.get("preprocess_kernel<14>"))
    # a frame-sized downsize, 16 crops of 1280^2 (read from device memory);
    # its bound counts the source pixels the taps touch, not whole frames
    from embodied_captioning_tpu_torch.kernels.preprocess import source_taps

    frames = crops(FRAMES, 1280)
    big = K.fused_preprocess(frames, 224, 14)
    t0, t1, _ = source_taps(224, 1280, dev)
    touched = torch.unique(torch.cat([t0, t1])).numel()
    fb, ff = bound_ms(FRAMES * touched * touched * 3 + nbytes(big),
                      12 * big.numel(), FP32_FLOP_PER_S)
    rows["fused_preprocess"]["cases"] = [dict(
        case=f"[{FRAMES},1280,1280,3] -> 224",
        replaces=TPU_KERNELS + "preprocess.py:83",
        max_abs_err=check_close(
            f"fused_preprocess [{FRAMES},1280,1280,3] -> 224", big,
            K.fused_preprocess_plain(frames, 224, 14), 0.0),
        **kernel_ms(lambda: K.fused_preprocess(frames, 224, 14), 50),
        plain_ms=time_ms(lambda: K.fused_preprocess_plain(frames, 224, 14),
                         10),
        bound_ms=fb, bound_by=ff, **NO_LIBRARY)]
    log_rows(rows)
    for name in ("decode_self_block", "decode_cross_block"):
        log(f"  {name}: the same sublayer as separate calls "
            f"{rows[name]['unfused_ms'] * 1e3:.1f} us")
    for name, busy, launches in (
            (f"decode_self_block [{b},{d}] int8, cache {t}", self_busy,
             self_launches),
            (f"decode_cross_block [{b},{d}] int8, {nk} int8 keys",
             cross_busy, cross_launches)):
        log(f"  {name}: {busy:.1f} us on the device per call; launch "
            f"durations " + ", ".join(f"{k} {v:.1f} us"
                                      for k, v in launches.items())
            + " (the second and third launches start early under "
            "programmatic dependent launch and wait inside their durations)")
    return rows


def route_checks(K, dev) -> None:
    """`common.block`, one decode step of ROWS rows, on the card at shapes
    where not every sublayer takes its fused kernel (`decode_route`): 96
    wide with 2 heads of 48 (the self block's q/k/v product takes widths a
    multiple of 64: that sublayer runs as separate calls, the cross block
    and the MLP fuse), 64 wide with 16 heads of 4 (both attention
    sublayers run as separate calls with the attention itself as plain
    ops, as the reference does for heads not a multiple of 8 wide), and
    the large preset's width, 768 with 12 heads of 64, at a self-attention
    cache of 1024 positions (more than the self block's shared memory
    holds: that sublayer runs as separate calls, `decode_self_attention`'s
    tiled kernel among them) beside the same step at the preset's cache of
    DECODE_LEN (every sublayer fused). Each must launch the kernels its route names
    and match the same step on the CPU, where every wrapper runs its plain
    version (tolerance: bf16 outputs of |x + y| < 8, cache entries of |k|,
    |v| < 4)."""
    from embodied_captioning_tpu_torch.models import common as TC
    from embodied_captioning_tpu_torch.models.quantize import quantize_params

    separate = {"layernorm": 1, "decode_self_attention": 1,
                "decode_cross_block": 1, "decode_mlp": 1}
    for d, heads, cache_len, want in (
            (96, 2, DECODE_LEN, separate),
            (64, 16, DECODE_LEN, {"layernorm": 2, "decode_mlp": 1}),
            (768, 12, 1024, separate),
            (768, 12, DECODE_LEN, {"decode_self_block": 1,
                                   "decode_cross_block": 1,
                                   "decode_mlp": 1})):
        g = torch.Generator().manual_seed(d + heads)
        p = quantize_params(TC.block_init(g, d, 4.0, "cpu", cross_dim=d),
                            min_size=0)
        dh = d // heads
        x = torch.randn(ROWS, 1, d, generator=g).bfloat16()
        kc = torch.randn(ROWS, heads, dh, cache_len, generator=g).bfloat16()
        vc = torch.randn(ROWS, cache_len, heads, dh, generator=g).bfloat16()
        img = torch.randn(ROWS, 256, d, generator=g).bfloat16()
        ckv = TC.precompute_kv(p["xattn"], img, heads)
        pos = cache_len - 5
        ref, rc = TC.block(p, x, heads, cache=TC.KVCache(kc.clone(),
                                                         vc.clone(), pos),
                           cross_kv=ckv)
        K.reset_launches()
        out, oc = TC.block(to_device(p, dev), x.to(dev), heads,
                           cache=TC.KVCache(kc.to(dev), vc.to(dev), pos),
                           cross_kv=to_device(ckv, dev))
        torch.cuda.synchronize()
        got = {k: v for k, v in K.launches.items() if v}
        name = (f"common.block [{ROWS},1,{d}], {heads} heads of {dh}, cache "
                f"{cache_len}")
        if got != want:
            raise AssertionError(f"{name}: launches {got}, route names "
                                 f"{want}")
        check_close(f"{name} on the card vs the CPU", out.cpu(), ref, 1 / 16)
        check_close("  cache k", oc.k.cpu(), rc.k, 1 / 32)
        check_close("  cache v", oc.v.cpu(), rc.v, 1 / 32)
        log(f"  {name}: launches {got}")


# one SASS instruction: its address, a predicate, its opcode and a branch
# target
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)[^;]*?(0x[0-9a-f]+)?\s*;")
SASS_CONTROL = ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "NOP", "BAR")


def sass_text(lib: Path) -> str:
    """cuobjdump -sass of a built library; empty where the toolkit has no
    cuobjdump."""
    import os
    import shutil

    exe = shutil.which("cuobjdump") or str(Path(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(exe).exists():
        return ""
    return subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_functions(text: str, name: str) -> dict:
    """{mangled name: [(address, opcode, backward-branch target or None)]}
    of each function whose name holds `name`."""
    out = {}
    for part in text.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        if name not in head:
            continue
        ins = []
        for line in body.splitlines():
            m = SASS_LINE.search(line)
            if m:
                ins.append((int(m.group(1), 16), m.group(3),
                            int(m.group(4), 16) if m.group(3) == "BRA"
                            and m.group(4) else None))
        out[head.strip()] = ins
    return out


def loop_bodies(ins) -> list:
    """The opcode counts of each loop: the instructions between a backward
    branch and its target."""
    bodies = []
    for addr, _, target in ins:
        if target is not None and target < addr:
            body = [o for a, o, _ in ins if target <= a <= addr]
            bodies.append({o: body.count(o) for o in sorted(set(body))})
    return bodies


def by_kind(counts: dict) -> dict:
    """Instruction counts split into FP32 arithmetic, memory, control and
    integer (everything else: address and index arithmetic, moves,
    byte permutes)."""
    kinds = {"fp32": 0, "memory": 0, "control": 0, "integer": 0}
    for op, n in counts.items():
        kind = ("fp32" if op[0] == "F" or op == "MUFU" else
                "memory" if op[:2] in ("LD", "ST") else
                "control" if op in SASS_CONTROL else "integer")
        kinds[kind] += n
    return kinds


def log_preprocess_sass(sass: dict) -> None:
    for fn, r in sass.items():
        loop = r.get("pixel_loop")
        log(f"  {fn} (cuobjdump -sass): {r['instructions']} instructions, "
            f"{r['by_kind']}" + (
                f"; its loop over output pixels (3 floats each) "
                f"{loop['instructions']}, {loop['by_kind']}: "
                f"{loop['by_opcode']}" if loop else
                f"; no loop: {r['by_opcode']}"))


def raycast_loop_sass(lib: Path) -> dict:
    """Instructions of raycast_kernel's box loop in the built library, by
    opcode (cuobjdump -sass): the loop body that holds the most FMNMX, and
    the boxes it handles (6 FMUL per box). Empty where the toolkit has no
    cuobjdump."""
    funcs = sass_functions(sass_text(lib), "raycast_kernel")
    bodies = [b for ins in funcs.values() for b in loop_bodies(ins)]
    best = max(bodies, key=lambda b: b.get("FMNMX", 0), default={})
    if not best.get("FMNMX"):
        return {}
    return dict(instructions=sum(best.values()),
                boxes=best.get("FMUL", 0) // 6, by_opcode=best)


def preprocess_sass(lib: Path) -> dict:
    """Instructions of each preprocess_kernel instance in a built library
    (cuobjdump -sass), by kind, and of the loop that computes one output
    pixel (the shortest loop with the IEEE division by std of each of its
    three channels: three FCHK), where there is one. Empty where the
    toolkit has no cuobjdump."""
    out = {}
    for fn, ins in sass_functions(sass_text(lib), "preprocess_kernel").items():
        ops = [o for _, o, _ in ins]
        counts = {o: ops.count(o) for o in sorted(set(ops))}
        r = dict(instructions=len(ins), by_kind=by_kind(counts),
                 by_opcode=counts)
        loops = [b for b in loop_bodies(ins) if b.get("FCHK", 0) >= 3]
        if loops:
            pixel = min(loops, key=lambda b: sum(b.values()))
            r["pixel_loop"] = dict(instructions=sum(pixel.values()),
                                   by_kind=by_kind(pixel), by_opcode=pixel)
        m = re.search(r"preprocess_kernelILi(\d+)E", fn)
        out[f"preprocess_kernel<{m.group(1)}>" if m
            else "preprocess_kernel"] = r
    return out


def loop_kernel_checks(K, dev, scenes, poses, cfg) -> dict:
    """The exploration loop's kernels against their plain versions: the
    raycast at the render's shape (FRAMES envs x 1280^2 rays x 96 boxes,
    exactly equal) and on adversarial inputs; LayerNorm in both modes at
    the ViT [ROWS, 257, 1024] bf16, decoder [ROWS, 768] bf16 and
    sentence-encoder [ROWS, 64, 384] f32 shapes."""
    import numpy as np

    from embodied_captioning_tpu_torch.envs.sim import ray_directions

    rows = {}
    sn = cfg.sensors

    # raycast ---------------------------------------------------------------
    def equal(name, got, want):
        for part, g, w in zip(("t_best", "best"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}: {part} differs from the plain "
                                     f"version on {bad} of {g.numel()} rays")
        log(f"  {name}: t_best and best equal the plain version bit for bit "
            f"({got[0].numel()} rays, {int(torch.isinf(got[0]).sum())} miss)")

    # adversarial: all-miss rays, an invalid box, a duplicate box (ties go
    # to the first index), zero ray components (clamped reciprocals)
    rng = np.random.default_rng(0)
    nb, h, w = 7, 16, 128
    box_min = rng.uniform(-4, 4, (nb, 3)).astype(np.float32)
    box_max = (box_min + rng.uniform(0.2, 2.0, (nb, 3))).astype(np.float32)
    box_min[3], box_max[3] = box_min[2], box_max[2]
    valid = np.ones((nb,), bool)
    valid[5] = False
    dirs = rng.standard_normal((h, w, 3)).astype(np.float32)
    dirs[0, :, :] = np.array([0.0, 0.0, 1.0])
    dirs[1, :, :] = np.array([0.0, 1.0, 0.0])
    inv_np = (1.0 / np.where(np.abs(dirs) < 1e-8,
                             np.where(dirs >= 0, 1e-8, -1e-8), dirs)
              ).astype(np.float32)
    adv = [torch.from_numpy(x)[None].to(dev)
           for x in (box_min, box_max, valid, inv_np)]
    got, want = K.raycast_minargmin(*adv), K.raycast_minargmin_plain(*adv)
    equal("raycast_minargmin adversarial", got, want)
    hit = torch.isfinite(got[0])
    if bool(hit.all()) or bool((got[1][hit] == 5).any()) or bool(
            (got[1][hit] == 3).any()) or bool((got[1][~hit] != 0).any()):
        raise AssertionError("raycast_minargmin: adversarial semantics")
    none = [adv[0], adv[1], torch.zeros_like(adv[2]), adv[3]]
    equal("raycast_minargmin no valid box", K.raycast_minargmin(*none),
          K.raycast_minargmin_plain(*none))

    origin, _, inv = ray_directions(poses, sn.height, sn.width, sn.hfov_deg)
    a_min = scenes.box_min - origin[:, None, :]
    a_max = scenes.box_max - origin[:, None, :]
    e, nb = a_min.shape[:2]
    got = K.raycast_minargmin(a_min, a_max, scenes.valid, inv)
    equal(f"raycast_minargmin [{e},{sn.height},{sn.width}] x {nb} boxes",
          got, K.raycast_minargmin_plain(a_min, a_max, scenes.valid, inv))
    rays = e * sn.height * sn.width
    sass = raycast_loop_sass(K.build())
    ops = RAYCAST_OPS
    if sass:
        fp32 = sum(v for k, v in sass["by_opcode"].items()
                   if k in RAYCAST_FP32_OPCODES)
        ops = fp32 / sass["boxes"]
        log(f"  raycast_minargmin box loop (cuobjdump -sass): "
            f"{sass['instructions']} instructions for {sass['boxes']} boxes, "
            f"{fp32} of them FP32 ({ops:g} a box, the bound's count): "
            f"{sass['by_opcode']}")
    rb, rf = bound_ms(nbytes(a_min, a_max, inv, *got) + e * nb,
                      ops * rays * nb, FP32_OP_PER_S)
    rows["raycast_minargmin"] = dict(
        source=PORT_KERNELS + "raycast.cu",
        replaces=TPU_KERNELS + "raycast.py:106",
        max_abs_err=0.0,
        **kernel_ms(lambda: K.raycast_minargmin(a_min, a_max, scenes.valid,
                                                inv)),
        plain_ms=time_ms(lambda: K.raycast_minargmin_plain(
            a_min, a_max, scenes.valid, inv), 2, 1),
        bound_ms=rb, bound_by=rf,
        **NO_LIBRARY,  # no one PyTorch call computes it
        loop_sass=sass, bound_ops_per_box=ops)
    del inv, got

    # layernorm ---------------------------------------------------------------
    # tolerance: bf16 output: one bf16 ulp of the largest |y|; f32 output:
    # 1e-5 (sums in another order, rsqrt within 2 ulps). Each check runs
    # twice on the same inputs, which must give the same bits
    g = torch.Generator(device=dev).manual_seed(2)

    def ln_inputs(shape, dtype):
        d = shape[-1]
        return ((torch.randn(*shape, generator=g, device=dev) * 1.5 + 0.3
                 ).to(dtype),
                1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                0.1 * torch.randn(d, generator=g, device=dev))

    def ln_case(name, x, lg, lb, two_pass=None, out_dtype=None):
        want = K.layernorm_plain(x, lg, lb, 1e-5, out_dtype, two_pass)
        tol = (2.0 ** (math.floor(math.log2(
            want.float().abs().max().item())) - 7)
               if want.dtype == torch.bfloat16 else 1e-5)
        got = K.layernorm(x, lg, lb, 1e-5, out_dtype, two_pass)
        err = check_close(f"layernorm {name}", got, want, tol)
        if not torch.equal(got, K.layernorm(x, lg, lb, 1e-5, out_dtype,
                                            two_pass)):
            raise AssertionError(f"layernorm {name}: two runs on the same "
                                 f"inputs differ")
        return err

    cases, split_inputs = [], {}
    for case, shape, dtype, main_two_pass in (
            ("vit", (ROWS, 257, 1024), torch.bfloat16, False),
            ("decoder", (ROWS, 768), torch.bfloat16, False),
            ("sentence_encoder", (ROWS, 64, 384), torch.float32, True)):
        d = shape[-1]
        x, lg, lb = ln_inputs(shape, dtype)
        for two_pass in (main_two_pass, not main_two_pass):
            mode = "two-pass" if two_pass else "one-pass"
            err = ln_case(f"{case} {list(shape)} {mode}", x, lg, lb, two_pass)
            if two_pass != main_two_pass:
                continue
            split_inputs[f"{case} {mode}"] = (x, lg, lb)
            wg, wb = lg.to(dtype), lb.to(dtype)
            y = torch.empty_like(x)
            lnb, lnf = bound_ms(2 * nbytes(x) + nbytes(lg, lb),
                                8 * x.numel(), FP32_FLOP_PER_S)
            cases.append(dict(
                case=f"{case} {mode}", shape=list(shape),
                replaces=TPU_KERNELS + ("layernorm.py:50" if len(shape) == 2
                                        else "layernorm.py:85"),
                max_abs_err=err,
                **kernel_ms(lambda: K.layernorm(x, lg, lb), 100),
                plain_ms=time_ms(lambda: K.layernorm_plain(x, lg, lb), 20),
                bound_ms=lnb, bound_by=lnf,
                **library(lambda: torch.nn.functional.layer_norm(
                    x, (d,), wg, wb, 1e-5), 100),
                # copying the same bytes: what the card's memory gives a
                # pass that reads x once and writes y once
                copy_device_us=device_us(lambda: y.copy_(x)),
                # the ViT's x (33.7 MB) sits partly in L2 in the timing
                # loop, not in the batch
                **(cold_l2(lambda xx: K.layernorm(xx, lg, lb), (x,), 100)
                   if case == "vit" else {})))
    # the vector path with the output in the other type; the scalar path:
    # rows that are not a multiple of 16 bytes, a base 2 bytes past 16-byte
    # alignment, rows wider than the vector path holds in registers
    bf = torch.bfloat16
    ln_case(f"[{ROWS},768] bf16 -> f32", *ln_inputs((ROWS, 768), bf),
            out_dtype=torch.float32)
    ln_case(f"[{ROWS},64,384] f32 -> bf16",
            *ln_inputs((ROWS, 64, 384), torch.float32), out_dtype=bf)
    ln_case("[37,100] bf16", *ln_inputs((37, 100), bf))
    ln_case("[37,100] f32", *ln_inputs((37, 100), torch.float32))
    buf = ln_inputs((16 * 768 + 8,), bf)[0]
    x = buf[1:1 + 16 * 768].view(16, 768)
    if x.data_ptr() % 16 != 2:
        raise AssertionError("the misaligned LayerNorm input is aligned")
    ln_case("[16,768] bf16 at 2 bytes past 16-byte alignment", x,
            *ln_inputs((1, 768), bf)[1:])
    ln_case("[8,4096] bf16", *ln_inputs((8, 4096), bf))
    log("  layernorm: two runs give equal bits at every shape above")
    for c in cases[1:]:
        c["host_split_us"] = split = layernorm_host_split(
            K, *split_inputs[c["case"]])
        log(f"  layernorm host time per wrapper call, {c['case']} "
            f"{c['shape']} (us, each piece timed alone on the host's "
            f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    # the row is the ViT case (most of the LayerNorm device time); the
    # decoder and sentence-encoder cases ride along
    rows["layernorm"] = dict(source=PORT_KERNELS + "layernorm.cu", **cases[0],
                             cases=cases[1:])
    log_rows(rows)
    return rows


def launches_traced(fn, name: str, iters: int = 5) -> tuple:
    """(launches of the kernels whose names hold `name`, calls) in a
    torch.profiler trace of `iters` calls of `fn` (see MARKER)."""
    fn()
    torch.cuda.synchronize()
    return sum(name in e.name for e in traced_calls(fn, iters)), iters


def layernorm_bwd_checks(K, dev) -> dict:
    """The LayerNorm backward kernel against its plain version at the
    shapes the fine-tune's step at FT_BATCH crops gives it (the ViT's
    [FT_BATCH * 257, 1024], the attentional pool's [FT_BATCH * 256, 1024]
    and the decoder's [FT_BATCH * 77, 768], bf16, one-pass statistics),
    then at the perceive batch's ViT [ROWS * 257, 1024] and decoder
    [ROWS, 768] bf16 and the sentence encoder's [ROWS, 64, 384] f32
    (two-pass); each run twice for equal bits, timed with its inputs warm
    and cold in L2, with its plan (`kernels/layernorm.bwd_plan`), its
    launches per call and the bytes of its float32 partials; then the
    generic path ([37, 100], bf16 and f32) and a bf16 x with a float32
    cotangent. Tolerances: bf16 dx one bf16 ulp of the largest |dx|; f32
    dx 1e-5 of its row's largest |dx|; dg and db, sums over the rows in
    another order, 1e-5 of each column's sum of absolute terms. The bound
    counts the function's own traffic (x, dy and g read, dx, dg and db
    written); the float32 partials of dg and db that the first launch
    writes and the second reads are its design's overhead, reported
    beside it as `partials_bytes` (written and read) and their share of
    the function's bytes."""
    from embodied_captioning_tpu_torch.kernels.layernorm import (
        bwd_plan, bwd_room)

    g = torch.Generator(device=dev).manual_seed(4)
    slots, widest = bwd_room(dev)
    log(f"  layernorm_bwd: the card holds {slots} clusters of register-path "
        f"blocks at once and launches few-row clusters of up to {widest}")

    def inputs(shape, dtype, dy_dtype=None):
        d = shape[-1]
        return ((torch.randn(*shape, generator=g, device=dev) * 1.5 + 0.3
                 ).to(dtype),
                1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                torch.randn(*shape, generator=g, device=dev).to(
                    dy_dtype or dtype))

    def case(name, x, lg, dy):
        d = x.shape[-1]
        plan = bwd_plan(x.numel() // d, d, x.element_size(),
                        dy.element_size(), slots, widest)
        log(f"  layernorm_bwd {name}: plan {plan._asdict()}")
        want = K.layernorm_bwd_plain(x, lg, dy)
        got = K.layernorm_bwd(x, lg, dy)
        xf, dyf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
        if x.dtype == torch.bfloat16:
            tol = 2.0 ** (math.floor(math.log2(
                want[0].float().abs().max().item())) - 7)
            err = check_close(f"layernorm_bwd {name} dx", got[0], want[0],
                              tol)
        else:
            scale = want[0].float().abs().reshape(-1, d).amax(
                dim=1, keepdim=True).reshape(*x.shape[:-1], 1)
            err = check_close(f"layernorm_bwd {name} dx / its row's max",
                              got[0] / scale, want[0] / scale, 1e-5)
        m1 = xf.mean(dim=1, keepdim=True)
        xhat_abs = (xf - m1).abs() * torch.rsqrt(
            torch.square(xf - m1).mean(dim=1, keepdim=True) + 1e-5)
        for part, i, l1 in (("dg", 1, (dyf.abs() * xhat_abs).sum(dim=0)),
                            ("db", 2, dyf.abs().sum(dim=0))):
            diff = (got[i] - want[i]).abs()
            worst = (diff / (1e-5 * l1 + 1e-6)).max().item()
            log(f"  layernorm_bwd {name} {part}: max_abs_err "
                f"{diff.max().item():.3e}, {worst:.3f} of its limit (1e-5 of "
                f"the column's sum of absolute terms)")
            if not math.isfinite(worst) or worst > 1.0:
                raise AssertionError(f"layernorm_bwd {name} {part}")
        again = K.layernorm_bwd(x, lg, dy)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"layernorm_bwd {name}: two runs on the "
                                 f"same inputs differ")
        return err, plan

    cases = []
    for name, shape, dtype, two_pass in (
            ("fine-tune vit", (FT_BATCH * 257, 1024), torch.bfloat16, False),
            ("fine-tune pool", (FT_BATCH * 256, 1024), torch.bfloat16, False),
            ("fine-tune decoder", (FT_BATCH * 77, 768), torch.bfloat16,
             False),
            ("vit", (ROWS * 257, 1024), torch.bfloat16, False),
            ("decoder", (ROWS, 768), torch.bfloat16, False),
            ("sentence_encoder", (ROWS, 64, 384), torch.float32, True)):
        mode = "two-pass" if two_pass else "one-pass"
        x, lg, dy = inputs(shape, dtype)
        err, plan = case(f"{name} {list(shape)} {mode}", x, lg, dy)
        d = shape[-1]
        # x, dy and g read, dx written, dg and db written (float32); ~16
        # float32 operations an element (statistics, the two means, dx,
        # the two column sums)
        own = nbytes(x, dy, lg, x) + 2 * d * 4
        lb, lf = bound_ms(own, 16 * x.numel(), FP32_FLOP_PER_S)
        wg, wb = lg.to(dtype), torch.zeros(d, dtype=dtype, device=dev)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], wg, wb,
                                                         1e-5)
        partials = 2 * 2 * plan.partials * d * 4
        # a whole trace, so a whole number of launches a call
        n, calls = launches_traced(lambda: K.layernorm_bwd(x, lg, dy),
                                   "layernorm_bwd")
        cases.append(dict(
            case=f"{name} {mode}", shape=list(shape),
            replaces="embodied_captioning_tpu/models/common.py:83",
            max_abs_err=err, plan=plan._asdict(), partials_bytes=partials,
            partials_share=partials / own, launches_traced=[n, calls],
            launches_per_call=n // calls,
            **kernel_ms(lambda: K.layernorm_bwd(x, lg, dy), 100),
            plain_ms=time_ms(lambda: K.layernorm_bwd_plain(x, lg, dy), 20),
            bound_ms=lb, bound_by=lf,
            **library(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [d], mean, rstd, wg, wb, [True, True, True]), 100),
            **cold_l2(lambda xx, dd: K.layernorm_bwd(xx, lg, dd), (x, dy),
                      100)))
        log(f"  layernorm_bwd {name}: {n} launches in {calls} traced "
            f"calls, partials {partials} bytes "
            f"({partials / own:.3f} of the function's), device "
            f"{cases[-1]['device_us']:.1f} us against "
            f"native_layer_norm_backward's "
            f"{cases[-1]['library_device_us']:.1f} and a bound of "
            f"{lb * 1e3:.2f}")
        del x, dy
    bf = torch.bfloat16
    case("[37,100] bf16 (generic path)", *inputs((37, 100), bf))
    case("[37,100] f32 (generic path)", *inputs((37, 100), torch.float32))
    case(f"[{ROWS},768] bf16 x, f32 cotangent",
         *inputs((ROWS, 768), bf, torch.float32))
    case(f"[{ROWS},1024] f32 (generic path)",
         *inputs((ROWS, 1024), torch.float32))
    log("  layernorm_bwd: two runs give equal bits at every shape above")
    rows = {"layernorm_bwd": dict(
        source=PORT_KERNELS + "layernorm.cu", **cases[0], cases=cases[1:])}
    log_rows(rows)
    return rows


def layernorm_host_split(K, x, g, b, n: int = 2000) -> dict:
    """Host time of one LayerNorm wrapper call on x in its default mode,
    split into its pieces, each timed alone in a loop on the host's clock
    (us per call), beside the whole wrapper and one F.layer_norm call. The
    ctypes entry with 0 rows returns before launching: its time is ctypes'
    argument marshalling alone."""
    import torch.nn.functional as F

    from embodied_captioning_tpu_torch.kernels import _lib

    d = x.shape[-1]
    out = torch.empty_like(x)
    kinds, f32 = (torch.bfloat16, torch.float32), (torch.float32,)
    entry = _lib._entries["ecap_layernorm"]
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    ptrs = (x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr())
    bf16 = int(x.dtype == torch.bfloat16)
    flags = (1 - bf16, bf16, bf16)  # two-pass for f32, in and out dtype
    wg, wb = g.to(x.dtype), b.to(x.dtype)

    def host_us(fn) -> float:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        dt = time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        return dt / n / 1e3

    return {
        "device query and dispatch": host_us(lambda: _lib.dispatch_device(x)),
        "checks": host_us(lambda: (
            _lib.check(x, "x", kinds, align=x.element_size()),
            _lib.check_param(g, "g", f32, (d,), align=4),
            _lib.check_param(b, "b", f32, (d,), align=4))),
        "output allocation": host_us(lambda: torch.empty_like(x)),
        "stream query": host_us(lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice())),
        "ctypes marshalling": host_us(
            lambda: entry(*ptrs, 0, d, 1e-5, *flags, stream)),
        "ctypes call with the launch": host_us(
            lambda: entry(*ptrs, x.numel() // d, d, 1e-5, *flags, stream)),
        "whole wrapper": host_us(lambda: K.layernorm(x, g, b)),
        "F.layer_norm": host_us(
            lambda: F.layer_norm(x, (d,), wg, wb, 1e-5)),
    }


# ---------------------------------------------------------------------------
# phase 3: perceive at full width
# ---------------------------------------------------------------------------

def synthetic_frames(n: int, size: int, seed: int, dev) -> torch.Tensor:
    """Seeded frames: a smooth background with a few flat-coloured boxes
    and pixel noise (uint8 [n, size, size, 3])."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.linspace(0, 1, size, device=dev)[:, None, None]
    xx = torch.linspace(0, 1, size, device=dev)[None, :, None]
    out = []
    for _ in range(n):
        c0, c1 = (torch.rand(2, 3, generator=g, device=dev) * 200 + 30)
        img = c0 * (1 - yy) + c1 * xx
        for _ in range(6):
            x0, y0 = (torch.rand(2, generator=g, device=dev) * 0.7 * size
                      ).long().tolist()
            w, h = (torch.rand(2, generator=g, device=dev) * 0.25 * size
                    + size // 10).long().tolist()
            img[y0:y0 + h, x0:x0 + w] = torch.rand(
                3, generator=g, device=dev) * 255
        img = img + torch.randn(img.shape, generator=g, device=dev) * 6
        out.append(img.clamp(0, 255).to(torch.uint8))
    return torch.stack(out)


class plain_kernels:
    """Route the model code and the simulator to the kernels' plain
    versions (on the card) for a comparison run; restores the kernels on
    exit."""

    def __init__(self, K):
        from embodied_captioning_tpu_torch.envs import sim
        from embodied_captioning_tpu_torch.models import common
        from embodied_captioning_tpu_torch.ops import image

        # (module, attribute the module calls, kernel name)
        self.routes = [(common, n, n) for n in (
            "flash_attention", "decode_self_attention",
            "decode_cross_attention", "decode_mlp", "decode_self_block",
            "decode_cross_block")] + [
            (common, "layernorm_kernel", "layernorm"),
            (image, "fused_preprocess", "fused_preprocess"),
            (sim, "raycast_minargmin", "raycast_minargmin")]
        self.K = K

    def __enter__(self):
        for mod, attr, name in self.routes:
            setattr(mod, attr, getattr(self.K, name + "_plain"))

    def __exit__(self, *exc):
        for mod, attr, name in self.routes:
            setattr(mod, attr, getattr(self.K, name))


def center_crops(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Four quadrant crops per frame, resized to the ViT input (uint8)."""
    from embodied_captioning_tpu_torch.ops.image import crop_and_resize

    s = frames.shape[1]
    h = s / 2
    boxes = torch.tensor([[0, 0, h, h], [h, 0, s, h], [0, h, h, s],
                          [h, h, s, s]], dtype=torch.float32,
                         device=frames.device)
    crops = crop_and_resize(frames.float(),
                            boxes.expand(frames.shape[0], 4, 4), size)
    return crops.reshape(-1, size, size, 3).to(torch.uint8)


@torch.no_grad()
def teacher_forced(cp, crops, ccfg, K) -> dict:
    """Greedy-decode `crops` through the kernels, then feed those tokens to
    the plain path step by step; compare the plain path's argmax and
    chosen-token log-probs with the kernel path's, and the ViT global
    embeddings of both. The log-prob difference is returned in bf16 ulps
    of the largest |logit| of its row."""
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.models.common import KVCache
    from embodied_captioning_tpu_torch.models.vit import encode_image

    tokens, lp_k, lengths = CAP.generate(cp, crops, ccfg)
    _, g_k = encode_image(cp["vision"], crops, ccfg.vision)
    t = ccfg.text
    b, L = tokens.shape
    with plain_kernels(K):
        pooled, g_p = encode_image(cp["vision"], crops, ccfg.vision)
        hd = t.width // t.heads
        tc = [KVCache.create(b, L, t.heads, hd, crops.device)
              for _ in range(t.layers)]
        mc = [KVCache.create(b, L, t.heads, hd, crops.device)
              for _ in range(t.cross_layers)]
        cross = CAP._cross_kvs(cp, pooled, t.heads)
        agree = n = 0
        lp_err = lp_ulps = ulps_sum = 0.0
        for pos in range(L - 1):
            live = lengths > pos + 1
            if not bool(live.any()):
                break
            logits, tc, mc = CAP._decode_step(cp, tokens[:, pos].long(), pos,
                                              cross, tc, mc, ccfg)
            logits = logits.float()
            nxt = tokens[:, pos + 1].long()
            lp = torch.log_softmax(logits, -1).gather(1, nxt[:, None])[:, 0]
            agree += int((logits.argmax(-1) == nxt)[live].sum())
            n += int(live.sum())
            diff = (lp - lp_k[:, pos]).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                logits.abs().amax(-1).clamp(min=1e-30))) - 7)
            u = (diff / ulp)[live]
            lp_err = max(lp_err, diff[live].max().item())
            lp_ulps = max(lp_ulps, u.max().item())
            ulps_sum += u.sum().item()
    img_cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=-1)
    return dict(agree=agree / max(n, 1), n=n, lp_err=lp_err,
                lp_ulps=lp_ulps, mean_ulps=ulps_sum / max(n, 1),
                img_cos=img_cos.min().item())


def full_width_setup(dev) -> dict:
    """The serving configuration, its weights, the FRAMES seeded scenes
    (seeds 100.., as bench.py's loop mode) with their spawned agents, and
    BATCHES + 1 batches of frames rendered along the "explore" plan."""
    from embodied_captioning_tpu_torch.config import (
        ExperimentConfig, apply_dotlist, merge)
    from embodied_captioning_tpu_torch.envs import device_loop as DL
    from embodied_captioning_tpu_torch.envs.sim import RaycastSim
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.models.quantize import quantize_params
    from embodied_captioning_tpu_torch.models.sbert import (
        init_sentence_encoder)
    from embodied_captioning_tpu_torch.params import (
        PerceptionParams, load_detector_artifact)

    cfg = apply_dotlist(ExperimentConfig.preset_config("large"), [
        f"runtime.caption_slots_per_frame={SLOTS}",
        "runtime.caption_invalid_slots=true",
        f"runtime.num_envs={FRAMES}"])
    det_params, det_cfg = load_detector_artifact(
        str(REPO / "embodied_captioning_tpu/models/data/det_serving_256.pkl"),
        dev)
    cfg = merge(cfg, {"detector": det_cfg})
    g = torch.Generator(device=dev).manual_seed(0)
    params = PerceptionParams(
        detector=det_params,
        captioner=quantize_params(init_captioner(g, cfg.captioner, dev)),
        sbert=quantize_params(init_sentence_encoder(g, cfg.sentence_encoder,
                                                    dev)))
    sims = [RaycastSim(cfg.sim, cfg.sensors, seed=100 + i, device=dev)
            for i in range(FRAMES)]
    scenes, state = DL.states_from_sims(sims)
    plan = torch.from_numpy(DL.make_action_plan(BATCHES + 1, FRAMES)).to(dev)
    batches, st = [], state
    for acts in plan:
        st = DL.step_agents(scenes, st, acts, cfg.sim)
        batches.append(
            DL._render_scan(scenes, DL.camera_poses(st), cfg)["rgb"])
    log(f"  config: detector {det_cfg['block']} {det_cfg['norm']} "
        f"{det_cfg['image_size']}^2, ViT {cfg.captioner.vision.layers}x"
        f"{cfg.captioner.vision.width}, decoder {cfg.captioner.text.layers}+"
        f"{cfg.captioner.text.cross_layers}x{cfg.captioner.text.width}, "
        f"{FRAMES} envs of {cfg.sim.max_boxes}-box scenes, frames of "
        f"{cfg.sensors.height}^2, {SLOTS} slots per frame, voxel grid "
        f"{cfg.map.grid} at {cfg.map.voxel_size} m")
    return dict(cfg=cfg, params=params, scenes=scenes, state=state,
                batches=batches)


def decoder_sublayers(ccfg) -> tuple:
    """(self-attention sublayers = MLPs, cross-attention sublayers) of one
    decode step: 24 and 12 at the large preset."""
    return (ccfg.text.layers + ccfg.text.cross_layers,
            ccfg.text.cross_layers)


def check_decode_counts(counts: dict, steps: int, batches: int,
                        blocks: bool, ccfg) -> None:
    """Launch counts of `batches` perceive batches with `steps` decode
    steps in all: every self-attention and cross-attention sublayer of a
    step through the block kernels or through the attention kernels, every
    MLP through the decode-MLP kernel; one preprocess launch and one flash
    launch per ViT layer per batch; at least the ViT's ln_pre and two norms
    per ViT block per batch plus one LayerNorm per step; no LayerNorm
    backward (serving records no gradient)."""
    counts = dict(counts)
    n_self, n_cross = decoder_sublayers(ccfg)
    vit = ccfg.vision.layers
    fused, unfused = (n_self * steps, n_cross * steps), (0, 0)
    if not blocks:
        fused, unfused = unfused, fused
    expect = {"flash_attention": vit * batches,
              "decode_self_block": fused[0], "decode_cross_block": fused[1],
              "decode_self_attention": unfused[0],
              "decode_cross_attention": unfused[1],
              "decode_mlp": n_self * steps, "fused_preprocess": batches,
              "raycast_minargmin": 0, "layernorm_bwd": 0}
    n_ln = counts.pop("layernorm")
    if n_ln < (2 * vit + 1) * batches + steps:
        raise AssertionError(f"{n_ln} LayerNorm launches in {batches} "
                             f"batches and {steps} decode steps")
    if (counts != expect or steps < batches
            or steps > (DECODE_LEN - 1) * batches):
        raise AssertionError(f"launch counts {counts} != expected {expect} "
                             f"for {steps} decode steps")


def decode_routes_in_turns(setup: dict) -> dict:
    """One batch of `perceive` on each decode route in turns (block,
    separate, separate, block) after a warm-up of the route of separate
    calls, so that both are timed under one host; the launch counts of the
    route of separate calls."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.perception import perceive

    cfg, params = setup["cfg"], setup["params"]
    frames = setup["batches"][1]
    perceive(params, frames, cfg, decode_blocks=False)
    torch.cuda.synchronize()
    ms = {True: [], False: []}
    counts = {}
    for blocks in (True, False, False, True):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perceive(params, frames, cfg, decode_blocks=blocks)
        torch.cuda.synchronize()
        ms[blocks].append((time.perf_counter() - t0) * 1e3)
        counts[blocks] = dict(K.launches)
    n_self = decoder_sublayers(cfg.captioner)[0]
    for blocks in (True, False):
        check_decode_counts(counts[blocks],
                            counts[blocks]["decode_mlp"] // n_self, 1, blocks,
                            cfg.captioner)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"  decode routes in turns, one batch of {FRAMES} frames each: "
        f"block kernels {ms[True][0]:.1f} and {ms[True][1]:.1f} ms "
        f"({FRAMES / mean[True] * 1e3:.2f} frames/s), separate calls "
        f"{ms[False][0]:.1f} and {ms[False][1]:.1f} ms "
        f"({FRAMES / mean[False] * 1e3:.2f} frames/s)")
    log(f"  launches per batch, block route: {counts[True]}")
    log(f"  launches per batch, separate calls: {counts[False]}")
    return dict(ms=mean, counts=counts[False], frames=frames)


def perceive_full_width(setup: dict) -> dict:
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.perception import perceive

    cfg, params, batches = setup["cfg"], setup["params"], setup["batches"]
    e = FRAMES
    t0 = time.perf_counter()
    ref = perceive(params, batches[0], cfg)  # warm-up (cuBLAS/cuDNN plans)
    torch.cuda.synchronize()
    log(f"  warm-up batch {time.perf_counter() - t0:.2f} s")

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [perceive(params, x, cfg) for x in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    fps = e * BATCHES / dt
    log(f"  launches in the main-path run: {counts}")

    steps = counts["decode_self_block"] // decoder_sublayers(cfg.captioner)[0]
    check_decode_counts(counts, steps, BATCHES, True, cfg.captioner)
    n_det = cfg.detector.max_detections
    for r in results:
        d = r.detections
        shapes = {"boxes": (e, n_det, 4), "masks": (e, n_det, 256, 256),
                  "embeddings": (e, n_det, cfg.sentence_encoder.embed_dim)}
        for k, shp in shapes.items():
            if tuple(getattr(d, k).shape) != shp:
                raise AssertionError(f"{k} shape {getattr(d, k).shape}")
        if tuple(r.caption_tokens.shape) != (e, n_det, DECODE_LEN):
            raise AssertionError(f"tokens shape {r.caption_tokens.shape}")
        for k in ("boxes", "scores", "masks", "embeddings"):
            if not torch.isfinite(getattr(d, k).float()).all():
                raise AssertionError(f"non-finite {k}")
        if not torch.isfinite(r.caption_logprobs).all():
            raise AssertionError("non-finite log-probs")
        if int((r.caption_lengths > 0).sum()) != ROWS:
            raise AssertionError(f"expected {SLOTS} captioned slots per frame")
    n_valid = sum(int(r.detections.valid.sum()) for r in results)

    # kernel path vs plain path. The random-weight captioner is nearly
    # uniform over its 49,408 tokens, so free-running greedy decodes part
    # ways at the first near-tie whatever the source of a last-bit
    # difference; that agreement is printed. The checks are teacher-forced:
    # the plain path decodes the kernel path's tokens. Two frame seeds.
    bad = False
    for seed, frames, kern in ((100, batches[0], ref),
                               (101, batches[1], results[0])):
        with plain_kernels(K):
            plain = perceive(params, frames, cfg)
        cap = kern.caption_lengths.reshape(-1) > 0
        free = (kern.caption_tokens.reshape(-1, DECODE_LEN)[cap]
                == plain.caption_tokens.reshape(-1, DECODE_LEN)[cap]).all(1)
        crops = center_crops(frames, cfg.captioner.vision.image_size)
        forced = teacher_forced(params.captioner, crops, cfg.captioner, K)
        box_diff = (kern.detections.boxes.float()
                    - plain.detections.boxes.float()).abs().max().item()
        # sentence embeddings (kept for valid detections only) of the rows
        # whose free-running tokens agree
        same = free & kern.detections.valid.reshape(-1)[cap].bool()
        dim = kern.detections.embeddings.shape[-1]
        emb_cos = torch.nn.functional.cosine_similarity(
            kern.detections.embeddings.reshape(-1, dim)[cap][same].float(),
            plain.detections.embeddings.reshape(-1, dim)[cap][same].float(),
            dim=-1).min().item() if bool(same.any()) else 1.0
        log(f"  kernel vs plain path, frame seed {seed}: free-running tokens "
            f"equal on {free.float().mean().item():.3f} of {int(cap.sum())} "
            f"rows; sentence-embedding cosine min {emb_cos:.7f} over the "
            f"{int(same.sum())} valid ones (limit {MIN_EMB_COSINE}); "
            f"teacher-forced: argmax agrees on {forced['agree']:.4f} "
            f"of {forced['n']} steps (limit {MIN_ARGMAX_AGREE}), chosen "
            f"log-prob max diff {forced['lp_err']:.3e} = "
            f"{forced['lp_ulps']:.3f} bf16 logit ulps, mean "
            f"{forced['mean_ulps']:.3f} (limit on max "
            f"{MAX_LOGPROB_ULPS}), ViT embedding cosine min "
            f"{forced['img_cos']:.7f} (limit {MIN_IMG_COSINE}); det boxes "
            f"max diff {box_diff:.3e}")
        bad |= (forced["agree"] < MIN_ARGMAX_AGREE
                or forced["lp_ulps"] > MAX_LOGPROB_ULPS
                or forced["img_cos"] <= MIN_IMG_COSINE
                or emb_cos <= MIN_EMB_COSINE)
    if bad:
        raise AssertionError("kernel path and plain path disagree")
    return dict(fps=fps, seconds=dt, batches=BATCHES, counts=counts,
                steps=steps, valid_detections=n_valid, params=params,
                cfg=cfg, frames=batches[1])


# ---------------------------------------------------------------------------
# phase 4: the fused exploration loop at full width
# ---------------------------------------------------------------------------

def render_kernel_vs_plain(setup: dict) -> None:
    """The render through the raycast kernel against the render through
    its plain version, same scenes and poses: everything after visibility
    is the same tensor code, so the outputs must be equal."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.envs import device_loop as DL

    cfg, scenes, e = setup["cfg"], setup["scenes"], FRAMES
    poses = DL.camera_poses(setup["state"])
    out_k = DL._render_scan(scenes, poses, cfg)
    with plain_kernels(K):
        out_p = DL._render_scan(scenes, poses, cfg)
    for k in ("depth", "instances", "classes", "rgb"):
        if not torch.equal(out_k[k], out_p[k]):
            raise AssertionError(
                f"render: {k} differs between the kernel path and the plain "
                f"path on {int((out_k[k] != out_p[k]).sum())} elements")
    hit = out_k["depth"] < cfg.sensors.max_depth
    log(f"  render kernel path == plain path (depth, instances, classes, "
        f"rgb of {e} x {cfg.sensors.height}^2); "
        f"{hit.float().mean().item():.3f} of the rays hit within "
        f"{cfg.sensors.max_depth} m, "
        f"{(out_k['instances'] >= 0).float().mean().item():.3f} hit an object")


def rollouts_full_width(setup: dict, smi: str) -> dict:
    """One window of rollout_perception, then a warm-up and LOOP_WINDOWS
    timed windows of rollout_fused along the "explore" plan."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.envs import device_loop as DL
    from embodied_captioning_tpu_torch.mapping import voxel_map as V

    cfg, params = setup["cfg"], setup["params"]
    scenes, state0 = setup["scenes"], setup["state"]
    dev = state0.x.device
    e = FRAMES
    plan = DL.make_action_plan(LOOP_STEPS, e, "explore")

    # rollout_perception: one window
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cs, n_valid = DL.rollout_perception(params, scenes, state0, plan, cfg)
    cs = float(cs)
    dt = time.perf_counter() - t0
    if not math.isfinite(cs) or K.launches["raycast_minargmin"] != LOOP_STEPS:
        raise AssertionError(f"rollout_perception: checksum {cs}, launches "
                             f"{dict(K.launches)}")
    log(f"rollout_perception: {e * LOOP_STEPS / dt:.2f} frames/s on {smi} "
        f"({e} envs x {LOOP_STEPS} steps in {dt:.3f} s, {int(n_valid)} valid "
        f"detections, checksum {cs:.1f})")

    # rollout_fused: one warm-up window, then the timed windows
    maps = V.create(cfg.map, scenes.lower, device=dev)
    torch.cuda.reset_peak_memory_stats()
    state, maps, rew, _ = DL.rollout_fused(params, scenes, state0, maps, plan,
                                           cfg)
    torch.cuda.synchronize()
    K.reset_launches()
    split: dict = {}
    rewards, collided = [rew], []
    t0 = time.perf_counter()
    for _ in range(LOOP_WINDOWS):
        state, maps, rew, col = DL.rollout_fused(params, scenes, state, maps,
                                                 plan, cfg, timings=split)
        rewards.append(rew)
        collided.append(col)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = LOOP_STEPS * LOOP_WINDOWS
    rewards = torch.cat(rewards).cpu()
    moved = ((state.x - state0.x).abs() + (state.z - state0.z).abs()) > 1e-3
    log(f"  launches in the rollout_fused windows: {counts}")
    log(f"  rewards per step (rows) and env (columns), warm-up window first:")
    for row in rewards:
        log("    " + " ".join(f"{v:.5f}" for v in row.tolist()))
    log(f"  {int(moved.sum())} of {e} agents moved; "
        f"{int(torch.cat(collided).sum())} blocked forward moves; objects per "
        f"map {maps.num_objects.tolist()}")
    per = {k: v / steps * 1e3 for k, v in split.items()}
    log(f"rollout_fused: {e * steps / dt:.2f} frames/s on {smi} ({e} envs x "
        f"{steps} steps in {dt:.3f} s); ms per step: step+render "
        f"{per['step_render']:.1f}, perceive {per['perceive']:.1f}, "
        f"fuse+reward {per['fuse_reward']:.1f}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if not torch.isfinite(rewards).all():
        raise AssertionError("non-finite rewards")
    if not bool((rewards[-1] > 1e-4).any()):
        raise AssertionError("no env has a reward above 1e-4 (float32 noise "
                             "is about 1e-7) by the last step")
    if not bool(moved.any()):
        raise AssertionError("no agent moved")
    # the loop decodes on the block route: every kernel but the two
    # standalone decode attention kernels and the LayerNorm backward (no
    # gradient is recorded) runs in it
    idle = {"decode_self_attention", "decode_cross_attention",
            "layernorm_bwd"}
    if (counts["raycast_minargmin"] != steps
            or counts["fused_preprocess"] != steps
            or any((v <= 0) != (k in idle) for k, v in counts.items())):
        raise AssertionError(f"rollout_fused launch counts {counts}")

    def one_step():
        DL.rollout_fused(params, scenes, state, maps, plan[:1], cfg)

    return dict(counts=counts, fps=e * steps / dt, per_step_ms=per,
                peak_bytes=peak, one_step=one_step)


def fuse_card_vs_cpu(setup: dict) -> None:
    """Map fusion and reward on the card against the same functions on
    the CPU, fed the same depth, poses, detections and embeddings (three
    frames along the "explore" plan): rewards within rtol 1e-4, atol 1e-6.
    The
    rewards of two free-running loops are not compared: with random
    captioner weights their greedy captions part ways."""
    from embodied_captioning_tpu_torch.envs import device_loop as DL
    from embodied_captioning_tpu_torch.mapping import voxel_map as V
    from embodied_captioning_tpu_torch.perception import perceive

    cfg, params = setup["cfg"], setup["params"]
    scenes, state0 = setup["scenes"], setup["state"]
    dev = state0.x.device
    e = FRAMES
    m_gpu = V.create(cfg.map, scenes.lower, device=dev)
    m_cpu = V.create(cfg.map, scenes.lower.cpu(), device="cpu")
    st = state0
    worst = 0.0
    for k, acts in enumerate(DL.make_action_plan(3, e, "explore")):
        st = DL.step_agents(scenes, st, torch.from_numpy(acts).to(dev),
                            cfg.sim)
        poses = DL.camera_poses(st)
        obs = DL._render_scan(scenes, poses, cfg)
        det = perceive(params, obs["rgb"], cfg).detections
        stride = cfg.sensors.height // det.masks.shape[-1]
        depth = obs["depth"][:, ::stride, ::stride].contiguous()
        args = (depth, poses, det.masks, det.classes, det.logits,
                det.embeddings, det.valid)
        kw = dict(hfov_deg=cfg.sensors.hfov_deg,
                  min_depth=cfg.sensors.min_depth,
                  max_depth=cfg.sensors.max_depth)
        m_gpu = V.integrate_frame(m_gpu, *args, cfg.map, **kw)
        m_cpu = V.integrate_frame(m_cpu, *(a.cpu() for a in args), cfg.map,
                                  **kw)
        r_gpu = V.disagreement_reward(m_gpu, cfg.map, cfg.ppo.reward_scale)
        r_cpu = V.disagreement_reward(m_cpu, cfg.map, cfg.ppo.reward_scale)
        diff = (r_gpu.cpu() - r_cpu).abs()
        big = r_cpu > 1e-4
        rel = (diff / r_cpu.clamp(min=1e-12))[big]
        worst = max(worst, rel.max().item() if rel.numel() else 0.0)
        log(f"  fuse+reward card vs CPU, frame {k}: CPU rewards "
            + " ".join(f"{v:.2e}" for v in r_cpu.tolist()))
        log(f"    max abs diff {diff.max().item():.3e} (atol 1e-6: an object "
            f"whose views carry one caption has a disagreement of float32 "
            f"noise), max rel diff where the reward > 1e-4 {worst:.3e} "
            f"(rtol 1e-4)")
        if not torch.allclose(r_gpu.cpu(), r_cpu, rtol=1e-4, atol=1e-6):
            raise AssertionError("fuse+reward: card and CPU disagree")
    if not bool((r_cpu > 1e-4).any()):
        raise AssertionError("fuse+reward check saw no reward above 1e-4")


# ---------------------------------------------------------------------------
# phase 5: tiny preset, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------

def tiny_card_vs_cpu(dev) -> None:
    from embodied_captioning_tpu_torch.config import ExperimentConfig, merge
    from embodied_captioning_tpu_torch.models.quantize import quantize_params
    from embodied_captioning_tpu_torch.params import init_perception
    from embodied_captioning_tpu_torch.perception import perceive

    cfg = merge(ExperimentConfig.preset_config("tiny"),
                {"runtime": {"caption_slots_per_frame": 2},
                 "detector": {"score_threshold": 0.0}})
    g = torch.Generator().manual_seed(3)
    p_cpu = quantize_params(init_perception(g, cfg, "cpu"))
    frames = synthetic_frames(2, 96, 7, "cpu")
    r_cpu = perceive(p_cpu, frames, cfg)
    r_gpu = perceive(to_device(p_cpu, dev), frames.to(dev), cfg)
    cap = r_cpu.caption_lengths.reshape(-1) > 0
    tok = (r_cpu.caption_tokens.reshape(-1, 12)[cap]
           == r_gpu.caption_tokens.cpu().reshape(-1, 12)[cap]).all(1)
    box = (r_cpu.detections.boxes.float()
           - r_gpu.detections.boxes.float().cpu()).abs().max().item()
    log(f"  tiny preset card vs CPU: tokens equal on {tok.float().mean():.3f}"
        f" of {int(cap.sum())} rows, boxes max diff {box:.3e}")
    if tok.float().mean().item() < 0.9:
        raise AssertionError("tiny preset: card and CPU disagree")


def check_frames(what: str, got: dict, want: dict) -> float:
    """depth, instances and classes equal; rgb within one level on all
    but RGB_SHARE of the pixels. Returns that share."""
    for k in ("depth", "instances", "classes"):
        if not torch.equal(got[k].cpu(), want[k].cpu()):
            raise AssertionError(f"{what}: {k} differs")
    d = (got["rgb"].cpu().int() - want["rgb"].cpu().int()).abs().amax(-1)
    share = (d > 1).float().mean().item()
    if share > RGB_SHARE:
        raise AssertionError(f"{what}: rgb differs by more than one level "
                             f"on {share:.2e} of the pixels")
    return share


def tiny_generate_card_vs_cpu(dev) -> None:
    """The tiny preset's unfused loop (`randombaseline`, 2 envs, 128^2
    sensors over the 64^2 mask raster, 4 steps of 3-step episodes, so both
    envs auto-reset on the card) through the kernels on the card, against the
    plain path on the CPU: frames equal (rgb within one level on all but
    RGB_SHARE of the pixels), the CPU's perception on the card's frames
    beside the card's tokens, and the CPU's fusion of the card's
    detections against the card's rewards within rtol 1e-4, atol
    1e-5."""
    from embodied_captioning_tpu_torch.agents.baselines import RandomBaseline
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.params import init_perception
    from embodied_captioning_tpu_torch.perception import (
        FrameResult, Perceiver)

    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=2", "sensors.height=128", "sensors.width=128",
        "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2",
        "sim.episode_steps=3", "runtime.caption_slots_per_frame=2",
        "detector.score_threshold=0.0"])
    p_cpu = init_perception(torch.Generator().manual_seed(3), cfg, "cpu")
    card = RandomBaseline(cfg, device=dev, perceiver=Perceiver(
        cfg, params=to_device(p_cpu, dev), device=dev))
    cpu = RandomBaseline(cfg, device="cpu", perceiver=Perceiver(
        cfg, params=p_cpu, device="cpu"))
    obs, obs_cpu = card.envs.observe(), cpu.envs.observe()
    resets, tok_eq, tok_n, worst, top, rgb = 0, 0, 0, 0.0, 0.0, 0.0
    for step in range(4):
        rgb = max(rgb, check_frames(f"tiny generate step {step}", obs,
                                    obs_cpu))
        res = card.perceive_and_fuse(obs)
        frames = {k: v.cpu() for k, v in obs.items()}
        ref = cpu.perceiver.process(frames["rgb"])
        cap = ref.caption_lengths.reshape(-1) > 0
        tok_eq += int((ref.caption_tokens.reshape(-1, 12)[cap]
                       == res.caption_tokens.cpu().reshape(-1, 12)[cap]
                       ).all(1).sum())
        tok_n += int(cap.sum())
        handed = FrameResult(res.detections.to("cpu"), None, None, None)
        cpu.perceiver.process = lambda _: handed
        cpu.perceive_and_fuse(frames)
        del cpu.perceiver.process
        r_card, r_cpu = card.rewards(), cpu.rewards()
        worst = max(worst, float(abs(r_card - r_cpu).max()))
        top = max(top, float(r_cpu.max()))
        if not np.allclose(r_card, r_cpu, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"tiny generate step {step}: rewards card "
                                 f"{r_card} CPU {r_cpu}")
        acts = card.actions(obs)
        if cpu.actions(obs_cpu) != acts:
            raise AssertionError("tiny generate: the controllers part ways")
        card.envs.step_async(acts)
        obs, _, dones, _ = card.envs.step_wait()
        obs_cpu, _, dones_cpu, _ = cpu.envs.step(acts)
        if not np.array_equal(dones, dones_cpu):
            raise AssertionError("tiny generate: dones differ")
        resets += int(dones.sum())
    card.envs.close()
    cpu.envs.close()
    log(f"  tiny generate card vs CPU: 4 steps, {resets} auto-resets; "
        f"frames: depth, instances, classes equal, rgb more than one level "
        f"apart on at most {rgb:.2e} of the pixels (limit {RGB_SHARE}); "
        f"tokens equal on {tok_eq} of {tok_n} captioned rows; rewards max "
        f"abs diff {worst:.3e} (rtol 1e-4, atol 1e-5), largest reward "
        f"{top:.5f}")
    # tokens are reported, not gated: on 16 rows one greedy flip of the
    # random-weight decoder (ROADMAP C.8) moves the share by 6%; the
    # `perceive` check above gates the kernels against the plain path
    if resets != 2 or top <= 1e-4:
        raise AssertionError("tiny generate: card and CPU disagree")


# ---------------------------------------------------------------------------
# phase 6: where one full-width perceive batch spends its time
# ---------------------------------------------------------------------------

def profile_run(what: str, fn, unprofiled_us: float, top: int = 15
                ) -> float:
    """Device time by kernel over one call of `fn` (torch.profiler, the
    device's activity alone), the share of the ported kernels, and the
    device's idle share of the unprofiled time of the same work measured in
    an earlier phase. Returns the device busy time (us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):  # again if the trace lost its device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_marker()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            trace_marker()
            torch.cuda.synchronize()
        events = device_events(prof)
        busy = busy_us(events)
        if busy > 0:
            break
    else:
        raise AssertionError("the profiler saw no device time in three "
                             "traces")
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and MARKER not in e.key]
    rows.sort(key=lambda e: -e.self_device_time_total)
    ported = [e for e in rows
              if any(k in e.key for k in PORTED_KERNELS)]
    ours = busy_us([e for e in events
                    if any(k in e.name for k in PORTED_KERNELS)])
    log(f"  {what}: device busy {busy / 1e3:.1f} ms; wall "
        f"{unprofiled_us / 1e3:.1f} ms unprofiled, "
        f"{wall_us / 1e3:.1f} ms under the profiler; idle share "
        f"{max(0.0, 1 - busy / unprofiled_us):.3f} of the unprofiled time; "
        f"ported kernels {ours / 1e3:.1f} ms ({ours / busy:.3f} of device "
        f"time)")
    for e in rows[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  "
            f"{e.key[:90]}")
    log("    ported kernels, device us per launch: " + "; ".join(
        f"{kernel_name(e.key)} {e.self_device_time_total / e.count:.1f} "
        f"x{e.count}" for e in ported))
    # the decode MLP's and the two blocks' three launches run once per
    # call each; a launch started early by programmatic dependent launch
    # counts from its start, so a call's time is the union of its launches
    calls = block_calls(events)
    for name, first, parts in (
            ("decode_mlp", "mlp_ln_kernel", ("mlp_ln_kernel",
                                             "mlp_gemm_kernel")),
            ("decode_self_block", SELF_BLOCK_KERNELS[0], SELF_BLOCK_KERNELS),
            ("decode_cross_block", CROSS_BLOCK_KERNELS[0],
             CROSS_BLOCK_KERNELS)):
        n = sum(e.count for e in ported if first in e.key)
        if n:
            span = busy_us(calls.get(first) or [
                e for e in events if any(k in e.name for k in parts)])
            log(f"    {name}: {span / n:.1f} us on the device per call "
                f"({n} calls)")
    return busy


def block_calls(events) -> dict:
    """{first launch of a block: the block's launches}: each of the two
    blocks' launches, the shared out product given to the block whose
    first launch started last before it."""
    firsts = (SELF_BLOCK_KERNELS[0], CROSS_BLOCK_KERNELS[0])
    calls, owner = {}, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        first = next((k for k in firsts if k in e.name), None)
        if first is not None:
            owner = first
        parts = (SELF_BLOCK_KERNELS if owner == firsts[0]
                 else CROSS_BLOCK_KERNELS)
        if owner is not None and any(k in e.name for k in parts[1:]):
            first = owner
        if first is not None:
            calls.setdefault(first, []).append(e)
    return calls


def parameter_names(tree, path: str = "") -> dict:
    """{id(tensor): its dotted path} over dicts, lists and named tuples of
    tensors, list indices folded to `*`."""
    if isinstance(tree, torch.Tensor):
        return {id(tree): path}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = (("*", v) for v in tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(parameter_names(v, f"{path}.{k}" if path else str(k)))
    return out


def layernorm_split(K, params, fn) -> dict:
    """LayerNorm launches and device time over one call of `fn`, by the
    LayerNorm's parameters and input shape: each wrapper call is labelled
    by the name of its g in `params`, and the LayerNorm kernels of a
    profiler trace, in the order they started, are matched to the calls in
    the order they were made (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    from embodied_captioning_tpu_torch.models import common

    names = parameter_names(params)
    labels = []

    def labelled(x, g, b, *a, **k):
        name = names.get(id(g), "?").removesuffix(".g")
        labels.append(f"{name} {list(x.shape)} {str(x.dtype)[6:]}")
        return K.layernorm(x, g, b, *a, **k)

    torch.cuda.synchronize()
    common.layernorm_kernel = labelled
    try:
        for _ in range(3):  # again if the trace lost its device events
            labels.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trace_marker()
                fn()
                trace_marker()
                torch.cuda.synchronize()
            ln = sorted((e for e in device_events(prof)
                         if "layernorm" in e.name),
                        key=lambda e: e.time_range.start)
            if ln:
                break
    finally:
        common.layernorm_kernel = K.layernorm
    if len(ln) != len(labels):
        raise AssertionError(f"{len(ln)} LayerNorm kernels in the trace for "
                             f"{len(labels)} wrapper calls")
    split: dict = {}
    for label, e in zip(labels, ln):
        r = split.setdefault(label, {"launches": 0, "device_us": 0.0})
        r["launches"] += 1
        r["device_us"] += e.time_range.end - e.time_range.start
    for label, r in sorted(split.items(), key=lambda kv: -kv[1]["device_us"]):
        log(f"    layernorm {label}: {r['launches']} launches, "
            f"{r['device_us']:.1f} us on the device "
            f"({r['device_us'] / r['launches']:.2f} us each)")
    return split


# ---------------------------------------------------------------------------
# phase 7: beam, sampled and speculative generation at full width
# ---------------------------------------------------------------------------

@torch.no_grad()
def generation_modes(setup: dict, smi: str) -> None:
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.models import captioner as CAP

    cfg, cp = setup["cfg"].captioner, setup["params"].captioner
    t = cfg.text
    crops = center_crops(setup["batches"][1], cfg.vision.image_size)
    few = crops[::SLOTS].contiguous()                 # one crop per frame
    dev = crops.device

    def timed(fn):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(K.launches)

    def check_tokens(name, tokens, rows):
        if tuple(tokens.shape) != (rows, DECODE_LEN) or (
                tokens.dtype != torch.int32):
            raise AssertionError(f"{name}: tokens {tokens.shape} "
                                 f"{tokens.dtype}")
        if not bool((tokens[:, 0] == t.bos_id).all()):
            raise AssertionError(f"{name}: BOS is not first")
        if not bool(((tokens >= 0) & (tokens < t.vocab_size)).all()):
            raise AssertionError(f"{name}: token ids out of range")
        pad = tokens == t.pad_id
        lengths = (~pad).sum(1)
        after = torch.arange(DECODE_LEN, device=dev)[None] >= lengths[:, None]
        if not torch.equal(pad, after):
            raise AssertionError(f"{name}: a PAD inside a caption")
        eos = tokens == t.eos_id
        last = torch.arange(DECODE_LEN, device=dev)[None] == (lengths - 1
                                                               )[:, None]
        if bool((eos & ~last).any()):
            raise AssertionError(f"{name}: tokens after EOS")
        return lengths

    n_self, n_cross = decoder_sublayers(cfg)
    n_draft = t.layers + 1      # self blocks of a draft step (1 draft layer)

    def blocks_ran(name, counts, min_steps):
        n = counts["decode_self_block"]
        if (n < n_self * min_steps or n % n_self
                or counts["decode_cross_block"] * n_self != n * n_cross
                or counts["decode_mlp"] != n
                or counts["decode_self_attention"]
                or counts["decode_cross_attention"]):
            raise AssertionError(f"{name}: launch counts {counts}")

    # warm-up of the shapes that phase 3 has not run (16 and 64 x 4 rows)
    CAP.generate(cp, few, cfg, max_len=3)
    CAP.generate_beam(cp, few, cfg, max_len=3, num_beams=BEAMS)

    (g_tok, g_lp, g_len), dt_g, c_g = timed(lambda: CAP.generate(cp, few,
                                                                 cfg))
    check_tokens("greedy generate", g_tok, FRAMES)
    blocks_ran("greedy generate", c_g, 1)
    log(f"  greedy generate, {FRAMES} crops: {dt_g * 1e3:.1f} ms, "
        f"{c_g['decode_mlp'] // n_self} steps, lengths "
        f"{g_len.float().mean().item():.1f} mean")

    (b_tok, b_score), dt_b, c_b = timed(lambda: CAP.generate_beam(
        cp, few, cfg, num_beams=BEAMS))
    b_len = check_tokens("generate_beam", b_tok, FRAMES)
    blocks_ran("generate_beam", c_b, 1)
    if tuple(b_score.shape) != (FRAMES,) or not bool(
            torch.isfinite(b_score).all()) or bool((b_score > 0).any()):
        raise AssertionError(f"generate_beam: scores {b_score}")
    # the best of 4 beams against the greedy caption's own length-normalised
    # score: printed, not gated (a beam search is not monotone in its width)
    g_score = g_lp.sum(1) / g_len.float()
    log(f"generate_beam: {FRAMES / dt_b:.2f} crops/s on {smi} ({FRAMES} crops "
        f"x {BEAMS} beams in {dt_b * 1e3:.1f} ms, {c_b['decode_mlp'] // n_self} "
        f"steps; score mean {b_score.mean().item():.4f} against greedy "
        f"{g_score.mean().item():.4f}, at least greedy's on "
        f"{(b_score >= g_score - 1e-3).float().mean().item():.3f} of the "
        f"rows; lengths {b_len.float().mean().item():.1f} mean)")
    log(f"  launches: {c_b}")

    gen = torch.Generator(device=dev).manual_seed(11)
    (s_tok, s_lp, s_len), dt_s, c_s = timed(lambda: CAP.generate(
        cp, crops, cfg, top_k=50, top_p=0.9, temperature=0.7, generator=gen))
    check_tokens("sampled generate", s_tok, ROWS)
    blocks_ran("sampled generate", c_s, 1)
    again = CAP.generate(cp, crops, cfg, top_k=50, top_p=0.9, temperature=0.7,
                         generator=torch.Generator(device=dev).manual_seed(11))
    if not torch.isfinite(s_lp).all() or not torch.equal(again[0], s_tok):
        raise AssertionError("sampled generate: non-finite log-probs, or "
                             "another draw from the same seed")
    greedy64 = CAP.generate(cp, crops, cfg)
    live = s_len > 1
    log(f"sampled generate: {ROWS / dt_s:.2f} crops/s on {smi} ({ROWS} crops "
        f"in {dt_s * 1e3:.1f} ms, {c_s['decode_mlp'] // n_self} steps, "
        f"temperature 0.7, top-k 50, top-p 0.9; chosen log-prob mean "
        f"{(s_lp.sum(1) / (s_len - 1).clamp(min=1))[live].mean().item():.3f} "
        f"against greedy "
        f"{(greedy64[1].sum(1) / (greedy64[2] - 1).clamp(min=1)).mean().item():.3f}"
        f"; differs from greedy on "
        f"{(s_tok != greedy64[0]).any(1).float().mean().item():.3f} of the "
        f"rows)")
    if bool((s_tok == greedy64[0]).all()):
        raise AssertionError("sampled generate equals greedy decoding")

    CAP.generate_speculative(cp, few, cfg, max_len=6, draft_len=4)  # warm-up
    (p_tok, p_len), dt_p, c_p = timed(lambda: CAP.generate_speculative(
        cp, few, cfg, draft_len=4))
    check_tokens("generate_speculative", p_tok, FRAMES)
    # the drafts run one self block per text layer and draft multimodal
    # layer; a verify pass of 4 tokens runs no decode kernel
    if (c_p["decode_self_block"] % n_draft
            or c_p["decode_cross_block"] * n_draft != c_p["decode_self_block"]
            or c_p["decode_self_block"] < n_draft * 4
            or c_p["decode_mlp"] != c_p["decode_self_block"]
            or c_p["decode_self_attention"] or c_p["decode_cross_attention"]):
        raise AssertionError(f"generate_speculative: launch counts {c_p}")
    macro = c_p["decode_self_block"] // (n_draft * 4)
    same = (p_tok == g_tok)
    prefix = same.int().cumprod(1).sum(1).float()
    first = same[:, 1].float().mean().item()
    log(f"generate_speculative: {FRAMES / dt_p:.2f} crops/s on {smi} "
        f"({FRAMES} crops in {dt_p * 1e3:.1f} ms against greedy "
        f"{dt_g * 1e3:.1f} ms; {macro} macro steps of 4 drafts + 1 verify "
        f"pass for {int(p_len.max()) - 1} positions); against greedy on the "
        f"same crops: rows equal {same.all(1).float().mean().item():.3f}, "
        f"first token equal {first:.3f} (limit {MIN_SPEC_FIRST_TOKEN}), "
        f"common prefix {prefix.mean().item():.1f} of {DECODE_LEN} tokens")
    log(f"  launches: {c_p}")
    if first < MIN_SPEC_FIRST_TOKEN:
        raise AssertionError("generate_speculative and greedy part ways at "
                             "the first token")


# ---------------------------------------------------------------------------
# phase 8: the exploration entry point (`generate`) at full width
# ---------------------------------------------------------------------------

def generate_checks(cfg, params, dev) -> None:
    """Before the timed run, on fresh VectorEnvs of the same seeds: frames
    of step_async/step_wait (with the caller's perception and readbacks
    in flight on its own stream, as in `generate`) equal a synchronous
    step's, and the batched chunked render equals each env's own render,
    bit for bit; the chunked render's peak memory stays within its
    budget; the native library is the port's build and runs."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.envs import sim as S
    from embodied_captioning_tpu_torch.envs.device_loop import (
        make_action_plan)
    from embodied_captioning_tpu_torch.envs.vector_env import VectorEnv
    from embodied_captioning_tpu_torch.mapping import components
    from embodied_captioning_tpu_torch.perception import perceive

    va, vb = VectorEnv(cfg, device=dev), VectorEnv(cfg, device=dev)
    obs_a, obs_b = va.observe(), vb.observe()
    for k, acts in enumerate(make_action_plan(2, va.num_envs, "random", 1)):
        va.step_async(acts.tolist())
        perceive(params, obs_a["rgb"], cfg)
        obs_a["rgb"].cpu(), obs_a["depth"].cpu()
        obs_a = va.step_wait()[0]
        obs_b = vb.step(acts.tolist())[0]
        for key in obs_b:
            if not torch.equal(obs_a[key], obs_b[key]):
                raise AssertionError(f"step {k}: async {key} differs from "
                                     "sync")
    scenes = S.Scene(*(torch.stack(xs) for xs in
                       zip(*(e.sim.scene for e in va.envs))))
    poses = torch.stack([e.camera_pose() for e in va.envs])
    s = cfg.sensors
    budget = 6 << 30
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    chunked = S.render_batch_chunked(scenes, poses, s.height, s.width,
                                     s.hfov_deg, s.max_depth, budget)
    peak = torch.cuda.max_memory_allocated() - base
    launches = K.launches["raycast_minargmin"]
    for i, env in enumerate(va.envs):
        one = env.observe()
        for key in one:
            if not torch.equal(chunked[key][i], one[key]):
                raise AssertionError(f"chunked render: env {i} {key} "
                                     "differs from its own render")
    out_bytes = sum(v.numel() * v.element_size() for v in chunked.values())
    log(f"  async frames == sync frames (2 steps, {va.num_envs} envs, "
        f"bit for bit); chunked render ({launches} raycast launches) == "
        f"per-env renders; its peak {peak / 2**30:.2f} GiB beside a budget "
        f"of {budget / 2**30:.2f} GiB plus {out_bytes / 2**30:.2f} GiB of "
        f"outputs")
    if peak > budget + out_bytes:
        raise AssertionError("the chunked render exceeds its memory budget")
    va.close()
    vb.close()
    del va, vb, chunked
    lib = Path(components.native_library()._name).resolve()
    port = REPO / "embodied_captioning_tpu_torch" / "native" / "build"
    grid = torch.zeros(8, 8, 8, dtype=torch.int32)
    grid[1:3, 1:3, 1:3] = 1
    grid[5:7, 5:7, 5:7] = 2
    _, n = components.connected_components_26(grid.numpy())
    if not lib.is_relative_to(port) or components._load_native() is None \
            or n != 2:
        raise AssertionError(f"native library {lib}: not the port's build "
                             f"or wrong ({n} components)")
    log(f"  native library loaded: {lib.relative_to(REPO)} "
        f"(connected_components_26 and astar_2d)")


def generate_full_width(setup: dict, smi: str, obs_dir: str) -> dict:
    """`randombaseline`'s generate, the entry point of run_exp, at the
    serving configuration (16 envs of 96-box scenes at 1280^2, the
    detector artifact, random seeded captioner, 4 caption slots), with
    observations written to `obs_dir` (phase 10's fine-tune reads them):
    one warm-up step, then GEN_STEPS timed steps with the per-step split,
    launch counts, peak device memory, then one step under the profiler
    for the idle share."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.agents.baselines import RandomBaseline
    from embodied_captioning_tpu_torch.config import apply_dotlist
    from embodied_captioning_tpu_torch.perception import Perceiver

    dev = setup["state"].x.device
    cfg = apply_dotlist(setup["cfg"], [f"runtime.obs_dir={obs_dir}",
                                       "sim.scene_seed=100"])
    generate_checks(cfg, setup["params"], dev)
    trainer = RandomBaseline(cfg, device=dev, perceiver=Perceiver(
        cfg, params=setup["params"], device=dev))
    e = trainer.envs.num_envs
    path = trainer.envs.envs[0].get_path((1.0, 1.0), (10.0, 10.0))
    if len(path) == 0:
        raise AssertionError("A* found no path across the room")
    trainer.generate(1)                                   # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    split: dict = {}
    t0 = time.perf_counter()
    trainer.generate(GEN_STEPS, timings=split)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    trainer.generate(1)
    torch.cuda.synchronize()
    one_us = (time.perf_counter() - t0) * 1e6
    profile_run("one generate step (observe, perceive, fuse, save, "
                "render)", lambda: trainer.generate(1), one_us)
    rewards = trainer.rewards()
    saved = len(trainer.saved_paths)
    on_disk = sum(len(f) for _, _, f in os.walk(obs_dir))
    trainer.envs.close()
    per = {k: v / GEN_STEPS * 1e3 for k, v in split.items()}
    fps = e * GEN_STEPS / dt
    log(f"  launches in the timed generate steps: {counts}")
    log(f"generate: {fps:.2f} frames/s on {smi} ({e} envs x {GEN_STEPS} "
        f"steps in {dt:.3f} s); ms per step: perceive "
        f"{per['perceive']:.1f}, upsample+fusion {per['fuse']:.1f}, "
        f"save_step_obs {per['save']:.1f}, waiting in step_wait "
        f"{per['wait']:.1f}; the worker (agent steps + render) "
        f"{per['worker']:.1f}; peak device memory {peak / 2**30:.2f} GiB; "
        f"{saved} files saved ({on_disk} on disk); rewards "
        + " ".join(f"{r:.5f}" for r in rewards))
    steps_run = 1 + GEN_STEPS + 2
    if saved != steps_run * e * 4 or on_disk != saved:
        raise AssertionError(f"generate saved {saved} files ({on_disk} on "
                             f"disk), expected {steps_run * e * 4}")
    if not np.isfinite(rewards).all():
        raise AssertionError(f"non-finite rewards {rewards}")
    path_kernels = ("raycast_minargmin", "fused_preprocess",
                    "flash_attention", "layernorm", "decode_self_block",
                    "decode_cross_block", "decode_mlp")
    if any(counts[k] <= 0 for k in path_kernels) or (
            counts["decode_self_attention"] or counts["decode_cross_attention"]):
        raise AssertionError(f"generate launch counts {counts}")
    return dict(counts=counts, fps=fps, per_step_ms=per, peak_bytes=peak)


# ---------------------------------------------------------------------------
# phase 9: PPO training (`train`) at full width
# ---------------------------------------------------------------------------

TRAIN_UPDATES = 2              # PPO updates per train call in phase 9
TRAIN_DECISIONS = 2            # decisions per update
TRAIN_WINDOW = 2               # env steps per decision (num_global_steps)
# the reference's rollout batch: horizon 8 x 16 envs, PPOConfig's 4 epochs
# x 2 minibatches
REF_HORIZON = 8


def random_rollout(t: int, e: int, map_size: int, recurrent: bool,
                   seed: int):
    """A rollout of random maps, orientations, actions, log-probs, values,
    rewards and masks (tests/test_torch_policy.py's)."""
    from embodied_captioning_tpu_torch.agents.storage import Rollout

    rng = np.random.default_rng(seed)
    return Rollout(
        maps=rng.random((t + 1, e, map_size, map_size, 2)).astype(np.float32),
        orientation=rng.integers(0, 72, (t + 1, e)).astype(np.int32),
        raw_actions=rng.standard_normal((t, e, 2)).astype(np.float32),
        log_probs=(rng.standard_normal((t, e)) - 2).astype(np.float32),
        values=rng.random((t + 1, e)).astype(np.float32),
        rewards=rng.random((t, e)).astype(np.float32),
        masks=(rng.random((t + 1, e)) > 0.2).astype(np.float32),
        rnn_states=((rng.standard_normal((t, e, 256)) * 0.5).astype(
            np.float32) if recurrent else None))


HEAD_LEAVES = ("value.", "act.", "log_std")


def ppo_card_vs_cpu(dev) -> None:
    """The same rollout, weights and permutations through `ppo_update` on
    the card and on the CPU (a rollout of 4 decisions x 4 envs, 2 epochs x
    2 minibatches), with the limits of tests/test_torch_policy.py: the
    first minibatch's gradients within a relative L2 error of 1e-2 per leaf
    (5e-2 with the GRU), the parameters after the update within Adam's
    2 * lr a step of each other with a mean difference under a tenth of the
    mean move, the metrics within 2e-3. At the CPU tests' 32^2 maps every
    leaf's gradient is held; at the policy's default 128^2 maps, the path's
    own shapes, the trunk's bf16 gradients are chaotic (ROADMAP C.20), so
    the gradients of the head leaves (value, act, log_std) are held, and
    the update-level checks as at 32^2."""
    from embodied_captioning_tpu_torch.agents import ppo as PPO
    from embodied_captioning_tpu_torch.agents.policy import init_policy
    from embodied_captioning_tpu_torch.config import PolicyConfig, PPOConfig

    cfg = PPOConfig(ppo_epoch=2, num_mini_batch=2)
    for size, recurrent in ((32, False), (32, True), (128, False),
                            (128, True)):
        params = init_policy(torch.Generator().manual_seed(5),
                             PolicyConfig(map_size=size, recurrent=recurrent),
                             device="cpu")
        ids = parameter_names(params)
        names = [ids[id(x)] for x in PPO.tree_leaves(params)]
        held = [size == 32 or n.startswith(HEAD_LEAVES) for n in names]
        ro = random_rollout(4, 4, size, recurrent, seed=0)
        g = torch.Generator().manual_seed(6)
        perms = [torch.randperm(16, generator=g) for _ in range(2)]

        def first_grads(p):
            batch = PPO.prepare_batch(ro, cfg, p["log_std"].device)
            idx = perms[0][:8].to(p["log_std"].device)
            return [x.cpu() for x in PPO.tree_leaves(
                PPO.ppo_grads(p, batch, idx, cfg)[0])]

        def rel(a, b):
            return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

        grads, state, metrics = {}, {}, {}
        for where, p in (("cpu", params), ("card", to_device(params, dev))):
            grads[where] = first_grads(p)
            state[where], metrics[where] = PPO.ppo_update_with(
                PPO.create_state(p, cfg), ro, perms, cfg)
        tol = 5e-2 if recurrent else 1e-2
        errs = [rel(a, b) for a, b in zip(grads["card"], grads["cpu"])]
        held_err = max(e for e, h in zip(errs, held) if h)
        p0 = PPO.tree_leaves(params)
        p_cpu = PPO.tree_leaves(state["cpu"].params)
        p_card = [x.cpu() for x in PPO.tree_leaves(state["card"].params)]
        diff = torch.cat([(a - b).abs().flatten()
                          for a, b in zip(p_card, p_cpu)])
        move = torch.cat([(a - b).abs().flatten()
                          for a, b in zip(p_cpu, p0)])
        steps = cfg.ppo_epoch * cfg.num_mini_batch
        m_err = max(abs(float(metrics["card"][k]) - float(metrics["cpu"][k]))
                    / abs(float(metrics["cpu"][k])) for k in metrics["cpu"])
        what = f"{'GRU' if recurrent else 'feed-forward'}, {size}^2 maps"
        log(f"  ppo_update card vs CPU ({what}): first-minibatch gradients' "
            f"relative L2 error per leaf, held ones * (limit {tol:.0e}): "
            + ", ".join(f"{n} {e:.2e}{' *' if h else ''}"
                        for n, e, h in zip(names, errs, held)))
        log(f"    parameters after the update: max diff "
            f"{diff.max().item() / cfg.lr:.3f} lr (limit {2 * steps} lr), "
            f"mean diff {diff.mean().item() / cfg.lr:.4f} lr beside a mean "
            f"move of {move.mean().item() / cfg.lr:.4f} lr; metrics max "
            f"relative diff {m_err:.2e}; loss card "
            f"{float(metrics['card']['loss']):.6f}, CPU "
            f"{float(metrics['cpu']['loss']):.6f}")
        if (held_err > tol
                or diff.max().item() > 2 * cfg.lr * steps
                or diff.mean() > 0.1 * move.mean() or m_err > 2e-3
                or not math.isfinite(m_err)):
            raise AssertionError(f"ppo_update ({what}): the card and the CPU "
                                 "disagree")


def ppo_update_reference_batch(dev, smi: str) -> dict:
    """One PPO update at the reference's batch (8 decisions x 16 envs,
    PPOConfig's 4 epochs x 2 minibatches, the policy at 128^2 maps) on
    random rollout data: a warm-up, 3 timed updates (host clock around
    synchronised calls), one profiled."""
    from embodied_captioning_tpu_torch.agents import ppo as PPO
    from embodied_captioning_tpu_torch.agents.policy import init_policy
    from embodied_captioning_tpu_torch.config import PolicyConfig, PPOConfig

    cfg = PPOConfig()
    params = init_policy(torch.Generator(device=dev).manual_seed(7),
                         PolicyConfig(), device=dev)
    n_params = sum(x.numel() for x in PPO.tree_leaves(params))
    ro = random_rollout(REF_HORIZON, FRAMES, 128, False, seed=1)
    g = torch.Generator(device=dev).manual_seed(8)

    def update():
        state, m = PPO.ppo_update(PPO.create_state(params, cfg), ro, g, cfg)
        return float(m["loss"])

    update()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = update()
        times.append(time.perf_counter() - t0)
    ms = sorted(times)[1] * 1e3
    log(f"ppo_update at the reference's batch ({REF_HORIZON} x {FRAMES} "
        f"rows, {cfg.ppo_epoch} epochs x {cfg.num_mini_batch} minibatches, "
        f"{n_params} parameters): {ms:.1f} ms (median of 3: "
        + ", ".join(f"{t * 1e3:.1f}" for t in times) + f") on {smi}; "
        f"loss {loss:.5f}")
    if not math.isfinite(loss):
        raise AssertionError("ppo_update: non-finite loss")
    profile_run("one ppo_update at the reference's batch", update, ms * 1e3)
    return dict(ms=ms, n_params=n_params)


def train_full_width(setup: dict, smi: str) -> dict:
    """`goalexplorationbaseline-v0`'s `train` at the serving configuration
    (16 envs of 96-box scenes at 1280^2, the detector artifact, the seeded
    int8 captioner, 4 caption slots, 256 x 64 x 256 voxel grids, the policy
    at PolicyConfig's defaults): TRAIN_UPDATES updates of TRAIN_DECISIONS
    decisions of TRAIN_WINDOW steps, unfused and then fused. For each:
    finite metrics, changed parameters, launch counts, the split of an
    update (rollout, policy inputs, update), env steps/s, peak memory, the
    checkpoint written and read back equal; then one decision and its
    update unprofiled and under the profiler for the idle share. The first
    decision of an episode builds each env's traversability grid for the
    goal planner (a Python loop over cells); its planning time stands on a
    line of its own, and the second update, with the grids cached, gives
    the steady-state rollout and env steps/s."""
    import tempfile

    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.agents.goal_exploration import (
        GoalExplorationTrainer)
    from embodied_captioning_tpu_torch.agents.ppo import tree_leaves
    from embodied_captioning_tpu_torch.config import apply_dotlist
    from embodied_captioning_tpu_torch.perception import Perceiver
    from embodied_captioning_tpu_torch.utils.profiling import PROFILER

    dev = setup["state"].x.device
    out = {}
    with tempfile.TemporaryDirectory(prefix="ecap_train_") as ckpt:
        cfg = apply_dotlist(setup["cfg"], [
            "sim.scene_seed=100", f"ppo.num_global_steps={TRAIN_WINDOW}",
            f"runtime.checkpoint_dir={ckpt}"])
        if cfg.sim.episode_steps % TRAIN_WINDOW:
            raise AssertionError("the window must divide the episode")
        t_start = time.perf_counter()
        trainer = GoalExplorationTrainer(cfg, device=dev, perceiver=Perceiver(
            cfg, params=setup["params"], device=dev))
        e = trainer.envs.num_envs
        log(f"  trainer built in {time.perf_counter() - t_start:.1f} s")
        parts = time_calls(trainer, ("_act", "_goals_from_actions",
                                     "perceive_and_fuse", "fused_window"))
        time_calls(trainer.envs, ("step_wait",), parts)
        for fused in (False, True):
            form = "fused" if fused else "unfused"
            before = [x.clone() for x in tree_leaves(trainer.ppo_state.params)]
            torch.cuda.synchronize()
            K.reset_launches()
            PROFILER.reset()
            torch.cuda.reset_peak_memory_stats()
            for k in parts:
                parts[k] = []
            n_log = len(trainer.metrics_log)
            t0 = time.perf_counter()
            trainer.train(TRAIN_UPDATES, TRAIN_DECISIONS, fused=fused)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(K.launches)
            peak = torch.cuda.max_memory_allocated()
            rollouts = list(PROFILER.stats["rollout"])
            stats = {k: sum(v) for k, v in PROFILER.stats.items()}
            stats.update({k: sum(v) for k, v in parts.items() if v})
            plans = list(parts["_goals_from_actions"])
            metrics = trainer.metrics_log[n_log:]
            after = tree_leaves(trainer.ppo_state.params)
            moved = max((a - b).abs().max().item()
                        for a, b in zip(after, before))
            steps = TRAIN_UPDATES * TRAIN_DECISIONS * TRAIN_WINDOW
            per = {k: v / TRAIN_UPDATES * 1e3 for k, v in stats.items()}
            sps = e * steps / stats["rollout"]
            steady_sps = (e * TRAIN_DECISIONS * TRAIN_WINDOW
                          / rollouts[-1])
            log(f"  launches in train({form}): {counts}")
            log(f"train ({form}): {TRAIN_UPDATES} updates x "
                f"{TRAIN_DECISIONS} decisions x {TRAIN_WINDOW} steps x {e} "
                f"envs in {dt:.3f} s on {smi}; ms per update: rollout "
                f"{per['rollout']:.1f} (policy inputs "
                f"{per['policy_inputs']:.1f} of it; "
                + ", ".join(f"{k} {per[k]:.1f}" for k in parts if k in per)
                + f"), update {per['update']:.1f}; {sps:.2f} env steps/s "
                f"in the "
                f"rollout; peak device memory {peak / 2**30:.2f} GiB; "
                f"parameters moved by up to {moved:.3e}; metrics "
                + "; ".join(", ".join(f"{k} {v:.5f}" for k, v in m.items())
                            for m in metrics))
            log(f"train ({form}): goal planning of the first decision "
                f"{plans[0] * 1e3:.1f} ms, of the later ones "
                + ", ".join(f"{t * 1e3:.1f}" for t in plans[1:])
                + f" ms; the last update's rollout (grids cached) "
                f"{rollouts[-1] * 1e3:.1f} ms, {steady_sps:.2f} env steps/s "
                f"on {smi}; rollout ms per update "
                + ", ".join(f"{t * 1e3:.1f}" for t in rollouts))
            if len(metrics) != TRAIN_UPDATES or not all(
                    math.isfinite(v) for m in metrics for v in m.values()):
                raise AssertionError(f"train({form}) metrics {metrics}")
            if not moved > 0:
                raise AssertionError(f"train({form}) left the parameters "
                                     "as they were")
            path_kernels = ("raycast_minargmin", "fused_preprocess",
                            "flash_attention", "layernorm",
                            "decode_self_block", "decode_cross_block",
                            "decode_mlp")
            if any(counts[k] <= 0 for k in path_kernels) or (
                    counts["decode_self_attention"]
                    or counts["decode_cross_attention"]):
                raise AssertionError(f"train({form}) launch counts {counts}")
            log(f"  train({form}) checked at {time.perf_counter() - t_start:.1f} s")
            # the checkpoint of the last update, read back
            path = os.path.join(ckpt, "policy.pkl")
            saved = [x.clone() for x in after]
            trainer.load_checkpoint(path)
            if not all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(trainer.ppo_state.params), saved)):
                raise AssertionError("policy.pkl read back differs")
            # one decision and its update, for the idle share
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(1, 1, fused=fused)
            torch.cuda.synchronize()
            one_us = (time.perf_counter() - t0) * 1e6
            profile_run(f"train({form}): one decision of {TRAIN_WINDOW} "
                        "steps and its update",
                        lambda: trainer.train(1, 1, fused=fused), one_us)
            log(f"  train({form}) profiled at {time.perf_counter() - t_start:.1f} s")
            out[form] = dict(counts=counts, seconds=dt, per_update_ms=per,
                             env_steps_per_s=sps,
                             steady_env_steps_per_s=steady_sps,
                             first_plan_ms=plans[0] * 1e3, peak_bytes=peak,
                             metrics=metrics)
        trainer.envs.close()
    return out


def time_calls(obj, names, split=None) -> dict:
    """Replace the methods `names` of `obj` by wrappers that append the
    synchronised wall time of each call to split[name]; returns split."""
    split = {} if split is None else split
    for name in names:
        split[name] = []

        def timed(*a, _fn=getattr(obj, name), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                split[_name].append(time.perf_counter() - t0)

        setattr(obj, name, timed)
    return split


def run_exp_train_on_card() -> None:
    """`run_exp --mode train` at the tiny preset, in process, on the card:
    its JSON line shows the updates and finite metrics, and policy.pkl is
    written."""
    import contextlib
    import io
    import tempfile

    from embodied_captioning_tpu_torch import run_exp

    with tempfile.TemporaryDirectory(prefix="ecap_run_exp_") as ckpt:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_exp.main([
                "--trainer", "goalexplorationbaseline-v0", "--mode", "train",
                "--preset", "tiny", "--steps", "1", "ppo.num_global_steps=2",
                f"runtime.checkpoint_dir={ckpt}"])
        printed = buf.getvalue().strip().splitlines()
        line = json.loads(printed[-1])
        written = os.path.exists(os.path.join(ckpt, "policy.pkl"))
    log(f"  run_exp --mode train on the card: rc {rc}, {line}")
    if rc != 0 or line["mode"] != "train" or line["updates"] != 1 or not (
            written and all(math.isfinite(v) for m in line["metrics"]
                            for v in m.values())):
        raise AssertionError("run_exp --mode train on the card failed")


# ---------------------------------------------------------------------------
# phase 10: the captioner fine-tune (`finetune_captioner`)
# ---------------------------------------------------------------------------

FT_BATCH = 8                   # the fine-tune script's default batch
FT_STEPS = 3                   # timed train steps after a warm-up step
FT_LR = 1e-3                   # phase 10a's step (2 lr bounds a sign flip)
FT_TRIPLET = 0.1               # the fine-tune script's triplet weight


def leaf_paths(tree, path: str = "") -> list:
    """Dotted names of a parameter tree's leaves in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_paths(tree[k], f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_paths(v, f"{path}[{i}]")]
    return [path]


def finetune_batch(cfg, n: int, seed: int, dev) -> list:
    """n uint8 crops at the ViT's input size, tokens BOS .. EOS of lengths
    6-30 padded with PAD, object ids in pairs (the triplet loss's
    positives), all valid."""
    rng = np.random.default_rng(seed)
    s, t = cfg.vision.image_size, cfg.text
    imgs = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    toks = np.full((n, t.context_length), t.pad_id, np.int32)
    for i in range(n):
        k = int(rng.integers(5, min(30, t.context_length - 1)))
        toks[i, 0] = t.bos_id
        toks[i, 1:k] = rng.integers(3, t.vocab_size, k - 1)
        toks[i, k] = t.eos_id
    ids = np.arange(n, dtype=np.int32) // 2
    return [torch.from_numpy(x).to(dev)
            for x in (imgs, toks, ids, np.ones(n, bool))]


def finetune_card_vs_cpu(dev) -> None:
    """`train_step` at the tiny preset on the card (the LayerNorm forward
    and backward kernels, the fused preprocess) and on the CPU (their plain
    versions), same weights and batch (4 crops, triplet weight 0.1). Every
    leaf's gradient within the larger of 5% of its norm and 3x the CPU's
    own spread: how far the CPU's gradient of that leaf moves when the
    parameters move by 1e-4 of themselves (two draws; ROADMAP C.20: the
    key biases' gradients are zero in exact arithmetic, and the multimodal
    cross-attention's query and key see nearly equal keys, so theirs are
    rounding noise); every leaf whose CPU gradient is non-zero non-zero and
    finite on the card (ROADMAP C.21); the loss and its parts within the
    larger of 1e-3 and 3x their spread; the parameters after one step
    within 2 lr (1 + 0.01 |p|) of each other (a gradient whose sign
    differs moves an element 2 lr the other way), and where both clipped
    gradients have one sign and are at least 1e-4 (Adam's eps then moves
    the first step by under 1e-4 of itself) within 1e-4 lr + 2^-21 (|p| +
    lr): the same step but for rounding, which a wrong weight decay (lr
    0.01 |p|) oversteps where |p| is of order 1 (the LayerNorm gains)."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import (
        tree_leaves, tree_map)

    cfg = CaptionerConfig.tiny()
    params = init_captioner(torch.Generator().manual_seed(11), cfg, "cpu")
    names = leaf_paths(params)
    batch = finetune_batch(cfg, 4, 0, "cpu")

    def run(p, where):
        g, loss, aux = TT.loss_and_grads(
            to_device(p, where), *[x.to(where) for x in batch], cfg,
            FT_TRIPLET)
        return ([x.float().cpu() for x in tree_leaves(g)],
                dict({k: float(v) for k, v in aux.items()}, loss=float(loss)))

    g_cpu, parts_cpu = run(params, "cpu")
    spreads = [0.0] * len(names)
    part_spread = {k: 0.0 for k in parts_cpu}
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        moved = tree_map(lambda x: x * (1 + 1e-4 * torch.randn(
            x.shape, generator=gen)), params)
        gm, pm = run(moved, "cpu")
        spreads = [max(s, (a - b).norm().item())
                   for s, a, b in zip(spreads, gm, g_cpu)]
        part_spread = {k: max(v, abs(pm[k] - parts_cpu[k]))
                       for k, v in part_spread.items()}
    torch.cuda.synchronize()
    K.reset_launches()
    g_card, parts_card = run(params, dev)
    counts = dict(K.launches)
    worst, bad, dead = [], [], []
    for n, a, b, sp in zip(names, g_card, g_cpu, spreads):
        err = (a - b).norm().item()
        lim = max(5e-2 * b.norm().item(), 3 * sp)
        worst.append((err / lim if lim > 0 else (0.0 if err == 0 else
                                                  math.inf), n))
        if not err <= lim:
            bad.append((n, err, lim))
        if bool((b != 0).any()) and not (bool((a != 0).any())
                                          and bool(torch.isfinite(a).all())):
            dead.append(n)
    worst.sort(reverse=True)
    log(f"  fine-tune card vs CPU (tiny, 4 crops): {len(names)} leaves; "
        f"gradient error / limit, the largest five: "
        + ", ".join(f"{n} {r:.3f}" for r, n in worst[:5])
        + f"; leaves with a non-zero CPU gradient and a zero or non-finite "
        f"card gradient: {len(dead)}")
    for k in parts_cpu:
        lim = max(1e-3 * abs(parts_cpu[k]), 3 * part_spread[k])
        log(f"    {k}: card {parts_card[k]:.6f}, CPU {parts_cpu[k]:.6f} "
            f"(limit {lim:.2e})")
        if not abs(parts_card[k] - parts_cpu[k]) <= lim:
            bad.append((k, parts_card[k], parts_cpu[k]))
    log(f"    launches in the card's loss and gradients: "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts["layernorm_bwd"] <= 0 or counts["layernorm"] <= 0 or \
            counts["fused_preprocess"] <= 0 or counts["flash_attention"]:
        raise AssertionError(f"fine-tune launch counts {counts}")
    states = {}
    for where in ("cpu", dev):
        st = TT.create_train_state(to_device(params, where))
        states[str(where)] = TT.train_step(
            st, *[x.to(where) for x in batch], cfg, lr=FT_LR,
            triplet_weight=FT_TRIPLET)[0]
    p0 = tree_leaves(params)
    p_cpu = tree_leaves(states["cpu"].params)
    p_card = [x.cpu() for x in tree_leaves(states[str(dev)].params)]
    ratio = max(((a - b).abs() / (2 * FT_LR * (1 + 0.01 * c.abs()) + 1e-7)
                 ).max().item() for a, b, c in zip(p_card, p_cpu, p0))
    flips = sum(int(((a - b).abs() > FT_LR).sum()) for a, b in
                zip(p_card, p_cpu))
    total = sum(x.numel() for x in p0)
    def clip_scale(gs):
        norm = math.sqrt(sum(float(torch.sum(torch.square(x.double())))
                             for x in gs))
        return 1.0 if norm < TT.MAX_GRAD_NORM else TT.MAX_GRAD_NORM / norm

    ca, cb = clip_scale(g_card), clip_scale(g_cpu)
    tight, n_same, n_large = 0.0, 0, 0
    for a, b, c, ga, gb in zip(p_card, p_cpu, p0, g_card, g_cpu):
        ga, gb = ga * ca, gb * cb
        same = (torch.sign(ga) == torch.sign(gb)) & (
            torch.minimum(ga.abs(), gb.abs()) >= 1e-4)
        if bool(same.any()):
            lim = 1e-4 * FT_LR + 2.0 ** -21 * (c[same].abs() + FT_LR)
            tight = max(tight, ((a - b)[same].abs() / lim).max().item())
        n_same += int(same.sum())
        n_large += int((c[same].abs() >= 0.5).sum())
    log(f"    parameters after one step: max diff {ratio:.4f} of 2 lr "
        f"(1 + 0.01 |p|); {flips} of {total} elements more than lr apart "
        f"(a flipped gradient sign); {n_same} elements whose clipped "
        f"gradients share a sign and are at least 1e-4 ({n_large} of them "
        f"with |p| >= 0.5): max diff {tight:.4f} of 1e-4 lr + 2^-21 (|p| + "
        f"lr)")
    if (bad or dead or not ratio <= 1.0 or not tight <= 1.0
            or n_same < total // 4 or n_large < 100):
        raise AssertionError(f"fine-tune card vs CPU: {bad} {dead} {ratio} "
                             f"{tight} {n_same} {n_large}")


def finetune_full_width(dev, smi: str) -> dict:
    """One `train_step` at the large preset (ViT-L/14 at 224^2, the 768-wide
    12+12-layer decoder, 49,408-token vocabulary; seeded weights) at the
    fine-tune's batch of FT_BATCH crops, triplet weight 0.1: with `remat`
    off and then on, a warm-up step, FT_STEPS timed steps (host clock
    around synchronised steps), their launch counts and peak memory, one
    step under the profiler for device busy and idle share. Returns the
    readings and the parameter shapes."""
    import dataclasses
    import gc

    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    # the fine-tune's own memory: what is allocated past what earlier
    # phases left (their objects are collected first)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = CaptionerConfig.large()
    params = init_captioner(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    batch = finetune_batch(cfg, FT_BATCH, 3, dev)
    out = dict(n_params=n_params, shapes=[tuple(x.shape) for x in leaves])
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)

        def step(st):
            return TT.train_step(st, *batch, c, triplet_weight=FT_TRIPLET)

        state = TT.create_train_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, aux = step(state)                             # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        times, losses = [], []
        for _ in range(FT_STEPS):
            t0 = time.perf_counter()
            state, aux = step(state)
            losses.append(float(aux["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = dict(K.launches)
        peak = torch.cuda.max_memory_allocated() - base
        ms = sorted(times)[len(times) // 2] * 1e3
        moved = sum(int(not torch.equal(a, b)) for a, b in
                    zip(tree_leaves(state.params), leaves))
        log(f"fine-tune train_step, large preset, batch {FT_BATCH}, remat "
            f"{'on' if remat else 'off'}: {ms:.1f} ms a step (median of "
            f"{FT_STEPS}: " + ", ".join(f"{t * 1e3:.1f}" for t in times)
            + f") on {smi}; {FT_BATCH / ms * 1e3:.2f} crops/s; peak device "
            f"memory {peak / 2**30:.2f} GiB (weights, optimizer state, "
            f"gradients and activations; {base / 2**30:.2f} GiB of earlier "
            f"phases beside it); {n_params} parameters, "
            f"{moved} of {len(leaves)} leaves moved; losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; LayerNorm launches a step: forward "
            f"{counts['layernorm'] / FT_STEPS:g}, backward "
            f"{counts['layernorm_bwd'] / FT_STEPS:g}; all launches over the "
            f"timed steps {({k: v for k, v in counts.items() if v})}")
        if (not all(math.isfinite(x) for x in losses) or moved != len(leaves)
                or counts["layernorm_bwd"] <= 0
                or counts["fused_preprocess"] != FT_STEPS
                or counts["flash_attention"]):
            raise AssertionError(f"fine-tune step (remat {remat}) failed: "
                                 f"{losses} {moved} {counts}")
        busy = profile_run(f"one fine-tune step, remat "
                           f"{'on' if remat else 'off'}",
                           lambda: step(state), ms * 1e3)
        out["remat" if remat else "plain"] = dict(
            ms=ms, peak_bytes=peak, counts=counts, busy_us=busy)
        del state, aux
        torch.cuda.empty_cache()
    return out


def finetune_entry_point(store: str, shapes: list) -> dict:
    """`finetune_captioner` (python -m embodied_captioning_tpu_torch.
    finetune_captioner) at the large preset on the store that phase 8's
    `generate` wrote, in process on the card, with its defaults (1 epoch,
    batch 8, lr 1e-4, triplet weight 0.1) and the repository's
    pseudo_captions.json ({}: the captions come from the store): its JSON
    line (pairs, steps = pairs // 8, finite losses) and the pickle read
    back (numpy leaves of the init's shapes, all finite)."""
    import contextlib
    import io
    import tempfile

    from embodied_captioning_tpu_torch import finetune_captioner
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.params import load_pickle
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    with tempfile.TemporaryDirectory(prefix="ecap_finetune_") as d:
        save = os.path.join(d, "captioner_finetuned.pkl")
        buf = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = finetune_captioner.main([
                store, "--preset", "large", "--save", save,
                "--pseudo-captions", str(REPO / "pseudo_captions.json")])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.launches)
        printed = buf.getvalue().strip().splitlines()
        line = json.loads(printed[-1])
        size = os.path.getsize(save) if os.path.exists(save) else 0
        t0 = time.perf_counter()
        tree = tree_leaves(load_pickle(save)) if size else []
        dt_load = time.perf_counter() - t0
    log("  " + "; ".join(x for x in printed[:-1]
                         if x.startswith("[finetune]")))
    log(f"  finetune_captioner on phase 8's store: rc {rc}, {line}; "
        f"{dt:.1f} s in all; the pickle {size / 2**30:.2f} GiB, read back "
        f"in {dt_load:.1f} s; launches {({k: v for k, v in counts.items() if v})}")
    ok = (rc == 0 and line.get("pairs", 0) > 0
          and line["steps"] == line["pairs"] // FT_BATCH
          and line["steps"] > 0
          and all(math.isfinite(line[k]) for k in ("first_loss",
                                                   "last_loss"))
          and line["saved"] == save
          and [tuple(x.shape) for x in tree] == shapes
          and all(isinstance(x, np.ndarray) and np.isfinite(x).all()
                  for x in tree)
          and counts["layernorm_bwd"] > 0)
    if not ok:
        raise AssertionError("finetune_captioner on the card failed")
    return dict(line=line, seconds=dt, counts=counts)


# ---------------------------------------------------------------------------
# phase 11: the two learning self-checks (`selfcheck_training`,
# `selfcheck_detector`)
# ---------------------------------------------------------------------------

DET_HEADS = ("ce", "focal", "soft", "softfocal", "msefocal")
DET_STEP_BATCH = 8             # the detector self-check's default batch
DET_STEPS = 3                  # timed detector steps after a warm-up step
DET_LR = 1e-3                  # the detector self-check's default lr
DET_SPREAD_DRAWS = 4           # 11a: moves of the CPU's parameters
SELF_CHECK_BAR = 0.8           # held-out sbert_cosine: the JAX script's bar
INT8_GAP = 0.01                # int8_sbert_cosine within this of it
MAP50_TRAIN_BAR = 0.4          # the detector self-check's bars at 700 steps
MASK_IOU_BAR = 0.5
MASK_MATCHED_BAR = 5
MIN_FREE_RUN_AGREE = 0.9       # C.8: rows with equal free-running tokens
# kernels the learning path launches: the render (raycast), the training
# forward and backward (LayerNorm, its backward, the preprocess), the
# evaluation's ViT (flash) and greedy decoding on the block route
LEARNING_KERNELS = ("raycast_minargmin", "layernorm", "layernorm_bwd",
                    "fused_preprocess", "flash_attention", "decode_mlp",
                    "decode_self_block", "decode_cross_block")


def kernel_family(name: str) -> str:
    """A device kernel's family for the step's split: convolutions (cuDNN's
    forward, data and weight gradients), products (GEMMs), the port's own
    kernels, and elementwise / reductions / copies (everything else)."""
    n = name.lower()
    if any(k in name for k in PORTED_KERNELS):
        return "ported kernels"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "winograd")):
        return "convolutions"
    if any(k in n for k in ("gemm", "cutlass", "cublas", "matmul", "xmma")):
        return "products"
    return "elementwise, reductions, copies"


def family_split(fn) -> dict:
    """Device time (ms) by kernel family over one call of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_marker()
        fn()
        torch.cuda.synchronize()
        trace_marker()
        torch.cuda.synchronize()
    split: dict = {}
    for e in device_events(prof):
        f = kernel_family(e.name)
        split[f] = split.get(f, 0.0) + (e.time_range.end
                                        - e.time_range.start) / 1e3
    return split


def detector_batch(cfg, n: int, g: int, seed: int, dev):
    """n uint8 frames at the detector's size and padded ground truth of g
    boxes each (80% valid), classes, teacher probabilities and box-shaped
    masks at the detector's size."""
    from embodied_captioning_tpu_torch.ops.detections import Detections

    s = cfg.image_size
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, s * 0.8, (n, g))
    y1 = rng.uniform(0, s * 0.8, (n, g))
    boxes = np.stack([x1, y1,
                      np.minimum(x1 + rng.uniform(s / 10, s / 2, (n, g)), s),
                      np.minimum(y1 + rng.uniform(s / 10, s / 2, (n, g)), s)],
                     -1).astype(np.float32)
    masks = np.zeros((n, g, s, s), np.uint8)
    for i in range(n):
        for j in range(g):
            a, b, c, d = boxes[i, j].astype(int)
            masks[i, j, b:d, a:c] = 1
    images = torch.from_numpy(rng.integers(0, 256, (n, s, s, 3),
                                           dtype=np.uint8)).to(dev)
    gt = Detections(
        boxes=torch.from_numpy(boxes), scores=torch.ones(n, g),
        classes=torch.from_numpy(rng.integers(0, 6, (n, g)).astype(np.int32)),
        logits=torch.from_numpy(rng.dirichlet(np.ones(6), (n, g)).astype(
            np.float32)),
        valid=torch.from_numpy(rng.random((n, g)) < 0.8),
        masks=torch.from_numpy(masks)).to(dev)
    return images, gt


def detector_card_vs_cpu(dev, smi: str) -> None:
    """11a: `detector_loss` at the tiny preset on the card (cuDNN
    convolutions, the port's ops under autograd) and on the CPU, same
    weights and batch (2 frames, 8 ground-truth boxes with masks), for the
    five ROI heads: the loss and its five parts within the larger of 1e-4
    of their value and 3x their CPU spread (how far the CPU's part moves
    when the parameters move by 1e-4 of themselves, the largest of
    DET_SPREAD_DRAWS draws: a 1e-4 move shifts the loss by about 1e-2, a
    rounding of the bf16 stream as large as the card's own, and the
    largest of two draws reads up to half of the largest of eight); every
    leaf's gradient within the larger of 5% of its norm and 3x its CPU
    spread; every leaf with a non-zero CPU gradient non-zero and finite on
    the card. Then one clip-by-global-norm(5) + Adam step (ce head): the
    parameters within 2 lr of each other."""
    from embodied_captioning_tpu_torch.config import DetectorConfig
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.selfcheck_detector import (
        loss_and_grads, train_step)
    from embodied_captioning_tpu_torch.train.optim import (
        adam_init, tree_leaves, tree_map)

    cfg = DetectorConfig.tiny()
    params = init_detector(torch.Generator().manual_seed(5), cfg, "cpu")
    names = leaf_paths(params)
    images, gt = detector_batch(cfg, 2, 8, 0, "cpu")

    def run(p, where, head):
        g, loss, aux = loss_and_grads(to_device(p, where), images.to(where),
                                      gt.to(where), cfg, head)
        return ([x.float().cpu() for x in tree_leaves(g)],
                dict({k: float(v) for k, v in aux.items()}, loss=float(loss)))

    bad, summary = [], []
    for head in DET_HEADS:
        g_cpu, parts_cpu = run(params, "cpu", head)
        spreads = [0.0] * len(g_cpu)
        part_spread = {k: 0.0 for k in parts_cpu}
        for seed in range(1, DET_SPREAD_DRAWS + 1):
            gen = torch.Generator().manual_seed(seed)
            moved = tree_map(lambda x: x * (1 + 1e-4 * torch.randn(
                x.shape, generator=gen)), params)
            gm, pm = run(moved, "cpu", head)
            spreads = [max(s, (a - b).norm().item())
                       for s, a, b in zip(spreads, gm, g_cpu)]
            part_spread = {k: max(v, abs(pm[k] - parts_cpu[k]))
                           for k, v in part_spread.items()}
        g_card, parts_card = run(params, dev, head)
        worst = 0.0
        for n, a, b, sp in zip(names, g_card, g_cpu, spreads):
            err = (a - b).norm().item()
            lim = max(5e-2 * b.norm().item(), 3 * sp)
            worst = max(worst, err / lim if lim > 0 else
                        (0.0 if err == 0 else math.inf))
            if not err <= lim:
                bad.append((head, n, err, lim))
            if bool((b != 0).any()) and not (
                    bool((a != 0).any()) and bool(torch.isfinite(a).all())):
                bad.append((head, n, "zero or non-finite on the card"))
        part_err = {}
        for k in parts_cpu:
            lim = max(1e-4 * abs(parts_cpu[k]), 3 * part_spread[k])
            part_err[k] = abs(parts_card[k] - parts_cpu[k]) / max(lim, 1e-30)
            if not part_err[k] <= 1.0:
                bad.append((head, k, parts_card[k], parts_cpu[k], lim))
        k = max(part_err, key=part_err.get)
        summary.append(f"{head}: loss card {parts_card['loss']:.5f} CPU "
                       f"{parts_cpu['loss']:.5f} (spread "
                       f"{part_spread['loss']:.2e}); worst part {k} "
                       f"{part_err[k]:.3f} of its limit (card "
                       f"{parts_card[k]:.5f}, CPU {parts_cpu[k]:.5f}, spread "
                       f"{part_spread[k]:.2e}); worst leaf {worst:.3f} of "
                       f"its limit")
    log(f"  detector_loss card ({smi}) vs CPU (tiny, 2 frames, 8 boxes, "
        f"masks), {len(names)} leaves:\n    " + "\n    ".join(summary))
    after = {}
    for where in ("cpu", dev):
        p, opt, _ = train_step(to_device(params, where), adam_init(
            to_device(params, where)), images.to(where), gt.to(where), cfg,
            "ce", lambda c: DET_LR)
        after[str(where)] = [x.cpu() for x in tree_leaves(p)]
    ratio = max(((a - b).abs() / (2 * DET_LR + 1e-7)).max().item()
                for a, b in zip(after[str(dev)], after["cpu"]))
    log(f"    parameters after one clip + Adam step (ce): max diff "
        f"{ratio:.4f} of 2 lr")
    if bad or not ratio <= 1.0:
        raise AssertionError(f"detector card vs CPU: {bad[:8]} {ratio}")


def detector_step_full_width(dev, smi: str, preset: str) -> dict:
    """11b: one detector training step at `preset` (large: the R50
    bottleneck FPN P3-P6 with affine norm at 1024^2, 128 proposals; base:
    basic blocks with GroupNorm at 256^2), batch DET_STEP_BATCH, ce head,
    masks on, seeded weights, on frames of the port's simulator with their
    ground truth (`selfcheck_detector.collect`): a warm-up step,
    DET_STEPS timed steps (host clock around synchronised steps), peak
    memory, and one step under the profiler (device busy and idle share,
    device time by kernel family)."""
    import gc

    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.selfcheck_detector import (
        batch_of, collect, train_step)
    from embodied_captioning_tpu_torch.train.optim import (
        adam_init, tree_leaves)

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = load_config(preset)
    dcfg = cfg.detector
    t0 = time.perf_counter()
    frames = collect(cfg, 2, DET_STEP_BATCH // 2, 0,
                     np.random.default_rng(0), dev)
    collect_s = time.perf_counter() - t0
    images, gt = batch_of(frames, range(DET_STEP_BATCH), dcfg.image_size, dev)
    params = init_detector(torch.Generator(device=dev).manual_seed(0), dcfg,
                           dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    state = [params, adam_init(params)]

    def step():
        state[0], state[1], loss = train_step(state[0], state[1], images, gt,
                                              dcfg, "ce", lambda c: DET_LR)
        return loss

    torch.cuda.reset_peak_memory_stats()
    step()                                                   # warm-up
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(DET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    ms = sorted(times)[len(times) // 2] * 1e3
    moved = sum(int(not torch.equal(a, b)) for a, b in
                zip(tree_leaves(state[0]), tree_leaves(params)))
    log(f"detector train step, {preset} preset ({dcfg.block} blocks, "
        f"{dcfg.norm} norm, {dcfg.image_size}^2, {dcfg.num_proposals} "
        f"proposals, masks), batch {DET_STEP_BATCH}, ce head: {ms:.1f} ms a "
        f"step (median of {DET_STEPS}: "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f") on {smi}; {DET_STEP_BATCH / ms * 1e3:.2f} frames/s; peak "
        f"device memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB of "
        f"earlier phases beside it); {n_params} parameters, {moved} leaves "
        f"moved; losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; {len(frames)} frames collected in {collect_s:.1f} s, "
        f"{int(gt.valid.sum())} valid boxes")
    if not all(math.isfinite(x) for x in losses) or moved == 0:
        raise AssertionError(f"detector step ({preset}) failed: {losses}")
    busy = profile_run(f"one detector train step, {preset} preset", step,
                       ms * 1e3, top=10)
    split = family_split(step)
    total = sum(split.values())
    log("    device time by family: " + "; ".join(
        f"{k} {v:.1f} ms ({v / total:.3f})"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    del state, images, gt, frames
    torch.cuda.empty_cache()
    return dict(ms=ms, peak_bytes=peak, busy_us=busy, split=split)


def run_entry(main, argv: list) -> tuple:
    """An entry point's `main(argv)` in this process, its output echoed:
    (return code, its last line as JSON)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log("    | " + line[:400])
    return rc, json.loads(text.strip().splitlines()[-1])


def captioner_selfcheck(dev, smi: str, tmp: str) -> dict:
    """11c: the captioner self-check whole, on the card, with the JAX
    script's defaults (tiny preset, 192 train crops asked for, 300 steps,
    batch 16) and --speculative: its JSON line, the bar held-out
    sbert_cosine > SELF_CHECK_BAR with int8_sbert_cosine within INT8_GAP of
    it (read with the port's own seeded captioner and sentence encoder),
    speculative decoding's exactness, and the launches of the whole run;
    then a timed run at the large preset (20 steps on 64 crops). Returns
    the tiny run's trained state and eval corpus (for 11e)."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch import selfcheck_training as ST

    kept = {}
    train = ST.train

    def keep_state(*a, **k):
        out = train(*a, **k)
        kept["state"] = out[0]
        return out

    cache = os.path.join(tmp, "captioner_eval.npz")
    ST.train = keep_state
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        rc, line = run_entry(ST.main, ["--speculative", "--eval-cache",
                                       cache])
        seconds = time.perf_counter() - t0
        counts = dict(K.launches)
    finally:
        ST.train = train
    cos, cos_q = line.get("sbert_cosine", 0.0), line.get("int8_sbert_cosine",
                                                         0.0)
    spec = line.get("speculative", {})
    log(f"  captioner self-check (tiny, JAX script defaults) on {smi}: "
        f"{seconds:.1f} s; sbert_cosine {cos} (bar > {SELF_CHECK_BAR}), "
        f"int8 {cos_q} (within {INT8_GAP}), class_word_accuracy "
        f"{line.get('class_word_accuracy')}, bleu {line.get('bleu')}; "
        f"speculative exact: "
        + ", ".join(f"{b} {v['exact']}" for b, v in spec.items())
        + f"; launches {({k: v for k, v in counts.items() if v})}")
    missing = [k for k in LEARNING_KERNELS if counts[k] <= 0]
    if (rc != 0 or missing or not cos > SELF_CHECK_BAR
            or not abs(cos_q - cos) <= INT8_GAP):
        raise AssertionError(f"captioner self-check failed: rc {rc}, "
                             f"kernels not launched {missing}, {line}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc_l, large = run_entry(ST.main, ["--preset", "large", "--steps", "20",
                                      "--train-crops", "64"])
    log(f"  captioner self-check, large preset, 20 steps on "
        f"{large.get('train_crops')} crops, batch 16, on {smi}: "
        f"step_ms_median {large.get('step_ms_median')} ms, hbm_peak_gb "
        f"{large.get('hbm_peak_gb')} of {large.get('hbm_limit_gb')}, "
        f"{time.perf_counter() - t0:.1f} s in all")
    if rc_l != 0 or not math.isfinite(large.get("last_loss", math.nan)):
        raise AssertionError(f"large captioner self-check failed: {large}")
    torch.cuda.empty_cache()
    return dict(line=line, counts=counts, large=large,
                state=kept["state"], eval_cache=cache)


def detector_selfcheck(smi: str) -> dict:
    """11d: the detector self-check on the card at the tiny preset with
    --steps 700 --episodes 4: its JSON line and the bars map50_train >
    MAP50_TRAIN_BAR, mask_iou > MASK_IOU_BAR with mask_matched >
    MASK_MATCHED_BAR."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch import selfcheck_detector as SD

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    rc, line = run_entry(SD.main, ["--steps", "700", "--episodes", "4"])
    seconds = time.perf_counter() - t0
    counts = dict(K.launches)
    log(f"  detector self-check (tiny, 700 steps, 4 episodes) on {smi}: "
        f"{seconds:.1f} s; map50_train {line.get('map50_train')} (bar > "
        f"{MAP50_TRAIN_BAR}), mask_iou {line.get('mask_iou')} (bar > "
        f"{MASK_IOU_BAR}) on {line.get('mask_matched')} matched (bar > "
        f"{MASK_MATCHED_BAR}), map50 unseen scenes {line.get('map50_before')}"
        f" -> {line.get('map50_after')}; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    if (rc != 0 or not line.get("map50_train", 0) > MAP50_TRAIN_BAR
            or not line.get("mask_iou", 0) > MASK_IOU_BAR
            or not line.get("mask_matched", 0) > MASK_MATCHED_BAR):
        raise AssertionError(f"detector self-check failed: {line}")
    return dict(line=line, counts=counts, seconds=seconds)


def free_running_on_trained_weights(K, cap: dict, dev, smi: str) -> None:
    """11e (ROADMAP C.8, C.15): greedy decoding of the held-out crops by the
    captioner 11c trained, free-running through the kernels and through
    their plain versions, float and int8: rows with equal tokens at least
    MIN_FREE_RUN_AGREE; the route the decode step took, and the kernels
    launched; speculative decoding against greedy on the same weights."""
    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models.captioner import (
        generate, generate_speculative)
    from embodied_captioning_tpu_torch.models.common import decode_route
    from embodied_captioning_tpu_torch.models.quantize import quantize_params

    cfg = CaptionerConfig.tiny()
    crops = torch.from_numpy(np.load(cap["eval_cache"])["crops"]).to(dev)
    params = cap["state"].params
    t = cfg.text
    route = decode_route(crops.shape[0], t.width, t.heads,
                         int(t.width * t.mlp_ratio), cfg.max_caption_len,
                         True)
    bad = []
    for what, p in (("float", params), ("int8", quantize_params(params))):
        K.reset_launches()
        tk = generate(p, crops, cfg)[0]
        counts = {k: v for k, v in K.launches.items() if v}
        with plain_kernels(K):
            tp = generate(p, crops, cfg)[0]
        agree = (tk == tp).all(dim=1).float().mean().item()
        spec = generate_speculative(p, crops, cfg)[0]
        spec_rows = (spec == tk).all(dim=1).float().mean().item()
        log(f"  C.8 on trained weights ({what}, {crops.shape[0]} held-out "
            f"crops, {smi}): free-running tokens equal through the kernels and "
            f"their plain versions on {agree:.3f} of rows (gate "
            f"{MIN_FREE_RUN_AGREE}); route {route._asdict()}; launches "
            f"{counts}; C.15: speculative equals greedy through the kernels "
            f"on {spec_rows:.3f} of rows")
        if not agree >= MIN_FREE_RUN_AGREE:
            bad.append((what, agree))
        if what == "float" and not all(route):
            bad.append(("route", route))
    if bad:
        raise AssertionError(f"free-running decoding on trained weights: "
                             f"{bad}")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def self_attention_only(root: Path) -> int:
    """decode_self_attention's cases (phase 2's) through the kernels of the
    checkout at `root`, built from its sources: an earlier commit's, to
    time beside this one's in one call. Prints one JSON line of the
    cases."""
    sys.path.insert(0, str(root.resolve()))
    from embodied_captioning_tpu_torch import kernels as K

    log(card_name())
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        K.build()
        log(f"decode_self_attention of {root} ({Path(K.__file__).parent})")
        cases = self_attention_cases(K, torch.device("cuda"))
        log_rows({"decode_self_attention": dict(**cases[0],
                                                cases=cases[1:])})
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"self_attention_cases": cases, "root": str(root)}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--sass"] and len(sys.argv) == 3:
        # the preprocess kernel's instructions in another build of the
        # kernels (an earlier commit's, to compare with): no card needed
        sass = preprocess_sass(Path(sys.argv[2]))
        log_preprocess_sass(sass)
        return 0 if sass else 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--self-attention"] and len(sys.argv) == 3:
        return self_attention_only(Path(sys.argv[2]))
    try:
        from embodied_captioning_tpu_torch import kernels as K
        from embodied_captioning_tpu_torch.models import quantize as QZ
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc})",
              file=sys.stderr)
        return 2
    smi = card_name()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")
    dev = torch.device("cuda")
    try:
        t0 = time.perf_counter()
        K.build()
        log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
        log("[2] kernels vs plain versions at the main paths' shapes")
        setup = full_width_setup(dev)
        rows = kernel_checks(K, QZ, dev)
        rows.update(generation_kernel_checks(K, QZ, dev))
        route_checks(K, dev)
        from embodied_captioning_tpu_torch.envs.device_loop import (
            camera_poses)
        rows.update(loop_kernel_checks(K, dev, setup["scenes"],
                                       camera_poses(setup["state"]),
                                       setup["cfg"]))
        rows.update(layernorm_bwd_checks(K, dev))
        log("[3] perceive at full width")
        res = perceive_full_width(setup)
        log(f"perceive: {res['fps']:.2f} frames/s on {smi} "
            f"({FRAMES} frames x {BATCHES} batches in "
            f"{res['seconds']:.3f} s, {res['steps']} decode steps, "
            f"{res['valid_detections']} valid detections)")
        routes = decode_routes_in_turns(setup)
        log("[4] the exploration loop at full width")
        render_kernel_vs_plain(setup)
        loop = rollouts_full_width(setup, smi)
        fuse_card_vs_cpu(setup)
        log("[5] tiny preset: card vs CPU")
        tiny_card_vs_cpu(dev)
        tiny_generate_card_vs_cpu(dev)
        log("[6] device time of one full-width perceive batch on each "
            "decode route and of one rollout_fused step")
        from embodied_captioning_tpu_torch.perception import perceive
        for blocks, what in ((True, "block kernels"),
                             (False, "separate calls")):
            profile_run(f"one perceive batch, {what}",
                        lambda: perceive(res["params"], routes["frames"],
                                         res["cfg"], decode_blocks=blocks),
                        routes["ms"][blocks] * 1e3)
        log("  LayerNorm of one perceive batch on the block route, by its "
            "parameters and input shape:")
        rows["layernorm"]["perceive_split"] = layernorm_split(
            K, res["params"], lambda: perceive(res["params"], routes["frames"],
                                               res["cfg"]))
        route_counts, perceive_counts = routes["counts"], res["counts"]
        profile_run("one rollout_fused step", loop["one_step"],
                    sum(loop["per_step_ms"].values()) * 1e3)
        log("[7] beam, sampled and speculative generation at full width")
        generation_modes(setup, smi)
        import tempfile
        with tempfile.TemporaryDirectory(prefix="ecap_generate_") as store:
            log("[8] the exploration entry point (generate) at full width")
            gen = generate_full_width(setup, smi, store)
            log("[9] PPO training (train) at full width")
            ppo_card_vs_cpu(dev)
            train = train_full_width(setup, smi)
            ppo_update_reference_batch(dev, smi)
            run_exp_train_on_card()
            # the full-width perception state, frames and voxel maps of
            # phases 3-9 are not needed past here: free them for the
            # large preset's training state
            del setup, res, routes
            loop.pop("one_step")
            torch.cuda.empty_cache()
            log("[10] the captioner fine-tune (finetune_captioner)")
            finetune_card_vs_cpu(dev)
            ft = finetune_full_width(dev, smi)
            finetune_entry_point(store, ft["shapes"])
        log("[11] the learning self-checks (selfcheck_training, "
            "selfcheck_detector)")
        detector_card_vs_cpu(dev, smi)
        for preset in ("large", "base"):
            detector_step_full_width(dev, smi, preset)
        with tempfile.TemporaryDirectory(prefix="ecap_selfcheck_") as tmp:
            cap = captioner_selfcheck(dev, smi, tmp)
            det = detector_selfcheck(smi)
            free_running_on_trained_weights(K, cap, dev, smi)
    except Exception:
        traceback.print_exc()
        return 1
    # launches: over the timed rollout_fused windows, which run every kernel
    # but the two standalone decode attention kernels and the LayerNorm
    # backward; the first two's are from the perceive batch on the route of
    # separate calls (phase 3), the backward's from phase 10's fine-tune
    # steps.
    # launches_perceive: over the timed perceive batches of phase 3;
    # launches_generate: over the timed generate steps of phase 8;
    # launches_train: over phase 9's two timed train calls (unfused, then
    # fused); launches_finetune: over phase 10's FT_STEPS timed large-preset
    # train steps with remat off; launches_learning: over phase 11's two
    # self-checks at the tiny preset (11c and 11d), collection, training
    # and evaluation
    kernels = []
    for n, r in rows.items():
        if loop["counts"][n] > 0:
            launches, src = loop["counts"][n], "rollout_fused"
        elif route_counts[n] > 0:
            launches, src = route_counts[n], "perceive(decode_blocks=False)"
        else:
            launches, src = ft["plain"]["counts"][n], "finetune train_step"
        kernels.append(dict(
            name=n, route="cuda", launches=launches, launches_from=src,
            launches_perceive=perceive_counts.get(n, 0),
            launches_generate=gen["counts"][n],
            launches_train=(train["unfused"]["counts"][n]
                            + train["fused"]["counts"][n]),
            launches_finetune=ft["plain"]["counts"][n],
            launches_learning=cap["counts"][n] + det["counts"][n], **r))
    if any(k["launches"] <= 0 for k in kernels):
        print(f"chip_smoke: a kernel was never launched: {kernels}",
              file=sys.stderr)
        return 1
    log(f"profiler traces taken again for a lost launch (first kernel, "
        f"tries): {RETRACES or 'none'}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
