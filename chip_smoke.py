#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's perception path, fused exploration loop,
caption-generation modes, exploration entry point (`generate`), PPO
training entry point (`train`), captioner fine-tune
(`finetune_captioner`), learning self-checks (`selfcheck_training`,
`selfcheck_detector`), pseudo-labeler (`run_pseudolabeler`),
pseudo-captioner (`pseudocaption`), teacher-student detector pipeline
(`train_detector`), the query detector family (with
`export_serving_artifact`), the detector's serving evaluations
(`eval_artifact`, the self-check's serving flags), the BLIP-2, Florence
and consensus-LM families, the parallel layer, the replay path, the
real-checkpoint path (`port_checkpoint`, `evaluate_finetuned_model`), the
quantized serving opt-ins and render modes, and the four learning loops
(`selfcheck_loop`, `selfcheck_rl`, `selfcheck_cycle`,
`selfcheck_teacher_student`) on one NVIDIA GPU.

Phases, each of which must pass:
  1. build the hand-written Hopper kernels from the sources in the checkout;
  2. hold every kernel against its plain PyTorch version on the card at the
     shapes the main paths give it: max error, kernel / plain / library
     time, the kernel's and the library call's device time per call
     (torch.profiler over its timing loop), and the least time the card
     could take (bound); the warpgroup kernels' tensor-core and copy
     instructions counted in the built library (cuobjdump -sass: each of
     the 11 flash_wg and mlp_wg_kernel instances the wrappers dispatch to
     is there and issues wgmma and TMA loads through mbarriers, and no
     mma.sync; no cuobjdump fails the phase). Flash attention at head dims 32, 64, 128
     and T = 1, 16, 65, 257 (and 640 at D = 128, streamed through the K/V
     ring), causal and
     with valid_len < T, and at head dims 8 and 16 (the query detector's)
     at T = 1, 16, 64, 65, 257 the same ways, twice for equal bits, timed
     at the query decoder's shapes [16, 8, 64, 16] and [16, 8, 64, 32]; the decode MLP at 1, 16, 17 and 64 rows with int8
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
     and at the tiny preset's width, and at phase 14's 16 rows (the self
     block at caches of 62, positions 32, 33 and 61, and of 128, positions
     1 and 127; the cross block over 257 keys), each run twice for equal
     bits, with
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
     the card's rewards (rtol 1e-4, atol 1e-5); then the divisions by a
     constant (ROADMAP C.10) card against CPU bit for bit: the int8 cross
     K/V at the serving shape, both detectors' float input and the first
     FPN level the card computes from it, the separate preprocess ops, the
     box coder and the smooth-L1 loss;
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
     busy and idle share under the profiler); (c) `finetune_captioner`
     at the large preset on 4 env directories of the store phase 8 wrote
     (FT_STORE_ENVS): its JSON line and its pickle read back (run in
     phase 19's lanes);
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
     launches of the run; then LARGE_SELFCHECK_STEPS steps at the large
     preset on 64 crops:
     step_ms_median, hbm_peak_gb; (d) `selfcheck_detector --steps 700
     --episodes 4` at the tiny preset: map50_train > 0.4, mask_iou > 0.5
     on more than 5 matched detections (run in phase 19's lanes); (e) on the captioner (c) trained,
     free-running greedy decoding of the held-out crops through the
     kernels and through their plain versions, float and int8: equal
     tokens on at least 90% of rows, every sublayer on a fused kernel, and
     speculative decoding beside greedy;
 12. drive pseudo-labeling, pseudo-captioning and the teacher-student
     pipeline: (a) on the card against the CPU: `raytrace_pseudo_labels`
     on a map the CPU integrates (masks, slots, classes, validity equal);
     the flip merge of `forward_tta` on the same passes and `forward_mc`
     on handed keep masks at the tiny preset, and both on the committed
     detector artifact's trained weights over rendered frames (the share
     of detections matched, boxes and scores); two
     `TeacherStudent.training_step`s per head (ce, focal) at the tiny
     preset: the first loss and its parts within limits from the CPU's
     spread, and what each update did (elements moved alike, the decay
     applied, Adam's moments and count, the parameters within 2 lr a
     step), with a decay of 0.01 shown to be caught; (b) at full width
     on phase 8's store (the serving configuration of phase 3): one timed `predict` over
     LABEL_FRAMES frames with the kernels' launches, every consensus of
     `CONSENSUS_REGISTRY` through its labeler class (the semantic-map
     labelers' integrate and raytrace timed apart), the re-captioning of
     the raytraced instances, and `run_pseudolabeler` on SUBSET_ENVS envs
     of the store (run in phase 19's lanes);
     (c) `pseudocaption` with sbert and tfidf through the entry point and
     `_clip_consensus` on crops from the store; (d) `train_detector` at
     the large preset (default pipeline, soft consensus, focal head) for
     one round on SUBSET_ENVS envs of the store: labeling time, ms a
     step, peak memory; then one round each of the online, gt and swa
     pipelines at the tiny preset on a store written on the card; (e)
     `selfcheck_detector --tta` on a short run at the tiny preset (run in
     phase 19's lanes);
 13. drive the query (Mask2Former-class) detector family: (a) at QCFG
     (64^2, head dim 8) on the card against the CPU: every decoder point's
     logits, the set loss and every leaf's gradient within limits from the
     CPU's spread, one AdamW step held by what it did (`update_gaps`),
     the cost matrices (TF32 products caught), the Hungarian solver's
     matches on the card's costs all equal; (b) one timed `perceive` batch
     of phase 3's frames with the query detector at the large preset
     (1024^2, head dim 32): the launches, device busy and idle share, the
     detections matched against the twins' route; one timed training step
     at batch 4 (the host solver, the costs' copy and the wait for the
     device apart; peak memory); (c) the serving rung shortened:
     `selfcheck_detector --device-train --pack-masks --ckpt ... --tta
     --save` with the query family at 256^2 (head dim 16), a second call
     resuming from the checkpoint, `export_serving_artifact` on the card
     (its tree equal to the CPU export's), and `perceive` on the exported
     int8 detector; (d) `run_pseudolabeler` with a query detector, and
     `train_detector` refusing a query student without masks, as the JAX
     package's pipelines do;
 14. drive the detector's serving evaluations and the last three model
     families: (a) `eval_artifact` on the committed artifact on the card
     (its corpora rendered there: 8 / 2 / 2 scenes of 2 positions at
     1280^2, written to caches) and on the CPU from those caches (equal
     corpus shas, mAPs within 0.05), then `selfcheck_detector --eval-wide
     2 --eval-serving --calibrate --affine-finetune 20 --tta` at the tiny
     preset (every key present and finite; run in phase 19's lanes); (b) BLIP-2 at `Blip2Config()`
     (ViT-L/14 at 224^2, a 768-wide 6-layer Q-Former over 32 queries, a
     768-wide 12-layer LM) with random seeded weights on 16 crops of phase
     3's frames: flash at the Q-Former's [16, 12, 32, 64] against its twin
     (timed beside SDPA and the bound), greedy `generate` timed with its
     launches, device busy and idle share, its layout, and held
     teacher-forced against the twins (its step logits against the twins'
     decode of its tokens in bf16 ulps, a decode without the image prefix
     shown to be caught; the plain path's `lm_logits` over the decoded
     tokens; `lm_logits`, `itc_score`, `itm_score`, each with a control of
     other crops that must fail); (c) Florence at `FlorenceConfig()` (a
     cache of 128, cross-attention over 257 ViT tokens): `generate` in
     both tasks, on the route of separate calls and with int8 weights
     (int8 cross K/V), each timed and held teacher-forced against the
     twins (the kernel route's decode of its tokens against the twins' in
     ulps, a decode without BOS shown to be caught; `florence_logits`);
     (d)
     `ConsensusLM` at `LMConfig()`: scores card vs CPU, `choose` timed;
 15. drive the parallel layer under a world-1 NCCL process group: (a)
     `moe_mlp` at 8 experts, top-2, 768 x 3072, at decode rows [64, 1] and
     training rows [8, 77]: the card's bf16 expert products against
     float32 ones, twice for equal bits, the routing card vs CPU on the
     same probabilities; (b) the large preset's captioner with 8 experts
     a text block (int8, the gate float): greedy `generate` on 64 crops of
     phase 3's frames timed (launches: every text block on the self
     block, never on the decode MLP; device busy and idle share; peak
     memory) and held teacher-forced against the plain path with each
     path's own routing and with the kernel path's routing handed over
     (phase 3's gates); the gradients of one batch of 8 (the routed
     experts' non-zero, the others zero) and two timed `train_step`s;
     (c) `myppo` beside `goalexplorationbaseline-v0` at phase 9's
     configuration (fused, DDPPO_UPDATES updates): parameters equal bit
     for bit after each update, its resume state; `run_exp --trainer myppo --mode
     train` at tiny; the SIGTERM path at tiny; (d) `perceive_sharded`
     against `perceive` bit for bit, `pipeline_vit_features` and
     `vit_features_seqparallel` against `vit_features` at ViT-L, and
     expert-parallel `moe_mlp` against the plain call;
 16. the tensor-parallel captioner and the replay path: (a) under a
     world-1 NCCL group, the large preset's captioner with a (1, 1) mesh:
     `forward` and one `train_step` at batch 8 on phase 3's crops equal
     the mesh-less calls bit for bit; (b) two processes on the card in a
     gloo group (NCCL refuses two ranks on a device), the captioner cut
     over a (1, 2) mesh: the flash kernel at the local heads [8, 8, 257,
     64] against its twin, the TP `forward` held to (a)'s by
     `tests/test_tp.py`'s limits, one DP1 x TP2 `train_step` held to
     (a)'s by its loss and `update_gaps`, ms a call, peak memory, host
     copies and launches per rank; (c) `replay_exp --perceive --preset
     large` on phase 8's store against `Perceiver.process` on the same
     frames bit for bit, frames/s, and `Viz-v1`'s trajectory PNGs;
 17. the real-checkpoint path: (a) a coca_ViT-L-14-shaped state dict
     (vision 1024 x 24 at patch 14, 256 pooled queries, text 768 x 12,
     12 multimodal pairs, 49,408 ids) from the port's `build_torch_coca`
     with seeded N(0, 0.02) weights, and a merges table of 48,894
     distinct pairs, through `port_checkpoint coca` as a subprocess on
     the card (run in phase 19's lanes; (b) follows them): the inferred configuration (24 alternating self-only and
     cross-only multimodal blocks, BOS 49406, EOS 49407) and the replica
     on the card teacher-forced beside the port's captioner
     (teacher_forced_corr > 0.999); (b) `evaluate_finetuned_model
     --ported-dir` on 32 boxes over frames of phase 8's store in batches
     of 16: the CSV's rows and finite perplexities, the launches (24
     self-attention sublayers a step on the self block, 12 on the cross
     block, 36 MLPs on the decode MLP), peak memory, a batch's wall and
     device time, the copy launches of its float32 leaves beside weights
     cast once (equal tokens), and the batch held teacher-forced against
     the twins (phase 3's limits); (c) a MiniLM-L6-shaped BERT checkpoint
     in HF layout under `0.auto_model.` and a 30,522-token `vocab.txt`
     through `port_checkpoint sbert` in process: a unit-norm embedding,
     then the encoder's kernel route against the twins (embeddings,
     every LayerNorm call's float32 rows, flash at MiniLM's heads);
 18. the serving opt-ins, the render modes and the s2d stem: (a)
     `quantize.dense_w8a8` on the card against the CPU, bit for bit (the
     first 512 rows: rows are independent), at the decode step's [64,
     768] x [768, 768 / 3072 / 49,408] and the ViT's [64 * 257, 1024] x
     [1024, 4096], timed beside `dense` on the same int8 weights; (b-c)
     `perceive` on the serving tree and phase 3's frames with the default
     opt-ins, `w8a8=True` and `int8_kv=False`, in turns: ms a batch,
     device time, launches (under w8a8 the ViT's flash, the preprocess and
     the standalone decode attentions a sublayer a step, none of the
     fused decode kernels; bf16 K/V on the whole-block route), the w8a8
     detections against the default route's (reported), each route's
     decode teacher-forced against the twins on the same route (w8a8 to
     its quantization step: MAX_LOGPROB_ULPS_W8A8); (d) the serving
     tree's `quantization_ratio`; (e) every render mode at 16 envs x
     1280^2 x 96 boxes through `render_batch_chunked`, equal bits to
     "onehot" (culled at 160^2 tiles with K 48: overflow 0), and an
     overflowing K (4) that must differ, with ms a render; (f)
     `stem_s2d` on the served detector against the direct stem on the
     16 frames: with its int8 stem (reported) and with the stem's weights
     in float32 (boxes and valid flags equal);
 19. the entry points held by their output alone, each a subprocess on
     the card (COUNTED: its launches counted), in lanes side by side
     after every timed phase, so that no measured time shares the card
     with them: 10c, 11d, 12b, 12e, 14a's self-check and 17a above, and
     the four learning loops at the tiny preset with cut step counts
     (LOOP_ARGS, TS_SCENES, TS_STEPS, TS_THRESHOLD): `selfcheck_loop` (8
     envs), `selfcheck_rl`, `selfcheck_cycle`, and `selfcheck_detector
     --save` (the teacher) then `selfcheck_teacher_student`; each run held
     as its phase holds it, each loop's JSON line with the JAX script's
     keys (LOOP_KEYS) and finite values, and `selfcheck_loop`'s
     disagreement rewards not all zero; a tenth lane runs `caption_tools
     perplexity` at the large preset on CT_MAX_CROPS crops of phase 8's
     store (its JSON line and CSV, every perplexity finite and >= 1, the
     preprocess, flash, LayerNorm, both block and the decode MLP kernels
     launched); meanwhile this process runs BLIP-2 (`Blip2Config()`),
     Florence (`FlorenceConfig()`, the caption task) and the query
     `perceive` (13b's configuration) under `w8a8=True` on int8 trees of
     their seeded weights, a batch each with its launches (the standalone
     decode attentions, no block or decode-MLP kernel) and its int8 x int8
     products counted (at least one), each held by the default route on
     the same tree: its teacher-forced logits pick the W8A8 decode's token
     on W8A8_MIN_AGREE of the live steps (BLIP-2, Florence), or its
     detections are matched (QUERY_MIN_MATCHED), and W8A8's logits (the
     query family's scores) differ from the default route's; then 17b.

Float32 products and convolutions run without TF32 so the comparisons see
the kernels' own error. Prints the card's name and power limit, frames/s
lines, one JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when a
phase fails or no CUDA device is present.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --sass LIB   (instructions of the preprocess
                                           kernel in a built kernel
                                           library, by cuobjdump)
       python3 chip_smoke.py --rows ROOT NAME [NAME ...]
                                          (phase 2's rows NAME, of
                                           flash_attention, decode_mlp,
                                           decode_self_attention and
                                           by_kernel, through the kernels
                                           of the checkout at ROOT)
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
# Under W8A8 (phase 18b) every product quantizes its input per token: a
# last-bit difference in an activation can move its int8 level by one, a
# step of amax / 127, which the products after carry. So its decode is
# held to the quantization step, not to bf16 rounding: the same argmax
# agreement, the chosen log-prob within 8 bf16 ulps and 1.0 on average,
# the ViT embedding to a cosine of 0.999.
MAX_LOGPROB_ULPS_W8A8 = 8.0
MAX_MEAN_ULPS_W8A8 = 1.0
MIN_IMG_COSINE_W8A8 = 0.999
MIN_IMG_COSINE = 0.9999
# equal tokens go through the same sentence encoder (no ported kernel)
MIN_EMB_COSINE = 0.9999
# speculative decoding against greedy on the same crops: the first token
# comes from the verify pass (plain multi-token attention) in one and from
# the block kernels in the other, a teacher-forced comparison of one step
MIN_SPEC_FIRST_TOKEN = 0.8
BEAMS = 4
# the port's kernels, as the profiler names them
PORTED_KERNELS = ("flash_wg", "flash_head", "flash_stream",
                  "self_attn_tiled_kernel",
                  "cross_attn_kernel", "cross_attn_tiled_kernel",
                  "mlp_wg_kernel",
                  "self_qkv_kernel", "self_attn_kernel", "block_out_kernel",
                  "cross_q_kernel", "layernorm_kernel", "layernorm_vec_kernel",
                  "layernorm_bwd_regs", "layernorm_bwd_sum",
                  "layernorm_bwd_rows", "layernorm_bwd_cols",
                  "raycast_kernel", "preprocess_kernel")
# the decode MLP's kernel (decode_mlp.cu): two launches a call, fc and proj
MLP_KERNEL = "mlp_wg_kernel"
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
# every retaken trace is logged and counted in RETRACES. Where a reading
# needs only the device time per call (`device_us`) and no trace in
# TRACE_TRIES comes back whole, it is read from CUDA events instead
# (`event_device_us`), and logged and counted in EVENT_TIMED.
MARKER = "spin_kernel"
MARKER_CYCLES = 20_000
TRACE_TRIES = 8
RETRACES: list = []  # (first kernel, traces taken) where one was retaken
EVENT_TIMED: list = []  # (calls, us a call) read from events, not a trace
HEAD_START_CYCLES = 20_000_000  # ~10 ms of spin before an event-timed loop


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


def event_device_us(fn, calls: int) -> float:
    """Device time per call of `fn` from CUDA events around `calls` calls
    queued behind a spin of HEAD_START_CYCLES, so the host has enqueued
    them before the first starts and the card runs them back to back: the
    kernels' time and the gaps between them, not the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def device_us(fn, iters: int = 10) -> float:
    """Device busy time per call of `fn` (see device_profile); from CUDA
    events (`event_device_us`) where no trace came back whole."""
    try:
        return device_profile(fn, iters)[0]
    except AssertionError as e:
        us = event_device_us(fn, iters)
        EVENT_TIMED.append((iters, us))
        log(f"  ({e}: {us:.1f} us a call from CUDA events instead)")
        return us


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


def flash_checks(K, rn) -> dict:
    """Phase 2's flash attention row: the kernel against its plain version
    at every head dim and edge, then timed at the ViT-L shape [ROWS, 16,
    257, 64], at T = 640 and at the query decoder's shapes beside SDPA and
    the bound. `rn(*shape)` draws bf16 inputs on the card."""
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
    rows["flash_attention"]["cases"] += query_flash_cases(K, rn)

    return rows["flash_attention"]


def mlp_checks(K, QZ, rn, b: int) -> dict:
    """Phase 2's decode-MLP row: the kernel against its plain version at
    1, 16, 17 and b rows, int8 and bf16 weights, and at the tiny preset's
    width, each twice for equal bits; then timed at [b, 768] int8 beside
    two library matmuls and the bound."""
    rows = {}
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
    return rows["decode_mlp"]


def kernel_checks(K, QZ, dev) -> dict:
    """Kernel vs plain at the main path's shapes: FRAMES x SLOTS = ROWS
    crops; ViT-L attention [ROWS, 16, 257, 64]; decode batch ROWS, 12 heads
    of 64, self cache T=30, cross K=256 int8; MLP 768 -> 3072 -> 768 int8."""
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}

    sass = tensor_core_sass(K.build())
    check_wgmma_paths(sass)
    rows["flash_attention"] = flash_checks(K, rn)
    rows["flash_attention"]["sass"] = {
        fn: ops for fn, ops in sass.items() if "flash" in fn}

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

    rows["decode_mlp"] = mlp_checks(K, QZ, rn, b)
    rows["decode_mlp"]["sass"] = {
        fn: ops for fn, ops in sass.items() if "mlp" in fn}
    log_rows(rows)
    return rows


# the query detector's self-attention: 8 heads of fpn_dim / 8 over its 64
# queries, a perceive batch of FRAMES frames (head dim 16 at the serving
# rung's fpn_dim 128, 32 at the large preset's 256)
QUERY_HEADS = 8
QUERY_T = 64


def query_flash_cases(K, rn) -> list:
    """Flash attention at the head dims the query detector adds, 8 and 16
    (the tile zero-padded to the mma's k-extent of 16 at 8): against the
    plain version at T = 1, 16, 64, 65 and 257, causal and with valid_len
    < T, each run twice for equal bits; then timed at the query decoder's
    shapes [FRAMES, 8, 64, D] for D = 16 and 32 beside SDPA and the
    bound."""
    for d in (8, 16):
        for tt in (1, 16, QUERY_T, 65, 257):
            for causal, vl in ((False, None), (True, None),
                               (False, max(1, tt - 5)),
                               (True, max(1, tt - 5))):
                if tt == 1 and vl is not None:
                    continue
                qs, ks, vs = rn(2, 4, tt, d), rn(2, 4, tt, d), rn(2, 4, tt, d)
                n = vl or tt
                got = K.flash_attention(qs, ks, vs, causal, vl)[:, :, :n]
                check_close(f"flash_attention [2,4,{tt},{d}] causal={causal} "
                            f"valid_len={vl}", got,
                            K.flash_attention_plain(qs, ks, vs, causal,
                                                    vl)[:, :, :n], 2e-2)
                again = K.flash_attention(qs, ks, vs, causal, vl)[:, :, :n]
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_attention D={d} T={tt}: two "
                                         f"runs differ")
    cases = []
    for d in (16, 32):
        shape = (FRAMES, QUERY_HEADS, QUERY_T, d)
        q, k, v = rn(*shape), rn(*shape), rn(*shape)
        err = check_close(f"flash_attention {list(shape)} (query decoder)",
                          K.flash_attention(q, k, v),
                          K.flash_attention_plain(q, k, v), 2e-2)
        fb, ff = bound_ms(4 * nbytes(q), 4 * math.prod(shape) * QUERY_T)
        cases.append(dict(
            shape=list(shape), what="query decoder self-attention",
            replaces=TPU_KERNELS + "flash_attention.py:147", max_abs_err=err,
            **kernel_ms(lambda: K.flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: K.flash_attention_plain(q, k, v), 5, 1),
            bound_ms=fb, bound_by=ff,
            **library(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))))
        c = cases[-1]
        log(f"  flash_attention {list(shape)}: {c['device_us']:.2f} us on "
            f"the device ({c['ms'] * 1e3:.2f} us a call), SDPA "
            f"{c['library_device_us']:.2f} us, bound {fb * 1e3:.2f} us "
            f"({ff}), plain {c['plain_ms'] * 1e3:.1f} us")
    return cases


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
            # runs 16 rows, beam search 64), the tiny preset's width, and
            # phase 14's caches at its 16 crops: BLIP-2's LM (32 prefix
            # positions + 30, decoded from position 32) and Florence's
            # decoder (128 positions)
            for n, width, heads, tt, poses in (
                    (1, d, h, t, (0, 1, t - 1)), (17, d, h, t, (0, 1, t - 1)),
                    (4, 64, 2, 12, (0, 1, 11)),
                    (VLM_CROPS, d, h, 62, (32, 33, 61)),
                    (VLM_CROPS, d, h, 128, (1, 127))):
                g_n = 1.0 + rn(width, scale=0.1, dtype=torch.float32)
                b_n = rn(width, scale=0.1, dtype=torch.float32)
                xn = rn(n, width)
                for w8 in (True, False):
                    wn, _ = weights("qkvo", w8, width)
                    for pos in poses:
                        name = (f"decode_self_block "
                                f"{'int8' if w8 else 'bf16'} [{n},{width}] "
                                f"cache {tt} pos={pos}")
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
    # (2 heads of 32 over 16 keys), cross K/V too long for one block's
    # shared memory (tiles of keys) and Florence's 257 ViT tokens at phase
    # 14's 16 crops (no multiple of 4: the tiled kernel, ROADMAP B.19),
    # every weight and K/V type
    for n, width, heads, keys in ((1, d, h, nk), (17, d, h, nk),
                                  (4, 64, 2, 16), (4, d, h, 2048),
                                  (VLM_CROPS, d, h, 257)):
        g_n = 1.0 + rn(width, scale=0.1, dtype=torch.float32)
        b_n = rn(width, scale=0.1, dtype=torch.float32)
        xn = rn(n, width)
        for w8 in (True, False):
            wn, _ = weights("qo", w8, width)
            for kv8 in (True, False):
                kv, _ = cross_kv(n, heads, width, keys, kv8)
                name = (f"decode_cross_block {'int8' if w8 else 'bf16'} "
                        f"weights {'int8' if kv8 else 'bf16'} K/V "
                        f"[{n},{width}] {keys} keys")
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


# the kernels whose tensor-core and copy instructions phase 2 counts, and
# the opcodes: wgmma (HGMMA), mma.sync (HMMA), TMA loads (UTMALDG),
# mbarrier operations (SYNCS), cp.async (LDGSTS), ldmatrix (LDSM)
TENSOR_CORE_KERNELS = ("flash_wg", "flash_head", "flash_stream",
                       "mlp_wg_kernel")
TENSOR_CORE_OPCODES = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDGSTS",
                       "LDSM")
# every instance the wrappers dispatch to flash_wg (flash_plan's 0-5 at
# D = 64, 0 at 128) and to mlp_wg_kernel (int8 and bf16 weights, fc and
# proj), by their demangled names (flash_wg is in namespace wg)
WGMMA_INSTANCES = (
    *(f"wg::flash_wg<64, {n}>" for n in range(6)), "wg::flash_wg<128, 0>",
    *(f"mlp_wg_kernel<{w}, {fc}>" for w in ("signed char", "__nv_bfloat16")
      for fc in ("true", "false")))


def demangle(names: list) -> list:
    """C++ names by c++filt, the mangled ones where it is missing."""
    import shutil

    exe = shutil.which("c++filt")
    if not exe or not names:
        return names
    out = subprocess.run([exe], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def tensor_core_sass(lib: Path) -> dict:
    """{kernel instance: {opcode: count}} of TENSOR_CORE_OPCODES in each
    instance of TENSOR_CORE_KERNELS (cuobjdump -sass). Raises where the
    toolkit has no cuobjdump."""
    text = sass_text(lib)
    if not text:
        raise AssertionError("cuobjdump not found: the kernels' tensor-core "
                             "instructions cannot be read")
    found = {}
    for name in TENSOR_CORE_KERNELS:
        for fn, ins in sass_functions(text, name).items():
            ops = [o for _, o, _ in ins]
            found[fn] = {o: ops.count(o) for o in TENSOR_CORE_OPCODES}
    short = [re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", "")
                    ).removeprefix("void ")
             for n in demangle(list(found))]
    return dict(zip(short, found.values()))


def check_wgmma_paths(sass: dict) -> None:
    """Each instance of WGMMA_INSTANCES is in the library, issues wgmma fed
    by TMA through mbarriers, and no mma.sync."""
    for fn, ops in sass.items():
        log(f"  {fn} (cuobjdump -sass): {ops}")
    missing = [fn for fn in WGMMA_INSTANCES if fn not in sass]
    if missing:
        raise AssertionError(f"warpgroup kernel instances not found in the "
                             f"library: {missing} (found {list(sass)})")
    for fn in WGMMA_INSTANCES:
        ops = sass[fn]
        if not (ops["HGMMA"] and ops["UTMALDG"] and ops["SYNCS"]) or (
                ops["HMMA"]):
            raise AssertionError(f"{fn}: not a wgmma/TMA path: {ops}")


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
def teacher_forced(cp, crops, ccfg, K, tape=None, w8a8: bool = False,
                   int8_kv: bool = True) -> dict:
    """Greedy-decode `crops` through the kernels, then feed those tokens to
    the plain path step by step; compare the plain path's argmax and
    chosen-token log-probs with the kernel path's, and the ViT global
    embeddings of both. The log-prob difference is returned in bf16 ulps
    of the largest |logit| of its row. With a `RoutingTape`, the kernel
    path's MoE routing is recorded and handed to the plain path. `w8a8`
    and `int8_kv` (the serving opt-ins) go to both paths alike."""
    import contextlib

    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.models.common import KVCache
    from embodied_captioning_tpu_torch.models.vit import encode_image

    with tape.record() if tape else contextlib.nullcontext():
        tokens, lp_k, lengths = CAP.generate(cp, crops, ccfg, w8a8=w8a8,
                                             int8_kv=int8_kv)
    _, g_k = encode_image(cp["vision"], crops, ccfg.vision, w8a8=w8a8)
    t = ccfg.text
    b, L = tokens.shape
    with plain_kernels(K), (tape.replay() if tape
                            else contextlib.nullcontext()):
        pooled, g_p = encode_image(cp["vision"], crops, ccfg.vision,
                                   w8a8=w8a8)
        hd = t.width // t.heads
        tc = [KVCache.create(b, L, t.heads, hd, crops.device)
              for _ in range(t.layers)]
        mc = [KVCache.create(b, L, t.heads, hd, crops.device)
              for _ in range(t.cross_layers)]
        cross = CAP._cross_kvs(cp, pooled, t.heads, w8a8, int8_kv)
        agree = n = 0
        lp_err = lp_ulps = ulps_sum = 0.0
        for pos in range(L - 1):
            live = lengths > pos + 1
            if not bool(live.any()):
                break
            logits, tc, mc = CAP._decode_step(cp, tokens[:, pos].long(), pos,
                                              cross, tc, mc, ccfg, w8a8=w8a8)
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
                img_cos=img_cos.min().item(),
                flips=tape.flips if tape else 0,
                routed=tape.tokens if tape else 0)


def serving_perception(dev) -> tuple:
    """The serving configuration (bench.py's loop mode: the large preset,
    SLOTS caption slots a frame, FRAMES envs) and its weights: the
    committed detector artifact, a random captioner and sentence encoder
    from a generator seeded 0, int8. Returns (cfg, params, the artifact's
    detector config)."""
    from embodied_captioning_tpu_torch.config import (
        ExperimentConfig, apply_dotlist, merge)
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
    return cfg, params, det_cfg


def full_width_setup(dev) -> dict:
    """The serving configuration, its weights, the FRAMES seeded scenes
    (seeds 100.., as bench.py's loop mode) with their spawned agents, and
    BATCHES + 1 batches of frames rendered along the "explore" plan."""
    from embodied_captioning_tpu_torch.envs import device_loop as DL
    from embodied_captioning_tpu_torch.envs.sim import RaycastSim

    cfg, params, det_cfg = serving_perception(dev)
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


def divisions_card_vs_cpu(dev) -> None:
    """ROADMAP C.10: where the port divides by a constant it multiplies by
    the float32 reciprocal, as the jitted JAX package does and as PyTorch
    on the card does for a host number, so the card and the CPU give equal
    bits. Held here: the int8 cross K/V at the serving shape (16 crops x 12
    heads x 64 x 257); the rcnn and query detectors' float input on phase
    5's frames (at the detector's size, beside a frame of every byte
    value), read where each detector hands it to `backbone_fpn`, and the
    first FPN level the card computes from it against the one it computes
    from the CPU's input (the levels of the two devices are reported:
    their convolutions sum in other orders); the separate preprocess ops
    at an identity resize; the box coder; the smooth-L1 loss. Any
    difference raises."""
    import dataclasses

    from embodied_captioning_tpu_torch.config import ExperimentConfig
    from embodied_captioning_tpu_torch.models import detector as DET
    from embodied_captioning_tpu_torch.models.quantize import (
        QuantizedKV, quantize_kv)
    from embodied_captioning_tpu_torch.ops import image as IM

    compared = {}

    def same(what: str, want: torch.Tensor, got: torch.Tensor) -> None:
        want, got = want.detach().cpu(), got.detach().cpu()
        if (want.shape != got.shape or want.dtype != got.dtype
                or not torch.equal(want, got)):
            raise AssertionError(f"phase 5 divisions: {what}: the card's "
                                 f"bits are not the CPU's")
        compared[what] = want.numel()

    g = torch.Generator().manual_seed(22)
    kt = torch.randn(16, 12, 64, 257, generator=g).to(torch.bfloat16)
    v = torch.randn(16, 257, 12, 64, generator=g).to(torch.bfloat16)
    for name, a, b in zip(QuantizedKV._fields, quantize_kv(kt, v),
                          quantize_kv(kt.to(dev), v.to(dev))):
        same(f"quantize_kv {name}", a, b)

    det_cfg = ExperimentConfig.preset_config("tiny").detector
    size = det_cfg.image_size
    every_byte = torch.arange(256, dtype=torch.uint8).reshape(16, 16, 1)
    frames = torch.cat([
        synthetic_frames(2, size, 7, "cpu"),
        every_byte.repeat(size // 16 + 1, size // 16 + 1, 3)[None, :size,
                                                              :size]])
    fpn = DET.backbone_fpn
    worst = {}
    for family in ("rcnn", "query"):
        cfg = dataclasses.replace(det_cfg, family=family,
                                  score_threshold=0.0)
        params = DET.init_detector(torch.Generator().manual_seed(5), cfg,
                                   "cpu")
        seen = []

        def spy(p, images, c, *a, **k):
            out = fpn(p, images, c, *a, **k)
            seen.append((images, out[0]))
            return out

        DET.backbone_fpn = spy
        try:
            DET.forward(params, frames, cfg)
            p_dev = to_device(params, dev)
            DET.forward(p_dev, frames.to(dev), cfg)
        finally:
            DET.backbone_fpn = fpn
        (x_cpu, f_cpu), (x_card, f_card) = seen[0], seen[-1]
        same(f"{family} float input", x_cpu, x_card)
        same(f"{family} FPN level 0 from the CPU's input", f_card,
             fpn(p_dev, x_cpu.to(dev), cfg)[0])
        worst[family] = (f_card.float().cpu() - f_cpu.float()).abs().max()

    img = frames[0]  # one [H, W, 3] image takes the separate ops
    same("separate preprocess", IM.preprocess_for_vit(img, size, 8),
         IM.preprocess_for_vit(img.to(dev), size, 8))
    xy = torch.rand(64, 2, generator=g) * size * 0.6
    boxes = torch.cat([xy, xy + torch.rand(64, 2, generator=g) * size * 0.4
                       + 1], 1)
    deltas = torch.randn(4096, 4, generator=g)
    deltas[:, 2:] = 0  # exp(0) = 1 on both devices
    anchors = boxes.repeat(64, 1)
    same("box coder", DET.decode_boxes(anchors, deltas, size,
                                       DET.ROI_BOX_WEIGHTS),
         DET.decode_boxes(anchors.to(dev), deltas.to(dev), size,
                          DET.ROI_BOX_WEIGHTS))
    x = torch.randn(65536, generator=g) * 0.3
    same("smooth-L1", DET._smooth_l1(x), DET._smooth_l1(x.to(dev)))
    # controls on the card: the old spelling, a division by the host
    # number, is what the card computed before (so no number moves there),
    # and the CPU's division differs from it where the checks above must
    # see it
    u8 = torch.arange(256, dtype=torch.uint8)
    amax = kt.float().abs().amax(dim=2).clamp(min=1e-8)
    split = {}
    if dev.type == "cuda":
        same("control: to_float is the card's `/ 255.0`",
             u8.to(dev).float() / 255.0, IM.to_float(u8.to(dev)))
        same("control: the K scales are the card's `/ 127.0`",
             amax.to(dev) / 127.0,
             quantize_kv(kt.to(dev), v.to(dev)).kt_scale)
        split = {"/ 255.0": int((u8.float() / 255.0 != (
                     u8.to(dev).float() / 255.0).cpu()).sum()),
                 "/ 127.0": int((amax / 127.0 != (
                     amax.to(dev) / 127.0).cpu()).sum())}
        if not all(split.values()):
            raise AssertionError(f"phase 5 divisions: the old spelling no "
                                 f"longer differs, card vs CPU {split}")
    log(f"  divisions by a constant card vs CPU (C.10): equal bits at "
        f"{len(compared)} sites, {sum(compared.values())} values ("
        + ", ".join(f"{k} {n}" for k, n in compared.items())
        + "); FPN level 0 card vs CPU max abs diff "
        + ", ".join(f"{k} {float(w):.3e}" for k, w in worst.items())
        + "; the old spelling, card vs CPU, differed on "
        + ", ".join(f"{k} {n} of {256 if '255' in k else amax.numel()}"
                    for k, n in split.items()))


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
    # the decode MLP's two launches (fc, then proj: one kernel template)
    # and the two blocks' three launches run once per call each; a launch
    # started early by programmatic dependent launch counts from its
    # start, so a call's time is the union of its launches
    calls = block_calls(events)
    for name, first, parts, per_call in (
            ("decode_mlp", MLP_KERNEL, (MLP_KERNEL,), 2),
            ("decode_self_block", SELF_BLOCK_KERNELS[0], SELF_BLOCK_KERNELS,
             1),
            ("decode_cross_block", CROSS_BLOCK_KERNELS[0],
             CROSS_BLOCK_KERNELS, 1)):
        n = sum(e.count for e in ported if first in e.key) // per_call
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
# 10c: env dirs of phase 8's store the entry point reads (on the whole
# store, collecting its 183 pairs took 106 s of a 135 s run on an H100
# 80GB HBM3 at 700 W)
FT_STORE_ENVS = 4
FT_PICKLE = "captioner_finetuned.pkl"  # 10c's --save, in phase 19's lanes


def leaf_paths(tree, path: str = "") -> list:
    """Dotted names of a parameter tree's leaves in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_paths(tree[k], f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_paths(v, f"{path}[{i}]")]
    return [path]


def numpy_leaves(tree, path: str = "") -> list:
    """(dotted name, array) of a numpy tree's leaves, dicts in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in numpy_leaves(tree[k], f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in numpy_leaves(v, f"{path}[{i}]")]
    return [(path, np.asarray(tree))]


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


def finetune_entry_check(run: dict, save: str, shapes: list) -> dict:
    """10c: `finetune_captioner` at the large preset on FT_STORE_ENVS env
    directories of the store that phase 8's `generate` wrote (a run of
    phase 19's lanes), with its defaults (1 epoch, batch 8, lr 1e-4,
    triplet weight 0.1) and the repository's pseudo_captions.json ({}: the
    captions come from the store): its JSON line (pairs, steps = pairs //
    8, finite losses), the LayerNorm backward launched, and the pickle
    read back (numpy leaves of the init's shapes, all finite)."""
    from embodied_captioning_tpu_torch.params import load_pickle
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    line, counts = run["line"], run["launches"]
    size = os.path.getsize(save) if os.path.exists(save) else 0
    t0 = time.perf_counter()
    tree = tree_leaves(load_pickle(save)) if size else []
    dt_load = time.perf_counter() - t0
    log(f"  10c finetune_captioner on {FT_STORE_ENVS} envs of phase 8's "
        f"store: {line}; {run['seconds']:.1f} s in all; the pickle "
        f"{size / 2**30:.2f} GiB, read back in {dt_load:.1f} s; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    ok = (line.get("pairs", 0) > 0
          and line["steps"] == line["pairs"] // FT_BATCH
          and line["steps"] > 0
          and all(math.isfinite(line[k]) for k in ("first_loss",
                                                   "last_loss"))
          and line["saved"] == save
          and [tuple(x.shape) for x in tree] == shapes
          and all(isinstance(x, np.ndarray) and np.isfinite(x).all()
                  for x in tree)
          and counts.get("layernorm_bwd", 0) > 0)
    if not ok:
        raise AssertionError("finetune_captioner on the card failed")
    os.remove(save)
    return dict(line=line, seconds=run["seconds"], counts=counts)


# ---------------------------------------------------------------------------
# phase 11: the two learning self-checks (`selfcheck_training`,
# `selfcheck_detector`)
# ---------------------------------------------------------------------------

DET_HEADS = ("ce", "focal", "soft", "softfocal", "msefocal")
DET_STEP_BATCH = 8             # the detector self-check's default batch
DET_STEPS = 3                  # timed detector steps after a warm-up step
LARGE_SELFCHECK_STEPS = 8      # 11c: the large preset's timed self-check
DET_LR = 1e-3                  # the detector self-check's default lr
DET_SPREAD_DRAWS = 4           # 11a: moves of the CPU's parameters
SELF_CHECK_BAR = 0.8           # held-out sbert_cosine: the JAX script's bar
INT8_GAP = 0.01                # int8_sbert_cosine within this of it
DET_SELFCHECK_ARGS = ["--steps", "700", "--episodes", "4"]  # 11d
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
    return run_entry_text(main, argv)[:2]


def run_entry_text(main, argv: list) -> tuple:
    """`run_entry`, and the whole output: (return code, last line as JSON,
    output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log("    | " + line[:400])
    return rc, json.loads(text.strip().splitlines()[-1]), text


def captioner_selfcheck(dev, smi: str, tmp: str) -> dict:
    """11c: the captioner self-check whole, on the card, with the JAX
    script's defaults (tiny preset, 192 train crops asked for, 300 steps,
    batch 16) and --speculative: its JSON line, the bar held-out
    sbert_cosine > SELF_CHECK_BAR with int8_sbert_cosine within INT8_GAP of
    it (read with the port's own seeded captioner and sentence encoder),
    speculative decoding's exactness, and the launches of the whole run;
    then a timed run at the large preset (LARGE_SELFCHECK_STEPS steps on
    64 crops). Returns
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
    rc_l, large = run_entry(ST.main, [
        "--preset", "large", "--steps", str(LARGE_SELFCHECK_STEPS),
        "--train-crops", "64"])
    log(f"  captioner self-check, large preset, {LARGE_SELFCHECK_STEPS} "
        f"steps on "
        f"{large.get('train_crops')} crops, batch 16, on {smi}: "
        f"step_ms_median {large.get('step_ms_median')} ms, hbm_peak_gb "
        f"{large.get('hbm_peak_gb')} of {large.get('hbm_limit_gb')}, "
        f"{time.perf_counter() - t0:.1f} s in all")
    if rc_l != 0 or not math.isfinite(large.get("last_loss", math.nan)):
        raise AssertionError(f"large captioner self-check failed: {large}")
    torch.cuda.empty_cache()
    return dict(line=line, counts=counts, large=large,
                state=kept["state"], eval_cache=cache)


def detector_selfcheck_check(run: dict, smi: str) -> dict:
    """11d: `selfcheck_detector --steps 700 --episodes 4` at the tiny
    preset (a run of phase 19's lanes): its JSON line and the bars
    map50_train > MAP50_TRAIN_BAR, mask_iou > MASK_IOU_BAR with
    mask_matched > MASK_MATCHED_BAR."""
    line, counts = run["line"], run["launches"]
    log(f"  11d detector self-check (tiny, 700 steps, 4 episodes) on {smi}: "
        f"{run['seconds']:.1f} s; map50_train {line.get('map50_train')} "
        f"(bar > {MAP50_TRAIN_BAR}), mask_iou {line.get('mask_iou')} (bar > "
        f"{MASK_IOU_BAR}) on {line.get('mask_matched')} matched (bar > "
        f"{MASK_MATCHED_BAR}), map50 unseen scenes {line.get('map50_before')}"
        f" -> {line.get('map50_after')}; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    if (not line.get("map50_train", 0) > MAP50_TRAIN_BAR
            or not line.get("mask_iou", 0) > MASK_IOU_BAR
            or not line.get("mask_matched", 0) > MASK_MATCHED_BAR):
        raise AssertionError(f"detector self-check failed: {line}")
    return dict(line=line, counts=counts, seconds=run["seconds"])


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


# ---------------------------------------------------------------------------
# phase 12: pseudo-labeling, pseudo-captioning, the teacher-student pipeline
# ---------------------------------------------------------------------------

LABEL_PRESET = "large"         # 12b-d: the entry points' preset
# 12b: frames of phase 8's store labelled (8, 2 env dirs and
# FT_STORE_ENVS keep the whole script well inside its 1200 s; the gates
# do not depend on them)
LABEL_FRAMES = 8
LABEL_BATCH = 8                # run_pseudolabeler's default batch
SUBSET_ENVS = 2                # 12b's subprocess, 12d: env dirs of the store
CLIP_OBJECTS = 16              # 12c: objects scored by _clip_consensus
TS_LR = 1e-4                   # TeacherStudent's default step size
# 12a: (moved alike at least, |decay estimate| at most, moments at most)
# after the first and the second TeacherStudent step, card against CPU.
# Read on an H100 (PERF.md, PR 14): after one step 0.9918-0.9925 moved
# alike, decay within 1.1e-4, moments 1.14e-2-1.39e-2; after two
# 0.983-0.987, moments 4.0e-2-6.2e-2; a decay of 0.01 moved alike 0.557.
# test_torch_pipelines.py holds the CPU to the JAX package at (0.99, 2e-3,
# 0.02) and (0.95, -, 0.35); a reset state counts 1
TS_UPDATE = ((0.97, 2e-3, 0.05), (0.95, None, 0.35))
TTA_STEPS = 40                 # 12e: training steps of the short run
MC_SAMPLES = 3                 # 12a: forward_mc's stochastic passes
# 12a: the MC statistics' limit, test_torch_pseudolabel.py's against the
# JAX package (bf16 box-head outputs an ulp apart, doubled by dropout)
MC_ATOL = 3e-3
TRAINED_FRAMES = 16            # 12a: frames for the trained detector
# 12a: the trained detector card against CPU on these frames, read on an
# H100 (PERF.md, PR 14): `forward` matched 45 of 48 detections (a score
# of 0.502 at the 0.5 threshold), boxes within 5 px (the detector's boxes
# are bf16, ROADMAP C.6: one ulp is a pixel at 128-255), scores within
# 5.3e-3; `forward_tta` matched 47 of 51 (0.92), 3 boxes 5-11 px off and
# 2 scores 0.07 off (the merge kept the other pass's copy of an object).
# The shares are gated: matched, and of those within TTA_BOX_PX and
# TTA_SCORE_ATOL
TTA_AGREE, TTA_CLOSE = 0.85, 0.85
TTA_BOX_PX, TTA_SCORE_ATOL = 2.0, 5e-3
# `forward_mc`: 936 of 2048 proposals at the same index (0.457: trained
# objectness reorders near-equal proposals), mean and std within 9.9e-3
# and 1.4e-2 there (sharp trained logits: a bf16 ulp of a logit near 10
# is 0.06)
MC_TRAINED_ROWS, MC_TRAINED_ATOL = 0.3, 0.03


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _tiny_map_frames(cfg, n: int, seed: int):
    """Depth, pose and ground-truth detections of the port's simulator on
    the CPU along a short walk, with seeded logits and embeddings."""
    from embodied_captioning_tpu_torch.envs.sim import RaycastSim

    sim = RaycastSim(cfg.sim, cfg.sensors, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    out = []
    for a in (2, 2, 1, 3, 2, 1, 2, 3)[:n]:
        sim.step(a)
        obs = sim.observe()
        det = sim.gt_detections(obs, max_instances=12)
        m = det.valid.shape[0]
        out.append(dict(
            depth=obs["depth"],
            pose=torch.from_numpy(sim.agent.camera_matrix()).float(),
            masks=det.masks.float(), classes=det.classes,
            logits=torch.randn(m, cfg.map.num_classes, generator=g),
            embeddings=torch.randn(m, cfg.map.embed_dim, generator=g),
            valid=det.valid))
    return out, sim.bounds()[0]


def raytrace_card_vs_cpu(dev) -> str:
    """12a: `raytrace_pseudo_labels` on a map the CPU integrates from six
    frames, the same map on the card: masks, slots, classes and validity
    equal; logits within 1e-5 relative (exp and log on the card)."""
    import dataclasses

    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.mapping import voxel_map as V

    cfg = load_config("tiny", overrides=["sensors.height=64",
                                         "sensors.width=64"])
    bad, n_valid, worst = [], 0, 0.0
    for solution in ("max", "bayesian"):
        mcfg = dataclasses.replace(cfg.map, grid=(64, 16, 64),
                                   voxel_size=0.2, max_views_per_object=3,
                                   solution=solution)
        cfg = dataclasses.replace(cfg, map=mcfg)
        frames, lower = _tiny_map_frames(cfg, 6, 15)
        st = V.create(mcfg, lower, device="cpu")
        for f in frames:
            V.integrate_frame(st, f["depth"], f["pose"], f["masks"],
                              f["classes"], f["logits"], f["embeddings"],
                              f["valid"], mcfg,
                              hfov_deg=cfg.sensors.hfov_deg)
        card = to_device(st, dev)
        for f in frames:
            kw = dict(hfov_deg=cfg.sensors.hfov_deg, max_objects_out=12,
                      min_pixels=20)
            want = V.raytrace_pseudo_labels(st, f["depth"], f["pose"], mcfg,
                                            **kw)
            got = V.raytrace_pseudo_labels(card, f["depth"].to(dev),
                                           f["pose"].to(dev), mcfg, **kw)
            for name, a, b in zip(("masks", "slots", "classes", "logits",
                                   "valid"), got, want):
                a = a.cpu()
                if name == "logits":
                    err = ((a - b).abs() / b.abs().clamp(min=1e-6)).max()
                    worst = max(worst, err.item())
                    if not err.item() <= 1e-5:
                        bad.append((solution, name, err.item()))
                elif not torch.equal(a, b):
                    bad.append((solution, name))
            n_valid += int(want[4].sum())
    if bad or n_valid == 0:
        raise AssertionError(f"raytrace card vs CPU: {bad[:6]} ({n_valid} "
                             f"valid objects)")
    return (f"raytrace: masks, slots, classes, validity equal on "
            f"{n_valid} objects of 12 frames (max, bayesian), logits "
            f"{worst:.2e} relative")


def trained_frames(n: int, dev) -> torch.Tensor:
    """n frames at the detector artifact's 256^2 input, rendered by the
    port's simulator on `dev` in the large preset's scenes (seeds 100..,
    as bench.py's loop mode), each after two steps of a walk."""
    from embodied_captioning_tpu_torch.config import (
        ExperimentConfig, apply_dotlist)
    from embodied_captioning_tpu_torch.envs.sim import RaycastSim

    cfg = apply_dotlist(ExperimentConfig.preset_config("large"),
                        ["sensors.height=256", "sensors.width=256"])
    out = []
    for i in range(n):
        sim = RaycastSim(cfg.sim, cfg.sensors, seed=100 + i, device=dev)
        for a in (2, 1):
            sim.step(a)
        out.append(torch.as_tensor(sim.observe()["rgb"], device=dev))
    return torch.stack(out)


def mc_card_vs_cpu(p, pc, imgs, x, cfg, min_rows: float, atol: float,
                   what: str) -> str:
    """`forward_mc` with the same handed keep masks on the card (`pc`, `x`)
    and on the CPU (`p`, `imgs`): the proposals equal, index by index, on
    at least `min_rows` of the valid ones, and the MC mean and std there
    within `atol` (the masks are indexed by proposal, so a proposal that
    moved to another index draws other masks)."""
    from embodied_captioning_tpu_torch.models import detector as DET

    keep = torch.rand((MC_SAMPLES, imgs.shape[0], cfg.num_proposals, 1024),
                      generator=torch.Generator().manual_seed(2)) < 0.5
    ref = DET.forward_mc(p, imgs, cfg, MC_SAMPLES, dropout_keep=keep)
    mc = [t.cpu() for t in DET.forward_mc(pc, x, cfg, MC_SAMPLES,
                                          dropout_keep=keep.to(x.device))]
    rows = ref[1] & mc[1] & (ref[0] == mc[0]).all(-1)
    errs = [(mc[i] - ref[i]).abs()[rows].max().item() if rows.any() else
            math.inf for i in (2, 3)]
    n, valid = int(rows.sum()), int(ref[1].sum())
    if not (n >= min_rows * valid and valid > 0 and max(errs) <= atol):
        raise AssertionError(f"forward_mc card vs CPU ({what}): {errs} on "
                             f"{n} of {valid} valid proposals")
    return (f"forward_mc ({what}, {MC_SAMPLES} passes, handed masks): {n} of "
            f"{valid} valid proposals equal (limit {min_rows}), mean "
            f"{errs[0]:.2e}, std {errs[1]:.2e} (limit {atol})")


def detector_variants_card_vs_cpu(dev) -> str:
    """12a: the detector's inference variants on the card against the CPU.
    At the tiny preset with random weights: the flip merge on the same
    passes (the card's two `forward` passes merged on the card by
    `forward_tta` and on the CPU by `merge_flipped`: equal; a random
    detector's own passes part ways at bf16 near-ties, ROADMAP C.7) and
    `forward_mc`. On the committed artifact's trained weights (int8,
    256^2) and TRAINED_FRAMES rendered frames: `forward_tta`'s detections
    matched slot by slot (valid on both sides, the same class) on at least
    TTA_AGREE of those valid on either, and at least TTA_CLOSE of the
    matched ones within TTA_BOX_PX and TTA_SCORE_ATOL; `forward_mc`."""
    import dataclasses

    from embodied_captioning_tpu_torch.config import DetectorConfig
    from embodied_captioning_tpu_torch.models import detector as DET
    from embodied_captioning_tpu_torch.params import load_detector_artifact

    cfg = dataclasses.replace(DetectorConfig.tiny(), score_threshold=0.01)
    # seed 4: 23 valid proposals and 16 merged detections on these frames
    # (seeds 0-11 give 0-23; random weights rarely propose boxes wider than
    # a pixel)
    p = DET.init_detector(torch.Generator().manual_seed(4), cfg, "cpu")
    pd = to_device(p, dev)
    imgs = synthetic_frames(2, cfg.image_size, 11, "cpu")
    x = imgs.to(dev)
    passes = [DET.forward(pd, x, cfg),
              DET.forward(pd, torch.flip(x, dims=[2]), cfg)]
    got = DET.forward_tta(pd, x, cfg).to("cpu")
    want = DET.merge_flipped(*(d.to("cpu") for d in passes), cfg)
    diff = [f for f in ("boxes", "classes", "scores", "logits", "valid",
                        "masks") if not torch.equal(getattr(got, f),
                                                    getattr(want, f))]
    if diff or int(want.valid.sum()) == 0:
        raise AssertionError(f"forward_tta card vs CPU merge: {diff}, "
                             f"{int(want.valid.sum())} valid")
    lines = [f"forward_tta (tiny, random weights): the card's merge of its "
             f"two passes equals the CPU's on every field "
             f"({int(want.valid.sum())} detections)",
             mc_card_vs_cpu(p, pd, imgs, x, cfg, 0.5, MC_ATOL,
                            "tiny, random weights")]

    path = REPO / "embodied_captioning_tpu/models/data/det_serving_256.pkl"
    p, dcfg = load_detector_artifact(str(path), "cpu")
    tcfg = DetectorConfig(**dcfg)
    pc = to_device(p, dev)
    x = trained_frames(TRAINED_FRAMES, dev)
    imgs = x.cpu()
    for fn in (DET.forward, DET.forward_tta):
        card = fn(pc, x, tcfg).to("cpu")
        ref = fn(p, imgs, tcfg)
        either = int((card.valid | ref.valid).sum())
        both = card.valid & ref.valid & (card.classes == ref.classes)
        box = (card.boxes.float() - ref.boxes.float()).abs().amax(-1)[both]
        score = (card.scores.float() - ref.scores.float()).abs()[both]
        close = int(((box <= TTA_BOX_PX) & (score <= TTA_SCORE_ATOL)).sum())
        matched = int(both.sum())
        agree = matched / max(either, 1)
        lines.append(
            f"{fn.__name__} (trained artifact, {TRAINED_FRAMES} frames): "
            f"{matched} of {either} detections matched ({agree:.3f}), "
            f"{close} of them within {TTA_BOX_PX} px and {TTA_SCORE_ATOL} "
            f"in score (the farthest {box.max().item():.2f} px, "
            f"{score.max().item():.2e})" if matched else "no match")
    # gated: the TTA (the plain pass above for comparison)
    if not (agree >= TTA_AGREE and close >= TTA_CLOSE * matched > 0):
        raise AssertionError(f"forward_tta card vs CPU: {lines[-1]} "
                             f"(limits {TTA_AGREE}, {TTA_CLOSE})")
    lines.append(mc_card_vs_cpu(p, pc, imgs, x, tcfg, MC_TRAINED_ROWS,
                                MC_TRAINED_ATOL, "trained artifact"))
    return "; ".join(lines)


def labelled_batch(n: int = 2, size: int = 48, seed: int = 0) -> dict:
    """The JAX package's pipeline tests' synthetic labelled batch."""
    from embodied_captioning_tpu_torch.config import NUM_CLASSES

    rng = np.random.default_rng(seed)
    return {
        "image": (rng.random((n, size, size, 3)) * 255).astype(np.uint8),
        "boxes": np.tile(np.array([[4, 4, 20, 20], [26, 26, 44, 44],
                                   [0, 0, 0, 0], [0, 0, 0, 0]], np.float32),
                         (n, 1, 1)),
        "classes": np.tile(np.array([1, 3, 0, 0], np.int32), (n, 1)),
        "logits": np.tile(np.eye(NUM_CLASSES, dtype=np.float32)[[1, 3, 0, 0]],
                          (n, 1, 1)),
        "valid": np.tile(np.array([True, True, False, False]), (n, 1)),
        "object_ids": np.tile(np.array([5, 6, -1, -1]), (n, 1)),
        "episode": np.zeros(n, np.int64),
        "step": np.arange(n),
    }


def teacher_student_card_vs_cpu(dev) -> str:
    """12a: two `TeacherStudent.training_step`s per head (ce, focal) at the
    tiny preset on the card and on the CPU, same student and batches: the
    first step's loss and its parts within the larger of 1e-4 of their
    value and 3x their CPU spread (DET_SPREAD_DRAWS moves of the weights
    by 1e-4 of themselves, as 11a); after each step, what the update did
    (`train/optim.update_gaps`, `relative_gap`): the share of elements
    moved alike, the decay applied beyond the CPU's and Adam's moments
    within TS_UPDATE's limits, the step counts equal, and every parameter
    within 2 lr a step."""
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.train.optim import (
        relative_gap, tree_leaves, tree_map, update_gaps)
    from embodied_captioning_tpu_torch.train import pipelines as TP
    from embodied_captioning_tpu_torch.train.pipelines import TeacherStudent

    cfg = load_config("tiny")
    student = init_detector(torch.Generator().manual_seed(0), cfg.detector,
                            "cpu")
    before = [x.numpy() for x in tree_leaves(student)]
    batches = [labelled_batch(), labelled_batch(seed=1)]

    def steps(params, where, head, n=2):
        ts = TeacherStudent(cfg, consensus="vanilla", head=head,
                            student_params=to_device(params, where),
                            device=where)
        out = []
        for batch in batches[:n]:
            parts = ts.training_step(batch)
            st = ts.opt_state
            out.append((parts, st.count, *([x.cpu().numpy() for x in
                                            tree_leaves(t)] for t in
                                           (ts.student, st.mu, st.nu))))
        return out

    def update_faults(card, ref):
        """(what each step did, the steps past TS_UPDATE's limits)."""
        read, bad = [], []
        for i, ((_, c, p, mu, nu), (_, rc, rp, rmu, rnu)) in enumerate(
                zip(card, ref)):
            agree_lim, decay_lim, mom_lim = TS_UPDATE[i]
            gaps = update_gaps(before, p, rp, TS_LR)
            mom = max(relative_gap(mu, rmu), relative_gap(nu, rnu))
            ratio = max(np.abs(a - b).max() / (2 * (i + 1) * TS_LR + 1e-7)
                        for a, b in zip(p, rp))
            read.append(f"step {i + 1}: moved alike {gaps['agree']:.5f}, "
                        f"decay {gaps['decay']:+.2e}, moments {mom:.2e}, "
                        f"parameters {ratio:.4f} of {2 * (i + 1)} lr")
            if not (c == rc == i + 1 and gaps["agree"] >= agree_lim
                    and (decay_lim is None
                         or abs(gaps["decay"]) <= decay_lim)
                    and mom <= mom_lim and ratio <= 1.0):
                bad.append((i + 1, c, rc, gaps, mom, ratio))
        return read, bad

    lines, bad = [], []
    for head in ("ce", "focal"):
        ref = steps(student, "cpu", head)
        want = ref[0][0]
        spread = {k: 0.0 for k in want}
        for seed in range(1, DET_SPREAD_DRAWS + 1):
            gen = torch.Generator().manual_seed(seed)
            moved = tree_map(lambda x: x * (1 + 1e-4 * torch.randn(
                x.shape, generator=gen)), student)
            pm = steps(moved, "cpu", head, n=1)[0][0]
            spread = {k: max(v, abs(pm[k] - want[k]))
                      for k, v in spread.items()}
        card = steps(student, dev, head)
        got = card[0][0]
        worst = {}
        for k in want:
            lim = max(1e-4 * abs(want[k]), 3 * spread[k])
            worst[k] = abs(got[k] - want[k]) / max(lim, 1e-30)
            if not worst[k] <= 1.0:
                bad.append((head, k, got[k], want[k], lim))
        read, faults = update_faults(card, ref)
        bad += [(head, f) for f in faults]
        k = max(worst, key=worst.get)
        lines.append(f"{head}: loss card {got['loss']:.5f} CPU "
                     f"{want['loss']:.5f}, worst part {k} {worst[k]:.3f} of "
                     f"its limit; " + "; ".join(read))
    # the same checks catch the captioner's decay (0.01) on the card
    # (`ref`: the CPU's focal steps)
    wd, TP.WEIGHT_DECAY = TP.WEIGHT_DECAY, 0.01
    try:
        _, caught = update_faults(steps(student, dev, "focal"), ref)
    finally:
        TP.WEIGHT_DECAY = wd
    if bad or not caught:
        raise AssertionError(f"TeacherStudent card vs CPU: {bad}; a decay "
                             f"of 0.01 caught: {caught}")
    return ("TeacherStudent.training_step: " + "; ".join(lines)
            + f"; a decay of 0.01 on the card caught by {caught[0]}")


def labeling_card_vs_cpu(dev, smi: str) -> None:
    """12a, at the tiny preset: the raytrace, the detector's inference
    variants and the teacher-student step on the card against the CPU."""
    for line in (raytrace_card_vs_cpu(dev), detector_variants_card_vs_cpu(dev),
                 teacher_student_card_vs_cpu(dev)):
        log(f"  {line} ({smi})")


def subset_store(store: str, root: str, envs: int) -> str:
    """A store of the first `envs` env directories of `store` (its files
    linked, since the store's loader does not follow linked
    directories)."""
    out = os.path.join(root, f"subset_{envs}")
    if os.path.exists(out):
        return out
    for name in sorted(os.listdir(store))[:envs]:
        os.makedirs(os.path.join(out, name), exist_ok=True)
        for f in os.listdir(os.path.join(store, name)):
            os.symlink(os.path.join(store, name, f),
                       os.path.join(out, name, f))
    return out


def _label_copies(preds: list) -> list:
    """The predictions with their own class and logit arrays (the host
    consensus stages relabel in place)."""
    import dataclasses

    return [dataclasses.replace(p, classes=p.classes.copy(),
                                logits=p.logits.copy()) for p in preds]


def pseudolabel_full_width(store: str, tmp: str, dev, smi: str) -> dict:
    """12b: the labelers at full width on phase 8's store (the serving
    configuration of phase 3: the detector artifact, 1280^2 frames, 16
    detections a frame): one timed `predict` over LABEL_FRAMES frames (the
    semantic-map captioner's, which keeps the captions too) with the
    kernels' launches, then every consensus of CONSENSUS_REGISTRY through
    its labeler class on copies of those predictions (the semantic-map
    labelers' integrate and raytrace timed apart), the re-captioning of
    the raytraced instances (`run_pseudolabeler` on SUBSET_ENVS envs of
    the store runs in phase 19's lanes: `pseudolabel_cli_check`)."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.labeling.datasets import (
        EpisodeDetectionDataset)
    from embodied_captioning_tpu_torch.labeling.pseudolabeler import (
        CONSENSUS_REGISTRY)
    from embodied_captioning_tpu_torch.perception import Perceiver

    cfg, params, _ = serving_perception(dev)
    per = Perceiver(cfg, params=params, device=dev)
    ds = EpisodeDetectionDataset(store, label_modality="bbs",
                                 with_depth_pose=True)
    total = len(ds)
    ds.index = ds.index[:LABEL_FRAMES]
    cap = CONSENSUS_REGISTRY["semantic_map_captioner"](cfg, perceiver=per)
    cap.predict(_one_batch(ds), LABEL_BATCH)   # warm-up
    process, perceive_s = per.process, []

    def timed_process(images):
        sync(dev)
        t = time.perf_counter()
        out = process(images)
        sync(dev)
        perceive_s.append(time.perf_counter() - t)
        return out

    per.process = timed_process
    sync(dev)
    K.reset_launches()
    t0 = time.perf_counter()
    preds = cap.predict(ds, LABEL_BATCH)
    sync(dev)
    predict_s = time.perf_counter() - t0
    per.process = process
    counts = dict(K.launches)
    n_det = int(sum(p.valid.sum() for p in preds))
    log(f"  predict (the semantic-map captioner's) over {len(preds)} of "
        f"{total} frames at {cfg.sensors.height}^2, batch {LABEL_BATCH}, on "
        f"{smi}: {predict_s:.2f} s, {predict_s / len(preds) * 1e3:.1f} ms a "
        f"frame, of which `perceive` {sum(perceive_s) / len(preds) * 1e3:.1f}"
        f" (the rest: the store's loads, the host copies and id matching, "
        f"the captions' decoding); {n_det} detections, {len(cap.captions)} "
        f"objects with captions; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    labeling_kernels = ("fused_preprocess", "flash_attention", "layernorm",
                        "decode_self_block", "decode_cross_block",
                        "decode_mlp")
    on_card = torch.device(dev).type == "cuda"
    if len(preds) != LABEL_FRAMES or on_card and any(
            counts[k] <= 0 for k in labeling_kernels):
        raise AssertionError(f"predict: {len(preds)} frames, {counts}")
    rows = {}
    for name, cls in CONSENSUS_REGISTRY.items():
        labeler = cls(cfg, perceiver=per)
        spans = {}
        if hasattr(labeler, "accumulate"):
            accumulate = labeler.accumulate

            def timed(ps, accumulate=accumulate, spans=spans):
                t = time.perf_counter()
                accumulate(ps)
                sync(dev)
                spans["integrate"] = time.perf_counter() - t

            labeler.accumulate = timed
        copies = _label_copies(preds)
        sync(dev)
        t0 = time.perf_counter()
        out = labeler.get_pseudo_labels(copies)
        sync(dev)
        dt = time.perf_counter() - t0
        inst = int(sum(p.valid.sum() for p in out))
        ok = len(out) == len(preds) and all(
            np.isfinite(p.logits).all() and p.boxes.shape[-1] == 4
            and (p.object_ids[p.valid] >= 0).all() for p in out)
        row = dict(frames=len(out), instances=inst, seconds=dt,
                   ms_per_frame=dt / len(out) * 1e3)
        if spans:
            row["integrate_ms_per_frame"] = spans["integrate"] / len(out) * 1e3
            row["raytrace_ms_per_frame"] = (dt - spans["integrate"]) / len(
                out) * 1e3
        if name == "semantic_map_captioner":
            t0 = time.perf_counter()
            caps = labeler.recaption(out)
            sync(dev)
            row["recaption_s"] = time.perf_counter() - t0
            row["recaptioned"] = len(caps)
            ok = ok and len(caps) == len({(p.episode, int(i)) for p in out
                                          for i in p.object_ids[p.valid]})
            ok = ok and all(isinstance(c, str) for c in caps.values())
        if name == "vanilla":
            paths = labeler.save_pseudo_labels(out, os.path.join(tmp, "pl"))
            ok = ok and len(paths) == len(out)
        rows[name] = row
        log(f"  consensus {name}: {inst} instances over {len(out)} frames, "
            f"{dt:.3f} s ({row['ms_per_frame']:.1f} ms a frame)"
            + (f"; integrate {row['integrate_ms_per_frame']:.1f} ms a frame,"
               f" raytrace {row['raytrace_ms_per_frame']:.1f}"
               if spans else "")
            + (f"; recaption {row['recaptioned']} instances in "
               f"{row['recaption_s']:.2f} s" if "recaption_s" in row else ""))
        if not ok:
            raise AssertionError(f"consensus {name} failed: {row}")
    return dict(counts=counts, predict_s=predict_s, frames=len(preds),
                rows=rows, per=per, cfg=cfg)


def pseudolabel_cli_check(run: dict) -> None:
    """12b's `run_pseudolabeler` on SUBSET_ENVS envs of the store (a run
    of phase 19's lanes): its JSON line, a file for every frame."""
    line = run["line"]
    log(f"  12b run_pseudolabeler ({LABEL_PRESET} preset, {SUBSET_ENVS} envs "
        f"of the store) in {run['seconds']:.1f} s: {line}")
    if set(line) != {"frames", "instances", "files", "out"} or \
            line["files"] != line["frames"] or line["frames"] <= 0:
        raise AssertionError(f"run_pseudolabeler failed: {line}")


def _one_batch(ds):
    """A dataset of the first LABEL_BATCH frames of `ds` (a warm-up)."""
    import copy

    first = copy.copy(ds)
    first.index = ds.index[:LABEL_BATCH]
    return first


def pseudocaption_full_width(store: str, tmp: str, lab: dict, dev,
                             smi: str) -> dict:
    """12c: `pseudocaption` at the large preset on phase 8's store, sbert
    and tfidf through the entry point; then `_clip_consensus` (the
    captioner's contrastive heads, `captioner.forward`) called directly on
    crops of the CLIP_OBJECTS objects with the most captions (the entry
    point hands no crops), each crop its first view's box expanded by 0.2,
    on the card."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch import pseudocaption as PC
    from embodied_captioning_tpu_torch.labeling.pseudocaptioner import (
        PseudoCaptioner, filter_banned, group_captions, records_from_store)
    from embodied_captioning_tpu_torch.ops.detections import expand_boxes
    from embodied_captioning_tpu_torch.ops.image import crop_and_resize
    from embodied_captioning_tpu_torch.utils.obs_store import SampleLoader

    out = {}
    for method in ("sbert", "tfidf"):
        t0 = time.perf_counter()
        rc, line = run_entry(PC.main, [store, "--method", method, "--out",
                                       os.path.join(tmp, f"pc_{method}.json"),
                                       "--preset", LABEL_PRESET, "--device",
                                       str(dev)])
        dt = time.perf_counter() - t0
        log(f"  pseudocaption --method {method} ({LABEL_PRESET} preset) on "
            f"{smi}: "
            f"{line} in {dt:.2f} s, {line.get('objects', 0) / dt:.1f} "
            f"objects/s")
        if rc != 0 or set(line) != {"objects", "method", "out"}:
            raise AssertionError(f"pseudocaption {method} failed: {line}")
        out[method] = dict(line=line, seconds=dt)
    records = records_from_store(store)
    groups = {k: filter_banned(v) for k, v in group_captions(records).items()}
    # the objects with the most captions first
    keys = sorted((k for k in groups if groups[k]),
                  key=lambda k: (-len(groups[k]), k))[:CLIP_OBJECTS]
    loader = SampleLoader(store)
    crops = {}
    size = lab["cfg"].captioner.vision.image_size
    for key in keys:
        ep, oid = key
        step = next(r["step"] for r in records
                    if (r["episode"], r["object_id"]) == key)
        cam = loader.camera_of(ep, "bbs")
        bbs = loader.get_sample(ep, cam, "bbs", step).data
        slot = int(np.nonzero(np.asarray(bbs["object_ids"]) == oid)[0][0])
        rgb = loader.get_sample(ep, loader.camera_of(ep, "rgb"), "rgb",
                                step).data
        box = torch.tensor(np.asarray(bbs["boxes"], np.float32)[slot:slot + 1],
                           device=dev)
        h, w = rgb.shape[:2]
        crops[key] = crop_and_resize(
            torch.as_tensor(rgb, device=dev).float(),
            expand_boxes(box, 0.2, h, w), size)[0].to(torch.uint8
                                                     ).cpu().numpy()
    pc = PseudoCaptioner(lab["cfg"], perceiver=lab["per"], method="clip",
                         device=dev)
    sync(dev)
    K.reset_launches()
    t0 = time.perf_counter()
    chosen = {k: pc._clip_consensus(groups[k], crops[k]) for k in keys}
    sync(dev)
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in K.launches.items() if v}
    log(f"  _clip_consensus on {len(keys)} objects' crops ({size}^2, "
        f"{sum(len(groups[k]) for k in keys)} captions) on {smi}: "
        f"{dt:.2f} s, {len(keys) / max(dt, 1e-9):.1f} objects/s; launches "
        f"{counts}")
    if not keys or not all(chosen[k] in groups[k] for k in keys):
        raise AssertionError(f"clip consensus: {chosen}")
    out["clip"] = dict(objects=len(keys), seconds=dt, counts=counts)
    return out


def train_detector_full_width(store: str, tmp: str, dev, smi: str) -> dict:
    """12d: `train_detector --preset large --pipeline default --consensus
    soft --head focal`, one round on SUBSET_ENVS envs of phase 8's store:
    the labeling time, ms per training step, peak memory, the JSON line;
    then one round each of `online`, `gt` and `swa` at the tiny preset on a
    store the port's `generate` writes on the card (with `bbsgt` labels
    written beside it: each frame's labels, boxes moved by a quarter
    pixel)."""
    from embodied_captioning_tpu_torch import train_detector as TDR
    from embodied_captioning_tpu_torch.train import pipelines as PL

    collect, step = PL.Pipeline.collect_pseudolabeled_dataset, \
        PL.TeacherStudent.training_step
    spans = {"label": [], "step": []}

    def timed(fn, key):
        def wrapper(*a, **k):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            spans[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    sub = subset_store(store, tmp, SUBSET_ENVS)
    PL.Pipeline.collect_pseudolabeled_dataset = timed(collect, "label")
    PL.TeacherStudent.training_step = timed(step, "step")
    try:
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc, line = run_entry(TDR.main, [
            "--obs-dir", sub, "--preset", LABEL_PRESET, "--pipeline",
            "default",
            "--consensus", "soft", "--head", "focal", "--save",
            os.path.join(tmp, "pipeline.pkl"), "--device", str(dev)])
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        large = dict(line=line, seconds=dt, label_s=sum(spans["label"]),
                     step_ms=[s * 1e3 for s in spans["step"]],
                     peak_bytes=peak)
    finally:
        PL.Pipeline.collect_pseudolabeled_dataset = collect
        PL.TeacherStudent.training_step = step
    steps = large["step_ms"]
    log(f"  train_detector ({LABEL_PRESET} preset, default pipeline, soft "
        f"consensus, focal head, {SUBSET_ENVS} envs of the store) on {smi}: "
        f"{dt:.1f} s; labeling {large['label_s']:.2f} s; {len(steps)} steps, "
        f"ms a step: first {steps[0] if steps else 0:.1f}, median of the "
        f"rest {float(np.median(steps[1:])) if len(steps) > 1 else 0:.1f}; "
        f"peak {peak / 2**30:.2f} GiB; {line}")
    if rc != 0 or line.get("train_steps", 0) < 1 or not all(
            math.isfinite(v) for v in (line.get("last") or {"x": math.nan}
                                       ).values()):
        raise AssertionError(f"train_detector large failed: {line}")
    tiny = tiny_store(os.path.join(tmp, "tiny_obs"), dev)
    others = {}
    for pipeline in ("online", "gt", "swa"):
        rc, line = run_entry(TDR.main, ["--obs-dir", tiny, "--pipeline",
                                        pipeline, "--device", str(dev)]
                             + TINY_STORE)
        log(f"  train_detector --pipeline {pipeline} (tiny) on {smi}: {line}")
        if rc != 0 or line.get("train_steps", 0) < 1:
            raise AssertionError(f"train_detector {pipeline} failed: {line}")
        others[pipeline] = line
    return dict(large=large, others=others)


# the tiny store's settings: 64^2 frames, detector threshold 0 so that the
# random-weight detector yields labels. A copy of tests/torch_parity.py's
# STORE_OVERRIDES (that module imports the JAX package, which this script
# must not): keep the two alike
TINY_STORE = ["runtime.num_envs=2", "sensors.height=64", "sensors.width=64",
              "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2",
              "detector.score_threshold=0.0"]


def tiny_store(path: str, dev) -> str:
    """4 steps of `randombaseline`'s generate (2 envs, TINY_STORE) at
    `path`, with `bbsgt` labels beside the `bbs` ones."""
    import glob

    from embodied_captioning_tpu_torch.agents import get_trainer
    from embodied_captioning_tpu_torch.config import load_config

    cfg = load_config("tiny", overrides=TINY_STORE + [
        f"runtime.obs_dir={path}"])
    tr = get_trainer("randombaseline")(cfg, device=dev)
    tr.generate(4)
    tr.envs.close()
    for f in glob.glob(os.path.join(path, "*", "*modality_bbs_id_*.npz")):
        d = np.load(f, allow_pickle=True)["arr_0"].item()
        inst = dict(d["instances"])
        inst["boxes"] = np.asarray(inst["boxes"], np.float32) + 0.25
        np.savez_compressed(
            f.replace("modality_bbs_id_", "modality_bbsgt_id_"),
            np.array({"instances": inst}, dtype=object))
    return path


# 12e: `selfcheck_detector --tta` on a short run (phase 11d's seed 0)
TTA_ARGS = ["--steps", str(TTA_STEPS), "--episodes", "2", "--tta"]


def selfcheck_tta_check(run: dict, smi: str) -> None:
    """12e: `selfcheck_detector --tta` at the tiny preset on a short run (a
    run of phase 19's lanes): map50_after_tta beside map50_after."""
    line = run["line"]
    log(f"  12e selfcheck_detector --tta (tiny, {TTA_STEPS} steps, 2 "
        f"episodes) on {smi}: {run['seconds']:.1f} s; map50_after "
        f"{line.get('map50_after')}, map50_after_tta "
        f"{line.get('map50_after_tta')}, map50_after_ema_tta "
        f"{line.get('map50_after_ema_tta')}")
    tta = line.get("map50_after_tta")
    if not isinstance(tta, float) or not 0.0 <= tta <= 1.0 or \
            "map50_after_ema_tta" not in line:
        raise AssertionError(f"selfcheck_detector --tta failed: {line}")


# ---------------------------------------------------------------------------
# phase 13: the query (Mask2Former-class) detector family
# ---------------------------------------------------------------------------

# 13a: tests/test_query_detector.py's QCFG (64^2, fpn_dim 64: head dim 8, 16
# queries, 3 decoder layers) with the rung's one-to-many aux matching
QCFG = dict(image_size=64, backbone_width=16, fpn_dim=64, family="query",
            num_queries=16, query_layers=3, max_detections=8,
            score_threshold=0.1, query_aux_topk=3)
# 13b: the large preset with the query head, as the JAX package's scale
# test builds it (tests/test_query_large_shapes.py): 1024^2, the R50-class
# bottleneck FPN P3-P6 at 256, 64 queries, 6 layers, head dim 32; score
# threshold 0 so that the random-weight detector keeps detections
QUERY_LARGE = ["detector.family=query", "detector.norm=gn",
               "detector.score_threshold=0.0"]
QUERY_STEP_BATCH = 4           # 13b: the timed training step's batch
# 13b: the share of the twins' route's detections the kernel route matches
# (same class, IoU >= 0.5); the decoder amplifies last-bit differences
# through its attention masks (ROADMAP C.29)
QUERY_MIN_MATCHED = 0.75
# 13a: one AdamW step card against CPU (`update_gaps`, `relative_gap`):
# (moved alike at least, |decay estimate| at most, moments at most).
# Read on an H100 80GB HBM3 at 700 W (PERF.md): moved alike 0.96007,
# decay -4.65e-4, moments 0.170 (the gradients part within their spread
# limits: the decoder's attention masks flip under last-bit changes,
# ROADMAP C.29); a step on the negated gradient 0.19345, -3.86e-3, 1.99
QUERY_UPDATE = (0.9, 2e-3, 0.35)
# 13a: the valid cost entries card against CPU, over the largest of them
# (both from the CPU's logits: the products' order and the card's
# sigmoid, log and softmax). Read on an H100 80GB HBM3 at 700 W
# (PERF.md): 1.30e-7; with TF32 products 5.30e-5
QUERY_COST_GAP = 3e-6
# 13c: the serving rung (scripts/rungs_r5_small.sh, query-serving), its
# depth cut to 2 training and 2 eval scenes and RUNG_STEPS steps, then a
# call that resumes from the checkpoint and runs to RUNG_STEPS_RESUMED
RUNG = ["--split", "scenes", "--batch", "16", "--device-train", "--augment",
        "--augment-crop", "--lr-schedule", "cosine", "--ema", "0.999",
        "--tta", "--pack-masks", "--episodes", "2", "--eval-scenes", "2",
        "--eval-ep-steps", "8", "--seed", "0", "sensors.height=1280",
        "sensors.width=1280", "detector.image_size=256",
        "detector.family=query", "detector.query_aux_topk=3"]
RUNG_STEPS, RUNG_STEPS_RESUMED, RUNG_CKPT_EVERY = 6, 10, 3


def _spread_limit(err: float, ref: float, spread: float, rel: float
                  ) -> tuple:
    lim = max(rel * ref, 3 * spread)
    return err <= lim, (err / lim if lim > 0 else
                        (0.0 if err == 0 else math.inf))


def query_card_vs_cpu(dev, smi: str) -> None:
    """13a: the query detector at QCFG on the card (the flash kernel at
    head dim 8, the LayerNorm kernels, cuDNN) and on the CPU (their plain
    versions), same weights and batch (2 frames, 8 ground-truth boxes with
    masks): every supervision point's class and mask logits, the set loss
    and every leaf's gradient, each within the larger of a share of its
    norm (1e-2 for the logits, 1e-4 for the loss, 5e-2 for a gradient)
    and 3x its CPU spread (DET_SPREAD_DRAWS moves of the CPU's parameters
    by 1e-4 of themselves); one AdamW step (the pipelines' clip 1 and
    decay 1e-4) held by what it did (`train/optim.update_gaps`,
    `relative_gap`: the share of elements moved alike, the decay applied
    beyond the CPU's, Adam's moments) within QUERY_UPDATE, a step on the
    negated gradient failing them; the cost matrices from the CPU's
    logits within QUERY_COST_GAP of the CPU's (the same with TF32
    products beyond it), and the Hungarian solver's matched queries on
    the card's costs equal to those on the CPU's."""
    from embodied_captioning_tpu_torch.config import DetectorConfig
    from embodied_captioning_tpu_torch.models import query_detector as TQ
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.selfcheck_detector import (
        loss_and_grads)
    from embodied_captioning_tpu_torch.train.optim import (
        adam_init, adam_update, relative_gap, tree_leaves, tree_map,
        update_gaps)

    cfg = DetectorConfig(**QCFG)
    params = init_detector(torch.Generator().manual_seed(5), cfg, "cpu")
    names = leaf_paths(params)
    images, gt = detector_batch(cfg, 2, 8, 0, "cpu")

    def moved(seed):
        gen = torch.Generator().manual_seed(seed)
        return tree_map(lambda x: x * (1 + 1e-4 * torch.randn(
            x.shape, generator=gen)), params)

    @torch.no_grad()
    def decode(p, where):
        return [[x.float().cpu() for x in pr] for pr in TQ._decode(
            to_device(p, where), images.to(where).float() / 255.0, cfg)]

    def grads(p, where):
        g, loss, _ = loss_and_grads(to_device(p, where), images.to(where),
                                    gt.to(where), cfg, "ce")
        return [x.float().cpu() for x in tree_leaves(g)], float(loss)

    dec_cpu, (g_cpu, l_cpu) = decode(params, "cpu"), grads(params, "cpu")
    dec_spread = [[0.0, 0.0] for _ in dec_cpu]
    g_spread, l_spread = [0.0] * len(g_cpu), 0.0
    for seed in range(1, DET_SPREAD_DRAWS + 1):
        mp = moved(seed)
        for li, pr in enumerate(decode(mp, "cpu")):
            for k in range(2):
                dec_spread[li][k] = max(dec_spread[li][k], (
                    pr[k] - dec_cpu[li][k]).norm().item())
        gm, lm = grads(mp, "cpu")
        g_spread = [max(s, (a - b).norm().item())
                    for s, a, b in zip(g_spread, gm, g_cpu)]
        l_spread = max(l_spread, abs(lm - l_cpu))
    dec_card, (g_card, l_card) = decode(params, dev), grads(params, dev)
    bad, worst_dec, worst_leaf = [], 0.0, 0.0
    for li in range(len(dec_cpu)):
        for k, what in enumerate(("class", "mask")):
            ok, r = _spread_limit((dec_card[li][k] - dec_cpu[li][k]).norm()
                                  .item(), dec_cpu[li][k].norm().item(),
                                  dec_spread[li][k], 1e-2)
            worst_dec = max(worst_dec, r)
            if not ok:
                bad.append((f"decoder point {li} {what} logits", r))
    ok, r_loss = _spread_limit(abs(l_card - l_cpu), abs(l_cpu), l_spread,
                               1e-4)
    if not ok:
        bad.append(("loss", l_card, l_cpu, l_spread))
    for n, a, b, sp in zip(names, g_card, g_cpu, g_spread):
        ok, r = _spread_limit((a - b).norm().item(), b.norm().item(), sp,
                              5e-2)
        worst_leaf = max(worst_leaf, r)
        if not ok:
            bad.append((n, r))
        if bool((b != 0).any()) and not (bool((a != 0).any())
                                         and bool(torch.isfinite(a).all())):
            bad.append((n, "zero or non-finite on the card"))
    def adamw_step(where, sign=1.0):
        p = to_device(params, where)
        g, _, _ = loss_and_grads(p, images.to(where), gt.to(where), cfg, "ce")
        p2, st = adam_update(p, adam_init(p), tree_map(lambda x: sign * x, g),
                             DET_LR, 1.0, weight_decay=1e-4)
        return st.count, *([x.cpu().numpy() for x in tree_leaves(t)]
                           for t in (p2, st.mu, st.nu))

    def update_read(card, ref):
        gaps = update_gaps(before, card[1], ref[1], DET_LR)
        mom = max(relative_gap(card[2], ref[2]), relative_gap(card[3],
                                                              ref[3]))
        agree_lim, decay_lim, mom_lim = QUERY_UPDATE
        ok = (card[0] == ref[0] == 1 and gaps["agree"] >= agree_lim
              and abs(gaps["decay"]) <= decay_lim and mom <= mom_lim)
        return ok, (f"moved alike {gaps['agree']:.5f}, decay "
                    f"{gaps['decay']:+.2e}, moments {mom:.2e}")

    before = [x.numpy() for x in tree_leaves(params)]
    step_cpu = adamw_step("cpu")
    ok_step, step_read = update_read(adamw_step(dev), step_cpu)
    caught, neg_read = update_read(adamw_step(dev, -1.0), step_cpu)
    if not ok_step:
        bad.append(("one AdamW step", step_read))
    if caught:
        bad.append(("a step on the negated gradient passed", neg_read))

    with torch.no_grad():
        preds = TQ._decode(params, images.float() / 255.0, cfg)
        gmask = TQ.gt_masks(gt.masks, *preds[0][1].shape[2:])

        def costs_on(w):
            return [TQ._costs(c.to(w), m.to(w), gt.classes.to(w),
                              gt.valid.to(w), gmask.to(w))[0]
                    for c, m in preds]

        costs = {"cpu": costs_on("cpu"), str(dev): costs_on(dev)}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = costs_on(dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    valid = gt.valid[:, None, :]

    def gap(got):
        return max(((a.cpu() - b).abs()[valid.expand_as(b)].max()
                    / b.abs()[valid.expand_as(b)].max()).item()
                   for a, b in zip(got, costs["cpu"]))

    cost_gap, tf32_gap = gap(costs[str(dev)]), gap(tf32)
    if cost_gap > QUERY_COST_GAP:
        bad.append(("cost matrices", cost_gap))
    if tf32_gap <= QUERY_COST_GAP:
        bad.append(("TF32 cost matrices passed", tf32_gap))
    m_cpu, m_card = TQ.match(costs["cpu"]), TQ.match(costs[str(dev)])
    agree = int((m_cpu == m_card).sum())
    if agree != m_cpu.size:
        bad.append(("Hungarian matches", agree, m_cpu.size))
    log(f"  query detector card ({smi}) vs CPU (QCFG: 64^2, fpn_dim 64, 16 "
        f"queries, 3 layers, aux top-3; 2 frames, 8 boxes): decoder worst "
        f"{worst_dec:.3f} of its limit over {len(dec_cpu)} points; loss "
        f"card {l_card:.5f} CPU {l_cpu:.5f} (spread {l_spread:.2e}, "
        f"{r_loss:.3f} of its limit); worst of {len(names)} leaves "
        f"{worst_leaf:.3f} of its limit; one AdamW step: {step_read} "
        f"(limits {QUERY_UPDATE}; on the negated gradient {neg_read}); "
        f"valid costs {cost_gap:.2e} of their largest apart (limit "
        f"{QUERY_COST_GAP:.0e}; with TF32 products {tf32_gap:.2e}); "
        f"Hungarian matches on the card's costs equal the CPU's on {agree} "
        f"of {m_cpu.size}")
    if bad:
        raise AssertionError(f"query card vs CPU: {bad[:8]}")


def matched_share(got, want) -> tuple:
    """(matched, total): `want`'s valid detections with a valid detection
    of `got` of the same class at IoU >= 0.5."""
    from embodied_captioning_tpu_torch.ops.detections import pairwise_iou

    hit = total = 0
    for b in range(want.boxes.shape[0]):
        wv, gv = want.valid[b].bool(), got.valid[b].bool()
        iou = pairwise_iou(want.boxes[b].float(), got.boxes[b].float())
        same = want.classes[b][:, None] == got.classes[b][None, :]
        ok = (iou >= 0.5) & same & gv[None, :] & wv[:, None]
        hit += int(ok.any(1).sum())
        total += int(wv.sum())
    return hit, total


def query_perception(dev, detector_overrides: list):
    """`per_cfg(detector_overrides)` and random weights from a generator
    seeded 0 (the captioner and sentence encoder int8)."""
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.models.quantize import quantize_params
    from embodied_captioning_tpu_torch.models.sbert import (
        init_sentence_encoder)
    from embodied_captioning_tpu_torch.params import PerceptionParams

    cfg = per_cfg(detector_overrides)
    g = torch.Generator(device=dev).manual_seed(0)
    params = PerceptionParams(
        detector=init_detector(g, cfg.detector, dev),
        captioner=quantize_params(init_captioner(g, cfg.captioner, dev)),
        sbert=quantize_params(init_sentence_encoder(g, cfg.sentence_encoder,
                                                    dev)))
    return cfg, params


def timed_perceive(what: str, params, frames, cfg, smi: str) -> dict:
    """A warm-up `perceive` batch, then one timed with the kernels'
    launches counted (flash attention and LayerNorm must launch), its
    outputs checked (shapes, finite values), and one under the profiler
    (device busy and idle share)."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.perception import perceive

    perceive(params, frames, cfg)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = perceive(params, frames, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    d, n = res.detections, cfg.detector.max_detections
    paste = cfg.detector.paste_size or cfg.detector.image_size
    e = frames.shape[0]
    if (tuple(d.boxes.shape) != (e, n, 4)
            or tuple(d.masks.shape) != (e, n, paste, paste)
            or not all(bool(torch.isfinite(getattr(d, k).float()).all())
                       for k in ("boxes", "scores", "masks", "embeddings"))
            or not bool(torch.isfinite(res.caption_logprobs).all())):
        raise AssertionError(f"{what}: outputs {d.boxes.shape} "
                             f"{d.masks.shape}")
    if counts["flash_attention"] <= 0 or counts["layernorm"] <= 0:
        raise AssertionError(f"{what}: flash or LayerNorm not launched: "
                             f"{counts}")
    log(f"  {what} on {smi}: {dt * 1e3:.1f} ms a batch of {e} frames "
        f"({e / dt:.2f} frames/s), {int(d.valid.sum())} valid detections; "
        f"launches {counts}")
    busy = profile_run(what, lambda: perceive(params, frames, cfg), dt * 1e6,
                       top=8)
    return dict(res=res, ms=dt * 1e3, counts=counts, busy_us=busy)


def query_full_width(frames, dev, smi: str) -> dict:
    """13b: one timed `perceive` batch of FRAMES phase-3 frames (1280^2)
    with the query detector at the large preset (random seeded weights):
    launches, device busy and idle share, and the share of the detections
    of the twins' route (`plain_kernels`) it matches; then one timed
    training step of that detector at batch QUERY_STEP_BATCH on frames of
    the port's simulator (a warm-up and DET_STEPS timed steps): ms a
    step, the host solver's ms a step, peak memory, device busy and idle
    share. Returns the perception weights for 13c."""
    import gc

    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.models import query_detector as TQ
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.perception import perceive
    from embodied_captioning_tpu_torch.selfcheck_detector import (
        batch_of, collect, train_step)
    from embodied_captioning_tpu_torch.train.optim import adam_init

    cfg, params = query_perception(dev, QUERY_LARGE)
    dc = cfg.detector
    log(f"  query detector: {dc.block} blocks, {dc.norm} norm, "
        f"{dc.image_size}^2, FPN strides {dc.fpn_strides} at {dc.fpn_dim}, "
        f"{dc.num_queries} queries, {dc.query_layers} layers, head dim "
        f"{dc.fpn_dim // 8}")
    run = timed_perceive("one perceive batch, query detector (large preset)",
                         params, frames, cfg, smi)
    with plain_kernels(K):
        plain = perceive(params, frames, cfg)
    hit, total = matched_share(run["res"].detections, plain.detections)
    log(f"  kernel route vs the twins' route: {hit} of {total} detections "
        f"matched (class, IoU >= 0.5; limit {QUERY_MIN_MATCHED})")
    if total == 0 or hit < QUERY_MIN_MATCHED * total:
        raise AssertionError(f"query perceive: matched {hit} of {total}")
    per = params._replace(detector=None)
    del params, plain, run["res"]
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tcfg = load_config("large", overrides=QUERY_LARGE)
    data = collect(tcfg, 2, QUERY_STEP_BATCH // 2, 0,
                   np.random.default_rng(0), dev)
    images, gt = batch_of(data, range(QUERY_STEP_BATCH), dc.image_size, dev)
    state = [init_detector(torch.Generator(device=dev).manual_seed(0), dc,
                           dev)]
    state.append(adam_init(state[0]))
    wait, copy, solver = [], [], []
    match, hungarian = TQ.match, TQ.hungarian_batch

    def timed_hungarian(c):
        t0 = time.perf_counter()
        out = hungarian(c)
        solver.append(time.perf_counter() - t0)
        return out

    def timed_match(costs):
        # the wait for the device's forward pass and cost products, then
        # the costs' copy to the host and the solver, each on its own
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = match(costs)
        wait.append(t1 - t0)
        copy.append(time.perf_counter() - t1)
        return out

    def step():
        state[0], state[1], loss = train_step(state[0], state[1], images, gt,
                                              dc, "ce", lambda c: DET_LR)
        return loss

    TQ.match, TQ.hungarian_batch = timed_match, timed_hungarian
    try:
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        for x in (wait, copy, solver):
            x.clear()
        K.reset_launches()
        times, losses = [], []
        for _ in range(DET_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = dict(K.launches)
        peak = torch.cuda.max_memory_allocated() - base
        ms = sorted(times)[len(times) // 2] * 1e3

        def step_median(xs):
            # each step matches once
            return sorted(xs)[len(xs) // 2] * 1e3

        solver_ms, wait_ms = step_median(solver), step_median(wait)
        copy_ms = step_median(copy) - solver_ms
        log(f"  query detector train step (large preset), batch "
            f"{QUERY_STEP_BATCH}, ce head, aux top-{dc.query_aux_topk}: "
            f"{ms:.1f} ms a step (median of {DET_STEPS}: "
            + ", ".join(f"{t * 1e3:.1f}" for t in times)
            + f") on {smi}; host solver {solver_ms:.2f} ms a step, the "
            f"costs' stack and copy to the host {copy_ms:.2f} ms, the wait "
            f"for the device before them {wait_ms:.2f} ms; peak "
            f"{peak / 2**30:.2f} GiB; losses "
            + " ".join(f"{x:.4f}" for x in losses) + f"; launches {counts}")
        if (not all(math.isfinite(x) for x in losses)
                or counts["layernorm_bwd"] <= 0):
            raise AssertionError(f"query step failed: {losses} {counts}")
        busy = profile_run("one query detector train step (large preset)",
                           step, ms * 1e3, top=10)
    finally:
        TQ.match, TQ.hungarian_batch = match, hungarian
    del state, images, gt, data
    torch.cuda.empty_cache()
    return dict(counts=run["counts"], perceive_ms=run["ms"],
                perceive_busy_us=run["busy_us"], step_ms=ms,
                solver_ms=solver_ms, copy_ms=copy_ms, wait_ms=wait_ms,
                peak_bytes=peak, step_busy_us=busy,
                per=per, cfg=cfg)


def query_rung(frames, per, dev, smi: str, tmp: str) -> dict:
    """13c: the serving rung, shortened (RUNG): `selfcheck_detector` with
    the rung's flags (device-side training on bit-packed masks, the
    checkpoint every RUNG_CKPT_EVERY steps, the flip merge, the saved
    artifact) for RUNG_STEPS steps; a second call resumes from the
    checkpoint and runs to RUNG_STEPS_RESUMED (its output says so); the
    port's `export_serving_artifact` of the saved artifact; then
    `perceive` over the FRAMES phase-3 frames with the exported int8
    detector (`load_detector_artifact`) and 13b's captioner; then with a
    query detector at the default width (fpn_dim 128, 256^2: the flash
    kernel at head dim 16), random seeded weights."""
    from embodied_captioning_tpu_torch import export_serving_artifact as EX
    from embodied_captioning_tpu_torch import selfcheck_detector as SD
    from embodied_captioning_tpu_torch.config import (
        DetectorConfig, merge, to_dict)
    from embodied_captioning_tpu_torch.models.detector import init_detector
    from embodied_captioning_tpu_torch.params import (
        load_detector_artifact, load_pickle)

    ck, save = os.path.join(tmp, "rung_ckpt.pkl"), os.path.join(tmp,
                                                                "rung.pkl")
    argv = RUNG + ["--ckpt", ck, "--ckpt-every", str(RUNG_CKPT_EVERY),
                   "--save", save, "--device", str(dev),
                   "--train-cache", os.path.join(tmp, "rung_train.npz"),
                   "--eval-cache", os.path.join(tmp, "rung_eval.npz")]
    t0 = time.perf_counter()
    rc, line, text = run_entry_text(SD.main, argv + ["--steps",
                                                     str(RUNG_STEPS)])
    t1 = time.perf_counter()
    if rc != 0 or f"checkpoint @ step {RUNG_STEPS}" not in text:
        raise AssertionError(f"rung: {rc} {line}")
    rc, line2, text = run_entry_text(SD.main, argv + [
        "--steps", str(RUNG_STEPS_RESUMED)])
    t2 = time.perf_counter()
    if (rc != 0 or f"resumed from {ck} at step {RUNG_STEPS}" not in text
            or not math.isfinite(line2.get("last_loss") or math.nan)):
        raise AssertionError(f"rung resume: {rc} {line2}")
    log(f"  selfcheck_detector, the query-serving rung shortened, on {smi}: "
        f"{t1 - t0:.1f} s for {RUNG_STEPS} steps (corpora collected), "
        f"{t2 - t1:.1f} s resumed at {RUNG_STEPS} to "
        f"{RUNG_STEPS_RESUMED}; map50_after {line2['map50_after']}, "
        f"map50_after_tta {line2['map50_after_tta']}, mask_iou "
        f"{line2['mask_iou']}")
    served = os.path.join(tmp, "served_query.pkl")
    served_cpu = os.path.join(tmp, "served_query_cpu.pkl")
    t0 = time.perf_counter()
    rc, ex = run_entry(EX.main, [save, "--out", served])
    t1 = time.perf_counter()
    rc_cpu, _ = run_entry(EX.main, [save, "--out", served_cpu, "--device",
                                    "cpu"])
    dp, dcfg = load_detector_artifact(served, dev)
    if rc != 0 or rc_cpu != 0 or dcfg["family"] != "query":
        raise AssertionError(f"export: {rc} {rc_cpu} {ex} "
                             f"{dcfg.get('family')}")
    # the card's export against the CPU's: the same tree, equal bits
    # (int8 rounding of w / scale, both divisions correctly rounded)
    card_tree, cpu_tree = load_pickle(served), load_pickle(served_cpu)
    leaves = numpy_leaves(card_tree["served"])
    want = numpy_leaves(cpu_tree["served"])
    differ = [k for (k, a), (kw, b) in zip(leaves, want) if not (
        k == kw and a.dtype == b.dtype and a.shape == b.shape
        and np.array_equal(a, b))]
    if len(leaves) != len(want):
        differ.append(("leaves", len(leaves), len(want)))
    log(f"  export_serving_artifact on the card: {(t1 - t0) * 1e3:.1f} ms, "
        f"{ex['mb']} MB; {len(leaves) - len(differ)} of {len(leaves)} "
        f"leaves equal to the CPU export's bit for bit")
    if differ or card_tree["serving_cfg"] != cpu_tree["serving_cfg"]:
        raise AssertionError(f"export card vs CPU: {differ[:8]}")
    cfg = merge(per_cfg(), {"detector": dcfg})
    run = timed_perceive("one perceive batch, exported int8 query detector "
                         f"({dcfg['image_size']}^2, head dim "
                         f"{dcfg['fpn_dim'] // 8})",
                         per._replace(detector=dp), frames, cfg, smi)
    # the rung runs the tiny preset's detector (fpn_dim 32: head dim 4, the
    # plain attention); the default detector width, fpn_dim 128, gives the
    # flash kernel's head dim 16
    dc16 = DetectorConfig(family="query", score_threshold=0.0)
    cfg16 = merge(per_cfg(), {"detector": to_dict(dc16)})
    run16 = timed_perceive(
        f"one perceive batch, query detector at fpn_dim {dc16.fpn_dim} "
        f"({dc16.image_size}^2, head dim {dc16.fpn_dim // 8})",
        per._replace(detector=init_detector(torch.Generator(
            device=dev).manual_seed(0), dc16, dev)), frames, cfg16, smi)
    return dict(line=line2, export=ex, counts=run["counts"],
                perceive_ms=run["ms"], counts16=run16["counts"],
                perceive16_ms=run16["ms"])


def per_cfg(detector_overrides=()):
    """The serving configuration of phase 3 (the large preset, SLOTS
    caption slots a frame, FRAMES envs), the detector's fields set by
    `detector_overrides`."""
    from embodied_captioning_tpu_torch.config import load_config

    return load_config("large", overrides=list(detector_overrides) + [
        f"runtime.caption_slots_per_frame={SLOTS}",
        "runtime.caption_invalid_slots=true", f"runtime.num_envs={FRAMES}"])


def query_labeling(dev, smi: str, tmp: str) -> dict:
    """13d: `run_pseudolabeler` with a query detector (tiny preset) on a
    store the port's `generate` writes on the card; then `train_detector
    --pipeline online --head ce` with a query student, which its set loss
    refuses as the JAX package's does (the pipelines hand the student no
    masks)."""
    from embodied_captioning_tpu_torch import run_pseudolabeler as RPL
    from embodied_captioning_tpu_torch import train_detector as TDR

    store = tiny_store(os.path.join(tmp, "query_obs"), dev)
    over = TINY_STORE + ["detector.family=query"]
    rc, line = run_entry(RPL.main, [store] + over + [
        "--out", os.path.join(tmp, "query_pl"), "--consensus", "vanilla",
        "--device", str(dev)])
    if rc != 0 or line.get("frames", 0) <= 0:
        raise AssertionError(f"run_pseudolabeler (query): {line}")
    try:
        run_entry(TDR.main, ["--obs-dir", store, "--pipeline", "online",
                             "--head", "ce", "--device", str(dev)] + over)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("train_detector trained a query student "
                             "without masks")
    if "gt.masks required" not in refused:
        raise AssertionError(f"train_detector (query): {refused}")
    log(f"  run_pseudolabeler (query detector, tiny) on {smi}: {line}; "
        f"train_detector with a query student: refused ({refused})")
    return line


# ---------------------------------------------------------------------------
# phase 14: the detector's serving evaluations, BLIP-2, Florence and the
# consensus LM
# ---------------------------------------------------------------------------

# 14a: eval_artifact's corpora cut to size: its protocol corpus's fixed 8
# scenes, 2 wide and 2 stress scenes, EVAL_EP_STEPS walk positions a scene
# (the script's default 12), batches of EVAL_BATCH (whole batches only);
# the CPU's evaluation of the 24 frames takes most of the phase's time
EVAL_SCENES, EVAL_WIDE, EVAL_STRESS = 8, 2, 2
EVAL_EP_STEPS = 2
EVAL_BATCH = 4
# the card's mAP against the CPU's on the same frames and weights: the
# served int8 detector's bf16 boxes and scores (ROADMAP C.25) may move a
# detection across IoU 0.5 or past another's score
EVAL_MAP_ATOL = 0.05
SERVING_STEPS = TTA_STEPS      # 14a: selfcheck_detector steps (12e's)
SERVING_FT = 20                # 14a: --affine-finetune steps
VLM_CROPS = 16                 # 14b-c: crops of phase 3's frames
# 14b: the Q-Former's query self-attention at Blip2Config(): 12 heads of
# 64 over its 32 queries (XLA attention in the JAX package, T < 64)
QFORMER_FLASH = (VLM_CROPS, 12, 32, 64)
# 14b: ITC / ITM scores (f32 of bf16 features after a 24-layer ViT and a
# 6-layer Q-Former) through the kernels against the twins' route. Read on
# an H100 (PERF.md, PR 16 B, D): ITC 9.4e-4 and 8.4e-4, ITM 2.2e-3 and
# 1.3e-3; the twins' scores of other crops 0.188 (ITC) and 0.863 (ITM)
# from the kernels' (D), which must stay above the limit
SCORE_ATOL = 1e-2
# 14b-c: the step logits of the kernel decode against the twins' decode of
# the same tokens (teacher-forced, phase 3's measure: the chosen tokens'
# log-probs in bf16 ulps of the row's largest |logit|) are held to
# MAX_LOGPROB_ULPS (read: BLIP-2 2.017, Florence 2.013-2.051, PR 16 D); a
# twins' decode whose cache lacks its first positions (BLIP-2's image
# prefix, Florence's BOS) must read above it (read 284.7 and 90.0).
# BLIP-2's full-sequence `lm_logits` (the ViT, Q-Former and a 44-position
# prefix-LM pass, no decode kernel) through the kernels against the
# twins' in the same measure (read 3.002, PR 16 D); the kernels' over
# other crops must read above it
LM_LOGITS_ULPS = 8.0
LM_SETS = (["a red couch", "a red couch near the wall", "a green plant"],
           ["a tv", "a black tv on a table", "a television", "a tv"],
           ["a white toilet", "a bed", "a white toilet in a bathroom"],
           ["a plant", "a small green plant", "a potted plant on a table",
            "a brown table", "a plant"])
LM_SCORE_ATOL = 1e-2           # 14d: mean log-probs, card vs CPU


def serving_evals(dev, smi: str, tmp: str) -> dict:
    """14a: `eval_artifact` on the committed artifact on the card, its
    corpora rendered there and written to caches (EVAL_SCENES / EVAL_WIDE
    / EVAL_STRESS scenes of EVAL_EP_STEPS positions; the raycast kernel
    launched), then on the CPU from those caches: equal corpus shas, every
    mAP within EVAL_MAP_ATOL (the self-check's serving flags run in phase
    19's lanes: `serving_flags_check`)."""
    from embodied_captioning_tpu_torch import eval_artifact as EA
    from embodied_captioning_tpu_torch import kernels as K

    caches = [os.path.join(tmp, f"{n}.npz")
              for n in ("protocol", "wide", "stress")]
    argv = ["--eval-cache", caches[0], "--wide", str(EVAL_WIDE),
            "--wide-cache", caches[1], "--stress", str(EVAL_STRESS),
            "--stress-cache", caches[2], "--eval-ep-steps",
            str(EVAL_EP_STEPS), "--batch", str(EVAL_BATCH)]
    K.reset_launches()
    t0 = time.perf_counter()
    rc, card = run_entry(EA.main, argv + ["--device", str(dev)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    t0 = time.perf_counter()
    rc_cpu, cpu = run_entry(EA.main, argv + ["--device", "cpu"])
    dt_cpu = time.perf_counter() - t0
    log(f"  eval_artifact (committed artifact, {EVAL_SCENES}/{EVAL_WIDE}/"
        f"{EVAL_STRESS} scenes x {EVAL_EP_STEPS} positions at 1280^2) on "
        f"{smi}: {dt:.1f} s with the render, {dt_cpu:.1f} s on the CPU "
        f"from the caches; launches {counts}")
    if rc != 0 or rc_cpu != 0 or counts["raycast_minargmin"] <= 0:
        raise AssertionError(f"eval_artifact: rc {rc} / {rc_cpu}, "
                             f"launches {counts}")
    if card["corpora"] != cpu["corpora"] or list(card["results"]) != [
            "protocol", "wide", "stress"]:
        raise AssertionError(f"eval_artifact corpora: {card['corpora']} vs "
                             f"{cpu['corpora']}")
    worst = 0.0
    for c, row in cpu["results"].items():
        if list(card["results"][c]) != list(row):
            raise AssertionError(f"eval_artifact {c}: {card['results'][c]}")
        for v, m in row.items():
            got = card["results"][c][v]
            worst = max(worst, abs(got - m))
            log(f"    {c}/{v}: card {got}, CPU {m}")
    if worst > EVAL_MAP_ATOL:
        raise AssertionError(f"eval_artifact mAP card vs CPU {worst} > "
                             f"{EVAL_MAP_ATOL}")
    log(f"  eval_artifact: corpora {card['corpora']}; mAP card vs CPU "
        f"within {worst:.4f} (limit {EVAL_MAP_ATOL})")
    return dict(counts=counts, card=card, cpu=cpu)


# 14a: the self-check's serving flags at the tiny preset
SERVING_ARGS = ["--steps", str(SERVING_STEPS), "--episodes", "2",
                "--eval-wide", "2", "--eval-serving", "--calibrate",
                "--affine-finetune", str(SERVING_FT), "--tta"]
SERVING_KEYS = ("map50_wide", "map50_wide_tta", "map50_serving_exact",
                "map50_serving_approx", "map50_gn_int8", "map50_affine",
                "map50_affine_ft", "map50_served_int8",
                "map50_served_int8_tta")


def serving_flags_check(run: dict, smi: str) -> None:
    """14a: `selfcheck_detector --eval-wide 2 --eval-serving --calibrate
    --affine-finetune SERVING_FT --tta` at the tiny preset (a run of phase
    19's lanes): every key of those flags present, finite and in [0, 1]."""
    line = run["line"]
    bad = [k for k in SERVING_KEYS if not isinstance(line.get(k), float)
           or not 0.0 <= line[k] <= 1.0]
    if bad or not isinstance(line.get("eval_wide_sha"), str):
        raise AssertionError(f"selfcheck_detector serving flags: {bad} "
                             f"{line}")
    log(f"  14a selfcheck_detector --eval-wide 2 --eval-serving --calibrate "
        f"--affine-finetune {SERVING_FT} --tta (tiny, {SERVING_STEPS} "
        f"steps) on {smi}: {run['seconds']:.1f} s; "
        + ", ".join(f"{k} {line[k]}" for k in SERVING_KEYS))


def require_launches(what: str, counts: dict, need: tuple) -> None:
    missing = [n for n in need if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched {missing}: "
                             f"{counts}")


def live_positions(tokens: torch.Tensor, first: int) -> torch.Tensor:
    """[B, L-1-first] bool: decode steps from position `first` whose token
    (at pos + 1) was chosen before the row finished (an EOS at or before
    pos)."""
    from embodied_captioning_tpu_torch.models.tokenizer import EOS_ID

    eos = (tokens[:, first:-1] == EOS_ID).int()
    done_before = torch.cumsum(eos, dim=1) > 0
    return ~done_before


def chosen_agree(logits: torch.Tensor, tokens: torch.Tensor, first: int
                 ) -> tuple:
    """(share, count) of the live decode steps from `first` whose argmax of
    the teacher-forced `logits` [B, L, V] equals the token chosen there."""
    live = live_positions(tokens, first)
    pred = logits[:, first:-1].float().argmax(-1)
    ok = (pred == tokens[:, first + 1:].long()) & live
    n = int(live.sum())
    return int(ok.sum()) / max(n, 1), n


def qformer_flash_case(K, dev) -> dict:
    """Flash attention at the Q-Former's query self-attention shape
    QFORMER_FLASH against its plain version (twice for equal bits), timed
    beside SDPA and the bound: a new shape for the kernel (the JAX package
    sends T < 64 to XLA attention, ROADMAP C.9)."""
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(*QFORMER_FLASH, generator=g, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    got = K.flash_attention(q, k, v)
    err = check_close(f"flash_attention {list(QFORMER_FLASH)} (Q-Former "
                      f"queries)", got, K.flash_attention_plain(q, k, v),
                      2e-2)
    if not torch.equal(got, K.flash_attention(q, k, v)):
        raise AssertionError("flash_attention (Q-Former): two runs differ")
    b, h, t, d = QFORMER_FLASH
    fb, ff = bound_ms(4 * nbytes(q), 4 * b * h * t * t * d)
    case = dict(
        shape=list(QFORMER_FLASH), what="Q-Former query self-attention",
        replaces=TPU_KERNELS + "flash_attention.py:147", max_abs_err=err,
        **kernel_ms(lambda: K.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: K.flash_attention_plain(q, k, v), 5, 1),
        bound_ms=fb, bound_by=ff,
        **library(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v)))
    log(f"  flash_attention {list(QFORMER_FLASH)}: {case['device_us']:.2f} "
        f"us on the device ({case['ms'] * 1e3:.2f} us a call), SDPA "
        f"{case['library_device_us']:.2f} us, bound {fb * 1e3:.2f} us ({ff}),"
        f" plain {case['plain_ms'] * 1e3:.1f} us")
    return case


def timed_generate(what: str, fn, need: tuple, smi: str) -> dict:
    """A warm-up call of `fn`, then one timed with the kernels' launches
    counted (every kernel in `need` launched), then one under the profiler
    (device busy and idle share)."""
    from embodied_captioning_tpu_torch import kernels as K

    fn()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    require_launches(what, counts, need)
    log(f"  {what} on {smi}: {dt * 1e3:.1f} ms a batch; launches {counts}")
    busy = profile_run(what, fn, dt * 1e6, top=8)
    return dict(out=out, ms=dt * 1e3, counts=counts, busy_us=busy)


def logprob_ulps(kern: torch.Tensor, twin: torch.Tensor,
                 tokens: torch.Tensor, first: int) -> dict:
    """Phase 3's measure over the live decode steps from `first`: step
    logits [B, S, V] (step s predicts tokens[:, first + s + 1]) of the
    kernel route and of the twins, the chosen tokens' log-prob difference
    in bf16 ulps of the twins' largest |logit| in the row: max and mean."""
    live = live_positions(tokens, first)
    nxt = tokens[:, first + 1:].long()[..., None]
    kern, twin = kern.float(), twin.float()
    lk = torch.log_softmax(kern, -1).gather(-1, nxt)[..., 0]
    lt = torch.log_softmax(twin, -1).gather(-1, nxt)[..., 0]
    ulp = torch.exp2(torch.floor(torch.log2(
        twin.abs().amax(-1).clamp(min=1e-30))) - 7)
    u = ((lk - lt).abs() / ulp)[live]
    return dict(max=u.max().item(), mean=u.mean().item(), n=int(live.sum()))


def blip2_forced_steps(params: dict, crops: torch.Tensor,
                       tokens: torch.Tensor, cfg, prime: bool = True
                       ) -> torch.Tensor:
    """The decode steps of BLIP-2's `generate` fed `tokens` [B, L]
    (teacher-forced) on the route in force (kernels or twins): the step
    logits [B, L-1, V]. prime=False leaves the cache's Q prefix positions
    unwritten (a decode that does not see the image: the control)."""
    from embodied_captioning_tpu_torch.models import blip2 as B
    from embodied_captioning_tpu_torch.models.common import (
        KVCache, block, dense, layernorm)

    prefix = B._lm_prefix(params, crops, cfg)
    b, nq, _ = prefix.shape
    length = tokens.shape[1]
    hd = cfg.lm_width // cfg.lm_heads
    caches = [KVCache.create(b, nq + length, cfg.lm_heads, hd, crops.device)
              for _ in range(cfg.lm_layers)]
    if prime:
        x = (prefix.float() + params["lm_pos"][None, :nq]).to(torch.bfloat16)
        for i, blk in enumerate(params["lm_blocks"]):
            x, caches[i] = block(blk, x, cfg.lm_heads, cache=caches[i],
                                 cache_block_causal=False)
    else:
        caches = [KVCache(c.k, c.v, nq) for c in caches]
    out = []
    for pos in range(length - 1):
        x = (params["lm_tok_emb"][tokens[:, pos].long()][:, None]
             + params["lm_pos"][nq + pos][None, None]).to(torch.bfloat16)
        for i, blk in enumerate(params["lm_blocks"]):
            x, caches[i] = block(blk, x, cfg.lm_heads, cache=caches[i])
        out.append(dense(params["lm_head"],
                         layernorm(params["lm_ln"], x))[:, 0])
    return torch.stack(out, 1)


def florence_forced_steps(params: dict, crops: torch.Tensor,
                          tokens: torch.Tensor, cfg, decode_blocks: bool,
                          prime: bool = True) -> torch.Tensor:
    """The decode steps of Florence's `generate` fed `tokens` [B, L]
    (teacher-forced) on the route in force: the step logits [B, L-2, V]
    of positions 1..L-2. prime=False leaves the cache's position 0 (BOS)
    unwritten (the control)."""
    from embodied_captioning_tpu_torch.models import florence as F
    from embodied_captioning_tpu_torch.models.common import (
        KVCache, block, dense, layernorm, precompute_kv)

    feats = F._encode(params, crops, cfg)
    b, length = tokens.shape
    hd = cfg.width // cfg.heads
    caches = [KVCache.create(b, length, cfg.heads, hd, crops.device)
              for _ in range(cfg.layers)]
    cross_kvs = [precompute_kv(blk["xattn"], feats, cfg.heads)
                 for blk in params["blocks"]]

    def run_token(pos: int) -> torch.Tensor:
        x = (params["tok_emb"][tokens[:, pos].long()][:, None]
             + params["pos_emb"][pos][None, None]).to(torch.bfloat16)
        for i, (blk, ckv) in enumerate(zip(params["blocks"], cross_kvs)):
            x, caches[i] = block(blk, x, cfg.heads, cache=caches[i],
                                 cross_kv=ckv, decode_blocks=decode_blocks)
        return dense(params["head"], layernorm(params["ln"], x))[:, 0]

    if prime:
        run_token(0)
    else:
        caches = [KVCache(c.k, c.v, 1) for c in caches]
    return torch.stack([run_token(pos) for pos in range(1, length - 1)], 1)


@torch.no_grad()
def blip2_full_width(K, frames, dev, smi: str) -> dict:
    """14b: BLIP-2 at Blip2Config() (ViT-L/14 at 224^2, a 768-wide 6-layer
    Q-Former over 32 queries, a 768-wide 12-layer LM) with random weights
    from a generator seeded 0, on VLM_CROPS quadrant crops of phase 3's
    frames: the Q-Former's flash shape against its twin; greedy `generate`
    timed (launches, device busy and idle share), its layout (BOS first,
    PAD after EOS, lengths), and held teacher-forced against the twins'
    route: `generate`'s step logits against the twins' decode of its
    tokens within MAX_LOGPROB_ULPS (the twins' decode without the image
    prefix in its cache must fail that); the plain path's `lm_logits`
    over the kernel path's tokens picks the same token on at least
    MIN_ARGMAX_AGREE of the live steps, and the kernel path's within
    LM_LOGITS_ULPS of it (the kernel path's over other crops must be
    further off); `itc_score` and `itm_score` against the plain path's
    within SCORE_ATOL (the plain path's scores of other crops must be
    further off)."""
    from embodied_captioning_tpu_torch.models import blip2 as B
    from embodied_captioning_tpu_torch.models.tokenizer import (
        EOS_ID, PAD_ID)

    case = qformer_flash_case(K, dev)
    cfg = B.Blip2Config()
    params = B.init_blip2(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    crops = center_crops(frames[:VLM_CROPS // 4], cfg.vision.image_size)
    run = timed_generate(
        "BLIP-2 generate (16 crops, 32 + 30 cache positions)",
        lambda: B.generate(params, crops, None, cfg, DECODE_LEN),
        ("flash_attention", "layernorm", "fused_preprocess",
         "decode_self_block", "decode_mlp"), smi)
    toks, step_logits, lengths = run["out"]
    t = toks.cpu()
    after_eos = torch.cumsum((t == EOS_ID).int(), 1) - (t == EOS_ID).int()
    if (tuple(toks.shape) != (VLM_CROPS, DECODE_LEN)
            or not bool((t[:, 0] == 1).all())
            or bool(((after_eos > 0) & (t != PAD_ID)).any())
            or not torch.equal(lengths.cpu(), (t != PAD_ID).sum(1).int())
            or not bool(torch.isfinite(step_logits.float()).all())):
        raise AssertionError(f"BLIP-2 generate: layout {t[:2]} {lengths}")
    rolled = crops.roll(1, 0)
    with plain_kernels(K):
        tf = B.lm_logits(params, crops, toks, cfg)
        itc_p = B.itc_score(params, crops, toks, cfg)
        itm_p = B.itm_score(params, crops, toks, cfg)
        itc_o = B.itc_score(params, rolled, toks, cfg)
        itm_o = B.itm_score(params, rolled, toks, cfg)
        steps = logprob_ulps(step_logits, blip2_forced_steps(
            params, crops, toks, cfg), toks, 0)
        ctrl = logprob_ulps(step_logits, blip2_forced_steps(
            params, crops, toks, cfg, prime=False), toks, 0)
    agree, n = chosen_agree(tf, toks, 0)
    lk = B.lm_logits(params, crops, toks, cfg)
    ka, _ = chosen_agree(lk, toks, 0)
    full = logprob_ulps(lk[:, :-1], tf[:, :-1], toks, 0)
    full_c = logprob_ulps(B.lm_logits(params, rolled, toks, cfg)[:, :-1],
                          tf[:, :-1], toks, 0)
    err = (lk.float() - tf.float()).abs().max().item()
    itc, itm = B.itc_score(params, crops, toks, cfg), B.itm_score(
        params, crops, toks, cfg)
    itc_e = (itc - itc_p).abs().max().item()
    itm_e = (itm - itm_p).abs().max().item()
    itc_c = (itc - itc_o).abs().max().item()
    itm_c = (itm - itm_o).abs().max().item()
    log(f"  BLIP-2 teacher-forced: generate's step logits against the "
        f"twins' decode of its tokens {steps['max']:.3f} bf16 logit ulps, "
        f"mean {steps['mean']:.3f}, over {steps['n']} live steps (limit "
        f"{MAX_LOGPROB_ULPS}; the twins' decode without the image prefix "
        f"{ctrl['max']:.3f}, mean {ctrl['mean']:.3f}); the twins' lm_logits "
        f"pick the kernel decode's token on {agree:.4f} of {n} live steps "
        f"(the kernels' lm_logits on {ka:.4f}); lm_logits kernels vs twins "
        f"{full['max']:.3f} ulps, mean {full['mean']:.3f}, max_abs_err "
        f"{err:.3e} (limit {LM_LOGITS_ULPS}; the kernels' over other crops "
        f"{full_c['max']:.3f}); itc {itc_e:.3e}, itm {itm_e:.3e} (limit "
        f"{SCORE_ATOL}; against the twins' scores of other crops "
        f"{itc_c:.3e}, {itm_c:.3e})")
    bad = [name for name, fail in (
        ("step logits", steps["max"] > MAX_LOGPROB_ULPS),
        ("the prefix-less control passed", ctrl["max"] <= MAX_LOGPROB_ULPS),
        ("lm_logits agreement", agree < MIN_ARGMAX_AGREE
         or ka < MIN_ARGMAX_AGREE),
        ("lm_logits ulps", full["max"] > LM_LOGITS_ULPS
         or not math.isfinite(err)),
        ("the other crops' lm_logits passed", full_c["max"] <= LM_LOGITS_ULPS),
        ("itc / itm", itc_e > SCORE_ATOL or itm_e > SCORE_ATOL),
        ("the other crops' scores passed",
         itc_c <= SCORE_ATOL or itm_c <= SCORE_ATOL)) if fail]
    if bad:
        raise AssertionError(f"BLIP-2 kernels vs twins: {bad}")
    return dict(counts=run["counts"], ms=run["ms"], busy_us=run["busy_us"],
                flash_case=case, agree=agree)


@torch.no_grad()
def florence_full_width(K, frames, dev, smi: str) -> dict:
    """14c: Florence at FlorenceConfig() (ViT-L/14 at 224^2, a 768-wide
    12-layer decoder with cross-attention over 257 ViT tokens, a cache of
    128) with random weights from a generator seeded 0, on the crops of
    14b: greedy `generate` in both tasks on the block route, the caption
    task also on the route of separate calls and with int8 weights (int8
    cross K/V), each timed with its launches; each held teacher-forced:
    the twins' `florence_logits` over the kernel decode's tokens picks the
    same token on at least MIN_ARGMAX_AGREE of the live steps, and the
    kernel route's decode of those tokens against the twins' within
    MAX_LOGPROB_ULPS (the twins' decode without BOS in its cache, on the
    first run, must fail that)."""
    from embodied_captioning_tpu_torch.models import florence as F
    from embodied_captioning_tpu_torch.models.quantize import quantize_params

    cfg = F.FlorenceConfig()
    params = F.init_florence(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    qparams = quantize_params(params)
    crops = center_crops(frames[:VLM_CROPS // 4], cfg.vision.image_size)
    blocks = ("flash_attention", "layernorm", "fused_preprocess",
              "decode_self_block", "decode_cross_block", "decode_mlp")
    calls = ("flash_attention", "layernorm", "fused_preprocess",
             "decode_self_attention", "decode_cross_attention", "decode_mlp")
    counts = collections.Counter()
    out, bad = {}, []
    for name, p, task, route, need in (
            ("caption", params, F.TASK_CAPTION, True, blocks),
            ("od", params, F.TASK_OD, True, blocks),
            ("caption, separate calls", params, F.TASK_CAPTION, False, calls),
            ("od, int8", qparams, F.TASK_OD, True, blocks)):
        run = timed_generate(
            f"Florence generate {name} (16 crops, cache 128)",
            lambda: F.generate(p, crops, cfg, task=task, decode_blocks=route),
            need, smi)
        toks, lengths = run["out"]
        if (tuple(toks.shape) != (VLM_CROPS, cfg.max_seq)
                or not bool((toks[:, 1] == cfg.task_offset + task).all())
                or int(toks.max()) >= cfg.vocab_size):
            raise AssertionError(f"Florence {name}: tokens {toks[:2]}")
        kern = florence_forced_steps(p, crops, toks, cfg, route)
        live = live_positions(toks, 1)
        ka = int(((kern.float().argmax(-1) == toks[:, 2:].long())
                  & live).sum()) / max(int(live.sum()), 1)
        with plain_kernels(K):
            tf = F.florence_logits(p, crops, toks, cfg)
            steps = logprob_ulps(kern, florence_forced_steps(
                p, crops, toks, cfg, route), toks, 1)
            ctrl = None if out else logprob_ulps(kern, florence_forced_steps(
                p, crops, toks, cfg, route, prime=False), toks, 1)
        del kern
        agree, n = chosen_agree(tf, toks, 1)
        log(f"  Florence {name} teacher-forced: the kernel route's decode of "
            f"the tokens against the twins' {steps['max']:.3f} bf16 logit "
            f"ulps, mean {steps['mean']:.3f}, over {steps['n']} live steps "
            f"(limit {MAX_LOGPROB_ULPS}"
            + ("" if ctrl is None else
               f"; the twins' decode without BOS {ctrl['max']:.3f}, mean "
               f"{ctrl['mean']:.3f}")
            + f"), its argmax the decoded token on {ka:.4f}; the twins' "
            f"florence_logits pick the kernel decode's token on {agree:.4f} "
            f"of {n} live steps")
        if agree < MIN_ARGMAX_AGREE or steps["max"] > MAX_LOGPROB_ULPS:
            bad.append(name)
        if ctrl is not None and ctrl["max"] <= MAX_LOGPROB_ULPS:
            bad.append(f"{name}: the control without BOS passed")
        counts.update(run["counts"])
        out[name] = dict(ms=run["ms"], busy_us=run["busy_us"], agree=agree,
                         ulps=steps["max"])
    if bad:
        raise AssertionError(f"Florence kernels vs twins: {bad}")
    return dict(counts=dict(counts), runs=out)


@torch.no_grad()
def consensus_lm_card_vs_cpu(dev, smi: str) -> dict:
    """14d: `ConsensusLM` at LMConfig() (256 wide, 4 layers, a context of
    256: float32 residual rows through the LayerNorm kernel) with random
    weights from a generator seeded 0: each caption set's scores on the
    card against the same weights on the CPU within LM_SCORE_ATOL, the
    same pick where the best two scores are further apart than twice
    that; `choose` timed, with its launches."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.models import llm as L

    cfg = L.LMConfig()
    lm = L.ConsensusLM(cfg, seed=0, device=dev)
    lm_cpu = L.ConsensusLM(cfg, params=to_device(lm.params, "cpu"),
                           device="cpu")
    lm.choose(LM_SETS[0])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    picks = [lm.choose(s) for s in LM_SETS]
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    require_launches("ConsensusLM", counts, ("layernorm",))
    worst = 0.0
    for s, pick in zip(LM_SETS, picks):
        a, b = lm.scores(s), lm_cpu.scores(s)
        worst = max(worst, float(np.abs(a - b).max()))
        top = np.sort(b)[::-1]
        if top[0] - top[1] > 2 * LM_SCORE_ATOL and \
                pick != s[int(np.argmax(b))]:
            raise AssertionError(f"ConsensusLM picks {pick} on the card, "
                                 f"{s[int(np.argmax(b))]} on the CPU")
    log(f"  ConsensusLM (LMConfig(), {len(LM_SETS)} caption sets) on {smi}: "
        f"{dt * 1e3 / len(LM_SETS):.1f} ms a choose; scores card vs CPU "
        f"max_abs_err {worst:.3e} (limit {LM_SCORE_ATOL}); launches {counts}")
    if worst > LM_SCORE_ATOL:
        raise AssertionError("ConsensusLM scores card vs CPU")
    return dict(counts=counts, ms=dt * 1e3 / len(LM_SETS), err=worst)


def phase14(K, frames, rows: dict, dev, smi: str, tmp: str) -> dict:
    """Phase 14 in order, its Q-Former flash case added to the flash
    attention row's cases; returns each path's launch counts."""
    t14 = time.perf_counter()
    ev = serving_evals(dev, smi, tmp)
    torch.cuda.empty_cache()
    b2 = blip2_full_width(K, frames, dev, smi)
    rows["flash_attention"].setdefault("cases", []).append(b2["flash_case"])
    torch.cuda.empty_cache()
    fl = florence_full_width(K, frames, dev, smi)
    torch.cuda.empty_cache()
    lm = consensus_lm_card_vs_cpu(dev, smi)
    log(f"  phase 14 in {time.perf_counter() - t14:.1f} s")
    return dict(eval=ev["counts"], blip2=b2["counts"],
                florence=fl["counts"], lm=lm["counts"])


# ---------------------------------------------------------------------------
# phase 15: the parallel layer (MoE captioner, myppo, perceive_sharded,
# pipeline and ring attention, the checkpoint manager)
# ---------------------------------------------------------------------------

MOE_EXPERTS = 8                # 15a-b: experts a MoE text block
MOE_SHAPES = ((ROWS, 1), (8, 77))  # 15a: decode rows, training rows
# 15a: bf16 expert products against float32 ones on the same routing, the
# largest error over the largest |output| (one bf16 rounding of each
# product's operands and of the combine's: ~2**-8 relative each)
MOE_BF16_REL = 2e-2
MOE_LEAVES = ("fc_w", "fc_b", "proj_w", "proj_b")
MOE_TRAIN_BATCH = 8            # 15b: the fine-tune's batch
MOE_TRAIN_STEPS = 2
DDPPO_UPDATES = 1              # 15c: updates of the full-width trainers
# 15d: vit_features_seqparallel and pipeline_vit_features against
# vit_features at ViT-L (24 blocks on a bf16 stream): the JAX tests'
# elementwise limits (test_seq_parallel 3e-2 + 3e-2 |x|,
# test_pipeline_vit_features 0.05 + 0.05 |x|) were set at 2 and 8 blocks;
# at 24 the port's own vit_features moves some elements past them when
# only the batch is split into microbatches (0.094 of |x| <= 4.3 on the
# CPU at 4 crops, 1 element of 1.05M past 0.05), so they are held on
# SP_SHARE of the elements, with the correlation bar of
# test_pipeline_vit_features
SP_SHARE = 0.999
SP_CORR = 0.9999


class RoutingTape:
    """Records the dispatch and combine of every `moe._route_group` call
    of one run (`record`), then hands them in order to the calls of
    another (`replay`), counting the tokens whose own routing there would
    have differed: the plain path decodes teacher-forced with the kernel
    path's routing, so a routing flip near a tie (a discrete jump, not a
    kernel's error) stays out of the ulp comparison."""

    def __init__(self):
        self.calls, self.flips, self.tokens = [], 0, 0

    def _patched(self, fn):
        import contextlib

        from embodied_captioning_tpu_torch.parallel import moe as MOE

        @contextlib.contextmanager
        def ctx():
            orig = MOE._route_group
            MOE._route_group = lambda *a: fn(orig, *a)
            try:
                yield self
            finally:
                MOE._route_group = orig
        return ctx()

    def record(self):
        def rec(orig, *a):
            out = orig(*a)
            self.calls.append(out)
            return out
        return self._patched(rec)

    def replay(self):
        it = iter(list(self.calls))

        def rep(orig, *a):
            disp, comb = next(it)
            own = orig(*a)[0]
            # the experts a token takes (not its slots, which a flip
            # before it in the queue moves too)
            self.flips += int((own.sum(-1) != disp.sum(-1)).any(-1).sum())
            self.tokens += disp.shape[0] * disp.shape[1]
            return disp, comb
        return self._patched(rep)


def moe_layer_checks(dev, smi: str) -> None:
    """15a: `moe_mlp` at E=MOE_EXPERTS, top-2, width 768, hidden 3072 (the
    large preset's text MLP) at decode rows and training rows: the card's
    bf16 expert products against the float32 ones on the card within
    MOE_BF16_REL of the largest output, twice for equal bits, the routing
    of the card's gate probabilities on the card equal to the CPU's, ms a
    call beside the float32 path's."""
    from embodied_captioning_tpu_torch.parallel import moe as MOE

    g = torch.Generator(device=dev).manual_seed(15)
    p = MOE.moe_init(g, 768, 3072, MOE_EXPERTS, dev)
    for b, t in MOE_SHAPES:
        x = torch.randn(b, t, 768, generator=g, device=dev).to(torch.bfloat16)
        got, probs = MOE.moe_mlp(p, x, return_gate_probs=True)
        if not torch.equal(got, MOE.moe_mlp(p, x)):
            raise AssertionError(f"moe_mlp {[b, t]}: two runs differ")
        f32 = MOE.moe_mlp(p, x, expert_dtype=torch.float32)
        err = (got.float() - f32.float()).abs().max().item()
        scale = f32.float().abs().max().item()
        n = b * t
        cap = MOE.capacity(2, n, MOE_EXPERTS, 1.25)
        d_card, c_card = MOE._route_group(probs[None], 2, cap)
        d_cpu, c_cpu = MOE._route_group(probs[None].cpu(), 2, cap)
        same = (torch.equal(d_card.cpu(), d_cpu)
                and torch.equal(c_card.cpu(), c_cpu))
        kept = int(d_card.sum().item())
        ms = time_ms(lambda: MOE.moe_mlp(p, x), 10, 2)
        ms32 = time_ms(lambda: MOE.moe_mlp(p, x, expert_dtype=torch.float32),
                       10, 2)
        log(f"  moe_mlp [{b}, {t}, 768] E={MOE_EXPERTS} top-2 capacity "
            f"{cap}: bf16 against float32 products {err:.3e} (largest "
            f"|output| {scale:.3f}, limit {MOE_BF16_REL} of it); routing "
            f"card == CPU {same}; {kept} of {2 * n} routes kept; "
            f"{ms * 1e3:.1f} us a call (float32 products {ms32 * 1e3:.1f}) "
            f"on {smi}")
        if not same or err > MOE_BF16_REL * scale or not math.isfinite(err):
            raise AssertionError(f"moe_mlp {[b, t]} failed")


def _moe_captioner_cfg():
    import dataclasses

    from embodied_captioning_tpu_torch.config import CaptionerConfig

    c = CaptionerConfig.large()
    return dataclasses.replace(c, text=dataclasses.replace(
        c.text, moe_experts=MOE_EXPERTS))


@torch.no_grad()
def moe_generate_full_width(K, frames, dev, smi: str) -> dict:
    """15b: the large preset's captioner with MOE_EXPERTS experts in each
    of its 12 text blocks, random weights from a generator seeded 0,
    int8 (quantize_params; the 768 x 8 gate stays float): greedy
    `generate` on 64 quadrant crops of phase 3's frames, timed with its
    launches (each text block's self-attention on the self block, its MLP
    never on the decode MLP: per step 24 self blocks, 12 cross blocks, 12
    decode MLPs), device busy and idle share, peak memory; then held
    teacher-forced against the plain path as phase 3 is: with each path
    routing on its own (argmax agreement and ViT cosine), and with the
    kernel path's routing handed to the plain path (phase 3's whole gate,
    MAX_LOGPROB_ULPS included)."""
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.models.quantize import (
        QuantizedArray, quantize_params)

    ccfg = _moe_captioner_cfg()
    cp = quantize_params(init_captioner(
        torch.Generator(device=dev).manual_seed(0), ccfg, dev))
    moe0 = cp["text_blocks"][0]["moe"]
    if isinstance(moe0["gate"]["w"], QuantizedArray) or any(
            isinstance(moe0[k], QuantizedArray) for k in MOE_LEAVES):
        raise AssertionError("the MoE leaves were quantized")
    crops = center_crops(frames[:ROWS // 4], ccfg.vision.image_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = timed_generate(
        f"MoE captioner generate ({ROWS} crops, large preset, "
        f"{MOE_EXPERTS} experts)", lambda: CAP.generate(cp, crops, ccfg),
        ("flash_attention", "layernorm", "fused_preprocess",
         "decode_self_block", "decode_cross_block", "decode_mlp"), smi)
    peak = torch.cuda.max_memory_allocated()
    c = run["counts"]
    t = ccfg.text
    steps = c["decode_cross_block"] // t.cross_layers
    if (c["decode_mlp"] != steps * t.cross_layers
            or c["decode_self_block"] != steps * (t.layers + t.cross_layers)
            or c["decode_cross_block"] != steps * t.cross_layers
            or c["decode_self_attention"] or c["decode_cross_attention"]):
        raise AssertionError(f"MoE generate's decode launches {c}")
    free = teacher_forced(cp, crops, ccfg, K)
    handed = teacher_forced(cp, crops, ccfg, K, tape=RoutingTape())
    log(f"  MoE generate: {steps} decode steps, {run['ms']:.1f} ms a batch, "
        f"peak device memory {peak / 2**30:.2f} GiB on {smi}; teacher-forced "
        f"against the plain path, routing free: argmax agreement "
        f"{free['agree']:.4f} of {free['n']} (limit {MIN_ARGMAX_AGREE}), "
        f"log-prob {free['lp_ulps']:.3f} ulps, mean {free['mean_ulps']:.3f}; "
        f"routing handed: agreement {handed['agree']:.4f}, log-prob "
        f"{handed['lp_ulps']:.3f} ulps (limit {MAX_LOGPROB_ULPS}), mean "
        f"{handed['mean_ulps']:.3f}, {handed['flips']} of "
        f"{handed['routed']} token routings the plain path would have "
        f"taken otherwise; ViT cosine min {handed['img_cos']:.7f} (limit "
        f"{MIN_IMG_COSINE})")
    if (free["agree"] < MIN_ARGMAX_AGREE or free["img_cos"] <= MIN_IMG_COSINE
            or handed["agree"] < MIN_ARGMAX_AGREE
            or handed["lp_ulps"] > MAX_LOGPROB_ULPS
            or handed["img_cos"] <= MIN_IMG_COSINE):
        raise AssertionError("MoE captioner: kernel path vs plain path")
    return dict(counts=c, ms=run["ms"], busy_us=run["busy_us"],
                peak_bytes=peak, steps=steps, free=free, handed=handed)


def moe_train_full_width(dev, smi: str) -> dict:
    """15b: the same MoE captioner (float) at the fine-tune's batch: the
    gradients of one batch (each text block's experts that took a token
    have non-zero, finite gradients, the others zero; the gate's non-zero),
    then MOE_TRAIN_STEPS timed `train_step`s: finite losses, every expert
    leaf moved, the LayerNorm forward and backward and the preprocess
    launched, ms a step, peak memory. An expert that took only tokens at
    padding positions (no loss reads them) gets a zero gradient too."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.models.captioner import init_captioner
    from embodied_captioning_tpu_torch.train import captioner_train as TT

    ccfg = _moe_captioner_cfg()
    params = init_captioner(torch.Generator(device=dev).manual_seed(0), ccfg,
                            dev)
    batch = finetune_batch(ccfg, MOE_TRAIN_BATCH, 3, dev)
    tape = RoutingTape()
    with tape.record():
        grads, loss, _ = TT.loss_and_grads(params, *batch, ccfg, FT_TRIPLET)
    routed, graded = [], []
    for i, (disp, _) in enumerate(tape.calls):
        took = disp.sum(dim=(0, 1, 3)) > 0                 # [E]
        gm = grads["text_blocks"][i]["moe"]
        nz = torch.stack([gm["fc_w"][e].abs().sum() > 0
                          for e in range(MOE_EXPERTS)])
        if (bool((nz & ~took).any()) or int(nz.sum()) < 2
                or not bool(torch.isfinite(gm["fc_w"]).all())
                or not bool(gm["gate"]["w"].abs().sum() > 0)):
            raise AssertionError(f"MoE gradients of text block {i}: routed "
                                 f"{took.tolist()}, non-zero {nz.tolist()}")
        routed.append(int(took.sum()))
        graded.append(int(nz.sum()))
    state = TT.create_train_state(params)
    before = [state.params["text_blocks"][0]["moe"][k].clone()
              for k in MOE_LEAVES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    times, losses = [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, aux = TT.train_step(state, *batch, ccfg,
                                   triplet_weight=FT_TRIPLET)
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    moved = [not torch.equal(a, state.params["text_blocks"][0]["moe"][k])
             for a, k in zip(before, MOE_LEAVES)]
    log(f"  MoE train_step, large preset, batch {MOE_TRAIN_BATCH}: "
        + ", ".join(f"{x * 1e3:.1f}" for x in times) + f" ms a step on {smi};"
        f" peak device memory {peak / 2**30:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f" (first gradient's loss "
        f"{float(loss):.4f}); experts routed a text block {routed}, with "
        f"a non-zero gradient {graded}; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    if (not all(math.isfinite(x) for x in losses) or not all(moved)):
        raise AssertionError(f"MoE train_step: {losses} {moved}")
    require_launches("MoE train_step", counts,
                     ("layernorm", "layernorm_bwd", "fused_preprocess"))
    return dict(counts=counts, ms=times[-1] * 1e3, peak_bytes=peak)


def myppo_full_width(serving: tuple, dev, smi: str, tmp: str) -> dict:
    """15c, under the world-1 NCCL group: `goalexplorationbaseline-v0` and
    `myppo` trained side by side at phase 9's configuration (the serving
    perception, 16 envs of seeded scenes at 1280^2, windows of
    TRAIN_WINDOW steps, fused), DDPPO_UPDATES updates of TRAIN_DECISIONS
    decisions: the parameters after each update equal bit for bit, the
    launches, ms an update; the resume state under ddppo/ at the last
    update index, restored equal; then `run_exp --trainer myppo --mode
    train` at the tiny preset in process, and the SIGTERM path at tiny
    (stops after one update, resume state written, ECAP_REQUEUE_CMD run,
    a fresh trainer resumes at the index)."""
    import contextlib
    import io
    import signal

    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch import run_exp
    from embodied_captioning_tpu_torch.agents.ddppo import (
        DistributedPPOTrainer)
    from embodied_captioning_tpu_torch.agents.goal_exploration import (
        GoalExplorationTrainer)
    from embodied_captioning_tpu_torch.agents.ppo import tree_leaves
    from embodied_captioning_tpu_torch.config import apply_dotlist, load_config
    from embodied_captioning_tpu_torch.perception import Perceiver
    from embodied_captioning_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    scfg, params, _ = serving
    snaps, out = {}, {}
    for name, cls in (("v0", GoalExplorationTrainer),
                      ("myppo", DistributedPPOTrainer)):
        cfg = apply_dotlist(scfg, [
            "sim.scene_seed=100", f"ppo.num_global_steps={TRAIN_WINDOW}",
            f"runtime.checkpoint_dir={tmp}/{name}"])
        tr = cls(cfg, device=dev, perceiver=Perceiver(cfg, params=params,
                                                      device=dev))
        snaps[name] = []
        update = tr._ppo_update

        def recorded(rollout, _u=update, _s=snaps[name]):
            state, m = _u(rollout)
            _s.append([x.clone() for x in tree_leaves(state.params)])
            return state, m

        tr._ppo_update = recorded
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        tr.train(DDPPO_UPDATES, TRAIN_DECISIONS, fused=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name] = dict(counts=dict(K.launches),
                         ms=dt / DDPPO_UPDATES * 1e3)
        log(f"  {name} train (fused): {DDPPO_UPDATES} updates x "
            f"{TRAIN_DECISIONS} decisions x {TRAIN_WINDOW} steps x "
            f"{tr.envs.num_envs} envs, {dt / DDPPO_UPDATES * 1e3:.1f} ms an "
            f"update on {smi}; launches {out[name]['counts']}")
        if name == "myppo":
            mgr = CheckpointManager(f"{tmp}/myppo/ddppo")
            back = mgr.restore(tr.ppo_state)
            if (mgr.latest_step() != DDPPO_UPDATES
                    or tr._update_idx != DDPPO_UPDATES or not all(
                        torch.equal(a, b) if torch.is_tensor(a) else a == b
                        for a, b in zip(tree_leaves(back),
                                        tree_leaves(tr.ppo_state)))):
                raise AssertionError("myppo's resume state")
        tr.envs.close()
        del tr
        torch.cuda.empty_cache()
    same = [all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(snaps["v0"], snaps["myppo"])]
    log(f"  myppo against goalexplorationbaseline-v0, parameters equal bit "
        f"for bit after each update: {same}")
    if len(same) != DDPPO_UPDATES or not all(same):
        raise AssertionError("myppo's updates differ from v0's")
    require_launches("myppo train", out["myppo"]["counts"], (
        "raycast_minargmin", "fused_preprocess", "flash_attention",
        "layernorm", "decode_self_block", "decode_cross_block",
        "decode_mlp"))

    tiny = ["--trainer", "myppo", "--mode", "train", "--preset", "tiny",
            "--steps", "2", "ppo.num_global_steps=2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_exp.main(tiny + [f"runtime.checkpoint_dir={tmp}/run_exp"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  run_exp --trainer myppo --mode train (tiny) on the card: rc {rc}"
        f", {line}")
    if rc != 0 or line["updates"] != 2 or CheckpointManager(
            f"{tmp}/run_exp/ddppo").latest_step() != 2:
        raise AssertionError("run_exp --trainer myppo failed")

    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=4", "ppo.num_global_steps=1",
        f"runtime.checkpoint_dir={tmp}/sigterm"])
    marker = f"{tmp}/requeued"
    old_handler = signal.getsignal(signal.SIGTERM)
    os.environ["ECAP_REQUEUE_CMD"] = f"touch {marker}"
    try:
        tr = DistributedPPOTrainer(cfg, with_perception=False, device=dev)
        os.kill(os.getpid(), signal.SIGTERM)
        metrics = tr.train(50, 2)
        idx = tr._update_idx
        saved = tr.ckpt_mgr.latest_step()
        tr.envs.close()
        tr2 = DistributedPPOTrainer(cfg, with_perception=False, device=dev)
        resumed = tr2._update_idx
        tr2.envs.close()
    finally:
        os.environ.pop("ECAP_REQUEUE_CMD", None)
        signal.signal(signal.SIGTERM, old_handler)
    log(f"  myppo SIGTERM (tiny): stopped after {len(metrics)} update(s) at "
        f"index {idx}, resume state at {saved}, requeue command run "
        f"{os.path.exists(marker)}, a fresh trainer resumed at {resumed}")
    if not (len(metrics) == 1 and idx == saved == resumed == 1
            and os.path.exists(marker)):
        raise AssertionError("myppo's SIGTERM path")
    return dict(counts=out["myppo"]["counts"], ms=out["myppo"]["ms"],
                v0_ms=out["v0"]["ms"])


@torch.no_grad()
def parallel_world_one(serving: tuple, frames, dev, smi: str) -> dict:
    """15d, at world size 1 on NCCL: `perceive_sharded` against `perceive`
    on phase 3's frames at the serving configuration, bit for bit;
    `pipeline_vit_features` (1 stage, 4 microbatches) and
    `vit_features_seqparallel` against `vit_features` at ViT-L on 64 crops
    (the pipeline also bit for bit against `vit_features` of each
    microbatch); expert-parallel `moe_mlp` against the plain call."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.models.vit import vit_features
    from embodied_captioning_tpu_torch.ops.image import preprocess_for_vit
    from embodied_captioning_tpu_torch.parallel import moe as MOE
    from embodied_captioning_tpu_torch.parallel.mesh import make_mesh
    from embodied_captioning_tpu_torch.parallel.pipeline import (
        pipeline_vit_features)
    from embodied_captioning_tpu_torch.parallel.sequence import (
        vit_features_seqparallel)
    from embodied_captioning_tpu_torch.perception import (
        perceive, perceive_sharded)

    cfg, params, _ = serving
    want = perceive(params, frames, cfg)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    got = perceive_sharded(params, frames, cfg, make_mesh((1,), ("data",)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(K.launches)
    fields = ("boxes", "classes", "scores", "valid", "masks", "embeddings")
    same = all(torch.equal(getattr(got.detections, f),
                           getattr(want.detections, f)) for f in fields) and \
        all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    log(f"  perceive_sharded ({frames.shape[0]} frames, data axis 1): "
        f"{ms:.1f} ms on {smi}; equal to perceive bit for bit: {same}")
    if not same:
        raise AssertionError("perceive_sharded differs from perceive")

    vision, vcfg = params.captioner["vision"], cfg.captioner.vision
    crops = center_crops(frames[:ROWS // 4], vcfg.image_size)
    toks = preprocess_for_vit(crops, vcfg.image_size, vcfg.patch_size)
    whole = vit_features(vision, toks, vcfg).float()
    per_mb = torch.cat([vit_features(vision, t, vcfg)
                        for t in toks.chunk(4)]).float()
    t0 = time.perf_counter()
    pipe = pipeline_vit_features(vision, toks, vcfg,
                                 make_mesh((1,), ("pipe",)), microbatches=4)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seq = vit_features_seqparallel(vision, toks, vcfg,
                                   make_mesh((1,), ("seq",)))
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    spread = (per_mb - whole).abs().max().item()
    rows = {}
    for name, x, tol in (("pipeline_vit_features", pipe.float(), 0.05),
                         ("vit_features_seqparallel", seq.float(), 3e-2)):
        err = (x - whole).abs()
        share = (err <= tol + tol * whole.abs()).float().mean().item()
        corr = float(np.corrcoef(x.cpu().numpy().ravel(),
                                 whole.cpu().numpy().ravel())[0, 1])
        rows[name] = dict(max_err=err.max().item(), share=share, corr=corr)
    pipe_exact = torch.equal(pipe.float(), per_mb)
    log(f"  ViT-L on {crops.shape[0]} crops: vit_features of 4 microbatches "
        f"against the whole batch {spread:.4f}; pipeline_vit_features "
        f"{pipe_ms:.1f} ms, equal to the microbatches' bit for bit "
        f"{pipe_exact}; vit_features_seqparallel {seq_ms:.1f} ms; against "
        f"the whole batch: " + "; ".join(
            f"{n} max {r['max_err']:.4f}, within the JAX test's limit "
            f"{r['share']:.6f} of elements, corr {r['corr']:.7f}"
            for n, r in rows.items()) + f" (limits {SP_SHARE}, {SP_CORR})"
        f" on {smi}")
    if not pipe_exact or any(r["share"] < SP_SHARE or r["corr"] < SP_CORR
                             for r in rows.values()):
        raise AssertionError("pipeline / sequence-parallel ViT-L")

    g = torch.Generator(device=dev).manual_seed(16)
    p = MOE.moe_init(g, 768, 3072, MOE_EXPERTS, dev)
    x = torch.randn(ROWS, 1, 768, generator=g, device=dev).to(torch.bfloat16)
    group = torch.distributed.group.WORLD
    ep = MOE.moe_mlp(MOE.shard_experts(p, group), x, group=group)
    if not torch.equal(ep, MOE.moe_mlp(p, x)):
        raise AssertionError("expert-parallel moe_mlp (world 1)")
    log("  expert-parallel moe_mlp (world 1) equal to the plain call")
    return dict(counts=counts, ms=ms)


def phase15(K, frames, dev, smi: str, tmp: str) -> dict:
    """Phase 15 in order under a world-1 NCCL process group (a file://
    store in `tmp`), destroyed at the end; returns each path's launch
    counts and readings."""
    import torch.distributed as dist

    t15 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store",
                            world_size=1, rank=0)
    try:
        moe_layer_checks(dev, smi)
        gen = moe_generate_full_width(K, frames, dev, smi)
        torch.cuda.empty_cache()
        train = moe_train_full_width(dev, smi)
        torch.cuda.empty_cache()
        serving = serving_perception(dev)
        ppo = myppo_full_width(serving, dev, smi, tmp)
        torch.cuda.empty_cache()
        par = parallel_world_one(serving, frames, dev, smi)
        del serving
    finally:
        dist.destroy_process_group()
    counts = dict(moe=gen["counts"], moe_train=train["counts"],
                  myppo=ppo["counts"], parallel=par["counts"])
    log("  phase 15 launches by kernel: " + json.dumps(
        {n: {k: c[n] for k, c in counts.items()} for n in gen["counts"]}))
    missing = [n for n in gen["counts"]
               if n not in ("decode_self_attention", "decode_cross_attention")
               and not any(c[n] for c in counts.values())]
    if missing:
        raise AssertionError(f"phase 15 launched no {missing}")
    log(f"  phase 15 in {time.perf_counter() - t15:.1f} s")
    return dict(counts=counts, gen=gen, train=train, ppo=ppo, par=par)


# ---------------------------------------------------------------------------
# phase 16: the tensor-parallel captioner (forward and the DP x TP train
# step) and the replay path (Viz-v0, Viz-v1, replay_exp)
# ---------------------------------------------------------------------------

TP_PRESET = "large"            # 16a-b: the captioner's preset
TP_BATCH = 8                   # 16a-b: the fine-tune's batch
TP_SEED = 16                   # 16a-b: the captioner's seeded weights
TP_LR = 1e-4                   # train_step's default step size
TP_RANKS = 2                   # 16b: the "model" axis, two processes a card
# 16b against the one-process calls on the card, tests/test_torch_tp.py's
# limits: tests/test_tp.py's on the forward (embeddings within rtol = atol
# = 2e-2, logits correlation > 0.999, argmax agreement > 0.99 on the
# confident half of the rows), the loss within 2e-2 relative, the update
# by update_gaps: the decay estimate within 2e-3 (the CPU test's), moved
# alike >= 0.96: 16b read 0.98072 on an H100 80GB HBM3 at 700 W (PERF.md
# §6), the CPU test's 2 + 2 + 2 layers 0.990; the leaves whose gradient is
# rounding noise at random weights move either way (the attention k
# biases, whose gradient is 0 in exact arithmetic; the multimodal
# cross-attention's q and k over near-equal pooled tokens), and the large
# preset has more of them; the faults the CPU test's mutations showed read
# 0.942 and 0.783
TP_EMB_TOL = 2e-2
TP_CORR = 0.999
TP_ARGMAX = 0.99
TP_LOSS_RTOL = 2e-2
TP_AGREE, TP_DECAY_ATOL = 0.96, 2e-3
TP_FLASH = (TP_BATCH, 8, 257, 64)   # ViT-L's 16 heads cut in two
REPLAY_PRESET = "large"        # 16c: replay_exp --preset
REPLAY_FRAMES = 500            # 16c: BASELINE.md configuration (2)
# 16c: the seeded random detector finds no box at the large preset, so
# SLOTS slots a frame are captioned valid or not (the serving
# configuration's settings, `serving_perception`)
REPLAY_OVERRIDES = (f"runtime.caption_slots_per_frame={SLOTS}",
                    "runtime.caption_invalid_slots=true")
VIZ_STEPS = 3                  # 16c: Viz-v1 steps after its reset


def tp_world_one(frames, dev, smi: str, tmp: str) -> dict:
    """16a, under a world-1 NCCL group: the large preset's captioner with a
    (1, 1) mesh against the mesh-less calls, bit for bit: `forward` and
    one `train_step` at TP_BATCH on phase 3's crops. Returns the
    mesh-less forward's outputs and step (loss, leaves before and after)
    on the host, for 16b."""
    import torch.distributed as dist

    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.parallel.mesh import make_mesh
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import tree_leaves

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl16",
                            world_size=1, rank=0)
    try:
        cfg = getattr(CaptionerConfig, TP_PRESET)()
        params = CAP.init_captioner(
            torch.Generator(device=dev).manual_seed(TP_SEED), cfg, dev)
        # the quadrant crops of phase 3's first TP_BATCH / 4 frames
        batch = [center_crops(frames[:TP_BATCH // 4], cfg.vision.image_size)
                 ] + finetune_batch(cfg, TP_BATCH, 3, dev)[1:]
        torch.save([t.cpu() for t in batch], f"{tmp}/tp_batch.pt")
        mesh = make_mesh((1, 1))
        with torch.no_grad():
            f0 = CAP.forward(params, *batch[:2], cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f1 = CAP.forward(params, *batch[:2], cfg, mesh)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
        kw = dict(lr=TP_LR, triplet_weight=FT_TRIPLET)
        s0, a0 = TT.train_step(TT.create_train_state(params), *batch, cfg,
                               **kw)
        after = [t.cpu() for t in tree_leaves(s0.params)]
        del s0
        t0 = time.perf_counter()
        s1, a1 = TT.train_step(TT.create_train_state(params), *batch, cfg,
                               mesh=mesh, **kw)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        same = dict(
            forward=all(torch.equal(a, b) for a, b in zip(f0, f1)),
            loss=all(torch.equal(a0[k], a1[k]) for k in a0),
            params=all(torch.equal(a.cpu(), b) for a, b in zip(
                tree_leaves(s1.params), after)))
        log(f"  16a: {TP_PRESET} preset, batch {TP_BATCH}, a (1, 1) mesh "
            f"against "
            f"the mesh-less calls, equal bit for bit: {same}; forward "
            f"{fwd_ms:.1f} ms, train_step {step_ms:.1f} ms (its first) on "
            f"{smi}; loss {float(a0['loss']):.4f}")
        if not all(same.values()):
            raise AssertionError(f"16a: the (1, 1) mesh differs: {same}")
        out = dict(forward=[t.float().cpu() for t in f0],
                   loss=float(a0["loss"]),
                   before=[t.cpu() for t in tree_leaves(params)],
                   after=after, fwd_ms=fwd_ms, step_ms=step_ms)
        del params, s1, f0, f1
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, tmp: str, device: str) -> None:
    """16b's process `rank` of TP_RANKS on the one card `device`, in a gloo
    group over a file:// store: the large preset's captioner (TP_SEED) cut by
    `shard_params` over a (1, TP_RANKS) mesh; the flash kernel at the
    local head count against its twin; two TP `forward`s (the second
    timed); two DP1 x TP2 `train_step`s (the first's updated leaves and
    loss saved; the second timed). Saves its readings to
    `tmp/tp_rank{rank}.pt`."""
    import datetime

    import torch.distributed as dist

    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.config import CaptionerConfig
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.parallel import mesh as M
    from embodied_captioning_tpu_torch.train import captioner_train as TT
    from embodied_captioning_tpu_torch.train.optim import (
        tree_leaves, tree_map_with_path)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/tp_store",
                            world_size=TP_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = getattr(CaptionerConfig, TP_PRESET)()
        mesh = M.make_mesh((1, TP_RANKS))
        params = CAP.init_captioner(
            torch.Generator(device=dev).manual_seed(TP_SEED), cfg, dev)
        sp = M.shard_params(params, mesh)
        del params
        batch = [t.to(dev) for t in torch.load(f"{tmp}/tp_batch.pt")]
        out = {}
        g = torch.Generator(device=dev).manual_seed(rank)
        q, k, v = (torch.randn(*TP_FLASH, generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        got = K.flash_attention(q, k, v)
        out["flash_err"] = (got.float() - K.flash_attention_plain(
            q, k, v).float()).abs().max().item()
        out["flash_equal"] = torch.equal(got, K.flash_attention(q, k, v))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            CAP.forward(sp, *batch[:2], cfg, mesh)
            torch.cuda.synchronize()
            K.reset_launches()
            M.reset_host_copies()
            t0 = time.perf_counter()
            fwd = CAP.forward(sp, *batch[:2], cfg, mesh)
            torch.cuda.synchronize()
        out["fwd_ms"] = (time.perf_counter() - t0) * 1e3
        out["fwd_counts"] = dict(K.launches)
        out["fwd_copies"] = dict(M.host_copies)
        out["fwd_peak"] = torch.cuda.max_memory_allocated()
        if rank == 0:
            out["forward"] = [t.float().cpu() for t in fwd]
        del fwd
        kw = dict(lr=TP_LR, triplet_weight=FT_TRIPLET, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        state, aux = TT.train_step(TT.create_train_state(sp), *batch, cfg,
                                   **kw)
        del sp
        out["loss"] = float(aux["loss"])
        out["leaves"] = [t.cpu() for t in tree_leaves(state.params)]
        out["cut"] = CAP.tp_cut_leaves(state.params, cfg, mesh)
        dims = tree_map_with_path(
            lambda p, t: M.partition_spec_for(
                "/".join(map(str, p)), t, True).index("model")
            if "model" in M.partition_spec_for("/".join(map(str, p)), t,
                                               True) else -1,
            state.params)
        out["dims"] = tree_leaves(dims)
        torch.cuda.synchronize()
        K.reset_launches()
        M.reset_host_copies()
        t0 = time.perf_counter()
        state, aux = TT.train_step(state, *batch, cfg, **kw)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_counts"] = dict(K.launches)
        out["step_copies"] = dict(M.host_copies)
        out["step_peak"] = torch.cuda.max_memory_allocated()
        out["finite"] = bool(math.isfinite(float(aux["loss"])))
        torch.save(out, f"{tmp}/tp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_two_ranks(ref: dict, dev, tmp: str, smi: str) -> dict:
    """16b: TP_RANKS processes on the one card (`tp_rank`, in a gloo group:
    NCCL refuses two ranks on a device); their forward held to 16a's
    one-process forward, their first step's loss and reassembled update
    to 16a's step; readings printed per rank."""
    import torch.multiprocessing as mp

    from embodied_captioning_tpu_torch.train.optim import update_gaps

    t0 = time.perf_counter()
    mp.spawn(tp_rank, args=(tmp, str(dev)), nprocs=TP_RANKS, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/tp_rank{r}.pt") for r in range(TP_RANKS)]
    for r, x in enumerate(ranks):
        log(f"  16b rank {r}: forward {x['fwd_ms']:.1f} ms (16a's "
            f"one-process forward {ref['fwd_ms']:.1f}), train_step "
            f"{x['step_ms']:.1f} ms (its second; 16a's first step "
            f"{ref['step_ms']:.1f}) on {smi}; peak device memory "
            f"{x['fwd_peak'] / 2**30:.2f} GiB forward, "
            f"{x['step_peak'] / 2**30:.2f} GiB the step; host copies "
            f"forward {x['fwd_copies']}, a step {x['step_copies']}; flash "
            f"at {list(TP_FLASH)} against its twin {x['flash_err']:.3e} "
            f"(tolerance 2.0e-02), equal bits again {x['flash_equal']}; "
            f"launches forward "
            f"{({k: v for k, v in x['fwd_counts'].items() if v})}, a step "
            f"{({k: v for k, v in x['step_counts'].items() if v})}")
        require_launches(f"16b rank {r} forward", x["fwd_counts"],
                         ("flash_attention", "layernorm",
                          "fused_preprocess"))
        require_launches(f"16b rank {r} train_step", x["step_counts"],
                         ("layernorm", "layernorm_bwd", "fused_preprocess"))
        if x["flash_err"] > 2e-2 or not x["flash_equal"] or not x["finite"]:
            raise AssertionError(f"16b rank {r}: flash or loss")
    logits, img, txt = ranks[0]["forward"]
    want = ref["forward"]
    emb = [(a - b).abs().max().item() for a, b in zip((img, txt), want[1:])]
    emb_ok = all(torch.allclose(a, b, rtol=TP_EMB_TOL, atol=TP_EMB_TOL)
                 for a, b in zip((img, txt), want[1:]))
    a, b = logits.numpy().ravel(), want[0].numpy().ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    top2 = want[0].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    confident = margin > margin.median()
    agree = (logits.argmax(-1) == want[0].argmax(-1))[confident].float(
        ).mean().item()
    lerr = (logits - want[0]).abs().max().item()
    rel = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    got = []
    for i, d in enumerate(ranks[0]["dims"]):
        if ranks[0]["cut"][i]:
            got.append(torch.cat([x["leaves"][i] for x in ranks], dim=d))
        else:
            got.append(ranks[0]["leaves"][i])
    whole_equal = all(torch.equal(ranks[0]["leaves"][i], x["leaves"][i])
                      for x in ranks[1:] for i, c in
                      enumerate(ranks[0]["cut"]) if not c)
    before = [t.numpy() for t in ref["before"]]
    got = [t.float().numpy() for t in got]
    after = [t.numpy() for t in ref["after"]]
    gaps = update_gaps(before, got, after, TP_LR)
    log(f"  16b against 16a's one-process calls: logits max "
        f"{lerr:.4f}, correlation {corr:.7f} (> {TP_CORR}), argmax "
        f"agreement on the confident half {agree:.4f} (> {TP_ARGMAX}); "
        f"embeddings max {emb[0]:.3e} / {emb[1]:.3e} (within rtol = atol "
        f"{TP_EMB_TOL}: {emb_ok}); loss {ranks[0]['loss']:.5f} against "
        f"{ref['loss']:.5f} ({rel:.2e} relative, < {TP_LOSS_RTOL}); the "
        f"update reassembled from {sum(ranks[0]['cut'])} cut leaves: moved "
        f"alike {gaps['agree']:.5f} (>= {TP_AGREE}), decay "
        f"{gaps['decay']:.2e} (within {TP_DECAY_ATOL}); whole leaves equal "
        f"on both ranks {whole_equal}; the two processes {wall:.1f} s")
    if not (emb_ok and corr > TP_CORR and agree > TP_ARGMAX
            and rel < TP_LOSS_RTOL and gaps["agree"] >= TP_AGREE
            and abs(gaps["decay"]) <= TP_DECAY_ATOL and whole_equal):
        raise AssertionError("16b: the TP=2 captioner against one process")
    counts = {n: ranks[0]["fwd_counts"][n] + ranks[0]["step_counts"][n]
              for n in ranks[0]["fwd_counts"]}
    return dict(counts=counts, ranks=ranks)


def replay_full_width(store: str, tmp: str, dev, smi: str) -> dict:
    """16c: `replay_exp --perceive --preset large` on phase 8's store (its
    rgb frames, at most REPLAY_FRAMES) in batches of FRAMES: what its
    `Perceiver.process` returned against `Perceiver.process` of a second
    perceiver with the same seed on the same frames stacked by hand, bit
    for bit (caption tokens, lengths, embeddings and every detection
    field); then `Viz-v1` on the store's first episode for VIZ_STEPS
    steps, its trajectory PNGs written."""
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch import perception as PER
    from embodied_captioning_tpu_torch import replay_exp
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.envs.registry import make_env
    from embodied_captioning_tpu_torch.utils.obs_store import SampleLoader

    seen = []
    process = PER.Perceiver.process

    def recorded(self, images):
        res = process(self, images)
        seen.append(res)
        return res

    PER.Perceiver.process = recorded
    K.reset_launches()
    try:
        # the overrides beside the path: argparse takes the positionals
        # in one run
        rc, line = run_entry(replay_exp.main, [
            store, *REPLAY_OVERRIDES, "--perceive", "--preset",
            REPLAY_PRESET, "--batch", str(FRAMES), "--max-frames",
            str(REPLAY_FRAMES), "--device", str(dev)])
    finally:
        PER.Perceiver.process = process
    counts = dict(K.launches)
    loader = SampleLoader(store)
    frames = replay_exp.rgb_frames(loader, REPLAY_FRAMES)
    per = PER.Perceiver(load_config(REPLAY_PRESET,
                                    overrides=list(REPLAY_OVERRIDES)),
                        device=dev)
    same = len(seen) == -(-len(frames) // FRAMES)
    fields = ("boxes", "classes", "scores", "valid", "masks", "embeddings")
    for i, got in zip(range(0, len(frames), FRAMES), seen):
        want = per.process(replay_exp.load_batch(loader,
                                                 frames[i:i + FRAMES]))
        same &= all(torch.equal(getattr(got.detections, f),
                                getattr(want.detections, f))
                    for f in fields)
        same &= all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    n_det = sum(int(r.detections.valid.sum()) for r in seen)
    n_tok = sum(int(r.caption_lengths.sum()) for r in seen)
    log(f"  16c replay_exp --perceive --preset {REPLAY_PRESET} on phase 8's "
        f"store: "
        f"{line['frames']} frames ({len(loader.episodes)} episodes; "
        f"BASELINE configuration (2) is {REPLAY_FRAMES}), "
        f"{line['detections']} detections, {n_tok} caption tokens, "
        f"{line['fps']} frames/s "
        f"({line['seconds']} s, npz loads included) on {smi}; equal to "
        f"Perceiver.process on the same frames bit for bit: {same}; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    if (rc != 0 or not same or line["frames"] != len(frames)
            or line["detections"] != n_det):
        raise AssertionError("16c: replay_exp against Perceiver.process")
    require_launches("16c replay_exp", counts,
                     ("flash_attention", "layernorm", "fused_preprocess",
                      "decode_self_block", "decode_cross_block",
                      "decode_mlp"))
    del per, seen
    ep_dir = os.path.dirname(loader.get_path(
        loader.episodes[0], loader.camera_of(loader.episodes[0], "rgb"),
        "rgb", frames[0][2]))
    out_dir = os.path.join(tmp, "viz_out")
    cfg = load_config(REPLAY_PRESET, overrides=[
        f"sim.replay_dir={ep_dir}", f"runtime.obs_dir={out_dir}"])
    t0 = time.perf_counter()
    env = make_env("Viz-v1", cfg, device=dev)
    obs = env.reset()
    for _ in range(VIZ_STEPS):
        obs, _, done, _ = env.step(1)
        if done:
            break
    viz_s = time.perf_counter() - t0
    pngs = sorted(Path(out_dir, "viz").glob("trajectory_*.png"))
    log(f"  16c Viz-v1 on {ep_dir}: {len(pngs)} trajectory PNGs "
        f"({[p.name for p in pngs]}), trajectory cells "
        f"{env._traj_cells}, pcd {obs['pcd'].shape}, rgb "
        f"{tuple(obs['rgb'].shape)} on {obs['rgb'].device}; {viz_s:.1f} s")
    if len(pngs) < 2 or any(p.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n"
                            for p in pngs):
        raise AssertionError("16c: Viz-v1 wrote no trajectory PNGs")
    return dict(counts=counts, fps=line["fps"])


def phase16(K, frames, store: str, dev, smi: str, tmp: str) -> dict:
    """Phase 16 in order; returns each path's launch counts."""
    import gc

    t16 = time.perf_counter()
    ref = tp_world_one(frames, dev, smi, tmp)
    tp = tp_two_ranks(ref, dev, tmp, smi)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    rep = replay_full_width(store, tmp, dev, smi)
    counts = dict(tp=tp["counts"], replay=rep["counts"])
    log("  phase 16 launches by kernel (16b: rank 0's timed forward and "
        "step): " + json.dumps({n: {k: c[n] for k, c in counts.items()}
                                for n in rep["counts"]}))
    log(f"  phase 16 in {time.perf_counter() - t16:.1f} s")
    return dict(counts=counts)


# ---------------------------------------------------------------------------
# phase 17: the real-checkpoint path (port_checkpoint coca and sbert,
# evaluate_finetuned_model --ported-dir)
# ---------------------------------------------------------------------------

# 17a: open_clip's coca_ViT-L-14 shapes (its model config: vision 1024 x
# 24 at patch 14 and 224^2, 256 pooled queries, text 768 x 12, 12
# multimodal pairs, 49,408 ids; text.positional_embedding 77 rows, as its
# text tower holds with embed_cls), weights N(0, 0.02) from a seeded
# generator
COCA_SHAPE = dict(v_width=1024, t_width=768, v_layers=24, t_layers=12,
                  mm_pairs=12, patch=14, image=224, queries=256,
                  vocab=49408, ctx=77)
COCA_SEED, COCA_STD = 17, 0.02
COCA_MERGES = 49408 - 514      # CLIP BPE's merges at 49,408 ids
COCA_CORR = 0.999              # port_checkpoint's own bar (the JAX script's)
EVAL_BOXES, EVAL_BATCH = 32, 16  # 17b: annotated boxes, --batch
EVAL_FRAMES = 8                # 17b: store frames the boxes lie on
# 17c: all-MiniLM-L6-v2's shapes (BERT: 384 wide, 6 layers, 12 heads,
# intermediate 1536, 512 positions, 30,522 ids), N(0, 0.02) weights
MINILM = dict(width=384, layers=6, inter=1536, positions=512, vocab=30522)
MINILM_ROWS = 64               # 17c: sentences encoded on both routes
MINILM_EMB_ATOL = 1e-4         # 17c: kernel route against the twins
MINILM_FLASH = (MINILM_ROWS, 12, 64, 32)  # MiniLM's heads at 64 positions


def write_coca_checkpoint(tmp: str, dev) -> tuple:
    """17a's inputs: the replica built on the card at COCA_SHAPE, every
    tensor drawn from N(0, COCA_STD) by a generator seeded COCA_SEED,
    saved with `torch.save` (then freed); a merges `.txt.gz` of
    COCA_MERGES distinct pairs of byte-unicode characters. Returns the
    two paths."""
    import gzip

    from embodied_captioning_tpu_torch.models.tokenizer_artifacts import (
        bytes_to_unicode)
    from embodied_captioning_tpu_torch.tools.torch_replica import (
        build_torch_coca, zero_state)

    replica, _ = build_torch_coca(zero_state(**COCA_SHAPE), dev)
    g = torch.Generator(device=dev).manual_seed(COCA_SEED)
    with torch.no_grad():
        for p in replica.parameters():
            p.normal_(0.0, COCA_STD, generator=g)
    ckpt = os.path.join(tmp, "coca_ViT-L-14.pt")
    torch.save({k: v.cpu() for k, v in replica.state_dict().items()}, ckpt)
    del replica
    torch.cuda.empty_cache()
    chars = list(bytes_to_unicode().values())
    merges = [f"{a} {b}" for a in chars for b in chars][:COCA_MERGES]
    bpe = os.path.join(tmp, "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(bpe, "wb") as fh:
        fh.write("\n".join(["#version: 0.2"] + merges).encode("utf-8"))
    return ckpt, bpe


def port_coca_check(run: dict, coca: dict, smi: str) -> None:
    """17a: `port_checkpoint coca` on the coca_ViT-L-14-shaped checkpoint
    (a run of phase 19's lanes): the inferred configuration, the smoke
    caption, and the replica held teacher-forced beside the port's
    captioner (`teacher_forced_corr` > COCA_CORR)."""
    line = run["line"]
    cfg, par = line.get("config", {}), line.get("parity", {})
    log(f"  17a: a coca_ViT-L-14-shaped checkpoint "
        f"({os.path.getsize(coca['ckpt']) / 2**30:.2f} GiB, made and saved "
        f"in {coca['made']:.1f} s) through port_checkpoint coca in "
        f"{run['seconds']:.1f} s on {smi}: config {cfg}; smoke caption "
        f"{line.get('smoke_tokens')} tokens "
        f"{line.get('smoke_caption', '')[:60]!r}; against the replica on the "
        f"card: teacher_forced_corr {par.get('teacher_forced_corr')} (bar "
        f"> {COCA_CORR}), argmax_agreement {par.get('argmax_agreement')}, "
        f"max |delta| / std {par.get('max_abs_delta_over_std')}; replica "
        f"missing {par.get('replica_missing')}, checkpoint unconsumed "
        f"{par.get('checkpoint_unconsumed')}")
    s = COCA_SHAPE
    want = {"vision_width": s["v_width"], "vision_layers": s["v_layers"],
            "image_size": s["image"], "vocab": s["vocab"],
            "text_layers": s["t_layers"], "mm_blocks": 2 * s["mm_pairs"],
            "bos": s["vocab"] - 2, "eos": s["vocab"] - 1}
    if (cfg != want or not par.get("teacher_forced_corr", 0) > COCA_CORR
            or par.get("replica_missing") or par.get(
                "checkpoint_unconsumed")):
        raise AssertionError(f"17a: port_checkpoint coca failed: {line}")
    os.remove(coca["ckpt"])


def eval_annotations(store: str, tmp: str) -> str:
    """17b's annotations: EVAL_BOXES boxes (a seeded 15-45% of the frame a
    side) over the first EVAL_FRAMES rgb frames of phase 8's store,
    referenced as "exp:episode:camera:step"."""
    from embodied_captioning_tpu_torch import replay_exp
    from embodied_captioning_tpu_torch.utils.obs_store import SampleLoader

    loader = SampleLoader(store)
    frames = replay_exp.rgb_frames(loader, EVAL_FRAMES)
    rng = np.random.default_rng(17)
    anns = []
    for i in range(EVAL_BOXES):
        ep, cam, step = frames[i % len(frames)]
        h, w = loader.get_sample(ep, cam, "rgb", step).data.shape[:2]
        bw, bh = rng.uniform(0.15, 0.45) * w, rng.uniform(0.15, 0.45) * h
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        anns.append({"image": f"{store}:{ep}:{cam}:{step}",
                     "box": [x1, y1, x1 + bw, y1 + bh],
                     "caption": f"object {i}"})
    path = os.path.join(tmp, "annotations.json")
    with open(path, "w") as fh:
        json.dump(anns, fh)
    return path


def kernel_weights_cast(params: dict) -> dict:
    """The captioner tree with the leaves the decode kernels read
    (`common._kernel_weight`: the self blocks' q, k, v, o, the cross
    blocks' q, o, the MLPs' fc, proj) cast to bf16 once, the others as
    they are: the kernels get the same bf16 weights as from float32
    leaves cast on every call."""
    def cast(blk: dict) -> dict:
        blk = dict(blk)
        for sub, names in (("attn", "qkvo"), ("xattn", "qo")):
            if sub in blk:
                blk[sub] = {n: (dict(p, w=p["w"].to(torch.bfloat16))
                                if n in names else p)
                            for n, p in blk[sub].items()}
        blk["mlp"] = {n: dict(p, w=p["w"].to(torch.bfloat16))
                      for n, p in blk["mlp"].items()}
        return blk

    return dict(params, text_blocks=[cast(b) for b in params["text_blocks"]],
                mm_blocks=[cast(b) for b in params["mm_blocks"]])


def copy_launches(fn) -> tuple:
    """(launches, device ms) of the elementwise copy kernels (the float32
    -> bf16 casts among them) in one traced call of `fn`."""
    events = traced_calls(fn, 1)
    cast = [e for e in events if "copy" in e.name]
    return len(cast), sum(e.time_range.end - e.time_range.start
                          for e in cast) / 1e3


@torch.no_grad()
def evaluate_ported_full_width(K, store: str, ported: str, tmp: str, dev,
                               smi: str) -> dict:
    """17b: `evaluate_finetuned_model --ported-dir` (in process, on the
    card) on the annotations of `eval_annotations` in batches of
    EVAL_BATCH: EVAL_BOXES CSV rows with finite perplexities, the
    launches (the text tower's 12 and the 12 self-only multimodal blocks
    on the self block, the 12 cross-only ones on the cross block, all 36
    on the decode MLP, every step), peak memory; then the first batch
    again: its captions those of the CSV, timed in turns (wall and
    device) with its float32 leaves (cast on every kernel call) and with
    the kernels' leaves cast once (equal tokens), the copy launches of
    each, and held teacher-forced against the twins (phase 3's
    limits)."""
    import csv

    from embodied_captioning_tpu_torch import evaluate_finetuned_model as EV
    from embodied_captioning_tpu_torch.models import captioner as CAP
    from embodied_captioning_tpu_torch.params import from_jax
    from embodied_captioning_tpu_torch.tools.port import load_ported

    anns_path = eval_annotations(store, tmp)
    out_csv = os.path.join(tmp, "captions_eval.csv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    rc, line = run_entry(EV.main, [anns_path, "--ported-dir", ported,
                                   "--batch", str(EVAL_BATCH), "--out",
                                   out_csv, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    with open(out_csv, newline="") as fh:
        rows = list(csv.DictReader(fh))
    ppl = np.asarray([float(r["perplexity"]) for r in rows])
    params, cfg, tok = load_ported(ported)
    params = from_jax(params, dev)
    t = cfg.text
    n_self, n_cross = t.layers + t.cross_layers // 2, t.cross_layers // 2
    steps = counts["decode_self_block"] // n_self
    batches = -(-EVAL_BOXES // EVAL_BATCH)
    expect = dict(flash_attention=cfg.vision.layers * batches,
                  fused_preprocess=batches, decode_self_block=n_self * steps,
                  decode_cross_block=n_cross * steps,
                  decode_mlp=(t.layers + t.cross_layers) * steps,
                  decode_self_attention=0, decode_cross_attention=0,
                  raycast_minargmin=0, layernorm_bwd=0)
    log(f"  17b evaluate_finetuned_model --ported-dir on {EVAL_BOXES} boxes "
        f"over {EVAL_FRAMES} frames of phase 8's store, batches of "
        f"{EVAL_BATCH}: rc {rc}, {line}, {len(rows)} rows in {wall:.1f} s "
        f"(loading the {os.path.getsize(os.path.join(ported, 'params.pkl')) / 2**30:.2f}"
        f" GiB directory included) on {smi}; perplexity "
        f"{ppl.min():.1f}-{ppl.max():.1f}; {steps} decode steps; launches "
        f"{({k: v for k, v in counts.items() if v})}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    got = {k: counts[k] for k in expect}
    if (rc != 0 or line != {"rows": EVAL_BOXES, "out": out_csv}
            or len(rows) != EVAL_BOXES or not np.isfinite(ppl).all()
            or got != expect or steps < batches
            or counts["layernorm"] < (2 * cfg.vision.layers + 1) * batches
            + steps):
        raise AssertionError(f"17b: evaluate_finetuned_model: {got} != "
                             f"{expect} or rows / perplexities")
    with open(anns_path) as fh:
        anns = json.load(fh)[:EVAL_BATCH]
    crops = EV.crop_batch(anns, cfg.vision.image_size, dev)
    toks, _, _ = CAP.generate(params, crops, cfg)
    same_csv = [tok.decode(r) for r in toks.cpu().numpy()] == [
        r["proposed"] for r in rows[:EVAL_BATCH]]
    cast = kernel_weights_cast(params)
    toks_c, _, _ = CAP.generate(cast, crops, cfg)
    # the float32 leaves and the kernels' leaves cast once, in turns
    walls = {"float32": [], "cast once": []}
    for name in ("float32", "cast once", "cast once", "float32"):
        p = params if name == "float32" else cast
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _, lengths = CAP.generate(p, crops, cfg)
        torch.cuda.synchronize()
        walls[name].append(round((time.perf_counter() - t0) * 1e3, 1))
    ms, ms_c = (sum(walls[k]) / 2 for k in ("float32", "cast once"))
    busy = profile_run(f"17b: one batch of {EVAL_BATCH} ported-CoCa crops",
                       lambda: CAP.generate(params, crops, cfg), ms * 1e3,
                       top=8)
    busy_c = profile_run(f"17b: the same batch, the kernels' leaves cast "
                         f"once", lambda: CAP.generate(cast, crops, cfg),
                         ms_c * 1e3, top=4)
    n_copy, copy_ms = copy_launches(lambda: CAP.generate(params, crops, cfg))
    n_copy_c, copy_ms_c = copy_launches(lambda: CAP.generate(cast, crops,
                                                             cfg))
    del cast
    forced = teacher_forced(params, crops, cfg, K)
    log(f"  17b one batch again: captions those of the CSV {same_csv}; "
        f"{int(lengths.sum())} tokens; in turns, wall ms float32 leaves "
        f"{walls['float32']}, the kernels' leaves cast once "
        f"{walls['cast once']} (tokens equal {torch.equal(toks, toks_c)}); "
        f"device busy {busy / 1e3:.1f} ms and {busy_c / 1e3:.1f} ms; copy "
        f"launches {n_copy} ({copy_ms:.2f} ms device) and {n_copy_c} "
        f"({copy_ms_c:.2f} ms); teacher-forced against the twins: "
        f"argmax agrees on {forced['agree']:.4f} of {forced['n']} live steps "
        f"(limit {MIN_ARGMAX_AGREE}), chosen log-prob {forced['lp_ulps']:.3f}"
        f" bf16 logit ulps, mean {forced['mean_ulps']:.3f} (limit "
        f"{MAX_LOGPROB_ULPS}), ViT embedding cosine min "
        f"{forced['img_cos']:.7f} (limit {MIN_IMG_COSINE})")
    if (not same_csv or not torch.equal(toks, toks_c)
            or forced["agree"] < MIN_ARGMAX_AGREE
            or forced["lp_ulps"] > MAX_LOGPROB_ULPS
            or forced["img_cos"] <= MIN_IMG_COSINE):
        raise AssertionError("17b: the ported CoCa's decode against the "
                             "CSV, the cast weights or the twins")
    return dict(counts=counts, wall=wall, ms=ms, busy_us=busy, peak=peak,
                ms_cast=ms_c, busy_cast_us=busy_c,
                copies=(n_copy, copy_ms, n_copy_c, copy_ms_c),
                agree=forced["agree"], ulps=forced["lp_ulps"])


def minilm_state(g, width, layers, inter, positions, vocab,
                 std: float = 0.02) -> dict:
    """A BERT state dict in the HF key layout, weights N(0, std) from the
    generator g (on the CPU), LayerNorms at 1 / 0."""
    def w(*shape):
        return torch.randn(*shape, generator=g) * std

    sd = {"embeddings.word_embeddings.weight": w(vocab, width),
          "embeddings.position_embeddings.weight": w(positions, width),
          "embeddings.token_type_embeddings.weight": w(2, width),
          "embeddings.LayerNorm.weight": torch.ones(width),
          "embeddings.LayerNorm.bias": torch.zeros(width)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, o, n in (("attention.self.query", width, width),
                           ("attention.self.key", width, width),
                           ("attention.self.value", width, width),
                           ("attention.output.dense", width, width),
                           ("intermediate.dense", inter, width),
                           ("output.dense", width, inter)):
            sd[p + name + ".weight"] = w(o, n)
            sd[p + name + ".bias"] = w(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = torch.ones(width)
            sd[p + ln + ".bias"] = torch.zeros(width)
    return sd


@torch.no_grad()
def minilm_full_width(K, tmp: str, dev, smi: str) -> dict:
    """17c: a MiniLM-L6-shaped BERT checkpoint in HF layout wrapped as
    sentence-transformers' `0.auto_model.`, and a `vocab.txt` of 30,522
    tokens, through `port_checkpoint sbert` (in process, on the card):
    its configuration and a unit-norm embedding (within 1e-3). Then the
    kernel route against the twins on the card: MINILM_ROWS sentences
    encoded (embeddings within MINILM_EMB_ATOL), every LayerNorm call's
    float32 rows of that encode through the kernel against its plain
    version (phase 2's 1e-5), and flash at MiniLM's head shape
    MINILM_FLASH against its twin (phase 2's 2e-2): the encoder's
    attention takes the pad mask, so it runs plain attention, in both
    packages."""
    from embodied_captioning_tpu_torch import port_checkpoint as PC
    from embodied_captioning_tpu_torch.models import common
    from embodied_captioning_tpu_torch.models import sbert as SB
    from embodied_captioning_tpu_torch.params import from_jax
    from embodied_captioning_tpu_torch.tools.port import load_ported

    g = torch.Generator().manual_seed(17)
    sd = minilm_state(g, **MINILM)
    ckpt = os.path.join(tmp, "minilm.bin")
    torch.save({"0.auto_model." + k: v for k, v in sd.items()}, ckpt)
    del sd
    words = ("a red couch in the living room with plant bed table toilet "
             "tv chair sofa near wall".split())
    vocab = list(dict.fromkeys(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
        + [chr(c) for c in range(ord("a"), ord("z") + 1)]))
    vocab += [f"##w{i}" if i % 3 else f"w{i}"
              for i in range(MINILM["vocab"] - len(vocab))]
    vpath = os.path.join(tmp, "vocab.txt")
    with open(vpath, "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")
    out_dir = os.path.join(tmp, "ported_minilm")
    K.reset_launches()
    t0 = time.perf_counter()
    rc, line = run_entry(PC.main, ["sbert", "--checkpoint", ckpt,
                                   "--tokenizer", vpath, "--out", out_dir,
                                   "--device", str(dev)])
    secs = time.perf_counter() - t0
    counts = dict(K.launches)
    norm = line.get("smoke_embedding_norm", 0.0)
    params, cfg, tok = load_ported(out_dir)
    params = from_jax(params, dev)
    rng = np.random.default_rng(17)
    sents = [" ".join(rng.choice(words, rng.integers(2, 12)))
             for _ in range(MINILM_ROWS)]
    ids = torch.from_numpy(tok.encode_batch(sents, cfg.max_len)).to(dev)
    seen = []
    kernel = common.layernorm_kernel

    def recorded(x, g_, b_, eps, *a, **k):
        seen.append((x, g_, b_, eps, a, k))
        return kernel(x, g_, b_, eps, *a, **k)

    common.layernorm_kernel = recorded
    try:
        K.reset_launches()
        emb = SB.encode_tokens(params, ids, cfg)
        torch.cuda.synchronize()
        enc_counts = dict(K.launches)
    finally:
        common.layernorm_kernel = kernel
    with plain_kernels(K):
        twin = SB.encode_tokens(params, ids, cfg)
    emb_err = (emb - twin).abs().max().item()
    ln_err = max((K.layernorm(x, g_, b_, eps, *a, **k).float()
                  - K.layernorm_plain(x, g_, b_, eps, *a, **k).float()
                  ).abs().max().item() for x, g_, b_, eps, a, k in seen)
    fg = torch.Generator(device=dev).manual_seed(17)
    q, k_, v = (torch.randn(*MINILM_FLASH, generator=fg, device=dev
                            ).to(torch.bfloat16) for _ in range(3))
    flash_err = check_close(f"flash_attention {list(MINILM_FLASH)} "
                            f"(MiniLM's heads)", K.flash_attention(q, k_, v),
                            K.flash_attention_plain(q, k_, v), 2e-2)
    t0 = time.perf_counter()
    for _ in range(5):
        SB.encode_tokens(params, ids, cfg)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  17c port_checkpoint sbert (in process) in {secs:.1f} s on {smi}: "
        f"rc {rc}, config {line.get('config')}, embedding norm {norm:.6f}, "
        f"launches {({k: v for k, v in counts.items() if v})}; "
        f"{MINILM_ROWS} sentences: {enc_ms:.2f} ms an encode, launches "
        f"{({k: v for k, v in enc_counts.items() if v})}; against the twins "
        f"on the card: embeddings max {emb_err:.3e} (limit "
        f"{MINILM_EMB_ATOL}), the {len(seen)} LayerNorm calls' float32 rows "
        f"{list(seen[0][0].shape)} max {ln_err:.3e} (limit 1e-5), flash at {list(MINILM_FLASH)} "
        f"{flash_err:.3e}")
    if (rc != 0 or line.get("config") != {
            "width": MINILM["width"], "layers": MINILM["layers"],
            "vocab": MINILM["vocab"], "post_ln": True}
            or abs(norm - 1.0) > 1e-3 or emb_err > MINILM_EMB_ATOL
            or ln_err > 1e-5 or len(seen) != 2 * cfg.layers + 1
            or counts["layernorm"] <= 0 or enc_counts["layernorm"] !=
            len(seen) or not torch.isfinite(emb).all()):
        raise AssertionError("17c: port_checkpoint sbert or its kernel route")
    return dict(counts=counts, seconds=secs, enc_ms=enc_ms, emb_err=emb_err,
                ln_err=ln_err, flash_err=flash_err)


def phase17(K, dev, smi: str, tmp: str) -> dict:
    """Phase 17's 17c, and 17a's checkpoint written for phase 19's lanes
    (17b follows them: `phase17b`); returns 17c's launch counts and the
    checkpoint's paths."""
    import gc

    t17 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ckpt, bpe = write_coca_checkpoint(tmp, dev)
    coca = dict(ckpt=ckpt, bpe=bpe, made=time.perf_counter() - t0,
                out_dir=os.path.join(tmp, "ported_coca"))
    gc.collect()
    torch.cuda.empty_cache()
    mini = minilm_full_width(K, tmp, dev, smi)
    log(f"  phase 17 (17c, 17a's checkpoint) in "
        f"{time.perf_counter() - t17:.1f} s")
    return dict(minilm=mini["counts"], coca=coca)


def phase17b(K, store: str, ported: str, dev, smi: str, tmp: str) -> dict:
    """17b on the directory 17a ported in phase 19's lanes; returns its
    launch counts."""
    t0 = time.perf_counter()
    ev = evaluate_ported_full_width(K, store, ported, tmp, dev, smi)
    log("  17b launches by kernel (evaluate_finetuned_model): "
        + json.dumps(ev["counts"]))
    log(f"  17b in {time.perf_counter() - t0:.1f} s")
    return ev["counts"]


# ---------------------------------------------------------------------------
# phase 18: the serving opt-ins, the render modes and the s2d stem
# ---------------------------------------------------------------------------

# (rows, in, out) of 18a: the decode step's q/k/v/o, its MLP and its
# vocabulary head at the serving batch, and a ViT MLP product of a batch
W8A8_SHAPES = ((ROWS, 768, 768), (ROWS, 768, 3072), (ROWS, 768, 49408),
               (ROWS * 257, 1024, 4096))
W8A8_CPU_ROWS = 512            # 18a: rows held against the CPU (row-wise)
RENDER_MODES = ("onehot", "gather", "onehot16", "onehot+vr", "onehot+pk",
                "gather+pk", "onehot16+pk", "onehot@160x48", "onehot@160x4")
OVERFLOW_MODE = "onehot@160x4"  # 18e: K too small for a 160^2 tile
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense INT8 tensor-core peak


def dense_w8a8_checks(dev, smi: str) -> dict:
    """18a: `dense_w8a8` on the card against the CPU (the first
    W8A8_CPU_ROWS rows: the activations' scales are per row and the int32
    sums exact, so rows are independent), bit for bit, at W8A8_SHAPES;
    each timed beside `common.dense` on the same int8 weights (bf16
    dequant) and beside its bound."""
    from embodied_captioning_tpu_torch.models.common import dense
    from embodied_captioning_tpu_torch.models.quantize import (
        QuantizedArray, dense_w8a8, quantize_array)

    g = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for m, k, n in W8A8_SHAPES:
        x = (torch.randn(m, k, generator=g, device=dev) * 2).bfloat16()
        w = quantize_array(torch.randn(k, n, generator=g, device=dev) * 0.05)
        p = {"w": w, "b": torch.zeros(n, device=dev)}
        got = dense_w8a8(x, w)
        r = min(m, W8A8_CPU_ROWS)
        want = dense_w8a8(x[:r].cpu(), QuantizedArray(w.q.cpu(),
                                                      w.scale.cpu()))
        if not torch.equal(got[:r].cpu(), want):
            raise AssertionError(f"18a: dense_w8a8 [{m}, {k}] x [{k}, {n}] "
                                 f"card != CPU")
        t8 = time_ms(lambda: dense_w8a8(x, w), iters=10)
        td = time_ms(lambda: dense(p, x), iters=10)
        d8 = device_us(lambda: dense_w8a8(x, w), iters=5)
        dd = device_us(lambda: dense(p, x), iters=5)
        bound = bound_ms(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * k * n,
                         INT8_OPS_PER_S)
        log(f"  18a: dense_w8a8 [{m}, {k}] x [{k}, {n}] card = CPU bit for "
            f"bit on {r} rows; {t8:.4f} ms ({d8:.1f} us device) against "
            f"dense on the int8 weights {td:.4f} ms ({dd:.1f} us device); "
            f"bound {bound[0] * 1e3:.2f} us ({bound[1]}) on {smi}")
        out[f"{m}x{k}x{n}"] = dict(ms=t8, device_us=d8, dense_ms=td,
                                   dense_device_us=dd, bound_ms=bound[0])
    return out


def w8a8_counts_ok(counts: dict, ccfg) -> int:
    """The launches of one `perceive(w8a8=True)` batch: the ViT's flash and
    the preprocess, the standalone decode attentions a sublayer a step,
    none of the fused decode kernels (rows 5-7), no backward. Returns the
    decode steps."""
    n_self, n_cross = decoder_sublayers(ccfg)
    steps = counts["decode_self_attention"] // n_self
    expect = {"flash_attention": ccfg.vision.layers, "fused_preprocess": 1,
              "decode_self_attention": n_self * steps,
              "decode_cross_attention": n_cross * steps,
              "decode_mlp": 0, "decode_self_block": 0,
              "decode_cross_block": 0, "raycast_minargmin": 0,
              "layernorm_bwd": 0}
    got = {k: v for k, v in counts.items() if k != "layernorm"}
    if got != expect or steps < 1 or counts["layernorm"] < steps:
        raise AssertionError(f"18b: w8a8 launches {counts} != {expect}")
    return steps


def serving_optins(K, frames, dev, smi: str) -> dict:
    """18b-d: `perceive` on the serving tree and phase 3's frames with the
    default opt-ins, with `w8a8=True` and with `int8_kv=False`, in turns
    (default, w8a8, bf16 K/V, then back): launches, ms a batch, device
    time; each route's decode held teacher-forced against the plain twins
    on the same route; the w8a8 detections against the default route's;
    the serving tree's `quantization_ratio`."""
    from embodied_captioning_tpu_torch.models.quantize import (
        quantization_ratio)
    from embodied_captioning_tpu_torch.perception import perceive

    cfg, params, _ = serving_perception(dev)
    ratio = quantization_ratio(params)
    log(f"  18d: quantization_ratio of the serving tree {ratio:.6f} (int8 "
        f"bytes over all, a float leaf counted 4 bytes an element)")
    modes = (("default", {}), ("w8a8", dict(w8a8=True)),
             ("bf16_kv", dict(int8_kv=False)))
    for _, kw in modes:
        perceive(params, frames, cfg, **kw)  # warm-up
    torch.cuda.synchronize()
    ms = {n: [] for n, _ in modes}
    counts, outs = {}, {}
    for name, kw in modes + modes[::-1]:
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = perceive(params, frames, cfg, **kw)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
        counts[name] = dict(K.launches)
    steps = w8a8_counts_ok(counts["w8a8"], cfg.captioner)
    n_self = decoder_sublayers(cfg.captioner)[0]
    check_decode_counts(counts["bf16_kv"],
                        counts["bf16_kv"]["decode_mlp"] // n_self, 1, True,
                        cfg.captioner)
    dev_us = {n: profile_run(
        f"18b-c: one perceive batch, {n}",
        lambda kw=kw: perceive(params, frames, cfg, **kw),
        sum(ms[n]) / len(ms[n]) * 1e3, top=8) for n, kw in modes}
    for name, _ in modes:
        log(f"  18b-c: perceive {name}: {ms[name][0]:.1f} and "
            f"{ms[name][1]:.1f} ms a batch of {FRAMES} frames, device "
            f"{dev_us[name] / 1e3:.2f} ms; launches {counts[name]}")
    da, db = outs["default"].detections, outs["w8a8"].detections
    same_n = int((da.valid.sum(1) == db.valid.sum(1)).sum())
    both = da.valid & db.valid
    box = ((da.boxes.float() - db.boxes.float()).abs().amax(-1)[both]
           .max().item() if bool(both.any()) else 0.0)
    cls = (da.classes == db.classes)[both].float().mean().item()
    log(f"  18b: w8a8 detections against the default route: valid counts "
        f"equal on {same_n} of {FRAMES} frames, {int(both.sum())} slots "
        f"valid in both: classes equal on {cls:.4f}, boxes max diff "
        f"{box:.3f} px ({steps} decode steps)")
    crops = center_crops(frames, cfg.captioner.vision.image_size)
    forced = {}
    for name, kw in modes[1:]:
        f = teacher_forced(params.captioner, crops, cfg.captioner, K, **kw)
        forced[name] = f
        w8 = name == "w8a8"
        ulps = MAX_LOGPROB_ULPS_W8A8 if w8 else MAX_LOGPROB_ULPS
        mean = MAX_MEAN_ULPS_W8A8 if w8 else math.inf
        cos = MIN_IMG_COSINE_W8A8 if w8 else MIN_IMG_COSINE
        log(f"  18b-c: {name} teacher-forced against the twins on its route: "
            f"argmax agrees on {f['agree']:.4f} of {f['n']} steps (limit "
            f"{MIN_ARGMAX_AGREE}), chosen log-prob {f['lp_ulps']:.3f} bf16 "
            f"ulps max (limit {ulps}), {f['mean_ulps']:.3f} mean (limit "
            f"{mean}), ViT embedding cosine min {f['img_cos']:.7f} (limit "
            f"{cos})")
        if (f["agree"] < MIN_ARGMAX_AGREE or f["lp_ulps"] > ulps
                or f["mean_ulps"] > mean or f["img_cos"] <= cos):
            raise AssertionError(f"18b-c: {name} kernel path and twins "
                                 f"disagree")
    return dict(counts=counts, ms=ms, device_us=dev_us, ratio=ratio,
                forced=forced)


def render_modes_full_width(K, dev, smi: str) -> dict:
    """18e: every render mode at 16 envs x 1280^2 x 96 boxes (the serving
    scenes, seeds 100..): each mode's outputs against "onehot"'s (equal
    bits for every mode with no overflowing tile), the culled modes'
    overflow counts, ms a `render_batch_chunked` call a mode."""
    from embodied_captioning_tpu_torch.config import ExperimentConfig
    from embodied_captioning_tpu_torch.envs import device_loop as DL
    from embodied_captioning_tpu_torch.envs import sim as S
    from embodied_captioning_tpu_torch.ops.geometry import (
        intrinsics_from_hfov)

    cfg = ExperimentConfig.preset_config("large")
    sims = [S.RaycastSim(cfg.sim, cfg.sensors, seed=100 + i, device=dev)
            for i in range(FRAMES)]
    scenes, state = DL.states_from_sims(sims)
    poses = DL.camera_poses(state)
    s = cfg.sensors
    ref = None
    out, launches = {}, collections.Counter()
    for mode in RENDER_MODES:
        def call(mode=mode):
            return S.render_batch_chunked(scenes, poses, s.height, s.width,
                                          s.hfov_deg, s.max_depth,
                                          attr_mode=mode)
        K.reset_launches()
        got = call()
        launches.update(K.launches)
        torch.cuda.synchronize()
        ms = time_ms(call, iters=2, warmup=0)
        row = dict(ms=ms)
        if ref is None:
            ref = got
        diff = sum(int((got[k] != ref[k]).reshape(FRAMES, s.height, s.width,
                                                 -1).any(-1).sum())
                   for k in ("depth", "instances", "classes"))
        row["pixels_off"] = diff
        base, tile, k = S._split_mode(mode)
        if tile:
            fx, fy, xc, yc = intrinsics_from_hfov(s.height, s.width,
                                                  s.hfov_deg)
            _, _, over = S._tile_candidates(
                scenes, poses[:, :3, 3].float(), poses[:, :3, :3].float(),
                fx, fy, xc, yc, s.height, s.width, tile, min(k, cfg.sim.max_boxes))
            row["overflow"] = int(over.max())
        equal = all(torch.equal(got[k], ref[k]) for k in ref)
        log(f"  18e: render {mode}: {ms:.2f} ms for {FRAMES} x "
            f"{s.height}^2 x {cfg.sim.max_boxes} boxes on {smi}; "
            + ("equal to onehot bit for bit" if equal else
               f"{diff} pixels of depth/instances/classes off onehot")
            + (f", overflow {row['overflow']}" if tile else ""))
        if mode == OVERFLOW_MODE:
            if row["overflow"] <= 0 or equal:
                raise AssertionError(f"18e: {mode} did not overflow")
        elif not equal or row.get("overflow", 0):
            raise AssertionError(f"18e: {mode} differs from onehot")
        out[mode] = row
    return dict(rows=out, counts=dict(launches))


def stem_s2d_served(frames, dev, smi: str) -> None:
    """18f: the served detector (the committed artifact, its int8 stem)
    with `stem_s2d` against the direct stem on phase 3's 16 frames, and
    the same with the stem's weights in float32 (as the s2d scatter
    dequantizes them): the stem outputs and the detections."""
    import dataclasses

    from embodied_captioning_tpu_torch.config import ExperimentConfig, merge
    from embodied_captioning_tpu_torch.models import detector as DET
    from embodied_captioning_tpu_torch.models.quantize import QuantizedArray
    from embodied_captioning_tpu_torch.ops.image import resize_bilinear
    from embodied_captioning_tpu_torch.params import load_detector_artifact

    params, det_cfg = load_detector_artifact(
        str(REPO / "embodied_captioning_tpu/models/data/det_serving_256.pkl"),
        dev)
    dcfg = merge(ExperimentConfig.preset_config("large"),
                 {"detector": det_cfg}).detector
    size = dcfg.image_size
    imgs = torch.clamp(resize_bilinear(frames.float(), size, size), 0, 255
                       ).to(torch.uint8)
    w = params["stem"]["w"]
    wf = (w.q.float() * w.scale.float()[:, None, None, None]
          if isinstance(w, QuantizedArray) else w.float())
    for what, p in (("int8 stem", params),
                    ("float32 stem", dict(params, stem=dict(
                        params["stem"], w=wf)))):
        x = imgs.float() / 255.0
        a = DET.conv(p["stem"], x, 2)
        b = DET._stem_s2d(p["stem"], x)
        off = (a != b).float().mean().item()
        da = DET.forward(p, imgs, dcfg, with_masks=False)
        db = DET.forward(p, imgs, dataclasses.replace(dcfg, stem_s2d=True),
                         with_masks=False)
        frames_eq = int(((da.boxes == db.boxes).all(-1).all(-1)
                         & (da.valid == db.valid).all(-1)).sum())
        log(f"  18f: {what} ({'int8' if isinstance(p['stem']['w'], QuantizedArray) else 'float32'} "
            f"leaf): s2d stem outputs off the direct stem's on {off:.3e} of "
            f"them; boxes and valid flags equal on {frames_eq} of "
            f"{imgs.shape[0]} frames on {smi}")
        if what == "float32 stem" and frames_eq != imgs.shape[0]:
            raise AssertionError("18f: the s2d stem moved the detections")


def phase18(K, frames, dev, smi: str) -> dict:
    """Phase 18 in order; returns the launch counts of its main paths."""
    t18 = time.perf_counter()
    dense_w8a8_checks(dev, smi)
    opt = serving_optins(K, frames, dev, smi)
    torch.cuda.empty_cache()
    ren = render_modes_full_width(K, dev, smi)
    torch.cuda.empty_cache()
    stem_s2d_served(frames, dev, smi)
    log(f"  phase 18 in {time.perf_counter() - t18:.1f} s")
    return dict(w8a8=opt["counts"]["w8a8"], bf16_kv=opt["counts"]["bf16_kv"],
                render=ren["counts"])


# ---------------------------------------------------------------------------
# phase 19: the entry points held by their output alone, in lanes
# ---------------------------------------------------------------------------

# each loop's JSON keys, the JAX script's (scripts/selfcheck_*.py)
LOOP_KEYS = {
    "selfcheck_loop": {"preset", "loop_steps", "seconds", "loop_fps",
                       "reward_mean_first_half", "reward_mean_second_half",
                       "captioned_detections", "mapped_objects_per_env",
                       "disagreement_rewards", "example_caption"},
    "selfcheck_rl": {"eval_steps", "preset", "arms", "summary",
                     "best_ppo_arm", "ppo_beats_random",
                     "ppo_beats_frontier"},
    "selfcheck_cycle": {"preset", "seeds", "triplet_weight", "explore_envs",
                        "mean_consistency_delta", "mean_gt_cosine_delta",
                        "all_positive", "coherent_and_accurate", "per_seed"},
    "selfcheck_teacher_student": {
        "teacher_map50", "eval_sha", "pool_frames", "teacher_detections",
        "steps", "scenes", "generations", "student_vanilla_map50",
        "student_soft_map50", "student_semantic_map_map50"},
}
CYCLE_SEED_KEYS = {"seed", "objects", "views", "consistency_before",
                   "consistency_after", "consistency_delta",
                   "gt_class_accuracy_before", "gt_class_accuracy_after",
                   "gt_cosine_before", "gt_cosine_after", "example_pseudo",
                   "example_before", "example_after"}
RL_ROW_KEYS = {"disagreement_reward", "area_ratio_mean", "mapped_objects"}
MAY_BE_NONE = {"example_caption", "example_pseudo"}
# each loop's cut command (the JAX scripts' defaults: 400 detector and 300
# captioner steps, 24 loop steps, 10 PPO updates of 8 decisions, 120 eval
# steps, 48 explore and 200 fine-tune steps, 128 pool scenes and 12,000
# student steps). The disagreement reward is the spread of each mapped
# object's caption embeddings over its views: a trained captioner gives
# every view of an object one caption on most envs, so `selfcheck_loop`
# runs 8 envs. On the CPU at 150 / 60 steps and 24 loop steps, the JAX
# script gave 6 envs of 8 a non-zero reward and the port 5; at the
# defaults (400 / 300, 2 envs) both gave none.
LOOP_ARGS = {
    "selfcheck_loop": ["--det-steps", "150", "--cap-steps", "60",
                       "--loop-steps", "24", "runtime.num_envs=8"],
    "selfcheck_rl": ["--det-steps", "100", "--cap-steps", "40", "--seeds",
                     "0", "--ppo-updates", "1", "--decisions-per-update",
                     "2", "--eval-steps", "10"],
    "selfcheck_cycle": ["--det-steps", "150", "--cap-steps", "60",
                        "--seeds", "0", "--finetune-steps", "10",
                        "--explore-steps", "32"],
}
# the teacher-student loop's pool, steps and the teacher's score threshold
# (the JAX script's: 128 scenes, 12,000 steps, 0.5), and its teacher's
# training (`selfcheck_detector --save`): a short teacher keeps few boxes
# above 0.2, too few for the semantic-map consensus to label any; at 0 it
# keeps every slot NMS keeps
TS_SCENES = 4
TS_STEPS = 30
TS_THRESHOLD = 0.0
TS_TEACHER_STEPS = 150
# `caption_tools perplexity`'s crops of phase 8's store (its default) and
# its CSV, in phase 19's files
CT_MAX_CROPS = 64
CT_CSV = "perplexity.csv"
CT_KEYS = {"crops", "out", "mean_perplexity"}
# the families under W8A8 (beside the lanes): the default route's
# teacher-forced logits on the same int8 tree pick the W8A8 decode's token
# on at least this share of the live steps. Predicted, not read: phase
# 18b's W8A8 decode against the twins read 0.9122, and random weights
# leave near-ties that an int8 level of an activation (amax / 127) flips
W8A8_MIN_AGREE = 0.8
# threads of each lane's process (8 host cores shared by the lanes)
LANE_THREADS = "2"
# a lane's command: the entry point's main(argv) with the kernel wrappers'
# launch counts of the run printed after its own output
COUNTED = (
    "import importlib, json, sys\n"
    "from embodied_captioning_tpu_torch import kernels as K\n"
    "mod = importlib.import_module('embodied_captioning_tpu_torch.' "
    "+ sys.argv[1])\n"
    "K.reset_launches()\n"
    "rc = mod.main(sys.argv[2:])\n"
    "sys.stdout.flush()\n"
    "print(json.dumps({'launches': dict(K.launches)}))\n"
    "sys.exit(rc or 0)\n")


def finite_json(x, key: str = "") -> bool:
    """Every number in a JSON value finite; None only under MAY_BE_NONE."""
    if x is None:
        return key in MAY_BE_NONE
    if isinstance(x, bool) or isinstance(x, str):
        return True
    if isinstance(x, (int, float)):
        return math.isfinite(x)
    if isinstance(x, dict):
        return all(finite_json(v, k) for k, v in x.items())
    return all(finite_json(v, key) for v in x)


def run_counted(module: str, argv: list, timeout: int = 600) -> dict:
    """`embodied_captioning_tpu_torch.<module>`'s main(argv) as a
    subprocess on the card (COUNTED): rc, its last line as JSON (None where
    it printed none), the launches, seconds, its output and errors."""
    env = dict(os.environ, OMP_NUM_THREADS=LANE_THREADS)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", COUNTED, module]
                              + argv, cwd=str(REPO), capture_output=True,
                              text=True, timeout=timeout, env=env)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = "timeout", str(exc.stdout or ""), str(exc.stderr
                                                              or "")
    lines = out.strip().splitlines()
    launches, line = {}, None
    if lines and lines[-1].startswith('{"launches"'):
        launches = json.loads(lines.pop())["launches"]
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            pass
    return dict(rc=rc, line=line, launches=launches, lines=lines,
                stderr=err, seconds=time.perf_counter() - t0)


def run_lanes(lanes: dict, alongside=None) -> tuple:
    """Each lane, a list of (key, module, argv) run in turn (a lane stops
    at its first failure), in a thread of its own, the lanes side by side,
    and `alongside()` in this thread meanwhile: ({key: run_counted's
    result}, alongside's result), each run's output logged after all
    ended."""
    import threading

    runs: dict = {}

    def lane(steps):
        for key, module, argv in steps:
            runs[key] = run_counted(module, argv)
            if runs[key]["rc"] != 0:
                break

    threads = [threading.Thread(target=lane, args=(steps,))
               for steps in lanes.values()]
    for t in threads:
        t.start()
    try:
        beside = alongside() if alongside is not None else None
    finally:
        for t in threads:
            t.join()
    for steps in lanes.values():
        for key, module, _ in steps:
            if key not in runs:
                continue
            r = runs[key]
            for line in r["lines"][:-1]:
                log("    | " + line[:300])
            log(f"  19 {key}: {module} in {r['seconds']:.1f} s, rc "
                f"{r['rc']}: "
                + (json.dumps(r["line"])[:1500] if r["line"] is not None
                   else r["stderr"][-3000:]))
    return runs, beside


def require_run(runs: dict, key: str) -> dict:
    """The run `key` of the lanes, which must have ended with rc 0 and a
    JSON line."""
    r = runs.get(key)
    if r is None:
        raise AssertionError(f"19: {key} did not run (its lane stopped)")
    if r["rc"] != 0 or r["line"] is None:
        raise AssertionError(f"19: {key} failed (rc {r['rc']}): "
                             f"{r['stderr'][-3000:]}")
    return r


def check_loops(runs: dict) -> None:
    """Each loop's JSON line has the JAX script's keys and finite values;
    `selfcheck_loop`'s disagreement rewards are not all zero."""
    lines = {name: require_run(runs, name)["line"] for name in LOOP_KEYS}
    for name, line in lines.items():
        if set(line) != LOOP_KEYS[name] or not finite_json(line):
            raise AssertionError(f"19: {name}'s JSON line: keys "
                                 f"{sorted(set(line) ^ LOOP_KEYS[name])} "
                                 f"differ or a value is not finite")
    for row in lines["selfcheck_cycle"]["per_seed"]:
        if set(row) != CYCLE_SEED_KEYS:
            raise AssertionError(f"19: selfcheck_cycle seed line {row}")
    for rows in lines["selfcheck_rl"]["arms"].values():
        if any(not RL_ROW_KEYS <= set(r) for r in rows):
            raise AssertionError("19: selfcheck_rl arm rows")
    if not any(r > 0 for r in lines["selfcheck_loop"]["disagreement_rewards"]):
        raise AssertionError("19: selfcheck_loop's disagreement rewards are "
                             "all zero")


def lane_commands(tmp: str, store: str, coca: dict) -> dict:
    """Phase 19's lanes: {lane: [(key, module, argv), ...]}, their files
    under `tmp`: 11d's detector self-check, the teacher-student loop after
    its teacher's training, 12b's `run_pseudolabeler`, 12e's and 14a's
    self-checks, 10c's `finetune_captioner`, 17a's `port_checkpoint coca`
    (on `coca`'s checkpoint), `caption_tools perplexity` on `store`, and
    the other three loops."""
    teacher = os.path.join(tmp, "teacher.pkl")
    lanes = {
        "11d": [("11d", "selfcheck_detector", DET_SELFCHECK_ARGS)],
        "teacher_student": [
            ("teacher", "selfcheck_detector", [
                "--steps", str(TS_TEACHER_STEPS), "--episodes", "2",
                "--save", teacher]),
            ("selfcheck_teacher_student", "selfcheck_teacher_student", [
                "--teacher", teacher, "--scenes", str(TS_SCENES), "--steps",
                str(TS_STEPS), "--batch", "4", "--teacher-threshold",
                str(TS_THRESHOLD), "--eval-cache",
                os.path.join(tmp, "eval_corpus.npz")])],
        "12b": [("12b", "run_pseudolabeler", [
            subset_store(store, tmp, SUBSET_ENVS), "--out",
            os.path.join(tmp, "pl_cli"), "--preset", LABEL_PRESET,
            "--consensus", "semantic_map"])],
        "12e_14a": [("12e", "selfcheck_detector", TTA_ARGS),
                    ("14a", "selfcheck_detector", SERVING_ARGS)],
        "10c": [("10c", "finetune_captioner", [
            subset_store(store, tmp, FT_STORE_ENVS), "--preset", "large",
            "--save", os.path.join(tmp, FT_PICKLE), "--pseudo-captions",
            str(REPO / "pseudo_captions.json")])],
        "17a": [("17a", "port_checkpoint", [
            "coca", "--checkpoint", coca["ckpt"], "--tokenizer",
            coca["bpe"], "--out", coca["out_dir"]])],
        "caption_tools": [("caption_tools", "caption_tools", [
            "perplexity", store, "--preset", "large", "--max-crops",
            str(CT_MAX_CROPS), "--out", os.path.join(tmp, CT_CSV)])],
    }
    for name, argv in LOOP_ARGS.items():
        extra = (["--workdir", os.path.join(tmp, "cycle")]
                 if name == "selfcheck_cycle" else [])
        lanes[name] = [(name, name, ["--preset", "tiny"] + argv + extra)]
    return lanes


def caption_tools_check(run: dict, path: str, smi: str) -> dict:
    """`caption_tools perplexity` (a run of phase 19's lanes): its JSON
    line (CT_KEYS, at least one crop, a finite mean), a CSV row a crop
    with a finite perplexity >= 1, and the kernels of its path launched:
    the ViT's preprocess, flash attention and LayerNorm, the decode loop's
    self block, cross block and decode MLP. Returns its launches."""
    import csv

    line = run["line"]
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    ppl = [float(r["perplexity"]) for r in rows]
    if (set(line) != CT_KEYS or not line["crops"]
            or not finite_json(line) or len(rows) != line["crops"]
            or not all(math.isfinite(p) and p >= 1.0 for p in ppl)):
        raise AssertionError(f"19 caption_tools perplexity: {line}, "
                             f"{len(rows)} rows, {ppl[:4]}")
    require_launches("19 caption_tools perplexity", run["launches"], (
        "fused_preprocess", "flash_attention", "layernorm",
        "decode_self_block", "decode_cross_block", "decode_mlp"))
    log(f"  19 caption_tools perplexity (large preset, {line['crops']} "
        f"crops of phase 8's store) on {smi}: {run['seconds']:.1f} s with "
        f"the process's start, mean perplexity "
        f"{line['mean_perplexity']:.2f}; launches {run['launches']}")
    return run["launches"]


@torch.no_grad()
def w8a8_families(K, frames, dev, smi: str) -> dict:
    """19, beside the lanes: BLIP-2 (`Blip2Config()`), Florence
    (`FlorenceConfig()`, the caption task) and the query `perceive` (13b's
    configuration: QUERY_LARGE at the large preset) under `w8a8=True`, on
    int8 trees of their weights from a generator seeded 0 (the query
    detector's quantized too), one batch each (VLM_CROPS quadrant crops of
    `frames`, or the frames): its launches (preprocess, flash, LayerNorm,
    the standalone decode attentions; no block and no decode-MLP kernel)
    and ms (under the lanes' load), and the int8 x int8 products it ran
    (`quantize.dense_w8a8` calls, at least one: `w8a8` reached the
    family's int8 weights). Then held by the default route on the same
    tree: its teacher-forced logits pick the W8A8 decode's token on
    W8A8_MIN_AGREE of the live steps (BLIP-2, Florence), its detections
    matched by the W8A8 route's on QUERY_MIN_MATCHED (the query family);
    and W8A8 moves the numbers: the teacher-forced logits under `w8a8` on
    the decode's tokens (the detection scores) differ from the default
    route's. Returns each family's launches."""
    from embodied_captioning_tpu_torch.models import blip2 as B
    from embodied_captioning_tpu_torch.models import common as C
    from embodied_captioning_tpu_torch.models import florence as F
    from embodied_captioning_tpu_torch.models.quantize import quantize_params
    from embodied_captioning_tpu_torch.perception import perceive

    fused = ("decode_self_block", "decode_cross_block", "decode_mlp")

    def counted(what, fn, need):
        products = [0]
        int8_product = C.dense_w8a8

        def count_product(*a, **k):
            products[0] += 1
            return int8_product(*a, **k)

        K.reset_launches()
        C.dense_w8a8 = count_product
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            C.dense_w8a8 = int8_product
        counts = dict(K.launches)
        require_launches(what, counts, need)
        if any(counts[n] for n in fused):
            raise AssertionError(f"{what}: a fused decode kernel launched "
                                 f"under w8a8: {counts}")
        if not products[0]:
            raise AssertionError(f"{what}: no int8 x int8 product ran")
        log(f"  19 {what} on {smi}: {ms:.1f} ms a batch (beside the "
            f"lanes); {products[0]} int8 x int8 products; launches {counts}")
        return out, counts

    def moved(what, w8a8_out, default_out):
        if torch.equal(w8a8_out, default_out):
            log(f"  19 {what}: equal under w8a8 and on the default route")
            bad.append(f"{what} unmoved by w8a8")

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    need = ("fused_preprocess", "flash_attention", "layernorm",
            "decode_self_attention")
    out, bad = {}, []
    cfg = B.Blip2Config()
    q = quantize_params(B.init_blip2(seeded(), cfg, dev))
    crops = center_crops(frames[:VLM_CROPS // 4], cfg.vision.image_size)
    (toks, _, _), out["blip2"] = counted(
        "BLIP-2 generate under w8a8 (16 crops)",
        lambda: B.generate(q, crops, None, cfg, DECODE_LEN, w8a8=True), need)
    ref = B.lm_logits(q, crops, toks, cfg)
    agree, n = chosen_agree(ref, toks, 0)
    moved("BLIP-2 lm_logits", B.lm_logits(q, crops, toks, cfg, w8a8=True),
          ref)
    log(f"  19 BLIP-2: the default route's lm_logits on the same int8 tree "
        f"pick the w8a8 decode's token on {agree:.4f} of {n} live steps "
        f"(limit {W8A8_MIN_AGREE})")
    if agree < W8A8_MIN_AGREE:
        bad.append("BLIP-2")
    del q
    cfg = F.FlorenceConfig()
    q = quantize_params(F.init_florence(seeded(), cfg, dev))
    (toks, _), out["florence"] = counted(
        "Florence generate under w8a8 (caption task, 16 crops, cache 128)",
        lambda: F.generate(q, crops, cfg, task=F.TASK_CAPTION, w8a8=True),
        need + ("decode_cross_attention",))
    ref = F.florence_logits(q, crops, toks, cfg)
    agree, n = chosen_agree(ref, toks, 1)
    moved("Florence florence_logits",
          F.florence_logits(q, crops, toks, cfg, w8a8=True), ref)
    log(f"  19 Florence: the default route's florence_logits on the same "
        f"int8 tree pick the w8a8 decode's token on {agree:.4f} of {n} "
        f"live steps (limit {W8A8_MIN_AGREE})")
    if agree < W8A8_MIN_AGREE:
        bad.append("Florence")
    del q
    torch.cuda.empty_cache()
    cfg, per = query_perception(dev, QUERY_LARGE)
    per = per._replace(detector=quantize_params(per.detector))
    res, out["query"] = counted(
        "query perceive under w8a8 (large preset, int8 detector)",
        lambda: perceive(per, frames, cfg, w8a8=True),
        need + ("decode_cross_attention",))
    ref = perceive(per, frames, cfg).detections
    hit, total = matched_share(res.detections, ref)
    moved("query perceive scores", res.detections.scores, ref.scores)
    log(f"  19 query perceive: the w8a8 route matches {hit} of the default "
        f"route's {total} detections on the same int8 tree (class, IoU >= "
        f"0.5; limit {QUERY_MIN_MATCHED})")
    if total == 0 or hit < QUERY_MIN_MATCHED * total:
        bad.append("query perceive")
    if bad:
        raise AssertionError(f"19 under w8a8 against the default route: "
                             f"{bad}")
    return out


def phase19(K, frames, tmp: str, store: str, coca: dict, shapes: list,
            dev, smi: str) -> dict:
    """The entry points that are held by their output and read for no
    time, as subprocesses on the card (COUNTED) in lanes side by side
    after every timed phase (`lane_commands`; 17b follows the lanes), each
    run held as its phase held it, and the four loops' JSON lines
    (`check_loops`); the three families under W8A8 in this process
    meanwhile (`w8a8_families` on `frames`). Returns 11d's run and the
    launches of `caption_tools` and of each family."""
    t19 = time.perf_counter()
    lanes = lane_commands(tmp, store, coca)
    runs, fam = run_lanes(lanes, lambda: w8a8_families(K, frames, dev, smi))
    secs = time.perf_counter() - t19
    det = detector_selfcheck_check(require_run(runs, "11d"), smi)
    pseudolabel_cli_check(require_run(runs, "12b"))
    selfcheck_tta_check(require_run(runs, "12e"), smi)
    serving_flags_check(require_run(runs, "14a"), smi)
    finetune_entry_check(require_run(runs, "10c"),
                         os.path.join(tmp, FT_PICKLE), shapes)
    port_coca_check(require_run(runs, "17a"), coca, smi)
    require_run(runs, "teacher")
    check_loops(runs)
    ct = caption_tools_check(require_run(runs, "caption_tools"),
                             os.path.join(tmp, CT_CSV), smi)
    log(f"  phase 19: {len(lanes)} lanes and the w8a8 families in "
        f"{secs:.1f} s on {smi} (each run's seconds are under the load of "
        f"the others)")
    return dict(det=det, caption_tools=ct, **fam)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def by_kernel_times(K, QZ, rn) -> dict:
    """Device time per call of each kernel under the flash attention and
    decode-MLP wrappers at the main shapes (profiler), and the MLP's time
    from CUDA events around back-to-back calls (its launches and the gaps
    between them)."""
    out = {}
    for t in (257, 640):
        q, k, v = (rn(ROWS, 16, t, 64) for _ in range(3))
        out[f"flash_attention [{ROWS},16,{t},64]"] = device_profile(
            lambda: K.flash_attention(q, k, v))[1]
    dm, f = 768, 3072
    wfc = QZ.quantize_array(rn(dm, f, scale=dm ** -0.5, dtype=torch.float32))
    wpj = QZ.quantize_array(rn(f, dm, scale=f ** -0.5, dtype=torch.float32))
    args = (rn(ROWS, dm), 1.0 + rn(dm, scale=0.1, dtype=torch.float32),
            rn(dm, scale=0.1, dtype=torch.float32), wfc.q, wfc.scale,
            rn(f, scale=0.02, dtype=torch.float32), wpj.q, wpj.scale,
            rn(dm, scale=0.02, dtype=torch.float32))
    busy, kernels = device_profile(lambda: K.decode_mlp(*args), 20)
    out["decode_mlp int8"] = dict(
        kernels, busy_us=busy,
        events_us=event_device_us(lambda: K.decode_mlp(*args), 200))
    for name, r in out.items():
        log(f"  {name}: {r}")
    return out


# the rows `--rows` can run: name -> (K, QZ, rn, dev) -> row
ROW_CHECKS = {
    "flash_attention": lambda K, QZ, rn, dev: flash_checks(K, rn),
    "decode_mlp": lambda K, QZ, rn, dev: mlp_checks(K, QZ, rn, ROWS),
    "decode_self_attention": lambda K, QZ, rn, dev: (
        lambda c: dict(**c[0], cases=c[1:]))(self_attention_cases(K, dev)),
    "by_kernel": lambda K, QZ, rn, dev: by_kernel_times(K, QZ, rn),
}


def rows_only(root: Path, names: list) -> int:
    """Phase 2's rows `names` (of ROW_CHECKS) through the kernels of the
    checkout at `root`, built from its sources: an earlier commit's, to
    time beside this one's in one call. Prints one JSON line of the rows
    and of the tensor-core instructions of the flash and MLP kernels."""
    unknown = [n for n in names if n not in ROW_CHECKS]
    if unknown:
        print(f"chip_smoke: no row {unknown}; rows: {list(ROW_CHECKS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root.resolve()))
    from embodied_captioning_tpu_torch import kernels as K
    from embodied_captioning_tpu_torch.models import quantize as QZ

    log(card_name())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    try:
        sass = tensor_core_sass(K.build())
        log(f"{', '.join(names)} of {root} ({Path(K.__file__).parent})")
        for fn, ops in sass.items():
            log(f"  {fn} (cuobjdump -sass): {ops}")
        rows = {}
        for name in names:
            rows[name] = ROW_CHECKS[name](K, QZ, rn, dev)
            if name != "by_kernel":
                log_rows({name: rows[name]})
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"rows": rows, "sass": sass, "root": str(root)}))
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
    if sys.argv[1:2] == ["--rows"] and len(sys.argv) >= 4:
        return rows_only(Path(sys.argv[2]), sys.argv[3:])
    try:
        from embodied_captioning_tpu_torch import kernels as K
        from embodied_captioning_tpu_torch.models import quantize as QZ
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc})",
              file=sys.stderr)
        return 2
    smi = card_name()
    log(smi)
    t_run = time.perf_counter()

    def stage(text: str) -> None:
        log(f"{text} (at {time.perf_counter() - t_run:.1f} s)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")
    dev = torch.device("cuda")
    try:
        t0 = time.perf_counter()
        K.build()
        log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
        stage("[2] kernels vs plain versions at the main paths' shapes")
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
        stage("[3] perceive at full width")
        res = perceive_full_width(setup)
        log(f"perceive: {res['fps']:.2f} frames/s on {smi} "
            f"({FRAMES} frames x {BATCHES} batches in "
            f"{res['seconds']:.3f} s, {res['steps']} decode steps, "
            f"{res['valid_detections']} valid detections)")
        routes = decode_routes_in_turns(setup)
        stage("[4] the exploration loop at full width")
        render_kernel_vs_plain(setup)
        loop = rollouts_full_width(setup, smi)
        fuse_card_vs_cpu(setup)
        stage("[5] tiny preset: card vs CPU")
        tiny_card_vs_cpu(dev)
        tiny_generate_card_vs_cpu(dev)
        divisions_card_vs_cpu(dev)
        stage("[6] device time of one full-width perceive batch on each "
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
        stage("[7] beam, sampled and speculative generation at full width")
        generation_modes(setup, smi)
        import tempfile
        with tempfile.TemporaryDirectory(prefix="ecap_generate_") as store:
            stage("[8] the exploration entry point (generate) at full width")
            gen = generate_full_width(setup, smi, store)
            stage("[9] PPO training (train) at full width")
            ppo_card_vs_cpu(dev)
            train = train_full_width(setup, smi)
            ppo_update_reference_batch(dev, smi)
            run_exp_train_on_card()
            # the full-width perception state, frames and voxel maps of
            # phases 3-9 are not needed past here: free them for the
            # large preset's training state
            frames13 = res["frames"]  # phase 13's perceive batch
            del setup, res, routes
            loop.pop("one_step")
            torch.cuda.empty_cache()
            stage("[10] the captioner fine-tune (finetune_captioner)")
            finetune_card_vs_cpu(dev)
            ft = finetune_full_width(dev, smi)
            stage("[11] the learning self-checks (selfcheck_training, "
                "selfcheck_detector)")
            detector_card_vs_cpu(dev, smi)
            for preset in ("large", "base"):
                detector_step_full_width(dev, smi, preset)
            with tempfile.TemporaryDirectory(prefix="ecap_selfcheck_") as tmp:
                cap = captioner_selfcheck(dev, smi, tmp)
                free_running_on_trained_weights(K, cap, dev, smi)
            cap.pop("state")
            torch.cuda.empty_cache()
            stage("[12] pseudo-labeling, pseudo-captioning and the "
                "teacher-student pipeline (run_pseudolabeler, pseudocaption, "
                "train_detector)")
            t12 = time.perf_counter()
            labeling_card_vs_cpu(dev, smi)
            with tempfile.TemporaryDirectory(prefix="ecap_label_") as tmp:
                lab = pseudolabel_full_width(store, tmp, dev, smi)
                pseudocaption_full_width(store, tmp, lab, dev, smi)
                del lab["per"]
                torch.cuda.empty_cache()
                train_detector_full_width(store, tmp, dev, smi)
            log(f"  phase 12 in {time.perf_counter() - t12:.1f} s")
            torch.cuda.empty_cache()
            stage("[13] the query (Mask2Former-class) detector family "
                "(perceive, selfcheck_detector --pack-masks --ckpt, "
                "export_serving_artifact, run_pseudolabeler)")
            t13 = time.perf_counter()
            query_card_vs_cpu(dev, smi)
            qry = query_full_width(frames13, dev, smi)
            with tempfile.TemporaryDirectory(prefix="ecap_query_") as tmp:
                query_rung(frames13, qry.pop("per"), dev, smi, tmp)
                query_labeling(dev, smi, tmp)
            log(f"  phase 13 in {time.perf_counter() - t13:.1f} s")
            torch.cuda.empty_cache()
            stage("[14] the detector's serving evaluations (eval_artifact), "
                "BLIP-2, Florence and the consensus LM")
            with tempfile.TemporaryDirectory(prefix="ecap_vlm_") as tmp:
                p14 = phase14(K, frames13, rows, dev, smi, tmp)
            torch.cuda.empty_cache()
            stage("[15] the parallel layer: the mixture-of-experts captioner, "
                "myppo, perceive_sharded, pipeline and ring attention, the "
                "checkpoint manager (a world-1 NCCL group)")
            with tempfile.TemporaryDirectory(prefix="ecap_parallel_") as tmp:
                p15 = phase15(K, frames13, dev, smi, tmp)["counts"]
            torch.cuda.empty_cache()
            stage("[16] the tensor-parallel captioner (a world-1 NCCL group, "
                "then two processes on the card in a gloo group) and the "
                "replay path (replay_exp --perceive, Viz-v1)")
            with tempfile.TemporaryDirectory(prefix="ecap_tp_") as tmp:
                p16 = phase16(K, frames13, store, dev, smi, tmp)["counts"]
            torch.cuda.empty_cache()
            # phase 19's lanes and 17b work in `lanes` (17a's checkpoint
            # and ported directory, the fine-tune's pickle, the stores)
            with tempfile.TemporaryDirectory(prefix="ecap_lanes_") as lanes:
                stage("[17] the real-checkpoint path (port_checkpoint sbert; "
                      "port_checkpoint coca's checkpoint)")
                p17 = phase17(K, dev, smi, lanes)
                torch.cuda.empty_cache()
                stage("[18] the serving opt-ins (dense_w8a8, perceive with "
                      "w8a8 and with bf16 K/V, quantization_ratio), every "
                      "render mode, the s2d stem")
                p18 = phase18(K, frames13, dev, smi)
                torch.cuda.empty_cache()
                stage("[19] the entry points held by their output, in lanes "
                      "side by side: 10c, 11d, 12b, 12e, 14a, 17a, the "
                      "four learning loops and caption_tools perplexity; "
                      "BLIP-2, Florence and the query perceive under w8a8 "
                      "beside them")
                p19 = phase19(K, frames13, lanes, store, p17["coca"],
                              ft["shapes"], dev, smi)
                det = p19["det"]
                stage("[17b] evaluate_finetuned_model --ported-dir on 17a's "
                      "directory")
                p17["coca"] = phase17b(K, store, p17["coca"]["out_dir"], dev,
                                       smi, lanes)
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
    # self-checks at the tiny preset (11c in process, 11d in phase 19's
    # lanes), collection, training
    # and evaluation; launches_labeling: over phase 12b's timed `predict`
    # (LABEL_FRAMES frames of phase 8's store); launches_query: over phase
    # 13b's timed perceive batch with the query detector (large preset);
    # launches_eval: over 14a's eval_artifact on the card (its corpora's
    # render); launches_blip2: over 14b's timed BLIP-2 generate;
    # launches_florence: over 14c's four timed Florence generates;
    # launches_lm: over 14d's timed ConsensusLM choices; launches_moe: over
    # 15b's timed MoE generate; launches_moe_train: over 15b's timed MoE
    # train steps; launches_myppo: over 15c's full-width myppo train;
    # launches_parallel: over 15d's perceive_sharded; launches_tp: over
    # 16b's timed TP forward and train step on rank 0; launches_replay:
    # over 16c's replay_exp --perceive; launches_coca: over 17b's
    # evaluate_finetuned_model on the ported CoCa; launches_minilm: over
    # 17c's port_checkpoint sbert; launches_w8a8: over 18b's timed
    # perceive(w8a8=True) batch; launches_bf16_kv: over 18b's timed
    # perceive(int8_kv=False) batch; launches_render: over 18e's first
    # render of each mode; launches_caption_tools: over phase 19's
    # `caption_tools perplexity`; launches_blip2_w8a8,
    # launches_florence_w8a8, launches_query_w8a8: over phase 19's batch of
    # each family under w8a8
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
            launches_learning=cap["counts"][n] + det["counts"].get(n, 0),
            launches_labeling=lab["counts"][n],
            launches_query=qry["counts"][n],
            launches_eval=p14["eval"][n], launches_blip2=p14["blip2"][n],
            launches_florence=p14["florence"].get(n, 0),
            launches_lm=p14["lm"][n], launches_moe=p15["moe"][n],
            launches_moe_train=p15["moe_train"][n],
            launches_myppo=p15["myppo"][n],
            launches_parallel=p15["parallel"][n],
            launches_tp=p16["tp"][n], launches_replay=p16["replay"][n],
            launches_coca=p17["coca"][n], launches_minilm=p17["minilm"][n],
            launches_w8a8=p18["w8a8"][n], launches_bf16_kv=p18["bf16_kv"][n],
            launches_render=p18["render"].get(n, 0),
            launches_caption_tools=p19["caption_tools"].get(n, 0),
            launches_blip2_w8a8=p19["blip2"][n],
            launches_florence_w8a8=p19["florence"][n],
            launches_query_w8a8=p19["query"][n],
            **r))
    if any(k["launches"] <= 0 for k in kernels):
        print(f"chip_smoke: a kernel was never launched: {kernels}",
              file=sys.stderr)
        return 1
    log(f"profiler traces taken again for a lost launch (first kernel, "
        f"tries): {RETRACES or 'none'}; device times read from CUDA events "
        f"for want of a whole trace (calls, us a call): "
        f"{EVENT_TIMED or 'none'}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
