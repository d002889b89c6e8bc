"""The BLIP-2-class captioner (`models/blip2.py`) against the JAX package at
the tiny preset on the CPU, on the JAX package's seeded weights through
`from_jax`: the Q-Former in its three modes, the query encoder, the ITC and
ITM scores, the teacher-forced LM logits, greedy `generate` on both decode
routes, and the caption loss with its gradients.

Inference runs the JAX side with its kernels in interpret mode and the
whole-block decode kernels (`jax_kernel_path(blocks=True)`), gradients on
its default path (`jax_train_path`). The Q-Former's query self-attention
(8 queries here, 32 at full width) is XLA attention in the JAX package
(flash only from T = 64) and the flash kernel's numerics in the port
(ROADMAP C.9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models import blip2 as JB
from embodied_captioning_tpu.models.vit import vit_features as jvit
from embodied_captioning_tpu.ops.image import preprocess_for_vit as jpre
from embodied_captioning_tpu_torch.models import blip2 as TB
from embodied_captioning_tpu_torch.models.tokenizer import EOS_ID, PAD_ID
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, value_and_grad,
)
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import (
    gradient_errors, jax_kernel_path, jax_train_path, leaf_names, np32,
    perturbed, t,
)

# bf16 logits and features: the CoCa tests' limit (test_torch_generate.py)
ATOL = 5e-2
# f32 scores of bf16 features (cosines, a softmax)
SCORE_ATOL = 5e-3
# greedy decoding of random weights flips at near-ties (ROADMAP C.8,
# C.12): the weights' key and image seed were picked where every row of
# the JAX package's decode agrees with the port's on both routes
WEIGHT_KEY, IMAGE_SEED = 1, 0


def _inputs(cfg, seed: int, b: int = 3, t_len: int = 10):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    toks = rng.integers(3, cfg.vocab_size, (b, t_len)).astype(np.int32)
    toks[:, 0] = 1
    toks[1, 6:] = PAD_ID
    toks[2, 8:] = PAD_ID
    return imgs, toks


@pytest.fixture(scope="module")
def ref():
    cfg = JB.Blip2Config.tiny()
    params = JB.init_blip2(jax.random.PRNGKey(WEIGHT_KEY), cfg)
    imgs, toks = _inputs(cfg, IMAGE_SEED)
    ji, jt = jnp.asarray(imgs), jnp.asarray(toks)
    v = cfg.vision
    with jax_kernel_path(blocks=True):
        feats = jvit(params["vision"], jpre(ji, v.image_size, v.patch_size),
                     v)
        out = dict(
            feats=feats,
            q=JB.qformer(params, feats, cfg),
            qt=JB.qformer(params, feats, cfg, text_tokens=jt),
            txt=JB.qformer(params, None, cfg, text_tokens=jt),
            enc=JB.encode_image_queries(params, ji, cfg),
            itc=JB.itc_score(params, ji, jt, cfg),
            itm=JB.itm_score(params, ji, jt, cfg),
            logits=JB.lm_logits(params, ji, jt, cfg),
            gen_blocks=JB.generate(params, ji, jax.random.PRNGKey(0), cfg))
    with jax_kernel_path(blocks=False):
        out["gen_calls"] = JB.generate(params, ji, jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, tcfg=TB.Blip2Config.tiny(), params=params,
                tparams=from_jax(params, "cpu"), imgs=imgs, toks=toks, **out)


def test_config_and_init_shapes(ref):
    assert dataclasses.asdict(ref["tcfg"]) == dataclasses.asdict(ref["cfg"])
    assert dataclasses.asdict(TB.Blip2Config()) == dataclasses.asdict(
        JB.Blip2Config())
    mine = TB.init_blip2(torch.Generator().manual_seed(0), ref["tcfg"],
                         "cpu")
    assert leaf_names(mine) == leaf_names(ref["tparams"])
    for a, b in zip(tree_leaves(mine), tree_leaves(ref["tparams"])):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the scalar and the plain arrays cross as tensors
    assert ref["tparams"]["logit_scale"].shape == ()
    assert ref["tparams"]["queries"].shape == (8, 64)


@pytest.mark.parametrize("mode", ["queries", "queries+text", "text"])
def test_qformer_modes_match_jax(ref, mode):
    """On the JAX package's image features: queries only, queries with
    text (a PAD mask over the text), and the unimodal text mode."""
    feats = t(np32(ref["feats"])).bfloat16()
    toks = torch.from_numpy(ref["toks"])
    got = {"queries": lambda: TB.qformer(ref["tparams"], feats, ref["tcfg"]),
           "queries+text": lambda: TB.qformer(ref["tparams"], feats,
                                              ref["tcfg"], text_tokens=toks),
           "text": lambda: TB.qformer(ref["tparams"], None, ref["tcfg"],
                                      text_tokens=toks)}[mode]()
    want = ref[{"queries": "q", "queries+text": "qt", "text": "txt"}[mode]]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=0)


def test_qformer_text_mode_needs_tokens(ref):
    with pytest.raises(ValueError, match="text_tokens"):
        TB.qformer(ref["tparams"], None, ref["tcfg"])


def test_image_queries_and_scores_match_jax(ref):
    ti, tt = torch.from_numpy(ref["imgs"]), torch.from_numpy(ref["toks"])
    enc = TB.encode_image_queries(ref["tparams"], ti, ref["tcfg"])
    np.testing.assert_allclose(np32(enc), np32(ref["enc"]), atol=ATOL,
                               rtol=0)
    itc = TB.itc_score(ref["tparams"], ti, tt, ref["tcfg"])
    itm = TB.itm_score(ref["tparams"], ti, tt, ref["tcfg"])
    assert itc.dtype == itm.dtype == torch.float32
    assert itc.shape == itm.shape == (3,)
    np.testing.assert_allclose(np32(itc), np32(ref["itc"]), atol=SCORE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(np32(itm), np32(ref["itm"]), atol=SCORE_ATOL,
                               rtol=0)


def test_lm_logits_match_jax(ref):
    got = TB.lm_logits(ref["tparams"], torch.from_numpy(ref["imgs"]),
                       torch.from_numpy(ref["toks"]), ref["tcfg"])
    assert got.dtype == torch.bfloat16 and got.shape == ref["logits"].shape
    np.testing.assert_allclose(np32(got), np32(ref["logits"]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("blocks", [True, False])
def test_generate_matches_jax(ref, blocks):
    """Tokens and lengths equal, step logits within ATOL, on the block
    route and on the route of separate calls, each against the JAX
    package's counterpart (with and without its block kernels)."""
    toks, logits, lengths = TB.generate(
        ref["tparams"], torch.from_numpy(ref["imgs"]),
        torch.Generator().manual_seed(0), ref["tcfg"], decode_blocks=blocks)
    jt, jl, jlen = (np32(x) for x in ref["gen_blocks" if blocks
                                         else "gen_calls"])
    assert toks.dtype == lengths.dtype == torch.int32
    assert toks.shape == jt.shape == (3, ref["cfg"].max_caption_len)
    np.testing.assert_array_equal(np32(toks), jt)
    np.testing.assert_array_equal(np32(lengths), jlen)
    assert logits.dtype == torch.bfloat16 and logits.shape == jl.shape
    np.testing.assert_allclose(np32(logits), jl, atol=ATOL, rtol=0)


def test_generate_layout_after_eos(ref):
    """An EOS bias makes every row finish at its first step: BOS, EOS, then
    PAD; lengths count the non-PAD tokens (2); as in the JAX package."""
    params = jax.tree_util.tree_map(np.asarray, ref["params"])
    params["lm_head"]["b"] = params["lm_head"]["b"].copy()
    params["lm_head"]["b"][EOS_ID] = 100.0
    with jax_kernel_path(blocks=True):
        jt, _, jlen = JB.generate(params, jnp.asarray(ref["imgs"]),
                                  jax.random.PRNGKey(0), ref["cfg"],
                                  max_len=6)
    toks, _, lengths = TB.generate(from_jax(params, "cpu"),
                                   torch.from_numpy(ref["imgs"]), None,
                                   ref["tcfg"], max_len=6)
    np.testing.assert_array_equal(np32(toks), np32(jt))
    np.testing.assert_array_equal(np32(lengths), np32(jlen))
    assert (np32(toks)[:, :2] == [1, EOS_ID]).all()
    assert (np32(toks)[:, 2:] == PAD_ID).all() and (np32(lengths) == 2).all()


def test_caption_loss_and_gradients_match_jax(ref):
    """The loss within the larger of 1e-3 of it and 3x the JAX package's
    own spread under a 1e-4 move of its weights; every leaf's gradient
    within the larger of 5% of its norm and 3x that spread (C.20); a leaf
    with a non-zero JAX gradient non-zero and finite here."""
    ji, jt = jnp.asarray(ref["imgs"]), jnp.asarray(ref["toks"])
    with jax_train_path():
        vg = jax.jit(jax.value_and_grad(
            lambda p: JB.blip2_caption_loss(p, ji, jt, ref["cfg"])))
        loss, grads = vg(ref["params"])
        moved = [vg(perturbed(ref["params"], s)) for s in (1, 2)]
    flat = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - w))
                   for m in ms) for w, ms in zip(flat, zip(*(
                       [np32(g) for g in jax.tree_util.tree_leaves(mv[1])]
                       for mv in moved)))]
    loss_spread = max(abs(float(mv[0]) - float(loss)) for mv in moved)
    got_loss, _, got_grads = value_and_grad(
        lambda p: (TB.blip2_caption_loss(p, torch.from_numpy(ref["imgs"]),
                                         torch.from_numpy(ref["toks"]),
                                         ref["tcfg"]), {}), ref["tparams"])
    assert abs(float(got_loss) - float(loss)) <= max(
        1e-3 * abs(float(loss)), 3 * loss_spread)
    got = [np32(g) for g in tree_leaves(got_grads)]
    names = leaf_names(ref["tparams"])
    errs = gradient_errors(got, flat, spreads, 5e-2, 3.0)
    bad = [(n, e, l) for n, (e, l) in zip(names, errs) if e > l]
    assert not bad, bad
    for n, g, w in zip(names, got, flat):
        if np.any(w):
            assert np.any(g) and np.all(np.isfinite(g)), n
