"""The consensus LM (`models/llm.py`), the attention arguments it and the
BLIP-2 LM need (`common.mha` / `block`: `causal`, `cache_block_causal`),
the LLM consensus of the pseudo-captioner (`_hf_llm_consensus`,
`--llm-path`), and the calls that refused the mixture-of-experts
captioner until ROADMAP C.33 was closed, against the JAX package at tiny
sizes on the CPU.

The JAX side runs with its kernels in interpret mode (`jax_kernel_path`)
for inference and on its default path (`jax_train_path`) for gradients.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import CaptionerConfig as JCapCfg
from embodied_captioning_tpu.labeling import pseudocaptioner as JPC
from embodied_captioning_tpu.models import captioner as JCap
from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models import llm as JL
from embodied_captioning_tpu_torch import finetune_captioner
from embodied_captioning_tpu_torch import selfcheck_training as ST
from embodied_captioning_tpu_torch.config import CaptionerConfig, load_config
from embodied_captioning_tpu_torch.labeling import pseudocaptioner as TPC
from embodied_captioning_tpu_torch.models import captioner as TCap
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models import llm as TL
from embodied_captioning_tpu_torch.params import from_jax, init_perception
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, value_and_grad,
)
from torch_parity import (
    gradient_errors, jax_kernel_path, jax_train_path, leaf_names, np32,
    perturbed, t,
)

# bf16 logits and stream: the CoCa tests' limit (test_torch_generate.py)
LOGIT_ATOL = 5e-2


# ---------------------------------------------------------------------------
# C.33 (handled): the calls that refused the mixture-of-experts captioner
# build and run it (tests/test_torch_moe.py holds it to the JAX package)
# ---------------------------------------------------------------------------

def _moe_cfg() -> CaptionerConfig:
    tiny = CaptionerConfig.tiny()
    return dataclasses.replace(
        tiny, text=dataclasses.replace(tiny.text, moe_experts=4))


def test_init_captioner_refuses_moe_experts():
    """`init_captioner` with `text.moe_experts=4` builds MoE text blocks
    ("moe" in place of "mlp", 4 stacked experts); the multimodal blocks
    keep their dense MLPs."""
    p = TCap.init_captioner(torch.Generator().manual_seed(0), _moe_cfg(),
                            "cpu")
    for blk in p["text_blocks"]:
        assert "moe" in blk and "mlp" not in blk
        assert blk["moe"]["fc_w"].shape == (4, 64, 256)
        assert blk["moe"]["gate"]["w"].shape == (64, 4)
    assert all("mlp" in blk for blk in p["mm_blocks"])


def test_block_refuses_a_moe_key():
    """A JAX MoE captioner's text block (its "moe" key in place of "mlp")
    handed through `from_jax` runs through the port's `block` and matches
    the JAX package's block."""
    jcfg = JCapCfg.tiny()
    jcfg = dataclasses.replace(
        jcfg, text=dataclasses.replace(jcfg.text, moe_experts=4))
    jp = JCap.init_captioner(jax.random.PRNGKey(0), jcfg)
    blk = from_jax(jp["text_blocks"][0], "cpu")
    assert "moe" in blk
    x = np.random.default_rng(0).standard_normal((2, 3, 64)).astype(
        np.float32)
    with jax_train_path():
        want = JC.block(jp["text_blocks"][0],
                        jnp.asarray(x, jnp.bfloat16), 2)[0]
    got = TC.block(blk, torch.from_numpy(x).to(torch.bfloat16), 2)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_ATOL,
                               rtol=0)


def test_entry_points_refuse_moe_experts(tmp_path, capsys):
    """`init_perception` (every Perceiver), the captioner self-check and
    the fine-tune run with `captioner.text.moe_experts=4`."""
    from test_torch_finetune import _write_store

    from embodied_captioning_tpu_torch.utils import obs_store

    over = ["captioner.text.moe_experts=4"]
    per = init_perception(torch.Generator().manual_seed(0),
                          load_config("tiny", overrides=over), "cpu")
    assert "moe" in per.captioner["text_blocks"][0]
    assert ST.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                    "--train-crops", "24", "--train-scenes", "3",
                    "--train-steps-per-scene", "6", "--test-crops", "6",
                    "--eval-scenes", "1"] + over) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["train_crops"] == 24 and np.isfinite(line["last_loss"])
    store = tmp_path / "obs"
    _write_store(obs_store, str(store))
    assert finetune_captioner.main([str(store), "--device", "cpu",
                                    "--batch", "4", "--save",
                                    str(tmp_path / "c.pkl")] + over) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] >= 1 and np.isfinite(line["last_loss"])
    assert (tmp_path / "c.pkl").exists()


# ---------------------------------------------------------------------------
# common: causal and cache_block_causal
# ---------------------------------------------------------------------------

D, H = 64, 2


@pytest.fixture(scope="module")
def attn_params():
    p = JC.mha_init(jax.random.PRNGKey(4), D, H)
    return p, from_jax(p, "cpu")


def _x(t_len: int, seed: int = 0, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, t_len, D)).astype(np.float32)


def test_prefix_priming_sees_every_written_position(attn_params):
    """A multi-token write with `cache_block_causal=False` after an
    earlier write: each new query sees every position written so far
    (not only those up to its own), as the JAX package's `mha`; the cache
    holds the same keys and values and its index moves by the block."""
    jp, tp = attn_params
    first, block_ = _x(3, 1), _x(5, 2)
    jc = JC.KVCache.create(2, 12, H, D // H)
    tc = TC.KVCache.create(2, 12, H, D // H, "cpu")
    with jax_kernel_path():
        _, jc = JC.mha(jp, jnp.asarray(first, jnp.bfloat16), H, cache=jc)
        want, jc = JC.mha(jp, jnp.asarray(block_, jnp.bfloat16), H,
                          cache=jc, cache_block_causal=False)
    _, tc = TC.mha(tp, t(first).bfloat16(), H, cache=tc)
    got, tc = TC.mha(tp, t(block_).bfloat16(), H, cache=tc,
                     cache_block_causal=False)
    assert tc.index == int(jc.index) == 8
    np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(np32(tc.k), np32(jc.k), atol=LOGIT_ATOL,
                               rtol=0)
    # the causal write differs from it: the first queries of the block see
    # fewer keys
    tc2 = TC.KVCache.create(2, 12, H, D // H, "cpu")
    _, tc2 = TC.mha(tp, t(first).bfloat16(), H, cache=tc2)
    causal, _ = TC.mha(tp, t(block_).bfloat16(), H, cache=tc2)
    assert not torch.equal(causal[:, 0], got[:, 0])
    assert torch.equal(causal[:, -1], got[:, -1])


def test_one_token_write_without_block_causality_takes_no_kernel(
        attn_params, monkeypatch):
    """At `cache_block_causal=False` neither the decode self-attention nor
    the self block kernel runs (the JAX condition), also for one token."""
    _, tp = attn_params

    def refuse(*a, **k):
        raise AssertionError("a decode kernel ran")

    monkeypatch.setattr(TC, "decode_self_attention", refuse)
    monkeypatch.setattr(TC, "_decode_self_block", refuse)
    cache = TC.KVCache.create(2, 8, H, D // H, "cpu")
    x = t(_x(1, 3)).bfloat16()
    TC.mha(tp, x, H, cache=cache, cache_block_causal=False)
    blk = from_jax(JC.block_init(jax.random.PRNGKey(5), D, H), "cpu")
    TC.block(blk, x, H, cache=TC.KVCache.create(2, 8, H, D // H, "cpu"),
             cache_block_causal=False)


def test_causal_with_a_mask_is_plain_attention(attn_params, monkeypatch):
    """The JAX `mha` with an explicit mask and `causal=True` (how its
    `llm.lm_logits` calls it) ANDs the tril into the mask and takes the
    plain attention. The port's `lm_logits` passes the tril mask itself:
    the same masked attention, no flash kernel, and the JAX result, with
    a padding mask ANDed in as well."""
    jp, tp = attn_params
    x = _x(7, 6)
    pad = np.ones((2, 1, 1, 7), bool)
    pad[1, ..., 5:] = False
    tril = TC.causal_mask(7)
    with jax_kernel_path():
        want_tril = JC.mha(jp, jnp.asarray(x, jnp.bfloat16), H,
                           mask=jnp.asarray(tril.numpy()), causal=True)[0]
        want_pad = JC.mha(jp, jnp.asarray(x, jnp.bfloat16), H,
                          mask=jnp.asarray(pad), causal=True)[0]

    def refuse(*a, **k):
        raise AssertionError("the flash kernel ran")

    monkeypatch.setattr(TC, "flash_attention", refuse)
    got_tril = TC.mha(tp, t(x).bfloat16(), H, mask=tril)[0]
    got_pad = TC.mha(tp, t(x).bfloat16(), H,
                     mask=torch.from_numpy(pad) & tril)[0]
    for got, want in ((got_tril, want_tril), (got_pad, want_pad)):
        np.testing.assert_allclose(np32(got), np32(want), atol=LOGIT_ATOL,
                                   rtol=0)
    assert not torch.equal(got_tril, got_pad)


# ---------------------------------------------------------------------------
# models/llm.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = JL.LMConfig.tiny()
    params = JL.init_lm(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, (3, 24)).astype(np.int32)
    tokens[:, 0] = 1
    tokens[0, 18:] = 0
    tokens[2, 11:] = 0
    prefix = np.array([3, 6, 1], np.int32)
    with jax_kernel_path():
        logits = JL.lm_logits(params, jnp.asarray(tokens), cfg)
        slp = JL.sequence_log_prob(params, jnp.asarray(tokens), cfg,
                                   jnp.asarray(prefix))
    return dict(cfg=cfg, tcfg=TL.LMConfig.tiny(), params=params,
                tparams=from_jax(params, "cpu"), tokens=tokens, prefix=prefix,
                logits=np32(logits), slp=np32(slp))


def test_lm_config_and_init_shapes(lm):
    assert dataclasses.asdict(lm["tcfg"]) == dataclasses.asdict(lm["cfg"])
    assert dataclasses.asdict(TL.LMConfig()) == dataclasses.asdict(
        JL.LMConfig())
    mine = TL.init_lm(torch.Generator().manual_seed(0), lm["tcfg"], "cpu")
    assert leaf_names(mine) == leaf_names(lm["tparams"])
    for a, b in zip(tree_leaves(mine), tree_leaves(lm["tparams"])):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_lm_logits_match_jax(lm):
    """bf16 logits of a float32 residual stream (the LayerNorm kernel's
    float32 rows) within LOGIT_ATOL."""
    got = TL.lm_logits(lm["tparams"], torch.from_numpy(lm["tokens"]),
                       lm["tcfg"])
    assert got.dtype == torch.bfloat16 and got.shape == lm["logits"].shape
    np.testing.assert_allclose(np32(got), lm["logits"], atol=LOGIT_ATOL,
                               rtol=0)


def test_sequence_log_prob_matches_jax(lm):
    """Mean log-probs of the continuations after each prefix: means of
    float32 log-softmax of logits within LOGIT_ATOL, so within it too."""
    got = TL.sequence_log_prob(lm["tparams"], torch.from_numpy(lm["tokens"]),
                               lm["tcfg"], torch.from_numpy(lm["prefix"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), lm["slp"], atol=1e-2, rtol=0)


def test_lm_loss_and_gradients_match_jax(lm):
    """The loss within the larger of 1e-3 of it and 3x the JAX package's
    own spread under a 1e-4 move of its weights; every leaf's gradient
    within the larger of 5% of its norm and 3x that spread (C.20)."""
    tok = jnp.asarray(lm["tokens"])
    with jax_train_path():
        vg = jax.jit(jax.value_and_grad(
            lambda p: JL.lm_loss(p, tok, lm["cfg"])))
        loss, grads = vg(lm["params"])
        moved = [vg(perturbed(lm["params"], s)) for s in (1, 2)]
    flat = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - w))
                   for m in ms) for w, ms in zip(flat, zip(*(
                       [np32(g) for g in jax.tree_util.tree_leaves(mv[1])]
                       for mv in moved)))]
    loss_spread = max(abs(float(mv[0]) - float(loss)) for mv in moved)
    got_loss, _, got_grads = value_and_grad(
        lambda p: (TL.lm_loss(p, torch.from_numpy(lm["tokens"]), lm["tcfg"]),
                   {}), lm["tparams"])
    lim = max(1e-3 * abs(float(loss)), 3 * loss_spread)
    assert abs(float(got_loss) - float(loss)) <= lim
    got = [np32(g) for g in tree_leaves(got_grads)]
    names = leaf_names(lm["tparams"])
    errs = gradient_errors(got, flat, spreads, 5e-2, 3.0)
    bad = [(n, e, l) for n, (e, l) in zip(names, errs) if e > l]
    assert not bad, bad


CAPTION_SETS = (
    ["a red couch", "a red couch near the wall", "a green plant"],
    ["a tv", "a black tv on a table", "a television", "a tv"],
    ["a white toilet", "a bed"],
)


def test_consensus_lm_chooses_the_jax_caption(lm):
    """`ConsensusLM.choose` on the JAX package's weights picks the JAX
    package's caption (the scores' gaps are above the LOGIT_ATOL-level
    differences on these sets), and a single caption is returned as is."""
    jc = JL.ConsensusLM(lm["cfg"], params=lm["params"])
    tc = TL.ConsensusLM(lm["tcfg"], params=lm["tparams"], device="cpu")
    for caps in CAPTION_SETS:
        with jax_kernel_path():
            want = jc.choose(caps)
        assert tc.choose(caps) == want, caps
    assert tc.choose(["only one"]) == "only one"
    own = TL.ConsensusLM(seed=0, device="cpu")
    assert own.choose(CAPTION_SETS[0]) in CAPTION_SETS[0]


# ---------------------------------------------------------------------------
# the pseudo-captioner's LLM consensus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model(tmp_path_factory):
    """A tiny Hugging Face causal LM (one GPT-2 layer, 32 wide, seeded
    weights) and a byte-level BPE tokenizer trained on a few captions,
    built here and saved to a directory: no download."""
    transformers = pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    root = tmp_path_factory.mktemp("hf_llm")
    bpe = tokenizers.ByteLevelBPETokenizer()
    bpe.train_from_iterator(
        [" ".join(c) for c in CAPTION_SETS] * 4 + [
            "<Caption> </Caption> You are given multiple captions"],
        vocab_size=300, min_frequency=1)
    tok = transformers.PreTrainedTokenizerFast(tokenizer_object=bpe,
                                               eos_token="</s>")
    tok.add_special_tokens({"eos_token": "</s>"})
    tok.save_pretrained(root)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=len(tok), n_positions=512, n_embd=32, n_layer=1,
        n_head=2, eos_token_id=tok.eos_token_id,
        pad_token_id=tok.eos_token_id))
    model.save_pretrained(root)
    return str(root)


def test_hf_llm_consensus_matches_jax(hf_model):
    """The JAX package's function and the port's copy give the same string
    for each caption set (the same prompt, 32 greedy tokens, the text up
    to the closing tag, or the first caption), and keep one model per
    path."""
    for caps in CAPTION_SETS:
        want = JPC._hf_llm_consensus(hf_model, list(caps))
        assert TPC._hf_llm_consensus(hf_model, list(caps)) == want
    assert list(TPC._HF_LLM_CACHE) == [hf_model]


def test_llm_method_with_a_model_path_matches_jax(hf_model, monkeypatch):
    """`PseudoCaptioner(method="llm", llm_path=...)` against the JAX
    package's with ECAP_LLM_PATH: the same pseudo-caption an object."""
    groups = {(0, i): list(c) for i, c in enumerate(CAPTION_SETS)}
    monkeypatch.setenv("ECAP_LLM_PATH", hf_model)
    want = JPC.PseudoCaptioner(method="llm").consensus(groups)
    got = TPC.PseudoCaptioner(method="llm", device="cpu",
                              llm_path=hf_model).consensus(groups)
    assert got == want and len(got) == len(CAPTION_SETS)


def test_llm_method_without_a_model_is_the_sbert_pick(tmp_path):
    """A missing path, and a directory that holds no model (the load
    fails), give the sbert consensus, as in the JAX package."""
    groups = {(0, i): list(c) for i, c in enumerate(CAPTION_SETS)}
    cfg = load_config("tiny")
    sbert = TPC.PseudoCaptioner(cfg, method="sbert",
                                device="cpu").consensus(groups)
    for path in (str(tmp_path / "missing"), str(tmp_path)):
        got = TPC.PseudoCaptioner(cfg, method="llm", device="cpu",
                                  llm_path=path).consensus(groups)
        assert got == sbert, path
