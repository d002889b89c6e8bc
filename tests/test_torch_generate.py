"""The port's caption generation (greedy and sampled `generate`,
`generate_beam`, `generate_speculative`, `perplexity`, `_sample`) against
the JAX package's, tiny preset on the CPU.

Both sides run their whole-block decode route: the port its default
(`decode_blocks=True`, the twins of the block kernels on the CPU), the JAX
package with ECAP_USE_PALLAS=1 and ECAP_PALLAS_BLOCKS=1 (Pallas in
interpret mode). The JAX entry points are jitted and read the variables at
trace time, so `jax_kernel_path` clears the jit caches on entry and exit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import CaptionerConfig as JCfg
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models.quantize import quantize_params as jqp
from embodied_captioning_tpu_torch.config import CaptionerConfig as TCfg
from embodied_captioning_tpu_torch.models import captioner as TCAP
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32, t

JC, TC = JCfg.tiny(), TCfg.tiny()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result of this file, computed under one block-route
    context: float weights (PRNGKey(0)) and their int8 quantisation, three
    64^2 crops from default_rng(0)."""
    params = JCAP.init_captioner(jax.random.PRNGKey(0), JC)
    rng = np.random.default_rng(0)
    imgs = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    jimgs, key = jnp.asarray(imgs), jax.random.PRNGKey(0)
    out = {"params": params, "imgs": imgs}
    with jax_kernel_path(blocks=True):
        out["greedy"] = _np(JCAP.generate(params, jimgs, key, JC))
        out["greedy_int8"] = _np(JCAP.generate(jqp(params), jimgs, key, JC))
        out["full"] = _np(JCAP.generate(params, jimgs, key, JC,
                                        full_logits=True))
        out["beam"] = _np(JCAP.generate_beam(params, jimgs, JC, num_beams=2))
        for w in (1, 4):
            out[f"spec{w}"] = _np(JCAP.generate_speculative(
                params, jimgs, JC, draft_len=w))
    return out


@pytest.fixture(scope="module")
def port_side(jax_side):
    return from_jax(jax_side["params"], "cpu"), t(jax_side["imgs"])


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_generate_block_route(jax_side, int8, monkeypatch):
    from embodied_captioning_tpu_torch.models import common as TCM

    ref = jax_side["greedy_int8" if int8 else "greedy"]
    params = jqp(jax_side["params"]) if int8 else jax_side["params"]
    called = set()
    for name in ("decode_self_block", "decode_cross_block",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TCM, name)
        monkeypatch.setattr(TCM, name, lambda *a, _f=fn, _n=name, **k: (
            called.add(_n), _f(*a, **k))[1])
    tokens, logp, lengths = TCAP.generate(from_jax(params, "cpu"),
                                          t(jax_side["imgs"]), TC)
    assert called == {"decode_self_block", "decode_cross_block"}
    assert tokens.dtype == torch.int32 and lengths.dtype == torch.int32
    np.testing.assert_array_equal(np32(tokens), ref[0])
    np.testing.assert_array_equal(np32(lengths), ref[2])
    assert (ref[2] > 2).all()                      # real decode work
    # chosen log-probs out of bf16 logits (|logit| < 4: an ulp is 1/64)
    np.testing.assert_allclose(np32(logp), ref[1], atol=5e-2, rtol=0)


def test_generate_routes_agree(port_side):
    # the port's two decode routes on the same weights: the block kernels
    # keep q in f32, the separate calls round it to bf16
    params, imgs = port_side
    a = TCAP.generate(params, imgs, TC)
    b = TCAP.generate(params, imgs, TC, decode_blocks=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    np.testing.assert_allclose(np32(a[1]), np32(b[1]), atol=5e-2, rtol=0)


def test_full_logits_and_perplexity(jax_side, port_side):
    params, imgs = port_side
    r_tok, r_logits, r_len = jax_side["full"]
    tokens, logits, lengths = TCAP.generate(params, imgs, TC,
                                            full_logits=True)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == r_logits.shape == (3, 11, 1024)
    np.testing.assert_array_equal(np32(tokens), r_tok)
    np.testing.assert_array_equal(np32(lengths), r_len)
    # bf16 logits, |logit| < 4: two ulps
    np.testing.assert_allclose(np32(logits), np32(r_logits), atol=2 ** -5,
                               rtol=0)
    # without full_logits the tokens are the same and the loop stops early
    g_tok, g_logp, _ = TCAP.generate(params, imgs, TC)
    assert torch.equal(g_tok, tokens)
    # perplexity: both input forms, on the JAX package's arrays (the same
    # function of the same numbers: 1e-5) and on the port's own
    for step_out in (jax_side["greedy"][1], r_logits):
        ref = np.asarray(JCAP.perplexity(jnp.asarray(step_out),
                                         jnp.asarray(r_tok)))
        got = TCAP.perplexity(t(step_out), t(r_tok))
        np.testing.assert_allclose(np32(got), ref, rtol=1e-5)
    own = TCAP.perplexity(g_logp, g_tok)
    np.testing.assert_allclose(np32(own), np32(TCAP.perplexity(logits,
                                                               tokens)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        np32(own), np.asarray(JCAP.perplexity(
            jnp.asarray(jax_side["greedy"][1]), jnp.asarray(r_tok))),
        rtol=5e-2)
    assert (np32(own) > 1).all()


def test_generate_beam(jax_side, port_side):
    # two beams on these crops: a beam search over a random-weight model
    # parts ways at near-ties more often than greedy decoding does (over 2
    # to 4 beams the best beam differs on 11 of 48 rows between the two
    # packages, and on 12 of 48 between the JAX package's own two routes:
    # `python tests/torch_parity.py beam` counts them)
    params, imgs = port_side
    r_tok, r_score = jax_side["beam"]
    tokens, scores = TCAP.generate_beam(params, imgs, TC, num_beams=2)
    assert tokens.dtype == torch.int32 and tuple(tokens.shape) == (3, 12)
    np.testing.assert_array_equal(np32(tokens), r_tok)
    # a sum of up to 11 log-probs out of bf16 logits, over the length
    np.testing.assert_allclose(np32(scores), r_score, atol=5e-2, rtol=0)
    # one beam is greedy decoding
    one, one_score = TCAP.generate_beam(params, imgs, TC, num_beams=1)
    g_tok, g_logp, g_len = TCAP.generate(params, imgs, TC)
    assert torch.equal(one, g_tok)
    np.testing.assert_allclose(np32(one_score),
                               np32(g_logp.sum(1) / g_len.float()),
                               atol=1e-4, rtol=0)
    # a wider search without length normalisation: BOS first, finite
    # scores, PAD only after the caption
    wide, wide_score = TCAP.generate_beam(params, imgs, TC, num_beams=3,
                                          length_penalty=0.0)
    assert (wide[:, 0] == TC.text.bos_id).all()
    assert torch.isfinite(wide_score).all() and (wide_score < 0).all()
    for row in wide.tolist():
        n = sum(x != TC.text.pad_id for x in row)
        assert all(x != TC.text.pad_id for x in row[:n])


@pytest.mark.parametrize("draft_len", [1, 4])
def test_generate_speculative(jax_side, port_side, draft_len):
    # against the JAX function: tokens and lengths equal. Against greedy
    # decoding on the same route: the JAX docstring promises bit-identity,
    # which its tests hold only with every kernel off. With the kernels on,
    # the verify pass at draft_len > 1 runs plain multi-token attention
    # (bf16 scores and probabilities, bf16 q) where greedy runs the block
    # kernels (f32 q and probabilities), in both packages, so identity is
    # no longer exact by construction; at the tiny preset with these
    # weights and crops the tokens still come out equal, in the port and
    # in the JAX package alike.
    params, imgs = port_side
    r_tok, r_len = jax_side[f"spec{draft_len}"]
    tokens, lengths = TCAP.generate_speculative(params, imgs, TC,
                                                draft_len=draft_len)
    assert tokens.dtype == torch.int32 and tuple(tokens.shape) == (3, 12)
    np.testing.assert_array_equal(np32(tokens), r_tok)
    np.testing.assert_array_equal(np32(lengths), r_len)
    g_tok, _, g_len = TCAP.generate(params, imgs, TC)
    assert torch.equal(tokens, g_tok) and torch.equal(lengths, g_len)
    np.testing.assert_array_equal(r_tok, jax_side["greedy"][0])


def test_generate_speculative_loop_shape(port_side, monkeypatch):
    # every macro step is draft_len one-token draft passes and one verify
    # pass of draft_len tokens; the loop stops when every row has finished
    # instead of running max_len - 1 macro steps, and accepted drafts make
    # it shorter than one verify pass per token
    params, imgs = port_side
    passes = []
    run = TCAP._run_tokens
    monkeypatch.setattr(TCAP, "_run_tokens", lambda p, tok, *a: (
        passes.append(tok.shape[1]), run(p, tok, *a))[1])
    tokens, lengths = TCAP.generate_speculative(
        params, imgs, TC, draft_len=4, draft_layers=TC.text.cross_layers)
    spec = list(passes)                  # the greedy run below adds its own
    g_tok, _, g_len = TCAP.generate(params, imgs, TC)
    assert torch.equal(tokens, g_tok) and torch.equal(lengths, g_len)
    assert spec[:5] == [1, 1, 1, 1, 4]
    assert spec.count(1) == 4 * spec.count(4)
    assert 3 <= spec.count(4) < int(g_len.max()) - 1


def _jax_kept(logits, top_k, top_p, temperature, monkeypatch):
    """The filtered logits the JAX `_sample` hands to its categorical
    draw."""
    seen = []
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: (seen.append(np.asarray(lg)),
                                                  jnp.argmax(lg, axis))[1])
    JCAP._sample(jnp.asarray(logits), jax.random.PRNGKey(0), top_k, top_p,
                 temperature)
    return seen[0]


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8),
                                         (20, 0.6), (1, 0.0)])
def test_sample_filters_keep_what_jax_keeps(top_k, top_p, monkeypatch):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, 200)) * 2).astype(np.float32)
    logits[0, :10] = 3.0                           # ties at the k-th value
    kept = _jax_kept(logits, top_k, top_p, 0.7, monkeypatch)
    got = TCAP._filter_logits(t(logits), top_k, top_p, 0.7)
    np.testing.assert_array_equal(np.isfinite(np32(got)), np.isfinite(kept))
    live = np.isfinite(kept)
    np.testing.assert_allclose(np32(got)[live], kept[live], rtol=1e-6)
    if top_k == 1:
        assert (live.sum(1)[1:] == 1).all()


def test_sample_temperature_zero_is_argmax_and_draws_follow_the_filter():
    rng = np.random.default_rng(4)
    logits = t((rng.standard_normal((4, 50)) * 2).astype(np.float32))
    assert torch.equal(TCAP._sample(logits, None, 5, 0.9, 0.0),
                       logits.argmax(-1))
    assert torch.equal(TCAP._sample(logits.bfloat16(), None, 0, 0.0, 0.0),
                       logits.bfloat16().float().argmax(-1))
    # draws under an explicit generator: reproducible, inside the kept set,
    # and with the kept set's frequencies (20,000 draws per row: a
    # frequency's standard error is below 0.004, the bound is 0.02)
    many = logits[:1].repeat(20000, 1)
    g = torch.Generator().manual_seed(0)
    a = TCAP._sample(many, g, 8, 0.0, 0.7)
    b = TCAP._sample(many, torch.Generator().manual_seed(0), 8, 0.0, 0.7)
    assert torch.equal(a, b)
    probs = torch.softmax(TCAP._filter_logits(logits[:1], 8, 0.0, 0.7), -1)[0]
    assert int((probs > 0).sum()) == 8
    freq = torch.bincount(a, minlength=50).float() / a.numel()
    assert float((freq - probs).abs().max()) < 0.02
    assert (freq[probs == 0] == 0).all()


def test_sampled_generate(port_side):
    params, imgs = port_side
    g = torch.Generator().manual_seed(5)
    tokens, logp, lengths = TCAP.generate(params, imgs, TC, top_k=50,
                                          top_p=0.9, temperature=0.7,
                                          generator=g)
    again = TCAP.generate(params, imgs, TC, top_k=50, top_p=0.9,
                          temperature=0.7,
                          generator=torch.Generator().manual_seed(5))
    assert torch.equal(tokens, again[0])
    pad, bos, eos = TC.text.pad_id, TC.text.bos_id, TC.text.eos_id
    assert (tokens[:, 0] == bos).all() and torch.isfinite(logp).all()
    for row, n in zip(tokens.tolist(), lengths.tolist()):
        assert pad not in row[:n] and all(x == pad for x in row[n:])
        assert eos not in row[:n - 1]
    assert not torch.equal(tokens, TCAP.generate(params, imgs, TC)[0])


def test_live_row_that_samples_pad_finishes(port_side, monkeypatch):
    params, imgs = port_side
    pad = TC.text.pad_id
    draws = iter([torch.tensor([7, pad, 9]), torch.tensor([8, 5, pad])])
    monkeypatch.setattr(TCAP, "_sample", lambda logits, *a: next(
        draws, torch.full((3,), TC.text.eos_id)))
    tokens, _, lengths = TCAP.generate(params, imgs, TC, temperature=1.0)
    assert tokens[:, :4].tolist() == [[1, 7, 8, 2], [1, pad, pad, pad],
                                      [1, 9, pad, pad]]
    assert lengths.tolist() == [4, 1, 2]
