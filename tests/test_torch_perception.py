"""The port's `perceive` against the JAX package's, tiny preset. The port
runs its default route (fused preprocess, whole-block decode kernels: their
plain versions on the CPU); the JAX package runs with ECAP_USE_PALLAS=1 and
ECAP_PALLAS_BLOCKS=1 (Pallas in interpret mode), its whole-block route. Its
`encode_image` never takes its fused preprocess kernel, so the port's is
held to the XLA spelling here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu import perception as JP
from embodied_captioning_tpu.config import ExperimentConfig as JCfg
from embodied_captioning_tpu.config import merge as jmerge
from embodied_captioning_tpu.models.tokenizer import (
    default_tokenizer as j_tokenizer,
)
from embodied_captioning_tpu_torch import perception as TP
from embodied_captioning_tpu_torch.config import ExperimentConfig as TCfg
from embodied_captioning_tpu_torch.config import merge as tmerge
from embodied_captioning_tpu_torch.models.tokenizer import (
    default_tokenizer as t_tokenizer,
)
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32


@pytest.fixture(scope="module", params=[0, 2], ids=lambda s: f"slots{s}")
def perceive_pair(request):
    spf = request.param
    over = {"runtime": {"caption_slots_per_frame": spf},
            "detector": {"score_threshold": 0.0}}
    jc = jmerge(JCfg.preset_config("tiny"), over)
    tc = tmerge(TCfg.preset_config("tiny"), over)
    params = JP.init_perception(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    frames = (rng.random((3, 96, 96, 3)) * 255).astype(np.uint8)
    with jax_kernel_path(blocks=True):
        ref = JP.perceive(params, jnp.asarray(frames), jax.random.PRNGKey(1),
                          jc)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    tparams = from_jax(params, "cpu")
    out = TP.perceive(tparams, torch.from_numpy(frames), tc)
    return ref, out, tparams, tc, frames


def test_perceive_detections(perceive_pair):
    ref, out, *_ = perceive_pair
    jd, td = ref.detections, out.detections
    np.testing.assert_array_equal(np32(td.valid), np32(jd.valid))
    assert np32(jd.valid).sum() >= 3
    np.testing.assert_array_equal(np32(td.classes), np32(jd.classes))
    # bf16 boxes at 64 px: one ulp
    np.testing.assert_allclose(np32(td.boxes), np32(jd.boxes), atol=0.25,
                               rtol=0)
    np.testing.assert_allclose(np32(td.scores), np32(jd.scores), atol=5e-3,
                               rtol=0)
    # pasted mask probabilities: the mask head's conv + GroupNorm layers
    # reduce in another order than XLA, and a flipped bf16 rounding there
    # moves a probability by a few 1e-2
    np.testing.assert_allclose(np32(td.masks), np32(jd.masks), atol=5e-2,
                               rtol=0)


def test_perceive_captions_and_embeddings(perceive_pair):
    ref, out, *_ = perceive_pair
    np.testing.assert_array_equal(np32(out.caption_tokens),
                                  np32(ref.caption_tokens))
    np.testing.assert_array_equal(np32(out.caption_lengths),
                                  np32(ref.caption_lengths))
    assert (np32(ref.caption_lengths) > 1).sum() >= 3  # real decode work
    np.testing.assert_allclose(np32(out.caption_logprobs),
                               np32(ref.caption_logprobs), atol=5e-2, rtol=0)
    je = np32(ref.detections.embeddings).reshape(-1, 384)
    te = np32(out.detections.embeddings).reshape(-1, 384)
    live = np.linalg.norm(je, axis=1) > 0
    np.testing.assert_array_equal(np.linalg.norm(te, axis=1) > 0, live)
    cos = np.sum(je[live] * te[live], 1) / (
        np.linalg.norm(je[live], axis=1) * np.linalg.norm(te[live], axis=1))
    assert cos.min() > 0.999, cos


def test_perceive_decode_routes_agree(perceive_pair):
    # the route of separate calls (decode_blocks=False, which the JAX
    # package takes without ECAP_PALLAS_BLOCKS) gives the same captions
    _, out, tparams, tc, frames = perceive_pair
    res = TP.perceive(tparams, torch.from_numpy(frames), tc,
                      decode_blocks=False)
    assert torch.equal(res.caption_tokens, out.caption_tokens)
    np.testing.assert_allclose(np32(res.caption_logprobs),
                               np32(out.caption_logprobs), atol=5e-2, rtol=0)


def test_perceiver_process_and_captions(perceive_pair):
    ref, out, tparams, tc, frames = perceive_pair
    perceiver = TP.Perceiver(tc, params=tparams, device="cpu")
    res = perceiver.process(frames)
    assert torch.equal(res.caption_tokens, out.caption_tokens)
    tok = j_tokenizer(1024)
    want = [[tok.decode(r) for r in row] for row in ref.caption_tokens]
    assert perceiver.captions(res) == want


@pytest.mark.parametrize("vocab", [1024, 49408])
def test_tokenizer_matches_jax(vocab):
    text = ["a wooden table next to the wall", "tv", "ünïcode sofa  lamp"]
    jt, tt = j_tokenizer(vocab), t_tokenizer(vocab)
    for s in text:
        assert tt.encode(s) == jt.encode(s)
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s))
    np.testing.assert_array_equal(tt.encode_batch(text, 8),
                                  jt.encode_batch(text, 8))
