"""The quantized serving opt-ins through the other model families against
the JAX package on the CPU at tiny sizes: BLIP-2 (the ITC and ITM scores,
the teacher-forced LM logits, greedy `generate`), Florence (the
teacher-forced logits and greedy `generate` with int8 and bf16 cross
K/V), the consensus LM (`sequence_log_prob`, `ConsensusLM`) and the query
detector (its decoder's class and mask logits, the detections of
`detector.forward`, and `perceive` over it), each on a `quantize_params`
int8 tree with `w8a8` on, against the JAX package under `quantize._W8A8`
and ECAP_INT8_KV with its kernels (interpret mode, the whole-block
route).

The JAX package reads `_W8A8` when it traces and `jax.jit` keeps traces,
so every family's JAX reference is traced afresh (`jax.clear_caches()`),
once per module. Limits are the families' own tests' limits, widened
where W8A8 moves a number by an int8 level of an activation (amax / 127;
ROADMAP C.44), each stated where it is used."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu import perception as JP
from embodied_captioning_tpu.config import DetectorConfig as JDCfg
from embodied_captioning_tpu.config import ExperimentConfig as JCfg
from embodied_captioning_tpu.config import merge as jmerge
from embodied_captioning_tpu.models import blip2 as JB
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models import florence as JF
from embodied_captioning_tpu.models import llm as JL
from embodied_captioning_tpu.models import quantize as JQ
from embodied_captioning_tpu.models import query_detector as JQD
from embodied_captioning_tpu_torch import perception as TP
from embodied_captioning_tpu_torch.config import DetectorConfig as TDCfg
from embodied_captioning_tpu_torch.config import ExperimentConfig as TCfg
from embodied_captioning_tpu_torch.config import merge as tmerge
from embodied_captioning_tpu_torch.models import blip2 as TB
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.models import florence as TF
from embodied_captioning_tpu_torch.models import llm as TL
from embodied_captioning_tpu_torch.models import query_detector as TQD
from embodied_captioning_tpu_torch.models.tokenizer import PAD_ID
from embodied_captioning_tpu_torch.ops.detections import pairwise_iou
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32, perturbed, t

# every product of the tiny widths takes an int8 weight (the Florence
# tests' size)
MIN_SIZE = 1024
# greedy decoding of random weights flips at near-ties (ROADMAP C.8, C.12,
# C.44): each family's weight key and image seed were picked where every
# row of the JAX package's decode under W8A8 agrees with the port's (of
# weight keys 0-5 x image seeds 0-2, 5 cases for BLIP-2; 3 for Florence
# with int8 and with bf16 cross K/V)
BLIP2_KEY, BLIP2_IMAGES = 3, 0
FLORENCE_KEY, FLORENCE_IMAGES, FLORENCE_LEN = 5, 0, 12
# Under W8A8 a last-bit difference upstream moves an activation's int8
# level (amax / 127) and so a whole product's output, and the query
# decoder amplifies last-bit differences (ROADMAP C.29, C.44): whole
# outputs are held to 3x the JAX package's own spread under two 1e-4
# moves of the float weights, re-quantized (the query tests' rule), or
# 1e-2 of their norm, whichever is larger
SPREAD_FACTOR = 3.0
MOVES = (1, 2)


def _within_spread(got, want, moved, what: str) -> None:
    err = float(np.linalg.norm(np32(got) - want))
    spread = max(float(np.linalg.norm(m - want)) for m in moved)
    lim = max(1e-2 * float(np.linalg.norm(want)), SPREAD_FACTOR * spread)
    assert err <= lim, (what, err, spread, float(np.linalg.norm(want)))
QUERY = dict(image_size=64, backbone_width=16, fpn_dim=64, family="query",
             num_queries=16, query_layers=3, max_detections=8,
             score_threshold=0.0)


@contextlib.contextmanager
def _jax_w8a8(int8_kv: bool = True):
    """The JAX package's kernel path (whole-block decode kernels) under
    `_W8A8` and ECAP_INT8_KV, traced afresh."""
    with jax_kernel_path(blocks=True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQ, "_W8A8", True)
        mp.setenv("ECAP_INT8_KV", "1" if int8_kv else "0")
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def _calls(monkeypatch) -> list:
    """The names of the decode kernels' wrappers `common` calls."""
    called = []
    for name in ("decode_self_block", "decode_cross_block", "decode_mlp",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    return called


def _tokens(cfg_vocab: int, seed: int, b: int = 3, t_len: int = 10):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    toks = rng.integers(3, cfg_vocab, (b, t_len)).astype(np.int32)
    toks[:, 0] = 1
    toks[1, 6:] = PAD_ID
    return imgs, toks


# ---------------------------------------------------------------------------
# BLIP-2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blip2():
    cfg = JB.Blip2Config.tiny()
    p = JB.init_blip2(jax.random.PRNGKey(BLIP2_KEY), cfg)
    q = JQ.quantize_params(p, min_size=MIN_SIZE)
    imgs, toks = _tokens(cfg.vocab_size, BLIP2_IMAGES)
    ji, jt = jnp.asarray(imgs), jnp.asarray(toks)

    def scores(tree):
        return dict(itc=JB.itc_score(tree, ji, jt, cfg),
                    itm=JB.itm_score(tree, ji, jt, cfg),
                    logits=JB.lm_logits(tree, ji, jt, cfg),
                    gen=JB.generate(tree, ji, jax.random.PRNGKey(0), cfg))

    with _jax_w8a8():
        ref = scores(q)
        moved = [scores(JQ.quantize_params(perturbed(p, s),
                                           min_size=MIN_SIZE))
                 for s in MOVES]
    return dict(ref=jax.tree_util.tree_map(np32, ref),
                moved=jax.tree_util.tree_map(np32, moved),
                cfg=TB.Blip2Config.tiny(), tq=from_jax(q, "cpu"),
                imgs=torch.from_numpy(imgs), toks=torch.from_numpy(toks))


def test_blip2_scores_and_logits_under_w8a8_match_jax(blip2):
    """ITC, ITM and the teacher-forced logits within the JAX package's
    spread (`_within_spread`); W8A8 moves them (the port's own run without
    it differs)."""
    b, ref = blip2, blip2["ref"]
    args = (b["tq"], b["imgs"], b["toks"], b["cfg"])
    for name, fn in (("itc", TB.itc_score), ("itm", TB.itm_score),
                     ("logits", TB.lm_logits)):
        got = fn(*args, w8a8=True)
        assert got.shape == ref[name].shape, name
        _within_spread(got, ref[name], [m[name] for m in b["moved"]], name)
    assert not torch.equal(TB.lm_logits(*args, w8a8=True),
                           TB.lm_logits(*args))


def test_blip2_generate_under_w8a8_matches_jax(blip2, monkeypatch):
    """Greedy tokens and lengths equal, the step logits within the JAX
    package's spread (`_within_spread`); each step runs as separate calls,
    the cached self-attention through the standalone
    `decode_self_attention` (the JAX package's `_decode_fusion_ok` under
    W8A8)."""
    b = blip2
    called = _calls(monkeypatch)
    toks, logits, lengths = TB.generate(b["tq"], b["imgs"], None, b["cfg"],
                                        w8a8=True)
    jt, jl, jlen = b["ref"]["gen"]
    assert set(called) == {"decode_self_attention"}
    assert len(called) == b["cfg"].lm_layers * (b["cfg"].max_caption_len - 1)
    np.testing.assert_array_equal(np32(toks), jt)
    np.testing.assert_array_equal(np32(lengths), jlen)
    assert (jlen > 2).sum() >= 2  # real decode work
    _within_spread(logits, jl, [m["gen"][1] for m in b["moved"]],
                   "step logits")


# ---------------------------------------------------------------------------
# Florence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def florence():
    cfg = JF.FlorenceConfig.tiny()
    p = JF.init_florence(jax.random.PRNGKey(FLORENCE_KEY), cfg)
    q = JQ.quantize_params(p, min_size=MIN_SIZE)
    imgs, toks = _tokens(cfg.vocab_size, FLORENCE_IMAGES, t_len=16)
    toks[:, 1] = cfg.task_offset + JF.TASK_OD
    ji, jt = jnp.asarray(imgs), jnp.asarray(toks)
    ref = {}
    for int8_kv in (True, False):
        with _jax_w8a8(int8_kv):
            if int8_kv:
                ref["logits"] = JF.florence_logits(q, ji, jt, cfg)
                ref["moved"] = [JF.florence_logits(JQ.quantize_params(
                    perturbed(p, s), min_size=MIN_SIZE), ji, jt, cfg)
                    for s in MOVES]
            ref[f"int8kv{int(int8_kv)}"] = JF.generate(
                q, ji, cfg, task=JF.TASK_CAPTION, max_len=FLORENCE_LEN)
    return dict(ref=jax.tree_util.tree_map(np32, ref),
                cfg=TF.FlorenceConfig.tiny(), tq=from_jax(q, "cpu"),
                imgs=torch.from_numpy(imgs), toks=torch.from_numpy(toks))


def test_florence_logits_under_w8a8_match_jax(florence):
    f = florence
    got = TF.florence_logits(f["tq"], f["imgs"], f["toks"], f["cfg"],
                             w8a8=True)
    _within_spread(got, f["ref"]["logits"], f["ref"]["moved"], "logits")
    assert not torch.equal(got, TF.florence_logits(f["tq"], f["imgs"],
                                                   f["toks"], f["cfg"]))


@pytest.mark.parametrize("int8_kv", [True, False],
                         ids=["int8kv", "bf16kv"])
def test_florence_generate_under_w8a8_matches_jax(florence, int8_kv,
                                                  monkeypatch):
    """Tokens and lengths equal with int8 and with bf16 cross K/V; each
    step as separate calls: the standalone decode self- and
    cross-attention, the latter on int8 K/V only with `int8_kv`."""
    f = florence
    kvs = []
    real = TC.precompute_kv
    monkeypatch.setattr(TC, "precompute_kv", lambda *a, **k: (
        kvs.append(real(*a, **k)), kvs[-1])[1])
    monkeypatch.setattr(TF, "precompute_kv", TC.precompute_kv)
    called = _calls(monkeypatch)
    toks, lengths = TF.generate(f["tq"], f["imgs"], f["cfg"],
                                max_len=FLORENCE_LEN, w8a8=True,
                                int8_kv=int8_kv)
    jt, jlen = f["ref"][f"int8kv{int(int8_kv)}"]
    assert set(called) == {"decode_self_attention", "decode_cross_attention"}
    assert len(kvs) == f["cfg"].layers
    assert all(isinstance(kv, TC.QuantizedKV) == int8_kv for kv in kvs)
    np.testing.assert_array_equal(np32(toks), jt)
    np.testing.assert_array_equal(np32(lengths), jlen)
    assert (jlen > 3).sum() >= 2


# ---------------------------------------------------------------------------
# the consensus LM
# ---------------------------------------------------------------------------

CAPTION_SETS = (
    ["a red couch", "a red couch near the wall", "a green plant"],
    ["a tv", "a black tv on a table", "a television", "a tv"],
)


def test_lm_sequence_log_prob_and_consensus_under_w8a8_match_jax():
    """`sequence_log_prob` within 1e-2 (a mean of float32 log-softmaxes of
    bf16 logits: the LM tests' limit, 5e-3, doubled for W8A8) and
    `ConsensusLM.choose` picks the JAX package's caption."""
    cfg = JL.LMConfig.tiny()
    q = JQ.quantize_params(JL.init_lm(jax.random.PRNGKey(0), cfg),
                           min_size=MIN_SIZE)
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, (3, 24)).astype(np.int32)
    toks[:, 0] = 1
    toks[2, 15:] = PAD_ID
    prefix = np.array([4, 9, 2], np.int32)
    jc = JL.ConsensusLM(cfg, params=q)
    with _jax_w8a8():
        want = np32(JL.sequence_log_prob(q, jnp.asarray(toks), cfg,
                                         jnp.asarray(prefix)))
        picks = [jc.choose(c) for c in CAPTION_SETS]
    tq = from_jax(q, "cpu")
    tcfg = TL.LMConfig.tiny()
    got = TL.sequence_log_prob(tq, torch.from_numpy(toks), tcfg,
                               torch.from_numpy(prefix), w8a8=True)
    np.testing.assert_allclose(np32(got), want, atol=1e-2, rtol=0)
    assert not torch.equal(got, TL.sequence_log_prob(
        tq, torch.from_numpy(toks), tcfg, torch.from_numpy(prefix)))
    tc = TL.ConsensusLM(tcfg, params=tq, device="cpu", w8a8=True)
    assert [tc.choose(c) for c in CAPTION_SETS] == picks


# ---------------------------------------------------------------------------
# the query detector
# ---------------------------------------------------------------------------

def _query_frames(seed: int, b: int = 2) -> np.ndarray:
    """Two coloured boxes a frame on a noisy ground (the query tests'
    scenes)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, (b, 64, 64, 3)).astype(np.uint8)
    for i in range(b):
        for _ in range(2):
            x, y = rng.integers(4, 40, 2)
            imgs[i, y:y + 20, x:x + 20] = rng.integers(80, 256, 3)
    return imgs


@pytest.fixture(scope="module")
def query():
    """The JAX package's decoder points and detections under W8A8 on an
    int8 tree, the decoder's spread under two 1e-4 moves of the float
    weights (re-quantized), and the port's on the same tree and frames."""
    jc, tc = JDCfg(**QUERY), TDCfg(**QUERY)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    q = JQ.quantize_params(p, min_size=MIN_SIZE)
    imgs = _query_frames(0)
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    with _jax_w8a8():
        fn = jax.jit(functools.partial(JQD._decode, cfg=jc))
        want = [[np32(a) for a in pr] for pr in fn(q, x)]
        moved = [[[np32(a) for a in pr] for pr in fn(
            JQ.quantize_params(perturbed(p, s), min_size=MIN_SIZE), x)]
            for s in (1, 2)]
        det = jax.tree_util.tree_map(np32, JD.forward(q, jnp.asarray(imgs),
                                                      jc))
    tq = from_jax(q, "cpu")
    with torch.no_grad():
        got = [[np32(a) for a in pr] for pr in TQD._decode(
            tq, torch.from_numpy(imgs).float() / 255.0, tc, w8a8=True)]
    return dict(want=want, moved=moved, got=got, det=det, tq=tq, tc=tc,
                imgs=imgs)


def test_query_decoder_under_w8a8_within_the_jax_spread(query):
    """Every supervision point's class and mask logits within 3x the JAX
    package's own spread (or 1e-2 of the norm), as the query tests hold
    the float decoder."""
    d = query
    assert len(d["got"]) == len(d["want"]) == QUERY["query_layers"] + 1
    for li, (g, w) in enumerate(zip(d["got"], d["want"])):
        for k in range(2):
            err = float(np.linalg.norm(g[k] - w[k]))
            spread = max(float(np.linalg.norm(m[li][k] - w[k]))
                         for m in d["moved"])
            lim = max(1e-2 * float(np.linalg.norm(w[k])),
                      SPREAD_FACTOR * spread)
            assert err <= lim, (li, k, err, spread)
    with torch.no_grad():
        plain = TQD._decode(d["tq"], torch.from_numpy(d["imgs"]).float()
                            / 255.0, d["tc"])
    assert not np.array_equal(np32(plain[-1][1]), d["got"][-1][1])


def _matched(a, b) -> int:
    """Valid detections of `a` with a valid detection of `b` of the same
    class at box IoU >= 0.5."""
    hit = 0
    for i in range(a.valid.shape[0]):
        iou = np32(pairwise_iou(t(a.boxes[i]), t(b.boxes[i])))
        same = np32(a.classes[i])[:, None] == np32(b.classes[i])[None]
        ok = (iou >= 0.5) & same & np32(a.valid[i])[:, None].astype(bool) \
            & np32(b.valid[i])[None].astype(bool)
        hit += int(ok.any(1).sum())
    return hit


def test_query_forward_under_w8a8_matches_jax(query):
    """`detector.forward(w8a8=True)` on a query config runs (it refused
    before) and keeps the JAX package's detections under W8A8 by matched
    share: at least 3/4 matched by class and box IoU >= 0.5, as the query
    tests hold the float forward."""
    d = query
    got = TD.forward(d["tq"], torch.from_numpy(d["imgs"]), d["tc"],
                     w8a8=True)
    want = d["det"]
    assert got.boxes.shape == want.boxes.shape
    assert got.masks.shape == want.masks.shape
    assert want.valid.sum() >= 4
    assert _matched(want, got) >= 0.75 * want.valid.sum()


# `perceive` over the query detector: the perception key and frames seed
# of a scan (keys 0-11 x frames seeds 0-3) where every caption of the JAX
# package's W8A8 run agrees with the port's (18 of the 48 cases) and the
# crops give more than one caption (3 distinct here)
QUERY_PERCEIVE_KEY, QUERY_PERCEIVE_FRAMES = 5, 0


@pytest.fixture(scope="module")
def query_perceive():
    """The JAX package's `perceive` with the query family under W8A8 on
    an int8 perception tree, and the port's on the same tree and frames."""
    jc = jmerge(JCfg.preset_config("tiny"), {"detector": QUERY})
    tc = tmerge(TCfg.preset_config("tiny"), {"detector": QUERY})
    params = JQ.quantize_params(
        JP.init_perception(jax.random.PRNGKey(QUERY_PERCEIVE_KEY), jc),
        min_size=64)
    imgs = _query_frames(QUERY_PERCEIVE_FRAMES)
    with _jax_w8a8():
        ref = jax.tree_util.tree_map(np.asarray, JP.perceive(
            params, jnp.asarray(imgs), jax.random.PRNGKey(1), jc))
    tparams = from_jax(params, "cpu")
    frames = torch.from_numpy(imgs)
    out = TP.perceive(tparams, frames, tc, w8a8=True)
    return dict(ref=ref, out=out, tparams=tparams, tc=tc, frames=frames)


def test_query_perceive_under_w8a8_takes_the_query_forward(query_perceive):
    """`perceive(w8a8=True)` with the query family against the JAX
    package's under W8A8: detections matched (class, box IoU >= 0.5) for
    at least 3/4, as the forward test holds them, and the caption tokens
    equal. Its detections are `detector.forward(w8a8=True)`'s on the same
    frames (boxes, classes, valid), and W8A8 moves them (the scores differ
    from the run without it)."""
    d = query_perceive
    ref, out, tparams, tc, frames = (d[k] for k in (
        "ref", "out", "tparams", "tc", "frames"))
    od, jd = out.detections, ref.detections
    assert od.boxes.shape == jd.boxes.shape
    assert np32(jd.valid).sum() >= 4
    assert _matched(jd, od) >= 0.75 * np32(jd.valid).sum()
    toks = np32(ref.caption_tokens)
    np.testing.assert_array_equal(np32(out.caption_tokens), toks)
    np.testing.assert_array_equal(np32(out.caption_lengths),
                                  np32(ref.caption_lengths))
    assert len(np.unique(toks.reshape(-1, toks.shape[-1]), axis=0)) > 1
    det = TD.forward(tparams.detector, frames, tc.detector, w8a8=True)
    for f in ("boxes", "classes", "valid"):
        assert torch.equal(getattr(od, f), getattr(det, f)), f
    plain = TP.perceive(tparams, frames, tc)
    assert not torch.equal(plain.detections.scores, od.scores)
