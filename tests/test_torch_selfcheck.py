"""The two learning self-checks against the JAX package at the tiny preset,
on the CPU: `SentenceEncoder`, the captioner self-check
(`selfcheck_training`) and the detector self-check (`selfcheck_detector`).

The whole-flow tests hand the JAX scripts' rendered corpora across (the
port's render can differ by one rgb level, ROADMAP C.11), through the
scripts' own cache files, and compare the port's own corpora only where no
rgb level enters: counts, captions, classes, boxes, masks. The training
loops start from the JAX package's seeded weights and the same numpy batch
draws; they hold each step's loss and the parameters after the steps (to
Adam's 2 lr an element a step). The entry points run beside the JAX
scripts on the same caches and weights: their JSON lines have the same
keys and types, and the first step's loss agrees.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.config import SentenceEncoderConfig as JSeCfg
from embodied_captioning_tpu.models import captioner as JCap
from embodied_captioning_tpu.models import detector as JDET
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu.models.tokenizer import default_tokenizer
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.train import captioner_train as JT
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch import selfcheck_training as ST
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.config import SentenceEncoderConfig as TSeCfg
from embodied_captioning_tpu_torch.models import captioner as TCap
from embodied_captioning_tpu_torch.models import detector as TDET
from embodied_captioning_tpu_torch.models import sbert as TSB
from embodied_captioning_tpu_torch.params import from_jax, load_pickle
from embodied_captioning_tpu_torch.train.optim import tree_leaves
from torch_parity import (
    jax_kernel_path, jax_train_path, np32, perturbed, torch_threads,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while this module runs (see torch_threads)."""
    with torch_threads(2):
        yield


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, jax_side: bool):
    """A script's or the port's `main` with `argv`: (rc, last JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _same_keys_and_types(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None or isinstance(v, float):
            assert got[k] is None or isinstance(got[k], (int, float)), k
        else:
            assert type(got[k]) is type(v), (k, got[k], v)


# ---------------------------------------------------------------------------
# SentenceEncoder
# ---------------------------------------------------------------------------

SENTENCES = ("a blue bed", "a white toilet", "a brown couch on the floor",
             "a green plant", "a black tv", "", "a table", "a blue bed",
             "two red chairs")


@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8])
def test_sentence_encoder_matches_jax(post_ln, n):
    """Groups that hit the power-of-two bucket's edges: the rows of the
    bucket's PAD padding are sliced off; within the encode_tokens parity
    test's limit (cosine > 0.9999 a row)."""
    jc = dataclasses.replace(JSeCfg.tiny(), post_ln=post_ln)
    tc = dataclasses.replace(TSeCfg.tiny(), post_ln=post_ln)
    p = JSB.init_sentence_encoder(jax.random.PRNGKey(1), jc)
    with jax_kernel_path():
        want = JSB.SentenceEncoder(p, jc).encode(SENTENCES[:n])
    got = TSB.SentenceEncoder(from_jax(p, "cpu"), tc).encode(SENTENCES[:n])
    assert got.shape == want.shape == (n, jc.embed_dim)
    assert got.dtype == np.float32
    cos = np.sum(got * np.asarray(want, np.float32), axis=1)
    assert cos.min() > 0.9999, cos


def test_sentence_encoder_create_and_empty():
    cfg = TSeCfg.tiny()
    a = TSB.SentenceEncoder.create(0, cfg, "cpu")
    b = TSB.SentenceEncoder.create(0, cfg, "cpu")
    c = TSB.SentenceEncoder.create(1, cfg, "cpu")
    e = a.encode(["a blue bed", "a white toilet"])
    np.testing.assert_array_equal(e, b.encode(["a blue bed",
                                               "a white toilet"]))
    assert not np.array_equal(e, c.encode(["a blue bed", "a white toilet"]))
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-5)
    assert a.encode([]).shape == (0, cfg.embed_dim)
    # one sentence alone and in a padded group embeds the same
    np.testing.assert_allclose(a.encode(["a blue bed"])[0], e[0], atol=1e-6)


# ---------------------------------------------------------------------------
# the captioner self-check
# ---------------------------------------------------------------------------

CAP_TRAIN = dict(episodes=3, steps=6, max_crops=24)
CAP_EVAL = dict(episodes=1, steps=3, max_crops=6)


@pytest.fixture(scope="module")
def cap_corpus(tmp_path_factory):
    """The JAX script's corpora (train from scene seeds 0.., eval from
    1000..), written to its cache files, and the port's own from the same
    seeds."""
    root = tmp_path_factory.mktemp("selfcheck_training")
    mod = _script("selfcheck_training")
    cfg = jload_config("tiny")
    tr = mod.collect(cfg, CAP_TRAIN["episodes"], CAP_TRAIN["steps"], 0,
                     CAP_TRAIN["max_crops"])
    te = mod.collect(cfg, CAP_EVAL["episodes"], CAP_EVAL["steps"], 1000,
                     CAP_EVAL["max_crops"])
    np.savez_compressed(root / "train.npz", crops=np.stack(tr[0]),
                        caps=np.asarray(tr[1]))
    np.savez_compressed(root / "eval.npz", crops=np.stack(te[0]),
                        caps=np.asarray(te[1]), classes=np.asarray(te[2]))
    tcfg = load_config("tiny")
    own_tr = ST.collect(tcfg, CAP_TRAIN["episodes"], CAP_TRAIN["steps"], 0,
                        CAP_TRAIN["max_crops"], "cpu")
    own_te = ST.collect(tcfg, CAP_EVAL["episodes"], CAP_EVAL["steps"], 1000,
                        CAP_EVAL["max_crops"], "cpu")
    return dict(mod=mod, root=root, train=tr, eval=te, own_train=own_tr,
                own_eval=own_te)


def test_collect_matches_jax_in_count_and_captions(cap_corpus):
    """Each ground-truth instance a crop, in the same order, with the same
    "a {colour} {class}" caption and class; the crops' shape and dtype."""
    for own, want in ((cap_corpus["own_train"], cap_corpus["train"]),
                      (cap_corpus["own_eval"], cap_corpus["eval"])):
        assert len(own[0]) == len(want[0]) > 0
        assert own[1] == want[1] and own[2] == want[2]
        assert own[0][0].shape == want[0][0].shape == (64, 64, 3)
        assert own[0][0].dtype == np.uint8
    assert len(set(cap_corpus["train"][1])) > 1


def test_color_word_matches_jax(cap_corpus):
    rng = np.random.default_rng(0)
    for albedo in list(rng.uniform(0, 1, (200, 3))) + [
            (0.55, 0.27, 0.15), (0.13, 0.55, 0.13), (0.92, 0.92, 0.95),
            (0.08, 0.08, 0.1), (0.66, 0.66, 0.86), (0.5, 0.4, 0.3)]:
        assert ST._color_word(albedo) == cap_corpus["mod"]._color_word(albedo)


CAP_STEPS, CAP_BATCH, CAP_LR = 3, 4, 1e-3


@pytest.fixture(scope="module")
def cap_train(cap_corpus):
    """The JAX script's unfused loop (batches drawn by
    default_rng(seed), zero object ids, all valid) and the port's `train`
    from the JAX package's seeded weights on the handed crops."""
    cfg = jload_config("tiny").captioner
    tok = default_tokenizer(cfg.text.vocab_size)
    images = np.stack(cap_corpus["train"][0])
    tokens = tok.encode_batch(cap_corpus["train"][1], cfg.text.context_length)
    params = JCap.init_captioner(jax.random.PRNGKey(0), cfg)

    def jax_loop(start):
        rng = np.random.default_rng(0)
        losses = []
        state = JT.create_train_state(jax.tree_util.tree_map(jnp.asarray,
                                                             start),
                                      lr=CAP_LR)
        for _ in range(CAP_STEPS):
            sel = rng.choice(len(images), CAP_BATCH, replace=False)
            state, aux = JT.train_step(
                state, jnp.asarray(images[sel]), jnp.asarray(tokens[sel]),
                jnp.zeros(CAP_BATCH, jnp.int32), jnp.ones(CAP_BATCH, bool),
                cfg, lr=CAP_LR)
            losses.append(float(aux["loss"]))
        return state, losses

    with jax_train_path():
        state, losses = jax_loop(jax.tree_util.tree_map(np.asarray, params))
        moved = [jax_loop(perturbed(params, s))[1] for s in (1, 2)]
    tcfg = load_config("tiny").captioner
    runs = {k: ST.train(from_jax(params, "cpu"), images, tokens, tcfg,
                        CAP_STEPS, CAP_BATCH, CAP_LR, 0, k, "cpu",
                        log=lambda m: None) for k in (1, 2)}
    return dict(params=params, losses=losses, spread=np.abs(
        np.array(moved) - np.array(losses)).max(axis=0), after=[
        np32(x) for x in jax.tree_util.tree_leaves(state.params)], runs=runs)


def test_captioner_training_loop_matches_jax(cap_train):
    """Each step's loss within the larger of 1e-3 of it (the fine-tune's
    train_step test reads 1e-5-5e-4 at one step) and 3x how far the JAX
    package's own loss at that step moves when its start moves by 1e-4 of
    itself (bf16 gradients, C.20: later steps read 1.3e-3), every
    parameter within 2 lr (1 + 0.01 |p|) a step of the JAX package's, and
    a read-back every 2 steps runs the same steps to the same bits."""
    state, losses, times = cap_train["runs"][1]
    assert len(losses) == CAP_STEPS and len(times) == CAP_STEPS - 1
    want = np.array(cap_train["losses"])
    lim = np.maximum(1e-3 * np.abs(want), 3 * cap_train["spread"])
    assert (np.abs(np.array(losses) - want) <= lim).all(), (losses, want,
                                                             lim)
    assert abs(losses[0] - want[0]) <= 1e-3 * abs(want[0])
    assert state.step == CAP_STEPS
    p0 = [np32(x) for x in jax.tree_util.tree_leaves(cap_train["params"])]
    worst = 0.0
    for a, b, w in zip(tree_leaves(state.params), cap_train["after"], p0):
        lim = CAP_STEPS * 2 * CAP_LR * (1 + 0.01 * np.abs(w)) + 1e-7
        worst = max(worst, float((np.abs(np32(a) - b) / lim).max()))
    assert worst <= 1.0, worst
    state2, losses2, times2 = cap_train["runs"][2]
    # windows of 2 steps: the first window's times are left out
    assert losses2 == losses and len(times2) == CAP_STEPS - 2
    for a, b in zip(tree_leaves(state.params), tree_leaves(state2.params)):
        assert torch.equal(a, b)


def test_evaluate_scores_the_jax_captions_alike(cap_corpus, cap_train):
    """`evaluate` on the JAX package's weights after the steps: greedy
    captions of the held-out crops, class-word accuracy and BLEU as the
    JAX script computes them from the same captions."""
    from embodied_captioning_tpu.utils.metrics import caption_scores

    crops, caps, classes = (np.stack(cap_corpus["eval"][0]),
                            cap_corpus["eval"][1], cap_corpus["eval"][2])
    state = cap_train["runs"][1][0]
    cfg = load_config("tiny")
    preds, acc, cos, bleu = ST.evaluate(state.params, crops, caps, classes,
                                        cfg, "cpu")
    assert len(preds) == len(caps) and 0.0 <= acc <= 1.0
    assert -1.0 <= cos <= 1.0 and 0.0 <= bleu <= 1.0
    names = ("couch", "plant", "bed", "table", "toilet", "tv")
    assert acc == sum(names[c] in p for p, c in zip(preds, classes)) / len(
        preds)
    assert bleu == pytest.approx(float(np.mean(
        [caption_scores(p, r)["bleu"] for p, r in zip(preds, caps)])))


@pytest.fixture(scope="module")
def cap_entry(cap_corpus):
    """The JAX script and the port's entry point on the JAX script's cache
    files, 2 steps of batch 4, the captioner's weights the JAX package's
    seeded ones on both sides; the port's also with --speculative (the
    JAX script's speculative timing compiles four more programs)."""
    root = cap_corpus["root"]
    argv = ["--preset", "tiny", "--steps", "2", "--batch", "4",
            "--train-cache", str(root / "train.npz"),
            "--eval-cache", str(root / "eval.npz")]
    params = JCap.init_captioner(jax.random.PRNGKey(0),
                                 jload_config("tiny").captioner)
    with jax_train_path():
        jrc, jline = _run_main(cap_corpus["mod"].main, argv, True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TCap, "init_captioner",
                   lambda g, cfg, dev: from_jax(params, dev))
        rc, line = _run_main(ST.main, argv + ["--speculative"], False)
    return dict(rc=rc, line=line, jrc=jrc, jline=jline)


def test_captioner_entry_point_line_matches_jax(cap_entry, cap_train):
    """The same keys and types; the corpora's counts and sha; the first
    step's loss (the training loop test's first batch: the same draw) as
    that test holds it."""
    got, want = cap_entry["line"], cap_entry["jline"]
    assert cap_entry["rc"] == 0 and cap_entry["jrc"] is None
    spec = got.pop("speculative")
    _same_keys_and_types(got, want)
    for k in ("train_crops", "test_crops", "seed", "eval_sha", "preset",
              "batch", "hbm_peak_gb", "hbm_limit_gb"):
        assert got[k] == want[k], k
    lim = max(1e-3 * abs(want["first_loss"]), 3 * cap_train["spread"][0])
    assert abs(got["first_loss"] - want["first_loss"]) <= lim + 1e-3
    # the JAX script's speculative entry (`scripts/selfcheck_training.py`)
    assert set(spec) == {"b1", "b4"}
    for b in ("b1", "b4"):
        assert set(spec[b]) == {"exact", "greedy_ms", "speculative_ms",
                                "speedup"}
        assert isinstance(spec[b]["exact"], bool)
    assert len(got["examples"]) == min(4, got["test_crops"])


def test_captioner_entry_point_needs_a_card_or_cpu(monkeypatch):
    """Without --device it asks for the card, and exits 2 where there is
    none (the card is hidden, so the test means the same on any host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ST.main(["--steps", "1"]) == 2


# ---------------------------------------------------------------------------
# the detector self-check
# ---------------------------------------------------------------------------

DET_TRAIN = dict(episodes=2, steps=3)
DET_EVAL = dict(episodes=1, steps=8)


@pytest.fixture(scope="module")
def det_corpus(tmp_path_factory):
    """The JAX script's corpora, saved by its `save_corpus`, and the port's
    own from the same seeds and walk draws."""
    root = tmp_path_factory.mktemp("selfcheck_detector")
    mod = _script("selfcheck_detector")
    cfg = jload_config("tiny")
    tr = mod.collect(cfg, DET_TRAIN["episodes"], DET_TRAIN["steps"], 0,
                     np.random.default_rng(0), skip_seeds=(500, 8))
    te = mod.collect(cfg, DET_EVAL["episodes"], DET_EVAL["steps"], 500,
                     np.random.default_rng(500))
    mod.save_corpus(str(root / "train.npz"), tr)
    mod.save_corpus(str(root / "eval.npz"), te)
    tcfg = load_config("tiny")
    own = SD.collect(tcfg, DET_TRAIN["episodes"], DET_TRAIN["steps"], 0,
                     np.random.default_rng(0), "cpu", skip_seeds=(500, 8))
    return dict(mod=mod, root=root, train=SD.load_corpus(
        str(root / "train.npz")), eval=SD.load_corpus(str(root / "eval.npz")),
        jax_train=tr, own=own)


def test_detector_corpus_loads_in_both_and_matches_jax(det_corpus, tmp_path):
    """The JAX script's file loads in the port with equal arrays and
    checksum, the port's file loads in the JAX script; the port's own
    frames have the JAX script's ground truth (the rgb aside, C.11)."""
    mod = det_corpus["mod"]
    jtr, tr = det_corpus["jax_train"], det_corpus["train"]
    assert len(tr) == len(jtr) == DET_TRAIN["episodes"] * DET_TRAIN["steps"]
    assert SD.corpus_checksum(tr) == mod.corpus_checksum(jtr)
    for (rgb, det), (jrgb, jdet) in zip(tr, jtr):
        np.testing.assert_array_equal(rgb, np.asarray(jrgb))
        for f in SD.FIELDS:
            np.testing.assert_array_equal(det[f], np.asarray(getattr(jdet,
                                                                     f)))
    SD.save_corpus(str(tmp_path / "port.npz"), det_corpus["own"])
    back = mod.load_corpus(str(tmp_path / "port.npz"))
    assert mod.corpus_checksum(back) == SD.corpus_checksum(det_corpus["own"])
    assert sum(int(d["valid"].sum()) for _, d in tr) > 0
    for (rgb, det), (jrgb, jdet) in zip(det_corpus["own"], jtr):
        assert rgb.shape == np.asarray(jrgb).shape and rgb.dtype == np.uint8
        for f in SD.FIELDS:
            want = np.asarray(getattr(jdet, f))
            assert det[f].dtype == want.dtype, f
            np.testing.assert_array_equal(det[f], want, err_msg=f)


DET_STEPS, DET_BATCH, DET_LR = 3, 4, 1e-3


@pytest.fixture(scope="module")
def det_train(det_corpus):
    """The JAX script's host loop (no augmentation: its batch is the
    frames' stack) and the port's `train` from the JAX package's seeded
    weights, on the handed frames; the port's device-train loop too."""
    frames = det_corpus["train"]
    cfg = jload_config("tiny").detector
    params = JDET.init_detector(jax.random.PRNGKey(0), cfg)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(DET_LR))

    @jax.jit
    def step_fn(p, o, images, gt):
        (loss, _), grads = jax.value_and_grad(
            lambda q: JDET.detector_loss(q, images, gt, cfg), has_aux=True)(p)
        upd, o = opt.update(grads, o, p)
        return optax.apply_updates(p, upd), o, loss

    def jax_loop(start):
        rng = np.random.default_rng(0)
        p, o, losses = start, opt.init(start), []
        for _ in range(DET_STEPS):
            idx = rng.choice(len(frames), DET_BATCH, replace=False)
            images = jnp.asarray(np.stack([frames[i][0] for i in idx]))
            gt = JDet(**{f: jnp.asarray(np.stack([frames[i][1][f]
                                                  for i in idx]))
                         for f in SD.FIELDS})
            p, o, loss = step_fn(p, o, images, gt)
            losses.append(float(loss))
        return p, losses

    p, losses = jax_loop(params)
    moved = [jax_loop(jax.tree_util.tree_map(jnp.asarray, perturbed(
        params, s)))[1] for s in (1, 2)]
    tcfg = load_config("tiny").detector
    runs = {mode: SD.train(from_jax(params, "cpu"), frames, tcfg, DET_STEPS,
                           DET_BATCH, lambda c: DET_LR, "ce",
                           np.random.default_rng(0), "cpu",
                           device_train=mode == "device", log=lambda m: None)
            for mode in ("host", "device")}
    return dict(params=params, losses=losses, spread=np.abs(
                    np.array(moved) - np.array(losses)).max(axis=0),
                after=[np32(x) for x in jax.tree_util.tree_leaves(p)],
                runs=runs)


def test_detector_training_loop_matches_jax(det_train):
    """Each step's loss within the larger of 1e-4 of it and 3x how far the
    JAX package's own loss at that step moves when its start moves by 1e-4
    of itself (the first step reads 4e-5; after one Adam step the bf16
    gradients' signs have moved some elements by 2 lr, and the JAX
    package's own second and third losses move by about as much as the
    port's sit from them), every parameter within 2 lr a step; the
    device-train loop without augmentation runs the host loop's steps to
    the same bits."""
    from embodied_captioning_tpu_torch.params import to_numpy

    params, _, read = det_train["runs"]["host"]
    assert sorted(read) == list(range(DET_STEPS))
    got = np.array([read[s] for s in range(DET_STEPS)])
    want = np.array(det_train["losses"])
    lim = np.maximum(1e-4 * np.abs(want), 3 * det_train["spread"])
    assert (np.abs(got - want) <= lim).all(), (got, want, lim)
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    got = jax.tree_util.tree_leaves(to_numpy(params))
    assert len(got) == len(det_train["after"])
    for a, b in zip(got, det_train["after"]):
        assert np.abs(a - b).max() <= DET_STEPS * 2 * DET_LR + 1e-6
    dparams, _, dread = det_train["runs"]["device"]
    assert dread[0] == read[0] and dread[DET_STEPS - 1] == read[DET_STEPS - 1]
    for a, b in zip(tree_leaves(params), tree_leaves(dparams)):
        assert torch.equal(a, b)


def test_device_train_with_augmentation_and_ema():
    """The device-train path's options on a tiny corpus: augmentation from
    a seeded generator (reproducible), the EMA between the start and the
    trained weights, read-backs at most every `scan_steps` steps."""
    tcfg = load_config("tiny").detector
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), {
        "boxes": np.array([[4, 4, 40, 30], [30, 20, 60, 60]], np.float32),
        "classes": np.array([1, 4], np.int32),
        "scores": np.ones(2, np.float32),
        "logits": np.eye(6, dtype=np.float32)[[1, 4]],
        "valid": np.array([True, True]),
        "masks": np.pad(np.ones((2, 32, 32), np.uint8),
                        ((0, 0), (8, 24), (8, 24)))}) for _ in range(6)]
    p0 = TDET.init_detector(torch.Generator().manual_seed(0), tcfg, "cpu")
    runs = [SD.train(p0, frames, tcfg, 5, 2, lambda c: 1e-3, "focal",
                     np.random.default_rng(1), "cpu", augment=True,
                     augment_crop=True, device_train=True, ema=0.5,
                     scan_steps=2, generator=torch.Generator().manual_seed(7),
                     log=lambda m: None) for _ in range(2)]
    (p, ema, read), (p2, _, read2) = runs
    assert read == read2 and sorted(read) == [0, 1, 4]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(p2)))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                     tree_leaves(ema)))
    # one step: the average of the start and the stepped weights
    p1, ema1, _ = SD.train(p0, frames, tcfg, 1, 2, lambda c: 1e-3, "ce",
                           np.random.default_rng(1), "cpu",
                           device_train=True, ema=0.5, log=lambda m: None)
    for a, e, b in zip(tree_leaves(p0), tree_leaves(ema1), tree_leaves(p1)):
        assert torch.equal(e, a * 0.5 + b * 0.5)


@pytest.fixture(scope="module")
def det_entry(det_corpus, tmp_path_factory):
    """The JAX script and the port's entry point on the JAX script's cache
    files, 2 steps with host augmentation (the same numpy draws on both
    sides), calibration and the saved artifact, the detector's weights the
    JAX package's seeded ones on both sides."""
    root = det_corpus["root"]
    out = tmp_path_factory.mktemp("det_entry")
    argv = ["--preset", "tiny", "--steps", "2", "--batch", "4",
            "--eval-scenes", "1", "--eval-ep-steps", "8", "--augment",
            "--augment-crop", "--calibrate",
            "--train-cache", str(root / "train.npz"),
            "--eval-cache", str(root / "eval.npz")]
    params = JDET.init_detector(jax.random.PRNGKey(0),
                                jload_config("tiny").detector)
    jrc, jline = _run_main(det_corpus["mod"].main, argv + [
        "--save", str(out / "j.pkl")], True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TDET, "init_detector",
                   lambda g, cfg, dev: from_jax(params, dev))
        rc, line = _run_main(SD.main, argv + ["--save", str(out / "t.pkl")],
                             False)
    return dict(rc=rc, line=line, jrc=jrc, jline=jline, out=out)


def test_detector_entry_point_line_matches_jax(det_entry):
    got, want = det_entry["line"], det_entry["jline"]
    assert det_entry["rc"] == 0 and det_entry["jrc"] is None
    _same_keys_and_types(got, want)
    for k in ("seed", "eval_sha", "frames", "steps", "map50_after_ema",
              "map50_after_tta", "map50_after_ema_tta"):
        assert got[k] == want[k], k
    assert {"map50_affine", "map50_served_int8"} <= set(got)
    assert abs(got["first_loss"] - want["first_loss"]) <= 2e-3 * abs(
        want["first_loss"]), (got["first_loss"], want["first_loss"])


def test_detector_artifact_loads_in_both_packages(det_entry):
    """The saved artifact: numpy trees in the JAX layout, the JAX script's
    keys; the JAX package runs `forward` on the port's trained params."""
    with open(det_entry["out"] / "j.pkl", "rb") as fh:
        jart = pickle.load(fh)
    art = load_pickle(str(det_entry["out"] / "t.pkl"))
    assert set(art) == set(jart)
    assert art["train_cfg"] == jart["train_cfg"]
    assert art["serving_cfg"] == jart["serving_cfg"]
    assert art["best"] == jart["best"] == "raw" and art["ema"] is None
    for k in ("params", "affine"):
        a = jax.tree_util.tree_leaves(art[k])
        b = jax.tree_util.tree_leaves(jart[k])
        assert [x.shape for x in a] == [np.shape(x) for x in b], k
    cfg = jload_config("tiny").detector
    det = JDET.forward(jax.tree_util.tree_map(jnp.asarray, art["params"]),
                       jnp.zeros((1, 64, 64, 3), jnp.uint8), cfg)
    assert det.boxes.shape == (1, cfg.max_detections, 4)


@pytest.mark.parametrize("flag", [["--tta"], ["--eval-wide", "4"],
                                  ["--eval-serving"], ["--ckpt", "x.pkl"],
                                  ["--affine-finetune", "5"],
                                  ["--pack-masks"],
                                  ["--eval-wide-cache", "w.npz"]])
def test_unported_flags_exit_2_naming_their_roadmap_item(flag, capsys):
    assert SD.main(flag + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP A.14" in err if flag == ["--tta"] else "ROADMAP A.15" in err


def test_detector_entry_point_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SD.main(["--steps", "1"]) == 2
