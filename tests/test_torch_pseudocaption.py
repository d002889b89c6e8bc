"""The port's pseudo-captioning slice against the JAX package's, on the CPU
at tiny sizes: `labeling/pseudocaptioner.py` (grouping, filtering, the
store's records, the sbert, tfidf, clip / itc and llm consensus, the
last by its fallback), `labeling/caption_datasets.py`, and the
`pseudocaption` entry point beside `scripts/pseudocaption.py`.
"""

import contextlib
import csv
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import SentenceEncoderConfig as JSeCfg
from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.labeling import caption_datasets as JCD
from embodied_captioning_tpu.labeling import pseudocaptioner as JPC
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu.models.tokenizer import default_tokenizer
from embodied_captioning_tpu.perception import Perceiver as JPerceiver
from embodied_captioning_tpu_torch import pseudocaption
from embodied_captioning_tpu_torch.config import SentenceEncoderConfig
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.labeling import caption_datasets as TCD
from embodied_captioning_tpu_torch.labeling import pseudocaptioner as TPC
from embodied_captioning_tpu_torch.models import sbert as TSB
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.perception import Perceiver
from torch_parity import (
    STORE_OVERRIDES, jax_kernel_path, jax_store, jax_train_path,
)

REPO = Path(__file__).resolve().parents[1]

WORDS = ("a", "red", "blue", "brown", "couch", "bed", "tv", "plant", "table",
         "on", "the", "floor", "small", "large", "blurry", "dark")


def _groups(seed: int, n_objects: int = 12):
    """Caption sets of seeded objects: 1-6 views each, repeats (the tfidf
    frequencies), banned words and near-empty captions among them."""
    rng = np.random.default_rng(seed)
    groups = {}
    for o in range(n_objects):
        base = [" ".join(rng.choice(WORDS, int(rng.integers(2, 6))))
                for _ in range(3)]
        caps = [base[int(rng.integers(0, 3))]
                for _ in range(int(rng.integers(1, 7)))]
        if o % 5 == 0:
            caps.append("ab")
        groups[(o // 4, 100 + o)] = caps
    return groups


@pytest.fixture(scope="module")
def encoder():
    """The JAX package's seeded sentence encoder, and the port's on its
    weights."""
    jc, tc = JSeCfg.tiny(), SentenceEncoderConfig.tiny()
    p = JSB.init_sentence_encoder(jax.random.PRNGKey(0), jc)
    return (JSB.SentenceEncoder(p, jc),
            TSB.SentenceEncoder(from_jax(p, "cpu"), tc))


def test_grouping_filtering_and_frequencies_equal_jax():
    """tests/test_labeling.py's case, and seeded records."""
    recs = [{"episode": 0, "object_id": 5, "caption": "a red couch"},
            {"episode": 0, "object_id": 5, "caption": "a blurry mess"},
            {"episode": 0, "object_id": 6, "caption": "a tv"}]
    groups = TPC.group_captions(recs)
    assert len(groups[(0, 5)]) == 2
    assert TPC.filter_banned(groups[(0, 5)]) == ["a red couch"]
    assert TPC.caption_frequencies(["A tv", "a tv", "a couch"])["a tv"] == 2
    assert TPC.BANNED_WORDS == JPC.BANNED_WORDS
    for seed in (0, 1):
        g = _groups(seed)
        recs = [{"episode": k[0], "object_id": k[1], "caption": c}
                for k, v in g.items() for c in v]
        assert TPC.group_captions(recs) == JPC.group_captions(recs)
        for caps in g.values():
            assert TPC.filter_banned(caps) == JPC.filter_banned(caps)
            assert (TPC.caption_frequencies(caps)
                    == JPC.caption_frequencies(caps))


def _near_ties(jenc, groups, margin: float = 1e-3) -> set:
    """Groups whose best caption under the JAX package's sbert centroid is
    within `margin` of a different caption: two distinct captions seen
    equally often sit at exactly equal scores, so float rounding picks."""
    out = set()
    for key, caps in groups.items():
        caps = JPC.filter_banned(caps)
        if len(set(caps)) < 2:
            continue
        with jax_kernel_path():
            emb = np.asarray(jenc.encode(caps))
        c = emb.mean(0)
        score = emb @ (c / max(np.linalg.norm(c), 1e-9))
        best = int(np.argmax(score))
        others = [score[i] for i in range(len(caps)) if caps[i] != caps[best]]
        if score[best] - max(others) <= margin:
            out.add(f"{key[0]}_{key[1]}")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sbert_tfidf_and_llm_consensus_equal_jax(encoder, seed):
    """On the JAX package's encoder weights: tfidf picks the same captions;
    sbert and llm (with no model, both fall back to sbert) too, apart from
    near-ties (`_near_ties`: the embeddings are within 1e-3 of the JAX
    package's a row, so a tie within that falls either way)."""
    jenc, tenc = encoder
    groups = _groups(seed)
    ties = _near_ties(jenc, groups)
    for method in ("sbert", "tfidf", "llm"):
        jpc = JPC.PseudoCaptioner(method=method, sentence_encoder=jenc)
        tpc = TPC.PseudoCaptioner(method=method, sentence_encoder=tenc,
                                  device="cpu")
        with jax_kernel_path():
            want = jpc.consensus(groups)
        got = tpc.consensus(groups)
        assert sorted(got) == sorted(want) and len(want) >= 8
        skip = ties if method != "tfidf" else set()
        assert len(skip) <= 3
        for k in want:
            if k not in skip:
                assert got[k] == want[k], (method, k)
    assert (TPC.PseudoCaptioner(method="llm", sentence_encoder=tenc,
                                device="cpu").consensus(groups)
            == TPC.PseudoCaptioner(method="sbert", sentence_encoder=tenc,
                                   device="cpu").consensus(groups))


def test_cases_of_the_jax_tests_on_the_port():
    """tests/test_labeling.py's pseudo-captioner case on the port's own
    seeded encoder; an LLM path with no model at it gives the same picks
    (the sbert fallback, as in the JAX package)."""
    cfg = load_config("tiny")
    groups = {(0, 1): ["a red couch", "a red couch", "a green plant"],
              (0, 2): ["a tv"]}
    for method in ("sbert", "tfidf", "llm"):
        out = TPC.PseudoCaptioner(cfg, method=method,
                                  device="cpu").consensus(groups)
        assert out == {"0_1": "a red couch", "0_2": "a tv"}, method
    out = TPC.PseudoCaptioner(cfg, method="llm", device="cpu",
                              llm_path="/nonexistent").consensus(groups)
    assert out == {"0_1": "a red couch", "0_2": "a tv"}


@pytest.fixture(scope="module")
def perceivers():
    jcfg = jload_config("tiny")
    jp = JPerceiver(jcfg)
    tp = Perceiver(load_config("tiny"), params=from_jax(jp.params, "cpu"),
                   device="cpu")
    return jp, tp


@pytest.mark.parametrize("k", [2, 3, 5])
def test_clip_consensus_matches_jax(perceivers, k):
    """`_clip_consensus` through `captioner.forward` on the JAX package's
    weights (its training path, which the port's `forward` mirrors), the
    caption count padded to a power of two: the scores (dot products of
    unit embeddings from bf16 towers) within 5e-3 (measured 1.3e-3 to
    2.6e-3 over 2-8 captions), the same choice where the best two are
    more than 1e-2 apart."""
    jp, tp = perceivers
    rng = np.random.default_rng(k)
    crop = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    caps = [" ".join(rng.choice(WORDS[:12], 3)) for _ in range(k)]
    jpc = JPC.PseudoCaptioner(jp.cfg, perceiver=jp, method="clip")
    tpc = TPC.PseudoCaptioner(tp.cfg, perceiver=tp, method="clip",
                              device="cpu")
    with jax_train_path():
        want = jpc._clip_consensus(caps, crop)
    got = tpc._clip_consensus(caps, crop)
    assert got in caps
    jscore, tscore = _clip_scores(jp, tp, caps, crop)
    np.testing.assert_allclose(tscore, jscore, atol=5e-3, rtol=0)
    top = np.sort(jscore)[::-1]
    if top[0] - top[1] > 1e-2:
        assert got == want
    # with the object's crop handed in, `consensus` takes this method
    assert tpc.consensus({(0, 1): caps}, crops={(0, 1): crop}) == {
        "0_1": got}


def _clip_scores(jp, tp, caps, crop):
    """Both packages' image-text scores of `caps` for `crop`, the batch
    padded as `_clip_consensus` pads it."""
    import jax.numpy as jnp

    from embodied_captioning_tpu.models import captioner as JCap
    from embodied_captioning_tpu_torch.models import captioner as TCap

    cfg = jp.cfg.captioner
    k = len(caps)
    cap = 1 << (k - 1).bit_length()
    tok = jp.tokenizer.encode_batch(list(caps) + [""] * (cap - k),
                                    cfg.text.context_length)
    imgs = np.tile(crop[None], (cap, 1, 1, 1))
    with jax_train_path():
        _, ie, te = JCap.forward(jp.params.captioner, jnp.asarray(imgs),
                                 jnp.asarray(tok), cfg)
    want = np.asarray(jnp.sum(ie * te, axis=-1))[:k]
    with torch.no_grad():
        _, ie, te = TCap.forward(tp.params.captioner, torch.from_numpy(imgs),
                                 torch.from_numpy(tok), tp.cfg.captioner)
    return want, (ie * te).sum(-1).numpy()[:k]


# ---------------------------------------------------------------------------
# labeling/caption_datasets.py
# ---------------------------------------------------------------------------

def test_images_dir_dataset_equals_jax(tmp_path):
    """tests/test_caption_datasets.py's case, with .npy images, a JSON
    sidecar and .txt captions too."""
    for i in range(3):
        np.savez(tmp_path / f"img{i}.npz",
                 (np.random.default_rng(i).random((16, 16, 3)) * 255
                  ).astype(np.uint8))
    np.save(tmp_path / "img3.npy", np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "img3.txt").write_text("a small tv\n")
    with open(tmp_path / "captions.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["image", "caption"])
        w.writeheader()
        for i in range(2):
            w.writerow({"image": f"img{i}.npz", "caption": f"cap {i}"})
    for side in (None, "json"):
        if side:
            (tmp_path / "captions.json").write_text(json.dumps(
                {"img2.npz": "cap 2"}))
            os.remove(tmp_path / "captions.csv")
        ds = TCD.CaptioningBaseDataset(str(tmp_path))
        want = JCD.CaptioningBaseDataset(str(tmp_path))
        assert ds.items == want.items
        assert len(ds) == (3 if side is None else 2)
        for i in range(len(ds)):
            a, b = ds[i], want[i]
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    img, cap = TCD.CaptioningBaseDataset(str(tmp_path))[0]
    assert cap == "cap 2" and img.shape == (16, 16, 3)


def test_crop_csv_dataset_equals_jax(tmp_path):
    """tests/test_caption_datasets.py's case: the crops equal the JAX
    package's bit for bit (expand 0.2, bilinear resize, clip, uint8), the
    batches' tokens and ids too."""
    np.savez(tmp_path / "scene.npz",
             (np.random.default_rng(0).random((32, 32, 3)) * 255
              ).astype(np.uint8))
    with open(tmp_path / "crops.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["image", "x1", "y1", "x2", "y2",
                                           "caption", "object_id"])
        w.writeheader()
        for i in range(4):
            w.writerow({"image": "scene.npz", "x1": 2 + i, "y1": 2.5,
                        "x2": 20 + 1.5 * i, "y2": 20, "caption":
                        f"a red couch {i}", "object_id": i})
    ds = TCD.DetectionCropDataset(str(tmp_path / "crops.csv"), crop_size=16)
    want = JCD.DetectionCropDataset(str(tmp_path / "crops.csv"),
                                    crop_size=16)
    assert len(ds) == len(want) == 4
    for i in range(4):
        a, b = ds[i], want[i]
        assert a[0].shape == (16, 16, 3) and a[0].dtype == np.uint8
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    tok = default_tokenizer()
    for x, y in zip(ds.batches(tok, 24, 2), want.batches(tok, 24, 2)):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], k)


def test_image_files_need_pil_with_a_clear_error(tmp_path, monkeypatch):
    """A .png reads through PIL where it is installed; without it the
    error names PIL and the array formats."""
    path = tmp_path / "x.png"
    try:
        from PIL import Image

        Image.fromarray(np.full((4, 4, 3), 7, np.uint8)).save(path)
        np.testing.assert_array_equal(TCD._load_image(str(path)), 7)
    except ImportError:
        path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL.*npz"):
        TCD._load_image(str(path))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store of the JAX package's loop (8 frames)."""
    root = tmp_path_factory.mktemp("pseudocaption")
    path = str(root / "obs")
    jax_store(path)
    return path


def _run(main, argv, jax_side: bool):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setenv("ECAP_PLATFORM", os.environ.get("ECAP_PLATFORM",
                                                      "cpu"))
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_records_from_store_equal_jax(store):
    got, want = TPC.records_from_store(store), JPC.records_from_store(store)
    assert got == want and len(want) > 0


@pytest.mark.parametrize("method", ["sbert", "tfidf", "clip", "llm"])
def test_entry_point_matches_jax_script(store, encoder, method, tmp_path):
    """`pseudocaption` beside `scripts/pseudocaption.py` on the JAX store,
    the JAX package's encoder weights on both sides: the same JSON line
    (keys, types, objects, method) and the same pseudo-captions; `clip`
    falls back to sbert in both (the CLI hands no crops)."""
    jenc, tenc = encoder
    mod = _script("pseudocaption")
    argv = [store, "--method", method] + STORE_OVERRIDES
    with jax_kernel_path(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSB.SentenceEncoder, "create",
                   staticmethod(lambda seed=0, cfg=None: jenc))
        jrc, want = _run(mod.main, argv + ["--out", str(tmp_path / "j.json")],
                         True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TSB.SentenceEncoder, "create",
                   staticmethod(lambda seed=0, cfg=None, device="cuda":
                                tenc))
        rc, got = _run(pseudocaption.main,
                       argv + ["--out", str(tmp_path / "t.json")], False)
    assert rc == 0 and jrc is None
    assert set(got) == set(want) == {"objects", "method", "out"}
    assert got["objects"] == want["objects"] > 0
    assert got["method"] == want["method"] == method
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))


def test_entry_point_refuses_an_llm_path_and_needs_a_card_or_cpu(
        store, monkeypatch, tmp_path):
    """`--llm-path` is taken now (test_torch_llm.py holds the model's
    consensus): with no model at the path, the llm method writes the sbert
    method's pseudo-captions. Without --device it asks for the card. The
    name is the one the test had while `--llm-path` exited 2."""
    outs = {}
    for method, extra in (("llm", ["--llm-path", str(tmp_path / "x")]),
                          ("sbert", [])):
        out = tmp_path / f"{method}.json"
        assert pseudocaption.main([store, "--method", method, "--out",
                                   str(out), "--device", "cpu"]
                                  + extra + STORE_OVERRIDES) == 0
        outs[method] = json.loads(out.read_text())
    assert outs["llm"] == outs["sbert"] and outs["sbert"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pseudocaption.main([store]) == 2
