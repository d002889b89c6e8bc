"""The port's offline analysis entry points beside the JAX package's
scripts, on the CPU at tiny sizes: `compute_cosine_sim`,
`compute_detection_statistics`, `compute_performance_measures`,
`caption_tools` (its four subcommands), `visualize_exp`,
`visualize_cosine_similarity` and `build_vocab`.

Each runs in process beside `scripts/<name>.py` on the same store or CSV:
a store of 2 episodes x 3 steps written with numpy from a seed (rgb,
depth, `bbs` predictions with captions and object ids, `bbsgt` labels).
The sentence encoder and the captioner take the JAX package's seeded
weights on both sides (`params.from_jax`); the captioner subcommands run
the JAX package's kernels in interpret mode on its whole-block route
(`jax_kernel_path(blocks=True)`), the port's default route. Outputs are
equal; where a number comes out of a model the test states its
tolerance."""

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

from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu_torch import (
    build_vocab, caption_tools, compute_cosine_sim,
    compute_detection_statistics, compute_performance_measures,
    visualize_cosine_similarity, visualize_exp,
)
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.models import sbert as TSB
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.utils.obs_store import save_obs
from torch_parity import jax_kernel_path

REPO = Path(__file__).resolve().parents[1]

WORDS = ("a", "red", "blue", "brown", "couch", "bed", "tv", "plant", "table",
         "on", "the", "floor", "small", "large", "dark", "white")
# a cosine of two captions' embeddings through the two packages' bf16
# encoders on the same weights (the JAX package on its kernel path): each
# embedding lies within a cosine of 1e-4 of the JAX package's
# (test_torch_models.py), an angle of 0.014, so a pairwise cosine may move
# by twice that; measured on this store: 5.4e-4 at most a pair set (1.0e-3
# against the JAX default path), the rows' cosine >= 0.99999
COS_ATOL = 2e-3
# the captioner tests' limits (test_torch_generate.py): full bf16 logits
# (|logit| < 4) within two ulps; chosen-token log-probs within 5e-2, so a
# perplexity (exp of their mean) within 5%
LOGIT_ATOL = 2 ** -5
PPL_RTOL = 5e-2
# greedy decoding of random weights flips at near-ties (ROADMAP C.8,
# C.12): the store's seed was picked where every crop's decode agrees (of
# store seeds 0-27 at --max-crops 6, seeds 12, 20 and 25)
STORE_SEED = 12


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, jax_side: bool):
    """(exit code, the last line printed as JSON) of a script's `main()`
    with `argv` (the JAX side) or of an entry point's `main(argv)`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _caption(rng, obj: int) -> str:
    """One of three seeded captions of object `obj`."""
    r = np.random.default_rng(obj * 3 + int(rng.integers(0, 3)))
    return " ".join(r.choice(WORDS, int(r.integers(2, 6))))


def _payload(rng, boxes: np.ndarray, ids, gt: bool) -> np.ndarray:
    n = len(ids)
    inst = {"boxes": boxes.astype(np.float32),
            "classes": (np.asarray(ids) % 6).astype(np.int32),
            "valid": rng.random(n) < (0.9 if gt else 0.75),
            "object_ids": np.asarray(ids, np.int64)}
    if not gt:
        inst["scores"] = rng.uniform(0.05, 1.0, n).astype(np.float32)
        inst["captions"] = np.array([_caption(rng, i) for i in ids],
                                    dtype=object)
    return np.array({"instances": inst}, dtype=object)


def write_store(root: str, seed: int, episodes=(0, 7), steps: int = 3,
                size: int = 64) -> str:
    """A store of `episodes` x `steps` frames: rgb (camera 0), depth (1),
    bbs predictions of 6 slots with captions (2) and bbsgt labels of the
    same objects (3), all drawn from `seed`."""
    rng = np.random.default_rng(seed)
    for ep in episodes:
        for step in range(steps):
            ids = rng.choice(np.arange(ep * 10, ep * 10 + 8), 6,
                             replace=False)
            xy = rng.uniform(0, size * 0.6, (6, 2))
            gt = np.concatenate([xy, xy + rng.uniform(4, size * 0.4, (6, 2))],
                                1)
            # predictions: the labels' boxes moved by up to 6 px a side
            pred = np.clip(gt + rng.uniform(-6, 6, (6, 4)), 0, size)
            save_obs(os.path.join(root, f"env{ep}"), ep, {
                "rgb": rng.integers(0, 256, (size, size, 3), np.uint8),
                "depth": rng.uniform(0.3, 6.0, (size, size)).astype(
                    np.float32),
                "bbs": _payload(rng, pred, ids, False),
                "bbsgt": _payload(rng, gt, ids, True)}, step)
    return root


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(str(tmp_path_factory.mktemp("analysis") / "obs"),
                       STORE_SEED)


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's seeded sentence encoder at the tiny preset, and
    the port's on its weights."""
    jc = jload_config("tiny").sentence_encoder
    p = JSB.init_sentence_encoder(jax.random.PRNGKey(0), jc)
    return (JSB.SentenceEncoder(p, jc),
            TSB.SentenceEncoder(from_jax(p, "cpu"),
                                load_config("tiny").sentence_encoder))


@contextlib.contextmanager
def _handed(encoders):
    """Both packages' `SentenceEncoder.create` give the handed encoders;
    the JAX package runs its kernels (interpret mode)."""
    jenc, tenc = encoders
    with jax_kernel_path(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSB.SentenceEncoder, "create",
                   staticmethod(lambda seed=0, cfg=None: jenc))
        mp.setattr(TSB.SentenceEncoder, "create",
                   staticmethod(lambda seed=0, cfg=None, device="cuda":
                                tenc))
        yield


# ---------------------------------------------------------------------------
# compute_cosine_sim, compute_detection_statistics
# ---------------------------------------------------------------------------

def test_compute_cosine_sim_matches_jax_script(store, encoders, tmp_path):
    """The JSON line and the per-object file: the same objects and view
    counts, every cosine within COS_ATOL."""
    mod = _script("compute_cosine_sim")
    with _handed(encoders):
        jrc, want = _run(mod.main, [store, "--out", str(tmp_path / "j.json")],
                         True)
        rc, got = _run(compute_cosine_sim.main,
                       [store, "--out", str(tmp_path / "t.json"),
                        "--device", "cpu"], False)
    assert rc == 0 and jrc is None
    assert set(got) == set(want) == {"objects", "mean_consistency"}
    assert got["objects"] == want["objects"] > 4
    assert abs(got["mean_consistency"] - want["mean_consistency"]) < COS_ATOL
    jf = json.loads((tmp_path / "j.json").read_text())
    tf = json.loads((tmp_path / "t.json").read_text())
    assert tf["per_object"].keys() == jf["per_object"].keys()
    vals = []
    for k, w in jf["per_object"].items():
        g = tf["per_object"][k]
        assert g["views"] == w["views"] >= 2
        assert abs(g["mean_pairwise_cosine"] - w["mean_pairwise_cosine"]
                   ) < COS_ATOL
        vals.append(w["mean_pairwise_cosine"])
    assert min(vals) < 0.999  # views with different captions
    # --min-views filters alike
    with _handed(encoders):
        _, want3 = _run(mod.main, [store, "--min-views", "3"], True)
        _, got3 = _run(compute_cosine_sim.main,
                       [store, "--min-views", "3", "--device", "cpu"], False)
    assert got3["objects"] == want3["objects"] < want["objects"]


def test_compute_detection_statistics_matches_jax_script(store, tmp_path):
    """Host numpy only: the JSON lines equal, map_50 included; a store
    without labels has no map_50 in either."""
    mod = _script("compute_detection_statistics")
    jrc, want = _run(mod.main, [store], True)
    rc, got = _run(compute_detection_statistics.main, [store], False)
    assert rc == 0 and jrc is None
    assert got == want
    assert want["total"] > 0 and 0.0 < want["map_50"] < 1.0
    bare = write_store(str(tmp_path / "bare"), 3, episodes=(2,), steps=1)
    for p in Path(bare).rglob("*bbsgt*"):
        p.unlink()
    _, want = _run(mod.main, [bare], True)
    _, got = _run(compute_detection_statistics.main, [bare], False)
    assert got == want and "map_50" not in got


# ---------------------------------------------------------------------------
# compute_performance_measures
# ---------------------------------------------------------------------------

def test_compute_performance_measures_matches_jax_script(encoders, tmp_path):
    """BLEU, METEOR and ROUGE equal; the sentence cosine within COS_ATOL;
    the per-row CSV alike; an empty CSV gives the same error line."""
    rng = np.random.default_rng(5)
    src = tmp_path / "results.csv"
    with open(src, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["id", "cand", "ref"])
        for i in range(7):
            ref = _caption(rng, i)
            cand = ref if i % 3 == 0 else _caption(rng, i + 1)
            w.writerow([i, cand, ref])
    mod = _script("compute_performance_measures")
    argv = [str(src), "--proposed-col", "cand", "--reference-col", "ref"]
    with _handed(encoders):
        jrc, want = _run(mod.main, argv + ["--out", str(tmp_path / "j.csv")],
                         True)
        rc, got = _run(compute_performance_measures.main,
                       argv + ["--out", str(tmp_path / "t.csv"),
                               "--device", "cpu"], False)
    assert rc == 0 and jrc is None
    assert set(got) == set(want) and got["n"] == want["n"] == 7
    for k in want:
        assert abs(got[k] - want[k]) < (COS_ATOL if k == "sbert_cosine"
                                        else 1e-12), k
    jrows = list(csv.DictReader(open(tmp_path / "j.csv")))
    trows = list(csv.DictReader(open(tmp_path / "t.csv")))
    assert len(jrows) == len(trows) == 7
    for jr, tr in zip(jrows, trows):
        assert jr.keys() == tr.keys()
        for k in jr:
            tol = COS_ATOL if k == "sbert_cosine" else 0.0
            assert abs(float(tr[k]) - float(jr[k])) <= tol, k
    empty = tmp_path / "empty.csv"
    empty.write_text("proposed,reference\n")
    assert (_run(mod.main, [str(empty)], True)[1]
            == _run(compute_performance_measures.main,
                    [str(empty), "--device", "cpu"], False)[1]
            == {"error": "empty csv"})


# ---------------------------------------------------------------------------
# caption_tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["filter-boxes", "triage"])
def test_caption_tools_host_subcommands_match_jax_script(store, encoders,
                                                         tmp_path, cmd):
    """filter-boxes: the JSON line equal; triage: the JSON line and the
    ranked file, every consistency (rounded to 4 places) equal."""
    mod = _script("caption_tools")
    argv = [cmd, store, "--min-area", "150"]
    with _handed(encoders):
        jrc, want = _run(mod.main, argv + ["--out", str(tmp_path / "j")],
                         True)
        rc, got = _run(caption_tools.main,
                       argv + ["--out", str(tmp_path / "t"), "--device",
                               "cpu"], False)
    assert rc == 0 and jrc is None
    if cmd == "filter-boxes":
        assert got == want and want["kept"] > 0 and want["dropped"] > 0
        return
    assert want["objects"] > 4
    # consistencies rounded to 4 places: within COS_ATOL and a rounding
    lim = COS_ATOL + 1e-4
    assert got["objects"] == want["objects"]
    assert got["out"] == str(tmp_path / "t")
    assert abs(got["least_consistent"] - want["least_consistent"]) <= lim
    jrows = json.loads((tmp_path / "j").read_text())
    trows = json.loads((tmp_path / "t").read_text())
    assert len(trows) == len(jrows)
    key = lambda r: (r["episode"], r["object_id"])  # noqa: E731
    jby = {key(r): r for r in jrows}
    for r in trows:
        w = jby[key(r)]
        assert (r["views"], r["captions"]) == (w["views"], w["captions"])
        assert abs(r["consistency"] - w["consistency"]) <= lim
    # ranked by consistency, least first
    assert [r["consistency"] for r in trows] == sorted(
        r["consistency"] for r in trows)


@pytest.fixture(scope="module")
def captioner_runs(store, tmp_path_factory):
    """`save-logits` and `perplexity` of the JAX script (its kernels, the
    whole-block route) and of the port on the JAX script's weights
    (`init_captioner(PRNGKey(0))` at the tiny preset)."""
    out = tmp_path_factory.mktemp("captioner")
    mod = _script("caption_tools")
    jp = JCAP.init_captioner(jax.random.PRNGKey(0),
                             jload_config("tiny").captioner)
    tp = from_jax(jp, "cpu")
    runs = {}
    for cmd, ext in (("save-logits", ".npz"), ("perplexity", ".csv")):
        argv = [cmd, store, "--max-crops", "6"]
        with jax_kernel_path(blocks=True):
            runs[cmd, "jax"] = _run(
                mod.main, argv + ["--out", str(out / f"j{ext}")], True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(caption_tools, "captioner_params",
                       lambda cfg, device: tp)
            runs[cmd, "port"] = _run(
                caption_tools.main,
                argv + ["--out", str(out / f"t{ext}"), "--device", "cpu"],
                False)
    return out, runs


def _bf16_bytes_to_f32(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def test_caption_tools_save_logits_matches_jax_script(captioner_runs):
    """The npz holds the same arrays in the same formats: tokens equal,
    the bf16 logits as two raw bytes an element within LOGIT_ATOL, the
    crops' metadata equal; the JSON lines equal but for --out."""
    out, runs = captioner_runs
    (jrc, want), (rc, got) = runs["save-logits", "jax"], runs[
        "save-logits", "port"]
    assert rc == 0 and jrc is None
    assert got == {**want, "out": str(out / "t.npz")}
    assert want["crops"] >= 6
    j = np.load(out / "j.npz", allow_pickle=True)
    t = np.load(out / "t.npz", allow_pickle=True)
    assert sorted(j.files) == sorted(t.files) == ["logits", "meta", "tokens"]
    for k in j.files:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert (j["tokens"][:, 1:] != 0).sum(1).min() > 1  # real decode work
    assert list(t["meta"]) == list(j["meta"])
    np.testing.assert_allclose(_bf16_bytes_to_f32(t["logits"]),
                               _bf16_bytes_to_f32(j["logits"]),
                               atol=LOGIT_ATOL, rtol=0)


def test_caption_tools_perplexity_matches_jax_script(captioner_runs):
    """The CSV: the same rows, captions equal, each perplexity within
    PPL_RTOL; the JSON line's mean alike."""
    out, runs = captioner_runs
    (jrc, want), (rc, got) = runs["perplexity", "jax"], runs[
        "perplexity", "port"]
    assert rc == 0 and jrc is None
    assert got["crops"] == want["crops"] >= 6
    assert abs(got["mean_perplexity"] / want["mean_perplexity"] - 1
               ) < PPL_RTOL
    jrows = list(csv.DictReader(open(out / "j.csv")))
    trows = list(csv.DictReader(open(out / "t.csv")))
    assert len(jrows) == len(trows) == want["crops"]
    for jr, tr in zip(jrows, trows):
        for k in ("episode", "step", "object_id", "caption"):
            assert tr[k] == jr[k], k
        assert abs(float(tr["perplexity"]) / float(jr["perplexity"]) - 1
                   ) < PPL_RTOL
    assert any(r["caption"] for r in jrows)


def test_caption_tools_captioner_subcommands_need_a_card(store, tmp_path,
                                                         monkeypatch):
    """Without --device the captioner subcommands and triage (the
    sentence encoder) run on the card, and exit 2 where there is none;
    filter-boxes runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("save-logits", "perplexity", "triage"):
        assert caption_tools.main([cmd, store, "--out",
                                   str(tmp_path / cmd)]) == 2
        assert not (tmp_path / cmd).exists()
    assert caption_tools.main(["filter-boxes", store]) == 0
    for cmd in ("save-logits", "perplexity", "triage"):
        assert caption_tools.main([cmd, str(tmp_path / "none"), "--out",
                                   str(tmp_path / "x"), "--device",
                                   "cpu"]) == 0


@pytest.mark.parametrize("name", ["compute_cosine_sim",
                                  "compute_performance_measures"])
def test_sentence_encoder_entries_need_a_card(store, tmp_path, monkeypatch,
                                              name):
    """Without --device the sentence encoder runs on the card: exit 2
    where there is none, before anything is read or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"compute_cosine_sim": compute_cosine_sim.main,
            "compute_performance_measures":
                compute_performance_measures.main}[name]
    out = tmp_path / "out"
    src = store if name == "compute_cosine_sim" else str(tmp_path / "none")
    assert main([src, "--out", str(out)]) == 2
    assert not out.exists()


# ---------------------------------------------------------------------------
# visualize_exp, visualize_cosine_similarity
# ---------------------------------------------------------------------------

def _pixels(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_visualize_exp_matches_jax_script(store, tmp_path):
    """The same frames, file names and JSON line; every PNG's pixels equal
    to the JAX script's draw."""
    mod = _script("visualize_exp")
    jrc, want = _run(mod.main, [store, "--out", str(tmp_path / "j"),
                                "--max-frames", "5"], True)
    rc, got = _run(visualize_exp.main, [store, "--out", str(tmp_path / "t"),
                                        "--max-frames", "5"], False)
    assert rc == 0 and jrc is None
    assert got == {**want, "out": str(tmp_path / "t")} and want["frames"] == 5
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        a, b = _pixels(tmp_path / "j" / n), _pixels(tmp_path / "t" / n)
        assert a.shape == b.shape == (64, 2 * 64 + 4, 3)
        np.testing.assert_array_equal(b, a)
        assert len(np.unique(a.reshape(-1, 3), axis=0)) > 100  # drawn


def test_visualize_cosine_similarity_matches_jax_script(store, encoders,
                                                        tmp_path):
    """Two variants from `compute_cosine_sim --out` and one empty one:
    the same JSON line and lines printed, the PNG's pixels equal."""
    per = tmp_path / "per.json"
    with _handed(encoders):
        _run(compute_cosine_sim.main,
             [store, "--out", str(per), "--device", "cpu"], False)
    d = json.loads(per.read_text())
    half = dict(list(d["per_object"].items())[::2])
    (tmp_path / "half.json").write_text(json.dumps(half))
    (tmp_path / "none.json").write_text(json.dumps({"per_object": {}}))
    ins = [f"all={per}", str(tmp_path / "half.json"),
           f"empty={tmp_path / 'none.json'}"]
    mod = _script("visualize_cosine_similarity")
    outs = {}
    for side, main in (("j", mod.main), ("t", visualize_cosine_similarity.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                pytest.MonkeyPatch.context() as mp:
            png = str(tmp_path / f"{side}.png")
            if side == "j":
                mp.setattr(sys, "argv", ["s.py"] + ins + ["--out", png])
                main()
            else:
                assert main(ins + ["--out", png]) == 0
        outs[side] = buf.getvalue().replace(str(tmp_path / "t.png"),
                                            str(tmp_path / "j.png"))
    assert outs["t"] == outs["j"]
    line = json.loads(outs["j"].strip().splitlines()[-1])
    assert set(line["variants"]) == {"all", "half"}
    assert "[visualize] empty: no objects, skipped" in outs["j"]
    a, b = _pixels(tmp_path / "j.png"), _pixels(tmp_path / "t.png")
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(b, a)


def test_visualize_cosine_similarity_without_matplotlib(tmp_path,
                                                        monkeypatch, capsys):
    """Where matplotlib is missing, it says so and exits 2."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    (tmp_path / "a.json").write_text(json.dumps({"per_object": {}}))
    assert visualize_cosine_similarity.main([str(tmp_path / "a.json")]) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not Path("cosine_violins.png").exists()


# ---------------------------------------------------------------------------
# build_vocab
# ---------------------------------------------------------------------------

def _small_corpus(mod, mp):
    """Cut both scripts' docstring corpus to two standard-library
    packages (the whole corpus parses every installed package's sources,
    minutes of host work): the stdlib part to `json`, the site part to
    `email`."""
    stdlib_json = os.path.dirname(json.__file__)
    mp.setattr(mod, "stdlib_docstrings",
               lambda: mod._tree_docstrings(stdlib_json))
    mp.setattr(mod, "SITE_PACKAGES", ("email",))


def test_build_vocab_matches_jax_script(tmp_path):
    """At a small --vocab-size on the same corpus: the merges file equal
    to the JAX script's byte for byte."""
    mod = _script("build_vocab")
    argv = ["--vocab-size", "700", "--caption-weight", "7"]
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        _small_corpus(mod, mp)
        _small_corpus(build_vocab, mp)
        mp.setattr(sys, "argv", ["s.py"] + argv + ["--out",
                                                   str(tmp_path / "j.json")])
        mod.main()
        assert build_vocab.main(argv + ["--out",
                                        str(tmp_path / "t.json")]) == 0
    want = (tmp_path / "j.json").read_bytes()
    assert (tmp_path / "t.json").read_bytes() == want
    d = json.loads(want)
    assert d["vocab_size"] == 700 and len(d["merges"]) == 700 - 260


def test_build_vocab_writes_outside_the_jax_package(tmp_path, monkeypatch):
    """The default --out is `bpe_merges.json` in the working directory;
    the JAX script's default is the JAX package's data file, which the
    port only reads."""
    mod = _script("build_vocab")
    assert "embodied_captioning_tpu" not in build_vocab.DEFAULT_OUT
    assert mod.DEFAULT_MERGES_PATH.endswith(
        os.path.join("embodied_captioning_tpu", "models", "data",
                     "bpe_merges.json"))
    data = REPO / "embodied_captioning_tpu" / "models" / "data"
    before = {p.name: p.stat().st_mtime_ns for p in data.iterdir()}
    monkeypatch.chdir(tmp_path)
    _small_corpus(build_vocab, monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        assert build_vocab.main(["--vocab-size", "300"]) == 0
    assert json.loads((tmp_path / "bpe_merges.json").read_text())[
        "vocab_size"] == 300
    assert {p.name: p.stat().st_mtime_ns for p in data.iterdir()} == before
