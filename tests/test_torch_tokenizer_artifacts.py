"""The port's artifact tokenizers (`models/tokenizer_artifacts.py`) and
`models/tokenizer.py`'s `train_bpe`, `builtin_corpus` and
`default_tokenizer` against the JAX package's: the same ids and decoded
strings over the same merges `.txt.gz` and `vocab.txt` files, on the
built-in corpus and on unicode and punctuation cases; the same trained
merges; and the fallback for a missing merges file, which writes nothing
under the JAX package (ROADMAP C.40). Everything here is exact."""

import gzip
import hashlib
import random
from collections import Counter

import pytest

from embodied_captioning_tpu.models import tokenizer as JT
from embodied_captioning_tpu.models import tokenizer_artifacts as JA
from embodied_captioning_tpu_torch.models import tokenizer as TT
from embodied_captioning_tpu_torch.models import tokenizer_artifacts as TA

CASES = [
    "lower", "  LOW   low!  ", "it's", "Hello, world!", "Á", "unaffable",
    "running", "don't WON'T we'll they've I'm you'd", "café naïve façade",
    "東京 タワー", "①② 12345 3.14", "&amp;lt; html &quot;quoted&quot;",
    "snake_case __dunder__", "emoji 🙂 👍🏽", "tabs\tand\nnewlines",
    "a — dash… and “quotes”", "",
]


def _clip_merges(corpus, n):
    """A CLIP-style merges table learnt on `corpus`: words as byte-unicode
    characters, the last one marked '</w>'; the most frequent adjacent pair
    first, the smallest among equal counts."""
    b2u = JA.bytes_to_unicode()
    words = Counter()
    for line in corpus:
        for w in JA._CLIP_PAT.findall(line.lower()):
            chars = [b2u[b] for b in w.encode("utf-8")]
            words[tuple(chars[:-1] + [chars[-1] + "</w>"])] += 1
    merges = []
    while len(merges) < n:
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A merges `.txt.gz` (a version line, 300 learnt merges, 5 lines past
    the table) and a `vocab.txt`, both from the built-in corpus."""
    d = tmp_path_factory.mktemp("artifacts")
    corpus = JT.builtin_corpus() + CASES
    merges = _clip_merges(corpus, 305)
    assert len(merges) == 305
    bpe = d / "bpe.txt.gz"
    with gzip.open(bpe, "wb") as fh:
        fh.write("\n".join(["#version: 0.2"] + [f"{a} {b}" for a, b in
                                                merges]).encode("utf-8"))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = sorted({w for line in corpus
                    for w in TA.WordPieceTokenizer(vocab)._basic(line)})
    for w in words:
        if len(w) > 4:   # long words only as a stem and its suffixes
            vocab += [w[:3], "##" + w[3:5], "##" + w[5:]]
        else:
            vocab.append(w)
    vocab = list(dict.fromkeys(vocab))
    vtxt = d / "vocab.txt"
    vtxt.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return dict(bpe=str(bpe), vocab=str(vtxt), n_vocab=512 + 300 + 2,
                corpus=corpus)


def test_bytes_to_unicode_equal():
    assert TA.bytes_to_unicode() == JA.bytes_to_unicode()


def test_clip_bpe_ids_and_decode_equal(artifacts):
    j = JA.CLIPBPETokenizer.load(artifacts["bpe"], artifacts["n_vocab"])
    t = TA.CLIPBPETokenizer.load(artifacts["bpe"], artifacts["n_vocab"])
    assert (t.vocab_size, t.pad_id, t.bos_id, t.eos_id) == (
        j.vocab_size, j.pad_id, j.bos_id, j.eos_id) == (814, 0, 812, 813)
    merged = 0
    for text in artifacts["corpus"]:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids)
        merged += sum(512 <= i < 812 for i in ids)
    assert merged > 1000   # the merges table is exercised
    for bos, eos in ((False, False), (True, False), (False, True)):
        assert [t.encode(x, bos, eos) for x in CASES] == [
            j.encode(x, bos, eos) for x in CASES]
    batch = t.encode_batch(artifacts["corpus"], 12)
    assert (batch == j.encode_batch(artifacts["corpus"], 12)).all()
    assert t.decode_batch(batch) == j.decode_batch(batch)


def test_wordpiece_ids_and_decode_equal(artifacts):
    j = JA.WordPieceTokenizer.load(artifacts["vocab"])
    t = TA.WordPieceTokenizer.load(artifacts["vocab"])
    assert (t.vocab_size, t.pad_id, t.unk_id, t.bos_id, t.eos_id) == (
        j.vocab_size, j.pad_id, j.unk_id, j.bos_id, j.eos_id)
    pieces = 0
    for text in artifacts["corpus"] + ["zzzz qqq", "x" * 120]:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids)
        pieces += sum(t.inv[i].startswith("##") for i in ids)
    assert pieces > 100
    batch = t.encode_batch(artifacts["corpus"], 16)
    assert (batch == j.encode_batch(artifacts["corpus"], 16)).all()
    assert t.decode_batch(batch) == j.decode_batch(batch)


@pytest.mark.parametrize("needed", [306, 400])
def test_clip_bpe_refuses_a_table_of_the_wrong_length(artifacts, needed):
    """A vocabulary that needs more merges than the file holds (305) fails
    with the JAX package's message."""
    msgs = []
    for mod in (JA, TA):
        with pytest.raises(ValueError) as exc:
            mod.CLIPBPETokenizer.load(artifacts["bpe"], 512 + 2 + needed)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert f"expected {needed} merges, parsed 305" in msgs[0]


def test_builtin_corpus_equal():
    assert TT.builtin_corpus() == JT.builtin_corpus()


def _random_corpus(seed, lines=400):
    rng = random.Random(seed)
    return [" ".join("".join(rng.choice("abcdeé ") for _ in range(
        rng.randint(1, 7))) for _ in range(rng.randint(1, 9)))
        for _ in range(lines)]


@pytest.mark.parametrize("n", [1024, 4096])
def test_train_bpe_equal_on_builtin_corpus(n):
    want = [tuple(m) for m in JT.train_bpe(JT.builtin_corpus(), n)]
    got = TT.train_bpe(TT.builtin_corpus(), n)
    assert got == want and len(got) > 200


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 1024), (2, 4096)])
def test_train_bpe_equal_on_random_corpus(seed, n):
    """Few letters, many ties: the smallest pair must win each."""
    corpus = _random_corpus(seed)
    want = [tuple(m) for m in JT.train_bpe(corpus, n)]
    got = TT.train_bpe(corpus, n)
    assert got == want and len(got) >= 40
    jt, tt = JT.Tokenizer(want, n), TT.Tokenizer(got, n)
    assert [tt.encode(x) for x in corpus] == [jt.encode(x) for x in corpus]


@pytest.mark.parametrize("vocab", [300, 1024, 4096, 49408])
def test_default_tokenizer_equal(vocab):
    t, j = TT.default_tokenizer(vocab), JT.default_tokenizer(vocab)
    assert t.merges == [tuple(m) for m in j.merges]
    texts = JT.builtin_corpus()[:40] + CASES
    assert [t.encode(x) for x in texts] == [j.encode(x) for x in texts]


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("vocab", [1024, JT.CLIP_VOCAB_SIZE])
def test_fallback_trains_in_memory_and_writes_nothing(tmp_path,
                                                      monkeypatch, vocab):
    """With the merges file missing the port trains on the built-in corpus
    at the requested size, as the JAX fallback does, but writes no table:
    the JAX fallback persists one at 49,408 ids to its package data, the
    port leaves the JAX package's file and directory as they were."""
    from pathlib import Path

    jax_file = Path(JT.DEFAULT_MERGES_PATH)
    data_dir = jax_file.parent
    before = (_sha(jax_file), jax_file.stat().st_mtime_ns,
              sorted(p.name for p in data_dir.iterdir()))
    missing = tmp_path / "absent" / "bpe_merges.json"
    monkeypatch.setattr(TT, "MERGES_PATH", missing)
    TT.default_tokenizer.cache_clear()
    try:
        tok = TT.default_tokenizer(vocab)
    finally:
        TT.default_tokenizer.cache_clear()
    want = JT.Tokenizer(JT.train_bpe(JT.builtin_corpus(), vocab), vocab)
    assert tok.vocab_size == vocab
    assert tok.merges == [tuple(m) for m in want.merges]
    texts = JT.builtin_corpus()[::7] + CASES
    assert [tok.encode(x) for x in texts] == [want.encode(x) for x in texts]
    assert not missing.exists() and not missing.parent.exists()
    assert list(tmp_path.iterdir()) == []
    assert (_sha(jax_file), jax_file.stat().st_mtime_ns,
            sorted(p.name for p in data_dir.iterdir())) == before
