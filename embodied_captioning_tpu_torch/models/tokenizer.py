"""Byte-level BPE tokenizer over the committed merge table.

Layout: PAD=0, BOS=1, EOS=2, UNK=3 (unused), byte tokens 4..259, merge
tokens 260..vocab_size-1. Words are split on whitespace and carry a
leading-space byte, so decoding is exact for any UTF-8 text. The merge
table is read from the JAX package's data directory and never written:
where the file is missing, `default_tokenizer` trains a table on the
built-in corpus (`train_bpe`, `builtin_corpus`) and keeps it in memory.
"""

from __future__ import annotations

import functools
import heapq
import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
BYTE_OFFSET = 4

MERGES_PATH = (Path(__file__).resolve().parents[2] / "embodied_captioning_tpu"
               / "models" / "data" / "bpe_merges.json")


def _word_to_bytes(word: str) -> Tuple[int, ...]:
    return tuple(b + BYTE_OFFSET for b in word.encode("utf-8"))


def train_bpe(corpus: Iterable[str], vocab_size: int = 1024
              ) -> List[Tuple[int, int]]:
    """Learn BPE merges from a corpus: the ordered merge list [(left id,
    right id), ...], merge i creating id BYTE_OFFSET + 256 + i, until
    vocab_size ids or no pair occurs twice. Deterministic: among pairs of
    equal count the smallest (left, right) wins. Incremental: a merge
    updates the pair counts of the words that hold its pair only, and the
    best pair comes from a lazy max-heap."""
    word_counts: Dict[Tuple[int, ...], int] = {}
    for line in corpus:
        for i, raw in enumerate(line.strip().split()):
            key = _word_to_bytes((" " + raw) if i > 0 else raw)
            if key:
                word_counts[key] = word_counts.get(key, 0) + 1

    words: List[List[int]] = [list(w) for w in word_counts]
    counts: List[int] = list(word_counts.values())
    pair_counts: Dict[Tuple[int, int], int] = {}
    pair_words: Dict[Tuple[int, int], set] = {}
    for wi, w in enumerate(words):
        for pp in zip(w, w[1:]):
            pair_counts[pp] = pair_counts.get(pp, 0) + counts[wi]
            pair_words.setdefault(pp, set()).add(wi)

    heap = [(-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)
    merges: List[Tuple[int, int]] = []
    next_id = BYTE_OFFSET + 256
    while next_id < vocab_size and heap:
        negc, pair = heapq.heappop(heap)
        cur = pair_counts.get(pair, 0)
        if -negc != cur:  # a stale entry: push its current count back
            if cur > 0:
                heapq.heappush(heap, (-cur, pair))
            continue
        if cur < 2:
            break
        a, b = pair
        merges.append(pair)
        touched = set()
        for wi in list(pair_words.get(pair, ())):
            w, c = words[wi], counts[wi]
            for pp in zip(w, w[1:]):
                touched.add(pp)
                pair_counts[pp] -= c
                pair_words[pp].discard(wi)
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(next_id)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            for pp in zip(out, out[1:]):
                touched.add(pp)
                pair_counts[pp] = pair_counts.get(pp, 0) + c
                pair_words.setdefault(pp, set()).add(wi)
        del pair_counts[pair]
        pair_words.pop(pair, None)
        for pp in touched:
            if pair_counts.get(pp, 0) > 0:
                heapq.heappush(heap, (-pair_counts[pp], pp))
        next_id += 1
    return merges


class Tokenizer:
    """Byte-level BPE encoder/decoder."""

    def __init__(self, merges: Sequence[Tuple[int, int]], vocab_size: int):
        self.merges = [tuple(m) for m in merges]
        self.rank = {m: i for i, m in enumerate(self.merges)}
        self.merge_id = {m: BYTE_OFFSET + 256 + i
                         for i, m in enumerate(self.merges)}
        self.vocab_size = vocab_size
        self._bytes: Dict[int, bytes] = {
            BYTE_OFFSET + b: bytes([b]) for b in range(256)}
        for (a, b), mid in self.merge_id.items():
            self._bytes[mid] = self._bytes[a] + self._bytes[b]

    def _encode_word(self, word: str) -> List[int]:
        toks = list(_word_to_bytes(word))
        while len(toks) > 1:
            best_rank, best_i = min(
                (self.rank.get((a, b), 1 << 30), i)
                for i, (a, b) in enumerate(zip(toks, toks[1:])))
            if best_rank >= (1 << 30):
                break
            pair = (toks[best_i], toks[best_i + 1])
            mid = self.merge_id[pair]
            out, i = [], 0
            while i < len(toks):
                if (i + 1 < len(toks) and toks[i] == pair[0]
                        and toks[i + 1] == pair[1]):
                    out.append(mid)
                    i += 2
                else:
                    out.append(toks[i])
                    i += 1
            toks = out
        return toks

    def encode(self, text: str, bos: bool = True, eos: bool = True
               ) -> List[int]:
        ids: List[int] = [BOS_ID] if bos else []
        for i, raw in enumerate(text.strip().split()):
            ids.extend(self._encode_word((" " + raw) if i > 0 else raw))
        if eos:
            ids.append(EOS_ID)
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     bos: bool = True, eos: bool = True) -> np.ndarray:
        """[N, max_len] int32, PAD-padded or truncated (EOS kept)."""
        out = np.full((len(texts), max_len), PAD_ID, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos, eos)
            if len(ids) > max_len:
                ids = ids[:max_len - 1] + [EOS_ID] if eos else ids[:max_len]
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        buf = b""
        for t in ids:
            t = int(t)
            if t in (PAD_ID, BOS_ID):
                continue
            if t == EOS_ID:
                break
            buf += self._bytes.get(t, b"")
        return buf.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# built-in corpus: caption-domain text for a merge table trained here
# ---------------------------------------------------------------------------

_OBJECTS = ["couch", "sofa", "plant", "potted plant", "bed", "table",
            "dining table", "coffee table", "toilet", "tv", "television",
            "monitor", "screen", "chair", "armchair", "lamp", "shelf",
            "cabinet", "pillow", "blanket", "rug", "curtain", "mirror",
            "window", "door", "wall", "floor", "ceiling"]
_COLORS = ["red", "green", "blue", "white", "black", "brown", "gray", "grey",
           "beige", "yellow", "orange", "purple", "dark", "light", "wooden",
           "leather", "fabric", "metal", "glass", "plastic"]
_ROOMS = ["living room", "bedroom", "bathroom", "kitchen", "dining room",
          "hallway", "office", "apartment", "house", "corner of a room"]
_TEMPLATES = [
    "a {c} {o} in a {r}",
    "a {c} {o} sitting in the {r}",
    "there is a {c} {o} next to the wall",
    "a photo of a {c} {o}",
    "the {o} is {c} and stands in the {r}",
    "a {o} with a {c} {o2} on top of it",
    "a close up of a {c} {o} in a {r}",
    "a {c} {o} near a {c2} {o2}",
    "an image of a {r} with a {c} {o}",
    "the {r} has a {c} {o} and a {c2} {o2}",
]
_EXTRA = [
    "this is a picture of furniture inside a home",
    "the room is bright and full of natural light",
    "a small object placed on the floor near the window",
    "two objects are visible in the corner of the image",
    "the camera looks at the scene from above",
    "a flat screen mounted on the wall above a cabinet",
    "someone left a remote control on the sofa cushion",
    "green leaves of a houseplant in a ceramic pot",
    "a neatly made bed with pillows and a blanket",
    "a bathroom with a white toilet and a sink",
]


def builtin_corpus() -> List[str]:
    """Caption-domain sentences: the extra lines, then every template
    filled with every object (colours and rooms in a fixed rotation)."""
    lines = list(_EXTRA)
    for i, t in enumerate(_TEMPLATES):
        for j, o in enumerate(_OBJECTS):
            c = _COLORS[(i + j) % len(_COLORS)]
            c2 = _COLORS[(i + 2 * j + 3) % len(_COLORS)]
            o2 = _OBJECTS[(j + 5) % len(_OBJECTS)]
            r = _ROOMS[(i * 3 + j) % len(_ROOMS)]
            lines.append(t.format(c=c, o=o, r=r, c2=c2, o2=o2))
    return lines


@functools.lru_cache(maxsize=None)
def default_tokenizer(vocab_size: int = 1024) -> Tokenizer:
    """The committed merge table, truncated so every id is < vocab_size.
    Where the file is missing, a table trained on `builtin_corpus` at the
    requested size, kept in memory (nothing is written; training is
    greedy, so a table trained at a size is the first merges of one
    trained larger)."""
    if vocab_size < BYTE_OFFSET + 256:
        raise ValueError(f"vocab_size must be >= {BYTE_OFFSET + 256}, "
                         f"got {vocab_size}")
    if not MERGES_PATH.exists():
        return Tokenizer(train_bpe(builtin_corpus(), vocab_size), vocab_size)
    with open(MERGES_PATH) as fh:
        merges = json.load(fh)["merges"]
    return Tokenizer(merges[:vocab_size - (BYTE_OFFSET + 256)], vocab_size)
