"""Byte-level BPE tokenizer over the committed merge table.

Layout: PAD=0, BOS=1, EOS=2, UNK=3 (unused), byte tokens 4..259, merge
tokens 260..vocab_size-1. Words are split on whitespace and carry a
leading-space byte, so decoding is exact for any UTF-8 text. The merge
table is read from the JAX package's data directory and never written.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def default_tokenizer(vocab_size: int = 1024) -> Tokenizer:
    """The committed merge table, truncated so every id is < vocab_size."""
    if vocab_size < BYTE_OFFSET + 256:
        raise ValueError(f"vocab_size must be >= {BYTE_OFFSET + 256}, "
                         f"got {vocab_size}")
    with open(MERGES_PATH) as fh:
        merges = json.load(fh)["merges"]
    return Tokenizer(merges[:vocab_size - (BYTE_OFFSET + 256)], vocab_size)
