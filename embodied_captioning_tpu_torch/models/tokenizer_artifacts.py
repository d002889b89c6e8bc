"""Tokenizers of real pretrained checkpoints, read from their artifact
files: the native tokenizer (`models/tokenizer.py`) is trained here, but a
ported checkpoint needs the tokenizer it was trained with.

  CLIPBPETokenizer   open_clip / CLIP byte-pair encoding from the standard
                     `bpe_simple_vocab_16e6.txt.gz` merges table, which
                     open_clip's CoCa uses (49,408 ids = 256 bytes + 256
                     byte+'</w>' + 48,894 merges + <|startoftext|> +
                     <|endoftext|>).
  WordPieceTokenizer HF BERT WordPiece from a `vocab.txt`, which MiniLM /
                     SBERT (all-MiniLM-L6-v2) uses.

Both follow the published algorithms (Sennrich BPE with GPT-2's
byte-to-unicode map; greedy longest-match WordPiece) with no library, and
give the originals' ids for the same artifact files. `port_checkpoint`
pairs them with the converted weights. Host Python; the counterpart of
the JAX package's `models/tokenizer_artifacts.py`, id for id.

Known differences from open_clip's SimpleTokenizer:
- text cleaning uses html.unescape instead of ftfy (not installed);
  input without mojibake tokenizes identically.
- the number class is `\\d` (Unicode Nd) where CLIP's regex has \\p{N}
  (which adds No / Nl, circled numbers and the like); caption text is
  unaffected.
"""

from __future__ import annotations

import gzip
import html
import re
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# GPT-2 byte <-> unicode mapping (also used by CLIP's BPE)
# ---------------------------------------------------------------------------

def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a printable unicode char: printable ASCII/latin-1
    ranges map to themselves, the rest to U+0100.. in order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = bytes_to_unicode()
_U2B = {v: k for k, v in _B2U.items()}

# CLIP's token splitter (std-re equivalent of its \p{L}/\p{N} pattern)
_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\w\s]|_)+",
    re.IGNORECASE)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip())


class CLIPBPETokenizer:
    """CLIP byte-pair encoder over a standard merges table.

    Matches open_clip's SimpleTokenizer ids exactly for the same
    `bpe_simple_vocab_16e6.txt.gz` file (modulo the documented ftfy/\\p{N}
    cleaning divergences). Exposes the framework Tokenizer protocol
    (encode/decode/encode_batch) plus pad/bos/eos ids for
    `TextDecoderConfig(pad_id=..., bos_id=..., eos_id=...)`.
    """

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        vocab: List[str] = list(_B2U.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.ranks: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(merges)}
        self.vocab_size = len(vocab)
        self.pad_id = 0                       # open_clip pads with zeros
        self.bos_id = self.encoder[self.SOT]  # 49406 at full scale
        self.eos_id = self.encoder[self.EOT]  # 49407
        self._cache: Dict[str, List[str]] = {}

    # -- artifact loading -------------------------------------------------
    @staticmethod
    def load(path: str, expected_vocab: int = 49408) -> "CLIPBPETokenizer":
        """Read the standard merges artifact: gzip (or plain) text, first
        line a version header, then one 'left right' merge per line; the
        table is truncated to expected_vocab - 512 - 2 merges (the file
        ships more lines than CLIP uses)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as fh:
            lines = fh.read().decode("utf-8").split("\n")
        n_merges = expected_vocab - 2 * len(_B2U) - 2
        body = lines[1:1 + n_merges]
        merges = [tuple(line.split()) for line in body if line.strip()]
        if len(merges) != n_merges:
            raise ValueError(
                f"{path}: expected {n_merges} merges, parsed {len(merges)}")
        return CLIPBPETokenizer(merges)

    # -- BPE --------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def encode(self, text: str, bos: bool = True, eos: bool = True
               ) -> List[int]:
        ids: List[int] = [self.bos_id] if bos else []
        for tok in _CLIP_PAT.findall(_clean(text).lower()):
            mapped = "".join(_B2U[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        if eos:
            ids.append(self.eos_id)
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     bos: bool = True, eos: bool = True) -> np.ndarray:
        out = np.full((len(texts), max_len), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos, eos)
            if len(ids) > max_len:
                ids = ids[:max_len - 1] + [self.eos_id] if eos \
                    else ids[:max_len]
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        for t in ids:
            t = int(t)
            if t in (self.pad_id, self.bos_id):
                continue
            if t == self.eos_id:
                break
            parts.append(self.decoder.get(t, ""))
        text = "".join(parts)
        # '</w>' marks word ends; all other chars are byte-mapped unicode
        # (a literal space never occurs — byte 0x20 maps to a high char)
        raw = bytes(_U2B.get(c, ord(" "))
                    for c in text.replace("</w>", " "))
        return raw.decode("utf-8", errors="replace").strip()

    def decode_batch(self, ids: np.ndarray) -> List[str]:
        return [self.decode(row) for row in np.asarray(ids)]


# ---------------------------------------------------------------------------
# WordPiece (BERT / MiniLM)
# ---------------------------------------------------------------------------

def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


class WordPieceTokenizer:
    """HF-BERT-compatible WordPiece: basic tokenization (lowercase, accent
    strip, punctuation/CJK splitting) + greedy longest-match subwords with
    '##' continuations. encode() emits [CLS] ... [SEP] like
    BertTokenizer(do_lower_case=True) — id parity for the same vocab.txt."""

    def __init__(self, vocab: Sequence[str], lowercase: bool = True,
                 max_word_chars: int = 100):
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.inv: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get("[UNK]", 1)
        self.bos_id = self.vocab.get("[CLS]", 2)   # CLS plays BOS
        self.eos_id = self.vocab.get("[SEP]", 3)   # SEP plays EOS
        self.vocab_size = len(self.vocab)

    @staticmethod
    def load(path: str) -> "WordPieceTokenizer":
        """Standard HF `vocab.txt`: one token per line, id = line number."""
        with open(path, encoding="utf-8") as fh:
            vocab = [line.rstrip("\n") for line in fh]
        while vocab and not vocab[-1]:
            vocab.pop()
        return WordPieceTokenizer(vocab)

    # -- basic tokenizer --------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif _is_punct(ch) or _is_cjk(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str, bos: bool = True, eos: bool = True
               ) -> List[int]:
        ids: List[int] = [self.bos_id] if bos else []
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        if eos:
            ids.append(self.eos_id)
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int,
                     bos: bool = True, eos: bool = True) -> np.ndarray:
        out = np.full((len(texts), max_len), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos, eos)
            if len(ids) > max_len:
                ids = ids[:max_len - 1] + [self.eos_id] if eos \
                    else ids[:max_len]
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        words: List[str] = []
        for t in ids:
            t = int(t)
            if t in (self.pad_id, self.bos_id):
                continue
            if t == self.eos_id:
                break
            tok = self.inv.get(t, "[UNK]")
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)

    def decode_batch(self, ids: np.ndarray) -> List[str]:
        return [self.decode(row) for row in np.asarray(ids)]
