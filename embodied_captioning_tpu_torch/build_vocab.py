"""Train the reference-scale byte-BPE merge table (49,408 ids, the size of
CLIP's BPE) on text found on this machine: the caption-domain built-in
corpus (repeated so the early merges stay caption English), English
prose from the docstrings of the Python standard library and of some
installed packages, and the common-licenses texts.

The counterpart of the JAX package's `scripts/build_vocab.py`, with its
arguments, corpus, training and file format (a JSON of "merges" and
"vocab_size"): on the same machine both give the same merges. The
default `--out` is `bpe_merges.json` in the working directory; the
port's tokenizer reads the committed table of the JAX package's data
directory (`models/tokenizer.MERGES_PATH`), and nothing here writes
there.

Usage:
  python -m embodied_captioning_tpu_torch.build_vocab [--vocab-size 49408]
      [--caption-weight 100] [--out bpe_merges.json]
"""

from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import sys
import sysconfig
import time

from .models.tokenizer import BYTE_OFFSET, Tokenizer, builtin_corpus, train_bpe

VOCAB_SIZE = 49408  # CLIP BPE vocabulary size
DEFAULT_OUT = "bpe_merges.json"
# packages whose docstrings add English prose; those not installed are
# skipped (their sources are parsed, never imported)
SITE_PACKAGES = ("numpy", "scipy", "torch", "jax", "transformers", "pandas",
                 "sklearn", "matplotlib")


def _is_prose(line: str) -> bool:
    """Keep lines that look like English prose, not code."""
    s = line.strip()
    if len(s) < 16:
        return False
    if sum(ch.isalpha() for ch in s) / len(s) < 0.6:
        return False
    words = s.split()
    return len(words) >= 4 and sum(w.isalpha() for w in words) >= len(words) // 2


def _tree_docstrings(root: str) -> list:
    """The prose lines (lower case) of every docstring under `root`."""
    lines = []
    for path in sorted(glob.glob(root + "/**/*.py", recursive=True)):
        try:
            with open(path, encoding="utf-8", errors="ignore") as fh:
                tree = ast.parse(fh.read())
        except (SyntaxError, ValueError, OSError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                doc = ast.get_docstring(node)
                if doc:
                    lines.extend(l for l in doc.lower().splitlines()
                                 if _is_prose(l))
    return lines


def stdlib_docstrings() -> list:
    return _tree_docstrings(sysconfig.get_paths()["stdlib"])


def site_docstrings() -> list:
    import importlib.util

    lines = []
    for name in SITE_PACKAGES:
        spec = importlib.util.find_spec(name)
        if spec is None or not spec.submodule_search_locations:
            continue
        got = _tree_docstrings(list(spec.submodule_search_locations)[0])
        print(f"  {name}: {len(got)} prose lines", flush=True)
        lines.extend(got)
    return lines


def license_texts() -> list:
    lines = []
    for path in sorted(glob.glob("/usr/share/common-licenses/*")):
        if not os.path.isfile(path):
            continue
        try:
            with open(path, encoding="utf-8", errors="ignore") as fh:
                lines.extend(l for l in fh.read().lower().splitlines()
                             if _is_prose(l))
        except OSError:
            continue
    return lines


def save_merges(merges, vocab_size: int, path: str) -> None:
    """The JAX package's `Tokenizer.save` format."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"merges": [list(m) for m in merges],
                   "vocab_size": vocab_size}, fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab-size", type=int, default=VOCAB_SIZE)
    ap.add_argument("--caption-weight", type=int, default=100,
                    help="repeat factor for the caption-domain corpus so "
                         "early (frequent) merges stay caption-English")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    t0 = time.time()
    captions = builtin_corpus()
    docs = stdlib_docstrings() + site_docstrings()
    lic = license_texts()
    corpus = captions * args.caption_weight + docs + lic
    print(f"corpus: {len(captions)} caption lines x{args.caption_weight}, "
          f"{len(docs)} docstring lines, {len(lic)} license lines "
          f"({time.time() - t0:.0f}s)", flush=True)

    t0 = time.time()
    merges = train_bpe(corpus, args.vocab_size)
    print(f"trained {len(merges)} merges "
          f"(vocab {BYTE_OFFSET + 256 + len(merges)}/{args.vocab_size}) "
          f"in {time.time() - t0:.0f}s", flush=True)

    tok = Tokenizer(merges, args.vocab_size)
    for s in ["a brown leather couch in a bright living room",
              "the potted plant sits next to the television"]:
        if tok.decode(tok.encode(s)) != s:
            raise AssertionError(f"the table does not round-trip {s!r}")
        print(f"  {len(tok.encode(s))} ids <- {s!r}")
    save_merges(merges, args.vocab_size, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
