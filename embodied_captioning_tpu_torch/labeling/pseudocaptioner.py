"""Pseudo-captioner: distill the captions of an object's views into one.

The counterpart of the JAX package's `labeling/pseudocaptioner.py` (ref:
experimenting_env/captioner/pseudocaptioner.py): captions grouped by
(episode, object id) from the store's `bbs` payloads, banned-word
filtering, a caption frequency table, then a consensus scorer:

  clip / itc   the caption whose text embedding (the captioner's
               contrastive heads, `captioner.forward`) best matches the
               object's crop
  sbert        the caption closest to the centroid of the views' sentence
               embeddings (`sbert.SentenceEncoder`)
  tfidf        tf-idf weighted frequency ranking, the document
               frequencies over every object's captions computed once
  llm          a local Hugging Face causal LM prompted for the caption
               that best describes the object (`llm_path`); without a
               model at that path, or where it fails (no `transformers`),
               it falls back to `sbert`, as the JAX package does

Output: {"<episode>_<object id>": caption}.
"""

from __future__ import annotations

import json
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# words that mark a useless caption
BANNED_WORDS = (
    "blurry", "blur", "dark", "black image", "white image",
    "close up of a wall", "unclear", "cannot", "nothing",
)


def filter_banned(captions: Sequence[str],
                  banned: Sequence[str] = BANNED_WORDS) -> List[str]:
    out = []
    for c in captions:
        lc = c.lower()
        if any(b in lc for b in banned):
            continue
        if len(lc.strip()) < 3:
            continue
        out.append(c)
    return out


def group_captions(records: Sequence[Dict]) -> Dict[Tuple[int, int],
                                                    List[str]]:
    """records: {episode, object_id, caption} rows (e.g. from the store's
    bbs payloads), grouped by (episode, object)."""
    groups: Dict[Tuple[int, int], List[str]] = defaultdict(list)
    for r in records:
        groups[(int(r["episode"]), int(r["object_id"]))].append(r["caption"])
    return groups


def caption_frequencies(captions: Sequence[str]) -> Counter:
    return Counter(c.strip().lower() for c in captions)


def records_from_store(exp_path: str) -> List[Dict]:
    """(episode, object_id, caption, step) rows of the valid slots of every
    `bbs` and `bbsgt` payload with captions and object ids."""
    from ..utils.obs_store import SampleLoader

    loader = SampleLoader(exp_path)
    rows: List[Dict] = []
    for ep in loader.episodes:
        for cam in loader.cameras(ep):
            for mod in ("bbs", "bbsgt"):
                if mod not in loader.modalities(ep, cam):
                    continue
                for step in loader.steps(ep, cam, mod):
                    payload = loader.get_sample(ep, cam, mod, step).data
                    caps = payload.get("captions")
                    ids = payload.get("object_ids")
                    valid = payload.get("valid")
                    if caps is None or ids is None:
                        continue
                    for i in range(len(caps)):
                        if valid is not None and not valid[i]:
                            continue
                        rows.append({"episode": ep,
                                     "object_id": int(ids[i]),
                                     "caption": str(caps[i]),
                                     "step": step})
    return rows


class PseudoCaptioner:
    """`consensus` over grouped captions with `method`. The sentence
    encoder defaults to seeded random weights (generator seed 0) on
    `device`, the perceiver (for clip / itc) likewise. `llm_path`: a local
    Hugging Face causal LM for the llm method (the JAX package reads it
    from ECAP_LLM_PATH)."""

    def __init__(self, cfg=None, perceiver=None, sentence_encoder=None,
                 method: str = "sbert", device="cuda",
                 llm_path: Optional[str] = None):
        self.cfg = cfg
        self.perceiver = perceiver
        self.sentence_encoder = sentence_encoder
        self.method = method
        self.device = device
        self.llm_path = llm_path

    # -- method implementations -------------------------------------------
    def _sbert_consensus(self, captions: List[str]) -> str:
        enc = self._get_sentence_encoder()
        emb = enc.encode(captions)
        centroid = emb.mean(0)
        centroid /= max(np.linalg.norm(centroid), 1e-9)
        return captions[int(np.argmax(emb @ centroid))]

    @staticmethod
    def _df_table(all_groups: Dict) -> Tuple[Counter, int]:
        """Document frequencies over every object's caption set (one
        document an object), and the number of documents."""
        docs = [" ".join(v).lower() for v in all_groups.values()]
        df: Counter = Counter()
        for d in docs:
            for w in set(d.split()):
                df[w] += 1
        return df, max(len(docs), 1)

    def _tfidf_consensus(self, captions: List[str], df: Counter,
                         n_docs: int) -> str:
        """Each caption scored by its frequency times the mean idf of its
        words; the first best."""
        freqs = caption_frequencies(captions)

        def score(c: str) -> float:
            words = c.lower().split()
            if not words:
                return 0.0
            idf = [np.log(n_docs / (1 + df[w])) + 1.0 for w in words]
            return freqs[c.strip().lower()] * float(np.mean(idf))

        return max(captions, key=score)

    def _clip_consensus(self, captions: List[str], crop: np.ndarray) -> str:
        """The caption whose text embedding best matches the crop's image
        embedding. The caption count is padded to a power of two with
        empty captions, as the JAX package pads it."""
        from ..models.captioner import forward

        p = self._get_perceiver()
        cfg = p.cfg.captioner
        k = len(captions)
        cap = 1
        while cap < k:
            cap *= 2
        padded = list(captions) + [""] * (cap - k)
        tok = p.tokenizer.encode_batch(padded, cfg.text.context_length)
        dev = p.device
        imgs = torch.as_tensor(np.tile(crop[None], (cap, 1, 1, 1)),
                               device=dev)
        with torch.no_grad():
            _, img_emb, txt_emb = forward(p.params.captioner, imgs,
                                          torch.from_numpy(tok).to(dev), cfg)
        scores = (img_emb * txt_emb).sum(dim=-1).cpu().numpy()[:k]
        return captions[int(np.argmax(scores))]

    def _llm_consensus(self, captions: List[str]) -> str:
        """In-context LLM consensus with the local model at `llm_path`;
        without one, or where it fails, the sbert centroid."""
        if not self.llm_path or not os.path.exists(self.llm_path):
            return self._sbert_consensus(captions)
        try:
            return _hf_llm_consensus(self.llm_path, captions)
        except Exception:
            return self._sbert_consensus(captions)

    # -- plumbing ----------------------------------------------------------
    def _get_sentence_encoder(self):
        if self.sentence_encoder is None:
            from ..models.sbert import SentenceEncoder

            cfg = self.cfg.sentence_encoder if self.cfg else None
            self.sentence_encoder = SentenceEncoder.create(0, cfg,
                                                           self.device)
        return self.sentence_encoder

    def _get_perceiver(self):
        if self.perceiver is None:
            from ..perception import Perceiver

            self.perceiver = Perceiver(self.cfg, device=self.device)
        return self.perceiver

    def consensus(self, groups: Dict[Tuple[int, int], List[str]],
                  crops: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
                  ) -> Dict[str, str]:
        """Each object's caption set distilled to one pseudo-caption
        (`clip` / `itc` need the object's crop in `crops`, else `sbert`)."""
        out: Dict[str, str] = {}
        df, n_docs = (self._df_table(groups) if self.method == "tfidf"
                      else (None, 0))
        for key, caps in groups.items():
            caps = filter_banned(caps)
            if not caps:
                continue
            if len(caps) == 1:
                chosen = caps[0]
            elif self.method in ("clip", "itc") and crops and key in crops:
                chosen = self._clip_consensus(caps, crops[key])
            elif self.method == "tfidf":
                chosen = self._tfidf_consensus(caps, df, n_docs)
            elif self.method == "llm":
                chosen = self._llm_consensus(caps)
            else:
                chosen = self._sbert_consensus(caps)
            out[f"{key[0]}_{key[1]}"] = chosen
        return out

    def run(self, exp_path: str, output_json: str) -> Dict[str, str]:
        groups = group_captions(records_from_store(exp_path))
        result = self.consensus(groups)
        os.makedirs(os.path.dirname(os.path.abspath(output_json)),
                    exist_ok=True)
        with open(output_json, "w") as fh:
            json.dump(result, fh, indent=2)
        return result


_HF_LLM_CACHE: Dict[str, Tuple] = {}


def _hf_llm_consensus(model_path: str, captions: List[str]) -> str:
    """Prompted consensus with a local Hugging Face causal LM: the captions
    between <Caption> tags, 32 greedy new tokens, the text up to the first
    closing tag (the first caption where that is empty). The model loads
    once per path, in float32 on the CPU."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    if model_path not in _HF_LLM_CACHE:
        _HF_LLM_CACHE[model_path] = (
            AutoTokenizer.from_pretrained(model_path),
            AutoModelForCausalLM.from_pretrained(
                model_path, torch_dtype=torch.float32))
    tok, model = _HF_LLM_CACHE[model_path]
    listing = "\n".join(f"<Caption>{c}</Caption>" for c in captions)
    prompt = (
        "You are given multiple captions of the same object seen from "
        "different viewpoints. Reply with the single caption that best "
        "describes the object, between <Caption> tags.\n"
        f"{listing}\n<Caption>")
    inputs = tok(prompt, return_tensors="pt")
    out = model.generate(**inputs, max_new_tokens=32, do_sample=False)
    text = tok.decode(out[0][inputs["input_ids"].shape[1]:],
                      skip_special_tokens=True)
    return text.split("</Caption>")[0].strip() or captions[0]
