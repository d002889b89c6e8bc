"""Small decoder-only causal LM that ranks captions by likelihood. No entry
point calls it: the pseudo-captioner's `llm` method prompts a local Hugging
Face model (`labeling/pseudocaptioner._hf_llm_consensus`).

Candidate captions are ranked by their mean log-likelihood under a context
of the other views' captions (`ConsensusLM.choose`). The residual stream
is float32 (its LayerNorms take the float32 rows of the LayerNorm kernel,
two-pass); the products run in bf16 with float32 accumulation. Every block
gets the lower-triangular mask, so attention is the plain masked
attention, not the flash kernel: the JAX package passes that mask and
`causal=True`, which ANDs the same tril into it and takes the same route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .common import (
    block, block_init, causal_mask, dense, dense_init, layernorm,
    layernorm_init, randn,
)
from .tokenizer import PAD_ID, Tokenizer, default_tokenizer


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 1024
    width: int = 256
    layers: int = 4
    heads: int = 4
    context_length: int = 256
    mlp_ratio: float = 4.0

    @staticmethod
    def tiny() -> "LMConfig":
        return LMConfig(width=64, layers=2, heads=2, context_length=96)


def init_lm(g: torch.Generator, cfg: LMConfig, device) -> dict:
    """Random weights with the JAX `init_lm`'s shapes and scales, drawn
    from `g` (numbers differ from jax.random)."""
    return {
        "tok_emb": randn(g, (cfg.vocab_size, cfg.width), device, 0.02),
        "pos_emb": randn(g, (cfg.context_length, cfg.width), device, 0.02),
        "blocks": [block_init(g, cfg.width, cfg.mlp_ratio, device)
                   for _ in range(cfg.layers)],
        "ln": layernorm_init(cfg.width, device),
        "head": dense_init(g, cfg.width, cfg.vocab_size, device),
    }


def lm_logits(params: dict, tokens: torch.Tensor, cfg: LMConfig,
              w8a8: bool = False) -> torch.Tensor:
    """Tokens [B, T] -> logits [B, T, V] (bf16). `w8a8` (the JAX
    package's ECAP_W8A8): every product with an int8 weight takes int8
    activations."""
    t = tokens.shape[1]
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][None, :t]
    mask = causal_mask(t, tokens.device)
    for blk in params["blocks"]:
        x, _ = block(blk, x, cfg.heads, mask=mask, w8a8=w8a8)
    return dense(params["head"], layernorm(params["ln"], x), w8a8=w8a8)


def _token_log_probs(logits: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """log p(tokens[:, 1:]) [B, T-1] f32 from logits [B, T, V]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return torch.gather(logp, 2, tokens[:, 1:].long()[..., None])[..., 0]


def sequence_log_prob(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                      prefix_len: torch.Tensor, w8a8: bool = False
                      ) -> torch.Tensor:
    """Mean per-token log p(tokens[prefix_len:]) [B] f32 — the caption
    scoring primitive. tokens [B, T], prefix_len [B]; `w8a8` as in
    `lm_logits`."""
    lp = _token_log_probs(lm_logits(params, tokens, cfg, w8a8), tokens)
    tgt = tokens[:, 1:]
    pos = torch.arange(tgt.shape[1], device=tokens.device)[None, :]
    mask = ((tgt != PAD_ID) & (pos >= (prefix_len[:, None] - 1))).float()
    return (lp * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


def lm_loss(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    """Next-token cross-entropy over the non-PAD targets."""
    nll = -_token_log_probs(lm_logits(params, tokens, cfg), tokens)
    mask = (tokens[:, 1:] != PAD_ID).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class ConsensusLM:
    """Caption consensus by contextual likelihood: each candidate scored by
    its likelihood given the other views as context. Weights default to
    `init_lm` from a generator seeded with `seed`, on `device`; `w8a8`
    goes to `sequence_log_prob`."""

    def __init__(self, cfg: Optional[LMConfig] = None, seed: int = 0,
                 params: Optional[dict] = None,
                 tokenizer: Optional[Tokenizer] = None, device="cuda",
                 w8a8: bool = False):
        self.cfg = cfg or LMConfig.tiny()
        self.device = torch.device(device)
        self.w8a8 = w8a8
        self.params = params or init_lm(
            torch.Generator(device=self.device).manual_seed(seed), self.cfg,
            self.device)
        self.tokenizer = tokenizer or default_tokenizer(self.cfg.vocab_size)

    def choose(self, captions: Sequence[str]) -> str:
        if len(captions) == 1:
            return captions[0]
        return captions[int(np.argmax(self.scores(captions)))]

    def scores(self, captions: Sequence[str]) -> np.ndarray:
        """Each caption's mean log-likelihood [N] f32 after the other
        captions as context (" . "-joined, BOS first), truncated to the
        context length."""
        t = self.cfg.context_length
        rows, prefix_lens = [], []
        for i, cand in enumerate(captions):
            context = " . ".join(c for j, c in enumerate(captions) if j != i)
            ctx_ids = self.tokenizer.encode(context, bos=True, eos=False)
            cand_ids = self.tokenizer.encode(cand, bos=False, eos=True)
            ids = (ctx_ids + cand_ids)[:t]
            prefix_lens.append(min(len(ctx_ids), t - 1))
            rows.append(ids + [PAD_ID] * (t - len(ids)))
        with torch.no_grad():
            scores = sequence_log_prob(
                self.params,
                torch.as_tensor(np.asarray(rows, np.int32),
                                device=self.device),
                self.cfg, torch.as_tensor(prefix_lens, device=self.device),
                self.w8a8)
        return scores.cpu().numpy()
