"""MiniLM-class sentence encoder: token ids -> mean-pooled, L2-normalised
embeddings, with PAD (id 0) masked out. `post_ln` selects the BERT layer
ordering (embedding LayerNorm, post-LN blocks with erf GELU).
`SentenceEncoder` is the strings-in, embeddings-out surface."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SentenceEncoderConfig
from .common import (
    BERT_LN_EPS, block, block_init, block_post_ln, dense, dense_init,
    layernorm, layernorm_init, randn,
)
from .tokenizer import PAD_ID, Tokenizer, default_tokenizer


def init_sentence_encoder(g: torch.Generator, cfg: SentenceEncoderConfig,
                          device) -> dict:
    p = {
        "tok_emb": randn(g, (cfg.vocab_size, cfg.width), device, 0.02),
        "pos_emb": randn(g, (cfg.max_len, cfg.width), device, 0.02),
        "blocks": [block_init(g, cfg.width, cfg.mlp_ratio, device)
                   for _ in range(cfg.layers)],
        "ln": layernorm_init(cfg.width, device),
        "proj": dense_init(g, cfg.width, cfg.embed_dim, device),
    }
    if cfg.post_ln:
        p["emb_ln"] = layernorm_init(cfg.width, device)
    return p


@torch.no_grad()
def encode_tokens(params: dict, tokens: torch.Tensor,
                  cfg: SentenceEncoderConfig) -> torch.Tensor:
    """[B, T] int token ids -> [B, embed_dim] L2-normalised embeddings."""
    cdt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    t = tokens.shape[1]
    pad_mask = tokens != PAD_ID
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][None, :t]
    attn_mask = pad_mask[:, None, None, :]
    if cfg.post_ln:
        x = layernorm(params["emb_ln"], x, eps=BERT_LN_EPS)
        for blk in params["blocks"]:
            x = block_post_ln(blk, x, cfg.heads, mask=attn_mask,
                              compute_dtype=cdt)
        x = x.float()
    else:
        for blk in params["blocks"]:
            x, _ = block(blk, x, cfg.heads, mask=attn_mask,
                         compute_dtype=cdt)
        x = layernorm(params["ln"], x, out_dtype=torch.float32)
    w = pad_mask.float()[..., None]
    pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    e = dense(params["proj"], pooled, compute_dtype=cdt).float()
    return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                           min=1e-8)


class SentenceEncoder:
    """Strings in, L2-normalised float32 embeddings out (numpy), as
    SentenceTransformer's `encode`."""

    def __init__(self, params: dict, cfg: SentenceEncoderConfig,
                 tokenizer: Optional[Tokenizer] = None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer(cfg.vocab_size)

    @staticmethod
    def create(seed: int = 0, cfg: Optional[SentenceEncoderConfig] = None,
               device="cuda") -> "SentenceEncoder":
        """Seeded random weights with the JAX `init_sentence_encoder`'s
        shapes and scales, drawn from a `torch.Generator` seeded with
        `seed`: the numbers differ from the JAX package's
        `SentenceEncoder.create(seed)`, which draws from jax.random."""
        cfg = cfg or SentenceEncoderConfig()
        g = torch.Generator(device=device).manual_seed(seed)
        return SentenceEncoder(init_sentence_encoder(g, cfg, device), cfg)

    def encode(self, sentences: Sequence[str]) -> np.ndarray:
        """[len(sentences), embed_dim] float32. The batch is padded with
        all-PAD rows to the next power of two (the JAX package's bucket),
        and those rows are sliced off."""
        n = len(sentences)
        if n == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        tokens = self.tokenizer.encode_batch(list(sentences),
                                             self.cfg.max_len)
        bucket = 1 << (n - 1).bit_length()
        if bucket > n:
            tokens = np.concatenate(
                [tokens, np.zeros((bucket - n, tokens.shape[1]),
                                  tokens.dtype)])
        dev = self.params["tok_emb"].device
        out = encode_tokens(self.params, torch.from_numpy(tokens).to(dev),
                            self.cfg)
        return out[:n].cpu().numpy()
