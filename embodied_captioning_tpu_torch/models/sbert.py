"""MiniLM-class sentence encoder: token ids -> mean-pooled, L2-normalised
embeddings, with PAD (id 0) masked out. `post_ln` selects the BERT layer
ordering (embedding LayerNorm, post-LN blocks with erf GELU)."""

from __future__ import annotations

import torch

from ..config import SentenceEncoderConfig
from .common import (
    BERT_LN_EPS, block, block_init, block_post_ln, dense, dense_init,
    layernorm, layernorm_init, randn,
)
from .tokenizer import PAD_ID


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
