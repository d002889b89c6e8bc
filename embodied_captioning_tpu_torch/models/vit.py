"""Vision Transformer encoder with the CoCa attentional pooler. Blocks run
in bf16 with float32 accumulation; self-attention goes through the flash
kernel, or, where autograd records and needs its gradient, through the
plain attention (`common.mha`)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import VitConfig
from ..ops.image import preprocess_for_vit
from .common import (
    block, block_init, dense, dense_init, layernorm, layernorm_init, mha,
    mha_init, randn,
)


def init_vit(g: torch.Generator, cfg: VitConfig, device) -> dict:
    tokens = (cfg.image_size // cfg.patch_size) ** 2
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    return {
        "patch": dense_init(g, patch_dim, cfg.width, device),
        "pos": randn(g, (tokens + 1, cfg.width), device, 0.02),
        "cls": randn(g, (cfg.width,), device, 0.02),
        "ln_pre": layernorm_init(cfg.width, device),
        "ln_post": layernorm_init(cfg.width, device),
        "blocks": [block_init(g, cfg.width, cfg.mlp_ratio, device)
                   for _ in range(cfg.layers)],
        "pool_q": randn(g, (cfg.pool_queries, cfg.width), device, 0.02),
        "pool_attn": mha_init(g, cfg.width, None, device),
        "pool_ln": layernorm_init(cfg.width, device),
        "proj": dense_init(g, cfg.width, cfg.embed_dim, device),
    }


def run_blocks(fn: Callable, blocks: list, x: torch.Tensor,
               remat: bool) -> torch.Tensor:
    """x through fn(blk, x) for each block in turn; with `remat` each
    block is checkpointed (`torch.utils.checkpoint`, non-reentrant): the
    backward recomputes the block's internals from its input, so only
    the residual stream is kept between blocks (the JAX package's
    `jax.checkpoint` per block)."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, blk, x, use_reentrant=False)
        else:
            x = fn(blk, x)
    return x


def vit_features(params: dict, patch_tokens: torch.Tensor, cfg: VitConfig,
                 final_ln: bool = True, remat: bool = False) -> torch.Tensor:
    """Patch tokens [B, T, p*p*3] -> features [B, T+1, width] (bf16).
    `final_ln=False` skips ln_post (the CoCa-exact ordering applies it
    after pooling). `remat` checkpoints each block (`run_blocks`)."""
    x = dense(params["patch"], patch_tokens)
    b = x.shape[0]
    cls = params["cls"].expand(b, 1, cfg.width)
    x = (torch.cat([cls, x.float()], dim=1) + params["pos"][None]
         ).to(torch.bfloat16)
    x = layernorm(params["ln_pre"], x)
    x = run_blocks(lambda blk, h: block(blk, h, cfg.heads)[0],
                   params["blocks"], x, remat)
    return layernorm(params["ln_post"], x) if final_ln else x


def attentional_pool(params: dict, feats: torch.Tensor, pool_heads: int
                     ) -> torch.Tensor:
    """Learned-query cross-attention pooling -> [B, pool_queries, width].
    Native ordering: attention then `pool_ln`. CoCa-exact ordering (when
    `pool_ln_q`/`pool_ln_k` are present): LayerNorm on queries and context
    before attention, no output LayerNorm."""
    b = feats.shape[0]
    if "pool_ln_q" in params:
        q1 = layernorm(params["pool_ln_q"], params["pool_q"])
        kv = layernorm(params["pool_ln_k"], feats)
        out, _ = mha(params["pool_attn"], q1[None].expand(b, *q1.shape),
                     pool_heads, kv=kv)
        return out
    q = params["pool_q"][None].expand(b, *params["pool_q"].shape)
    out, _ = mha(params["pool_attn"], q, pool_heads, kv=feats)
    return layernorm(params["pool_ln"], out)


def encode_image(params: dict, images_u8: torch.Tensor, cfg: VitConfig,
                 remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] -> (pooled tokens [B, Q(-1), width] for the
    decoder, global embedding [B, embed_dim] L2-normalised). `remat`
    checkpoints each ViT block."""
    tokens = preprocess_for_vit(images_u8, cfg.image_size, cfg.patch_size)
    coca_exact = "pool_ln_q" in params
    feats = vit_features(params, tokens, cfg, final_ln=not coca_exact,
                         remat=remat)
    pooled = attentional_pool(params, feats, cfg.pool_heads)
    if coca_exact:
        pooled = layernorm(params["ln_post"], pooled)
    g = dense(params["proj"], pooled[:, 0]).float()
    g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
    if coca_exact:
        pooled = pooled[:, 1:]
    return pooled, g
