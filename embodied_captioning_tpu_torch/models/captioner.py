"""CoCa-class captioner: ViT encoder, unimodal text decoder and multimodal
cross-attention decoder, with KV-cached greedy generation.

Per decode step every self-attention runs the decode self-attention
kernel, every cross-attention the decode cross-attention kernel, and every
MLP the fused decode-MLP kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import CaptionerConfig
from .common import (
    KVCache, block, block_init, dense, dense_init, layernorm, layernorm_init,
    precompute_kv, randn,
)
from .vit import encode_image, init_vit


def init_captioner(g: torch.Generator, cfg: CaptionerConfig, device) -> dict:
    t = cfg.text
    return {
        "vision": init_vit(g, cfg.vision, device),
        "tok_emb": randn(g, (t.vocab_size, t.width), device, 0.02),
        "pos_emb": randn(g, (t.context_length, t.width), device, 0.01),
        "text_blocks": [block_init(g, t.width, t.mlp_ratio, device)
                        for _ in range(t.layers)],
        "mm_blocks": [block_init(g, t.width, t.mlp_ratio, device,
                                 cross_dim=cfg.vision.width)
                      for _ in range(t.cross_layers)],
        "ln_text": layernorm_init(t.width, device),
        "ln_mm": layernorm_init(t.width, device),
        "text_proj": dense_init(g, t.width, cfg.vision.embed_dim, device),
        "head": dense_init(g, t.width, t.vocab_size, device),
        "logit_scale": torch.tensor(2.659, device=device),
    }


def _cross_kvs(params: dict, pooled: torch.Tensor, heads: int):
    """Cross-attention K/V of every multimodal block, computed once per
    generation (None for a block without cross-attention; `ln_kv` is
    applied first where present)."""
    out = []
    for blk in params["mm_blocks"]:
        if "xattn" not in blk:
            out.append(None)
            continue
        src = layernorm(blk["ln_kv"], pooled) if "ln_kv" in blk else pooled
        out.append(precompute_kv(blk["xattn"], src, heads))
    return out


def _decode_step(params: dict, tok: torch.Tensor, pos: int, cross_kvs,
                 text_caches, mm_caches, cfg: CaptionerConfig):
    """One cached step: tok [B] -> (logits [B, V] bf16, caches)."""
    x = (params["tok_emb"][tok][:, None, :]
         + params["pos_emb"][pos][None, None]).to(torch.bfloat16)
    new_tc = []
    for blk, c in zip(params["text_blocks"], text_caches):
        x, c = block(blk, x, cfg.text.heads, cache=c)
        new_tc.append(c)
    x = layernorm(params["ln_text"], x)
    new_mc = []
    for blk, c, ckv in zip(params["mm_blocks"], mm_caches, cross_kvs):
        x, c = block(blk, x, cfg.text.heads, cache=c, cross_kv=ckv)
        new_mc.append(c)
    x = layernorm(params["ln_mm"], x)
    return dense(params["head"], x)[:, 0], new_tc, new_mc


@torch.no_grad()
def generate(params: dict, images_u8: torch.Tensor, cfg: CaptionerConfig,
             max_len: Optional[int] = None,
             row_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy KV-cached captioning of uint8 crops [B, H, W, 3].

    Rows with `row_valid` False start finished; finished rows emit PAD.
    The loop ends when every row has finished or at `max_len`.
    Returns (tokens [B, L] int32 incl. BOS, chosen-token log-probs
    [B, L-1] f32, lengths [B] int32)."""
    max_len = max_len or cfg.max_caption_len
    b = images_u8.shape[0]
    t = cfg.text
    dev = images_u8.device
    pooled, _ = encode_image(params["vision"], images_u8, cfg.vision)
    hd = t.width // t.heads
    tc = [KVCache.create(b, max_len, t.heads, hd, dev)
          for _ in range(t.layers)]
    mc = [KVCache.create(b, max_len, t.heads, hd, dev)
          for _ in range(t.cross_layers)]
    cross_kvs = _cross_kvs(params, pooled, t.heads)

    tokens = torch.full((b, max_len), t.pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = t.bos_id
    step_out = torch.zeros(b, max_len - 1, dtype=torch.float32, device=dev)
    tok = torch.full((b,), t.bos_id, dtype=torch.long, device=dev)
    finished = (torch.zeros(b, dtype=torch.bool, device=dev)
                if row_valid is None else ~row_valid.to(torch.bool))
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        logits, tc, mc = _decode_step(params, tok, pos, cross_kvs, tc, mc,
                                      cfg)
        logits = logits.float()
        nxt = torch.argmax(logits, dim=-1)
        was_finished = finished
        nxt = torch.where(finished, t.pad_id, nxt)
        finished = (finished | (nxt == t.eos_id)
                    | (~was_finished & (nxt == t.pad_id)))
        logp = torch.log_softmax(logits, dim=-1)
        step_out[:, pos] = torch.gather(logp, 1, nxt[:, None])[:, 0]
        tokens[:, pos + 1] = nxt.to(torch.int32)
        tok = nxt
        pos += 1
    lengths = (tokens != t.pad_id).sum(dim=1).to(torch.int32)
    return tokens, step_out, lengths
