"""BLIP-2-class captioner: ViT encoder, Q-Former bridge and causal LM
decoder, with the image-text contrastive (ITC) and matching (ITM) scores
of the pseudo-captioner's BLIP-2 methods.

  ViT encoder (`models/vit.py`: the fused preprocess kernel, flash
    attention, the LayerNorm kernel)
  Q-Former: learned queries; per layer self-attention over
    [queries ; text] and cross-attention of the queries into the image
    tokens
  LM: a causal transformer over [projected queries ; caption], the query
    prefix visible to every position
  ITC: max over queries of the cosine of query and unimodal text
    embeddings; ITM: a binary head over the joint query features

`generate` primes the LM's KV caches with the query prefix in one pass
(full visibility within the prefix), then decodes greedily one token a
step through the decode kernels (`common.block`). On an int8 tree,
`w8a8` (the JAX package's ECAP_W8A8) gives every product int8
activations, and a decode step runs as separate calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..config import VitConfig
from ..ops.image import preprocess_for_vit
from .common import (
    KVCache, block, block_init, dense, dense_init, layernorm, layernorm_init,
    mha, mlp, randn,
)
from .tokenizer import BOS_ID, EOS_ID, PAD_ID
from .vit import init_vit, vit_features


@dataclass(frozen=True)
class Blip2Config:
    vision: VitConfig = field(default_factory=VitConfig)
    num_queries: int = 32
    qformer_width: int = 768
    qformer_layers: int = 6
    qformer_heads: int = 12
    lm_width: int = 768
    lm_layers: int = 12
    lm_heads: int = 12
    vocab_size: int = 1024
    context_length: int = 77
    max_caption_len: int = 30
    embed_dim: int = 256  # ITC projection

    @staticmethod
    def tiny() -> "Blip2Config":
        return Blip2Config(
            vision=VitConfig(image_size=64, patch_size=8, width=64, layers=2,
                             heads=2, pool_queries=8, pool_heads=2,
                             embed_dim=64),
            num_queries=8, qformer_width=64, qformer_layers=2,
            qformer_heads=2, lm_width=64, lm_layers=2, lm_heads=2,
            context_length=32, max_caption_len=12, embed_dim=32)


def init_blip2(g: torch.Generator, cfg: Blip2Config, device) -> dict:
    """Random weights with the JAX `init_blip2`'s shapes and scales, drawn
    from `g` (numbers differ from jax.random)."""
    qw, lw = cfg.qformer_width, cfg.lm_width
    return {
        "vision": init_vit(g, cfg.vision, device),
        "queries": randn(g, (cfg.num_queries, qw), device, 0.02),
        "q_tok_emb": randn(g, (cfg.vocab_size, qw), device, 0.02),
        "q_pos": randn(g, (cfg.context_length, qw), device, 0.02),
        "q_blocks": [block_init(g, qw, 4.0, device,
                                cross_dim=cfg.vision.width)
                     for _ in range(cfg.qformer_layers)],
        "q_ln": layernorm_init(qw, device),
        "itc_img": dense_init(g, qw, cfg.embed_dim, device),
        "itc_txt": dense_init(g, qw, cfg.embed_dim, device),
        "itm_head": dense_init(g, qw, 2, device),
        "lm_proj": dense_init(g, qw, lw, device),
        "lm_tok_emb": randn(g, (cfg.vocab_size, lw), device, 0.02),
        "lm_pos": randn(g, (cfg.num_queries + cfg.context_length, lw),
                        device, 0.02),
        "lm_blocks": [block_init(g, lw, 4.0, device)
                      for _ in range(cfg.lm_layers)],
        "lm_ln": layernorm_init(lw, device),
        "lm_head": dense_init(g, lw, cfg.vocab_size, device),
        "logit_scale": torch.tensor(2.659, device=device),
    }


# ---------------------------------------------------------------------------
# Q-Former
# ---------------------------------------------------------------------------

def _text_embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    t = tokens.shape[1]
    return (params["q_tok_emb"][tokens.long()]
            + params["q_pos"][None, :t]).to(torch.bfloat16)


def qformer(params: dict, img_feats: Optional[torch.Tensor],
            cfg: Blip2Config,
            text_tokens: Optional[torch.Tensor] = None,
            w8a8: bool = False) -> torch.Tensor:
    """Queries (and optional text) attend jointly; the queries
    cross-attend the image. `img_feats=None` is the unimodal text mode
    (the ITC text branch): the text self-attends only, no queries and no
    image. Returns [B, Q(+T), width] (or [B, T, width] in text mode),
    bf16. `w8a8` goes to every product."""
    nq = cfg.num_queries
    if img_feats is None:
        if text_tokens is None:
            raise ValueError("text_tokens required in unimodal text mode")
        nq = 0
        x = _text_embed(params, text_tokens)
        attn_mask = (text_tokens != PAD_ID)[:, None, None, :]
    else:
        b = img_feats.shape[0]
        x = params["queries"][None].expand(b, *params["queries"].shape
                                           ).to(torch.bfloat16)
        if text_tokens is not None:
            x = torch.cat([x, _text_embed(params, text_tokens)], dim=1)
            pad = text_tokens != PAD_ID
            attn_mask = torch.cat(
                [torch.ones(b, nq, dtype=torch.bool, device=pad.device),
                 pad], dim=1)[:, None, None, :]
        else:
            attn_mask = None
    for blk in params["q_blocks"]:
        # self-attention over [queries ; text]
        h, _ = mha(blk["attn"], layernorm(blk["ln1"], x), cfg.qformer_heads,
                   mask=attn_mask, w8a8=w8a8)
        x = x + h
        if img_feats is not None:
            # only the queries cross-attend into the image: a bf16 add into
            # the query rows
            h, _ = mha(blk["xattn"], layernorm(blk["ln_x"], x[:, :nq]),
                       cfg.qformer_heads, kv=img_feats, w8a8=w8a8)
            x = torch.cat([x[:, :nq] + h, x[:, nq:]], dim=1)
        x = x + mlp(blk["mlp"], layernorm(blk["ln2"], x), w8a8=w8a8)
    return layernorm(params["q_ln"], x)


def _image_features(params: dict, images_u8: torch.Tensor, cfg: Blip2Config,
                    w8a8: bool = False) -> torch.Tensor:
    return vit_features(params["vision"], preprocess_for_vit(
        images_u8, cfg.vision.image_size, cfg.vision.patch_size), cfg.vision,
        w8a8=w8a8)


def encode_image_queries(params: dict, images_u8: torch.Tensor,
                         cfg: Blip2Config, w8a8: bool = False
                         ) -> torch.Tensor:
    """uint8 images [B, H, W, 3] -> query features [B, Q, width]."""
    return qformer(params, _image_features(params, images_u8, cfg, w8a8),
                   cfg, w8a8=w8a8)


# ---------------------------------------------------------------------------
# ITC / ITM scores
# ---------------------------------------------------------------------------

def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def itc_score(params: dict, images_u8: torch.Tensor, tokens: torch.Tensor,
              cfg: Blip2Config, w8a8: bool = False) -> torch.Tensor:
    """Image-text contrastive score [B] f32: the max over queries of the
    cosine of the query embedding and the text embedding, the text from
    the Q-Former's unimodal text mode (mean over its non-PAD positions).
    `w8a8` (the JAX package's ECAP_W8A8): every product with an int8
    weight takes int8 activations."""
    q = encode_image_queries(params, images_u8, cfg, w8a8)
    qe = _l2_normalise(dense(params["itc_img"], q, w8a8=w8a8).float())
    txt_feats = qformer(params, None, cfg, text_tokens=tokens, w8a8=w8a8)
    pad = (tokens != PAD_ID).float()[..., None]
    te = (txt_feats * pad).sum(dim=1) / torch.clamp(pad.sum(dim=1), min=1.0)
    te = _l2_normalise(dense(params["itc_txt"], te, w8a8=w8a8).float())
    return torch.einsum("bqd,bd->bq", qe, te).amax(dim=1)


def itm_score(params: dict, images_u8: torch.Tensor, tokens: torch.Tensor,
              cfg: Blip2Config, w8a8: bool = False) -> torch.Tensor:
    """Image-text matching probability [B] f32 from the joint query
    features (their mean, rounded to bf16 as JAX's bf16 mean is). `w8a8`
    as in `itc_score`."""
    joint = qformer(params, _image_features(params, images_u8, cfg, w8a8),
                    cfg, text_tokens=tokens, w8a8=w8a8)
    pooled = joint[:, :cfg.num_queries].float().mean(dim=1).to(
        torch.bfloat16)
    logits = dense(params["itm_head"], pooled, w8a8=w8a8)
    return torch.softmax(logits.float(), dim=-1)[:, 1]


# ---------------------------------------------------------------------------
# the captioning LM
# ---------------------------------------------------------------------------

def _lm_prefix(params: dict, images_u8: torch.Tensor, cfg: Blip2Config,
               w8a8: bool = False) -> torch.Tensor:
    q = encode_image_queries(params, images_u8, cfg, w8a8)
    return dense(params["lm_proj"], q, w8a8=w8a8)  # [B, Q, lm_width] bf16


def lm_logits(params: dict, images_u8: torch.Tensor, tokens: torch.Tensor,
              cfg: Blip2Config, w8a8: bool = False) -> torch.Tensor:
    """Teacher-forced logits [B, T, V] (bf16) of tokens [B, T] after the
    query prefix, which every position sees (prefix-LM mask). `w8a8` as
    in `itc_score`."""
    prefix = _lm_prefix(params, images_u8, cfg, w8a8)
    nq = prefix.shape[1]
    t = tokens.shape[1]
    emb = params["lm_tok_emb"][tokens.long()]
    x = (torch.cat([prefix.float(), emb], dim=1)
         + params["lm_pos"][None, :nq + t]).to(torch.bfloat16)
    total = nq + t
    mask = torch.tril(torch.ones(total, total, dtype=torch.bool,
                                 device=x.device))
    mask[:, :nq] = True  # the prefix is visible everywhere
    mask = mask[None, None]
    for blk in params["lm_blocks"]:
        x, _ = block(blk, x, cfg.lm_heads, mask=mask, w8a8=w8a8)
    x = layernorm(params["lm_ln"], x)
    return dense(params["lm_head"], x[:, nq:], w8a8=w8a8)


@torch.no_grad()
def generate(params: dict, images_u8: torch.Tensor, generator,
             cfg: Blip2Config, max_len: Optional[int] = None,
             decode_blocks: bool = True, w8a8: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cached greedy captioning of uint8 images [B, H, W, 3].
    `generator` stands where the JAX function takes a key, and is used for
    nothing, as that key is not. The caches (Q + max_len positions) are
    primed with the query prefix in one pass, then every step decodes one
    token (all max_len - 1 steps run). Finished rows emit PAD. Returns
    (tokens [B, L] int32 with BOS first, the step logits [B, L-1, V] bf16,
    lengths [B] int32: the non-PAD tokens). `w8a8` as in `itc_score`;
    under it each decode step runs as separate calls (the standalone
    `decode_self_attention`), as `common.decode_route` says."""
    del generator
    max_len = max_len or cfg.max_caption_len
    prefix = _lm_prefix(params, images_u8, cfg, w8a8)
    b, nq, _ = prefix.shape
    dev = prefix.device
    hd = cfg.lm_width // cfg.lm_heads
    caches = [KVCache.create(b, nq + max_len, cfg.lm_heads, hd, dev)
              for _ in range(cfg.lm_layers)]
    # the priming pass: every prefix position sees the whole prefix
    x = (prefix.float() + params["lm_pos"][None, :nq]).to(torch.bfloat16)
    for i, blk in enumerate(params["lm_blocks"]):
        x, caches[i] = block(blk, x, cfg.lm_heads, cache=caches[i],
                             cache_block_causal=False,
                             decode_blocks=decode_blocks, w8a8=w8a8)
    tokens = torch.full((b, max_len), PAD_ID, dtype=torch.int32, device=dev)
    tokens[:, 0] = BOS_ID
    step_logits = torch.zeros(b, max_len - 1, cfg.vocab_size,
                              dtype=torch.bfloat16, device=dev)
    tok = torch.full((b,), BOS_ID, dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for pos in range(max_len - 1):
        x = (params["lm_tok_emb"][tok][:, None]
             + params["lm_pos"][nq + pos][None, None]).to(torch.bfloat16)
        for i, blk in enumerate(params["lm_blocks"]):
            x, caches[i] = block(blk, x, cfg.lm_heads, cache=caches[i],
                                 decode_blocks=decode_blocks, w8a8=w8a8)
        logits = dense(params["lm_head"], layernorm(params["lm_ln"], x),
                       w8a8=w8a8)[:, 0]
        nxt = torch.argmax(logits.float(), dim=-1)
        nxt = torch.where(finished, PAD_ID, nxt)
        finished = finished | (nxt == EOS_ID)
        step_logits[:, pos] = logits
        tokens[:, pos + 1] = nxt.to(torch.int32)
        tok = nxt
    lengths = (tokens != PAD_ID).sum(dim=1).to(torch.int32)
    return tokens, step_logits, lengths


def blip2_caption_loss(params: dict, images_u8: torch.Tensor,
                       tokens: torch.Tensor, cfg: Blip2Config
                       ) -> torch.Tensor:
    """The LM's next-token cross-entropy over the non-PAD targets."""
    logits = lm_logits(params, images_u8, tokens, cfg)
    targets = tokens[:, 1:].long()
    mask = (targets != PAD_ID).float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, 2, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
