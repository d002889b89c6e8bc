"""CoCa-class captioner: ViT encoder, unimodal text decoder and multimodal
cross-attention decoder, with the training forward (`forward`,
`caption_loss`) and KV-cached generation: greedy or sampled
(`generate`), beam search (`generate_beam`) and self-speculative greedy
(`generate_speculative`).

The training forward runs every LayerNorm through the LayerNorm kernel
(forward and backward) and the image preprocess through the fused
preprocess kernel; attention and products are plain tensor ops on cuBLAS,
the route the JAX package's `train_step` differentiates.

Per decode step every self-attention and cross-attention sublayer runs as
one block kernel and every MLP as the fused decode-MLP kernel; with
`decode_blocks=False` the attention sublayers run as LayerNorm,
projections and the decode self-/cross-attention kernels instead. Every
`generate*` takes the serving opt-ins `w8a8` (int8 activations into
every product with an int8 weight; the route of separate calls) and
`int8_kv` (int8 cross-attention K/V of int8 projections), as
`common.block` and `common.precompute_kv` read them.

Tensor parallelism: `forward` takes the mesh, whose "model" axis the
leaves `parallel.mesh.shard_params` cut are cut over (Megatron column /
row pairs in every block and the pooler, the vocabulary head by
columns), and returns the gathered logits, as the JAX package's `forward`
on sharded leaves returns global ones; the training loss reads the local
columns (`local_forward`) and computes the cross-entropy vocabulary-
parallel (`caption_nll`). Generation takes whole leaves (the JAX package
runs no sharded `generate`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import CaptionerConfig
from ..ops.geometry import reciprocal32
from ..parallel.mesh import (
    all_gather_cat, axis_group, axis_size, max_replicated,
    partition_spec_for, replicate, sum_replicated,
)
from ..train.optim import tree_leaves, tree_map_with_path
from .common import (
    TP, KVCache, block, block_init, causal_mask, dense, dense_init,
    layernorm, layernorm_init, precompute_kv, randn, tp_group,
)
from .vit import encode_image, init_vit, run_blocks


def init_captioner(g: torch.Generator, cfg: CaptionerConfig, device) -> dict:
    """Random weights with the JAX `init_captioner`'s shapes and scales;
    with `text.moe_experts > 0` every text block's MLP is replaced by a
    mixture-of-experts layer ("moe", `parallel.moe.moe_init`), drawn after
    the other weights (a dense captioner draws what it drew before)."""
    t = cfg.text
    params = {
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
    if t.moe_experts > 0:
        from ..parallel.moe import moe_init

        for blk in params["text_blocks"]:
            del blk["mlp"]
            blk["moe"] = moe_init(g, t.width, int(t.width * t.mlp_ratio),
                                  t.moe_experts, device)
    return params


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

def _text_tp(cfg: CaptionerConfig, group) -> Optional[TP]:
    t = cfg.text
    return None if group is None else TP(group, int(t.width * t.mlp_ratio))


def _text_tower(params: dict, tokens: torch.Tensor, cfg: CaptionerConfig,
                group=None) -> torch.Tensor:
    """Tokens [B, T] -> unimodal text features [B, T, width] (bf16),
    causal self-attention; `group`: tensor-parallel over it."""
    t = tokens.shape[1]
    x = (params["tok_emb"][tokens.long()]
         + params["pos_emb"][None, :t]).to(torch.bfloat16)
    mask = causal_mask(t, tokens.device)
    tp = _text_tp(cfg, group)
    for blk in params["text_blocks"]:
        x, _ = block(blk, x, cfg.text.heads, mask=mask, tp=tp)
    return layernorm(params["ln_text"], x)


def _mm_tower(params: dict, text_feats: torch.Tensor,
              img_tokens: torch.Tensor, heads: int, remat: bool = False,
              tp: Optional[TP] = None) -> torch.Tensor:
    """Text features [B, T, width] cross-attending the pooled image tokens
    -> multimodal features [B, T, width]; `remat` checkpoints each
    block; `tp`: tensor-parallel."""
    mask = causal_mask(text_feats.shape[1], text_feats.device)
    x = run_blocks(lambda blk, h: block(blk, h, heads, mask=mask,
                                        cross=img_tokens, tp=tp)[0],
                   params["mm_blocks"], text_feats, remat)
    return layernorm(params["ln_mm"], x)


def head_group(params: dict, group):
    """`group` where the vocabulary head's columns were cut over it (the
    token embedding holds the whole vocabulary), None where the head was
    kept whole."""
    if group is None:
        return None
    return tp_group(group, params["head"]["w"].shape[-1],
                    params["tok_emb"].shape[0])


def local_forward(params: dict, images_u8: torch.Tensor,
                  tokens: torch.Tensor, cfg: CaptionerConfig, group=None):
    """`forward` with this rank's columns of the logits where the head is
    cut over `group` (the "model" axis's process group; see
    `head_group`)."""
    pooled, img_emb = encode_image(params["vision"], images_u8, cfg.vision,
                                   remat=cfg.remat, group=group)
    text_feats = _text_tower(params, tokens, cfg, group)
    mm = _mm_tower(params, text_feats, pooled, cfg.text.heads,
                   remat=cfg.remat, tp=_text_tp(cfg, group))
    hg = head_group(params, group)
    logits = dense(params["head"], replicate(mm, hg))
    lengths = (tokens != cfg.text.pad_id).sum(dim=1) - 1
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    pooled_txt = text_feats[rows, lengths.clamp(min=0)]
    txt_emb = dense(params["text_proj"], pooled_txt).float()
    txt_emb = txt_emb / torch.clamp(
        torch.linalg.norm(txt_emb, dim=-1, keepdim=True), min=1e-8)
    return logits, img_emb, txt_emb


def forward(params: dict, images_u8: torch.Tensor, tokens: torch.Tensor,
            cfg: CaptionerConfig, mesh=None):
    """Training forward of uint8 crops [B, H, W, 3] and tokens [B, T]:
    (logits [B, T, V] bf16, image embedding [B, E] f32, text embedding
    [B, E] f32), both embeddings L2-normalised; the text embedding is the
    text feature at the last non-pad position. With `mesh`, this rank's
    leaves are its `shard_params` blocks: the forward runs
    tensor-parallel over the "model" axis and the logits are gathered."""
    group = axis_group(mesh, "model")
    logits, img_emb, txt_emb = local_forward(params, images_u8, tokens, cfg,
                                             group)
    hg = head_group(params, group)
    if hg is not None:
        logits = all_gather_cat(logits.movedim(-1, 0).contiguous(), hg
                                ).movedim(0, -1)
    return logits, img_emb, txt_emb


def caption_nll(logits: torch.Tensor, tokens: torch.Tensor,
                cfg: CaptionerConfig, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token negative log-likelihoods [B, T-1] (float32) and the
    non-pad target mask. With `group`, `logits` are this rank's block of
    the vocabulary's columns (`head_group`) and the softmax is
    vocabulary-parallel: the max and the sum of exponentials reduced over
    the group, the target's logit from the rank that owns its column."""
    targets = tokens[:, 1:].long()
    pred = logits[:, :-1]
    mask = (targets != cfg.text.pad_id).float()
    if group is None:
        logp = torch.log_softmax(pred.float(), dim=-1)
        return -torch.gather(logp, 2, targets[..., None])[..., 0], mask
    pred = pred.float()
    v = pred.shape[-1]
    local = targets - dist.get_rank(group) * v
    own = (local >= 0) & (local < v)
    m = max_replicated(pred.amax(dim=-1), group)
    z = sum_replicated(torch.exp(pred - m[..., None]).sum(dim=-1), group)
    picked = torch.gather(pred, 2, local.clamp(0, v - 1)[..., None])[..., 0]
    target = sum_replicated(torch.where(own, picked, 0.0), group)
    return torch.log(z) - (target - m), mask


def contrastive_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """The symmetric CLIP loss of matching image and text embeddings."""
    sim = torch.exp(logit_scale) * img_emb @ txt_emb.T
    return 0.5 * (-torch.log_softmax(sim, dim=1).diagonal().mean()
                  - torch.log_softmax(sim, dim=0).diagonal().mean())


def caption_losses(logits: torch.Tensor, img_emb: torch.Tensor,
                   txt_emb: torch.Tensor, tokens: torch.Tensor,
                   logit_scale: torch.Tensor, cfg: CaptionerConfig,
                   contrastive_weight: float = 1.0,
                   caption_weight: float = 2.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CoCa loss of `forward`'s outputs: caption_weight x next-token
    cross-entropy over non-pad targets + contrastive_weight x the
    symmetric CLIP loss. Returns (total, {"caption_ce", "contrastive"})."""
    nll, mask = caption_nll(logits, tokens, cfg)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    con = contrastive_loss(img_emb, txt_emb, logit_scale)
    return caption_weight * ce + contrastive_weight * con, {
        "caption_ce": ce, "contrastive": con}


def tp_cut_leaves(params: dict, cfg: CaptionerConfig, mesh) -> List[bool]:
    """Per leaf of `params` (`tree_leaves` order): it is this rank's block
    of a leaf `shard_params` cut over the mesh's "model" axis, judged by
    its TP rule and its local width against the full width of the
    configuration (the vocabulary for the head, the tower's MLP width for
    an MLP, the tower's width for attention)."""
    size = axis_size(mesh, "model")

    def full(path: str) -> int:
        if path.startswith("head/"):
            return cfg.text.vocab_size
        tower = cfg.vision if path.startswith("vision/") else cfg.text
        if "mlp/" in path:
            return int(tower.width * tower.mlp_ratio)
        return tower.width

    def cut(path, leaf):
        s = "/".join(str(p) for p in path)
        spec = partition_spec_for(s, leaf, True)
        return size > 1 and any(a == "model" and leaf.shape[i] < full(s)
                                for i, a in enumerate(spec))

    return tree_leaves(tree_map_with_path(cut, params))


def caption_loss(params: dict, images_u8: torch.Tensor, tokens: torch.Tensor,
                 cfg: CaptionerConfig, contrastive_weight: float = 1.0,
                 caption_weight: float = 2.0):
    """CoCa loss = captioning cross-entropy + CLIP-style contrastive (the
    open_clip CoCa objective): (total, {"caption_ce", "contrastive"})."""
    logits, img_emb, txt_emb = forward(params, images_u8, tokens, cfg)
    return caption_losses(logits, img_emb, txt_emb, tokens,
                          params["logit_scale"], cfg, contrastive_weight,
                          caption_weight)


# ---------------------------------------------------------------------------
# KV-cached generation
# ---------------------------------------------------------------------------

def _cross_kvs(params: dict, pooled: torch.Tensor, heads: int,
               w8a8: bool = False, int8_kv: bool = True):
    """Cross-attention K/V of every multimodal block, computed once per
    generation (None for a block without cross-attention; `ln_kv` is
    applied first where present)."""
    out = []
    for blk in params["mm_blocks"]:
        if "xattn" not in blk:
            out.append(None)
            continue
        src = layernorm(blk["ln_kv"], pooled) if "ln_kv" in blk else pooled
        out.append(precompute_kv(blk["xattn"], src, heads, w8a8, int8_kv))
    return out


def _decode_step(params: dict, tok: torch.Tensor, pos: int, cross_kvs,
                 text_caches, mm_caches, cfg: CaptionerConfig,
                 decode_blocks: bool = True, w8a8: bool = False):
    """One cached step: tok [B] -> (logits [B, V] bf16, caches)."""
    logits, tc, mc = _run_tokens(params, tok[:, None], pos, cross_kvs,
                                 text_caches, mm_caches, cfg,
                                 cfg.text.cross_layers, decode_blocks, w8a8)
    return logits[:, 0], tc, mc


def _run_tokens(params: dict, tokens: torch.Tensor, pos: int, cross_kvs,
                text_caches, mm_caches, cfg: CaptionerConfig,
                mm_layers: int, decode_blocks: bool, w8a8: bool = False):
    """Cached pass of tokens [B, W] at positions pos .. pos + W - 1 through
    the text tower and the first `mm_layers` multimodal blocks (the others
    are skipped and their caches returned as they came):
    (logits [B, W, V] bf16, text caches, multimodal caches)."""
    w = tokens.shape[1]
    x = (params["tok_emb"][tokens]
         + params["pos_emb"][pos:pos + w][None]).to(torch.bfloat16)
    new_tc = []
    for blk, c in zip(params["text_blocks"], text_caches):
        x, c = block(blk, x, cfg.text.heads, cache=c,
                     decode_blocks=decode_blocks, w8a8=w8a8)
        new_tc.append(c)
    x = layernorm(params["ln_text"], x)
    new_mc = []
    for i, (blk, c, ckv) in enumerate(zip(params["mm_blocks"], mm_caches,
                                          cross_kvs)):
        if i < mm_layers:
            x, c = block(blk, x, cfg.text.heads, cache=c, cross_kv=ckv,
                         decode_blocks=decode_blocks, w8a8=w8a8)
        new_mc.append(c)
    x = layernorm(params["ln_mm"], x)
    return dense(params["head"], x, w8a8=w8a8), new_tc, new_mc


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float,
                   temperature: float) -> torch.Tensor:
    """logits / temperature with everything below the k-th largest, and
    below the nucleus of mass top_p, set to -inf (HF LogitsProcessor
    semantics; 0 switches a filter off)."""
    logits = logits.float() * reciprocal32(temperature)
    v = logits.shape[-1]
    if 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[:, v - top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if 0.0 < top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=v - 1)
        cutoff = torch.gather(sorted_l, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            top_k: int, top_p: float, temperature: float) -> torch.Tensor:
    """Next token ids [B] from logits [B, V]: argmax if temperature <= 0,
    else a draw from the filtered distribution with `generator` (on the
    logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(_filter_logits(logits, top_k, top_p, temperature),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _new_caches(cfg: CaptionerConfig, batch: int, capacity: int, device):
    t = cfg.text
    hd = t.width // t.heads
    return ([KVCache.create(batch, capacity, t.heads, hd, device)
             for _ in range(t.layers)],
            [KVCache.create(batch, capacity, t.heads, hd, device)
             for _ in range(t.cross_layers)])


@torch.no_grad()
def generate(params: dict, images_u8: torch.Tensor, cfg: CaptionerConfig,
             max_len: Optional[int] = None,
             row_valid: Optional[torch.Tensor] = None,
             top_k: int = 0, top_p: float = 0.0, temperature: float = 0.0,
             full_logits: bool = False,
             generator: Optional[torch.Generator] = None,
             decode_blocks: bool = True, w8a8: bool = False,
             int8_kv: bool = True,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cached captioning of uint8 crops [B, H, W, 3]: greedy at
    temperature 0, else top-k / top-p / temperature sampling with
    `generator`.

    Rows with `row_valid` False start finished; finished rows emit PAD. A
    live row that samples the PAD id finishes too. The loop ends when
    every row has finished or at `max_len`; with `full_logits` it runs
    every step and returns the per-step logits [B, L-1, V] (bf16) in place
    of the chosen-token log-probs.
    Returns (tokens [B, L] int32 incl. BOS, chosen-token log-probs
    [B, L-1] f32, lengths [B] int32)."""
    max_len = max_len or cfg.max_caption_len
    b = images_u8.shape[0]
    t = cfg.text
    dev = images_u8.device
    pooled, _ = encode_image(params["vision"], images_u8, cfg.vision,
                             w8a8=w8a8)
    tc, mc = _new_caches(cfg, b, max_len, dev)
    cross_kvs = _cross_kvs(params, pooled, t.heads, w8a8, int8_kv)

    tokens = torch.full((b, max_len), t.pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = t.bos_id
    if full_logits:
        step_out = torch.zeros(b, max_len - 1, t.vocab_size,
                               dtype=torch.bfloat16, device=dev)
    else:
        step_out = torch.zeros(b, max_len - 1, dtype=torch.float32,
                               device=dev)
    tok = torch.full((b,), t.bos_id, dtype=torch.long, device=dev)
    finished = (torch.zeros(b, dtype=torch.bool, device=dev)
                if row_valid is None else ~row_valid.to(torch.bool))
    pos = 0
    while pos < max_len - 1 and (full_logits or not bool(finished.all())):
        logits, tc, mc = _decode_step(params, tok, pos, cross_kvs, tc, mc,
                                      cfg, decode_blocks, w8a8)
        nxt = _sample(logits, generator, top_k, top_p, temperature)
        was_finished = finished
        nxt = torch.where(finished, t.pad_id, nxt)
        finished = (finished | (nxt == t.eos_id)
                    | (~was_finished & (nxt == t.pad_id)))
        if full_logits:
            step_out[:, pos] = logits
        else:
            logp = torch.log_softmax(logits.float(), dim=-1)
            step_out[:, pos] = torch.gather(logp, 1, nxt[:, None])[:, 0]
        tokens[:, pos + 1] = nxt.to(torch.int32)
        tok = nxt
        pos += 1
    lengths = (tokens != t.pad_id).sum(dim=1).to(torch.int32)
    return tokens, step_out, lengths


@torch.no_grad()
def generate_speculative(params: dict, images_u8: torch.Tensor,
                         cfg: CaptionerConfig, max_len: Optional[int] = None,
                         draft_len: int = 4, draft_layers: int = 1,
                         decode_blocks: bool = True, w8a8: bool = False,
                         int8_kv: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-speculative greedy decoding: the text tower plus the first
    `draft_layers` multimodal blocks propose `draft_len` tokens one at a
    time, then one pass of the whole model over those positions verifies
    them. Acceptance is the minimum over the batch, so every row's caches
    are right up to the accepted position, and a rejection only rewinds
    the cache index. The loop ends when every row has finished or at
    `max_len`. Returns (tokens [B, L] int32, lengths [B] int32).

    The draft steps decode one token per row (the decode kernels); the
    verify pass decodes `draft_len` tokens per row (plain tensor ops), so
    its logits differ from greedy `generate`'s in the last bits of a bf16
    and a near-tie can fall the other way."""
    max_len = max_len or cfg.max_caption_len
    b = images_u8.shape[0]
    t = cfg.text
    w = draft_len
    dev = images_u8.device
    pooled, _ = encode_image(params["vision"], images_u8, cfg.vision,
                             w8a8=w8a8)
    tc, mc = _new_caches(cfg, b, max_len + w + 1, dev)
    cross_kvs = _cross_kvs(params, pooled, t.heads, w8a8, int8_kv)

    def rewind(caches, index):
        return [KVCache(c.k, c.v, index) for c in caches]

    tokens = torch.zeros(b, max_len + w + 1, dtype=torch.int32, device=dev)
    tokens[:, 0] = t.bos_id
    cur = torch.full((b,), t.bos_id, dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        # draft on a copy of the text caches' indices: `tc` stays at `pos`.
        # The multimodal caches stay at `pos` for every draft step, and
        # what the draft writes there the verify pass overwrites
        drafts, tok, dtc = [], cur, tc
        for i in range(w):
            logits, dtc, _ = _run_tokens(params, tok[:, None], pos + i,
                                         cross_kvs, dtc, mc, cfg,
                                         draft_layers, decode_blocks, w8a8)
            tok = torch.argmax(logits[:, 0].float(), dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                       # [B, W]
        # verify [cur, d0 .. d_{w-2}]: column j predicts position pos+1+j
        blk = torch.cat([cur[:, None], drafts[:, :-1]], dim=1)
        logits, tc, mc = _run_tokens(params, blk, pos, cross_kvs, tc, mc,
                                     cfg, t.cross_layers, decode_blocks, w8a8)
        full_next = torch.argmax(logits.float(), dim=-1)          # [B, W]
        match = (full_next == drafts) | finished[:, None]
        acc_row = torch.cumprod(match.int(), dim=1).sum(dim=1)
        # greedy stops at the first EOS
        eos_cap = torch.cumprod((drafts != t.eos_id).int(), dim=1
                                ).sum(dim=1) + 1
        a = int(torch.minimum(acc_row, eos_cap).min().clamp(0, w))
        val = torch.where(finished[:, None], t.pad_id, drafts)
        tokens[:, pos + 1:pos + 1 + a] = val[:, :a].to(torch.int32)
        finished = finished | (drafts[:, :a] == t.eos_id).any(dim=1)
        if a >= w:
            # the last draft is written but not cached yet
            cur = drafts[:, w - 1]
            pos = pos + a
        else:
            cur = full_next[:, a]
            pos = pos + a + 1
        cur = torch.where(finished, t.pad_id, cur)
        if a < w:
            tokens[:, pos] = cur.to(torch.int32)
        finished = finished | (cur == t.eos_id)
        tc, mc = rewind(tc, pos), rewind(mc, pos)
    tokens = tokens[:, :max_len].contiguous()
    lengths = (tokens != t.pad_id).sum(dim=1).to(torch.int32)
    return tokens, lengths


@torch.no_grad()
def generate_beam(params: dict, images_u8: torch.Tensor,
                  cfg: CaptionerConfig, max_len: Optional[int] = None,
                  num_beams: int = 4, length_penalty: float = 1.0,
                  decode_blocks: bool = True, w8a8: bool = False,
                  int8_kv: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search captioning. The batch is expanded B -> B * num_beams and
    the KV caches are re-gathered along it after each beam reshuffle;
    finished beams extend with PAD at no cost; the loop ends when every
    beam has finished or at `max_len`. Returns (tokens [B, L] int32 of the
    best beam by score / length^length_penalty, that score [B] f32)."""
    max_len = max_len or cfg.max_caption_len
    w = num_beams
    b = images_u8.shape[0]
    t = cfg.text
    dev = images_u8.device
    pooled, _ = encode_image(params["vision"], images_u8, cfg.vision,
                             w8a8=w8a8)
    pooled = pooled.repeat_interleave(w, dim=0)
    bw = b * w
    tc, mc = _new_caches(cfg, bw, max_len, dev)
    cross_kvs = _cross_kvs(params, pooled, t.heads, w8a8, int8_kv)

    neg = -1e9
    # beam 0 live, the others dead at the start (identical prefixes)
    scores = torch.tensor([0.0] + [neg] * (w - 1), dtype=torch.float32,
                          device=dev).repeat(b)
    tokens = torch.full((bw, max_len), t.pad_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = t.bos_id
    tok = torch.full((bw,), t.bos_id, dtype=torch.long, device=dev)
    finished = torch.zeros(bw, dtype=torch.bool, device=dev)
    v = t.vocab_size
    pad_only = torch.full((v,), neg, dtype=torch.float32, device=dev)
    pad_only[t.pad_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * w
    pos = 0
    while pos < max_len - 1 and not bool(finished.all()):
        logits, tc, mc = _decode_step(params, tok, pos, cross_kvs, tc, mc,
                                      cfg, decode_blocks, w8a8)
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = torch.where(finished[:, None], pad_only, logp)
        cand = (scores[:, None] + logp).reshape(b, w * v)
        # a stable sort: ties go to the lower index
        order = torch.sort(cand, dim=1, descending=True, stable=True)
        top_idx = order.indices[:, :w]
        scores = order.values[:, :w].reshape(-1)
        tok = (top_idx % v).reshape(-1)
        gather = (rows + top_idx // v).reshape(-1)
        finished = finished[gather] | (tok == t.eos_id)
        tokens = tokens[gather]
        tokens[:, pos + 1] = tok.to(torch.int32)
        tc = [KVCache(c.k[gather], c.v[gather], c.index) for c in tc]
        mc = [KVCache(c.k[gather], c.v[gather], c.index) for c in mc]
        pos += 1
    lengths = (tokens != t.pad_id).sum(dim=1).float()
    norm = (scores / torch.clamp(lengths, min=1.0) ** length_penalty
            ).reshape(b, w)
    best = torch.argmax(norm, dim=1)
    pick = torch.arange(b, device=dev)
    return tokens.reshape(b, w, max_len)[pick, best], norm[pick, best]


def perplexity(step_out: torch.Tensor, tokens: torch.Tensor,
               pad_id: int = 0) -> torch.Tensor:
    """exp(mean -log p(chosen)) over the decode steps of each sequence,
    from `generate`'s chosen-token log-probs [B, L-1] or its full step
    logits [B, L-1, V]; PAD targets are left out."""
    chosen = tokens[:, 1:].long()
    if step_out.dim() == 3:
        logp = torch.log_softmax(step_out.float(), dim=-1)
        nll = -torch.gather(logp, 2, chosen[..., None])[..., 0]
    else:
        nll = -step_out.float()
    mask = (chosen != pad_id).float()
    mean_nll = (nll * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
    return torch.exp(mean_nll)
