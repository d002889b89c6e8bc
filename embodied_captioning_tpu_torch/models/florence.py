"""Florence-2-class vision-language model: detection as language.

One decoder emits task-conditioned token sequences: captions for
"<CAPTION>", and groups of four location tokens and a class token for
"<OD>" object detection. Box coordinates are quantized into
`NUM_LOC_BINS` location tokens appended to the text vocabulary:
[text | location bins | task tokens | class tokens].

A ViT encoder (`models/vit.py`) and a causal decoder with cross-attention
into its features. `generate` primes the KV caches with BOS, feeds the
task token, then decodes greedily through the decode kernels, the cross
K/V of every layer computed once (`common.precompute_kv`; int8 under
`int8_kv` on an int8 tree, and under `w8a8` int8 activations in every
product and a decode step as separate calls, the JAX package's
ECAP_INT8_KV and ECAP_W8A8). The numpy
codecs between boxes and location tokens round-trip exactly at bin
resolution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import NUM_CLASSES, VitConfig
from ..ops.image import preprocess_for_vit
from .common import (
    KVCache, block, block_init, causal_mask, dense, dense_init, layernorm,
    layernorm_init, precompute_kv, randn,
)
from .tokenizer import BOS_ID, EOS_ID, PAD_ID, Tokenizer, default_tokenizer
from .vit import init_vit, vit_features

NUM_LOC_BINS = 64
TASKS = ("<CAPTION>", "<OD>")
TASK_CAPTION = 0
TASK_OD = 1


@dataclass(frozen=True)
class FlorenceConfig:
    vision: VitConfig = field(default_factory=VitConfig)
    text_vocab: int = 1024           # base BPE vocabulary
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_seq: int = 128
    mlp_ratio: float = 4.0

    @property
    def loc_offset(self) -> int:
        return self.text_vocab

    @property
    def task_offset(self) -> int:
        return self.text_vocab + NUM_LOC_BINS

    @property
    def class_offset(self) -> int:
        return self.task_offset + len(TASKS)

    @property
    def vocab_size(self) -> int:
        return self.class_offset + NUM_CLASSES

    @staticmethod
    def tiny() -> "FlorenceConfig":
        return FlorenceConfig(
            vision=VitConfig(image_size=64, patch_size=8, width=64, layers=2,
                             heads=2, pool_queries=8, pool_heads=2,
                             embed_dim=64),
            width=64, layers=2, heads=2, max_seq=48)


# ---------------------------------------------------------------------------
# box <-> location-token codec
# ---------------------------------------------------------------------------

def boxes_to_loc_tokens(boxes: np.ndarray, image_size: int,
                        cfg: FlorenceConfig) -> np.ndarray:
    """XYXY pixel boxes [N, 4] -> location token ids [N, 4] (bin =
    floor(x / S * bins), clamped)."""
    b = np.clip((np.asarray(boxes) / image_size * NUM_LOC_BINS), 0,
                NUM_LOC_BINS - 1).astype(np.int64)
    return b + cfg.loc_offset


def loc_tokens_to_boxes(tokens: np.ndarray, image_size: int,
                        cfg: FlorenceConfig) -> np.ndarray:
    """Location token ids [N, 4] -> XYXY boxes at the bins' centres."""
    bins = np.asarray(tokens) - cfg.loc_offset
    return (bins + 0.5) / NUM_LOC_BINS * image_size


def encode_od_targets(boxes: np.ndarray, classes: np.ndarray,
                      valid: np.ndarray, image_size: int,
                      cfg: FlorenceConfig) -> List[int]:
    """Detections as the OD token sequence:
    BOS <OD> (loc loc loc loc cls)* EOS."""
    seq = [BOS_ID, cfg.task_offset + TASK_OD]
    for i in np.nonzero(np.asarray(valid))[0]:
        seq += list(boxes_to_loc_tokens(boxes[i][None], image_size,
                                        cfg)[0])
        seq.append(cfg.class_offset + int(classes[i]))
    seq.append(EOS_ID)
    return seq


def decode_od_sequence(tokens: np.ndarray, image_size: int,
                       cfg: FlorenceConfig
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """A generated OD sequence -> (boxes [K, 4] f32, classes [K])."""
    toks = [int(t) for t in np.asarray(tokens)
            if t not in (BOS_ID, PAD_ID)]
    if toks and toks[0] == cfg.task_offset + TASK_OD:
        toks = toks[1:]
    boxes, classes = [], []
    group: List[int] = []
    for t in toks:
        if t == EOS_ID:
            break
        if cfg.loc_offset <= t < cfg.loc_offset + NUM_LOC_BINS:
            group.append(t)
        elif t >= cfg.class_offset and len(group) >= 4:
            boxes.append(loc_tokens_to_boxes(
                np.asarray(group[:4])[None], image_size, cfg)[0])
            classes.append(t - cfg.class_offset)
            group = []
        else:
            group = []
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
    return np.stack(boxes).astype(np.float32), np.asarray(classes)


def encode_caption_targets(caption_ids: List[int], cfg: FlorenceConfig
                           ) -> List[int]:
    """BOS <CAPTION> text... EOS (caption_ids from the shared tokenizer,
    without BOS and EOS)."""
    return ([BOS_ID, cfg.task_offset + TASK_CAPTION] + list(caption_ids)
            + [EOS_ID])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def init_florence(g: torch.Generator, cfg: FlorenceConfig, device) -> dict:
    """Random weights with the JAX `init_florence`'s shapes and scales,
    drawn from `g` (numbers differ from jax.random)."""
    return {
        "vision": init_vit(g, cfg.vision, device),
        "tok_emb": randn(g, (cfg.vocab_size, cfg.width), device, 0.02),
        "pos_emb": randn(g, (cfg.max_seq, cfg.width), device, 0.02),
        "blocks": [block_init(g, cfg.width, cfg.mlp_ratio, device,
                              cross_dim=cfg.vision.width)
                   for _ in range(cfg.layers)],
        "ln": layernorm_init(cfg.width, device),
        "head": dense_init(g, cfg.width, cfg.vocab_size, device),
    }


def _encode(params: dict, images_u8: torch.Tensor, cfg: FlorenceConfig,
            w8a8: bool = False) -> torch.Tensor:
    return vit_features(params["vision"], preprocess_for_vit(
        images_u8, cfg.vision.image_size, cfg.vision.patch_size), cfg.vision,
        w8a8=w8a8)


def florence_logits(params: dict, images_u8: torch.Tensor,
                    tokens: torch.Tensor, cfg: FlorenceConfig,
                    w8a8: bool = False) -> torch.Tensor:
    """Teacher-forced decoder logits [B, T, V] (bf16). `w8a8` (the JAX
    package's ECAP_W8A8): every product with an int8 weight takes int8
    activations."""
    feats = _encode(params, images_u8, cfg, w8a8)
    t = tokens.shape[1]
    x = (params["tok_emb"][tokens.long()]
         + params["pos_emb"][None, :t]).to(torch.bfloat16)
    mask = causal_mask(t, x.device)
    for blk in params["blocks"]:
        x, _ = block(blk, x, cfg.heads, mask=mask, cross=feats, w8a8=w8a8)
    return dense(params["head"], layernorm(params["ln"], x), w8a8=w8a8)


def florence_loss(params: dict, images_u8: torch.Tensor,
                  tokens: torch.Tensor, cfg: FlorenceConfig) -> torch.Tensor:
    """Next-token cross-entropy over the task sequence (caption or OD)."""
    logits = florence_logits(params, images_u8, tokens, cfg)
    tgt = tokens[:, 1:].long()
    mask = (tgt != PAD_ID).float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, 2, tgt[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@torch.no_grad()
def generate(params: dict, images_u8: torch.Tensor, cfg: FlorenceConfig,
             task: int = TASK_CAPTION, max_len: Optional[int] = None,
             decode_blocks: bool = True, w8a8: bool = False,
             int8_kv: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached greedy generation conditioned on the task token: BOS at
    position 0 (its logits unused), the task token at 1, then max_len - 2
    decoded tokens (all steps run; finished rows emit PAD). Returns
    (tokens [B, max_len] int32 with BOS and the task token first, lengths
    [B] int32: the non-PAD tokens). `w8a8` as in `florence_logits`; under
    it each decode step runs as separate calls (the standalone decode
    attentions), as `common.decode_route` says. `int8_kv` (the JAX
    package's ECAP_INT8_KV): the cross K/V of int8 projections are
    quantized to int8 too."""
    max_len = max_len or cfg.max_seq
    b = images_u8.shape[0]
    feats = _encode(params, images_u8, cfg, w8a8)
    dev = feats.device
    hd = cfg.width // cfg.heads
    caches = [KVCache.create(b, max_len, cfg.heads, hd, dev)
              for _ in range(cfg.layers)]
    cross_kvs = [precompute_kv(blk["xattn"], feats, cfg.heads, w8a8=w8a8,
                               int8_kv=int8_kv)
                 for blk in params["blocks"]]

    def run_token(tok: torch.Tensor, pos: int) -> torch.Tensor:
        x = (params["tok_emb"][tok][:, None]
             + params["pos_emb"][pos][None, None]).to(torch.bfloat16)
        for i, (blk, ckv) in enumerate(zip(params["blocks"], cross_kvs)):
            x, caches[i] = block(blk, x, cfg.heads, cache=caches[i],
                                 cross_kv=ckv, decode_blocks=decode_blocks,
                                 w8a8=w8a8)
        return dense(params["head"], layernorm(params["ln"], x),
                     w8a8=w8a8)[:, 0]

    tokens = torch.full((b, max_len), PAD_ID, dtype=torch.int32, device=dev)
    tokens[:, 0] = BOS_ID
    tokens[:, 1] = cfg.task_offset + task
    run_token(torch.full((b,), BOS_ID, dtype=torch.long, device=dev), 0)
    tok = torch.full((b,), cfg.task_offset + task, dtype=torch.long,
                     device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for pos in range(1, max_len - 1):
        logits = run_token(tok, pos)
        nxt = torch.argmax(logits.float(), dim=-1)
        nxt = torch.where(finished, PAD_ID, nxt)
        finished = finished | (nxt == EOS_ID)
        tokens[:, pos + 1] = nxt.to(torch.int32)
        tok = nxt
    lengths = (tokens != PAD_ID).sum(dim=1).to(torch.int32)
    return tokens, lengths


class Florence:
    """Host wrapper with caption() and detect(). Weights default to
    `init_florence` from a generator seeded with `seed`, on `device`."""

    def __init__(self, cfg: Optional[FlorenceConfig] = None, seed: int = 0,
                 params: Optional[dict] = None,
                 tokenizer: Optional[Tokenizer] = None, device="cuda"):
        self.cfg = cfg or FlorenceConfig.tiny()
        self.device = torch.device(device)
        self.params = params or init_florence(
            torch.Generator(device=self.device).manual_seed(seed), self.cfg,
            self.device)
        self.tokenizer = tokenizer or default_tokenizer(self.cfg.text_vocab)

    def _generate(self, images_u8: np.ndarray, task: int) -> np.ndarray:
        toks, _ = generate(self.params, torch.as_tensor(
            np.asarray(images_u8), device=self.device), self.cfg, task=task)
        return toks.cpu().numpy()

    def caption(self, images_u8: np.ndarray) -> List[str]:
        out = []
        for row in self._generate(images_u8, TASK_CAPTION):
            ids = [int(t) for t in row[2:]
                   if t < self.cfg.text_vocab]  # no loc/task/class ids
            out.append(self.tokenizer.decode(ids))
        return out

    def detect(self, images_u8: np.ndarray):
        """Detection as language: [(boxes [K, 4], classes [K])] an image,
        the location bins decoded into the input image's pixels (the bins
        are relative; the ViT resizes internally)."""
        side = np.asarray(images_u8).shape[1]
        return [decode_od_sequence(row[2:], side, self.cfg)
                for row in self._generate(images_u8, TASK_OD)]
