"""Captioner fine-tuning: CoCa loss (captioning cross-entropy +
contrastive) plus the batch-hard triplet loss, AdamW.

The counterpart of the JAX package's `train/captioner_train.py`. The
reference's train step is one jitted function that differentiates the
loss and applies `optax.chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=0.01))`; here the gradients come from autograd through the
training forward (`models/captioner.forward`: the LayerNorm kernel
forward and backward, plain attention, cuBLAS products), and the update
is `train/optim.adam_update`. The JAX step runs `forward` a second time
for the triplet loss's image embeddings, the same pure function of the
same inputs; here one forward serves both.

The triplet loss follows the reference's online hard mining: anchors and
positives share an object id, negatives differ; the hardest positive and
the hardest negative per anchor.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..config import CaptionerConfig
from ..models.captioner import caption_losses, forward
from .optim import AdamState, adam_init, adam_update, value_and_grad


def triplet_loss_hard(embeddings: torch.Tensor, object_ids: torch.Tensor,
                      valid: torch.Tensor, margin: float = 0.2
                      ) -> torch.Tensor:
    """Batch-hard triplet loss over L2-normalised embeddings [N, E]:
    squared euclidean distances; per valid anchor with both a positive
    (same object id) and a negative (different id), hinge(hardest
    positive - hardest negative + margin), averaged over those anchors.
    `amax`/`amin` share a gradient among ties, as JAX's max does."""
    d = torch.square(embeddings[:, None] - embeddings[None, :]).sum(dim=-1)
    same = object_ids[:, None] == object_ids[None, :]
    vv = valid[:, None] & valid[None, :]
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    pos_mask = same & vv & ~eye
    neg_mask = ~same & vv
    hardest_pos = torch.where(pos_mask, d, 0.0).amax(dim=1)
    hardest_neg = torch.where(neg_mask, d, torch.inf).amin(dim=1)
    hardest_neg = torch.where(torch.isfinite(hardest_neg), hardest_neg, 0.0)
    has_trip = pos_mask.any(dim=1) & neg_mask.any(dim=1) & valid
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    return (loss * has_trip).sum() / torch.clamp(has_trip.sum(), min=1.0)


# the reference's `make_optimizer` defaults: optax.chain(
# clip_by_global_norm(MAX_GRAD_NORM), adamw(lr, weight_decay=WEIGHT_DECAY))
WEIGHT_DECAY = 0.01
MAX_GRAD_NORM = 1.0


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamState
    step: int


def create_train_state(params: dict) -> TrainState:
    return TrainState(params, adam_init(params), 0)


def loss_and_grads(params: dict, images_u8: torch.Tensor,
                   tokens: torch.Tensor, object_ids: torch.Tensor,
                   sample_valid: torch.Tensor, cfg: CaptionerConfig,
                   triplet_weight: float = 0.0):
    """(gradients as a tree like `params`, total loss, {"caption_ce",
    "contrastive"[, "triplet"]}) of one batch; a leaf the loss does not
    reach gets zeros."""
    def loss(p):
        logits, img_emb, txt_emb = forward(p, images_u8, tokens, cfg)
        total, aux = caption_losses(logits, img_emb, txt_emb, tokens,
                                    p["logit_scale"], cfg)
        if triplet_weight > 0:
            tl = triplet_loss_hard(img_emb, object_ids, sample_valid)
            total = total + triplet_weight * tl
            aux = dict(aux, triplet=tl)
        return total, aux

    total, aux, grads = value_and_grad(loss, params)
    return grads, total, aux


def train_step(state: TrainState, images_u8: torch.Tensor,
               tokens: torch.Tensor, object_ids: torch.Tensor,
               sample_valid: torch.Tensor, cfg: CaptionerConfig,
               lr: float = 1e-4, triplet_weight: float = 0.0,
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One fine-tune step on (crop, caption, object id) triples: uint8
    crops [B, H, W, 3], tokens [B, T], object ids [B], validity [B] bool.
    Returns (new state, {"caption_ce", "contrastive"[, "triplet"],
    "loss"}). The state handed in is not modified; drop it."""
    grads, loss, aux = loss_and_grads(state.params, images_u8, tokens,
                                      object_ids, sample_valid, cfg,
                                      triplet_weight)
    params, opt_state = adam_update(state.params, state.opt_state, grads,
                                    lr, MAX_GRAD_NORM,
                                    weight_decay=WEIGHT_DECAY)
    return TrainState(params, opt_state, state.step + 1), dict(aux,
                                                                loss=loss)
