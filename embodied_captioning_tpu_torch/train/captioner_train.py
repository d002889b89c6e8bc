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

With a ("data", "model") mesh the step is the reference's sharded jit
written out: the leaves are this rank's `shard_params` blocks and the
batch its `shard_batch` block. The forward runs tensor-parallel over
"model" with a vocabulary-parallel cross-entropy; each data rank adds its
share of the global-batch loss (its tokens' cross-entropy over the global
count of non-pad targets; the contrastive and triplet terms, on
embeddings gathered over "data", on the first data rank only), the
gradients are summed over "data", and the global norm counts each cut
leaf's blocks once over "model".
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..config import CaptionerConfig
from ..models.captioner import (
    caption_nll, contrastive_loss, head_group, local_forward, tp_cut_leaves,
)
from ..parallel.mesh import (
    all_gather_cat, axis_group, axis_rank, gather_batch, sum_replicated,
)
from .optim import (
    AdamState, adam_init, adam_update, tree_leaves, tree_unflatten,
    value_and_grad,
)


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
                   triplet_weight: float = 0.0, mesh=None,
                   contrastive_weight: float = 1.0,
                   caption_weight: float = 2.0):
    """(gradients as a tree like `params`, total loss, {"caption_ce",
    "contrastive"[, "triplet"]}) of one batch; a leaf the loss does not
    reach gets zeros. With `mesh`: this rank's blocks of leaves and batch;
    the gradients of its blocks summed over "data", the loss and its parts
    the global batch's."""
    group, data = axis_group(mesh, "model"), axis_group(mesh, "data")
    first = axis_rank(mesh, "data") == 0

    def loss(p):
        logits, img_emb, txt_emb = local_forward(p, images_u8, tokens, cfg,
                                                 group)
        nll, mask = caption_nll(logits, tokens, cfg, head_group(p, group))
        count = mask.sum()
        if data is not None:
            count = sum_replicated(count.detach(), data)
        ce = (nll * mask).sum() / torch.clamp(count, min=1.0)
        ids, valid = object_ids, sample_valid
        if data is not None:
            img_emb, txt_emb = (gather_batch(img_emb, data),
                                gather_batch(txt_emb, data))
            ids, valid = all_gather_cat(ids, data), all_gather_cat(valid,
                                                                   data)
        con = contrastive_loss(img_emb, txt_emb, p["logit_scale"])
        aux = {"caption_ce": ce, "contrastive": con}
        # the global-batch terms count once across the data ranks; the
        # other ranks weigh them 0, so that every rank's backward runs the
        # gather's collective
        total = caption_weight * ce + (contrastive_weight if first
                                       else 0.0) * con
        if triplet_weight > 0:
            tl = triplet_loss_hard(img_emb, ids, valid)
            total = total + (triplet_weight if first else 0.0) * tl
            aux = dict(aux, triplet=tl)
        return total, aux

    total, aux, grads = value_and_grad(loss, params)
    if data is not None:
        total = sum_replicated(total, data)
        aux["caption_ce"] = sum_replicated(aux["caption_ce"], data)
        grads = _sum_over(grads, data)
    return grads, total, aux


def _sum_over(tree, group):
    """Every leaf summed over `group`, in one all-reduce of the leaves
    flattened into float32."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return tree_unflatten(tree, out)


def train_step(state: TrainState, images_u8: torch.Tensor,
               tokens: torch.Tensor, object_ids: torch.Tensor,
               sample_valid: torch.Tensor, cfg: CaptionerConfig,
               lr: float = 1e-4, triplet_weight: float = 0.0, mesh=None,
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One fine-tune step on (crop, caption, object id) triples: uint8
    crops [B, H, W, 3], tokens [B, T], object ids [B], validity [B] bool.
    Returns (new state, {"caption_ce", "contrastive"[, "triplet"],
    "loss"}). The state handed in is not modified; drop it. With a
    ("data", "model") `mesh` the state's leaves are this rank's
    `shard_params` blocks and the batch its `shard_batch` block: the
    DP x TP step (the module's docstring); the state stays local."""
    grads, loss, aux = loss_and_grads(state.params, images_u8, tokens,
                                      object_ids, sample_valid, cfg,
                                      triplet_weight, mesh)
    group = axis_group(mesh, "model")
    cut = None if group is None else tp_cut_leaves(state.params, cfg, mesh)
    params, opt_state = adam_update(state.params, state.opt_state, grads,
                                    lr, MAX_GRAD_NORM,
                                    weight_decay=WEIGHT_DECAY, group=group,
                                    cut=cut)
    return TrainState(params, opt_state, state.step + 1), dict(aux,
                                                                loss=loss)
