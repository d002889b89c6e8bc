"""Instance detector, query family: the Mask2Former-class set predictor.

The counterpart of the JAX package's `models/query_detector.py`: learned
object queries cross-attend to pixel features through a masked-attention
transformer decoder, and each query emits one (class, mask) pair -- no
anchors, no NMS. Over the rcnn family's backbone and FPN (the pixel
decoder):

  * learned queries, per-scale level embeddings, 2D sinusoidal positions;
  * `query_layers` decoder layers cycling coarse to fine over the three
    coarsest FPN levels, each masked cross-attention (attending where the
    previous layer's mask logit, resized to the level, is > 0; a query with
    an empty mask attends everywhere) -> query self-attention -> MLP,
    pre-LN;
  * class and mask-embedding heads after every layer (deep supervision);
  * the Hungarian-matched set loss (CE + mask BCE + dice), the matching on
    the host (`ops/assignment`) in one copy a step;
  * inference: the top `max_detections` queries by class probability x
    mask confidence, boxes from the mask extents, ROI mask crops: the rcnn
    family's `Detections` contract.

The query self-attention is unmasked, so it takes the flash kernel in
serving (head dim fpn_dim / 8); every LayerNorm runs through the LayerNorm
kernel (float32 rows: the query stream is float32), and its backward under
training. The mask products (query embeddings x mask features, and the
loss's cost products over pixels) are float32 products, not TF32 ones
(PyTorch's default, which the port never changes). Under `w8a8` (the JAX
package's ECAP_W8A8) the decoder's and heads' products with int8 weights
take int8 activations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DetectorConfig
from ..ops.assignment import hungarian_batch
from ..ops.detections import Detections
from ..ops.geometry import reciprocal32
from ..ops.image import resize_bilinear, roi_align, to_float
from .common import (
    dense, dense_init, layernorm, layernorm_init, matmul_f32, mha, mha_init,
    mlp, randn, sinusoidal_positions,
)

HEADS = 8
# Mask2Former's loss weights (class 2, mask 5, dice 5; no-object 0.1)
W_CLS, W_BCE, W_DICE = 2.0, 5.0, 5.0
PAD_COST = 1e4  # the cost of a padded ground-truth column
EPS = 1e-6


def init_query_detector(g: torch.Generator, cfg: DetectorConfig,
                        device) -> dict:
    """Random weights with the shapes and scales of the JAX package's
    `init_query_detector`, drawn from `g`: the backbone and FPN as the
    rcnn family's, then the mask features, queries, level embeddings,
    decoder layers and heads."""
    from . import detector as DET

    if cfg.num_queries < cfg.max_detections:
        raise ValueError("num_queries must be >= max_detections")
    if not 0 <= cfg.query_aux_topk <= cfg.num_queries:
        raise ValueError("query_aux_topk must be in [0, num_queries]")
    if cfg.fpn_dim % HEADS:
        raise ValueError(f"fpn_dim must be divisible by {HEADS} heads")
    params = DET.init_backbone(g, cfg, device)
    d = cfg.fpn_dim
    params["mask_conv"] = DET.conv_init(g, 3, d, d, device)
    params["mask_gn"] = DET.gn_init(d, device)
    params["mask_proj"] = DET.conv_init(g, 1, d, d, device)
    params["query_embed"] = randn(g, (cfg.num_queries, d), device, 0.02)
    params["level_embed"] = randn(g, (3, d), device, 0.02)
    params["layers"] = [{
        "xattn": mha_init(g, d, None, device),
        "ln_x": layernorm_init(d, device),
        "sattn": mha_init(g, d, None, device),
        "ln_s": layernorm_init(d, device),
        "mlp": {"fc": dense_init(g, d, 4 * d, device),
                "proj": dense_init(g, 4 * d, d, device)},
        "ln_m": layernorm_init(d, device),
    } for _ in range(cfg.query_layers)]
    params["ln_out"] = layernorm_init(d, device)
    params["cls"] = dense_init(g, d, cfg.num_classes + 1, device, scale=0.01)
    params["mask_fc1"] = dense_init(g, d, d, device)
    params["mask_fc2"] = dense_init(g, d, d, device)
    return params


def reinit_query_heads(params: dict, g: torch.Generator,
                       cfg: DetectorConfig) -> dict:
    """Fresh class and mask-embedding heads (the JAX package's scales);
    every other leaf is the same tensor as in `params`."""
    dev, d = params["cls"]["b"].device, cfg.fpn_dim
    out = dict(params)
    out["cls"] = dense_init(g, d, cfg.num_classes + 1, dev, scale=0.01)
    out["mask_fc1"] = dense_init(g, d, d, dev)
    out["mask_fc2"] = dense_init(g, d, d, dev)
    return out


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _pos2d(h: int, w: int, d: int, device=None) -> torch.Tensor:
    """2D sinusoidal positions [h*w, d]: the y half, then the x half."""
    py = sinusoidal_positions(h, d // 2, device)
    px = sinusoidal_positions(w, d - d // 2, device)
    return torch.cat([py[:, None, :].expand(h, w, d // 2),
                      px[None, :, :].expand(h, w, d - d // 2)],
                     dim=-1).reshape(h * w, d)


def _predict(params: dict, q: torch.Tensor, mask_feat: torch.Tensor,
             w8a8: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Queries [B, Q, d] f32 and mask features [B, Hm, Wm, d] bf16 ->
    (class logits [B, Q, C+1] f32, mask logits [B, Q, Hm, Wm] f32). The
    mask logits are the float32 product of the bf16 mask embeddings and
    features (exact products, float32 sums)."""
    x = layernorm(params["ln_out"], q)
    cls = dense(params["cls"], x, w8a8=w8a8).float()
    e = dense(params["mask_fc2"], torch.relu(
        dense(params["mask_fc1"], x, w8a8=w8a8)), w8a8=w8a8)
    b, hm, wm, d = mask_feat.shape
    masks = matmul_f32(e, mask_feat.reshape(b, hm * wm, d).transpose(1, 2))
    return cls, masks.reshape(b, -1, hm, wm)


def _attn_mask(mask_logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Masked attention [B, 1, Q, h*w] from the previous layer's mask
    logits: attend where the logit, resized to h x w, is > 0; a query with
    no such pixel attends everywhere."""
    b, qn = mask_logits.shape[:2]
    m = mask_logits.detach().permute(0, 2, 3, 1)           # [B, Hm, Wm, Q]
    m = resize_bilinear(m, h, w)
    att = m.permute(0, 3, 1, 2).reshape(b, qn, h * w) > 0.0
    any_px = att.any(dim=-1, keepdim=True)
    return torch.where(any_px, att, True)[:, None]


def _decode(params: dict, images: torch.Tensor, cfg: DetectorConfig,
            w8a8: bool = False) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """float images [B, S, S, 3] in [0, 1] -> (class logits, mask logits)
    at every supervision point, the first before any decoder layer.
    `w8a8`: the decoder's and heads' products with int8 weights take
    int8 activations (the convolutions dequantize, as the JAX package's
    do)."""
    from . import detector as DET

    fpn = DET.backbone_fpn(params, images, cfg)
    b, d, dev = images.shape[0], cfg.fpn_dim, images.device
    mf = torch.relu(DET.groupnorm(params["mask_gn"],
                                  DET.conv(params["mask_conv"], fpn[0])))
    mask_feat = DET.conv(params["mask_proj"], mf)         # [B, Hm, Wm, d]
    tokens = []
    for i, f in enumerate(fpn[::-1][:3]):                 # coarsest first
        h, w = f.shape[1], f.shape[2]
        t = (f.reshape(b, h * w, d).float() + _pos2d(h, w, d, dev)
             + params["level_embed"][i])
        tokens.append((t.to(f.dtype), h, w))
    q = params["query_embed"][None].expand(b, -1, -1).contiguous()
    preds = [_predict(params, q, mask_feat, w8a8)]
    for li, layer in enumerate(params["layers"]):
        t, h, w = tokens[li % len(tokens)]
        att = _attn_mask(preds[-1][1], h, w)
        hx, _ = mha(layer["xattn"], layernorm(layer["ln_x"], q), HEADS,
                    kv=t, mask=att, w8a8=w8a8)
        q = q + hx
        hs, _ = mha(layer["sattn"], layernorm(layer["ln_s"], q), HEADS,
                    w8a8=w8a8)
        q = q + hs
        q = q + mlp(layer["mlp"], layernorm(layer["ln_m"], q), w8a8=w8a8)
        preds.append(_predict(params, q, mask_feat, w8a8))
    return preds


# ---------------------------------------------------------------------------
# set loss (Hungarian matching)
# ---------------------------------------------------------------------------

def _costs(cls: torch.Tensor, mlog: torch.Tensor, gt_cls: torch.Tensor,
           gt_valid: torch.Tensor, gm: torch.Tensor):
    """Per image (leading batch dims ...): cls [..., Q, C+1], mlog
    [..., Q, Hm, Wm], gt_cls [..., G], gt_valid [..., G], gm [..., G, Hm,
    Wm] in {0, 1} -> (matching cost [..., Q, G] with PAD_COST at invalid
    columns, mask BCE [..., Q, G], dice loss [..., Q, G]), the BCE and dice
    the mean per-pair losses."""
    qn, gn = cls.shape[-2], gt_cls.shape[-1]
    p = torch.sigmoid(mlog.reshape(*mlog.shape[:-2], -1))   # [..., Q, P]
    g = gm.reshape(*gm.shape[:-2], -1).float()             # [..., G, P]
    npix = p.shape[-1]
    gt = g.transpose(-1, -2)
    logp, log1p = torch.log(p + EPS), torch.log(1.0 - p + EPS)
    cost_bce = -(torch.matmul(logp, gt) + torch.matmul(log1p, 1.0 - gt)
                 ) * reciprocal32(npix)
    inter = torch.matmul(p, gt)
    cost_dice = 1.0 - (2.0 * inter + 1.0) / (
        p.sum(-1)[..., :, None] + g.sum(-1)[..., None, :] + 1.0)
    probs = torch.softmax(cls, dim=-1)
    idx = gt_cls.long()[..., None, :].expand(*cls.shape[:-1], gn)
    cost_cls = -torch.gather(probs, -1, idx)                # [..., Q, G]
    cost = W_CLS * cost_cls + W_BCE * cost_bce + W_DICE * cost_dice
    cost = torch.where(gt_valid[..., None, :], cost, PAD_COST)
    return cost, cost_bce, cost_dice


def _assign(cost: torch.Tensor, gt_valid: torch.Tensor, aux_topk: int,
            matched: Optional[np.ndarray] = None):
    """The assignment weights [..., Q, G] (1 where a query supervises a
    valid ground truth) and the query matched to each ground truth
    [..., G]. `aux_topk` 0: one-to-one Hungarian matching (`matched`, the
    solver's answer, [..., G]); k > 0: each ground truth's k lowest-cost
    queries, ties to the lower index (`lax.top_k`)."""
    qn, gn = cost.shape[-2], cost.shape[-1]
    vmask = gt_valid.float()[..., None, :]
    if aux_topk == 0:
        mq = torch.as_tensor(matched, dtype=torch.long, device=cost.device)
        w = torch.zeros(cost.shape, device=cost.device).scatter_(
            -2, mq[..., None, :], 1.0)
        return w * vmask, mq
    topq = torch.sort(-cost.detach().transpose(-1, -2), dim=-1,
                      descending=True, stable=True).indices[..., :aux_topk]
    w = torch.zeros(cost.shape[:-2] + (gn, qn), device=cost.device).scatter_(
        -1, topq, 1.0).transpose(-1, -2)
    return w * vmask, topq[..., 0]


def _loss_from(cls, cost_bce, cost_dice, w, gt_cls, no_obj_w: float,
               num_classes: int) -> torch.Tensor:
    """The per-image set loss [...] from the assignment weights `w`:
    classification CE (assigned pairs weight 1, unassigned queries
    no-object at `no_obj_w`) plus mask BCE and dice over the assigned
    pairs."""
    logprobs = torch.log_softmax(cls, dim=-1)
    unassigned = (w.sum(-1) == 0).float()                  # [..., Q]
    idx = gt_cls.long()[..., None, :].expand(*cls.shape[:-1],
                                             gt_cls.shape[-1])
    ce_pos = -(w * torch.gather(logprobs, -1, idx)).sum((-2, -1))
    ce_neg = -(logprobs[..., num_classes] * unassigned).sum(-1) * no_obj_w
    wsum = w.sum((-2, -1)) + no_obj_w * unassigned.sum(-1)
    ce = (ce_pos + ce_neg) / torch.clamp(wsum, min=1.0)
    npairs = torch.clamp(w.sum((-2, -1)), min=1.0)
    mask_loss = (w * (W_BCE * cost_bce + W_DICE * cost_dice)).sum(
        (-2, -1)) / npairs
    return W_CLS * ce + mask_loss


def match(costs: Sequence[torch.Tensor]) -> np.ndarray:
    """Hungarian matching of stacked costs [..., Q, G] (Q >= G), copied to
    the host once: the query matched to each ground truth [..., G]."""
    c = torch.stack(list(costs)).detach().float().cpu().numpy()
    lead, (qn, gn) = c.shape[:-2], c.shape[-2:]
    rows, cols = hungarian_batch(c.reshape(-1, qn, gn))
    matched = np.take_along_axis(rows, np.argsort(cols, axis=1), axis=1)
    return matched.reshape(*lead, gn)


def set_loss_one(cls, mlog, gt_cls, gt_valid, gm, no_obj_w: float,
                 num_classes: int, aux_topk: int = 0,
                 match_cost: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image, the JAX package's `_set_loss_one`: cls [Q, C+1], mlog
    [Q, Hm, Wm], gt_cls [G], gt_valid [G], gm [G, Hm, Wm] -> (loss, the
    query matched to each ground truth [G]). `match_cost` [Q, G]: the cost
    the matching reads in place of this function's own (the loss reads its
    own)."""
    cost, bce, dice = _costs(cls, mlog, gt_cls, gt_valid, gm)
    sel = cost if match_cost is None else torch.tensor(
        match_cost, device=cost.device)
    matched = match([sel])[0] if aux_topk == 0 else None
    w, mq = _assign(sel, gt_valid, aux_topk, matched)
    return _loss_from(cls, bce, dice, w, gt_cls, no_obj_w, num_classes), mq


def gt_masks(masks: torch.Tensor, hm: int, wm: int) -> torch.Tensor:
    """Ground-truth masks [B, G, S, S] -> {0, 1} float32 [B, G, Hm, Wm]
    at the mask logits' size (bilinear, then >= 0.5)."""
    m = resize_bilinear(masks.float().permute(0, 2, 3, 1), hm, wm)
    return (m >= 0.5).float().permute(0, 3, 1, 2)


def query_detector_loss(params: dict, images_u8: torch.Tensor,
                        gt: Detections, cfg: DetectorConfig,
                        head: str = "ce", **_unused
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Hungarian-matched set loss with deep supervision: the mean over
    the supervision points of the batch-mean per-image loss. The final
    point matches one to one; the others each ground truth's
    `query_aux_topk` lowest-cost queries where that is > 0. Every
    one-to-one matching of the step is solved in one host copy."""
    if head != "ce":
        raise ValueError(f"query family supports head='ce' only, got {head}")
    if gt.masks is None:
        raise ValueError("query family trains mask-supervised; gt.masks "
                         "required")
    images = to_float(images_u8)
    preds = _decode(params, images, cfg)
    gmask = gt_masks(gt.masks, *preds[0][1].shape[2:])
    last = len(preds) - 1
    ks = [cfg.query_aux_topk if li < last else 0 for li in range(len(preds))]
    parts = [_costs(cls, mlog, gt.classes, gt.valid, gmask)
             for cls, mlog in preds]
    hung = [li for li, k in enumerate(ks) if k == 0]
    matched = dict(zip(hung, match([parts[li][0] for li in hung])))
    total = 0.0
    for li, ((cls, _), (cost, bce, dice)) in enumerate(zip(preds, parts)):
        w, _ = _assign(cost, gt.valid, ks[li], matched.get(li))
        losses = _loss_from(cls, bce, dice, w, gt.classes,
                            cfg.no_object_weight, cfg.num_classes)
        total = total + losses.mean()
    total = total * reciprocal32(len(preds))
    return total, {"total": total,
                   "layers": torch.tensor(len(preds), device=images.device)}


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def _boxes_from_masks(binm: torch.Tensor) -> torch.Tensor:
    """Binary masks [..., N, H, W] -> XYXY boxes in mask-pixel space (the
    extent of the true region; an empty mask gives x2 <= x1)."""
    h, w = binm.shape[-2], binm.shape[-1]
    rows, cols = binm.any(dim=-1), binm.any(dim=-2)        # [..., N, H|W]
    ys = torch.arange(h, dtype=torch.float32, device=binm.device)
    xs = torch.arange(w, dtype=torch.float32, device=binm.device)
    y1 = torch.where(rows, ys, float(h)).amin(-1)
    y2 = torch.where(rows, ys + 1.0, 0.0).amax(-1)
    x1 = torch.where(cols, xs, float(w)).amin(-1)
    x2 = torch.where(cols, xs + 1.0, 0.0).amax(-1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def finalize(cls: torch.Tensor, mlog: torch.Tensor, cfg: DetectorConfig,
             with_masks: bool = True) -> Detections:
    """Last-layer (class logits [B, Q, C+1], mask logits [B, Q, Hm, Wm]) ->
    `Detections`: the top `max_detections` queries by class probability x
    mean mask probability over the mask (> 0.5), ties to the lower query;
    boxes from the masks' extents scaled to the image; `mask_size` ROI
    crops of each query's own mask probabilities (ROIAlign, one sample a
    bin)."""
    n = cfg.max_detections
    hm = mlog.shape[-2]
    probs = torch.softmax(cls, dim=-1)[..., :-1]           # [B, Q, C]
    cls_score = probs.amax(dim=-1)
    classes = torch.argmax(probs, dim=-1).to(torch.int32)
    p = torch.sigmoid(mlog)
    binm = p > 0.5
    area = binm.sum((-2, -1)).float()
    conf = torch.where(area > 0, (p * binm).sum((-2, -1))
                       / torch.clamp(area, min=1.0), 0.0)
    score = cls_score * conf
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., :n], idx[..., :n]

    def take(x: torch.Tensor) -> torch.Tensor:
        ix = idx.reshape(*idx.shape, *([1] * (x.dim() - idx.dim())))
        return torch.gather(x, 1, ix.expand(*idx.shape, *x.shape[2:]))

    boxes_m = _boxes_from_masks(take(binm))                 # [B, N, 4]
    nonempty = boxes_m[..., 2] > boxes_m[..., 0]
    keep = (top > cfg.score_threshold) & nonempty
    boxes = boxes_m * (cfg.image_size / hm)
    if with_masks:
        feat = take(p)[..., None]                           # [B, N, Hm, Wm, 1]
        crops = roi_align(feat, boxes_m[..., None, :], cfg.mask_size,
                          sampling_ratio=1)                 # [B, N, 1, m, m, 1]
        masks = torch.clamp(crops[:, :, 0, ..., 0], 0.0, 1.0
                            ) * keep[..., None, None]
    else:
        masks = torch.zeros(*keep.shape, cfg.mask_size, cfg.mask_size,
                            device=keep.device)
    return Detections(
        boxes=boxes * keep[..., None], classes=take(classes) * keep,
        scores=top * keep, logits=take(probs) * keep[..., None],
        valid=keep, masks=masks)


@torch.no_grad()
def forward_query(params: dict, images_u8: torch.Tensor, cfg: DetectorConfig,
                  with_masks: bool = True, w8a8: bool = False) -> Detections:
    """uint8 (or float on the 0..255 scale) [B, S, S, 3] -> `Detections`
    with `max_detections` slots a frame (`finalize` of the last layer).
    `w8a8` as in `_decode`."""
    cls, mlog = _decode(params, to_float(images_u8), cfg, w8a8)[-1]
    return finalize(cls, mlog, cfg, with_masks)
