"""Fixed-shape greedy non-maximum suppression.

`nms_topk` returns the indices of up to `max_out` survivors in score order
and their validity: `max_out` rounds of argmax + suppress over the whole
batch at once. Ties go to the lowest index, as `jnp.argmax` breaks them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .detections import pairwise_iou

NEG = -1e30


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float, valid: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Greedy NMS keep-mask [N] for one frame: walk boxes in score order;
    a box survives iff no surviving higher-scored box overlaps it above
    the threshold."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    key = torch.where(valid, scores.float(), float("-inf"))
    order = torch.sort(key, descending=True, stable=True).indices
    iou = pairwise_iou(boxes[order], boxes[order])
    svalid = valid[order]
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    kept = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep_i = alive[i] & svalid[i]
        kept[i] = keep_i
        suppress = keep_i & (iou[i] > iou_threshold)
        suppress[i] = False
        alive = alive & ~suppress
    out = torch.empty_like(kept)
    out[order] = kept
    return out & valid


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_out: int, valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [..., N, 4], scores [..., N] -> (indices [..., max_out] int64,
    ok [..., max_out] bool) of the greedy survivors in score order."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=boxes.device)
    iou = pairwise_iou(boxes, boxes)
    live = torch.where(valid, scores.float(), NEG)
    ar = torch.arange(n, device=boxes.device)
    idx, ok = [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=-1)
        ok.append(torch.gather(live, -1, best[..., None])[..., 0] > NEG * 0.5)
        at = best[..., None, None].expand(*best.shape, 1, n)
        row = torch.gather(iou, -2, at)[..., 0, :]
        dead = (row > iou_threshold) | (ar == best[..., None])
        live = torch.where(dead, NEG, live)
        idx.append(best)
    return torch.stack(idx, dim=-1), torch.stack(ok, dim=-1)


def class_aware_nms_topk(boxes: torch.Tensor, scores: torch.Tensor,
                         classes: torch.Tensor, iou_threshold: float,
                         max_out: int, valid: Optional[torch.Tensor] = None,
                         coord_offset: float = 1e4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS: boxes of each class are translated to a disjoint
    region so classes never suppress each other."""
    off = classes.float()[..., None] * coord_offset
    return nms_topk(boxes + off, scores, iou_threshold, max_out, valid)
