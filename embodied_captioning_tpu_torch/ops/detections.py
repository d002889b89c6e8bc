"""Fixed-capacity detections: every per-frame field has a leading capacity
dim N (plus any batch dims) and a boolean `valid` mask."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Detections:
    """boxes [..., N, 4] XYXY pixels (bf16, as the JAX package's detector
    computes them); classes [..., N] int32 (local
    ids 0..5); scores [..., N] f32; logits [..., N, C] f32 per-class
    probabilities; valid [..., N] bool; masks [..., N, Hm, Wm];
    embeddings [..., N, D] caption embeddings."""

    boxes: torch.Tensor
    classes: torch.Tensor
    scores: torch.Tensor
    logits: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    embeddings: Optional[torch.Tensor] = None
    object_ids: Optional[torch.Tensor] = None   # [..., N] int32, -1 = none
    episode_ids: Optional[torch.Tensor] = None  # [..., N] int32

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def replace(self, **kw) -> "Detections":
        return dataclasses.replace(self, **kw)


def boxes_from_masks(masks: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """XYXY float32 boxes from [N, H, W] {0,1} masks: per-mask row and
    column extents; zeros for empty or invalid masks."""
    n, h, w = masks.shape
    on = masks > 0.5
    cols = on.any(dim=1)  # [N, W]
    rows = on.any(dim=2)  # [N, H]
    xs = torch.arange(w, device=masks.device)[None, :]
    ys = torch.arange(h, device=masks.device)[None, :]
    big = 1 << 30
    x1 = torch.where(cols, xs, big).amin(dim=1)
    x2 = torch.where(cols, xs, -1).amax(dim=1) + 1
    y1 = torch.where(rows, ys, big).amin(dim=1)
    y2 = torch.where(rows, ys, -1).amax(dim=1) + 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).float()
    any_on = on.any(dim=2).any(dim=1) & valid
    return torch.where(any_on[:, None], boxes, 0.0)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                 ) -> torch.Tensor:
    """IoU matrix [..., A, B] between XYXY boxes [..., A, 4], [..., B, 4]
    (in the boxes' dtype)."""
    area_a = (torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0)
              * torch.clamp(boxes_a[..., 3] - boxes_a[..., 1], min=0))
    area_b = (torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0)
              * torch.clamp(boxes_b[..., 3] - boxes_b[..., 1], min=0))
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def expand_boxes(boxes: torch.Tensor, ratio: float, height: int,
                 width: int) -> torch.Tensor:
    """Expand XYXY boxes by `ratio` of their size on each side, clamped to
    the image. `ratio` takes the boxes' dtype first (JAX weak typing)."""
    ratio = torch.tensor(ratio, dtype=boxes.dtype, device=boxes.device)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    x1 = torch.clamp(boxes[..., 0] - ratio * w, 0, width - 1)
    y1 = torch.clamp(boxes[..., 1] - ratio * h, 0, height - 1)
    x2 = torch.clamp(boxes[..., 2] + ratio * w, 0, width)
    y2 = torch.clamp(boxes[..., 3] + ratio * h, 0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)
