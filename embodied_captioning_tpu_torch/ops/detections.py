"""Fixed-capacity detections: every per-frame field has a leading capacity
dim N (plus any batch dims) and a boolean `valid` mask."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import NUM_CLASSES

_ARRAY_FIELDS = ("boxes", "classes", "scores", "logits", "valid", "masks",
                 "embeddings", "object_ids", "episode_ids")


@dataclass
class Detections:
    """boxes [..., N, 4] XYXY pixels (bf16, as the JAX package's detector
    computes them); classes [..., N] int32 (local
    ids 0..5); scores [..., N] f32; logits [..., N, C] f32 per-class
    probabilities; valid [..., N] bool; masks [..., N, Hm, Wm];
    embeddings [..., N, D] caption embeddings; captions: host-side
    caption payload (an object array), or None."""

    boxes: torch.Tensor
    classes: torch.Tensor
    scores: torch.Tensor
    logits: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    embeddings: Optional[torch.Tensor] = None
    object_ids: Optional[torch.Tensor] = None   # [..., N] int32, -1 = none
    episode_ids: Optional[torch.Tensor] = None  # [..., N] int32
    captions: Optional[Any] = None

    @staticmethod
    def empty(capacity: int, num_classes: int = NUM_CLASSES,
              mask_size: Optional[int] = None,
              embed_dim: Optional[int] = None, device="cuda"
              ) -> "Detections":
        n, f32 = capacity, torch.float32

        def zeros(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return Detections(
            boxes=zeros(n, 4), classes=zeros(n, dtype=torch.int32),
            scores=zeros(n), logits=zeros(n, num_classes),
            valid=zeros(n, dtype=torch.bool),
            masks=zeros(n, mask_size, mask_size) if mask_size else None,
            embeddings=zeros(n, embed_dim) if embed_dim else None,
            object_ids=torch.full((n,), -1, dtype=torch.int32, device=device),
            episode_ids=torch.full((n,), -1, dtype=torch.int32,
                                   device=device),
        )

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def index(self, i: int) -> "Detections":
        """One batch row: every tensor field sliced at `i` (None fields and
        the host-side captions pass through)."""
        return self.replace(**{f: getattr(self, f)[i] for f in _ARRAY_FIELDS
                               if getattr(self, f) is not None})

    def replace(self, **kw) -> "Detections":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Detections":
        return self.replace(**{f: getattr(self, f).to(device)
                               for f in _ARRAY_FIELDS
                               if getattr(self, f) is not None})

    def to_numpy_dict(self) -> Dict[str, Any]:
        """Host-side payload of the `bbs` npz files. numpy has no bf16, so
        bf16 fields are widened to float32 (exactly)."""
        out: Dict[str, Any] = {}
        for f in _ARRAY_FIELDS:
            v = getattr(self, f)
            if v is not None:
                v = v.detach()
                if v.dtype == torch.bfloat16:
                    v = v.float()
                out[f] = v.cpu().numpy()
        if self.captions is not None:
            out["captions"] = self.captions
        return out

    @staticmethod
    def from_numpy_dict(d: Dict[str, Any], device="cuda") -> "Detections":
        """Tensors on `device` from a `to_numpy_dict` payload (of either
        package: a bfloat16 array arrives as bf16)."""

        def tensor(a):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.astype(np.float32)).to(
                    device=device, dtype=torch.bfloat16)
            return torch.from_numpy(np.array(a)).to(device)

        return Detections(**{f: tensor(d[f]) if f in d else None
                             for f in _ARRAY_FIELDS},
                          captions=d.get("captions"))


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
