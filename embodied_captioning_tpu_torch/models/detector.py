"""Instance detector, rcnn family, inference: ResNet backbone (basic or
bottleneck blocks, GroupNorm or affine norm) + FPN + RPN + ROI box and mask
heads, with fixed-size outputs (`max_detections` slots and a validity
mask).

Feature maps are NHWC; convolutions run in cuDNN on channels-last views
(the JAX package left them to XLA). Conv kernels are OIHW (the bridge
converts them once); int8 kernels keep their per-output-channel scale and
dequantize in bf16. Convs take bf16 operands, round their output to bf16,
then add the bias in float32 and round again, as the JAX `conv` does.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..config import DetectorConfig
from ..ops.detections import Detections
from ..ops.image import paste_masks, roi_align
from ..ops.nms import class_aware_nms_topk, nms_topk
from .common import dense, dense_init, randn
from .quantize import QuantizedArray

ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ANCHOR_SCALES = (2.0, 4.0, 8.0)  # x stride
NUM_ANCHORS = len(ANCHOR_RATIOS) * len(ANCHOR_SCALES)
ROI_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# conv primitives
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding (low, high) for size n, window k, stride s."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_weight(w) -> torch.Tensor:
    if isinstance(w, QuantizedArray):  # q OIHW int8, scale per O
        return w.q.to(torch.bfloat16) * w.scale.to(torch.bfloat16)[
            :, None, None, None]
    return w.to(torch.bfloat16)


def conv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC conv with "SAME" padding: bf16 in, bf16 out."""
    w = _conv_weight(p["w"])
    kh, kw = w.shape[2], w.shape[3]
    ph = _same_pads(x.shape[1], kh, stride)
    pw = _same_pads(x.shape[2], kw, stride)
    x = x.to(torch.bfloat16)
    if any(ph) or any(pw):
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride).permute(0, 2, 3, 1)
    return (y.float() + p["b"]).to(torch.bfloat16)


def groupnorm(p: dict, x: torch.Tensor, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC with float32 statistics; input dtype out."""
    n, h, w, c = x.shape
    g = min(groups, c)
    xf = x.float().reshape(n, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(1, 2, 4), keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf.reshape(n, h, w, c) * p["g"] + p["b"]).to(x.dtype)


def affine_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-channel affine (frozen-BatchNorm style)."""
    return (x.float() * p["g"] + p["b"]).to(x.dtype)


def _norm(cfg: DetectorConfig):
    return affine_norm if cfg.norm == "affine" else groupnorm


def _max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NHWC max pool with "SAME" padding by -inf."""
    ph = _same_pads(x.shape[1], k, s)
    pw = _same_pads(x.shape[2], k, s)
    x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    oh = (x.shape[1] - k) // s + 1
    ow = (x.shape[2] - k) // s + 1
    out = None
    for dy in range(k):
        for dx in range(k):
            win = x[:, dy:dy + s * (oh - 1) + 1:s, dx:dx + s * (ow - 1) + 1:s]
            out = win if out is None else torch.maximum(out, win)
    return out


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# init (shapes and scales of the JAX init_rcnn_detector)
# ---------------------------------------------------------------------------

def conv_init(g, k: int, c_in: int, c_out: int, device) -> dict:
    w = randn(g, (k, k, c_in, c_out), device, math.sqrt(2.0 / (k * k * c_in)))
    return {"w": w.permute(3, 2, 0, 1).contiguous(),
            "b": torch.zeros(c_out, device=device)}


def _gn_init(c: int, device) -> dict:
    return {"g": torch.ones(c, device=device),
            "b": torch.zeros(c, device=device)}


def init_detector(g: torch.Generator, cfg: DetectorConfig, device) -> dict:
    if cfg.family != "rcnn":
        raise ValueError("the port has the rcnn detector family only")
    w = cfg.backbone_width
    bottleneck = cfg.block == "bottleneck"
    mids = [w, 2 * w, 4 * w, 8 * w]
    widths = [m * (4 if bottleneck else 1) for m in mids]
    params = {"stem": conv_init(g, 3, 3, w, device),
              "stem_gn": _gn_init(w, device)}
    stages, c_in = [], w
    for si, depth in enumerate(cfg.backbone_depths):
        c_out, mid = widths[si], mids[si]
        blocks = []
        for bi in range(depth):
            b_in = c_in if bi == 0 else c_out
            if bottleneck:
                blocks.append({
                    "c1": conv_init(g, 1, b_in, mid, device),
                    "g1": _gn_init(mid, device),
                    "c2": conv_init(g, 3, mid, mid, device),
                    "g2": _gn_init(mid, device),
                    "c3": conv_init(g, 1, mid, c_out, device),
                    "g3": _gn_init(c_out, device),
                    "sc": (conv_init(g, 1, b_in, c_out, device)
                           if bi == 0 else None)})
            else:
                blocks.append({
                    "c1": conv_init(g, 3, b_in, c_out, device),
                    "g1": _gn_init(c_out, device),
                    "c2": conv_init(g, 3, c_out, c_out, device),
                    "g2": _gn_init(c_out, device),
                    "sc": (conv_init(g, 1, b_in, c_out, device)
                           if bi == 0 and c_in != c_out else None)})
        stages.append(blocks)
        c_in = c_out
    params["stages"] = stages
    d = cfg.fpn_dim
    fpn_widths = widths[cfg.min_level:]
    params["fpn_lat"] = [conv_init(g, 1, c, d, device) for c in fpn_widths]
    params["fpn_out"] = [conv_init(g, 3, d, d, device) for _ in fpn_widths]
    params["rpn_conv"] = conv_init(g, 3, d, d, device)
    params["rpn_obj"] = conv_init(g, 1, d, NUM_ANCHORS, device)
    params["rpn_box"] = conv_init(g, 1, d, NUM_ANCHORS * 4, device)
    roi_feat = cfg.roi_size * cfg.roi_size * d
    params["box_fc1"] = dense_init(g, roi_feat, 1024, device)
    params["box_fc2"] = dense_init(g, 1024, 1024, device)
    params["cls"] = dense_init(g, 1024, cfg.num_classes + 1, device,
                               scale=0.01)
    params["box"] = dense_init(g, 1024, 4, device, scale=0.001)
    params["proj_fc"] = dense_init(g, 1024, 512, device)
    params["proj_out"] = dense_init(g, 512, 128, device)
    params["mask_convs"] = [conv_init(g, 3, d, d, device) for _ in range(4)]
    params["mask_gns"] = [_gn_init(d, device) for _ in range(4)]
    params["mask_out"] = conv_init(g, 1, d, cfg.num_classes, device)
    return params


# ---------------------------------------------------------------------------
# backbone + FPN
# ---------------------------------------------------------------------------

def backbone_fpn(params: dict, images: torch.Tensor, cfg: DetectorConfig
                 ) -> List[torch.Tensor]:
    """float images [B, S, S, 3] in [0, 1] -> FPN levels at
    `cfg.fpn_strides`, each [B, S/s, S/s, fpn_dim] bf16."""
    if cfg.stem_s2d:
        raise ValueError("the port has the direct stem only")
    gn = _norm(cfg)
    x = torch.relu(gn(params["stem_gn"], conv(params["stem"], images, 2)))
    x = _max_pool_same(x, 3, 2)
    feats = []
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            if "c3" in blk:  # bottleneck: 1x1, 3x3 (strided), 1x1
                h = torch.relu(gn(blk["g1"], conv(blk["c1"], x)))
                h = torch.relu(gn(blk["g2"], conv(blk["c2"], h, stride)))
                h = gn(blk["g3"], conv(blk["c3"], h))
                if blk["sc"] is not None:
                    sc = conv(blk["sc"], x, stride)
                elif stride == 2:
                    sc = x[:, ::2, ::2, :]
                else:
                    sc = x
            else:  # basic: 3x3 (strided), 3x3
                h = torch.relu(gn(blk["g1"], conv(blk["c1"], x, stride)))
                h = gn(blk["g2"], conv(blk["c2"], h))
                if stride == 2 or blk["sc"] is not None:
                    sc = x if blk["sc"] is None else conv(blk["sc"], x)
                    if stride == 2:
                        sc = sc[:, ::2, ::2, :]
                else:
                    sc = x
            x = torch.relu(h + sc)
        feats.append(x)
    feats = feats[cfg.min_level:]
    lats = [conv(lp, f) for lp, f in zip(params["fpn_lat"], feats)]
    outs: List[torch.Tensor] = [None] * len(lats)
    prev = lats[-1]
    outs[-1] = conv(params["fpn_out"][-1], prev)
    for i in range(len(lats) - 2, -1, -1):
        prev = lats[i] + _up2(prev)
        outs[i] = conv(params["fpn_out"][i], prev)
    if cfg.add_p6:  # stride-64 level: max pool of window 1, stride 2
        outs.append(outs[-1][:, ::2, ::2, :])
    return outs


# ---------------------------------------------------------------------------
# anchors & box coding
# ---------------------------------------------------------------------------

def level_anchors(size: int, stride: int, device) -> torch.Tensor:
    """[Hl*Wl*A, 4] XYXY anchors for one level (3 scales x 3 ratios)."""
    hl = size // stride
    c = (torch.arange(hl, dtype=torch.float32, device=device) + 0.5) * stride
    cy, cx = torch.meshgrid(c, c, indexing="ij")
    anchors = []
    for s in ANCHOR_SCALES:
        base = s * stride
        for r in ANCHOR_RATIOS:
            w = base * math.sqrt(1.0 / r)
            h = base * math.sqrt(r)
            anchors.append(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                        cy + h / 2], dim=-1))
    return torch.stack(anchors, dim=2).reshape(-1, 4)


def all_anchors(size: int, strides: Tuple[int, ...], device) -> torch.Tensor:
    return torch.cat([level_anchors(size, s, device) for s in strides])


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor, size: int,
                 weights: Tuple[float, ...] = RPN_BOX_WEIGHTS,
                 const_anchors: bool = False) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas -> XYXY boxes clipped to the image. The
    arithmetic runs in the dtypes the JAX package gives it: bf16 deltas make
    bf16 boxes. `const_anchors`: float32 anchors standing for the JAX
    package's weakly typed anchor grid, whose widths and centres are
    computed in float32 and then take the deltas' dtype."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    if const_anchors:
        aw, ah, ax, ay = (t.to(deltas.dtype) for t in (aw, ah, ax, ay))
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw, dh = deltas[..., 2] / ww, deltas[..., 3] / wh
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(torch.clamp(dw, -4.0, 4.0))
    h = ah * torch.exp(torch.clamp(dh, -4.0, 4.0))
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    return torch.clamp(boxes, 0.0, float(size))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _rpn_head(params: dict, fpn: List[torch.Tensor]):
    objs, deltas = [], []
    for f in fpn:
        h = torch.relu(conv(params["rpn_conv"], f))
        b = h.shape[0]
        objs.append(conv(params["rpn_obj"], h).reshape(b, -1))
        deltas.append(conv(params["rpn_box"], h).reshape(b, -1, 4))
    return torch.cat(objs, dim=1), torch.cat(deltas, dim=1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, K] -> [B, K, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _propose(obj: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             cfg: DetectorConfig):
    """Per frame: exact top-k by objectness (ties to the lower index, as
    `lax.top_k`), decode, NMS -> proposals [B, P, 4] and validity."""
    k = cfg.pre_nms_topk
    order = torch.sort(obj, dim=1, descending=True, stable=True)
    scores, idx = order.values[:, :k], order.indices[:, :k]
    boxes = decode_boxes(anchors[idx], _gather_rows(deltas, idx),
                         cfg.image_size, const_anchors=True)
    keep_idx, keep_ok = nms_topk(boxes, scores, 0.7, cfg.num_proposals)
    props = _gather_rows(boxes, keep_idx)
    wh_ok = (((props[..., 2] - props[..., 0]) > 1.0)
             & ((props[..., 3] - props[..., 1]) > 1.0))
    return props, keep_ok & wh_ok


def _box_head(params: dict, feat: torch.Tensor, proposals: torch.Tensor,
              cfg: DetectorConfig):
    """ROI-align on the finest FPN level + 2-FC head -> (features, class
    logits, box deltas). feat [B, H, W, C], proposals [B, P, 4]."""
    feats = roi_align(feat, proposals, cfg.roi_size,
                      spatial_scale=1.0 / cfg.fpn_strides[0])
    x = feats.reshape(*proposals.shape[:2], -1)
    x = torch.relu(dense(params["box_fc1"], x))
    x = torch.relu(dense(params["box_fc2"], x))
    return x, dense(params["cls"], x), dense(params["box"], x)


def _mask_head(params: dict, feat: torch.Tensor, boxes: torch.Tensor,
               classes: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    """[B, N, mask_size, mask_size] mask logits of the predicted class."""
    b, n = boxes.shape[:2]
    x = roi_align(feat, boxes, cfg.mask_roi_size,
                  spatial_scale=1.0 / cfg.fpn_strides[0])
    x = x.reshape(b * n, *x.shape[2:])
    nrm = _norm(cfg)
    for cv, gp in zip(params["mask_convs"], params["mask_gns"]):
        x = torch.relu(nrm(gp, conv(cv, x)))
    logits = conv(params["mask_out"], _up2(x))  # [B*N, m, m, C]
    sel = torch.clamp(classes.reshape(-1), 0, cfg.num_classes - 1).long()
    m = torch.gather(logits, -1, sel[:, None, None, None].expand(
        *logits.shape[:3], 1))[..., 0]
    return m.reshape(b, n, *m.shape[1:])


def forward(params: dict, images: torch.Tensor, cfg: DetectorConfig
            ) -> Detections:
    """uint8 (or float on the 0..255 scale) [B, S, S, 3] -> Detections with
    `max_detections` slots per frame and ROI masks [B, N, m, m]."""
    if cfg.family != "rcnn":
        raise ValueError("the port has the rcnn detector family only")
    images = images.float() / 255.0
    fpn = backbone_fpn(params, images, cfg)
    obj, deltas = _rpn_head(params, fpn)
    anchors = all_anchors(cfg.image_size, cfg.fpn_strides, images.device)
    props, pvalid = _propose(obj, deltas, anchors, cfg)
    p2 = fpn[0]
    _, cls_logits, box_deltas = _box_head(params, p2, props, cfg)

    probs = torch.softmax(cls_logits.float(), dim=-1)
    fg = probs[..., :-1]
    scores = fg.amax(dim=-1)
    classes = torch.argmax(fg, dim=-1).to(torch.int32)
    boxes = decode_boxes(props, box_deltas, cfg.image_size, ROI_BOX_WEIGHTS)
    ok = pvalid & (scores > cfg.score_threshold)
    idx, keep = class_aware_nms_topk(boxes, scores, classes,
                                     cfg.nms_iou_threshold,
                                     cfg.max_detections, ok)
    det_boxes = _gather_rows(boxes, idx)
    det_classes = _gather_rows(classes, idx)
    det_scores = _gather_rows(scores, idx)
    det_logits = _gather_rows(fg, idx)
    # cascade-lite refinement: re-pool the selected boxes, run the shared
    # box head once more and decode; classes and scores stay from pass 1
    _, _, deltas2 = _box_head(params, p2, det_boxes, cfg)
    det_boxes = decode_boxes(det_boxes, deltas2, cfg.image_size,
                             ROI_BOX_WEIGHTS)
    masks = _mask_head(params, p2, det_boxes, det_classes, cfg)
    masks = torch.sigmoid(masks) * keep[..., None, None]
    return Detections(
        boxes=det_boxes * keep[..., None], classes=det_classes * keep,
        scores=det_scores * keep, logits=det_logits * keep[..., None],
        valid=keep, masks=masks)


def full_masks(det: Detections, size: int, src_size: int = 0
               ) -> torch.Tensor:
    """Paste ROI masks to full frame [B, N, size, size]; boxes live in
    `src_size` pixel space and are rescaled when it differs."""
    scale = size / (src_size or size)
    return paste_masks(det.masks, det.boxes * scale, size, size)
