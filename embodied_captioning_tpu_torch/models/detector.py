"""Instance detector, rcnn family: ResNet backbone (basic or bottleneck
blocks, GroupNorm or affine norm) + FPN + RPN + ROI box and mask heads,
with fixed-size outputs (`max_detections` slots and a validity mask);
the training loss (`detector_loss`, five ROI classification heads) and
the serving-prep helpers (`reinit_heads`, `fold_affine`,
`calibrate_affine`). `init_detector`, `forward` (hence `forward_tta`),
`detector_loss` and `reinit_heads` dispatch to the query family
(`models/query_detector.py`) where `cfg.family == "query"`; the rcnn-only
paths refuse it with the JAX package's messages.

Feature maps are NHWC; convolutions run in cuDNN on channels-last views
(the JAX package left them to XLA). Conv kernels are OIHW (the bridge
converts them once); int8 kernels keep their per-output-channel scale and
dequantize in bf16. Convs take bf16 operands, round their output to bf16,
then add the bias in float32 and round again, as the JAX `conv` does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import DetectorConfig
from ..ops.detections import Detections, pairwise_iou
from ..ops.geometry import reciprocal32
from ..ops.image import paste_masks, roi_align, to_float
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


def conv(p: dict, x: torch.Tensor, stride: int = 1,
         pads: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
         ) -> torch.Tensor:
    """NHWC conv with "SAME" padding (or explicit `pads`, (low, high) per
    spatial axis): bf16 in, bf16 out."""
    w = _conv_weight(p["w"])
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = pads or (_same_pads(x.shape[1], kh, stride),
                      _same_pads(x.shape[2], kw, stride))
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


def _norm(cfg: DetectorConfig, norm: Optional[Callable] = None):
    """The config's norm, or `norm` where given (calibration records its
    statistics through one)."""
    if norm is not None:
        return norm
    return affine_norm if cfg.norm == "affine" else groupnorm


def _max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NHWC max pool with "SAME" padding by -inf (the asymmetric pads are
    applied first, then a pool with none). Its gradient goes to the first
    maximum of each window in row-major order, as `lax.reduce_window`'s
    (select-and-scatter) does; a chain of `torch.maximum` would split it
    among ties, and ties are everywhere after a ReLU."""
    ph = _same_pads(x.shape[1], k, s)
    pw = _same_pads(x.shape[2], k, s)
    x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# init (shapes and scales of the JAX init_rcnn_detector)
# ---------------------------------------------------------------------------

def conv_init(g, k: int, c_in: int, c_out: int, device) -> dict:
    w = randn(g, (k, k, c_in, c_out), device, math.sqrt(2.0 / (k * k * c_in)))
    return {"w": w.permute(3, 2, 0, 1).contiguous(),
            "b": torch.zeros(c_out, device=device)}


def gn_init(c: int, device) -> dict:
    return {"g": torch.ones(c, device=device),
            "b": torch.zeros(c, device=device)}


def init_detector(g: torch.Generator, cfg: DetectorConfig, device) -> dict:
    """Random weights of the config's family, drawn from `g`: the backbone
    and FPN, then the family's heads."""
    if cfg.family == "query":
        from .query_detector import init_query_detector

        return init_query_detector(g, cfg, device)
    params = init_backbone(g, cfg, device)
    d = cfg.fpn_dim
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
    params["mask_gns"] = [gn_init(d, device) for _ in range(4)]
    params["mask_out"] = conv_init(g, 1, d, cfg.num_classes, device)
    return params


def init_backbone(g: torch.Generator, cfg: DetectorConfig, device) -> dict:
    """The stem, residual stages and FPN both families share."""
    w = cfg.backbone_width
    bottleneck = cfg.block == "bottleneck"
    mids = [w, 2 * w, 4 * w, 8 * w]
    widths = [m * (4 if bottleneck else 1) for m in mids]
    params = {"stem": conv_init(g, 3, 3, w, device),
              "stem_gn": gn_init(w, device)}
    stages, c_in = [], w
    for si, depth in enumerate(cfg.backbone_depths):
        c_out, mid = widths[si], mids[si]
        blocks = []
        for bi in range(depth):
            b_in = c_in if bi == 0 else c_out
            if bottleneck:
                blocks.append({
                    "c1": conv_init(g, 1, b_in, mid, device),
                    "g1": gn_init(mid, device),
                    "c2": conv_init(g, 3, mid, mid, device),
                    "g2": gn_init(mid, device),
                    "c3": conv_init(g, 1, mid, c_out, device),
                    "g3": gn_init(c_out, device),
                    "sc": (conv_init(g, 1, b_in, c_out, device)
                           if bi == 0 else None)})
            else:
                blocks.append({
                    "c1": conv_init(g, 3, b_in, c_out, device),
                    "g1": gn_init(c_out, device),
                    "c2": conv_init(g, 3, c_out, c_out, device),
                    "g2": gn_init(c_out, device),
                    "sc": (conv_init(g, 1, b_in, c_out, device)
                           if bi == 0 and c_in != c_out else None)})
        stages.append(blocks)
        c_in = c_out
    params["stages"] = stages
    d = cfg.fpn_dim
    fpn_widths = widths[cfg.min_level:]
    params["fpn_lat"] = [conv_init(g, 1, c, d, device) for c in fpn_widths]
    params["fpn_out"] = [conv_init(g, 3, d, d, device) for _ in fpn_widths]
    return params


# ---------------------------------------------------------------------------
# backbone + FPN
# ---------------------------------------------------------------------------

def _stem_s2d(p: dict, images: torch.Tensor) -> torch.Tensor:
    """The 3x3 stride-2 stem conv rewritten as space-to-depth(2) and a
    2x2 stride-1 conv (the JAX package's `_stem_s2d`): "SAME" padding of
    an even input at stride 2 is (0, 1), so output (i, j) reads input rows
    and columns 2i..2i+2, which the 2x2 window over depth-2 blocks i..i+1
    covers: w2[A, B, (a, b, c)] = w[2A+a, 2B+b, c] where the tap 2A+a <= 2
    exists, else zero (the weights scattered in float32, as the JAX
    package dequantizes them). The same products as the strided conv."""
    b, s, _, c = images.shape
    w = p["w"]
    w = (w.q.float() * w.scale.float()[:, None, None, None]
         if isinstance(w, QuantizedArray) else w.float())   # OIHW [o, c, 3, 3]
    cout = w.shape[0]
    w2 = w.new_zeros(cout, 2, 2, 2, 2, c)                   # [o, A, B, a, b, c]
    for ai in range(2):
        for a in range(2):
            for bi in range(2):
                for bb in range(2):
                    u, v = 2 * ai + a, 2 * bi + bb
                    if u <= 2 and v <= 2:
                        w2[:, ai, bi, a, bb] = w[:, :, u, v]
    # both sides pack the depth as (a, b, c)
    w2 = w2.reshape(cout, 2, 2, 4 * c).permute(0, 3, 1, 2)
    xs = images.reshape(b, s // 2, 2, s // 2, 2, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, s // 2, s // 2, 4 * c)
    return conv({"w": w2, "b": p["b"]}, xs, pads=((0, 1), (0, 1)))


def backbone_fpn(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                 norm: Optional[Callable] = None) -> List[torch.Tensor]:
    """float images [B, S, S, 3] in [0, 1] -> FPN levels at
    `cfg.fpn_strides`, each [B, S/s, S/s, fpn_dim] bf16. `norm(p, x)`
    replaces the config's norm at every norm site. `cfg.stem_s2d` runs
    the stem as `_stem_s2d`."""
    gn = _norm(cfg, norm)
    stem = (_stem_s2d(params["stem"], images) if cfg.stem_s2d
            else conv(params["stem"], images, 2))
    x = torch.relu(gn(params["stem_gn"], stem))
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
    # the jitted JAX program's products with the weights' reciprocals
    dx = deltas[..., 0] * reciprocal32(wx)
    dy = deltas[..., 1] * reciprocal32(wy)
    dw = deltas[..., 2] * reciprocal32(ww)
    dh = deltas[..., 3] * reciprocal32(wh)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(torch.clamp(dw, -4.0, 4.0))
    h = ah * torch.exp(torch.clamp(dh, -4.0, 4.0))
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    return torch.clamp(boxes, 0.0, float(size))


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, ...] = RPN_BOX_WEIGHTS
                 ) -> torch.Tensor:
    """XYXY boxes -> (dx, dy, dw, dh) regression targets against
    `anchors` (leading dims broadcast), widths and heights floored at
    1e-3."""
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-3)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-3)
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-3)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-3)
    bx = (boxes[..., 0] + boxes[..., 2]) / 2
    by = (boxes[..., 1] + boxes[..., 3]) / 2
    wx, wy, ww, wh = weights
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)],
                       dim=-1)


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
              cfg: DetectorConfig, dropout_rate: float = 0.0,
              keep: Optional[torch.Tensor] = None, w8a8: bool = False):
    """ROI-align on the finest FPN level + 2-FC head -> (features, class
    logits, box deltas). feat [B, H, W, C], proposals [B, P, 4]. With
    `keep` (a bool mask [B, P, 1024]), dropout after the first FC layer:
    kept units scaled by 1 / (1 - dropout_rate), the others zeroed. `w8a8`
    goes to the four products (`common.dense`)."""
    feats = roi_align(feat, proposals, cfg.roi_size,
                      spatial_scale=1.0 / cfg.fpn_strides[0])
    x = feats.reshape(*proposals.shape[:2], -1)
    x = torch.relu(dense(params["box_fc1"], x, w8a8=w8a8))
    if keep is not None and dropout_rate > 0:
        x = torch.where(keep, x * reciprocal32(1 - dropout_rate), 0.0)
    x = torch.relu(dense(params["box_fc2"], x, w8a8=w8a8))
    return (x, dense(params["cls"], x, w8a8=w8a8),
            dense(params["box"], x, w8a8=w8a8))


def _mask_head(params: dict, feat: torch.Tensor, boxes: torch.Tensor,
               classes: torch.Tensor, cfg: DetectorConfig,
               norm: Optional[Callable] = None) -> torch.Tensor:
    """[B, N, mask_size, mask_size] mask logits of the predicted class."""
    b, n = boxes.shape[:2]
    x = roi_align(feat, boxes, cfg.mask_roi_size,
                  spatial_scale=1.0 / cfg.fpn_strides[0])
    x = x.reshape(b * n, *x.shape[2:])
    nrm = _norm(cfg, norm)
    for cv, gp in zip(params["mask_convs"], params["mask_gns"]):
        x = torch.relu(nrm(gp, conv(cv, x)))
    logits = conv(params["mask_out"], _up2(x))  # [B*N, m, m, C]
    sel = torch.clamp(classes.reshape(-1), 0, cfg.num_classes - 1).long()
    m = torch.gather(logits, -1, sel[:, None, None, None].expand(
        *logits.shape[:3], 1))[..., 0]
    return m.reshape(b, n, *m.shape[1:])


class DetectorIntermediates(NamedTuple):
    proposals: torch.Tensor       # [B, P, 4]
    proposal_valid: torch.Tensor  # [B, P]
    roi_features: torch.Tensor    # [B, P, 1024]
    class_logits: torch.Tensor    # [B, P, C+1]
    box_deltas: torch.Tensor      # [B, P, 4]
    rpn_obj: torch.Tensor         # [B, A_total]
    rpn_deltas: torch.Tensor      # [B, A_total, 4]
    fpn: List[torch.Tensor]       # the FPN levels


def _intermediates(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                   gt_boxes: Optional[torch.Tensor] = None,
                   gt_valid: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   dropout_keep: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   w8a8: bool = False) -> DetectorIntermediates:
    """Backbone, RPN, proposals and the box head on float images in
    [0, 1]. Training passes `gt_boxes` [B, G, 4] (and their validity):
    they replace the last G proposals, so the head sees clean foreground.
    Proposals and their validity are constants to autograd, as the JAX
    package's `stop_gradient` makes them. With `dropout_rate` > 0 the box
    head drops units of its first layer: `dropout_keep` (bool [B, P,
    1024]) where handed in, else a draw from `generator` (jax.random and
    torch never draw the same numbers)."""
    fpn = backbone_fpn(params, images, cfg)
    obj, deltas = _rpn_head(params, fpn)
    anchors = all_anchors(cfg.image_size, cfg.fpn_strides, images.device)
    with torch.no_grad():
        props, pvalid = _propose(obj.detach(), deltas.detach(), anchors, cfg)
        if gt_boxes is not None:
            g = gt_boxes.shape[1]
            dt = torch.promote_types(props.dtype, gt_boxes.dtype)
            props = torch.cat([props[:, :-g].to(dt), gt_boxes.to(dt)], dim=1)
            gv = (gt_valid if gt_valid is not None
                  else torch.ones(gt_boxes.shape[:2], dtype=torch.bool,
                                  device=gt_boxes.device))
            pvalid = torch.cat([pvalid[:, :-g], gv.to(torch.bool)], dim=1)
    keep = None
    if dropout_rate > 0:
        keep = dropout_keep
        if keep is None:
            keep = torch.rand((*props.shape[:2], 1024), generator=generator,
                              device=images.device) < 1 - dropout_rate
    feats, cls_logits, box_deltas = _box_head(params, fpn[0], props, cfg,
                                              dropout_rate, keep, w8a8)
    return DetectorIntermediates(props, pvalid, feats, cls_logits,
                                 box_deltas, obj, deltas, fpn)


def forward(params: dict, images: torch.Tensor, cfg: DetectorConfig,
            with_masks: bool = True, w8a8: bool = False) -> Detections:
    """uint8 (or float on the 0..255 scale) [B, S, S, 3] -> Detections with
    `max_detections` slots per frame and ROI masks [B, N, m, m] (zeros
    without `with_masks`). `w8a8`: the box head's products (the query
    family's: its decoder's and heads') with int8 weights take int8
    activations (the convolutions dequantize, as the JAX package's do)."""
    if cfg.family == "query":
        from .query_detector import forward_query

        return forward_query(params, images, cfg, with_masks=with_masks,
                             w8a8=w8a8)
    inter = _intermediates(params, to_float(images), cfg, w8a8=w8a8)
    props, pvalid, p2 = inter.proposals, inter.proposal_valid, inter.fpn[0]
    cls_logits, box_deltas = inter.class_logits, inter.box_deltas

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
    _, _, deltas2 = _box_head(params, p2, det_boxes, cfg, w8a8=w8a8)
    det_boxes = decode_boxes(det_boxes, deltas2, cfg.image_size,
                             ROI_BOX_WEIGHTS)
    if with_masks:
        masks = _mask_head(params, p2, det_boxes, det_classes, cfg)
        masks = torch.sigmoid(masks) * keep[..., None, None]
    else:
        masks = torch.zeros(*keep.shape, cfg.mask_size, cfg.mask_size,
                            device=keep.device)
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


def flip_detections(det: Detections, size: float) -> Detections:
    """Mirror the detections of a horizontally flipped image back into the
    original image: x -> size - x (the ends swapped; in the boxes' dtype);
    ROI mask crops live in box-local coordinates, so they mirror along
    their own x axis. Classes, scores and logits carry no geometry."""
    b = det.boxes
    flipped = torch.stack([size - b[..., 2], b[..., 1],
                           size - b[..., 0], b[..., 3]], dim=-1)
    flipped = flipped * det.valid[..., None]
    masks = (torch.flip(det.masks, dims=[-1]) if det.masks is not None
             else None)
    return det.replace(boxes=flipped, masks=masks)


@torch.no_grad()
def forward_tta(params: dict, images: torch.Tensor, cfg: DetectorConfig,
                with_masks: bool = True) -> Detections:
    """Horizontal-flip test-time augmentation: `forward` on the frames and
    on their mirror, merged by `merge_flipped`."""
    det_a = forward(params, images, cfg, with_masks=with_masks)
    det_b = forward(params, torch.flip(images, dims=[2]), cfg,
                    with_masks=with_masks)
    return merge_flipped(det_a, det_b, cfg)


def merge_flipped(det_a: Detections, det_b: Detections,
                  cfg: DetectorConfig) -> Detections:
    """The detections of the frames (`det_a`) and of their mirror
    (`det_b`): the second mirrored back, the union (2N slots a frame)
    merged by one more round of per-class NMS; every field of a slot NMS
    drops is zeroed."""
    det_b = flip_detections(det_b, float(cfg.image_size))
    fields = ("boxes", "classes", "scores", "logits", "valid", "masks")
    cat = {f: torch.cat([getattr(det_a, f), getattr(det_b, f)], dim=1)
           for f in fields}
    idx, keep = class_aware_nms_topk(cat["boxes"], cat["scores"],
                                     cat["classes"], cfg.nms_iou_threshold,
                                     cfg.max_detections, cat["valid"])
    out = {f: _gather_rows(v, idx) for f, v in cat.items()}
    return Detections(
        boxes=out["boxes"] * keep[..., None],
        classes=out["classes"] * keep,
        scores=out["scores"] * keep,
        logits=out["logits"] * keep[..., None],
        valid=keep,
        masks=out["masks"] * keep[..., None, None])


@torch.no_grad()
def forward_mc(params: dict, images: torch.Tensor, cfg: DetectorConfig,
               samples: int = 5, dropout_rate: float = 0.5,
               generator: Optional[torch.Generator] = None,
               dropout_keep: Optional[torch.Tensor] = None):
    """MC-dropout inference: `samples` stochastic passes of the box head
    over shared proposals, dropping units of its first layer. Returns
    (proposals [B, P, 4], their validity [B, P], mean class
    probabilities [B, P, C+1], their population standard deviation).
    The masks are drawn from `generator`, or handed in as `dropout_keep`
    (bool [samples, B, P, 1024]): jax.random and torch never draw the
    same numbers."""
    if cfg.family == "query":
        raise ValueError("forward_mc supports the rcnn family only (the "
                         "reference's MC-dropout wraps its Mask R-CNN "
                         "predictor, not Mask2Former)")
    images = to_float(images)
    fpn = backbone_fpn(params, images, cfg)
    obj, deltas = _rpn_head(params, fpn)
    anchors = all_anchors(cfg.image_size, cfg.fpn_strides, images.device)
    props, pvalid = _propose(obj, deltas, anchors, cfg)
    probs = []
    for s in range(samples):
        keep = (dropout_keep[s] if dropout_keep is not None
                else torch.rand((*props.shape[:2], 1024),
                                generator=generator, device=images.device)
                < 1 - dropout_rate)
        _, cls_logits, _ = _box_head(params, fpn[0], props, cfg,
                                     dropout_rate, keep)
        probs.append(torch.softmax(cls_logits.float(), dim=-1))
    probs = torch.stack(probs)                    # [S, B, P, C+1]
    return props, pvalid, probs.mean(dim=0), probs.std(dim=0, correction=0)


# ---------------------------------------------------------------------------
# training losses
# ---------------------------------------------------------------------------

def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax * reciprocal32(beta),
                       ax - 0.5 * beta)


def _focal(probs: torch.Tensor, targets_onehot: torch.Tensor,
           gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Multi-class focal loss on probabilities (kornia's focal_loss
    semantics; the heads multiply it by 10)."""
    p = torch.clamp(probs, 1e-8, 1.0)
    w = alpha * torch.pow(1.0 - p, gamma)
    return -(targets_onehot * w * torch.log(p)).sum(dim=-1)


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x t + log1p(exp(-|x|)) in the JAX package's dtypes: the
    first and last terms in x's dtype (bf16 logits), the product in t's;
    `torch.maximum` shares the gradient of a tie at 0, as `jnp.maximum`."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.maximum(x, zero) - x * t
            + torch.log1p(torch.exp(-torch.abs(x))))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, G, ...] gathered at idx [B, K] -> [B, K, ...]."""
    return _gather_rows(x, idx.long())


def _balanced(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """0.5 (mean of v over mask a + mean of v over mask b), per frame."""
    a, b = a.float(), b.float()
    return 0.5 * ((v * a).sum(dim=1) / torch.clamp(a.sum(dim=1), min=1.0)
                  + (v * b).sum(dim=1) / torch.clamp(b.sum(dim=1), min=1.0))


def detector_loss(params: dict, images_u8: torch.Tensor, gt: Detections,
                  cfg: DetectorConfig, head: str = "ce",
                  soft_temperature: float = 2.0, soft_alpha: float = 0.5,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  dropout_keep: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint RPN + ROI-head (+ mask) loss on a batch with padded ground
    truth: gt boxes [B, G, 4], classes [B, G], valid [B, G], logits
    [B, G, C] (teacher probabilities, for the soft heads), masks
    [B, G, Hm, Wm] or None. `head` picks the ROI classification loss:
    "ce", "focal", "soft", "softfocal" or "msefocal". Returns (total, aux
    of the five parts), each the mean over the batch.

    RPN: anchors above 0.7 IoU with a ground-truth box are positive, and
    each box's best anchor too; below 0.3 negative; binary cross-entropy
    normalised over positives and negatives apart, smooth-L1 box targets
    on positives. ROI head: proposals above 0.5 IoU are foreground; the
    class loss normalised over foreground and background apart; box
    targets (weights 10, 10, 5, 5) and the mask BCE (ground-truth masks
    roi-aligned into each proposal at `mask_size`) on foreground. The query
    family's set loss where `cfg.family == "query"`."""
    if cfg.family == "query":
        from .query_detector import query_detector_loss

        return query_detector_loss(params, images_u8, gt, cfg, head=head)
    images = to_float(images_u8)
    inter = _intermediates(params, images, cfg, gt.boxes, gt.valid,
                           dropout_rate, dropout_keep, generator)
    dev = images.device
    anchors = all_anchors(cfg.image_size, cfg.fpn_strides, dev)
    gvalid = gt.valid.to(torch.bool)
    gvf = gvalid.float()[:, None, :]

    # ---- RPN ----
    iou = pairwise_iou(anchors, gt.boxes) * gvf              # [B, A, G]
    best_iou, best_gt = iou.amax(dim=2), iou.argmax(dim=2)
    pos = best_iou > 0.7
    # each ground-truth box's best anchor is positive too (a max, so two
    # boxes sharing an anchor agree: True wins)
    best_anchor = iou.argmax(dim=1)                           # [B, G]
    pos = pos.to(torch.int32).scatter_reduce(
        1, best_anchor, gvalid.to(torch.int32), "amax").to(torch.bool)
    neg = (best_iou < 0.3) & ~pos
    obj = inter.rpn_obj
    obj_loss = _balanced(_bce_with_logits(obj, pos.float()), pos, neg)
    tgt_deltas = encode_boxes(anchors, _take(gt.boxes, best_gt))
    box_w = pos.float()[..., None]
    rpn_box_loss = ((_smooth_l1(inter.rpn_deltas - tgt_deltas) * box_w)
                    .sum(dim=(1, 2))
                    / torch.clamp(box_w.sum(dim=(1, 2)) * 4, min=1.0))

    # ---- ROI head ----
    props, pvalid = inter.proposals, inter.proposal_valid
    riou = pairwise_iou(props, gt.boxes) * gvf               # [B, P, G]
    r_best, r_gt = riou.amax(dim=2), riou.argmax(dim=2)
    fg = (r_best > 0.5) & pvalid
    bg = (r_best <= 0.5) & pvalid
    nc = cfg.num_classes
    cls_t = torch.where(fg, _take(gt.classes, r_gt).long(), nc)
    logp = torch.log_softmax(inter.class_logits.float(), dim=-1)
    probs = torch.exp(logp)
    onehot = F.one_hot(cls_t, nc + 1).float()
    hard = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    if head == "ce":
        cls_loss_v = hard
    elif head == "focal":
        cls_loss_v = 10.0 * _focal(probs, onehot)
    elif head in ("soft", "softfocal", "msefocal"):
        # teacher probabilities over the classes plus a background slot,
        # softened by the temperature in log space
        gt_soft = (gt.logits if gt.logits is not None else torch.zeros(
            *gt.boxes.shape[:2], nc, device=dev))
        log_eps = torch.log(torch.tensor(1e-8, device=dev))
        soft = torch.cat([torch.log(torch.clamp(_take(gt_soft, r_gt),
                                                min=1e-8)),
                          log_eps.expand(*r_gt.shape, 1)], dim=-1)
        soft = torch.softmax(soft * reciprocal32(soft_temperature), dim=-1)
        soft = torch.where(fg[..., None], soft, onehot)
        if head == "soft":
            distill = -(soft * logp).sum(dim=-1)
            cls_loss_v = soft_alpha * distill + (1 - soft_alpha) * hard
        elif head == "softfocal":
            cls_loss_v = 10.0 * _focal(probs, soft)
        else:  # msefocal
            cls_loss_v = (torch.square(probs - soft).sum(dim=-1)
                          + 10.0 * _focal(probs, onehot))
    else:
        raise ValueError(f"unknown head {head!r}")
    cls_loss = _balanced(cls_loss_v, fg, bg)
    tgt_roi = encode_boxes(props, _take(gt.boxes, r_gt), ROI_BOX_WEIGHTS)
    fg_w = fg.float()[..., None]
    roi_box_loss = ((_smooth_l1(inter.box_deltas - tgt_roi) * fg_w)
                    .sum(dim=(1, 2))
                    / torch.clamp(fg_w.sum(dim=(1, 2)) * 4, min=1.0))

    # ---- mask head: BCE of the matched class's mask logits against the
    # ground-truth mask roi-aligned into the proposal ----
    if gt.masks is not None:
        m = cfg.mask_size
        mlogits = _mask_head(params, inter.fpn[0], props, cls_t, cfg)
        # masks may live at another resolution than the detector's pixels
        mask_scale = gt.masks.shape[-1] / cfg.image_size
        aligned = roi_align(gt.masks.float().permute(0, 2, 3, 1), props, m,
                            spatial_scale=mask_scale)         # [B,P,m,m,G]
        tgt = torch.gather(aligned, -1, r_gt[:, :, None, None, None].expand(
            *aligned.shape[:4], 1))[..., 0]
        tgt = (tgt >= 0.5).float()
        mw = fg.float()[..., None, None]
        mask_loss = ((_bce_with_logits(mlogits, tgt) * mw).sum(dim=(1, 2, 3))
                     / torch.clamp(mw.sum(dim=(1, 2, 3)) * m * m, min=1.0))
    else:
        mask_loss = torch.zeros(images.shape[0], device=dev)

    obj_l, rpnb_l, cls_l, roib_l, mask_l = (
        x.mean() for x in (obj_loss, rpn_box_loss, cls_loss, roi_box_loss,
                           mask_loss))
    total = obj_l + rpnb_l + cls_l + roib_l + mask_l
    return total, {"rpn_obj": obj_l, "rpn_box": rpnb_l, "roi_cls": cls_l,
                   "roi_box": roib_l, "mask": mask_l}


# ---------------------------------------------------------------------------
# heads for other tasks, and the serving-prep transforms
# ---------------------------------------------------------------------------

def reinit_heads(params: dict, generator: torch.Generator,
                 cfg: DetectorConfig) -> dict:
    """Fresh classification, box and mask output heads (the JAX package's
    scales; the numbers come from `generator`); every other leaf is the
    same tensor as in `params`. The query family: its class and
    mask-embedding heads."""
    if cfg.family == "query":
        from .query_detector import reinit_query_heads

        return reinit_query_heads(params, generator, cfg)
    dev = params["cls"]["w"].device
    out = dict(params)
    out["cls"] = dense_init(generator, 1024, cfg.num_classes + 1, dev,
                            scale=0.01)
    out["box"] = dense_init(generator, 1024, 4, dev, scale=0.001)
    out["mask_out"] = conv_init(generator, 1, cfg.fpn_dim, cfg.num_classes,
                                dev)
    return out


def project_features(params: dict, roi_features: torch.Tensor
                     ) -> torch.Tensor:
    """128-d contrastive projection of ROI features, L2-normalised."""
    h = torch.relu(dense(params["proj_fc"], roi_features))
    z = dense(params["proj_out"], h)
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                           min=1e-8)


def fold_affine(params: dict, cfg: DetectorConfig) -> dict:
    """For norm="affine": fold each per-channel affine norm into the conv
    before it (w' = w g per output channel, b' = b_conv g + b_norm) and
    make the norm the identity (g = 1, b = 0). Exact: the affine norm has
    no data statistics. Runs before `quantize_params`."""
    if cfg.norm != "affine":
        raise ValueError("fold_affine requires norm='affine'")
    if cfg.family == "query":
        raise ValueError("fold_affine supports the rcnn family only")

    def fold(c: dict, g: dict):
        if isinstance(c["w"], QuantizedArray):
            raise ValueError("fold_affine must run before quantize_params")
        w = c["w"].float() * g["g"][:, None, None, None]  # OIHW
        return ({"w": w, "b": c["b"] * g["g"] + g["b"]},
                {"g": torch.ones_like(g["g"]), "b": torch.zeros_like(g["b"])})

    p = dict(params)
    p["stem"], p["stem_gn"] = fold(params["stem"], params["stem_gn"])
    stages = []
    for blocks in params["stages"]:
        nb = []
        for blk in blocks:
            b2 = dict(blk)
            for ci, gi in (("c1", "g1"), ("c2", "g2"), ("c3", "g3")):
                if ci in blk:
                    b2[ci], b2[gi] = fold(blk[ci], blk[gi])
            nb.append(b2)
        stages.append(nb)
    p["stages"] = stages
    folded = [fold(c, g) for c, g in zip(params["mask_convs"],
                                         params["mask_gns"])]
    p["mask_convs"] = [c for c, _ in folded]
    p["mask_gns"] = [g for _, g in folded]
    return p


def _norm_sites(params: dict) -> List[Tuple[Any, ...]]:
    """Key paths of the norm sites in the order the forward calls them:
    the stem, each block's g1, g2 (and g3), then the mask head's four."""
    sites: List[Tuple[Any, ...]] = [("stem_gn",)]
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            sites.append(("stages", si, bi, "g1"))
            sites.append(("stages", si, bi, "g2"))
            if "c3" in blk:
                sites.append(("stages", si, bi, "g3"))
    for i in range(len(params["mask_gns"])):
        sites.append(("mask_gns", i))
    return sites


@torch.no_grad()
def calibrate_affine(params: dict, image_batches, cfg: DetectorConfig,
                     eps: float = 1e-5) -> dict:
    """GroupNorm-trained parameters -> frozen per-channel affine ones
    (frozen-BatchNorm semantics). The forward runs over the calibration
    batches (uint8 [B, S, S, 3]) with a norm that records each site's
    per-channel mean and mean square (over the batch and space; the mask
    head's per image, over its boxes, then averaged over the images);
    the moments are pooled over the batches and each site's g, b
    rewritten so that `affine_norm` reproduces GroupNorm under those
    statistics:

        scale_c = g_c / sqrt(var_group(c) + eps)
        bias_c  = b_c - g_c * mean_group(c) / sqrt(var_group(c) + eps)

    The result serves under norm="affine" and composes with
    `fold_affine` and `quantize_params`."""
    import numpy as np

    if cfg.family == "query":
        raise ValueError("calibrate_affine supports the rcnn family only")
    if cfg.norm != "gn":
        raise ValueError("calibrate_affine converts gn-trained params")
    trace: List[torch.Tensor] = []

    def rec(p: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        red = tuple(range(xf.dim() - 1))  # all but channels
        trace.append(torch.stack([xf.mean(dim=red), (xf * xf).mean(dim=red)]))
        return groupnorm(p, x)

    sites = _norm_sites(params)
    n_mask = len(params["mask_gns"])
    n_backbone = len(sites) - n_mask
    pooled, n = None, 0
    for images in image_batches:
        trace.clear()
        fpn0 = backbone_fpn(params, to_float(images), cfg, rec)[0]
        # detections from a forward that records nothing; the mask head is
        # replayed per image on the boxes and classes serving feeds it
        det = forward(params, images, cfg, with_masks=False)
        for b in range(images.shape[0]):
            _mask_head(params, fpn0[b:b + 1], det.boxes[b:b + 1],
                       det.classes[b:b + 1], cfg, rec)
        raw = [t.double().cpu().numpy() for t in trace]
        nimg = (len(raw) - n_backbone) // n_mask
        out = raw[:n_backbone] + [
            np.mean([raw[n_backbone + i * n_mask + m] for i in range(nimg)],
                    axis=0) for m in range(n_mask)]
        pooled = out if pooled is None else [a + b for a, b in zip(pooled,
                                                                   out)]
        n += 1
    pooled = [s / n for s in pooled]
    assert len(sites) == len(pooled), (len(sites), len(pooled))

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return node.clone() if isinstance(node, torch.Tensor) else node

    new_params = copy(params)
    for path, stat in zip(sites, pooled):
        site = new_params
        for k in path:
            site = site[k]
        dev = site["g"].device
        g = site["g"].double().cpu().numpy()
        b = site["b"].double().cpu().numpy()
        c = g.shape[0]
        ng = min(8, c)  # groupnorm's grouping
        mu_g = stat[0].reshape(ng, c // ng).mean(axis=1)
        var_g = stat[1].reshape(ng, c // ng).mean(axis=1) - mu_g ** 2
        inv = 1.0 / np.sqrt(np.maximum(var_g, 0.0) + eps)
        mu_c = np.repeat(mu_g, c // ng)
        inv_c = np.repeat(inv, c // ng)
        site["g"] = torch.tensor((g * inv_c).astype(np.float32), device=dev)
        site["b"] = torch.tensor((b - g * mu_c * inv_c).astype(np.float32),
                                 device=dev)
    return new_params
