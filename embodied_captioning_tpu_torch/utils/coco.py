"""COCO-format detection tooling: padded `Detections` to COCO results
(xywh boxes), COCO annotation json to dataset samples with local class
ids (the 6 target COCO categories), and AP of COCO results against those
samples with the framework's `average_precision`. Host numpy; the
counterpart of the JAX package's `utils/coco.py`."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import COCO_CLASS_IDS, COCO_TO_LOCAL, NUM_CLASSES
from .metrics import _round_bf16, average_precision


def _host(x) -> tuple:
    """(numpy array, whether it held bf16 values): a bf16 tensor widens
    to float32 exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), True
        return x.numpy(), False
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), True
    return a, False


def detections_to_coco(detections: Sequence, image_ids: Sequence[int],
                       use_coco_ids: bool = True) -> List[Dict]:
    """Padded Detections list -> COCO results list (xywh boxes). Boxes
    that hold bf16 values give a width and height rounded to bf16, as the
    difference of two bf16 numbers is in numpy."""
    out: List[Dict] = []
    for det, img_id in zip(detections, image_ids):
        v = _host(det.valid)[0]
        boxes, bf16 = _host(det.boxes)
        classes = _host(det.classes)[0]
        scores = _host(det.scores)[0]
        for i in np.nonzero(v)[0]:
            x1, y1, x2, y2 = boxes[i]
            wh = np.asarray([x2 - x1, y2 - y1], np.float32)
            if bf16:
                wh = _round_bf16(wh)
            cat = (COCO_CLASS_IDS[int(classes[i])] if use_coco_ids
                   else int(classes[i]))
            out.append({
                "image_id": int(img_id),
                "category_id": int(cat),
                "bbox": [float(x1), float(y1), float(wh[0]), float(wh[1])],
                "score": float(scores[i]),
            })
    return out


def coco_to_samples(coco_json: str, images_root: Optional[str] = None,
                    filter_target_classes: bool = True) -> List[Dict]:
    """COCO annotation json -> list of {image_id, image_path, width,
    height, boxes, classes} dicts with local class ids, sorted by image
    id. Images without annotations are kept with empty ground truth, so
    that predictions on them count as false positives."""
    with open(coco_json) as fh:
        coco = json.load(fh)
    images = {im["id"]: im for im in coco.get("images", [])}
    per_image: Dict[int, Dict] = {}
    for ann in coco.get("annotations", []):
        cat = ann["category_id"]
        if filter_target_classes:
            if cat not in COCO_TO_LOCAL:
                continue
            cls = COCO_TO_LOCAL[cat]
        else:
            cls = cat
        rec = per_image.setdefault(ann["image_id"],
                                   {"boxes": [], "classes": []})
        x, y, w, h = ann["bbox"]
        rec["boxes"].append([x, y, x + w, y + h])
        rec["classes"].append(cls)
    for img_id in images:
        per_image.setdefault(img_id, {"boxes": [], "classes": []})
    out = []
    for img_id, rec in sorted(per_image.items()):
        im = images.get(img_id, {})
        path = im.get("file_name", "")
        if images_root and path:
            path = os.path.join(images_root, path)
        out.append({
            "image_id": img_id,
            "image_path": path,
            "width": im.get("width"),
            "height": im.get("height"),
            "boxes": np.asarray(rec["boxes"], np.float32),
            "classes": np.asarray(rec["classes"], np.int32),
        })
    return out


def evaluate_coco(results: List[Dict], gt_samples: List[Dict],
                  iou_thresholds=(0.5,)) -> Dict[str, float]:
    """AP of COCO-format results against `coco_to_samples` ground truth.
    A result's category is a target COCO id or already a local id; any
    other category is outside the targets and left out."""
    by_img: Dict[int, List[Dict]] = {}
    for r in results:
        by_img.setdefault(r["image_id"], []).append(r)
    pb, ps, pc, gb, gc = [], [], [], [], []
    for g in gt_samples:
        boxes, scores, classes = [], [], []
        for r in by_img.get(g["image_id"], []):
            cat = r["category_id"]
            if cat in COCO_TO_LOCAL:
                cls = COCO_TO_LOCAL[cat]
            elif 0 <= cat < NUM_CLASSES:
                cls = cat
            else:
                continue
            x, y, w, h = r["bbox"]
            boxes.append([x, y, x + w, y + h])
            scores.append(r["score"])
            classes.append(cls)
        pb.append(np.asarray(boxes, np.float32).reshape(-1, 4))
        ps.append(np.asarray(scores, np.float32))
        pc.append(np.asarray(classes, np.int64))
        gb.append(g["boxes"].reshape(-1, 4))
        gc.append(g["classes"])
    return average_precision(pb, ps, pc, gb, gc, NUM_CLASSES, iou_thresholds)
