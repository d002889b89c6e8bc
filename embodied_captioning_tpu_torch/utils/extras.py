"""Small host utilities: a detection confusion matrix, a depth noise model
and viewpoint sampling around an object. Numpy; the counterpart of the
JAX package's `utils/extras.py`."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..config import NUM_CLASSES
from .metrics import _iou_matrix


class ConfusionMatrix:
    """Detection confusion matrix with an extra background row and column
    (the last index): rows are ground-truth classes, columns predicted."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 iou_threshold: float = 0.5):
        self.n = num_classes
        self.iou_threshold = iou_threshold
        self.matrix = np.zeros((num_classes + 1, num_classes + 1), np.int64)

    def update(self, pred_boxes: np.ndarray, pred_classes: np.ndarray,
               gt_boxes: np.ndarray, gt_classes: np.ndarray) -> None:
        """Each ground-truth box takes its best-IoU prediction if that
        reaches the threshold and is not taken yet, else counts as missed;
        predictions left over count as false positives."""
        bg = self.n
        if len(gt_boxes) == 0:
            for c in pred_classes:
                self.matrix[bg, int(c)] += 1
            return
        if len(pred_boxes) == 0:
            for c in gt_classes:
                self.matrix[int(c), bg] += 1
            return
        iou = _iou_matrix(np.asarray(gt_boxes), np.asarray(pred_boxes))
        matched_pred = set()
        for gi in range(len(gt_boxes)):
            pi = int(np.argmax(iou[gi]))
            if iou[gi, pi] >= self.iou_threshold and pi not in matched_pred:
                matched_pred.add(pi)
                self.matrix[int(gt_classes[gi]), int(pred_classes[pi])] += 1
            else:
                self.matrix[int(gt_classes[gi]), bg] += 1
        for pi in range(len(pred_boxes)):
            if pi not in matched_pred:
                self.matrix[bg, int(pred_classes[pi])] += 1

    def normalized(self) -> np.ndarray:
        s = self.matrix.sum(axis=1, keepdims=True)
        return self.matrix / np.maximum(s, 1)

    def summary(self) -> Dict[str, float]:
        diag = np.diag(self.matrix)[: self.n].sum()
        total = self.matrix[: self.n].sum()
        return {"accuracy": float(diag / max(total, 1))}


def redwood_depth_noise(depth: np.ndarray, rng: np.random.Generator,
                        noise_multiplier: float = 1.0) -> np.ndarray:
    """Depth-dependent Gaussian noise and dropout (a simplified Redwood
    model): sigma grows quadratically with distance, far pixels drop out
    to 0. Draws the noise, then the dropout, from `rng`."""
    d = np.asarray(depth, np.float32)
    sigma = noise_multiplier * (0.0012 + 0.0019 * (d - 0.4) ** 2)
    noisy = d + rng.normal(0, 1, d.shape).astype(np.float32) * sigma
    dropout = rng.random(d.shape) < 0.004 * noise_multiplier * d
    return np.where(dropout, 0.0, noisy).astype(np.float32)


def sample_object_viewpoints(traversability: np.ndarray, resolution: float,
                             object_center_xz: Tuple[float, float],
                             radius_range: Tuple[float, float] = (1.0, 2.5),
                             num_viewpoints: int = 8,
                             ) -> List[Tuple[float, float, float]]:
    """Reachable viewpoints on a ring around an object, facing it: for
    each of 4 x `num_viewpoints` angles the nearest of 4 radii whose cell
    is traversable. Returns [(x, z, yaw facing the object)]."""
    cx, cz = object_center_xz
    out: List[Tuple[float, float, float]] = []
    h, w = traversability.shape
    for k in range(num_viewpoints * 4):
        ang = 2 * np.pi * k / (num_viewpoints * 4)
        for r in np.linspace(radius_range[0], radius_range[1], 4):
            x = cx + r * np.cos(ang)
            z = cz + r * np.sin(ang)
            col = int(x / resolution)
            row = int(z / resolution)
            if 0 <= row < h and 0 <= col < w and traversability[row, col]:
                yaw = float(np.arctan2(-(cx - x), -(cz - z)))
                out.append((float(x), float(z), yaw))
                break
        if len(out) >= num_viewpoints:
            break
    return out
