"""Caption and detection quality metrics: the port's copy of the JAX
package's `utils/metrics.py`, function for function (pure Python and
numpy, so the two give equal floats on equal inputs).

- BLEU with adaptive n-gram order for short references and +1 smoothing
  on the higher orders;
- METEOR-lite: exact-match unigram alignment, F-mean (alpha 0.9) with a
  fragmentation penalty;
- ROUGE-1/2/L F1;
- mean pairwise cosine of embeddings (multi-view consistency);
- COCO-style detection AP (101-point interpolation) over padded
  `Detections`.

bf16 boxes are scored as the JAX package's numpy (ml_dtypes) scores
them: `evaluate_detections` widens them to float32 (exactly) and notes
that they were bf16, and `_iou_matrix` rounds each coordinate difference
of two bf16 operands to bf16, where numpy's dtypes stay bf16.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _tokens(text: str) -> List[str]:
    return [t for t in "".join(c.lower() if c.isalnum() else " "
                               for c in text).split() if t]


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def bleu(candidate: str, references: Sequence[str],
         max_n: int = 4, smooth: bool = True) -> float:
    """Sentence BLEU with adaptive max order (ref adapts weights for short
    captions) and add-1 smoothing on higher orders."""
    cand = _tokens(candidate)
    refs = [_tokens(r) for r in references]
    if not cand or not refs or not any(refs):
        return 0.0
    n_max = max(1, min(max_n, len(cand),
                       max(len(r) for r in refs)))
    logs = []
    for n in range(1, n_max + 1):
        c_ng = _ngrams(cand, n)
        if not c_ng:
            logs.append(np.log(1e-9))
            continue
        max_ref = Counter()
        for r in refs:
            for g, cnt in _ngrams(r, n).items():
                max_ref[g] = max(max_ref[g], cnt)
        clipped = sum(min(cnt, max_ref[g]) for g, cnt in c_ng.items())
        total = sum(c_ng.values())
        if smooth and n > 1:
            clipped += 1
            total += 1
        logs.append(np.log(max(clipped, 1e-9) / total))
    prec = np.exp(np.mean(logs))
    ref_len = min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
    bp = 1.0 if len(cand) >= ref_len else np.exp(1 - ref_len /
                                                 max(len(cand), 1))
    return float(bp * prec)


# ---------------------------------------------------------------------------
# METEOR-lite
# ---------------------------------------------------------------------------

def meteor(candidate: str, reference: str, alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5) -> float:
    """Exact-match METEOR: unigram precision/recall F-mean weighted toward
    recall, times a chunk-fragmentation penalty."""
    c = _tokens(candidate)
    r = _tokens(reference)
    if not c or not r:
        return 0.0
    # greedy one-to-one alignment preserving order for chunk counting
    used = [False] * len(r)
    align = []  # (cand_idx, ref_idx)
    for i, tok in enumerate(c):
        for j, rt in enumerate(r):
            if not used[j] and rt == tok:
                used[j] = True
                align.append((i, j))
                break
    m = len(align)
    if m == 0:
        return 0.0
    p = m / len(c)
    q = m / len(r)
    fmean = p * q / (alpha * p + (1 - alpha) * q)
    # chunks: maximal runs contiguous in both
    chunks = 1
    for (i0, j0), (i1, j1) in zip(align, align[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return float(fmean * (1 - penalty))


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------

def _f1(match: float, c_total: float, r_total: float) -> float:
    if match == 0:
        return 0.0
    p = match / c_total
    r = match / r_total
    return 2 * p * r / (p + r)


def rouge_n(candidate: str, reference: str, n: int = 1) -> float:
    c = _ngrams(_tokens(candidate), n)
    r = _ngrams(_tokens(reference), n)
    if not c or not r:
        return 0.0
    match = sum(min(cnt, r[g]) for g, cnt in c.items())
    return _f1(match, sum(c.values()), sum(r.values()))


def rouge_l(candidate: str, reference: str) -> float:
    c = _tokens(candidate)
    r = _tokens(reference)
    if not c or not r:
        return 0.0
    # LCS dynamic program
    dp = np.zeros((len(c) + 1, len(r) + 1), np.int32)
    for i, ct in enumerate(c):
        for j, rt in enumerate(r):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if ct == rt
                                else max(dp[i, j + 1], dp[i + 1, j]))
    lcs = int(dp[-1, -1])
    return _f1(lcs, len(c), len(r))


def caption_scores(candidate: str, reference: str) -> Dict[str, float]:
    """The full per-pair score row (ref: compute_performance_measures.py
    emits BLEU/METEOR/ROUGE-1/2/L per caption)."""
    return {
        "bleu": bleu(candidate, [reference]),
        "meteor": meteor(candidate, reference),
        "rouge1": rouge_n(candidate, reference, 1),
        "rouge2": rouge_n(candidate, reference, 2),
        "rougeL": rouge_l(candidate, reference),
    }


# ---------------------------------------------------------------------------
# embedding consistency
# ---------------------------------------------------------------------------

def mean_pairwise_cosine(embeddings: np.ndarray) -> float:
    """Mean pairwise cosine *similarity* over a set of embeddings, diagonal
    included (ref: compute_cosine_sim.py:11-22 — note the consistency score
    is similarity; the map's disagreement is 1 - this)."""
    e = np.asarray(embeddings, np.float64)
    if len(e) == 0:
        return 0.0
    if len(e) == 1:
        return 1.0
    n = np.linalg.norm(e, axis=1, keepdims=True)
    n = np.maximum(n, 1e-9)
    sim = (e / n) @ (e / n).T
    return float(sim.mean())


# ---------------------------------------------------------------------------
# detection AP
# ---------------------------------------------------------------------------

def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _iou_matrix(a: np.ndarray, b: np.ndarray, a_bf16: bool = False,
                b_bf16: bool = False) -> np.ndarray:
    """IoU of XYXY boxes a [A, 4] and b [B, 4] in the dtypes of the JAX
    package's numpy where a or b held bf16 values (`a_bf16`, `b_bf16`):
    the difference of two bf16 operands rounds to bf16 (ml_dtypes, as
    torch, computes it in float32 and rounds); `np.maximum(bf16, 0)`, and
    anything with a float32 operand, is float32."""
    def diff(x, y, bf16):
        return _round_bf16(x - y) if bf16 else x - y

    area_a = (np.maximum(diff(a[:, 2], a[:, 0], a_bf16), 0)
              * np.maximum(diff(a[:, 3], a[:, 1], a_bf16), 0))
    area_b = (np.maximum(diff(b[:, 2], b[:, 0], b_bf16), 0)
              * np.maximum(diff(b[:, 3], b[:, 1], b_bf16), 0))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(diff(rb, lt, a_bf16 and b_bf16), 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(pred_boxes: List[np.ndarray],
                      pred_scores: List[np.ndarray],
                      pred_classes: List[np.ndarray],
                      gt_boxes: List[np.ndarray],
                      gt_classes: List[np.ndarray],
                      num_classes: int,
                      iou_thresholds: Sequence[float] = (0.5,),
                      pred_bf16: bool = False, gt_bf16: bool = False,
                      ) -> Dict[str, float]:
    """COCO-style AP, 101-point interpolation, averaged over classes and
    IoU thresholds. Returns {"map": ..., "map_per_class": [...]} — parity
    axis with torchmetrics MAP(class_metrics=True)
    (ref: pipelines.py:372,519-545). `pred_bf16`, `gt_bf16`: the boxes
    held bf16 values (see `_iou_matrix`)."""
    aps = np.zeros((len(iou_thresholds), num_classes))
    valid_cls = np.zeros(num_classes, bool)
    for ti, thr in enumerate(iou_thresholds):
        for cls in range(num_classes):
            scores_all, tp_all = [], []
            n_gt = 0
            for pb, ps, pc, gb, gc in zip(pred_boxes, pred_scores,
                                          pred_classes, gt_boxes, gt_classes):
                sel_p = pc == cls
                sel_g = gc == cls
                n_gt += int(sel_g.sum())
                if sel_p.sum() == 0:
                    continue
                order = np.argsort(-ps[sel_p])
                boxes_p = pb[sel_p][order]
                iou = (_iou_matrix(boxes_p, gb[sel_g], pred_bf16, gt_bf16)
                       if sel_g.sum() else np.zeros((len(boxes_p), 0)))
                taken = np.zeros(iou.shape[1], bool)
                for bi in range(len(boxes_p)):
                    scores_all.append(ps[sel_p][order][bi])
                    if iou.shape[1] == 0:
                        tp_all.append(0)
                        continue
                    j = int(np.argmax(np.where(taken, -1.0, iou[bi])))
                    if iou[bi, j] >= thr and not taken[j]:
                        taken[j] = True
                        tp_all.append(1)
                    else:
                        tp_all.append(0)
            if n_gt == 0:
                continue
            valid_cls[cls] = True
            if not scores_all:
                aps[ti, cls] = 0.0
                continue
            order = np.argsort(-np.asarray(scores_all))
            tp = np.asarray(tp_all)[order]
            cum_tp = np.cumsum(tp)
            recall = cum_tp / n_gt
            precision = cum_tp / (np.arange(len(tp)) + 1)
            # 101-point interpolation
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                p = precision[recall >= r].max() if (recall >= r).any() else 0
                ap += p / 101
            aps[ti, cls] = ap
    per_class = aps.mean(axis=0)
    mask = valid_cls
    return {
        "map": float(per_class[mask].mean()) if mask.any() else 0.0,
        "map_per_class": [float(x) if m else float("nan")
                          for x, m in zip(per_class, mask)],
    }


def _host(t) -> Tuple[np.ndarray, bool]:
    """A tensor or array as numpy (bf16 widened to float32, exactly) and
    whether it was bf16."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), True
        return t.numpy(), False
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), True
    return a, False


def evaluate_detections(preds, gts, num_classes: int,
                        iou_thresholds=(0.5,)) -> Dict[str, float]:
    """`average_precision` over lists of padded `Detections` (one frame
    each, tensors on any device); bf16 boxes are scored as the JAX
    package's numpy scores them (see `_iou_matrix`)."""
    def unpack(d):
        v = _host(d.valid)[0].astype(bool)
        boxes, bf16 = _host(d.boxes)
        return (boxes[v], _host(d.scores)[0][v], _host(d.classes)[0][v],
                bf16)

    pb, ps, pc, gb, gc = [], [], [], [], []
    pred_bf16 = gt_bf16 = False
    for p, g in zip(preds, gts):
        b, s, c, bf16 = unpack(p)
        pb.append(b)
        ps.append(s)
        pc.append(c)
        pred_bf16 |= bf16
        b2, _, c2, bf16 = unpack(g)
        gb.append(b2)
        gc.append(c2)
        gt_bf16 |= bf16
    return average_precision(pb, ps, pc, gb, gc, num_classes, iou_thresholds,
                             pred_bf16, gt_bf16)
