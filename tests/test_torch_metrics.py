"""The port's caption and detection metrics (`utils/metrics.py`) against
the JAX package's, on seeded strings, embeddings and boxes: every
function gives equal floats (both are the same Python and numpy
arithmetic), empty inputs, a class with no ground truth and tied scores
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.utils import metrics as JM
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.utils import metrics as TM

WORDS = ("a", "the", "red", "blue", "brown", "couch", "bed", "tv", "plant",
         "table", "on", "in", "of", "A", "Bed,", "tv!")


def _sentences(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    out = ["", "   ", "a", "a red couch", "a red couch"]
    for _ in range(n):
        out.append(" ".join(rng.choice(WORDS, int(rng.integers(1, 9)))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_caption_scores_equal_jax(seed):
    sents = _sentences(seed)
    rng = np.random.default_rng(100 + seed)
    for i in range(len(sents)):
        cand = sents[i]
        refs = [sents[j] for j in rng.choice(len(sents), 3)]
        for max_n in (1, 2, 4):
            for smooth in (True, False):
                assert TM.bleu(cand, refs, max_n, smooth) == JM.bleu(
                    cand, refs, max_n, smooth), (cand, refs)
        assert TM.bleu(cand, []) == JM.bleu(cand, [])
        ref = refs[0]
        assert TM.meteor(cand, ref) == JM.meteor(cand, ref)
        for n in (1, 2, 3):
            assert TM.rouge_n(cand, ref, n) == JM.rouge_n(cand, ref, n)
        assert TM.rouge_l(cand, ref) == JM.rouge_l(cand, ref)
        assert TM.caption_scores(cand, ref) == JM.caption_scores(cand, ref)


@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_mean_pairwise_cosine_equals_jax(n):
    e = np.random.default_rng(n).standard_normal((n, 5)).astype(np.float32)
    if n > 2:
        e[2] = 0.0  # a zero embedding (norm floored)
    assert TM.mean_pairwise_cosine(e) == JM.mean_pairwise_cosine(e)


def _boxes(rng, n: int, size: float = 64.0) -> np.ndarray:
    xy = rng.uniform(0, size - 4, (n, 2))
    wh = rng.uniform(-2, 24, (n, 2))  # some degenerate (negative extents)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_iou_matrix_equals_jax():
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 9), _boxes(rng, 6)
    a[3] = b[2]  # an identical pair
    np.testing.assert_array_equal(TM._iou_matrix(a, b), JM._iou_matrix(a, b))
    z = np.zeros((0, 4), np.float32)
    assert TM._iou_matrix(a, z).shape == JM._iou_matrix(a, z).shape == (9, 0)


def _frames(seed: int, n_frames: int = 5, classes: int = 4):
    """Per-frame predictions and ground truth: predictions near the
    ground truth plus strays, scores rounded to 0.1 so that many tie;
    class 3 never in the ground truth; one frame with no predictions and
    one with no ground truth."""
    rng = np.random.default_rng(seed)
    pb, ps, pc, gb, gc = [], [], [], [], []
    for f in range(n_frames):
        ng = 0 if f == 1 else int(rng.integers(1, 6))
        g = _boxes(rng, ng)
        gcls = rng.integers(0, classes - 1, ng)
        near = g + rng.normal(0, 2, g.shape).astype(np.float32)
        p = np.concatenate([near, _boxes(rng, int(rng.integers(0, 4)))])
        pcls = np.concatenate([gcls, rng.integers(0, classes,
                                                  len(p) - ng)])
        if f == 2:
            p, pcls = p[:0], pcls[:0]
        pb.append(p)
        ps.append(np.round(rng.uniform(0, 1, len(p)), 1).astype(np.float32))
        pc.append(pcls.astype(np.int32))
        gb.append(g)
        gc.append(gcls.astype(np.int32))
    return pb, ps, pc, gb, gc


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("thresholds", [(0.5,), (0.5, 0.75), (0.3, 0.9)])
def test_average_precision_equals_jax(seed, thresholds):
    args = _frames(seed)
    want = JM.average_precision(*args, 4, thresholds)
    got = TM.average_precision(*args, 4, thresholds)
    assert got["map"] == want["map"]
    np.testing.assert_array_equal(got["map_per_class"],
                                  want["map_per_class"])
    assert np.isnan(got["map_per_class"][3])  # no ground truth of class 3


def test_average_precision_empty_equals_jax():
    z4, z = np.zeros((0, 4), np.float32), np.zeros(0, np.int32)
    for args in (([], [], [], [], []),
                 ([z4], [np.zeros(0, np.float32)], [z], [z4], [z])):
        got, want = (TM.average_precision(*args, 3),
                     JM.average_precision(*args, 3))
        assert got["map"] == want["map"] == 0.0
        np.testing.assert_array_equal(got["map_per_class"],
                                      want["map_per_class"])


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_detections_equals_jax(seed):
    """Padded per-frame Detections: the port's tensors against the JAX
    package's arrays (float32 boxes), invalid slots in between."""
    pb, ps, pc, gb, gc = _frames(seed)
    cap = 12

    def pad(x, fill=0):
        out = np.full((cap,) + x.shape[1:], fill, x.dtype)
        out[::2][:len(x)] = x[:len(out[::2])]
        return out

    jp, jg, tp, tg = [], [], [], []
    for b, s, c, g, k in zip(pb, ps, pc, gb, gc):
        for boxes, scores, classes, lst_j, lst_t in (
                (b, s, c, jp, tp), (g, np.ones(len(g), np.float32), k, jg,
                                    tg)):
            valid = np.zeros(cap, bool)
            valid[::2][:len(boxes)] = True
            f = dict(boxes=pad(boxes), scores=pad(scores),
                     classes=pad(classes), valid=valid,
                     logits=np.zeros((cap, 4), np.float32))
            lst_j.append(JDet(**{k2: jnp.asarray(v) for k2, v in f.items()}))
            lst_t.append(TDet(**{k2: torch.from_numpy(v)
                                 for k2, v in f.items()}))
    want = JM.evaluate_detections(jp, jg, 4)
    got = TM.evaluate_detections(tp, tg, 4)
    assert got["map"] == want["map"] and got["map"] > 0
    np.testing.assert_array_equal(got["map_per_class"],
                                  want["map_per_class"])
