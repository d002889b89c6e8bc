"""The port's `utils/coco.py` and `utils/extras.py` against the JAX
package's on the same seeded inputs: COCO results, samples and AP equal,
confusion matrices equal (empty cases included), depth noise equal bit
for bit from the same generator seed, viewpoints equal."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.utils import coco as JC
from embodied_captioning_tpu.utils import extras as JE
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.utils import coco as TC
from embodied_captioning_tpu_torch.utils import extras as TE


def _random_boxes(rng, n, size=64.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(1.0, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    """Per image: padded detections (8 slots, some invalid) with boxes near
    the ground truth, the ground truth and a COCO annotation file's
    content; image 3 has no annotation, image 4 only an off-target one."""
    rng = np.random.default_rng(19)
    out = []
    for img_id in range(5):
        gt = _random_boxes(rng, 3)
        gt_cls = rng.integers(0, 6, 3)
        boxes = np.concatenate([gt + rng.normal(0, 1.5, gt.shape),
                                _random_boxes(rng, 5)]).astype(np.float32)
        classes = np.concatenate([gt_cls, rng.integers(0, 6, 5)])
        scores = rng.uniform(0.05, 1.0, 8).astype(np.float32)
        valid = rng.random(8) < 0.8
        out.append(dict(id=100 + img_id, gt=gt, gt_cls=gt_cls, boxes=boxes,
                        classes=classes.astype(np.int32), scores=scores,
                        valid=valid))
    return out


def _dets(fr, bf16):
    jb = jnp.asarray(fr["boxes"], jnp.bfloat16 if bf16 else jnp.float32)
    tb = torch.from_numpy(fr["boxes"]).to(
        torch.bfloat16 if bf16 else torch.float32)
    j = JDet.empty(8).replace(
        boxes=jb, classes=jnp.asarray(fr["classes"]),
        scores=jnp.asarray(fr["scores"]), valid=jnp.asarray(fr["valid"]))
    t = TDet.empty(8, device="cpu").replace(
        boxes=tb, classes=torch.from_numpy(fr["classes"]),
        scores=torch.from_numpy(fr["scores"]),
        valid=torch.from_numpy(fr["valid"]))
    return j, t


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("coco_ids", [True, False], ids=["coco", "local"])
def test_detections_to_coco_equal_json(frames, bf16, coco_ids):
    js, ts = zip(*(_dets(f, bf16) for f in frames))
    ids = [f["id"] for f in frames]
    want = JC.detections_to_coco(js, ids, use_coco_ids=coco_ids)
    got = TC.detections_to_coco(ts, ids, use_coco_ids=coco_ids)
    assert len(want) > 10
    assert json.dumps(got) == json.dumps(want)


def _annotation_file(frames, tmp_path):
    coco = {"images": [], "annotations": []}
    for f in frames:
        coco["images"].append({"id": f["id"], "file_name": f"{f['id']}.png",
                               "width": 64, "height": 64})
        if f["id"] == 103:
            continue   # an image without annotations
        if f["id"] == 104:
            coco["annotations"].append({"image_id": f["id"],
                                        "category_id": 1,
                                        "bbox": [0, 0, 5, 5]})
            continue
        for b, c in zip(f["gt"], f["gt_cls"]):
            x1, y1, x2, y2 = (float(v) for v in b)
            coco["annotations"].append({
                "image_id": f["id"], "category_id": 57 + int(c),
                "bbox": [x1, y1, x2 - x1, y2 - y1]})
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(coco))
    return str(path)


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


@pytest.mark.parametrize("filtered", [True, False], ids=["targets", "all"])
def test_coco_to_samples_equal(frames, tmp_path, filtered):
    path = _annotation_file(frames, tmp_path)
    want = JC.coco_to_samples(path, images_root="/data",
                              filter_target_classes=filtered)
    got = TC.coco_to_samples(path, images_root="/data",
                             filter_target_classes=filtered)
    _same_samples(got, want)
    # the image without annotations is kept, with empty ground truth
    empty = [s for s in got if s["image_id"] == 103]
    assert len(empty) == 1 and empty[0]["boxes"].shape == (0,)


@pytest.mark.parametrize("thresholds", [(0.5,), (0.5, 0.75)],
                         ids=["ap50", "ap50_75"])
def test_evaluate_coco_equal_ap(frames, tmp_path, thresholds):
    path = _annotation_file(frames, tmp_path)
    gt = JC.coco_to_samples(path)
    js, ts = zip(*(_dets(f, False) for f in frames))
    ids = [f["id"] for f in frames]
    results = JC.detections_to_coco(js, ids)
    # an off-target category and a local id ride along
    results += [dict(results[0], category_id=1),
                dict(results[1], category_id=2)]
    want = JC.evaluate_coco(results, gt, thresholds)
    got = TC.evaluate_coco(TC.detections_to_coco(ts, ids) + results[-2:],
                           TC.coco_to_samples(path), thresholds)
    assert 0.0 < want["map"] < 1.0
    assert got["map"] == want["map"]
    np.testing.assert_array_equal(np.asarray(got["map_per_class"]),
                                  np.asarray(want["map_per_class"]))


@pytest.mark.parametrize("case", ["matched", "no_gt", "no_pred", "both_empty"])
def test_confusion_matrix_equal(frames, case):
    jm, tm = JE.ConfusionMatrix(), TE.ConfusionMatrix(iou_threshold=0.5)
    for f in frames:
        pb, pc = f["boxes"][f["valid"]], f["classes"][f["valid"]]
        gb, gc = f["gt"], f["gt_cls"]
        if case in ("no_gt", "both_empty"):
            gb, gc = np.zeros((0, 4), np.float32), np.zeros(0, np.int64)
        if case in ("no_pred", "both_empty"):
            pb, pc = np.zeros((0, 4), np.float32), np.zeros(0, np.int64)
        jm.update(pb, pc, gb, gc)
        tm.update(pb, pc, gb, gc)
    np.testing.assert_array_equal(tm.matrix, jm.matrix)
    np.testing.assert_array_equal(tm.normalized(), jm.normalized())
    assert tm.summary() == jm.summary()
    if case == "matched":
        assert np.trace(tm.matrix[:-1, :-1]) > 0


@pytest.mark.parametrize("mult", [0.5, 1.0, 3.0])
def test_redwood_depth_noise_equal_bits(mult):
    depth = np.random.default_rng(7).uniform(0.2, 9.0, (48, 64)).astype(
        np.float32)
    want = JE.redwood_depth_noise(depth, np.random.default_rng(11), mult)
    got = TE.redwood_depth_noise(depth, np.random.default_rng(11), mult)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got == 0).any() and (got != depth).any()


@pytest.mark.parametrize("n,radii", [(6, (1.0, 2.0)), (8, (0.5, 3.0)),
                                     (12, (1.0, 2.5))])
def test_sample_object_viewpoints_equal(n, radii):
    rng = np.random.default_rng(n)
    trav = (rng.random((60, 60)) < 0.7).astype(np.uint8)
    trav[25:35, 25:35] = 0
    want = JE.sample_object_viewpoints(trav, 0.1, (3.0, 3.0), radii, n)
    got = TE.sample_object_viewpoints(trav, 0.1, (3.0, 3.0), radii, n)
    assert len(want) > 0
    assert got == want
