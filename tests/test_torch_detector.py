"""The port's detector and image/box ops against the JAX package's (tiny
preset, CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JDetCfg
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.ops import detections as JDT
from embodied_captioning_tpu.ops import image as JI
from embodied_captioning_tpu.ops import nms as JN
from embodied_captioning_tpu_torch.config import DetectorConfig as TDetCfg
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.ops import detections as TDT
from embodied_captioning_tpu_torch.ops import image as TI
from embodied_captioning_tpu_torch.ops import nms as TN
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import np32, t


def _boxes(rng, n, size, dtype=jnp.float32):
    xy = rng.random((n, 2)) * size * 0.7
    wh = rng.random((n, 2)) * size * 0.5 + 2
    return jnp.asarray(np.concatenate([xy, xy + wh], 1), dtype)


# the tiny preset (basic blocks, GroupNorm, P2-P5), and the serving
# artifact's structure at tiny widths (bottleneck blocks, P3-P6)
VARIANTS = {
    "tiny": {},
    "bottleneck_p6": dict(block="bottleneck", min_level=1, add_p6=True,
                          backbone_width=8, fpn_dim=32),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def forward_pair(request):
    # score threshold 0 so the random-weight detector keeps detections
    over = dict(VARIANTS[request.param], score_threshold=0.0)
    jc = dataclasses.replace(JDetCfg.tiny(), **over)
    tc = dataclasses.replace(TDetCfg.tiny(), **over)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    imgs = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    ref = JD.forward(p, jnp.asarray(imgs), jc)
    out = TD.forward(from_jax(p, "cpu"), torch.from_numpy(imgs), tc)
    return ref, out


def test_forward_detections(forward_pair):
    ref, out = forward_pair
    np.testing.assert_array_equal(np32(out.valid), np32(ref.valid))
    assert np32(ref.valid).sum() >= 3
    np.testing.assert_array_equal(np32(out.classes), np32(ref.classes))
    # boxes are bf16 in both (the JAX anchors are weakly typed): one bf16
    # ulp at 64 px
    assert out.boxes.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out.boxes), np32(ref.boxes), atol=0.25,
                               rtol=0)
    # scores: softmax of bf16 class logits; a one-ulp logit flip moves a
    # probability by < 5e-3
    np.testing.assert_allclose(np32(out.scores), np32(ref.scores), atol=5e-3,
                               rtol=0)
    np.testing.assert_allclose(np32(out.logits), np32(ref.logits), atol=5e-3,
                               rtol=0)


def test_forward_masks_and_paste(forward_pair):
    ref, out = forward_pair
    # sigmoid masks in bf16: 2 ulps at 1
    np.testing.assert_allclose(np32(out.masks), np32(ref.masks), atol=2e-2,
                               rtol=0)
    jm = JD.full_masks(ref, 64, 64)
    tm = TD.full_masks(out, 64, 64)
    np.testing.assert_allclose(np32(tm), np32(jm), atol=2e-2, rtol=0)


@pytest.mark.parametrize("box_dtype", ["float32", "bfloat16"])
def test_roi_align_and_crop_and_resize(box_dtype):
    rng = np.random.default_rng(1)
    feat = jnp.asarray(rng.standard_normal((16, 16, 8)), jnp.bfloat16)
    img = jnp.asarray(rng.random((40, 48, 3)) * 255, jnp.float32)
    boxes = _boxes(rng, 6, 40, box_dtype)
    ref = JI.roi_align(feat, boxes, 7, spatial_scale=0.25)
    out = TI.roi_align(t(feat), t(boxes), 7, spatial_scale=0.25)
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-5, rtol=1e-5)
    ref = JI.crop_and_resize(img, boxes, 12)
    out = TI.crop_and_resize(t(img), t(boxes), 12)
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-3, rtol=1e-5)


def test_resize_paste_expand():
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.random((2, 30, 30, 3)) * 255, jnp.float32)
    np.testing.assert_allclose(
        np32(TI.resize_bilinear(t(img), 17, 17)),
        np32(JI.resize_bilinear(img, 17, 17)), atol=1e-3, rtol=1e-5)
    masks = jnp.asarray(rng.random((5, 28, 28)), jnp.float32)
    boxes = _boxes(rng, 5, 30)
    np.testing.assert_allclose(
        np32(TI.paste_masks(t(masks), t(boxes), 32, 32)),
        np32(JI.paste_masks(masks, boxes, 32, 32)), atol=1e-5, rtol=1e-5)
    for dt in (jnp.float32, jnp.bfloat16):
        b = _boxes(rng, 7, 60, dt)
        np.testing.assert_array_equal(
            np32(TDT.expand_boxes(t(b), 0.2, 64, 64)),
            np32(JDT.expand_boxes(b, 0.2, 64, 64)))
        np.testing.assert_allclose(np32(TDT.pairwise_iou(t(b), t(b))),
                                   np32(JDT.pairwise_iou(b, b)), atol=1e-6)


def test_nms_topk_and_class_aware():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 40, 50)
    scores = jnp.asarray(np.round(rng.random(40), 2), jnp.float32)  # ties
    valid = jnp.asarray(rng.random(40) > 0.2)
    classes = jnp.asarray(rng.integers(0, 3, 40), jnp.int32)
    ri, rk = JN.nms_topk(boxes, scores, 0.5, 12, valid)
    oi, ok = TN.nms_topk(t(boxes), t(scores), 0.5, 12, t(valid))
    np.testing.assert_array_equal(np32(ok), np32(rk))
    np.testing.assert_array_equal(np32(oi)[np32(ok)], np32(ri)[np32(rk)])
    ri, rk = JN.class_aware_nms_topk(boxes, scores, classes, 0.3, 20, valid)
    oi, ok = TN.class_aware_nms_topk(t(boxes), t(scores), t(classes), 0.3,
                                     20, t(valid))
    np.testing.assert_array_equal(np32(ok), np32(rk))
    np.testing.assert_array_equal(np32(oi)[np32(ok)], np32(ri)[np32(rk)])
    np.testing.assert_array_equal(
        np32(TN.nms_mask(t(boxes), t(scores), 0.5, t(valid))),
        np32(JN.nms_mask(boxes, scores, 0.5, valid)))
