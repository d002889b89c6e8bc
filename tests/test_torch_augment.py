"""The port's batched detection augmentation (`ops/augment.py`) against the
JAX package's on handed draws, bit for bit: images, masks (uint8 and
float), boxes and validity, at the tiny sizes; the port's own draws; and
the detector self-check's host augmentation against the JAX package's
host oracle (tests/test_augment.py, `selfcheck_detector.batch_of`'s
semantics) on the same numpy draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.ops import augment as JA
from embodied_captioning_tpu_torch.ops import augment as TA
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.selfcheck_detector import host_augment
from test_augment import _mkdet, _oracle

B, N, H, W = 6, 5, 48, 40
FLAGS = {"all": dict(), "no-crop": dict(crop=False),
         "no-flip": dict(flip=False), "no-jitter": dict(jitter=False),
         "crop-only": dict(flip=False, jitter=False)}


def _port_det(det, mask_dtype=None) -> TDet:
    f = {k: torch.from_numpy(np.array(getattr(det, k)))
         for k in ("boxes", "classes", "scores", "logits", "valid", "masks")}
    if mask_dtype is not None:
        f["masks"] = f["masks"].to(mask_dtype)
    return TDet(**f)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mask_dtype", ["uint8", "float32"])
def test_apply_augment_equals_jax_bit_for_bit(flags, seed, mask_dtype):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    det = _mkdet(rng, B, N, H, W)
    det = det.replace(masks=det.masks.astype(mask_dtype))
    p = JA.draw_augment_params(jax.random.PRNGKey(seed), B, **FLAGS[flags])
    want_img, want = jax.jit(JA.apply_augment)(jnp.asarray(rgb), det, p)
    tp = TA.AugmentParams(*(torch.from_numpy(np.array(x)) for x in p))
    got_img, got = TA.apply_augment(torch.from_numpy(rgb), _port_det(det),
                                    tp)
    assert got_img.dtype == torch.uint8
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.masks.dtype == getattr(torch, mask_dtype)
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    for f in ("classes", "scores", "logits"):
        assert torch.equal(getattr(got, f), _port_det(det).__dict__[f]), f


def test_apply_augment_without_masks():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    det = _mkdet(rng, B, N, H, W).replace(masks=None)
    p = JA.draw_augment_params(jax.random.PRNGKey(4), B)
    want_img, want = JA.apply_augment(jnp.asarray(rgb), det, p)
    got_img, got = TA.apply_augment(
        torch.from_numpy(rgb), _port_det(det.replace(
            masks=np.zeros(0))).replace(masks=None),
        TA.AugmentParams(*(torch.from_numpy(np.array(x)) for x in p)))
    assert got.masks is None and want.masks is None
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_port_draws_follow_the_jax_distributions():
    """jax.random and torch draw other numbers: the port's draws are
    held to the distributions (ranges, rates) and to their generator."""
    g = torch.Generator().manual_seed(0)
    p = TA.draw_augment_params(g, 4000, "cpu")
    assert 0.45 < float(p.do_crop.float().mean()) < 0.55
    assert 0.45 < float(p.do_flip.float().mean()) < 0.55
    for x, lo, hi in ((p.scale, 0.55, 0.95), (p.oy, 0.0, 1.0),
                      (p.ox, 0.0, 1.0), (p.bright, 0.75, 1.25),
                      (p.shift, -15.0, 15.0)):
        assert float(x.min()) >= lo and float(x.max()) < hi
        assert float(x.max() - x.min()) > 0.9 * (hi - lo)
    off = TA.draw_augment_params(g, 8, "cpu", crop=False, flip=False,
                                 jitter=False)
    assert not off.do_crop.any() and not off.do_flip.any()
    assert (off.scale == 1).all() and (off.bright == 1).all()
    assert not off.shift.any()
    a = TA.draw_augment_params(torch.Generator().manual_seed(5), 8, "cpu")
    b = TA.draw_augment_params(torch.Generator().manual_seed(5), 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_augment_batch_is_draw_then_apply():
    rng = np.random.default_rng(6)
    rgb = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3),
                                        dtype=np.uint8))
    det = _port_det(_mkdet(rng, B, N, H, W))
    img, out = TA.augment_batch(torch.Generator().manual_seed(9), rgb, det)
    p = TA.draw_augment_params(torch.Generator().manual_seed(9), B, "cpu")
    img2, out2 = TA.apply_augment(rgb, det, p)
    assert torch.equal(img, img2) and torch.equal(out.boxes, out2.boxes)
    assert torch.equal(out.masks, out2.masks)


@pytest.mark.parametrize("crop", [False, True])
def test_host_augment_equals_the_jax_host_oracle(crop):
    """The self-check's numpy augmentation of one frame against the JAX
    package's oracle of `batch_of`, fed the draws a copy of the same
    generator makes in the script's order."""
    rng = np.random.default_rng(11)
    det = _mkdet(rng, 8, N, H, W)
    rgbs = rng.integers(0, 256, (8, H, W, 3), dtype=np.uint8)
    draws = np.random.default_rng(21)
    for i in range(8):
        frame = {k: np.asarray(getattr(det, k))[i]
                 for k in ("boxes", "classes", "scores", "logits", "valid",
                           "masks")}
        twin = np.random.default_rng()
        twin.bit_generator.state = draws.bit_generator.state
        ch, cw, oy, ox = H, W, 0, 0
        if crop and twin.random() < 0.5:
            s = twin.uniform(0.55, 0.95)
            ch, cw = max(int(H * s), 8), max(int(W * s), 8)
            oy = int(twin.integers(0, H - ch + 1))
            ox = int(twin.integers(0, W - cw + 1))
        flip = twin.random() < 0.5
        bright = twin.uniform(0.75, 1.25)
        shift = twin.uniform(-15, 15, size=(1, 1, 3))
        d1 = det.replace(**{k: getattr(det, k)[i] for k in (
            "boxes", "valid", "masks")})
        want = _oracle(rgbs[i], d1, ch, cw, oy, ox, flip, bright, shift, H,
                       W)
        got_rgb, got = host_augment(rgbs[i], frame, draws, crop)
        assert draws.bit_generator.state == twin.bit_generator.state
        np.testing.assert_array_equal(got_rgb, want[0])
        np.testing.assert_array_equal(got["boxes"], want[1])
        np.testing.assert_array_equal(got["masks"], want[2])
        if crop:
            np.testing.assert_array_equal(got["valid"], want[3])
