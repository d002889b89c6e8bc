"""Divisions by a constant: the port against the JAX package jitted as its
paths run it (ROADMAP C.10).

Inside `jax.jit`, XLA on the CPU turns a float division by a constant into
a product with the constant's float32 reciprocal (eager JAX divides).
PyTorch on the card does the same for a division by a host number, and
divides on the CPU. The port spells the product (`ops.geometry
.reciprocal32`) wherever the JAX package's path is jitted, so its CPU
path, its card path and the reference compute one arithmetic. Each test
runs the JAX function jitted, with its inputs as arguments (a program
whose inputs are constants folds them with IEEE divisions instead), and
holds the port to it bit for bit. Where the JAX function's other
arithmetic keeps the whole output from being bit-equal, the test reads
the value at the site through a spy, or picks inputs whose other
arithmetic is exact; `test_jitted_reference_keeps_no_division_by_a_constant`
reads the compiled programs themselves.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JDetCfg
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models.quantize import quantize_kv as jqkv
from embodied_captioning_tpu.ops import image as JI
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu_torch.config import DetectorConfig as TDetCfg
from embodied_captioning_tpu_torch.models import captioner as TCAP
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.models.quantize import quantize_kv
from embodied_captioning_tpu_torch.ops import image as TI
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.ops.geometry import reciprocal32
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import np32, t

ALL_BYTES = np.arange(256, dtype=np.uint8)


def _bits_equal(got, want):
    np.testing.assert_array_equal(np32(got), np32(want))


# ---------------------------------------------------------------------------
# quantize_kv: the int8 cross K/V that `perceive` builds on every batch
# ---------------------------------------------------------------------------

def test_quantize_kv_equals_the_jitted_reference_at_the_serving_shape():
    rng = np.random.default_rng(0)
    kt = jnp.asarray(rng.standard_normal((4, 12, 64, 257)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((4, 257, 12, 64)), jnp.bfloat16)
    want = jax.jit(jqkv)(kt, v)
    got = quantize_kv(t(kt), t(v))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(np32(a), np32(b), err_msg=name)
    # the shape tells the two arithmetics apart: eager JAX divides, and
    # its K scales are not the jitted ones
    eager = jqkv(kt, v)
    assert (np32(eager.kt_scale) != np32(want.kt_scale)).sum() > 0


# ---------------------------------------------------------------------------
# the detectors' float input: uint8 / 255
# ---------------------------------------------------------------------------

def test_to_float_equals_the_jitted_division_over_every_byte():
    want = jax.jit(JI.to_float)(jnp.asarray(ALL_BYTES))
    got = TI.to_float(torch.from_numpy(ALL_BYTES))
    _bits_equal(got, want)
    # 126 of the 256 bytes tell the product from the division
    div = ALL_BYTES.astype(np.float32) / np.float32(255.0)
    assert (np32(want) != div).sum() == 126


def _frames():
    """Two 64^2 frames: every byte value in each channel of the first,
    seeded noise in the second."""
    a = np.tile(ALL_BYTES.reshape(16, 16, 1), (4, 4, 3))
    b = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    return np.stack([a, b])


@pytest.fixture
def fpn_inputs(monkeypatch):
    """Spies on both packages' `backbone_fpn`: the float images each
    detector path hands it, the JAX ones read out of the compiled program
    through a debug callback."""
    seen = {"jax": [], "port": []}
    jfpn, tfpn = JD.backbone_fpn, TD.backbone_fpn

    def jspy(params, images, cfg, *a, **k):
        jax.debug.callback(lambda x: seen["jax"].append(np.asarray(x)),
                           images)
        return jfpn(params, images, cfg, *a, **k)

    def tspy(params, images, cfg, *a, **k):
        seen["port"].append(images.detach().clone())
        return tfpn(params, images, cfg, *a, **k)

    monkeypatch.setattr(JD, "backbone_fpn", jspy)
    monkeypatch.setattr(TD, "backbone_fpn", tspy)
    jax.clear_caches()  # the jitted paths trace the spy afresh
    yield seen
    jax.clear_caches()


def _cfgs(family):
    over = dict(score_threshold=0.0, family=family)
    return (dataclasses.replace(JDetCfg.tiny(), **over),
            dataclasses.replace(TDetCfg.tiny(), **over))


def _gt(masks_side):
    boxes = np.array([[[4, 4, 30, 30], [10, 20, 50, 60]]] * 2, np.float32)
    d = dict(boxes=boxes, classes=np.ones((2, 2), np.int32),
             scores=np.ones((2, 2), np.float32),
             logits=np.full((2, 2, 6), 1 / 6, np.float32),
             valid=np.ones((2, 2), bool),
             masks=np.ones((2, 2, masks_side, masks_side), np.float32))
    return (JDet(**{k: jnp.asarray(v) for k, v in d.items()}),
            TDet(**{k: torch.from_numpy(v) for k, v in d.items()}))


@pytest.mark.parametrize("path", ["forward", "forward_mc", "detector_loss",
                                  "query_forward", "query_detector_loss"])
def test_detector_input_equals_the_jitted_paths(fpn_inputs, path):
    family = "query" if path.startswith("query") else "rcnn"
    jc, tc = _cfgs(family)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    tp = from_jax(p, "cpu")
    imgs = _frames()
    ju, tu = jnp.asarray(imgs), torch.from_numpy(imgs)
    if path in ("forward", "query_forward"):
        JD.forward(p, ju, jc)
        TD.forward(tp, tu, tc)
    elif path == "forward_mc":
        JD.forward_mc(p, ju, jax.random.PRNGKey(1), jc, samples=2)
        TD.forward_mc(tp, tu, tc, samples=2,
                      generator=torch.Generator().manual_seed(0))
    else:
        jgt, tgt = _gt(64 if family == "query" else jc.mask_size)
        # the training step's program: images and labels are arguments
        jax.jit(jax.value_and_grad(
            lambda q, im, g: JD.detector_loss(q, im, g, jc)[0]))(p, ju, jgt)
        TD.detector_loss(tp, tu, tgt, tc)
    assert fpn_inputs["jax"] and fpn_inputs["port"]
    _bits_equal(fpn_inputs["port"][-1], fpn_inputs["jax"][-1])
    _bits_equal(fpn_inputs["port"][-1],
                torch.from_numpy(imgs).float() * reciprocal32(255.0))


# ---------------------------------------------------------------------------
# ops/image: the separate preprocess path and the ROI sample positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_size,out_size,patch",
                         [(64, 64, 8), (64, 32, 8), (224, 224, 14)])
def test_separate_preprocess_equals_the_jitted_reference(in_size, out_size,
                                                         patch):
    # a single [H, W, 3] image takes the port's separate ops (the fused
    # kernel takes uint8 batches): `/ 255`, the resize, then `(v - mean)`
    # times the reciprocals of std, as the jitted program computes them.
    # At these sizes the two resize products sum alike.
    img = np.random.default_rng(in_size + out_size).integers(
        0, 256, (in_size, in_size, 3), np.uint8)
    want = jax.jit(JI.preprocess_for_vit, static_argnums=(1, 2))(
        jnp.asarray(img), out_size, patch)
    got = TI.preprocess_for_vit(torch.from_numpy(img), out_size, patch)
    _bits_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("samples", [7, 28, 224])
def test_box_interp_weights_are_eager_on_the_cpu(samples, dtype):
    # ROADMAP C.50, left open: the JAX package computes the ROI sample
    # positions eagerly in its scripts (an IEEE `/ samples`, separate
    # products and sums) and inside jitted programs as the surrounding
    # program rounds them (alone: a product and one fused multiply-add).
    # The port's CPU path is eager JAX's, bit for bit; the jitted function
    # alone differs from it
    rng = np.random.default_rng(samples)
    xy = rng.random((9, 2)) * 30
    boxes = jnp.asarray(np.concatenate([xy, xy + rng.random((9, 2)) * 15 + 2],
                                       1), dtype)
    want = JI._box_interp_weights(boxes, samples, 40, 48)
    got = TI._box_interp_weights(t(boxes), samples, 40, 48)
    _bits_equal(got[0], want[0])
    _bits_equal(got[1], want[1])
    jitted = jax.jit(JI._box_interp_weights, static_argnums=(1, 2, 3))(
        boxes, samples, 40, 48)
    assert (np32(jitted[1]) != np32(want[1])).sum() > 0


# ---------------------------------------------------------------------------
# the detector's box coder and losses
# ---------------------------------------------------------------------------

def test_decode_boxes_weights_equal_the_jitted_reference():
    # ROI weights (10, 10, 5, 5); dw = dh = 0, so exp(0) = 1 in both
    # libraries and the divided centre offsets decide every bit
    rng = np.random.default_rng(3)
    xy = rng.random((4000, 2)) * 200
    anchors = np.concatenate([xy, xy + rng.random((4000, 2)) * 50 + 1],
                             1).astype(np.float32)
    deltas = rng.standard_normal((4000, 4)).astype(np.float32)
    deltas[:, 2:] = 0
    want = jax.jit(JD.decode_boxes, static_argnums=(2, 3))(
        jnp.asarray(anchors), jnp.asarray(deltas), 256, JD.ROI_BOX_WEIGHTS)
    got = TD.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas),
                          256, TD.ROI_BOX_WEIGHTS)
    _bits_equal(got, want)


def test_smooth_l1_equals_the_jitted_reference():
    x = np.random.default_rng(4).standard_normal(50000).astype(np.float32)
    x *= 0.3  # most of them inside beta = 1/9's quadratic part or near it
    want = jax.jit(JD._smooth_l1)(jnp.asarray(x))
    _bits_equal(TD._smooth_l1(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# sites read through a spy on the function that consumes the divided value
# ---------------------------------------------------------------------------

class _SpyNumpy:
    """`jax.numpy` with one function's argument `arg` read out of the
    compiled program (debug callback) into `seen`."""

    def __init__(self, name, seen, arg=0):
        self._name, self._seen, self._arg = name, seen, arg

    def __getattr__(self, attr):
        fn = getattr(jnp, attr)
        if attr != self._name:
            return fn

        def spy(*a, **k):
            jax.debug.callback(lambda v: self._seen.append(np.asarray(v)),
                               a[self._arg])
            return fn(*a, **k)
        return spy


@pytest.mark.parametrize("t_len,dim", [(16, 32), (64, 128), (100, 96)])
def test_sinusoidal_angle_equals_the_jitted_reference(monkeypatch, t_len,
                                                      dim):
    # the angle pos / 10000^(2 i / dim), read where each package takes its
    # sine (the sines themselves differ by an ulp here and there: C.11)
    seen, port = [], []
    monkeypatch.setattr(JC, "jnp", _SpyNumpy("sin", seen))
    sin = torch.sin
    monkeypatch.setattr(torch, "sin", lambda x: (port.append(x), sin(x))[1])
    jax.jit(JC.sinusoidal_positions, static_argnums=(0, 1))(t_len, dim)
    TC.sinusoidal_positions(t_len, dim)
    _bits_equal(port[-1], seen[-1])


@pytest.mark.parametrize("temperature", [0.7, 1.3, 3.0])
def test_sampling_temperature_equals_the_jitted_reference(monkeypatch,
                                                          temperature):
    # `logits / temperature`, read where `_sample` sorts it for top-k
    seen = []
    monkeypatch.setattr(JCAP, "jnp", _SpyNumpy("sort", seen))
    logits = np.random.default_rng(5).standard_normal((4, 500)).astype(
        np.float32) * 6
    jax.jit(JCAP._sample, static_argnums=(2, 3, 4))(
        jnp.asarray(logits), jax.random.PRNGKey(0), 20, 1.0, temperature)
    filtered = TCAP._filter_logits(torch.from_numpy(logits), 0, 1.0,
                                   temperature)
    _bits_equal(filtered, seen[0])


@pytest.mark.parametrize("dh", [8, 32, 96])
def test_attention_scale_equals_the_jitted_reference(monkeypatch, dh):
    # XLA attention's `logits / sqrt(dh)` (its float32 route over
    # precomputed K/V), read where the mask is applied, against
    # `_attention_plain`'s scaled logits, read at the same place; the
    # products of integer-valued q and k are exact in both, so the scale
    # decides every bit
    seen, port = [], []
    monkeypatch.setattr(JC, "jnp", _SpyNumpy("where", seen, arg=1))
    rng = np.random.default_rng(dh)
    b, tq, h, tk = 2, 3, 2, 5
    q = rng.integers(-3, 4, (b, tq, h, dh)).astype(np.float32)
    kt = rng.integers(-3, 4, (b, h, dh, tk)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, dh)).astype(np.float32)  # head-major
    mask = rng.random((b, 1, tq, tk)) < 0.8
    eye = {"w": jnp.eye(h * dh, dtype=jnp.float32),
           "b": jnp.zeros((h * dh,), jnp.float32)}
    jax.jit(lambda x_, kt_, v_, m_: JC.mha(
        {"q": eye, "o": eye}, x_, h, mask=m_, compute_dtype=jnp.float32,
        kv_precomputed=(kt_, v_))[0])(
            jnp.asarray(q.reshape(b, tq, h * dh)), jnp.asarray(kt),
            jnp.asarray(v), jnp.asarray(mask))
    where = torch.where
    monkeypatch.setattr(torch, "where", lambda c, a, *r: (
        port.append(a) if torch.is_tensor(a) and a.shape == (b, h, tq, tk)
        else None, where(c, a, *r))[1])
    TC._attention_plain(torch.from_numpy(q), torch.from_numpy(kt),
                        torch.from_numpy(v),
                        torch.from_numpy(mask))
    assert len(seen) == 1 and len(port) == 1
    _bits_equal(port[0], seen[0])


# ---------------------------------------------------------------------------
# the compiled reference programs: no division by a constant is left
# ---------------------------------------------------------------------------

_COMP = re.compile(r"^%?([\w.\-]+) \(.*\) -> .* \{$")
_DEF = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = [^(]*?([a-z][\w\-]*)\((.*)$")


def _constant_divisions(hlo: str) -> list:
    """The float `divide` instructions of an optimised HLO module with a
    divisor that is a constant: a `constant`, or one reached through
    broadcasts, reshapes, bitcasts, copies, converts and fusion
    parameters."""
    defs, params, calls = {}, {}, []
    comp = None
    for line in hlo.splitlines():
        m = _COMP.match(line.strip())
        if m:
            comp = m.group(1)
            continue
        m = _DEF.match(line)
        if not m:
            continue
        name, op, rest = m.groups()
        operands = re.findall(r"%([\w.\-]+)", rest.split("), ")[0])
        defs[name] = (op, operands, line)
        if op == "parameter":
            idx = int(re.match(r"(\d+)", rest).group(1))
            params.setdefault(comp, {})[idx] = name
        c = re.search(r"calls=%([\w.\-]+)", rest)
        if op == "fusion" and c:
            calls.append((c.group(1), operands))
    outside = {}  # a fusion parameter -> the operands bound to it
    for comp_name, operands in calls:
        for idx, pname in params.get(comp_name, {}).items():
            if idx < len(operands):
                outside.setdefault(pname, []).append(operands[idx])

    def constant(name, depth=0):
        if name not in defs or depth > 32:
            return False
        op, operands, _ = defs[name]
        if op == "constant":
            return True
        if op in ("broadcast", "reshape", "bitcast", "copy", "convert"):
            return bool(operands) and constant(operands[0], depth + 1)
        if op == "parameter":
            return any(constant(o, depth + 1) for o in outside.get(name, []))
        return False

    return [line.strip() for op, operands, line in defs.values()
            if op == "divide" and re.search(r"= (f32|bf16|f16)", line)
            and len(operands) == 2 and constant(operands[1])]


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _loss_programs():
    jc, _ = _cfgs("rcnn")
    qc, _ = _cfgs("query")
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    qp = JD.init_detector(jax.random.PRNGKey(0), qc)
    imgs = jnp.asarray(_frames())
    jgt, _ = _gt(jc.mask_size)
    qgt, _ = _gt(64)
    return {
        # the soft head's `/ soft_temperature`, the box head's dropout
        # `/ (1 - rate)`, `_smooth_l1`'s `/ beta`, `/ 255`
        "detector_loss": lambda: _hlo(
            lambda q, im, g, k: jax.grad(lambda r: JD.detector_loss(
                r, im, g, jc, head="soft", dropout_rng=k,
                dropout_rate=0.5)[0])(q), p, imgs, jgt,
            jax.random.PRNGKey(2)),
        # the set loss's `/ npix` and `/ len(preds)`
        "query_detector_loss": lambda: _hlo(
            lambda q, im, g: jax.grad(lambda r: JD.detector_loss(
                r, im, g, qc)[0])(q), qp, imgs, qgt),
        # the advantage normalisation's and the losses' means (the
        # port's distributed update spells them as sums times 1/n)
        "ppo_normalise": lambda: _hlo(
            lambda a: (a - a.mean()) / (a.std() + 1e-5),
            jnp.ones((24,), jnp.float32)),
        "quantize_kv": lambda: _hlo(
            jqkv, jnp.ones((2, 3, 8, 10), jnp.bfloat16),
            jnp.ones((2, 10, 3, 8), jnp.bfloat16)),
        "sample": lambda: _hlo(
            lambda lg, k: JCAP._sample(lg, k, 20, 1.0, 0.7),
            jnp.ones((4, 500), jnp.float32), jax.random.PRNGKey(0)),
    }


@pytest.mark.parametrize("program", ["detector_loss", "query_detector_loss",
                                     "ppo_normalise", "quantize_kv",
                                     "sample"])
def test_jitted_reference_keeps_no_division_by_a_constant(program):
    hlo = _loss_programs()[program]()
    assert " divide(" in hlo or " multiply(" in hlo
    assert _constant_divisions(hlo) == []


def test_constant_division_finder_sees_a_kept_division():
    # a program XLA leaves a constant division in: an integer division,
    # which `_constant_divisions` skips, beside a float one it must see
    # when handed the unoptimised spelling
    hlo = ("HloModule m\n"
           "ENTRY %main (p: f32[4]) -> f32[4] {\n"
           "  %p = f32[4]{0} parameter(0)\n"
           "  %c = f32[] constant(3)\n"
           "  %b = f32[4]{0} broadcast(%c), dimensions={}\n"
           "  ROOT %d = f32[4]{0} divide(%p, %b)\n"
           "}\n")
    assert len(_constant_divisions(hlo)) == 1
