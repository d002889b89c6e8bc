"""The port's query (Mask2Former-class) detector against the JAX package's
`models/query_detector.py`, on the CPU, at the JAX tests' QCFG (64^2,
fpn_dim 64: head dim 8, the flash kernel's twin in the port; 16 queries,
3 layers) and at the tiny preset with the query family (fpn_dim 32: head
dim 4, the plain attention on both sides).

Module by module on handed inputs (positions, the attention mask, the
heads, the set loss and its matching, `finalize`), then the whole decoder,
loss and gradients on the JAX package's seeded weights. The decoder
amplifies one-ulp differences: a mask logit near 0 flips an attention
entry of the next layer (ROADMAP C.29), and at 16 queries the JAX package
sends the query self-attention to XLA attention (bf16 scores) while the
port keeps it on the flash kernel's numerics (C.9). So the whole-model
comparisons hold each output to a limit set from the JAX package's own
spread when its parameters move by 1e-4 of themselves
(`python tests/torch_parity.py query-chaos` prints the readings).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JCfg
from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models import query_detector as JQ
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu_torch.config import DetectorConfig as TCfg
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.models import query_detector as TQ
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.train.optim import value_and_grad
from torch_parity import (
    gradient_errors, jax_kernel_path, jax_train_path, leaf_names, np32,
    perturbed, t,
)

QCFG = dict(image_size=64, backbone_width=16, fpn_dim=64, family="query",
            num_queries=16, query_layers=3, max_detections=8,
            score_threshold=0.1)
TINY = dict(family="query")


def _cfgs(name: str, **over):
    if name == "qcfg":
        kw = dict(QCFG, **over)
        return JCfg(**kw), TCfg(**kw)
    kw = dict(TINY, **over)
    return (dataclasses.replace(JCfg.tiny(), **kw),
            dataclasses.replace(TCfg.tiny(), **kw))


def _gt_batch(rng, b: int, g: int, size: int, num_classes: int = 6):
    """tests/test_query_detector.py's scenes: two coloured boxes a frame,
    their masks and classes, the other slots padding."""
    x1 = rng.uniform(4, size - 24, (b, g))
    y1 = rng.uniform(4, size - 24, (b, g))
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 20, (b, g)),
                      y1 + rng.uniform(10, 20, (b, g))], -1)
    masks = np.zeros((b, g, size, size), np.uint8)
    imgs = np.full((b, size, size, 3), 30, np.uint8)
    classes = rng.integers(0, num_classes, (b, g))
    valid = np.zeros((b, g), bool)
    valid[:, :2] = True
    for i in range(b):
        for j in range(2):
            bx = boxes[i, j].astype(int)
            masks[i, j, bx[1]:bx[3], bx[0]:bx[2]] = 1
            imgs[i, bx[1]:bx[3], bx[0]:bx[2]] = [
                40 * (classes[i, j] + 1) % 255, 80, 160]
    gt = dict(boxes=boxes.astype(np.float32), classes=classes.astype(np.int32),
              scores=np.ones((b, g), np.float32),
              logits=np.zeros((b, g, num_classes), np.float32), valid=valid,
              masks=masks)
    return imgs, gt


def _jgt(gt: dict) -> JDet:
    return JDet(**{k: jnp.asarray(v) for k, v in gt.items()})


def _tgt(gt: dict) -> TDet:
    return TDet(**{k: torch.from_numpy(np.asarray(v)) for k, v in gt.items()})


# ---------------------------------------------------------------------------
# building blocks on handed inputs
# ---------------------------------------------------------------------------

def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("hwd", [(2, 2, 64), (4, 4, 32), (16, 16, 64),
                                 (8, 8, 256), (64, 64, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_positions_within_one_ulp(hwd):
    """`_pos2d`: torch.pow / sin / cos and XLA's differ by one float32 ulp
    on 3.4-7.8% of the entries at these shapes (ROADMAP C.11), never more.
    `sinusoidal_positions` over all h*w positions (angles up to 4095):
    within 1.2e-7 (two ulps at 1; 4.3-5.5% of the entries differ), the
    angle's own rounding carried through sin and cos."""
    h, w, d = hwd
    a, b = np32(JQ._pos2d(h, w, d)), np32(TQ._pos2d(h, w, d))
    assert a.shape == b.shape == (h * w, d)
    assert _ulps(a, b).max() <= 1 and (a != b).mean() <= 0.1
    s, u = np32(JC.sinusoidal_positions(h * w, d)), np32(
        TC.sinusoidal_positions(h * w, d))
    assert np.abs(s - u).max() <= 1.2e-7 and (s != u).mean() <= 0.1


@pytest.mark.parametrize("hm,h", [(16, 8), (16, 4), (16, 2), (32, 4),
                                  (64, 8)])
def test_attn_mask_bit_for_bit(hm, h):
    """`_attn_mask` on handed logits, zeros and an all-negative query (the
    full-attention fallback) among them: equal bit for bit (the resize's
    0.5/0.5 taps are exact sums)."""
    rng = np.random.default_rng(hm + h)
    mlog = rng.standard_normal((2, 5, hm, hm)).astype(np.float32)
    mlog[0, 1] = -np.abs(mlog[0, 1]) - 1e-3
    mlog[1, 2, ::2] = 0.0
    mlog[1, 3] *= np.float32(1e-30)
    want = np.asarray(JQ._attn_mask(jnp.asarray(mlog), h, h))
    got = TQ._attn_mask(torch.from_numpy(mlog), h, h).numpy()
    assert got.shape == want.shape == (2, 1, 5, h * h)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 1].all()


def test_predict_heads_on_handed_inputs():
    """`_predict` on handed float32 queries and bf16 mask features: class
    logits within one bf16 ulp (the dense output is rounded to bf16 after
    float32 sums in another order), mask logits within float32 rounding
    of the sums over 64 exact products."""
    jc, tc = _cfgs("qcfg")
    p = JD.init_detector(jax.random.PRNGKey(2), jc)
    tp = from_jax(p, "cpu")
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mf = jnp.asarray(rng.standard_normal((2, 16, 16, 64)), jnp.bfloat16)
    jcls, jm = JQ._predict(p, jnp.asarray(q), mf)
    tcls, tm = TQ._predict(tp, torch.from_numpy(q), t(mf))
    assert tm.dtype == tcls.dtype == torch.float32
    np.testing.assert_allclose(np32(tcls), np32(jcls), rtol=8e-3, atol=1e-5)
    np.testing.assert_allclose(np32(tm), np32(jm), rtol=1e-5, atol=1e-5)


def _handed_logits(seed: int, q: int = 16, g: int = 8, c: int = 6,
                   hm: int = 16):
    """Class and mask logits with clear winners for two ground truths and
    random ones elsewhere, the ground truth of `_gt_batch`'s kind."""
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((q, c + 1)).astype(np.float32)
    mlog = rng.standard_normal((q, hm, hm)).astype(np.float32) * 3
    gm = np.zeros((g, hm, hm), np.float32)
    gm[0, 2:8, 2:8] = 1
    gm[1, 9:14, 6:12] = 1
    gm[2, 1:4, 10:15] = 1
    gt_cls = rng.integers(0, c, g).astype(np.int32)
    valid = np.zeros(g, bool)
    valid[:3] = True
    return cls, mlog, gt_cls, valid, gm


# sigmoid, log and their derivatives round differently in XLA and torch
# near p = 0 and 1: a few mask-logit gradient elements (0.07-0.15%) move by
# more than 1e-4 of themselves, by at most 7.6e-4 of the largest element
# (measured over the six cases)
MLOG_GRAD_ATOL = 2e-3


@pytest.mark.parametrize("aux_topk", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_loss_one_and_its_gradients(aux_topk, seed):
    """`_set_loss_one` on handed logits: the matched queries equal (the
    Hungarian solver's, or the top-k's with lax.top_k's ties), the loss
    and its gradients with respect to both logits within float32 rounding
    (the cost products over pixels sum in another order)."""
    cls, mlog, gt_cls, valid, gm = _handed_logits(seed)
    kw = dict(no_obj_w=0.1, num_classes=6, aux_topk=aux_topk)

    @jax.jit
    def jfn(c, m):
        return JQ._set_loss_one(c, m, jnp.asarray(gt_cls), jnp.asarray(valid),
                                jnp.asarray(gm), **kw)

    (jl, jmatched), (jgc, jgm) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(cls), jnp.asarray(mlog))
    tcls = torch.from_numpy(cls).requires_grad_()
    tml = torch.from_numpy(mlog).requires_grad_()
    tl, tmatched = TQ.set_loss_one(tcls, tml, torch.from_numpy(gt_cls),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(gm), **kw)
    tl.backward()
    np.testing.assert_array_equal(np32(tmatched), np32(jmatched))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(np32(tcls.grad), np32(jgc), rtol=1e-4,
                               atol=1e-6)
    gm_want = np32(jgm)
    err = np.abs(np32(tml.grad) - gm_want) / np.abs(gm_want).max()
    np.testing.assert_allclose(np32(tml.grad), gm_want, rtol=1e-4,
                               atol=MLOG_GRAD_ATOL * np.abs(gm_want).max())


def test_set_loss_one_obvious_assignment():
    """tests/test_query_detector.py's crafted scene: queries 3 and 7 cover
    the two ground truths."""
    q, g, hm, c = 10, 4, 16, 6
    mlog = np.full((q, hm, hm), -8.0, np.float32)
    gm = np.zeros((g, hm, hm), np.float32)
    gm[0, 2:8, 2:8] = 1
    gm[1, 10:14, 10:14] = 1
    mlog[3, 2:8, 2:8] = 8.0
    mlog[7, 10:14, 10:14] = 8.0
    cls = np.zeros((q, c + 1), np.float32)
    cls[3, 1] = 6.0
    cls[7, 2] = 6.0
    args = [torch.from_numpy(x) for x in (
        cls, mlog, np.array([1, 2, 0, 0], np.int32),
        np.array([True, True, False, False]), gm)]
    loss, matched = TQ.set_loss_one(*args, no_obj_w=0.1, num_classes=c)
    assert matched[0] == 3 and matched[1] == 7 and float(loss) < 2.0
    loss_m, matched_m = TQ.set_loss_one(*args, no_obj_w=0.1, num_classes=c,
                                        aux_topk=2)
    assert matched_m[0] == 3 and matched_m[1] == 7
    assert float(loss_m) > float(loss)


# ---------------------------------------------------------------------------
# finalize on handed logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qcfg", "tiny"])
@pytest.mark.parametrize("with_masks", [True, False])
def test_finalize_on_handed_logits(name, with_masks, monkeypatch):
    """The JAX `forward_query`'s finalize (its `_decode` handed the same
    logits) against `finalize`: equal validity, classes, boxes and slot
    order; masks within 1.2e-7 (two float32 ulps at 1); scores and probabilities within 1e-6 of themselves
    (four float32 ulps at most, measured: the softmax and the mean over
    the mask round differently)."""
    jc, tc = _cfgs(name, score_threshold=0.05)
    rng = np.random.default_rng(7)
    qn = jc.num_queries
    cls = rng.standard_normal((2, qn, 7)).astype(np.float32) * 2
    mlog = rng.standard_normal((2, qn, 16, 16)).astype(np.float32) * 4
    mlog[:, ::3] -= 9.0  # empty masks: dropped whatever their score
    monkeypatch.setattr(JQ, "_decode", lambda p, im, cfg: [
        (jnp.asarray(cls), jnp.asarray(mlog))])
    want = JQ.forward_query.__wrapped__(
        None, jnp.zeros((2, 64, 64, 3), jnp.uint8), jc, with_masks)
    got = TQ.finalize(torch.from_numpy(cls), torch.from_numpy(mlog), tc,
                      with_masks)
    assert np32(want.valid).sum() >= 4
    for f in ("valid", "classes", "boxes"):
        np.testing.assert_array_equal(np32(getattr(got, f)),
                                      np32(getattr(want, f)), err_msg=f)
    for f in ("scores", "logits"):
        np.testing.assert_allclose(np32(getattr(got, f)),
                                   np32(getattr(want, f)), rtol=1e-6,
                                   atol=0, err_msg=f)
    # the ROI crops: the port's and XLA's float32 products of the two-tap
    # bilinear weights round differently on 13-15% of the elements (one
    # ulp), and torch's sigmoid differs from XLA's on 0.4% of its inputs
    # (one ulp; ROADMAP C.30)
    gm_, wm_ = np32(got.masks), np32(want.masks)
    assert np.abs(gm_ - wm_).max() <= 1.2e-7 and (gm_ != wm_).mean() <= 0.2


# ---------------------------------------------------------------------------
# the decoder, the loss and its gradients on the JAX package's weights
# ---------------------------------------------------------------------------

SPREAD_MOVES = (1, 2)
SPREAD_FACTOR = 3.0


@pytest.fixture(scope="module", params=["qcfg", "tiny"])
def decoded(request):
    """Per supervision point (class logits, mask logits) of the JAX
    package's kernel path and of the port on the same weights and frames,
    and the JAX path's own spread under two 1e-4 moves of the weights."""
    jc, tc = _cfgs(request.param)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    imgs, _ = _gt_batch(np.random.default_rng(0), 2, 8, 64)
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    with jax_kernel_path():
        fn = jax.jit(functools.partial(JQ._decode, cfg=jc))
        want = [[np32(a) for a in pr] for pr in fn(p, x)]
        moved = [[[np32(a) for a in pr] for pr in fn(perturbed(p, s), x)]
                 for s in SPREAD_MOVES]
    with torch.no_grad():
        got = [[np32(a) for a in pr] for pr in TQ._decode(
            from_jax(p, "cpu"), torch.from_numpy(imgs).float() / 255.0, tc)]
    return dict(name=request.param, want=want, got=got, moved=moved, p=p,
                imgs=imgs, jc=jc, tc=tc)


def test_decoder_layers_within_the_jax_spread(decoded):
    """Every supervision point's class and mask logits: the port's distance
    from the JAX package within 3x the JAX package's own spread (or 1e-2
    of the norm). Before the first decoder layer nothing amplifies: there
    the mask logits are within 2e-2 of their norm's scale (bf16 rounding
    of the convolutions' outputs)."""
    d = decoded
    assert len(d["got"]) == len(d["want"]) == d["jc"].query_layers + 1
    for li, (g, w) in enumerate(zip(d["got"], d["want"])):
        for k in range(2):
            assert g[k].shape == w[k].shape
            err = float(np.linalg.norm(g[k] - w[k]))
            spread = max(float(np.linalg.norm(m[li][k] - w[k]))
                         for m in d["moved"])
            lim = max(1e-2 * float(np.linalg.norm(w[k])),
                      SPREAD_FACTOR * spread)
            assert err <= lim, (li, k, err, spread)
    m0 = np.abs(d["got"][0][1] - d["want"][0][1]).max()
    assert m0 <= 2e-2 * np.abs(d["want"][0][1]).max(), m0


@pytest.fixture(scope="module", params=[0, 3], ids=lambda k: f"aux{k}")
def loss_pair(request):
    """The JAX set loss and its gradients (the path its training
    differentiates) at QCFG with `query_aux_topk` 0 or 3, their spread
    under two 1e-4 moves of the weights, and the port's on the same
    weights, frames and ground truth."""
    jc, tc = _cfgs("qcfg", query_aux_topk=request.param)
    p = JD.init_detector(jax.random.PRNGKey(1), jc)
    imgs, gt = _gt_batch(np.random.default_rng(1), 4, 8, 64)
    jimgs, jgt = jnp.asarray(imgs), _jgt(gt)
    with jax_train_path():
        vg = jax.jit(jax.value_and_grad(
            lambda q: JD.detector_loss(q, jimgs, jgt, jc)[0]))
        loss, grads = vg(p)
        moved = [vg(perturbed(p, s)) for s in SPREAD_MOVES]
    want = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np32(m).astype(np.float64) - w))
                   for m in ms) for w, ms in zip(want, zip(*(
                       jax.tree_util.tree_leaves(mv[1]) for mv in moved)))]
    tp = from_jax(p, "cpu")
    tl, aux, tg = value_and_grad(
        lambda q: TD.detector_loss(q, torch.from_numpy(imgs), _tgt(gt), tc),
        tp)
    got = [np32(x) for x in jax.tree_util.tree_leaves(to_numpy(tg))]
    return dict(loss=float(loss), got_loss=float(tl), aux=aux,
                loss_spread=max(abs(float(m[0]) - float(loss))
                                for m in moved),
                want=want, got=got, spreads=spreads, names=leaf_names(p))


def test_loss_within_the_jax_spread(loss_pair):
    """Measured: 0.0077 (aux 0) and 0.0070 (aux 3) apart at 10.95, the
    JAX package's own spread 0.0198 / 0.0194 (4 moves)."""
    p = loss_pair
    assert np.isfinite(p["got_loss"])
    assert abs(p["got_loss"] - p["loss"]) <= max(
        1e-4 * abs(p["loss"]), SPREAD_FACTOR * p["loss_spread"]), p
    assert int(p["aux"]["layers"]) == 4


def test_every_leaf_gradient_within_the_jax_spread(loss_pair):
    """Each leaf's gradient within 5e-2 of its norm or 3x the JAX spread
    (measured: at most 1.8x the spread over 4 moves, on the last decoder
    layer's self-attention)."""
    p = loss_pair
    assert len(p["got"]) == len(p["want"]) == len(p["names"]) == 184
    errs = gradient_errors(p["got"], p["want"], p["spreads"], 5e-2,
                           SPREAD_FACTOR)
    bad = [(n, e, lim) for n, (e, lim) in zip(p["names"], errs) if e > lim]
    assert not bad, bad
    for n, g, w in zip(p["names"], p["got"], p["want"]):
        assert g.shape == w.shape, n
        assert np.all(np.isfinite(g)), n


@jax.jit
def _jax_cost(cls, mlog, gt_cls, valid, gm):
    """The matching cost of the JAX package's `_set_loss_one` (its first
    lines, which return nothing else): [Q, G], 1e4 at padded columns."""
    qn, gn = cls.shape[0], gt_cls.shape[0]
    p = jax.nn.sigmoid(mlog.reshape(qn, -1))
    g = gm.reshape(gn, -1)
    npix = p.shape[1]
    logp, log1p = jnp.log(p + 1e-6), jnp.log(1.0 - p + 1e-6)
    bce = -(logp @ g.T + log1p @ (1.0 - g).T) / npix
    dice = 1.0 - (2.0 * (p @ g.T) + 1.0) / (
        p.sum(-1)[:, None] + g.sum(-1)[None, :] + 1.0)
    cost = (JQ._W_CLS * -jax.nn.softmax(cls, axis=-1)[:, gt_cls]
            + JQ._W_BCE * bce + JQ._W_DICE * dice)
    return jnp.where(valid[None, :], cost, 1e4)


@pytest.mark.parametrize("aux_topk", [0, 3])
def test_loss_on_handed_matching_costs(aux_topk):
    """`match_cost` hands the JAX package's cost matrix to the matching
    (the loss reads its own costs): the matched queries equal the JAX
    function's, and the loss equals its loss within float32 rounding,
    also where two queries' costs are a float32 ulp apart."""
    cls, mlog, gt_cls, valid, gm = _handed_logits(11)
    mlog[5] = mlog[4]  # two queries of (nearly) equal cost for every gt
    cls[5] = cls[4]
    args = [jnp.asarray(x) for x in (cls, mlog, gt_cls, valid, gm)]
    jl, jm = jax.jit(functools.partial(
        JQ._set_loss_one, no_obj_w=0.1, num_classes=6,
        aux_topk=aux_topk))(*args)
    jcost = np.asarray(_jax_cost(*args))
    tl, tm = TQ.set_loss_one(
        *[torch.from_numpy(x) for x in (cls, mlog, gt_cls, valid, gm)],
        0.1, 6, aux_topk=aux_topk, match_cost=jcost)
    np.testing.assert_array_equal(np32(tm), np32(jm))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_forward_matches_jax_by_matched_share(decoded):
    """The whole forward (serving, no gradient) on the JAX package's
    weights: the detections the two packages keep, matched by class and
    box IoU >= 0.5, at least 3/4 of the JAX package's; the contract's
    shapes and the full-frame paste."""
    d = decoded
    jc = dataclasses.replace(d["jc"], score_threshold=0.0)
    tc = dataclasses.replace(d["tc"], score_threshold=0.0)
    with jax_kernel_path():
        want = JD.forward(d["p"], jnp.asarray(d["imgs"]), jc)
    got = TD.forward(from_jax(d["p"], "cpu"), torch.from_numpy(d["imgs"]),
                     tc)
    n = jc.max_detections
    assert got.boxes.shape == (2, n, 4) and got.boxes.dtype == torch.float32
    assert got.masks.shape == (2, n, jc.mask_size, jc.mask_size)
    assert got.logits.shape == (2, n, jc.num_classes)
    fm = TD.full_masks(got, jc.image_size)
    assert fm.shape == (2, n, 64, 64)
    gv, wv = np32(got.valid), np32(want.valid)
    assert wv.sum() >= 4
    from embodied_captioning_tpu_torch.ops.detections import pairwise_iou

    hit = 0
    for b in range(2):
        iou = np32(pairwise_iou(t(want.boxes[b]), got.boxes[b]))
        same = np32(want.classes[b])[:, None] == np32(got.classes[b])[None]
        ok = (iou >= 0.5) & same & gv[b][None] & wv[b][:, None]
        hit += int(ok.any(1).sum())
    assert hit >= 0.75 * wv.sum(), (hit, wv.sum())


@pytest.mark.parametrize("aux_topk,ratio", [(0, 0.7), (3, 0.75)])
def test_training_learns_as_the_jax_test_asks(aux_topk, ratio):
    """tests/test_query_detector.py's learning checks on the port: 40 Adam
    steps (3e-4, no clipping) from the JAX package's weights on its scene
    of two boxes a frame bring the loss under 0.7 (Hungarian everywhere)
    or 0.75 (aux top-3) of its start."""
    from embodied_captioning_tpu_torch.train.optim import (
        adam_init, adam_update)

    jc, tc = _cfgs("qcfg", query_aux_topk=aux_topk)
    p = from_jax(JD.init_detector(jax.random.PRNGKey(1), jc), "cpu")
    imgs, gt = _gt_batch(np.random.default_rng(1), 4, 8, 64)
    images, tgt = torch.from_numpy(imgs), _tgt(gt)
    opt, losses = adam_init(p), []
    for _ in range(40):
        loss, _, g = value_and_grad(
            lambda q: TD.detector_loss(q, images, tgt, tc), p)
        p, opt = adam_update(p, opt, g, 3e-4, float("inf"))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * ratio, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# init, heads, refusals, the attention gate
# ---------------------------------------------------------------------------

def test_init_shapes_match_jax_and_reinit_heads():
    jc, tc = _cfgs("qcfg")
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    tp = TD.init_detector(torch.Generator().manual_seed(0), tc, "cpu")
    assert "rpn_conv" not in tp and "query_embed" in tp
    assert leaf_names(tp) == leaf_names(p)
    want = [np.shape(x) for x in jax.tree_util.tree_leaves(p)]
    got = [x.shape for x in jax.tree_util.tree_leaves(to_numpy(tp))]
    assert got == want
    # the scales: queries and level embeddings 0.02, the class head 0.01
    assert abs(float(tp["query_embed"].std()) - 0.02) < 4e-3
    assert abs(float(tp["cls"]["w"].std()) - 0.01) < 2e-3
    out = TD.reinit_heads(tp, torch.Generator().manual_seed(1), tc)
    assert out["cls"]["w"].shape == (64, 7)
    assert not torch.equal(out["cls"]["w"], tp["cls"]["w"])
    assert not torch.equal(out["mask_fc1"]["w"], tp["mask_fc1"]["w"])
    assert out["stem"]["w"] is tp["stem"]["w"]
    assert out["layers"] is tp["layers"]
    jout = JD.reinit_heads(p, jax.random.PRNGKey(1), jc)
    assert set(out) == set(jout)


def test_refusals_carry_the_jax_messages():
    jc, tc = _cfgs("qcfg")
    tp = TD.init_detector(torch.Generator().manual_seed(0), tc, "cpu")
    acfg = dataclasses.replace(tc, norm="affine")
    with pytest.raises(ValueError, match="rcnn family"):
        TD.fold_affine(tp, acfg)
    with pytest.raises(ValueError, match="rcnn family"):
        TD.forward_mc(tp, torch.zeros(1, 64, 64, 3, dtype=torch.uint8), tc)
    with pytest.raises(ValueError, match="rcnn family"):
        TD.calibrate_affine(tp, [], tc)
    imgs, gt = _gt_batch(np.random.default_rng(2), 1, 8, 64)
    with pytest.raises(ValueError, match="head='ce'"):
        TD.detector_loss(tp, torch.from_numpy(imgs), _tgt(gt), tc,
                         head="focal")
    with pytest.raises(ValueError, match="gt.masks required"):
        TD.detector_loss(tp, torch.from_numpy(imgs),
                         _tgt(gt).replace(masks=None), tc)
    for over, what in ((dict(query_aux_topk=17), "query_aux_topk"),
                       (dict(num_queries=4), "num_queries"),
                       (dict(fpn_dim=60), "divisible")):
        with pytest.raises(ValueError, match=what):
            TD.init_detector(torch.Generator(),
                             dataclasses.replace(tc, **over), "cpu")
        with pytest.raises(ValueError, match=what):
            JD.init_detector(jax.random.PRNGKey(0),
                             dataclasses.replace(jc, **over))


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("t_len", [16, 64])
def test_flash_twin_at_the_query_head_dims_matches_the_pallas_kernel(
        d, t_len):
    """The flash kernel's plain twin at head dims 8 and 16 (the query
    decoder's, with its 16 and 64 queries) against the TPU single-block
    kernel in interpret mode: within one bf16 ulp at |o| ~ 1, as at the
    ViT's head dims (test_torch_kernels.py)."""
    from embodied_captioning_tpu.ops.pallas.flash_attention import (
        flash_attention as j_flash)
    from embodied_captioning_tpu_torch import kernels as K

    rng = np.random.default_rng(d + t_len)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 8, t_len, d)),
                           jnp.bfloat16) for _ in range(3))
    ref = j_flash(q, k, v, interpret=True)
    out = K.flash_attention(t(q), t(k), t(v))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, t_len, d)
    np.testing.assert_allclose(np32(out), np32(ref), atol=1e-2, rtol=0)


@pytest.mark.parametrize("d", [4, 8, 16, 12, 32])
def test_attention_gate_by_head_dim(d, monkeypatch):
    """`mha`'s unmasked self-attention takes the flash kernel (its CPU twin
    here) where `flash_attention_fits`: head dims 8 and 16 (the query
    decoder's) beside 32/64/128; 4 and 12 take the plain attention, as
    the JAX dispatcher sends d % 8 != 0 to XLA."""
    calls = []
    real = TC.flash_attention
    monkeypatch.setattr(TC, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    heads = 8
    g = torch.Generator().manual_seed(d)
    p = TC.mha_init(g, d * heads, None, "cpu")
    x = torch.randn(2, 16, d * heads, generator=g)
    with torch.no_grad():
        out, _ = TC.mha(p, x, heads)
    fits = d in (8, 16, 32)
    assert TC.flash_attention_fits(d) == fits
    assert bool(calls) == fits
    assert out.shape == (2, 16, d * heads) and torch.isfinite(
        out.float()).all()
