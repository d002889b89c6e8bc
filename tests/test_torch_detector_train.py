"""The detector's training slice against the JAX package at the tiny
preset, on the CPU: box targets, the losses and their gradients for the
ce, focal and soft ROI heads with and without masks (softfocal and
msefocal: test_torch_detector_heads.py), dropout on a handed keep-mask, the
backbone's max-pool gradient at ties, one clip-plus-Adam step, the
serving-prep helpers and the warmup-cosine step size.

Limits: the loss parts within the larger of 1e-4 of their value and 3x how
far the JAX package's own part moves when the parameters move by 1e-4 of
themselves; every leaf's gradient within the larger of 5% of its norm and
3x that spread (the backbone's bf16 convolutions: the JAX package's own
gradients move by 5-19% of their norm under such a move, the port sits
0.5-1% from them, ROADMAP C.20's method).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JCfg
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu_torch.config import DetectorConfig as TCfg
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.train.optim import (
    adam_init, adam_update, tree_leaves, value_and_grad,
    warmup_cosine_decay_schedule,
)
from torch_parity import gradient_errors, leaf_names, np32, perturbed

HEADS = ("ce", "focal", "soft", "softfocal", "msefocal")
# the heads whose JAX gradients this file compiles; the other two compile
# in test_torch_detector_heads.py, on another worker
HERE = HEADS[:3]
B, G, S = 2, 8, 64
LR = 1e-3


def _ground_truth(seed: int, mask_size: int = S) -> dict:
    """G boxes a frame inside the 64^2 image, 80% valid, classes 0-5,
    teacher probabilities, and box-shaped {0,1} masks at `mask_size`."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, S - 12, (B, G))
    y1 = rng.uniform(0, S - 12, (B, G))
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(6, 30, (B, G)), S),
                      np.minimum(y1 + rng.uniform(6, 30, (B, G)), S)],
                     -1).astype(np.float32)
    masks = np.zeros((B, G, mask_size, mask_size), np.uint8)
    k = mask_size / S
    for i in range(B):
        for j in range(G):
            x0, y0, x2, y2 = (boxes[i, j] * k).astype(int)
            masks[i, j, y0:y2, x0:x2] = 1
    return dict(boxes=boxes, classes=rng.integers(0, 6, (B, G)).astype(
                    np.int32),
                scores=np.ones((B, G), np.float32),
                logits=rng.dirichlet(np.ones(6), (B, G)).astype(np.float32),
                valid=rng.random((B, G)) < 0.8, masks=masks)


def _jax_gt(gt: dict, masks: bool) -> JDet:
    return JDet(**{k: jnp.asarray(v) for k, v in gt.items()
                   if masks or k != "masks"})


def _port_gt(gt: dict, masks: bool) -> TDet:
    return TDet(**{k: torch.from_numpy(np.array(v)) for k, v in gt.items()
                   if masks or k != "masks"})


def _images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (B, S, S, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def base():
    return dict(params=JD.init_detector(jax.random.PRNGKey(0), JCfg.tiny()),
                images=_images(), gt=_ground_truth(1), pairs={})


def _port_loss_grads(params, images, gt, head):
    tp = from_jax(params, "cpu")
    loss, aux, grads = value_and_grad(lambda p: TD.detector_loss(
        p, torch.from_numpy(images), gt, TCfg.tiny(), head=head), tp)
    # gradients in the JAX layout (conv kernels HWIO), leaf by leaf
    flat = [np32(x) for x in jax.tree_util.tree_leaves(to_numpy(grads))]
    return tp, float(loss), {k: float(v) for k, v in aux.items()}, flat


def _pair(base, head: str, masks: bool) -> dict:
    """The JAX loss, parts and gradients (and their spread under two
    1e-4 moves of the parameters) beside the port's, computed once per
    (head, masks) and kept in `base`."""
    key = (head, masks)
    if key in base["pairs"]:
        return base["pairs"][key]
    cfg = JCfg.tiny()
    jgt = _jax_gt(base["gt"], masks)
    imgs = jnp.asarray(base["images"])
    vg = jax.jit(jax.value_and_grad(
        lambda p: JD.detector_loss(p, imgs, jgt, cfg, head=head),
        has_aux=True))
    (loss, aux), grads = vg(base["params"])
    moved = [vg(perturbed(base["params"], s)) for s in (1, 2)]
    want = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np32(m).astype(np.float64) - w))
                   for m in ms) for w, ms in zip(want, zip(*(
                       jax.tree_util.tree_leaves(mv[1]) for mv in moved)))]
    parts = {k: float(v) for k, v in dict(aux, loss=loss).items()}
    part_spread = {k: max(abs(float(dict(mv[0][1], loss=mv[0][0])[k])
                              - parts[k]) for mv in moved) for k in parts}
    tp, tl, taux, got = _port_loss_grads(base["params"], base["images"],
                                         _port_gt(base["gt"], masks), head)
    base["pairs"][key] = dict(
        head=head, masks=masks, parts=parts, part_spread=part_spread,
        want=want, spreads=spreads, got=got, got_parts=dict(taux, loss=tl),
        names=leaf_names(tp), jgrads=grads)
    return base["pairs"][key]


@pytest.fixture(scope="module", params=[(h, m) for h in HERE
                                        for m in (True, False)],
                ids=lambda p: f"{p[0]}-{'masks' if p[1] else 'nomasks'}")
def loss_pair(request, base):
    return _pair(base, *request.param)


def test_loss_and_parts_match_jax(loss_pair):
    p = loss_pair
    assert set(p["got_parts"]) == set(p["parts"]) == {
        "loss", "rpn_obj", "rpn_box", "roi_cls", "roi_box", "mask"}
    for k, want in p["parts"].items():
        lim = max(1e-4 * abs(want), 3 * p["part_spread"][k])
        assert abs(p["got_parts"][k] - want) <= lim, (k, p["got_parts"][k],
                                                      want, lim)
    assert (p["parts"]["mask"] > 0) == p["masks"]


def test_every_leaf_gradient_matches_jax(loss_pair):
    p = loss_pair
    assert len(p["got"]) == len(p["want"]) == len(p["names"])
    errs = gradient_errors(p["got"], p["want"], p["spreads"], 5e-2, 3.0)
    bad = [(n, e, lim) for n, (e, lim) in zip(p["names"], errs) if e > lim]
    assert not bad, bad
    for n, g, w in zip(p["names"], p["got"], p["want"]):
        assert g.shape == w.shape, n
        assert (np.any(g) == np.any(w)) and np.all(np.isfinite(g)), n


def test_one_clip_adam_step_matches_optax(base):
    """optax.chain(clip_by_global_norm(5), adam(lr)) on the JAX gradients
    of the ce head with masks against the port's `adam_update` on its own:
    the first Adam step moves an element by lr times its gradient's sign,
    so every element within 2 lr."""
    loss_pair = _pair(base, "ce", True)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(LR))
    upd, _ = opt.update(loss_pair["jgrads"], opt.init(base["params"]),
                        base["params"])
    want = jax.tree_util.tree_leaves(optax.apply_updates(base["params"], upd))
    tp = from_jax(base["params"], "cpu")
    grads = from_jax(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(base["params"]), loss_pair["got"]),
        "cpu")
    new, state = adam_update(tp, adam_init(tp), grads, LR, 5.0)
    assert state.count == 1
    got = jax.tree_util.tree_leaves(to_numpy(new))
    for n, a, w in zip(loss_pair["names"], got, want):
        assert np.abs(a - np32(w)).max() <= 2 * LR + 1e-7, n


def test_dropout_on_a_handed_keep_mask_matches_jax(base):
    """The box head's dropout with the JAX package's own draws handed
    across (its per-image split keys), and the port's own draw from a
    torch.Generator: kept at the rate asked for, and reproducible."""
    cfg, rate, key = JCfg.tiny(), 0.5, jax.random.PRNGKey(7)
    jgt = _jax_gt(base["gt"], True)
    loss, aux = jax.jit(lambda p: JD.detector_loss(
        p, jnp.asarray(base["images"]), jgt, cfg, dropout_rng=key,
        dropout_rate=rate))(base["params"])
    keep = np.stack([np.asarray(jax.random.bernoulli(k, 1 - rate, (
        cfg.num_proposals, 1024))) for k in jax.random.split(key, B)])
    tp = from_jax(base["params"], "cpu")
    tgt = _port_gt(base["gt"], True)
    with torch.no_grad():
        tl, taux = TD.detector_loss(tp, torch.from_numpy(base["images"]), tgt,
                                    TCfg.tiny(), dropout_rate=rate,
                                    dropout_keep=torch.from_numpy(keep))
        plain, _ = TD.detector_loss(tp, torch.from_numpy(base["images"]),
                                    tgt, TCfg.tiny())
    # fc1's bf16 outputs sit a bf16 ulp apart on some units, as without
    # dropout, and the 1 / (1 - rate) scale doubles them: measured 1.5e-4
    # and 1.6e-4 of the two parts; a mask shifted by one unit is 0.22 and
    # 0.69 off
    for k in ("roi_cls", "roi_box"):
        assert abs(float(taux[k]) - float(aux[k])) <= 1e-3 * abs(
            float(aux[k])), k
    assert float(tl) != float(plain)
    inter = [TD._intermediates(tp, torch.from_numpy(base["images"]) / 255.0,
                               TCfg.tiny(), dropout_rate=rate,
                               generator=torch.Generator().manual_seed(s))
             for s in (3, 3, 4)]
    assert torch.equal(inter[0].class_logits, inter[1].class_logits)
    assert not torch.equal(inter[0].class_logits, inter[2].class_logits)


def test_proposals_take_the_ground_truth_and_carry_no_gradient(base):
    """The last G proposals are the ground-truth boxes with their validity
    (float32 after the splice, as JAX promotes the bf16 proposals), and
    autograd reaches no proposal."""
    tp = from_jax(base["params"], "cpu")
    gt = _port_gt(base["gt"], True)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    inter = TD._intermediates(tp, torch.from_numpy(base["images"]) / 255.0,
                              TCfg.tiny(), gt.boxes, gt.valid)
    assert inter.proposals.dtype == torch.float32
    assert not inter.proposals.requires_grad
    assert torch.equal(inter.proposals[:, -G:], gt.boxes)
    assert torch.equal(inter.proposal_valid[:, -G:], gt.valid)
    assert inter.class_logits.requires_grad


def test_detector_loss_refuses_the_query_family(base):
    """The query family's set loss (tests/test_torch_query_detector.py)
    refuses what the JAX package's refuses, with its messages: a head
    other than ce, and ground truth without masks."""
    cfg = dataclasses.replace(TCfg.tiny(), family="query")
    qp = TD.init_detector(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="head='ce'"):
        TD.detector_loss(qp, torch.from_numpy(base["images"]),
                         _port_gt(base["gt"], True), cfg, head="focal")
    with pytest.raises(ValueError, match="gt.masks required"):
        TD.detector_loss(qp, torch.from_numpy(base["images"]),
                         _port_gt(base["gt"], False), cfg)


def test_max_pool_gradient_at_ties_matches_jax():
    """`lax.reduce_window`'s gradient goes to the first maximum of each
    window; ReLU output ties at 0 everywhere. The port's pool gives the
    JAX package's gradient exactly (integer cotangents, exact sums), and a
    chain of `torch.maximum` (which shares a tie's gradient) does not."""
    rng = np.random.default_rng(0)
    x = np.maximum(np.round(rng.standard_normal((2, 9, 10, 4)) * 2) / 2, 0)
    x = x.astype(np.float32)
    assert (x == 0).mean() > 0.4
    w = rng.integers(1, 4, (2, 5, 5, 4)).astype(np.float32)

    def jax_pool(v):
        v = v.astype(jnp.bfloat16)
        y = jax.lax.reduce_window(v, v.dtype.type(-jnp.inf), jax.lax.max,
                                  (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        return jnp.sum(y.astype(jnp.float32) * w)

    want = np.asarray(jax.grad(jax_pool)(jnp.asarray(x)))

    def chain(v, k=3, s=2):  # the port's pool before this slice
        ph, pw = TD._same_pads(v.shape[1], k, s), TD._same_pads(v.shape[2],
                                                                k, s)
        v = torch.nn.functional.pad(v, (0, 0, pw[0], pw[1], ph[0], ph[1]),
                                    value=float("-inf"))
        oh, ow = (v.shape[1] - k) // s + 1, (v.shape[2] - k) // s + 1
        out = None
        for dy in range(k):
            for dx in range(k):
                win = v[:, dy:dy + s * (oh - 1) + 1:s,
                        dx:dx + s * (ow - 1) + 1:s]
                out = win if out is None else torch.maximum(out, win)
        return out

    for pool, equal in ((lambda v: TD._max_pool_same(v, 3, 2), True),
                        (chain, False)):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = pool(xt.to(torch.bfloat16))
        (y.float() * torch.from_numpy(w)).sum().backward()
        assert np.array_equal(xt.grad.numpy(), want) == equal


def test_encode_boxes_matches_jax():
    """RPN and ROI weights, boxes thinner than the 1e-3 floor included:
    within float32 rounding (the logs' last bit)."""
    rng = np.random.default_rng(2)
    a = np.asarray(JD.all_anchors(S, (4, 8)))
    boxes = rng.uniform(0, S, (len(a), 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(0, 20, (len(a), 2))
    boxes[::7, 2] = boxes[::7, 0]  # zero width: the floor
    for wts in (JD.RPN_BOX_WEIGHTS, JD.ROI_BOX_WEIGHTS):
        want = np.asarray(JD.encode_boxes(jnp.asarray(a), jnp.asarray(boxes),
                                          wts))
        got = TD.encode_boxes(torch.from_numpy(a), torch.from_numpy(boxes),
                              wts).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    # leading dims broadcast: one anchor set against [B, A, 4] boxes
    got_b = TD.encode_boxes(torch.from_numpy(a),
                            torch.from_numpy(np.stack([boxes] * 2)))
    np.testing.assert_array_equal(got_b[1].numpy(), got_b[0].numpy())


def test_smooth_l1_and_focal_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 0.2, 64), rng.normal(0, 3, 64),
                        [0.0, 1 / 9, -1 / 9]]).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda v: jnp.sum(JD._smooth_l1(v)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = TD._smooth_l1(xt).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), atol=1e-6)
    probs = rng.dirichlet(np.ones(7), 32).astype(np.float32)
    probs[0] = np.eye(7)[2]  # a zero probability: the clip at 1e-8
    tgt = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 32)]
    soft = rng.dirichlet(np.ones(7), 32).astype(np.float32)
    for t in (tgt, soft):
        jv, jg = jax.value_and_grad(lambda p: jnp.sum(JD._focal(
            p, jnp.asarray(t))))(jnp.asarray(probs))
        pt = torch.from_numpy(probs).requires_grad_(True)
        tv = TD._focal(pt, torch.from_numpy(t)).sum()
        tv.backward()
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def test_forward_without_masks_is_forward_less_the_mask_head(base):
    tp = from_jax(base["params"], "cpu")
    cfg = dataclasses.replace(TCfg.tiny(), score_threshold=0.0)
    imgs = torch.from_numpy(base["images"])
    a = TD.forward(tp, imgs, cfg)
    b = TD.forward(tp, imgs, cfg, with_masks=False)
    for f in ("boxes", "classes", "scores", "logits", "valid"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert b.masks.shape == a.masks.shape and not b.masks.any()
    assert a.valid.any()


def test_reinit_heads_structure_and_scales(base):
    """The JAX package's tree structure and shapes; fresh cls, box and
    mask_out at their init scales (0.01, 0.001, He for the 1x1 conv),
    zero biases; every other leaf the same tensor."""
    cfg = JCfg.tiny()
    want = JD.reinit_heads(base["params"], jax.random.PRNGKey(1), cfg)
    tp = from_jax(base["params"], "cpu")
    got = TD.reinit_heads(tp, torch.Generator().manual_seed(1), TCfg.tiny())
    assert leaf_names(got) == leaf_names(from_jax(want, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == np.shape(b)
    for k in tp:
        if k not in ("cls", "box", "mask_out"):
            assert got[k] is tp[k]
    for k, scale in (("cls", 0.01), ("box", 0.001),
                     ("mask_out", np.sqrt(2.0 / cfg.fpn_dim))):
        w = got[k]["w"]
        assert abs(float(w.std()) / scale - 1) < 0.15, k
        assert not torch.equal(w, tp[k]["w"]) and not got[k]["b"].any()
    again = TD.reinit_heads(tp, torch.Generator().manual_seed(1), TCfg.tiny())
    assert torch.equal(again["cls"]["w"], got["cls"]["w"])
    # the query family's heads: class and mask embedding, the rest kept
    qcfg = dataclasses.replace(TCfg.tiny(), family="query")
    qp = TD.init_detector(torch.Generator().manual_seed(0), qcfg, "cpu")
    qgot = TD.reinit_heads(qp, torch.Generator().manual_seed(1), qcfg)
    for k in qp:
        fresh = k in ("cls", "mask_fc1", "mask_fc2")
        assert (qgot[k] is qp[k]) != fresh, k


def test_project_features_matches_jax(base):
    """bf16 products: within one bf16 ulp of the unit-norm outputs."""
    feats = np.random.default_rng(4).standard_normal((B, 16, 1024)).astype(
        np.float32)
    want = np32(JD.project_features(base["params"], jnp.asarray(feats)))
    got = np32(TD.project_features(from_jax(base["params"], "cpu"),
                                   torch.from_numpy(feats)))
    assert got.shape == want.shape == (B, 16, 128)
    np.testing.assert_allclose(got, want, atol=2 ** -8)


def _affine_params(seed: int):
    """Tiny bottleneck detector with norm="affine" and random norm
    parameters (so the fold has something to fold)."""
    jc = dataclasses.replace(JCfg.tiny(), norm="affine")
    p = JD.init_detector(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)

    def node(path):
        n = p
        for k in path:
            n = n[k]
        return n

    for path in JD._norm_sites(p):
        site = node(path)
        c = site["g"].shape[0]
        site["g"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
        site["b"] = jnp.asarray(rng.normal(0, 0.1, c), jnp.float32)
    return jc, p


def test_fold_affine_matches_jax():
    jc, p = _affine_params(3)
    tc = dataclasses.replace(TCfg.tiny(), norm="affine")
    tp = from_jax(p, "cpu")
    assert TD._norm_sites(tp) == JD._norm_sites(p)
    want = jax.tree_util.tree_leaves(JD.fold_affine(p, jc))
    got = jax.tree_util.tree_leaves(to_numpy(TD.fold_affine(tp, tc)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the folded detector serves the same detections (up to the bf16
    # rounding the fold moves: a weight rounded after the product)
    imgs = torch.from_numpy(_images(5))
    tc0 = dataclasses.replace(tc, score_threshold=0.0)
    a = TD.forward(tp, imgs, tc0)
    b = TD.forward(TD.fold_affine(tp, tc), imgs, tc0)
    assert (a.classes == b.classes).float().mean() >= 0.8
    from embodied_captioning_tpu_torch.models.quantize import quantize_params
    with pytest.raises(ValueError):
        TD.fold_affine(quantize_params(tp, min_size=0), tc)
    with pytest.raises(ValueError):
        TD.fold_affine(tp, TCfg.tiny())


def test_calibrate_affine_matches_jax(base):
    """Two calibration batches through the GroupNorm detector: every leaf
    of the calibrated tree against the JAX package's, within the larger of
    1e-4 of the leaf's largest value (plus 1e-5) and 3x how far the JAX
    package's own leaf moves when the parameters move by 1e-4 of
    themselves. The backbone sites' statistics are float32 means summed in
    another order (measured within 1.3e-4 of the largest value); the mask
    head's read the detections' bf16 boxes (C.7), so those sites sit up to
    1.0e-3 apart while the JAX package's own move by 2.1e-3-1.3e-2."""
    cfg = dataclasses.replace(JCfg.tiny(), score_threshold=0.0)
    tc = dataclasses.replace(TCfg.tiny(), score_threshold=0.0)
    batches = [_images(6), _images(7)]
    jb = [jnp.asarray(x) for x in batches]
    want = JD.calibrate_affine(base["params"], jb, cfg)
    moved = [JD.calibrate_affine(perturbed(base["params"], s), jb, cfg)
             for s in (1, 2)]
    got = TD.calibrate_affine(from_jax(base["params"], "cpu"),
                              [torch.from_numpy(x) for x in batches], tc)
    names = leaf_names(got)
    leaves = [jax.tree_util.tree_leaves(t) for t in (to_numpy(got), want,
                                                     *moved)]
    for n, a, w, m1, m2 in zip(names, *leaves):
        w = np.asarray(w)
        spread = max(np.abs(np.asarray(m) - w).max() for m in (m1, m2))
        lim = max(1e-4 * np.abs(w).max() + 1e-5, 3 * spread)
        assert np.abs(a - w).max() <= lim, (n, np.abs(a - w).max(), lim)
    # the calibrated weights serve under the affine norm
    det = TD.forward(got, torch.from_numpy(batches[0]),
                     dataclasses.replace(tc, norm="affine"))
    assert torch.isfinite(det.scores).all()
    with pytest.raises(ValueError):
        TD.calibrate_affine(got, [], dataclasses.replace(tc, norm="affine"))


@pytest.mark.parametrize("lr,steps", [(1e-3, 300), (3e-4, 700), (2e-3, 9)])
def test_warmup_cosine_schedule_matches_optax(lr, steps):
    """The detector self-check's `--lr-schedule cosine` against optax's
    warmup_cosine_decay_schedule at every count: within 2^-21 of the peak
    (XLA's float32 cosine and its contraction of the ramp into a fused
    multiply-add move the last bits: measured at most 1.94e-7 of the
    peak)."""
    warm = min(500, steps // 10)
    want_fn = jax.jit(optax.warmup_cosine_decay_schedule(0.0, lr, warm,
                                                         steps, lr / 20))
    got_fn = warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr / 20)
    counts = list(range(0, steps + 3, max(1, steps // 97)))
    want = np.array([float(want_fn(jnp.int32(c))) for c in counts])
    got = np.array([got_fn(c) for c in counts])
    assert np.abs(got - want).max() <= 2.0 ** -21 * lr
    assert got[0] == 0.0 or warm == 0
    np.testing.assert_allclose(got[-1], lr / 20, rtol=1e-6)
