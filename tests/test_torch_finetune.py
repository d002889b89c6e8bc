"""The captioner fine-tune slice against the JAX package at the tiny
preset, on the CPU, with the JAX package on its default path (the path
its `train_step` differentiates: ECAP_USE_PALLAS unset).

- The preprocess: at the fine-tune's crops (already at the ViT's input
  size) the port's fused-preprocess twin equals the JAX package's unfused
  `preprocess_for_vit` bit for bit, so nothing is handed across.
- `caption_loss` and its two parts, the gradient of every leaf (limits
  from the JAX package's own spread, ROADMAP C.20), `triplet_loss_hard`,
  and the parameters after one `train_step` within 2 lr an element.
- `labeling.datasets` on stores written by either package.
- The entry point: its JSON line beside the JAX script's, and its pickle
  loaded by both packages.
"""

import contextlib
import importlib.util
import io
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.config import CaptionerConfig as JCfg
from embodied_captioning_tpu.labeling import datasets as JDS
from embodied_captioning_tpu.models import captioner as JCap
from embodied_captioning_tpu.ops.image import preprocess_for_vit as jpre
from embodied_captioning_tpu.train import captioner_train as JT
from embodied_captioning_tpu.utils import obs_store as JOS
from embodied_captioning_tpu_torch import finetune_captioner
from embodied_captioning_tpu_torch.config import CaptionerConfig as TCfg
from embodied_captioning_tpu_torch.labeling import datasets as TDS
from embodied_captioning_tpu_torch.models import captioner as TCap
from embodied_captioning_tpu_torch.ops.image import preprocess_for_vit
from embodied_captioning_tpu_torch.params import from_jax, load_pickle
from embodied_captioning_tpu_torch.train import captioner_train as TT
from embodied_captioning_tpu_torch.train.optim import tree_leaves
from embodied_captioning_tpu_torch.utils import obs_store as TOS
from torch_parity import (
    gradient_errors, jax_train_path, leaf_names, np32, perturbed,
)

REPO = Path(__file__).resolve().parents[1]
B = 4
LR = 1e-3
TRIPLET = 0.1


def _batch(seed: int, cfg):
    """uint8 crops at the ViT's input size (as the entry point makes
    them), tokens BOS .. EOS of lengths 6-15 padded with 0, object ids
    with one repeated pair (so the triplet loss has a positive)."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    imgs = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    toks = np.zeros((B, cfg.text.context_length), np.int32)
    for i in range(B):
        n = 5 + 3 * i
        toks[i, 0] = cfg.text.bos_id
        toks[i, 1:n] = rng.integers(3, cfg.text.vocab_size, n - 1)
        toks[i, n] = cfg.text.eos_id
    return imgs, toks, np.array([7, 7, 9, 11], np.int32), np.ones(B, bool)


def _jax_loss(params, imgs, toks, ids, valid, cfg):
    """The JAX train_step's loss_fn at triplet weight TRIPLET."""
    total, aux = JCap.caption_loss(params, imgs, toks, cfg)
    _, img_emb, _ = JCap.forward(params, imgs, toks, cfg)
    tl = JT.triplet_loss_hard(img_emb, ids, valid)
    return total + TRIPLET * tl, dict(aux, triplet=tl)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's loss, parts and gradients at its seeded tiny
    parameters, the same at two points moved by 1e-4 of themselves (their
    spread sets the limits), and one train_step."""
    jcfg = JCfg.tiny()
    params = JCap.init_captioner(jax.random.PRNGKey(0), jcfg)
    batch = _batch(0, jcfg)
    jb = [jnp.asarray(x) for x in batch]
    with jax_train_path():
        vg = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss(p, *jb, jcfg), has_aux=True))
        (loss, aux), grads = vg(params)
        moved = [vg(perturbed(params, s)) for s in (1, 2)]
        state = JT.create_train_state(jax.tree_util.tree_map(jnp.copy, params),
                                      lr=LR)
        state, step_aux = JT.train_step(state, *jb, jcfg, lr=LR,
                                        triplet_weight=TRIPLET)
    flat = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - w))
                   for m in ms) for w, ms in zip(flat, zip(*(
                       [np32(g) for g in jax.tree_util.tree_leaves(mv[1])]
                       for mv in moved)))]
    parts = {k: float(v) for k, v in dict(aux, loss=loss).items()}
    part_spread = {k: max(abs(float(dict(mv[0][1], loss=mv[0][0])[k])
                              - parts[k]) for mv in moved) for k in parts}
    return dict(cfg=jcfg, params=params, batch=batch, parts=parts,
                part_spread=part_spread, grads=flat, spreads=spreads,
                after=[np32(x) for x in jax.tree_util.tree_leaves(
                    state.params)],
                step_aux={k: float(v) for k, v in step_aux.items()})


@pytest.fixture(scope="module")
def port(ref):
    tcfg = TCfg.tiny()
    params = from_jax(ref["params"], "cpu")
    batch = [torch.from_numpy(x) for x in ref["batch"]]
    grads, loss, aux = TT.loss_and_grads(params, *batch, tcfg, TRIPLET)
    return dict(cfg=tcfg, params=params, batch=batch, grads=grads,
                parts={k: float(v) for k, v in dict(aux, loss=loss).items()})


def test_preprocess_twin_equals_jax_at_the_crop_size(ref):
    imgs = ref["batch"][0]
    v = ref["cfg"].vision
    np.testing.assert_array_equal(
        preprocess_for_vit(torch.from_numpy(imgs), v.image_size,
                           v.patch_size).numpy(),
        np.asarray(jpre(jnp.asarray(imgs), v.image_size, v.patch_size)))


def test_caption_loss_and_parts_match_jax(ref, port):
    """Each part within the larger of 1e-3 of its value and 3x how far
    the JAX package's own part moves when the parameters move by 1e-4 of
    themselves (bf16 embeddings: the contrastive part reads the
    normalised image and text embeddings of 4 rows)."""
    for k in ("loss", "caption_ce", "contrastive", "triplet"):
        want, got = ref["parts"][k], port["parts"][k]
        lim = max(1e-3 * abs(want), 3 * ref["part_spread"][k])
        assert abs(got - want) <= lim, (k, got, want, lim)
    # caption_loss itself (no triplet) is the first two parts
    with torch.no_grad():
        total, aux = TCap.caption_loss(port["params"], *port["batch"][:2],
                                       port["cfg"])
    assert set(aux) == {"caption_ce", "contrastive"}
    np.testing.assert_allclose(
        float(total), 2 * float(aux["caption_ce"]) + float(aux["contrastive"]),
        rtol=1e-6)


def test_every_leaf_gradient_matches_jax(ref, port):
    """Every leaf within the larger of 5% of its norm and 3x the JAX
    package's own spread (C.20). The leaves whose gradients are rounding
    noise (the key biases, whose gradient is zero in exact arithmetic; the
    multimodal cross-attention's query, key and ln_x, whose keys, the
    pooled image tokens of a random-weight pooler, are nearly equal) move
    by 1.2-2.4x their own norm in the JAX package itself, so only the
    spread bounds them."""
    names = leaf_names(port["params"])
    got = [np32(g) for g in tree_leaves(port["grads"])]
    assert len(got) == len(ref["grads"]) == len(names)
    errs = gradient_errors(got, ref["grads"], ref["spreads"], 5e-2, 3.0)
    bad = [(n, e, lim) for n, (e, lim) in zip(names, errs) if e > lim]
    assert not bad, bad
    # the gradient reaches every leaf, through every LayerNorm and every
    # attention: a non-zero JAX gradient is non-zero here
    for n, g, w in zip(names, got, ref["grads"]):
        if np.any(w):
            assert np.any(g) and np.all(np.isfinite(g)), n


def test_triplet_loss_hard_matches_jax():
    """Float32 embeddings, repeated ids, an invalid row, a row without a
    positive: loss and gradient to float32 rounding."""
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((8, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = np.array([1, 1, 2, 2, 2, 3, 4, 4], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    jl, jg = jax.value_and_grad(JT.triplet_loss_hard)(
        jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(valid))
    te = torch.from_numpy(emb).requires_grad_(True)
    tl = TT.triplet_loss_hard(te, torch.from_numpy(ids),
                              torch.from_numpy(valid))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), atol=1e-6)


def _clip_scale(leaves) -> float:
    """clip_by_global_norm(1.0)'s factor for these gradients."""
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in leaves))
    return 1.0 if norm < TT.MAX_GRAD_NORM else TT.MAX_GRAD_NORM / norm


def test_train_step_matches_jax(ref, port):
    """One step of clip-by-global-norm then AdamW (decay 0.01): the first
    Adam step moves each element by lr times the sign of its gradient
    (plus the decay), so a gradient whose sign differs moves it 2 lr the
    other way; every element within 2 lr (1 + 0.01 |p|), and the loss as
    the loss test holds it. Where both clipped gradients have one sign and
    are at least 1e-4 (so Adam's eps moves the step by under 1e-4 of
    itself) the two steps are the same but for rounding: those elements
    (a third of them here) within 1e-4 lr + 2^-21 (|p| + lr), which a
    wrong decay (lr 0.01 |p|) oversteps by 17x where |p| = 1."""
    state = TT.create_train_state(port["params"])
    new, aux = TT.train_step(state, *port["batch"], port["cfg"], lr=LR,
                             triplet_weight=TRIPLET)
    assert new.step == 1 and new.opt_state.count == 1
    assert set(aux) == {"caption_ce", "contrastive", "triplet", "loss"}
    worst, moved = 0.0, 0
    for p0, p1, want in zip(tree_leaves(port["params"]),
                            tree_leaves(new.params), ref["after"]):
        d = np.abs(np32(p1) - want)
        lim = 2 * LR * (1 + 0.01 * np.abs(np32(p0))) + 1e-7
        worst = max(worst, float((d / lim).max()))
        moved += int(np.any(np32(p1) != np32(p0)))
    assert worst <= 1.0, worst
    assert moved == len(ref["after"])
    got_g = [np32(g) for g in tree_leaves(port["grads"])]
    ca, cb = _clip_scale(got_g), _clip_scale(ref["grads"])
    tight, n_same, n_large = 0.0, 0, 0
    for p0, p1, want, ga, gb in zip(tree_leaves(port["params"]),
                                    tree_leaves(new.params), ref["after"],
                                    got_g, ref["grads"]):
        ga, gb = ga * ca, gb * cb
        same = (np.sign(ga) == np.sign(gb)) & (
            np.minimum(np.abs(ga), np.abs(gb)) >= 1e-4)
        p0 = np32(p0)
        d = np.abs(np32(p1) - want)[same]
        lim = 1e-4 * LR + 2.0 ** -21 * (np.abs(p0[same]) + LR)
        if d.size:
            tight = max(tight, float((d / lim).max()))
        n_same += int(same.sum())
        n_large += int((np.abs(p0[same]) >= 0.5).sum())
    assert tight <= 1.0, tight
    # a quarter of the elements, among them the LayerNorm gains (|p| = 1)
    # where the decay is largest
    total = sum(x.size for x in ref["after"])
    assert n_same >= total // 4 and n_large >= 100, (n_same, n_large, total)
    lim = max(1e-3 * abs(ref["step_aux"]["loss"]),
              3 * ref["part_spread"]["loss"])
    assert abs(float(aux["loss"]) - ref["step_aux"]["loss"]) <= lim


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_matches_optax(clipped):
    """The update `train_step` applies (`adam_update` with the reference's
    decay and clip norm) against the JAX package's `make_optimizer(lr)`,
    optax's clip_by_global_norm(1.0) then adamw(lr, weight_decay=0.01), on
    the same gradients for three steps, with the norm below and above 1:
    to two float32 ulps. Parameters of order 1, so the decay (lr 0.01 |p|
    a step) is 20x the limit: a missing, doubled or flipped decay fails."""
    from embodied_captioning_tpu_torch.train.optim import adam_update

    rng = np.random.default_rng(12)
    shapes = {"a": (64, 32), "b": (32,), "c": {"d": (5, 7), "e": (3,)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    opt = JT.make_optimizer(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = from_jax(params, "cpu")
    state = TT.create_train_state(tp).opt_state
    scale = 1.0 if clipped else 1e-4
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * scale,
            params)
        norm = np.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                           for x in jax.tree_util.tree_leaves(g)))
        assert (norm >= TT.MAX_GRAD_NORM) == clipped
        updates, jstate = opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, state = adam_update(tp, state, from_jax(g, "cpu"), LR,
                                TT.MAX_GRAD_NORM,
                                weight_decay=TT.WEIGHT_DECAY)
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2 ** -21, atol=1e-6 * LR)


# ---------------------------------------------------------------------------
# the datasets and the entry point on recorded stores
# ---------------------------------------------------------------------------

CAPTIONS = ("a red couch", "a wooden table", "a green plant")


def _write_store(store, root: str, episodes=(0, 1), steps=3, size=48):
    """rgb, depth, position and bbs observations: three boxes a frame,
    the last invalid; captions on the bbs payload; object ids repeat
    across steps (the triplet loss's positives)."""
    from embodied_captioning_tpu_torch.config import NUM_CLASSES

    for ep in episodes:
        rng = np.random.default_rng(ep)
        for step in range(steps):
            boxes = np.array([[2, 3, 20, 25], [24, 10, 46, 40],
                              [5, 5, 9, 9]], np.float32) + step
            det = {"boxes": boxes, "classes": np.array([1, 3, 0], np.int32),
                   "logits": np.eye(NUM_CLASSES,
                                    dtype=np.float32)[[1, 3, 0]],
                   "scores": np.array([0.9, 0.8, 0.1], np.float32),
                   "valid": np.array([True, True, False]),
                   "masks": (rng.random((3, 12, 12)) > 0.5).astype(
                       np.float32),
                   "object_ids": np.array([100 + ep, 200 + ep, 300],
                                          np.int64),
                   "captions": np.array(CAPTIONS, dtype=object)}
            obs = {"rgb": rng.integers(0, 256, (size, size, 3),
                                       dtype=np.uint8),
                   "depth": rng.uniform(0.5, 4, (size, size)).astype(
                       np.float32),
                   "position": np.array({"position": rng.uniform(0, 3, 3),
                                         "orientation": np.array(
                                             [1.0, 0, 0, 0])}, dtype=object),
                   "bbs": np.array({"instances": det}, dtype=object)}
            store.save_obs(root, ep, obs, step)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_datasets_match_jax_on_either_store(tmp_path, writer):
    _write_store(TOS if writer == "port" else JOS, str(tmp_path))
    for kw in ({}, {"with_depth_pose": True}, {"transform": "bbs_crop"}):
        ours = TDS.EpisodeDetectionDataset(str(tmp_path), **kw)
        want = JDS.EpisodeDetectionDataset(str(tmp_path), **kw)
        assert ours.index == want.index and len(ours) == 6
        assert ours._find_cam(1, "bbs") == want._find_cam(1, "bbs")
        got_s = [ours[i] for i in range(len(ours))]
        want_s = [want[i] for i in range(len(want))]
        for a, b in zip(got_s, want_s):
            for f in ("image", "boxes", "classes", "logits", "masks",
                      "valid", "object_ids", "depth", "pose"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f)
            assert (a.episode, a.step, a.camera) == (b.episode, b.step,
                                                     b.camera)
        if not kw.get("transform"):
            got_c, want_c = TDS.collate(got_s), JDS.collate(want_s)
            assert set(got_c) == set(want_c)
            for k in got_c:
                np.testing.assert_array_equal(got_c[k], want_c[k], err_msg=k)
    seq = TDS.SequentialEpisodeDataset(TDS.EpisodeDetectionDataset(
        str(tmp_path)), window=2)
    jseq = JDS.SequentialEpisodeDataset(JDS.EpisodeDetectionDataset(
        str(tmp_path)), window=2)
    assert seq.windows == jseq.windows and len(seq) == 4
    assert [s.step for s in seq[1]] == [s.step for s in jseq[1]]
    got_b = list(TDS.EpisodeDetectionDataset(str(tmp_path)).batches(
        2, shuffle=True, seed=3))
    want_b = list(JDS.EpisodeDetectionDataset(str(tmp_path)).batches(
        2, shuffle=True, seed=3))
    assert len(got_b) == len(want_b) == 3
    for a, b in zip(got_b, want_b):
        np.testing.assert_array_equal(a["image"], b["image"])


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_finetune_captioner", REPO / "scripts" / "finetune_captioner.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """The port's entry point and the JAX script on one store written by
    the port (the fine-tune reads what `generate` writes), 2 epochs of
    batch 4, `pseudo_captions.json` the repository's ({}), so the
    captions come from the store."""
    root = tmp_path_factory.mktemp("finetune")
    store = str(root / "obs")
    _write_store(TOS, store)
    args = [store, "--pseudo-captions", str(REPO / "pseudo_captions.json"),
            "--preset", "tiny", "--epochs", "2", "--batch", "4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = finetune_captioner.main(args + ["--save", str(root / "t.pkl"),
                                             "--device", "cpu"])
    port_line = _last_json(buf.getvalue())
    buf = io.StringIO()
    with jax_train_path(), pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", ["finetune_captioner.py"] + args + [
            "--save", str(root / "j.pkl")])
        _jax_script().main()
    return dict(rc=rc, port=port_line, jax=_last_json(buf.getvalue()),
                root=root)


def test_entry_point_json_line_matches_the_jax_script(entry_runs):
    """The same pairs (2 valid boxes a frame, 6 frames) and steps; losses
    finite (the two start from different seeded inits: jax.random and
    torch's generator never agree)."""
    got, want = entry_runs["port"], entry_runs["jax"]
    assert entry_runs["rc"] == 0
    assert set(got) == set(want) == {"pairs", "steps", "first_loss",
                                     "last_loss", "saved"}
    assert got["pairs"] == want["pairs"] == 12
    assert got["steps"] == want["steps"] == 6
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
    assert got["saved"] == str(entry_runs["root"] / "t.pkl")


def test_entry_point_pickles_load_in_both_packages(entry_runs):
    """The port's pickle is a numpy tree the JAX package trains and
    evaluates as its own parameters, and the JAX script's loads in the
    port: on either file both packages' caption_loss agree (the loss
    test's 1e-3)."""
    jcfg, tcfg = JCfg.tiny(), TCfg.tiny()
    batch = _batch(1, jcfg)
    for name in ("t.pkl", "j.pkl"):
        path = str(entry_runs["root"] / name)
        with open(path, "rb") as fh:
            tree = pickle.load(fh)
        assert all(isinstance(x, np.ndarray)
                   for x in jax.tree_util.tree_leaves(tree))
        with jax_train_path():
            want = float(JCap.caption_loss(
                jax.tree_util.tree_map(jnp.asarray, tree),
                *(jnp.asarray(x) for x in batch[:2]), jcfg)[0])
        with torch.no_grad():
            got = float(TCap.caption_loss(
                from_jax(load_pickle(path), "cpu"),
                *(torch.from_numpy(x) for x in batch[:2]), tcfg)[0])
        assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want), (
            name, got, want)


def test_entry_point_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_captioner.main([str(tmp_path)])
