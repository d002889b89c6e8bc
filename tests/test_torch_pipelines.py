"""The port's teacher-student detector pipelines (`train/pipelines.py`)
against the JAX package's, on the CPU at the tiny preset: the EMA, SWA
and mixup helpers and the three step-size schedules; one
`TeacherStudent` and `OnlineTeacherStudent` step on handed weights;
`validate`; one `run_round` of each pipeline on a store of the JAX
package's loop; the saved pipelines in both packages; and the
`train_detector` entry point beside `scripts/train_detector.py`.

The student's gradients are bf16 and chaotic (ROADMAP C.20, as in
test_torch_detector_train.py): the limits below come from measured
spreads, each stated beside its limit.
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.config import NUM_CLASSES as JNUM
from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.labeling import datasets as JDS
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu.train import pipelines as JP
from embodied_captioning_tpu_torch import train_detector
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.labeling import datasets as TDS
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.perception import Perceiver
from embodied_captioning_tpu_torch.train import optim as TO
from embodied_captioning_tpu_torch.train import pipelines as TP
from torch_parity import STORE_OVERRIDES, jax_store

REPO = Path(__file__).resolve().parents[1]
LR = 1e-4  # TeacherStudent's default step size
# Adam moves an element by at most lr in its first step and 1.0013 lr in
# its second (the bias-corrected moments' ratio, by Cauchy-Schwarz), plus
# the decay's lr * 1e-4 * |p|: two trajectories part by at most 2 of that
ADAM_STEP = 1.0014 * LR


def _leaves(tree) -> list:
    """The leaves of a JAX tree or of a port tree (in the JAX layout),
    as numpy, in the JAX tree's order."""
    if any(isinstance(x, torch.Tensor) for x in TO.tree_leaves(tree)):
        tree = to_numpy(tree)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def trees():
    """Three seeded tiny detector trees (JAX) and the port's copies."""
    cfg = jload_config("tiny").detector
    js = [JD.init_detector(jax.random.PRNGKey(s), cfg) for s in (0, 1, 2)]
    return js, [from_jax(t, "cpu") for t in js]


@pytest.mark.parametrize("decay", [0.996, 0.5, 0.9])
def test_ema_update_equals_jax_bit_for_bit(trees, decay):
    js, ts = trees
    want = _leaves(JP.ema_update(js[0], js[1], decay))
    got = _leaves(TP.ema_update(ts[0], ts[1], decay))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_swa_average_equals_jax_bit_for_bit(trees, n):
    """The sum in order, then a true division by n (no reciprocal
    product)."""
    js, ts = trees
    want = _leaves(JP.swa_average(js[:n]))
    got = _leaves(TP.swa_average(ts[:n]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if n == 3:
        x = torch.tensor([1.0, 2.0, 0.7, 1e-3])
        assert torch.equal(TP.swa_average([{"w": x}] * 3)["w"],
                           (x + x + x) / torch.tensor(3.0))


def _batch(n=2, size=48, rng=None):
    """tests/test_pipelines.py's synthetic labelled batch."""
    rng = rng or np.random.default_rng(0)
    return {
        "image": (rng.random((n, size, size, 3)) * 255).astype(np.uint8),
        "boxes": np.tile(np.array([[4, 4, 20, 20], [26, 26, 44, 44],
                                   [0, 0, 0, 0], [0, 0, 0, 0]], np.float32),
                         (n, 1, 1)),
        "classes": np.tile(np.array([1, 3, 0, 0], np.int32), (n, 1)),
        "logits": np.tile(np.eye(JNUM, dtype=np.float32)[[1, 3, 0, 0]],
                          (n, 1, 1)),
        "valid": np.tile(np.array([True, True, False, False]), (n, 1)),
        "object_ids": np.tile(np.array([5, 6, -1, -1]), (n, 1)),
        "episode": np.zeros(n, np.int64),
        "step": np.arange(n),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_batch_equals_jax(seed):
    """The same numpy draws and arithmetic: every field equal; the union
    keeps at least each frame's own slots."""
    b = _batch(n=4, rng=np.random.default_rng(seed))
    b["valid"][1, 1] = False
    want = JP.mixup_batch(b, np.random.default_rng(seed))
    got = TP.mixup_batch(b, np.random.default_rng(seed))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert (got["valid"].sum(1) >= b["valid"].sum(1)).all()


@pytest.mark.parametrize("total", [100, 7, 1000])
def test_lr_schedules_equal_jax(total):
    """constant and step at every count around both boundaries of `step`
    and the ends of the warmup: equal float32; cosine within 2^-21 of the
    peak (test_torch_detector_train.py's limit for the same schedule: XLA's
    float32 cosine moves the last bits)."""
    lr = 1e-3
    assert TP.make_lr_schedule("constant", lr) == JP.make_lr_schedule(
        "constant", lr) == lr
    warm = min(10, total - 1)
    for kind in ("cosine", "step"):
        want = JP.make_lr_schedule(kind, lr, warm, total)
        got = TP.make_lr_schedule(kind, lr, warm, total)
        counts = sorted({c for b in (0, warm, total // 2, (3 * total) // 4,
                                     total) for c in range(b - 2, b + 3)
                         if c >= 0})
        for c in counts:
            if kind == "step":
                assert np.float32(got(c)) == np.float32(want(c)), c
            else:
                assert abs(got(c) - float(want(c))) <= 2.0 ** -21 * lr, c
    step = TP.make_lr_schedule("step", lr, total_steps=100)
    assert step(49) == float(np.float32(lr))
    assert step(50) == pytest.approx(1e-4) and step(75) == pytest.approx(1e-5)
    with pytest.raises(ValueError):
        TP.make_lr_schedule("nope")


def test_piecewise_constant_schedule_equals_optax():
    for bounds in ({3: 0.5, 7: 0.25}, {5: 0.1}, {2: 0.0, 4: 3.0}, None):
        want = optax.piecewise_constant_schedule(0.3, bounds)
        got = TO.piecewise_constant_schedule(0.3, bounds)
        for c in range(10):
            assert got(c) == float(want(c)), (bounds, c)
    with pytest.raises(ValueError):
        TO.piecewise_constant_schedule(1.0, {3: -1.0})


# ---------------------------------------------------------------------------
# TeacherStudent and OnlineTeacherStudent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_perceiver():
    from embodied_captioning_tpu.perception import Perceiver as JPer

    return JPer(jload_config("tiny"))


def _port_perceiver(jper, overrides=()):
    """The JAX perceiver's weights in a port perceiver of the tiny preset
    with `overrides` (the perceiver detects at its own config's
    threshold)."""
    return Perceiver(load_config("tiny", overrides=list(overrides)),
                     params=from_jax(jper.params, "cpu"), device="cpu")


def _pair(cls_name, head, jper):
    """The JAX package's TeacherStudent of `cls_name` (its seeded student)
    and the port's on the same weights and perceiver."""
    jts = getattr(JP, cls_name)(jload_config("tiny"), consensus="vanilla",
                                head=head)
    tts = getattr(TP, cls_name)(
        load_config("tiny"), consensus="vanilla", head=head, device="cpu",
        student_params=from_jax(jts.student, "cpu"),
        perceiver=_port_perceiver(jper))
    return jts, tts


def test_to_detector_scale_equals_jax(jax_perceiver):
    """The resized images (clip, then a truncating uint8 cast) and the
    scaled boxes (the factors in double, then float32): equal bits."""
    jts, tts = _pair("TeacherStudent", "ce", jax_perceiver)
    for size in (48, 80, 64):
        b = _batch(size=size, rng=np.random.default_rng(size))
        b["boxes"] = b["boxes"] * (size / 48) + np.float32(0.37)
        ji, jb = jts._to_detector_scale(b)
        ti, tb = tts._to_detector_scale(b)
        assert ti.dtype == torch.uint8 and tb.dtype == torch.float32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# measured on tests/test_pipelines.py's batch (CPU): the JAX package's
# own loss parts move by up to 6.9e-3 of themselves when its weights move
# by 1e-4 of themselves (bf16 convolutions; rpn_obj), and the port sits at
# most 3.4e-3 from it (roi_box; its other parts 1.3e-4 to 2.3e-3); the
# first step of a run_round at most 6.9e-4 (rpn_box, online)
PART_RTOL, PART_ATOL = 1e-2, 1e-4
# later steps of a run_round: after one Adam step the bf16 gradients'
# flipped signs have moved the two students apart (measured: the loss
# 4.7e-2 of itself, a part 9.2e-2, both rpn_obj, online)
LATER_LOSS_RTOL, LATER_PART_RTOL = 0.1, 0.2
# What the steps did, against the JAX package's (train/optim.update_gaps,
# relative_gap), measured on the four training-step cases and the four
# pipelines' rounds (CPU; `python tests/torch_parity.py update-gaps
# STORE_DIR` prints them), and what a faulty port reads:
#   after one step: the elements moved alike >= 0.99856 of those moved
#   (decay 0.01 in place of 1e-4: 0.37-0.52; a negated gradient: < 0.002);
#   the decay estimate within 2.9e-4 of 0 (decay 0.01: 9.9e-3); Adam's
#   moments within 6.2e-3 (a negated gradient: 2.0)
AGREE_1, DECAY_ATOL, MOMENTS_1 = 0.99, 2e-3, 0.02
#   after two steps: the steps counted alike (a state reset every step
#   counts 1); moved alike >= 0.974 (decay 0.01: <= 0.68, a reset:
#   0.83-0.91); the moments within 0.226 (a reset: >= 0.499 for the first)
AGREE_2, MOMENTS_2 = 0.95, 0.35


def _adam_state(ts):
    """(count, mu leaves, nu leaves) of a teacher-student's optimizer, in
    the JAX tree's order."""
    if hasattr(ts.opt_state, "mu"):
        st = ts.opt_state
    else:  # optax: (clip, (scale_by_adam, add_decayed_weights, scale))
        st = ts.opt_state[1][0]
    return int(st.count), _leaves(st.mu), _leaves(st.nu)


def _update_faults(before, jts, tts, steps: int) -> list:
    """What the port's `steps` optimizer steps from `before` did that the
    JAX package's did not, past the limits above."""
    gaps = TO.update_gaps(before, _leaves(tts.student), _leaves(jts.student),
                          LR)
    (jc, jmu, jnu), (tc, tmu, tnu) = _adam_state(jts), _adam_state(tts)
    mom = max(TO.relative_gap(tmu, jmu), TO.relative_gap(tnu, jnu))
    bad = []
    if tc != jc or tc != steps:
        bad.append(("count", tc, jc))
    if steps == 1:
        if not gaps["agree"] >= AGREE_1:
            bad.append(("agree", gaps["agree"]))
        if not abs(gaps["decay"]) <= DECAY_ATOL:
            bad.append(("decay", gaps["decay"]))
        if not mom <= MOMENTS_1:
            bad.append(("moments", mom))
    else:
        if not gaps["agree"] >= AGREE_2:
            bad.append(("agree", gaps["agree"]))
        if not mom <= MOMENTS_2:
            bad.append(("moments", mom))
    for a, b in zip(_leaves(tts.student), _leaves(jts.student)):
        if not np.abs(a - b).max() <= 2 * ADAM_STEP * steps:
            bad.append(("params", float(np.abs(a - b).max())))
            break
    return bad


def _two_steps(cls_name, head, jper) -> dict:
    """Two steps of both packages' `cls_name` on tests/test_pipelines.py's
    batch, then on a second draw of it: the loss parts of the first and
    the faults after each."""
    jts, tts = _pair(cls_name, head, jper)
    before = _leaves(tts.student)
    want = jts.training_step(_batch())
    got = tts.training_step(_batch())
    faults = [_update_faults(before, jts, tts, 1)]
    second = _batch(rng=np.random.default_rng(1))
    jts.training_step(second)
    tts.training_step(second)
    faults.append(_update_faults(before, jts, tts, 2))
    return dict(jts=jts, tts=tts, before=before, got=got, want=want,
                faults=faults)


@pytest.mark.parametrize("cls_name,head", [
    ("TeacherStudent", "ce"), ("TeacherStudent", "focal"),
    ("OnlineTeacherStudent", "ce"), ("OnlineTeacherStudent", "focal")])
def test_training_step_matches_jax(jax_perceiver, cls_name, head):
    """Two steps on tests/test_pipelines.py's batches (the online form on
    the teacher's own detections): the first step's loss and its five
    parts within PART_RTOL; after each step, what the update did held to
    the JAX package's (the share of elements moved alike, the decay
    applied, Adam's moments and step count; every parameter within 2
    ADAM_STEP a step: a flipped sign of a rounding-level gradient); the
    student moved, the teacher did not."""
    r = _two_steps(cls_name, head, jax_perceiver)
    got, want, tts = r["got"], r["want"], r["tts"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= max(PART_RTOL * abs(want[k]),
                                            PART_ATOL), (k, got[k], want[k])
    assert r["faults"] == [[], []]
    assert any(not np.array_equal(a, b) for a, b in zip(
        _leaves(tts.student), r["before"]))
    for a, b in zip(_leaves(tts.teacher), r["before"]):
        np.testing.assert_array_equal(a, b)
    # the labeler's perceiver detects with the teacher
    assert tts.labeler.perceiver.params.detector is tts.teacher


def _negated(update):
    def step(params, opt, grads, *a, **k):
        return update(params, opt, TO.tree_map(lambda g: -g, grads), *a, **k)
    return step


def _reset(update):
    def step(params, opt, grads, *a, **k):
        return update(params, TO.adam_init(params), grads, *a, **k)
    return step


@pytest.mark.parametrize("fault", ["decay_0.01", "reset_state",
                                   "negated_gradient"])
def test_update_checks_catch_a_faulty_step(jax_perceiver, fault):
    """The checks of test_training_step_matches_jax on a port made wrong
    on purpose: the captioner's AdamW decay (0.01) in place of optax's
    default (1e-4), the optimizer's state reset before every step, the
    gradient negated. Each is caught, and by the step that shows it."""
    with pytest.MonkeyPatch.context() as mp:
        if fault == "decay_0.01":
            mp.setattr(TP, "WEIGHT_DECAY", 0.01)
        elif fault == "reset_state":
            mp.setattr(TP, "adam_update", _reset(TP.adam_update))
        else:
            mp.setattr(TP, "adam_update", _negated(TP.adam_update))
        r = _two_steps("TeacherStudent", "focal", jax_perceiver)
    first, second = r["faults"]
    if fault == "reset_state":  # a first step is the same either way
        assert first == [] and "count" in [f[0] for f in second]
    else:
        assert {"agree"} <= {f[0] for f in first}, first
        assert second


def test_teacher_updates_equal_jax(jax_perceiver):
    """`update_teacher_ema` and `replace_teacher` on the same trees: equal
    bits; the perceiver follows the teacher."""
    jts, tts = _pair("TeacherStudent", "ce", jax_perceiver)
    k = jax.random.PRNGKey(4)
    jts.student = JD.init_detector(k, jload_config("tiny").detector)
    tts.student = from_jax(jts.student, "cpu")
    jts.update_teacher_ema(decay=0.5)
    tts.update_teacher_ema(decay=0.5)
    for a, b in zip(_leaves(tts.teacher), _leaves(jts.teacher)):
        np.testing.assert_array_equal(a, b)
    assert tts.labeler.perceiver.params.detector is tts.teacher
    tts.replace_teacher()
    for a, b in zip(_leaves(tts.teacher), _leaves(tts.student)):
        np.testing.assert_array_equal(a, b)
    assert tts.teacher["stem"]["w"] is not tts.student["stem"]["w"]


# ---------------------------------------------------------------------------
# a store of the JAX package's loop; validate; run_round; save / load
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """8 frames of the JAX package's loop (its labels the random detector's
    detections), with `bbsgt` files beside them for the GT pipeline: each
    frame's labels as ground truth, its boxes moved by a quarter pixel."""
    root = tmp_path_factory.mktemp("pipelines")
    path = str(root / "obs")
    jax_store(path)
    for f in glob.glob(os.path.join(path, "*", "*modality_bbs_id_*.npz")):
        d = np.load(f, allow_pickle=True)["arr_0"].item()
        inst = dict(d["instances"])
        inst["boxes"] = np.asarray(inst["boxes"], np.float32) + 0.25
        name = f.replace("modality_bbs_id_3", "modality_bbsgt_id_4")
        np.savez_compressed(name, np.array({"instances": inst},
                                           dtype=object))
    return path


def test_validate_matches_jax_on_handed_detections(store, jax_perceiver):
    """`validate` on the store's labels, with the same detections handed
    to both packages in place of the student's forward: each label's box
    moved by up to 3 pixels at each corner and rounded to bf16, plus
    strays, so that some IoUs fall near 0.5: equal mAP above 0, bf16 boxes
    scored as the JAX package scores them (ROADMAP C.25)."""
    jts, tts = _pair("TeacherStudent", "ce", jax_perceiver)
    rng = np.random.default_rng(0)
    tds = TDS.EpisodeDetectionDataset(store)
    preds = []
    for batch in tds.batches(4):
        b, n = batch["boxes"].shape[:2]
        boxes = batch["boxes"] + rng.uniform(-3, 3, (b, n, 4))
        stray = rng.random((b, n)) < 0.3
        boxes[stray] = rng.uniform(0, 40, (int(stray.sum()), 4)) + [0, 0,
                                                                   20, 20]
        preds.append(dict(
            boxes=boxes.astype(np.float32), classes=batch["classes"],
            scores=rng.uniform(0, 1, (b, n)).astype(np.float32),
            logits=np.zeros((b, n, 6), np.float32),
            valid=batch["valid"] | stray))
    assert sum(int(p["valid"].sum()) for p in preds) >= 4

    def fake(jax_side):
        calls = iter(preds)

        def forward(p, im, c, with_masks=True):
            d = next(calls)
            if jax_side:
                d = {k: jnp.asarray(v) for k, v in d.items()}
                return JDet(**dict(d, boxes=d["boxes"].astype(jnp.bfloat16)))
            d = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            return TDet(**dict(d, boxes=d["boxes"].to(torch.bfloat16)))

        return forward

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "forward", fake(True))
        want = jts.validate(JDS.EpisodeDetectionDataset(store), batch_size=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "forward", fake(False))
        got = tts.validate(tds, batch_size=4)
    assert got == want and want["val_map_50"] > 0
    # and on the student's own forward (near 0 at random weights)
    got = tts.validate(tds, batch_size=4)
    assert set(got) == {"val_map_50"} and 0.0 <= got["val_map_50"] <= 1.0


@pytest.fixture(scope="module")
def rounds(store, jax_perceiver, tmp_path_factory):
    """One `run_round` of each pipeline on the store, in both packages: the
    JAX package's seeded student handed to the port (its `init_detector`
    patched), the JAX perceiver's weights in the port's labeler."""
    out = {}
    tmp = tmp_path_factory.mktemp("rounds")
    for name in ("Pipeline", "OnlinePipeline", "GTPipeline", "SWAPipeline"):
        kw = dict(consensus="soft", head="focal")
        if name == "SWAPipeline":
            kw["snapshot_every"] = 1
        jpipe = getattr(JP, name)(jload_config("tiny", overrides=
                                               STORE_OVERRIDES), **kw)
        jlogs = jpipe.run_round(store)
        params = jax.tree_util.tree_map(np.asarray,
                                        JD.init_detector(jax.random.split(
                                            jax.random.PRNGKey(0))[0],
                                            jpipe.cfg.detector))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TD, "init_detector",
                       lambda g, cfg, dev: from_jax(params, dev))
            tpipe = getattr(TP, name)(
                load_config("tiny", overrides=STORE_OVERRIDES), device="cpu",
                perceiver=_port_perceiver(jax_perceiver, STORE_OVERRIDES),
                **kw)
        tlogs = tpipe.run_round(store)
        jpipe.save(str(tmp / f"{name}_j.pkl"))
        tpipe.save(str(tmp / f"{name}_t.pkl"))
        out[name] = dict(jpipe=jpipe, tpipe=tpipe, jlogs=jlogs, tlogs=tlogs,
                         before=_leaves(params),
                         jpath=tmp / f"{name}_j.pkl",
                         tpath=tmp / f"{name}_t.pkl")
    return out


@pytest.mark.parametrize("name", ["Pipeline", "OnlinePipeline", "GTPipeline",
                                  "SWAPipeline"])
def test_run_round_matches_jax(rounds, name):
    """The same number of steps with the same keys; the first step's loss
    and parts within PART_RTOL (its targets: the JAX package's labels where
    the two perceivers' detections agree, its own where a box moved by a
    bf16 ulp), every later step's within LATER_*_RTOL; after the round,
    what the steps did held to the JAX package's as in
    test_training_step_matches_jax (measured: moved alike >= 0.9846, the
    moments within 0.144; every parameter within 2.7e-4 to 3.8e-4 after 2
    steps, a sign flipped on both), and the teacher is the student
    (replaced)."""
    r = rounds[name]
    assert len(r["tlogs"]) == len(r["jlogs"]) >= 2
    for i, (got, want) in enumerate(zip(r["tlogs"], r["jlogs"])):
        assert sorted(got) == sorted(want)
        for k in want:
            rtol = (PART_RTOL if i == 0 else LATER_LOSS_RTOL if k == "loss"
                    else LATER_PART_RTOL)
            assert abs(got[k] - want[k]) <= max(rtol * abs(want[k]),
                                                PART_ATOL), (i, k, got, want)
    ts, jts = r["tpipe"].ts, r["jpipe"].ts
    assert _update_faults(r["before"], jts, ts, len(r["jlogs"])) == []
    for a, b in zip(_leaves(ts.teacher), _leaves(ts.student)):
        np.testing.assert_array_equal(a, b)


def test_saved_pipelines_load_in_both_packages(rounds):
    """The port's pickle: numpy trees in the JAX layout that the JAX
    package loads and runs; the JAX package's loads into the port."""
    r = rounds["Pipeline"]
    with open(r["tpath"], "rb") as fh:
        t = jax.tree_util.tree_map(np.asarray, __import__("pickle").load(fh))
    with open(r["jpath"], "rb") as fh:
        j = __import__("pickle").load(fh)
    assert sorted(t) == sorted(j) == ["student", "teacher"]
    for k in t:
        a, b = jax.tree_util.tree_leaves(t[k]), jax.tree_util.tree_leaves(j[k])
        assert [x.shape for x in a] == [np.shape(x) for x in b]
    r["jpipe"].load(str(r["tpath"]))
    det = JD.forward(r["jpipe"].ts.student, jnp.zeros((1, 64, 64, 3),
                                                      jnp.uint8),
                     r["jpipe"].cfg.detector)
    assert det.boxes.shape[0] == 1
    r["tpipe"].load(str(r["jpath"]))
    for a, b in zip(_leaves(r["tpipe"].ts.student), jax.tree_util.tree_leaves(
            j["student"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert r["tpipe"].ts.labeler.perceiver.params.detector is \
        r["tpipe"].ts.teacher


def test_round_generates_a_missing_store(tmp_path):
    """`collect_pseudolabeled_dataset` runs the trainer (its perceiver the
    labeler's) where the store is missing, then labels it."""
    cfg = load_config("tiny", overrides=STORE_OVERRIDES)
    pipe = TP.Pipeline(cfg, consensus="vanilla", device="cpu")
    obs = str(tmp_path / "new")
    labeled = pipe.collect_pseudolabeled_dataset(obs, num_steps=4)
    assert len(os.listdir(obs)) == 2 and len(labeled) == 8
    assert pipe.fit_student([], 1) == []
    assert TP.Pipeline._batch_starts(3, 4) == ([0], 3)
    assert TP.Pipeline._batch_starts(9, 4) == ([0, 4], 4)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, jax_side: bool):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    return rc, lines[:-1], json.loads(lines[-1])


def test_entry_point_matches_jax_script(store, rounds, tmp_path):
    """`train_detector` beside `scripts/train_detector.py` on the store:
    the same round lines' form and JSON line (keys, types, rounds,
    train_steps, the keys of `last`), the JAX package's seeded student on
    both sides; the saved pickle loads in the JAX package."""
    argv = ["--obs-dir", store, "--pipeline", "default", "--consensus",
            "soft", "--head", "focal"] + STORE_OVERRIDES
    jrc, jrounds, want = _run(_script("train_detector").main, argv + [
        "--save", str(tmp_path / "j.pkl")], True)
    params = jax.tree_util.tree_map(np.asarray, rounds["Pipeline"][
        "jpipe"].ts.teacher)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "init_detector",
                   lambda g, cfg, dev: from_jax(params, dev))
        rc, trounds, got = _run(train_detector.main, argv + [
            "--save", str(tmp_path / "t.pkl")], False)
    assert rc == 0 and jrc is None
    assert set(got) == set(want) == {"rounds", "train_steps", "last",
                                     "saved"}
    assert got["rounds"] == want["rounds"] == 1
    assert got["train_steps"] == want["train_steps"] >= 2
    assert sorted(got["last"]) == sorted(want["last"])
    assert all(isinstance(v, float) for v in got["last"].values())
    assert [ln.split(",")[0] for ln in trounds if ln.startswith("[round")] \
        == [ln.split(",")[0] for ln in jrounds if ln.startswith("[round")]
    with open(tmp_path / "t.pkl", "rb") as fh:
        saved = __import__("pickle").load(fh)
    JD.forward(jax.tree_util.tree_map(jnp.asarray, saved["teacher"]),
               jnp.zeros((1, 64, 64, 3), jnp.uint8),
               jload_config("tiny").detector)


def test_entry_point_needs_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_detector.main(["--obs-dir", str(tmp_path)]) == 2
