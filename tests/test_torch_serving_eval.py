"""The detector's serving evaluations against the JAX package at the tiny
preset, on the CPU: `selfcheck_detector --eval-wide --eval-serving
--affine-finetune` and `eval_artifact`.

The corpora are the JAX script's, handed across through its cache files
(the port's render can differ by one rgb level, ROADMAP C.11). The
whole-flag run hands both packages' `forward` and `forward_tta` the same
detections on the evaluation corpora (each batch's ground truth moved,
relabelled and padded with strays, seeded by the batch's pixels and by
the settings the evaluation passes: the norm, the pre-NMS top-k, int8
weights, the flip merge), so every mAP of the line is a function of what
the scripts do with detections and must be equal; training, calibration
and the training-frame probes run for real. The affine fine-tune's loop
is held to the JAX script's on the same weights and draws: each loss
within 3x the JAX package's own spread, the update by
`train/optim.update_gaps`. `eval_artifact` runs beside the JAX script on
handed caches, on the committed serving artifact and on a full save of
the JAX self-check.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.models import detector as JDET
from embodied_captioning_tpu.ops.detections import Detections as JDet
from embodied_captioning_tpu_torch import eval_artifact as EA
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.models import detector as TDET
from embodied_captioning_tpu_torch.ops.detections import Detections as TDet
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.train import optim as TO
from torch_parity import perturbed

REPO = Path(__file__).resolve().parents[1]
BATCH = 4


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, jax_side: bool, device: bool = True):
    """A script's or the port's `main` with `argv`: (rc, last JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["script.py"] + argv)
            rc = main()
        else:
            rc = main(argv + (["--device", "cpu"] if device else []))
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The JAX script's tiny corpora in its cache files: training (scene
    seeds 0.., 2 x 3 frames), evaluation (seed 500, 8 frames) and wide
    (seed 100000, 8 frames)."""
    root = tmp_path_factory.mktemp("serving_eval")
    mod = _script("selfcheck_detector")
    cfg = jload_config("tiny")
    parts = dict(
        train=mod.collect(cfg, 2, 3, 0, np.random.default_rng(0),
                          skip_seeds=(500, 1)),
        eval=mod.collect(cfg, 1, 8, 500, np.random.default_rng(500)),
        wide=mod.collect(cfg, 1, 8, 100000, np.random.default_rng(100000)))
    for k, frames in parts.items():
        mod.save_corpus(str(root / f"{k}.npz"), frames)
    return dict(mod=mod, root=root, **{
        k: SD.load_corpus(str(root / f"{k}.npz")) for k in parts})


# ---------------------------------------------------------------------------
# handed detections
# ---------------------------------------------------------------------------

def _quantized(tree) -> bool:
    if isinstance(tree, dict):
        return any(_quantized(v) for v in tree.values())
    if getattr(tree, "_fields", None) == ("q", "scale"):
        return True
    if isinstance(tree, (list, tuple)):
        return any(_quantized(v) for v in tree)
    return False


def _handed_table(corpora, names) -> dict:
    """The pixels of every whole evaluation batch of the named corpora ->
    that batch's ground truth."""
    return _batch_table([corpora[name] for name in names])


def _batch_table(corpora) -> dict:
    """The pixels of every whole batch of the frame lists `corpora` ->
    that batch's ground truth."""
    table = {}
    for frames in corpora:
        for i in range(0, len(frames) - BATCH + 1, BATCH):
            rgb = np.stack([frames[j][0] for j in range(i, i + BATCH)])
            table[rgb.tobytes()] = {
                f: np.stack([frames[j][1][f] for j in range(i, i + BATCH)])
                for f in ("boxes", "classes", "valid")}
    return table


def _handed(gt: dict, key: bytes, cfg, quantized: bool, tta: bool) -> dict:
    """Detections from a batch's ground truth, seeded by its pixels and the
    settings: corners moved by up to 3 pixels, a fifth of the classes
    changed, a fifth of the slots strays, seeded scores."""
    seed = [zlib.crc32(key), int(cfg.norm == "affine"), cfg.pre_nms_topk,
            int(quantized), int(tta)]
    rng = np.random.default_rng(seed)
    boxes = gt["boxes"].astype(np.float64) + rng.uniform(-3, 3,
                                                         gt["boxes"].shape)
    valid = gt["valid"]
    stray = rng.random(valid.shape) < 0.2
    boxes[stray] = rng.uniform(0, cfg.image_size * 0.6,
                               (int(stray.sum()), 4)) + [0, 0, 12, 12]
    classes = np.where(rng.random(valid.shape) < 0.2,
                       rng.integers(1, cfg.num_classes, valid.shape),
                       gt["classes"])
    return dict(boxes=boxes.astype(np.float32),
                classes=classes.astype(np.int32),
                scores=rng.uniform(0.05, 1, valid.shape).astype(np.float32),
                logits=np.zeros(valid.shape + (cfg.num_classes,),
                                np.float32),
                valid=valid | stray)


def _fakes(table: dict, jax_side: bool, calls: list):
    """`forward` and `forward_tta` that hand `_handed` detections for the
    batches in `table` and run the real functions elsewhere (calibration,
    the training-frame probes)."""
    real = JDET if jax_side else TDET

    def wrap(d):
        if jax_side:
            d = {k: jnp.asarray(v) for k, v in d.items()}
            return JDet(**dict(d, boxes=d["boxes"].astype(jnp.bfloat16)))
        d = {k: torch.from_numpy(v) for k, v in d.items()}
        return TDet(**dict(d, boxes=d["boxes"].to(torch.bfloat16)))

    def make(tta: bool):
        orig = real.forward_tta if tta else real.forward

        def fake(params, images, cfg_, with_masks=True):
            key = np.asarray(images if jax_side else images.cpu()).tobytes()
            if key not in table:
                return orig(params, images, cfg_, with_masks=with_masks)
            calls.append((tta, cfg_.norm, cfg_.pre_nms_topk))
            return wrap(_handed(table[key], key, cfg_, _quantized(params),
                                tta))

        if hasattr(orig, "__wrapped__"):  # calibrate_affine's raw forward
            fake.__wrapped__ = orig.__wrapped__
        return fake

    return make(False), make(True)


FLAGS = ["--preset", "tiny", "--steps", "2", "--batch", str(BATCH),
         "--eval-scenes", "1", "--eval-ep-steps", "8", "--device-train",
         "--ema", "0.5", "--tta", "--eval-wide", "1", "--eval-serving",
         "--calibrate", "--affine-finetune", "2"]


@pytest.fixture(scope="module")
def whole_flags(corpora, tmp_path_factory):
    """Both scripts with every serving flag, the detector's weights the
    JAX package's seeded ones on both sides, handed detections on the
    evaluation and wide corpora; the JAX script's artifact saved (a full
    save: params, EMA, affine)."""
    root, out = corpora["root"], tmp_path_factory.mktemp("whole_flags")
    argv = FLAGS + ["--train-cache", str(root / "train.npz"),
                    "--eval-cache", str(root / "eval.npz"),
                    "--eval-wide-cache", str(root / "wide.npz")]
    table = _handed_table(corpora, ("eval", "wide"))
    params = JDET.init_detector(jax.random.PRNGKey(0),
                                jload_config("tiny").detector)
    jcalls, tcalls = [], []
    jfwd, jtta = _fakes(table, True, jcalls)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDET, "forward", jfwd)
        mp.setattr(JDET, "forward_tta", jtta)
        jrc, jline = _run_main(corpora["mod"].main,
                               argv + ["--save", str(out / "j.pkl")], True)
    tfwd, ttta = _fakes(table, False, tcalls)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TDET, "forward", tfwd)
        mp.setattr(TDET, "forward_tta", ttta)
        mp.setattr(TDET, "init_detector",
                   lambda g, cfg, dev: from_jax(params, dev))
        rc, line = _run_main(SD.main, argv, False)
    return dict(rc=rc, line=line, jrc=jrc, jline=jline, jcalls=jcalls,
                tcalls=tcalls, artifact=out / "j.pkl")


SERVING_KEYS = ("map50_wide", "map50_wide_ema", "map50_wide_tta",
                "map50_wide_ema_tta", "eval_wide_sha", "map50_serving_exact",
                "map50_serving_approx", "map50_gn_int8", "map50_affine",
                "map50_affine_ft", "map50_served_int8",
                "map50_served_int8_tta")


def test_serving_flags_line_matches_jax(whole_flags):
    """The JAX script's keys, in its order; every mAP on the evaluation
    corpora and the wide corpus equal to the JAX script's (handed
    detections), and above 0; the same evaluations in the same order
    (norm, pre-NMS top-k, flip merge); the first loss as the self-check
    tests hold it."""
    got, want = whole_flags["line"], whole_flags["jline"]
    assert whole_flags["rc"] == 0 and whole_flags["jrc"] is None
    assert list(got) == list(want)
    assert set(SERVING_KEYS) <= set(got)
    for k in got:
        if k.startswith("map50") and k != "map50_train":
            assert got[k] == want[k] > 0, (k, got[k], want[k])
    for k in ("eval_sha", "eval_wide_sha", "frames", "steps", "seed"):
        assert got[k] == want[k], k
    # the JAX script evaluates the approximate top-k apart (its second
    # pass at 1024 proposals, one call a batch); the port's top-k is exact
    # and reuses the exact pass
    jcalls = whole_flags["jcalls"]
    i, n = jcalls.index((False, "gn", 1024)), len(jcalls) - len(
        whole_flags["tcalls"])
    assert n == 2 and jcalls[i:i + 2 * n] == [(False, "gn", 1024)] * 2 * n
    assert whole_flags["tcalls"] == jcalls[:i + n] + jcalls[i + 2 * n:]
    assert abs(got["first_loss"] - want["first_loss"]) <= 2e-3 * abs(
        want["first_loss"]), (got["first_loss"], want["first_loss"])


def test_serving_evaluations_take_the_serving_settings(whole_flags):
    """Per evaluation: the serving keys at 1024 pre-NMS proposals (the
    exact and the approximate top-k the same proposals in the port), the
    affine and fine-tuned affine ones under the affine norm, the served
    int8 artifact at both."""
    calls = whole_flags["tcalls"]
    assert (False, "gn", 1024) in calls and (False, "affine", 1024) in calls
    assert (True, "affine", 1024) in calls  # the served merge
    assert (False, "affine", 64) in calls   # affine and fine-tuned affine
    got = whole_flags["line"]
    assert got["map50_serving_approx"] == got["map50_serving_exact"]


def test_jax_approximate_top_k_is_exact_on_the_cpu():
    """The premise of the port's `map50_serving_approx`: the JAX package's
    `forward` at the serving settings returns the same detections with
    `approx_topk` on and off on the CPU."""
    cfg = dataclasses.replace(jload_config("tiny").detector,
                              pre_nms_topk=1024, num_proposals=128,
                              score_threshold=0.05)
    p = JDET.init_detector(jax.random.PRNGKey(3), cfg)
    imgs = jnp.asarray(np.random.default_rng(3).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    a = JDET.forward(p, imgs, cfg, with_masks=False)
    b = JDET.forward(p, imgs, dataclasses.replace(cfg, approx_topk=True),
                     with_masks=False)
    for f in ("boxes", "classes", "scores", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_wide_corpus_seed_asserts(corpora):
    """The JAX script's two leak guards, word for word: a wide block inside
    the training seeds, and one overlapping the primary eval block."""
    root = corpora["root"]
    argv = ["--preset", "tiny", "--steps", "1", "--eval-scenes", "1",
            "--train-cache", str(root / "train.npz"),
            "--eval-cache", str(root / "eval.npz"), "--eval-wide", "8",
            "--device", "cpu"]
    with pytest.raises(AssertionError,
                       match="--eval-wide-seed inside the training seed"):
        SD.main(argv + ["--eval-wide-seed", "5"])
    with pytest.raises(AssertionError):
        SD.main(argv + ["--eval-wide-seed", "496"])


# ---------------------------------------------------------------------------
# the affine fine-tune's loop
# ---------------------------------------------------------------------------

FT_STEPS, FT_LR = 2, 1e-3
# after two Adam steps the bf16 gradients' flipped signs part the runs
# (test_torch_pipelines.py's AGREE_2 after two steps): this loop reads
# 0.985 of the moved elements alike (0.954 after three steps); its second
# loss sits 0.108 from the JAX package's, whose own moves by 0.144
FT_AGREE = 0.95
# the summed size of the moves made alike, over the JAX package's: reads
# 1.0016 (the same loop at twice the learning rate: 1.964, while it still
# moves 0.969 of the elements alike)
FT_SCALE_ATOL = 0.1


@pytest.fixture(scope="module")
def affine_ft(corpora):
    """Both packages' fine-tune loops from the JAX package's calibrated
    affine weights (its seeded init calibrated on two training batches),
    the batches drawn by default_rng(0); the JAX loop also from two starts
    moved by 1e-4 of themselves, for its own spread."""
    frames = corpora["train"]
    cfg = jload_config("tiny").detector
    calib = [jnp.asarray(np.stack([frames[i][0] for i in range(j, j + 2)]))
             for j in (0, 2)]
    start = JDET.calibrate_affine(
        JDET.init_detector(jax.random.PRNGKey(0), cfg), calib, cfg)
    start = jax.tree_util.tree_map(np.asarray, start)
    aff = dataclasses.replace(cfg, norm="affine")
    sched = optax.warmup_cosine_decay_schedule(
        0.0, FT_LR / 10, min(50, FT_STEPS // 5), FT_STEPS, FT_LR / 200)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(sched))

    @jax.jit
    def step(p, o, images, gt):
        (loss, _), grads = jax.value_and_grad(
            lambda q: JDET.detector_loss(q, images, gt, aff, head="ce"),
            has_aux=True)(p)
        upd, o = opt.update(grads, o, p)
        return optax.apply_updates(p, upd), o, loss

    def jax_loop(p0):
        rng = np.random.default_rng(0)
        p = jax.tree_util.tree_map(jnp.asarray, p0)
        o, losses = opt.init(p), []
        for _ in range(FT_STEPS):
            idx = rng.choice(len(frames), BATCH, replace=False)
            images = jnp.asarray(np.stack([frames[i][0] for i in idx]))
            gt = JDet(**{f: jnp.asarray(np.stack([frames[i][1][f]
                                                  for i in idx]))
                         for f in SD.FIELDS})
            p, o, loss = step(p, o, images, gt)
            losses.append(float(loss))
        return p, losses

    p, losses = jax_loop(start)
    moved = [jax_loop(perturbed(start, s))[1] for s in (1, 2)]
    def port_loop(lr):
        return SD.affine_finetune(
            from_jax(start, "cpu"), frames, load_config("tiny").detector,
            FT_STEPS, BATCH, lr, "ce", np.random.default_rng(0), "cpu",
            log=lambda m: None)

    got, got_losses = port_loop(FT_LR)
    return dict(start=start, want=p, losses=losses, spread=np.abs(
        np.array(moved) - np.array(losses)).max(axis=0), got=got,
        got_losses=got_losses, fault=port_loop(2 * FT_LR)[0])


def _ft_faults(before, got, want) -> list:
    """What the port's fine-tune did that the JAX package's did not, past
    the limits above: elements moved alike, the moves' size, each
    parameter's distance."""
    assert len(got) == len(want) == len(before)
    gaps = TO.update_gaps(before, got, want, FT_LR / 10)
    num = den = 0.0
    for p, a, b in zip(before, got, want):
        alike = np.sign(a - p) == np.sign(b - p)
        num += float(np.abs(a - p)[alike].sum())
        den += float(np.abs(b - p)[alike].sum())
    scale = num / den
    bad = []
    if not gaps["agree"] >= FT_AGREE:
        bad.append(("agree", gaps["agree"]))
    if not abs(scale - 1) <= FT_SCALE_ATOL:
        bad.append(("scale", scale))
    for a, b in zip(got, want):
        if not np.abs(a - b).max() <= FT_STEPS * 2 * FT_LR / 10 + 1e-6:
            bad.append(("params", float(np.abs(a - b).max())))
            break
    return bad


def test_affine_finetune_loop_matches_jax(affine_ft):
    """Each step's loss within the larger of 1e-4 of it and 3x the JAX
    package's own spread at that step (ROADMAP C.20); the elements both
    runs moved, moved alike on at least FT_AGREE of them (plain Adam: no
    decay term to estimate); the moves alike as large as the JAX
    package's within FT_SCALE_ATOL; every parameter within 2 peak steps
    (lr / 10) a step. The same loop at twice the learning rate fails."""
    want = np.array(affine_ft["losses"])
    got = np.array(affine_ft["got_losses"])
    assert got.shape == want.shape == (FT_STEPS,)
    lim = np.maximum(1e-4 * np.abs(want), 3 * affine_ft["spread"])
    assert (np.abs(got - want) <= lim).all(), (got, want, lim)
    before = jax.tree_util.tree_leaves(affine_ft["start"])
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        affine_ft["want"])]
    after = jax.tree_util.tree_leaves(to_numpy(affine_ft["got"]))
    assert _ft_faults(before, after, ref) == []
    fault = jax.tree_util.tree_leaves(to_numpy(affine_ft["fault"]))
    assert _ft_faults(before, fault, ref)


# ---------------------------------------------------------------------------
# eval_artifact
# ---------------------------------------------------------------------------

def _artifact_caches(root: Path, cfg, sizes) -> list:
    """Handed protocol, wide and stress caches, rendered by the port's
    `collect` at `cfg` (the stress one with eval_artifact's difficulty
    settings) and read by both scripts."""
    from embodied_captioning_tpu_torch.config import apply_dotlist

    out = []
    for name, seed, steps in zip(("protocol", "wide", "stress"),
                                 (500, 100000, 200000), sizes):
        c = cfg if name != "stress" else apply_dotlist(cfg, [
            "sim.num_distractors=6", "sim.interior_walls=5",
            "sim.tex_boost=0.18"])
        frames = SD.collect(c, 1, steps, seed, np.random.default_rng(seed),
                            "cpu")
        path = root / f"{name}.npz"
        SD.save_corpus(str(path), frames)
        out.append(str(path))
    return out


def _artifact_argv(caches) -> list:
    return ["--eval-cache", caches[0], "--wide", "1", "--wide-cache",
            caches[1], "--stress", "1", "--stress-cache", caches[2],
            "--batch", str(BATCH)]


def _same_artifact_line(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in ("artifact", "serving_img", "artifact_metrics", "corpora"):
        assert got[k] == want[k], k
    assert list(got["results"]) == list(want["results"])
    for c, row in want["results"].items():
        assert list(got["results"][c]) == list(row), c
    assert got["results"] == want["results"]


@pytest.fixture(scope="module")
def committed_caches(tmp_path_factory):
    """Caches of 4 frames each for the committed serving artifact, rendered
    at its 256^2 input."""
    cfg = load_config("large", overrides=[
        "sensors.height=256", "sensors.width=256", "detector.image_size=256"])
    return _artifact_caches(tmp_path_factory.mktemp("committed"), cfg,
                            (4, 4, 4))


def test_eval_artifact_on_the_committed_artifact_matches_jax(
        committed_caches):
    """The committed serving artifact (served rows only) on caches of 4
    frames each, rendered at its 256^2 input: the JAX script's line,
    corpus shas and every mAP equal (real forwards; the int8 served
    weights' boxes in bf16, ROADMAP C.25)."""
    argv = _artifact_argv(committed_caches)
    jrc, want = _run_main(_script("eval_artifact").main, argv, True)
    rc, got = _run_main(EA.main, argv, False)
    assert rc == 0 and jrc is None
    _same_artifact_line(got, want)
    assert set(got["results"]["protocol"]) == {"served_int8",
                                               "served_int8_tta"}
    assert got["corpora"]["protocol"]["frames"] == 4


def test_eval_artifact_on_a_full_save_matches_jax(corpora, whole_flags):
    """The JAX self-check's full save (raw, EMA and affine weights of the
    tiny detector) on the tiny corpora as handed caches: the variants
    "best" (raw or EMA, under GroupNorm) and "affine", each with the
    flip merge; every mAP equal to the JAX script's (real forwards)."""
    root = corpora["root"]
    caches = [str(root / "eval.npz"), str(root / "wide.npz"),
              str(root / "eval.npz")]
    argv = ["--artifact", str(whole_flags["artifact"])] + _artifact_argv(
        caches)
    jrc, want = _run_main(_script("eval_artifact").main, argv, True)
    rc, got = _run_main(EA.main, argv, False)
    assert rc == 0 and jrc is None
    _same_artifact_line(got, want)
    assert list(got["results"]["protocol"]) == [
        "best", "best_tta", "affine", "affine_tta"]
    assert got["serving_img"] == 64 and got["artifact_metrics"] is None


@pytest.mark.parametrize("which", ["committed", "full_save"])
def test_eval_artifact_variants_on_handed_detections_match_jax(
        which, request):
    """Both scripts with `forward` and `forward_tta` handing detections
    seeded by each batch's pixels, its norm, int8 weights and the flip
    merge (`_handed`): every mAP of the line is then a function of which
    variants the script builds and how it evaluates them, and equals the
    JAX script's; the mAPs are not all alike. A port whose flip-merge
    variant runs the plain `forward` gives another line."""
    if which == "committed":
        caches = request.getfixturevalue("committed_caches")
        argv = _artifact_argv(caches)
    else:
        root = request.getfixturevalue("corpora")["root"]
        caches = [str(root / "eval.npz"), str(root / "wide.npz"),
                  str(root / "eval.npz")]
        argv = ["--artifact", str(request.getfixturevalue(
            "whole_flags")["artifact"])] + _artifact_argv(caches)
    table = _batch_table([SD.load_corpus(c) for c in caches])
    lines = []
    for jax_side, fault in ((True, False), (False, False), (False, True)):
        calls = []
        fwd, tta = _fakes(table, jax_side, calls)
        mod = JDET if jax_side else TDET
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "forward", fwd)
            mp.setattr(mod, "forward_tta", fwd if fault else tta)
            main = _script("eval_artifact").main if jax_side else EA.main
            lines.append(_run_main(main, argv, jax_side)[1])
        assert calls
    want, got, faulty = lines
    _same_artifact_line(got, want)
    maps = [m for row in got["results"].values() for m in row.values()]
    assert len(set(maps)) > 1, maps
    assert faulty["results"] != want["results"]


def test_eval_artifact_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EA.main([]) == 2
