"""The query detector family's training state and its exploration and
labeling entry points, on the CPU at the tiny preset: device-side training
on bit-packed masks, the checkpoint and its resume (`selfcheck_detector`'s
`--pack-masks` and `--ckpt`), `run_exp --mode generate`,
`run_pseudolabeler`, and `train_detector` (which refuses a query student,
as the JAX package's pipelines do)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from embodied_captioning_tpu_torch import run_exp as RX
from embodied_captioning_tpu_torch import run_pseudolabeler as RPL
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch import train_detector as TDR
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.params import load_pickle
from embodied_captioning_tpu_torch.train.optim import tree_leaves
from torch_parity import STORE_OVERRIDES

QUERY = ["detector.family=query", "detector.query_aux_topk=3"]


def _run_main(main, argv):
    """The port's `main` with `argv` on the CPU: (rc, last JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--device", "cpu"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _frames(n: int = 6):
    rng = np.random.default_rng(3)
    masks = np.zeros((8, 64, 64), np.uint8)
    masks[0, 8:40, 8:40] = 1
    masks[1, 30:60, 20:50] = 1
    return [(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), {
        "boxes": np.array([[8, 8, 40, 40], [20, 30, 50, 60]] + [[0] * 4] * 6,
                          np.float32),
        "classes": np.array([1, 4] + [0] * 6, np.int32),
        "scores": np.ones(8, np.float32),
        "logits": np.zeros((8, 6), np.float32),
        "valid": np.array([True, True] + [False] * 6),
        "masks": np.roll(masks, i, axis=2)}) for i in range(n)]


def test_pack_masks_round_trip_and_training_equal():
    """`pack_masks` / `unpack_masks` invert each other on any {0, 1}
    masks; device-side training on packed masks equals training on the
    masks themselves, step for step."""
    rng = np.random.default_rng(0)
    m = (rng.random((3, 8, 64, 64)) < 0.3).astype(np.uint8)
    pk = SD.pack_masks(m)
    assert pk.shape == (3, 8, 64, 8) and pk.dtype == np.uint8
    np.testing.assert_array_equal(
        SD.unpack_masks(torch.from_numpy(pk)).numpy(), m)
    cfg = load_config("tiny", overrides=QUERY).detector
    p0 = TD.init_detector(torch.Generator().manual_seed(0), cfg, "cpu")
    runs = [SD.train(p0, _frames(), cfg, 3, 2, lambda c: 1e-3, "ce",
                     np.random.default_rng(1), "cpu", device_train=True,
                     log=lambda s: None, packed=packed)
            for packed in (False, True)]
    (pa, _, ra), (pb, _, rb) = runs
    assert ra == rb
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa),
                                                 tree_leaves(pb)))


def test_checkpoint_resume_equals_straight_steps(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, and a resumed run to
    4 (weights, EMA and the read-back losses after the resume), with
    augmentation drawn from the generator and an EMA: the checkpoint
    carries the weights, EMA, Adam's state, the generator's and the
    numpy draws' states."""
    cfg = load_config("tiny", overrides=QUERY).detector
    p0 = TD.init_detector(torch.Generator().manual_seed(0), cfg, "cpu")
    ck = str(tmp_path / "ck.pkl")

    def run(steps, ckpt=None, every=0):
        return SD.train(p0, _frames(), cfg, steps, 2, lambda c: 1e-3, "ce",
                        np.random.default_rng(1), "cpu", augment=True,
                        device_train=True, ema=0.9,
                        generator=torch.Generator().manual_seed(7),
                        log=lambda s: None, packed=True, ckpt=ckpt,
                        ckpt_every=every)

    pa, ea, ra = run(4)
    run(2, ck, 2)
    assert load_pickle(ck)["step"] == 2
    logs = []
    pb, eb, rb = SD.train(
        p0, _frames(), cfg, 4, 2, lambda c: 1e-3, "ce",
        np.random.default_rng(1), "cpu", augment=True, device_train=True,
        ema=0.9, generator=torch.Generator().manual_seed(7), log=logs.append,
        packed=True, ckpt=ck, ckpt_every=2)
    assert any("resumed from" in m and "at step 2" in m for m in logs)
    assert load_pickle(ck)["step"] == 4
    assert rb == {k: v for k, v in ra.items() if k >= 2}
    for x, y in ((pa, pb), (ea, eb)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(x),
                                                     tree_leaves(y)))


# ---------------------------------------------------------------------------
# the exploration, labeling and teacher-student entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def query_store(tmp_path_factory):
    """`run_exp --mode generate` with a query detector (tiny, 2 envs, 4
    steps: 8 frames, one labeling batch) on the CPU: its line and its
    store."""
    root = tmp_path_factory.mktemp("query_store")
    rc, line = _run_main(RX.main, [
        "--trainer", "randombaseline", "--mode", "generate", "--preset",
        "tiny", "--steps", "4", "--obs-dir", str(root / "obs")]
        + STORE_OVERRIDES + QUERY)
    return dict(rc=rc, line=line, obs=str(root / "obs"), root=root)


def test_run_exp_generate_with_the_query_detector(query_store):
    line = query_store["line"]
    assert query_store["rc"] == 0
    assert line["saved_files"] == 4 * 2 * 4
    assert all(np.isfinite(line["rewards"]))


def test_run_pseudolabeler_with_the_query_detector(query_store):
    rc, line = _run_main(RPL.main, [
        query_store["obs"], "--out", str(query_store["root"] / "pl"),
        "--consensus", "vanilla"] + STORE_OVERRIDES + QUERY)
    assert rc == 0 and set(line) == {"frames", "instances", "files", "out"}
    assert line["frames"] == 8 and line["instances"] > 0


def test_train_detector_refuses_a_query_student_as_jax(query_store):
    """The teacher-student pipelines hand the student's loss boxes,
    classes and scores without masks (the JAX package's `training_step`s
    build `Detections` without them), so a query-family student is
    refused by its set loss with the JAX package's message, after the
    round's labeling ran the query teacher; a head other than ce is
    refused first."""
    with pytest.raises(ValueError, match="gt.masks required"):
        _run_main(TDR.main, ["--obs-dir", query_store["obs"], "--pipeline",
                             "online", "--head", "ce"]
                  + STORE_OVERRIDES + QUERY)
    with pytest.raises(ValueError, match="head='ce'"):
        _run_main(TDR.main, ["--obs-dir", query_store["obs"], "--pipeline",
                             "online", "--head", "focal"]
                  + STORE_OVERRIDES + QUERY)
