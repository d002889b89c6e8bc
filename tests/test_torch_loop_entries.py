"""The four learning-loop entry points on the CPU at the tiny preset with
cut step counts: each prints one JSON line with the JAX script's keys
(`scripts/selfcheck_loop.py:141-152`, `selfcheck_rl.py:147-230`,
`selfcheck_cycle.py:311-330` and `:256-270`,
`selfcheck_teacher_student.py:388-396`), and refuses to run on a missing
card unless asked for the CPU."""

import contextlib
import io
import json
import pickle

import numpy as np
import pytest
import torch

from embodied_captioning_tpu_torch import selfcheck_cycle as CYC
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch import selfcheck_loop as LOOP
from embodied_captioning_tpu_torch import selfcheck_rl as RL
from embodied_captioning_tpu_torch import selfcheck_teacher_student as TS
from embodied_captioning_tpu_torch.config import load_config, to_dict
from embodied_captioning_tpu_torch.models import detector as DET
from embodied_captioning_tpu_torch.params import to_numpy

LOOP_KEYS = {"preset", "loop_steps", "seconds", "loop_fps",
             "reward_mean_first_half", "reward_mean_second_half",
             "captioned_detections", "mapped_objects_per_env",
             "disagreement_rewards", "example_caption"}
RL_KEYS = {"eval_steps", "preset", "arms", "summary", "best_ppo_arm",
           "ppo_beats_random", "ppo_beats_frontier"}
RL_PPO_ROW = {"disagreement_reward", "area_ratio_mean", "mapped_objects",
              "train_seconds", "env_steps", "train_reward_first_quarter",
              "train_reward_last_quarter"}
RL_BASELINE_ROW = {"disagreement_reward", "area_ratio_mean",
                   "mapped_objects"}
CYCLE_KEYS = {"preset", "seeds", "triplet_weight", "explore_envs",
              "mean_consistency_delta", "mean_gt_cosine_delta",
              "all_positive", "coherent_and_accurate", "per_seed"}
CYCLE_SEED_KEYS = {"seed", "objects", "views", "consistency_before",
                   "consistency_after", "consistency_delta",
                   "gt_class_accuracy_before", "gt_class_accuracy_after",
                   "gt_cosine_before", "gt_cosine_after", "example_pseudo",
                   "example_before", "example_after"}
TS_KEYS = {"teacher_map50", "eval_sha", "pool_frames", "teacher_detections",
           "steps", "scenes", "generations", "student_vanilla_map50",
           "student_soft_map50", "student_semantic_map_map50"}
SMALL = ["sensors.height=64", "sensors.width=64"]


def _run(main, argv):
    """`main(argv + --device cpu)`: (rc, every JSON line printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--device", "cpu"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    return rc, lines


def test_selfcheck_loop_line():
    rc, lines = _run(LOOP.main, ["--det-steps", "2", "--cap-steps", "2",
                                 "--loop-steps", "9"])
    assert rc == 0 and set(lines[-1]) == LOOP_KEYS
    line = lines[-1]
    assert line["loop_steps"] == 9 and line["preset"] == "tiny"
    assert len(line["disagreement_rewards"]) == 2
    assert len(line["mapped_objects_per_env"]) == 2


def test_selfcheck_rl_line():
    rc, lines = _run(RL.main, [
        "--preset", "tiny", "--seeds", "0", "--det-steps", "2",
        "--cap-steps", "2", "--ppo-updates", "1",
        "--decisions-per-update", "2", "--eval-steps", "6"] + SMALL)
    assert rc == 0
    line = lines[-1]
    assert set(line) == RL_KEYS
    assert set(line["arms"]) == {"ppo", "random_goals", "frontier_v1"}
    assert set(line["arms"]["ppo"][0]) == RL_PPO_ROW
    assert line["arms"]["ppo"][0]["env_steps"] == 1 * 2 * 10 * 2
    for arm in ("random_goals", "frontier_v1"):
        assert set(line["arms"][arm][0]) == RL_BASELINE_ROW
    assert line["best_ppo_arm"] == "ppo"
    assert set(line["summary"]["ppo"]) == {"reward_mean", "reward_std",
                                           "area_mean", "area_std"}


def test_selfcheck_rl_entropy_arms_and_summary():
    rows = [{"disagreement_reward": r, "area_ratio_mean": 0.1}
            for r in (0.2, 0.4)]
    arms = {"ppo_ent0.01": rows, "ppo_ent0.05": rows[::-1][:1],
            "random_goals": rows[:1], "frontier_v1": rows[1:]}
    out = RL.summarize(arms)
    assert out["summary"]["ppo_ent0.01"]["reward_mean"] == 0.3
    assert out["best_ppo_arm"] == "ppo_ent0.05"
    assert out["ppo_beats_random"] and not out["ppo_beats_frontier"]


def test_selfcheck_cycle_lines(tmp_path, monkeypatch):
    """A seed whose store gives too few views prints the JAX script's
    error line; one that gives views (handed in here: the port's seeded
    tiny detector finds few objects) prints every per-seed key, and the
    summary line follows."""
    argv = ["--preset", "tiny", "--seeds", "0", "--det-steps", "2",
            "--cap-steps", "2", "--finetune-steps", "2", "--explore-steps",
            "4", "--workdir", str(tmp_path), "--ft-batch", "4"] + SMALL
    rc, lines = _run(CYC.main, argv)
    assert rc == 0 and set(lines[-1]) == CYCLE_KEYS
    assert lines[0] == {"seed": 0, "error": "too few recorded views"}
    rng = np.random.default_rng(0)
    crops = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
             for _ in range(6)]
    keys = [(0, 1), (0, 1), (0, 2), (0, 2), (0, 2), (1, 3)]
    monkeypatch.setattr(CYC, "view_crops", lambda *a: (crops, keys))
    rc, lines = _run(CYC.main, argv)
    assert rc == 0
    assert set(lines[0]) == CYCLE_SEED_KEYS and lines[0]["views"] == 6
    assert lines[0]["objects"] == 2
    summary = lines[-1]
    assert set(summary) == CYCLE_KEYS and summary["seeds"] == 1
    assert summary["per_seed"] == lines[:1]
    assert isinstance(summary["mean_consistency_delta"], float)


def test_selfcheck_teacher_student_line(tmp_path):
    """A teacher artifact in `selfcheck_detector --save`'s layout (raw
    weights best), then the three consensus modes' students."""
    cfg = load_config("tiny")
    params = DET.init_detector(torch.Generator().manual_seed(0),
                               cfg.detector, "cpu")
    art = tmp_path / "teacher.pkl"
    with open(art, "wb") as fh:
        pickle.dump({"params": to_numpy(params), "ema": None, "best": "raw",
                     "train_cfg": to_dict(cfg.detector)}, fh)
    # a small eval corpus in the cache the script reads (it collects 96
    # frames where the cache is missing)
    SD.save_corpus(str(tmp_path / "ev.npz"), SD.collect(
        cfg, 1, 8, 500, np.random.default_rng(500), "cpu"))
    rc, lines = _run(TS.main, [
        "--teacher", str(art), "--scenes", "2", "--steps", "3", "--batch",
        "4", "--teacher-threshold", "0.0", "--eval-cache",
        str(tmp_path / "ev.npz")])
    assert rc == 0
    line = lines[-1]
    assert set(line) == TS_KEYS
    assert line["pool_frames"] == 32 and line["teacher_detections"] > 0
    assert all(isinstance(line[f"student_{m}_map50"], float)
               for m in ("vanilla", "soft", "semantic_map"))


@pytest.mark.parametrize("main,argv", [
    (LOOP.main, []), (RL.main, []), (CYC.main, []),
    (TS.main, ["--teacher", "x.pkl"])])
def test_loops_need_a_card_unless_asked_for_the_cpu(main, argv,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 2
