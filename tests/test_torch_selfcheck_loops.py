"""The four whole-system learning loops' stages against the JAX scripts,
tiny preset, on the CPU: `train_stack` (shared by `selfcheck_loop`,
`selfcheck_rl` and, per seed, `selfcheck_cycle`) for 2 + 2 steps from the
JAX package's initial weights and the same numpy draws, held by the update
rule (detector and trunk training is chaotic, ROADMAP C.20, C.29); the
teacher-student loop's `collect_with_pose`, its consensus per mode on
handed predictions (the JAX labelers, as the JAX script runs them, per
episode for the semantic-map modes), and the cycle's consistency metric on
handed captions.

The frames the JAX scripts render are handed across where rgb enters (the
port's render can differ by one rgb level, C.11); the walks' draws are
made all the same, so the batches that follow are drawn alike."""

import copy
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload_config
from embodied_captioning_tpu.labeling import pseudolabeler as JPL
from embodied_captioning_tpu.labeling.datasets import Sample as JSample
from embodied_captioning_tpu.models import detector as JDET
from embodied_captioning_tpu.models import sbert as JSB
from embodied_captioning_tpu.models.captioner import init_captioner
from embodied_captioning_tpu.utils.metrics import (
    mean_pairwise_cosine as j_mean_pairwise_cosine,
)
from embodied_captioning_tpu_torch import selfcheck_cycle as CYC
from embodied_captioning_tpu_torch import selfcheck_detector as SD
from embodied_captioning_tpu_torch import selfcheck_loop as LOOP
from embodied_captioning_tpu_torch import selfcheck_teacher_student as TS
from embodied_captioning_tpu_torch import selfcheck_training as ST
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.labeling.datasets import Sample
from embodied_captioning_tpu_torch.models import sbert as TSB
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.train.optim import relative_gap, update_gaps
from torch_parity import jax_kernel_path, jax_train_path

REPO = Path(__file__).resolve().parents[1]
# the JAX scripts' configuration (selfcheck_loop.py:40-50)
OVERRIDES = ["sensors.height=64", "sensors.width=64"] + LOOP.LOOP_OVERRIDES
DET_LR, CAP_LR = 2e-3, 3e-4
STEPS = 2
# after 2 Adam steps, the elements either run moved that both moved the
# same way (test_torch_pipelines.py's AGREE_2, measured there >= 0.974)
AGREE_2 = 0.95
# |port's move - JAX's move| / |JAX's move| over all the leaves after the
# 2 steps (measured 0.28 for the detector, 0.23 for the captioner); a step
# of half or twice the size would read 0.5 or 1.0, none 1.0
MOVE_GAP = 0.4


def _script(name: str):
    """A JAX script as a module, with the scripts directory importable (the
    scripts import each other)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts_path():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        yield
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _port_frames(jframes):
    return [(np.asarray(rgb), {f: np.asarray(getattr(gt, f))
                               for f in SD.FIELDS}) for rgb, gt in jframes]


@pytest.fixture(scope="module")
def stacks(scripts_path):
    """The JAX script's `train_stack(cfg, 2, 2)` and the port's from the
    same initial weights (PRNGKey(0) and (1), as the script draws them),
    with the JAX frames and crops handed in where the port's own collects
    ran and drew."""
    rl = _script("selfcheck_rl")
    jdet_c = _script("selfcheck_detector")
    jcap_c = _script("selfcheck_training")
    jcfg = jload_config("tiny", overrides=OVERRIDES)
    tcfg = load_config("tiny", overrides=OVERRIDES)
    det0 = JDET.init_detector(jax.random.PRNGKey(0), jcfg.detector)
    cap0 = init_captioner(jax.random.PRNGKey(1), jcfg.captioner)
    jframes = jdet_c.collect(jcfg, 6, 16, 0, np.random.default_rng(0))
    jcaps = jcap_c.collect(jcfg, 6, 12, 0, 256)
    with jax_train_path():
        jdet, jcap = rl.train_stack(jcfg, STEPS, STEPS)

    own = {}
    real_collect = SD.collect

    def collect(cfg, episodes, steps, seed0, rng, device):
        own["frames"] = real_collect(cfg, episodes, steps, seed0, rng,
                                     device)
        return _port_frames(jframes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SD, "collect", collect)
        mp.setattr(ST, "collect", lambda *a: jcaps)
        tdet, tstate, dloss, closs = LOOP.train_stack(
            tcfg, STEPS, STEPS, "cpu", det_params=from_jax(det0, "cpu"),
            cap_params=from_jax(cap0, "cpu"))
    return dict(jframes=jframes, own=own["frames"], det0=det0, cap0=cap0,
                jdet=jdet, jcap=jcap, tdet=tdet, tcap=tstate.params,
                losses=(dloss, closs), steps=tstate.step)


def _leaves(tree):
    return [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(tree)]


def test_the_port_collects_the_jax_frames_but_for_rgb(stacks):
    """The walks draw alike: every frame's ground truth equal; the rgb of
    the port's render within one level of the JAX frames' on most pixels
    (C.11)."""
    got, want = stacks["own"], _port_frames(stacks["jframes"])
    assert len(got) == len(want) == 96
    for (a_rgb, a), (b_rgb, b) in zip(got, want):
        for f in ("boxes", "classes", "valid", "masks"):
            np.testing.assert_array_equal(a[f], b[f], f)
        off = np.abs(a_rgb.astype(int) - b_rgb.astype(int)).max(-1) > 1
        assert off.mean() < 0.02


@pytest.mark.parametrize("part,lr", [("detector", DET_LR),
                                     ("captioner", CAP_LR)])
def test_train_stack_matches_jax_by_the_update_rule(stacks, part, lr):
    """2 steps of each from the same weights on the same batches: the
    elements moved alike (update_gaps), and the port's whole move is the
    JAX package's within MOVE_GAP of its size (relative_gap of the moves:
    a step of another size, sign or set of leaves fails it, where a bound
    of a few lr on each element would not, an Adam move being about lr a
    step whatever the gradient)."""
    key = "det" if part == "detector" else "cap"
    before = _leaves(stacks[f"{key}0"])
    want = _leaves(stacks[f"j{key}"])
    got = _leaves(to_numpy(stacks[f"t{key}"]))
    assert len(got) == len(want) == len(before)
    gaps = update_gaps(before, got, want, lr)
    assert gaps["agree"] >= AGREE_2, gaps
    move = relative_gap([a - p for p, a in zip(before, got)],
                        [b - p for p, b in zip(before, want)])
    assert move <= MOVE_GAP, (move, gaps)
    assert stacks["steps"] == STEPS
    assert all(np.isfinite(x) for x in stacks["losses"])


def test_train_stack_draws_its_batches_from_one_generator(scripts_path):
    """`rng` is consumed by the walks, then the detector's and the
    captioner's batches in turn (selfcheck_rl.py:38-75): a port run and a
    run of the same draws by hand end at the same generator state."""
    cfg = load_config("tiny", overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ST, "collect", lambda *a: ([np.zeros((64, 64, 3),
                                                        np.uint8)] * 20,
                                              ["a bed"] * 20, [0] * 20))
        mp.setattr(SD, "train", lambda p, frames, dcfg, steps, batch, *a,
                   **k: ([rng.choice(len(frames), batch, replace=False)
                          for _ in range(steps)] and (p, p, {steps - 1: 0.0})))
        LOOP.train_stack(cfg, 3, 0, "cpu", rng=rng)
    ref = np.random.default_rng(0)
    ST.walk(cfg, 6, 16, 0, ref, "cpu")
    for _ in range(3):
        ref.choice(96, 8, replace=False)
    assert rng.integers(1 << 30) == ref.integers(1 << 30)


# ---------------------------------------------------------------------------
# the teacher-student loop's stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_frames(scripts_path):
    ts = _script("selfcheck_teacher_student")
    jcfg = jload_config("tiny", overrides=OVERRIDES)
    tcfg = load_config("tiny", overrides=OVERRIDES)
    jf = ts.collect_with_pose(jcfg, 2, 4, 2000, np.random.default_rng(0))
    tf = TS.collect_with_pose(tcfg, 2, 4, 2000, np.random.default_rng(0),
                              "cpu")
    return jcfg, tcfg, jf, tf


def test_collect_with_pose_matches_jax(pose_frames):
    """Episodes, poses, depth and the ground truth (ids included) equal;
    rgb within one level on most pixels (C.11)."""
    _, _, jf, tf = pose_frames
    assert len(jf) == len(tf) == 8
    for a, b in zip(tf, jf):
        assert a["episode"] == b["episode"]
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["depth"], np.asarray(b["depth"]))
        for f in ("boxes", "classes", "valid", "masks", "object_ids"):
            np.testing.assert_array_equal(a["gt"][f],
                                          np.asarray(getattr(b["gt"], f)), f)
        off = np.abs(a["rgb"].astype(int)
                     - np.asarray(b["rgb"]).astype(int)).max(-1) > 1
        assert off.mean() < 0.02
    assert sum(int(f["gt"]["valid"].sum()) for f in tf) >= 4


def _gt_samples(frames, cls):
    """The frames' ground truth as predictions (`Sample`s of class `cls`),
    ids as `label_pool` gives matched ones."""
    out = []
    for i, f in enumerate(frames):
        gt = {k: np.asarray(v) for k, v in (
            f["gt"].items() if isinstance(f["gt"], dict)
            else ((k, getattr(f["gt"], k)) for k in TS.FIELDS))}
        ids = np.where(gt["valid"], f["episode"] * 1000 + gt["object_ids"],
                       -1).astype(np.int64)
        out.append(cls(
            image=np.asarray(f["rgb"]), boxes=gt["boxes"].astype(np.float32),
            classes=gt["classes"].copy(),
            logits=gt["logits"].astype(np.float32),
            masks=gt["masks"].astype(np.float32), valid=gt["valid"].copy(),
            scores=gt["valid"].astype(np.float32), object_ids=ids,
            episode=int(f["episode"]), step=i, depth=np.asarray(f["depth"]),
            pose=np.asarray(f["pose"])))
    return out


def _jax_consensus(mode, samples, jcfg):
    """The JAX script's `consensus` (selfcheck_teacher_student.py:341-382)
    for vanilla, soft and semantic_map."""
    none = object()
    if mode == "vanilla":
        return JPL.VanillaConsensusLabeler(jcfg, perceiver=none
                                           ).get_pseudo_labels(samples)
    if mode == "soft":
        return JPL.SoftConsensusLabeler(jcfg, perceiver=none
                                        ).get_pseudo_labels(samples)
    out, by_ep = [], {}
    for s in samples:
        by_ep.setdefault(s.episode, []).append(s)
    for ep in sorted(by_ep):
        lab = JPL.SemanticMapConsensusLabeler(jcfg, perceiver=none)
        out += lab.get_pseudo_labels(by_ep[ep])
    return out


@pytest.mark.parametrize("mode", ["vanilla", "soft", "semantic_map"])
def test_consensus_per_mode_matches_jax_on_handed_predictions(pose_frames,
                                                              mode):
    """Each mode's pseudo-labels of the same predictions (the JAX frames'
    ground truth): boxes, classes, validity and ids equal, logits within
    1e-6 (test_torch_pseudolabel.py's limits), and the student's head."""
    jcfg, tcfg, jf, _ = pose_frames
    want = _jax_consensus(mode, _gt_samples(jf, JSample), jcfg)
    got, head = TS.consensus(mode, _gt_samples(jf, Sample), tcfg, "cpu")
    assert head == ("soft" if mode == "soft" else "ce")
    assert len(got) == len(want)
    n = 0
    for a, b in zip(got, want):
        for f in ("boxes", "classes", "valid", "object_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), f)
        np.testing.assert_allclose(a.logits, np.asarray(b.logits),
                                   rtol=1e-6, atol=1e-6)
        n += int(np.asarray(b.valid).sum())
    assert n > 0
    frames = TS.to_frames([p for p in got if p.valid.any()])
    assert frames and set(frames[0][1]) == set(SD.FIELDS)


def test_hybrid_graft_keeps_classes_and_takes_frame_boxes(pose_frames):
    _, tcfg, _, tf = pose_frames
    src = _gt_samples(tf, Sample)
    pseudo, _ = TS.consensus("semantic_map", src, tcfg, "cpu")
    before = copy.deepcopy(pseudo)
    grafted = TS.graft_frame_masks(pseudo, src)
    moved = 0
    for a, b in zip(grafted, before):
        np.testing.assert_array_equal(a.classes, b.classes)
        np.testing.assert_array_equal(a.logits, b.logits)
        moved += int((a.boxes != b.boxes).any())
    assert moved > 0


# ---------------------------------------------------------------------------
# the cycle's consistency metric
# ---------------------------------------------------------------------------

def test_cycle_consistency_matches_jax_on_handed_captions():
    """`consistency` groups the views' captions by object and averages the
    mean pairwise cosine of the groups with at least `min_views` views
    (selfcheck_cycle.py:188-201), under the JAX encoder's weights (the
    JAX package on its kernel path, as the sentence-encoder parity tests
    run it: embeddings within a cosine of 1e-4 a row)."""
    jcfg = jload_config("tiny")
    p = JSB.init_sentence_encoder(jax.random.PRNGKey(0),
                                  jcfg.sentence_encoder)
    caps = ["a brown couch", "a brown couch", "a blue bed", "a green plant",
            "a green plant on the floor", "a white toilet", "a black tv",
            "a black tv", "a black table"]
    keys = [(0, 1), (0, 1), (0, 1), (0, 2), (0, 2), (1, 3), (1, 4), (1, 4),
            (1, 4)]
    jenc = JSB.SentenceEncoder(p, jcfg.sentence_encoder)
    for min_views in (2, 3):
        groups = {}
        for c, k in zip(caps, keys):
            groups.setdefault(k, []).append(c)
        with jax_kernel_path():
            vals = [j_mean_pairwise_cosine(jenc.encode(g))
                    for g in groups.values() if len(g) >= min_views]
        tenc = TSB.SentenceEncoder(from_jax(p, "cpu"),
                                   load_config("tiny").sentence_encoder)
        got, n = CYC.consistency(caps, keys, tenc, min_views)
        assert n == len(vals)
        assert abs(got - float(np.mean(vals))) < 1e-4
    assert CYC.consistency(caps[:1], keys[:1], tenc, 2) == (0.0, 0)


# ---------------------------------------------------------------------------
# the RL loop's evaluation
# ---------------------------------------------------------------------------

def _goals(goals_from_actions, cfg, lower, actions):
    """`_goals_from_actions` (the port's or the JAX package's) on a
    stand-in trainer: the goals it sets, planning left out."""
    from types import SimpleNamespace

    envs = [SimpleNamespace(map_state=SimpleNamespace(lower=lower))
            for _ in actions]
    tr = SimpleNamespace(cfg=cfg, envs=SimpleNamespace(envs=envs),
                         _pending_goal=[None] * len(actions),
                         _plan_to=lambda i, goal: None)
    goals_from_actions(tr, np.asarray(actions))
    return tr._pending_goal


def test_ppo_evaluation_takes_the_handed_policy_and_saturates_as_jax():
    """`selfcheck_rl.evaluate` steers by the handed `ppo_state`: two
    policies pick different goals at the tiny preset, whose map spans 6.4 m
    of the 8 m scene. At the base preset the map spans 25.6 m, so an
    untrained policy's goals (sigmoid of mean 0, std e^-1: above 0.31 on
    every row drawn here) clip to the far corner (7.7, 7.7) whatever the
    policy, in the JAX package's goal rule as in the port's: the PPO arms'
    evaluations can then be equal across seeds."""
    from embodied_captioning_tpu.agents.goal_exploration import (
        GoalExplorationTrainer as JGoal,
    )
    from embodied_captioning_tpu_torch import selfcheck_rl as RL
    from embodied_captioning_tpu_torch.agents.goal_exploration import (
        GoalExplorationTrainer as TGoal,
    )
    from embodied_captioning_tpu_torch.agents.policy import act, init_policy
    from embodied_captioning_tpu_torch.agents.ppo import create_state
    from embodied_captioning_tpu_torch.perception import Perceiver

    common = ["sim.num_objects=8", "sim.scene_size=8.0", "map.voxel_size=0.1",
              "runtime.num_envs=2", "ppo.num_global_steps=10",
              "ppo.replanning_steps=10", "detector.score_threshold=0.2"]
    cfg = load_config("tiny", overrides=common + OVERRIDES[:2])
    states = [create_state(init_policy(torch.Generator().manual_seed(s),
                                       cfg.policy, device="cpu"), cfg.ppo)
              for s in (0, 1)]
    picked = []
    real = TGoal._goals_from_actions

    def record(self, actions):
        real(self, actions)
        picked[-1].append(list(self._pending_goal))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TGoal, "_goals_from_actions", record)
        for st in states:
            picked.append([])
            RL.evaluate(cfg, "goalexplorationbaseline-v0", 0, 1,
                        lambda c: Perceiver(c, device="cpu"), ppo_state=st)
    assert len(picked[0]) == len(picked[1]) == 1
    assert picked[0] != picked[1]

    base = load_config("base", overrides=common)
    jbase = jload_config("base", overrides=common)
    assert base.map.grid[0] * base.map.voxel_size > 3 * base.sim.scene_size
    maps = torch.rand(8, base.policy.map_size, base.policy.map_size,
                      base.policy.input_channels,
                      generator=torch.Generator().manual_seed(3))
    orients = torch.arange(8, dtype=torch.int32)
    lower = np.full(3, -0.1, np.float32)
    corner = float(np.float32(base.sim.scene_size - 0.3))
    for s, st in enumerate(states):
        params = init_policy(torch.Generator().manual_seed(s), base.policy,
                             device="cpu")
        a = act(params, torch.Generator().manual_seed(10 + s), maps,
                orients)[0].numpy()
        assert a.min() > 0.31
        got = _goals(TGoal._goals_from_actions, base, torch.from_numpy(lower),
                     a)
        want = _goals(JGoal._goals_from_actions, jbase, lower, a)
        assert got == want == [(corner, corner)] * len(a)
