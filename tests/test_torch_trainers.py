"""The port's PPO trainers (agents/goal_exploration.py, extra_trainers.py,
registry, run_exp --mode train) against the JAX package's.

- The whole slice: one PPO update of `goalexplorationbaseline-v0` over 2
  decisions of 2 env steps, unfused and fused, on the tiny settings of the
  generate tests (2 envs, 128^2 sensors), with the JAX
  trainer's weights. The port is handed the JAX run's decisions (its
  `_act`, replaced in the test), its frames (the unfused loop's
  observations; the fused loop's renders) and its minibatch
  permutations; it runs its own perception (block decode route; the JAX
  package with ECAP_USE_PALLAS=1 ECAP_PALLAS_BLOCKS=1), fusion, rewards,
  policy inputs, GAE and update. Window rewards within rtol 1e-4 / atol
  1e-5 (the loop tolerance of the generate tests); the stored policy maps
  within atol 1e-4 on all but 1e-3 of their elements (the voxel grids'
  tolerance of the device loop tests);
  orientations, masks and the handed decisions equal; the bootstrap value
  within 2 bf16 ulps; the parameters after the update within Adam's
  per-step bound of 2 * lr, with a mean difference under a tenth of the
  mean move (tests/test_torch_policy.py says why).
- Every trainer of the JAX package but "myppo" is registered; the light
  trainers act as the JAX package's; the goal-exploration variants mirror
  tests/test_trainers.py; checkpoints load across the packages.
"""

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import embodied_captioning_tpu.agents  # noqa: F401 (fills the registry)
from embodied_captioning_tpu.agents import goal_exploration as JGE
from embodied_captioning_tpu.agents import policy as JP
from embodied_captioning_tpu.agents.registry import get_trainer as jget
from embodied_captioning_tpu.agents.registry import list_trainers as jlist
from embodied_captioning_tpu.config import load_config as jload
from embodied_captioning_tpu.envs import device_loop as JDL
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch import run_exp
from embodied_captioning_tpu_torch.agents import goal_exploration as GE
from embodied_captioning_tpu_torch.agents import list_trainers
from embodied_captioning_tpu_torch.agents import policy as TP
from embodied_captioning_tpu_torch.agents import ppo as TPPO
from embodied_captioning_tpu_torch.agents.registry import get_trainer
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.envs import device_loop as DL
from embodied_captioning_tpu_torch.perception import Perceiver
from torch_parity import GENERATE_OVERRIDES, jax_kernel_path, np32

LIGHT = ["runtime.num_envs=1", "sensors.height=48", "sensors.width=48",
         "sim.scene_size=6.0", "sim.num_objects=4", "sim.episode_steps=6",
         "map.voxel_size=0.1", "ppo.replanning_steps=3"]

SEED = 12
# the generate tests' settings on the disagreement env (the KL env reads
# a frame's detections, which the fused loop does not hand it); scene
# seed 12 gives both loop forms a reward in env 0 within the 4 steps
SLICE = GENERATE_OVERRIDES[:-1] + [
    f"sim.scene_seed={SEED}", "sim.episode_steps=8", "ppo.num_global_steps=2",
    "ppo.ppo_epoch=2", "ppo.num_mini_batch=2"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the whole slice against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_train(fused: bool, monkeypatch):
    """`train(1, 2, fused)` of the JAX trainer, recording its decisions,
    the frames its perception saw, the rollout and key of its update, its
    initial and final policy parameters."""
    jtr = jget("goalexplorationbaseline-v0")(jload("tiny", overrides=SLICE))
    rec = dict(params0=_np(jtr.ppo_state.params), decisions=[], frames=[],
               updates=[])
    own_act = jtr._act

    def act(key, maps, orients, deterministic=False):
        out = own_act(key, maps, orients, deterministic)
        rec["decisions"].append(tuple(None if x is None else np32(x)
                                      for x in out))
        return out

    jtr._act = act
    if fused:
        real_render = JDL._render_scan

        def render(scenes, poses, cfg, want_depth=True):
            out = real_render(scenes, poses, cfg, want_depth)
            jax.debug.callback(
                lambda rgb, depth: rec["frames"].append(
                    {"rgb": torch.from_numpy(np.array(rgb)),
                     "depth": torch.from_numpy(np.array(depth))}),
                out[0], out[1], ordered=True)
            return out

        monkeypatch.setattr(JDL, "_render_scan", render)
    else:
        own_pf = jtr.perceive_and_fuse

        def perceive_and_fuse(obs):
            rec["frames"].append({k: np.array(v) for k, v in obs.items()})
            return own_pf(obs)

        jtr.perceive_and_fuse = perceive_and_fuse
    real_update = JGE.ppo_update

    def update(state, rollout, key, cfg, categorical=False):
        # copies: the rollout's maps, orientations and masks are views of
        # the storage's buffers, which `after_update` overwrites
        rec["updates"].append((jax.tree_util.tree_map(np.array, rollout),
                               key))
        return real_update(state, rollout, key, cfg, categorical)

    monkeypatch.setattr(JGE, "ppo_update", update)
    with jax_kernel_path(blocks=True):
        rec["metrics"] = jtr.train(num_updates=1, decisions_per_update=2,
                                   fused=fused)
    rec["params1"] = _np(jtr.ppo_state.params)
    rec["perception"] = _np(jtr.perceiver.params)
    monkeypatch.undo()
    jtr.envs.close()
    return rec


def _port_train(rec, fused: bool, monkeypatch):
    """The port's `train(1, 2, fused)` on the JAX run's weights, handed its
    decisions, frames and permutations; returns (trainer, rollouts)."""
    cfg = load_config("tiny", overrides=SLICE)
    tr = get_trainer("goalexplorationbaseline-v0")(
        cfg, device="cpu",
        perceiver=Perceiver(cfg, params=P.from_jax(rec["perception"], "cpu"),
                            device="cpu"))
    tr.ppo_state = TPPO.create_state(P.from_jax(rec["params0"], "cpu"),
                                     cfg.ppo)
    decisions = iter(rec["decisions"])
    tr._act = lambda maps, orients, deterministic=False: next(decisions)
    frames = iter(rec["frames"])
    if fused:
        monkeypatch.setattr(DL, "_render_scan",
                            lambda scenes, poses, c: next(frames))
    else:
        own_pf = tr.perceive_and_fuse
        tr.perceive_and_fuse = lambda obs, timer=None: own_pf(
            {k: torch.from_numpy(v) for k, v in next(frames).items()})
    keys = iter(rec["updates"])
    rollouts = []

    def update(state, rollout, generator, c, categorical=False):
        _, key = next(keys)
        perms = [torch.from_numpy(np.asarray(jax.random.permutation(
            k, rollout.rewards.size))) for k in jax.random.split(
                key, c.ppo_epoch)]
        rollouts.append(type(rollout)(*(None if x is None else np.array(x)
                                        for x in rollout)))
        return TPPO.ppo_update_with(state, rollout, perms, c, categorical)

    monkeypatch.setattr(GE, "ppo_update", update)
    tr.train(num_updates=1, decisions_per_update=2, fused=fused)
    assert next(decisions, None) is None and next(frames, None) is None
    tr.envs.close()
    return tr, rollouts


@pytest.mark.parametrize("fused", [False, True])
def test_train_matches_jax_on_handed_decisions_and_frames(fused,
                                                          monkeypatch):
    rec = _jax_train(fused, monkeypatch)
    assert len(rec["frames"]) == 4 and len(rec["decisions"]) == 2
    tr, rollouts = _port_train(rec, fused, monkeypatch)
    (want, _), got = rec["updates"][0], rollouts[0]
    # not vacuous: the disagreement moves
    assert np.abs(want.rewards).max() > 1e-3, want.rewards
    np.testing.assert_allclose(got.rewards, want.rewards, rtol=1e-4,
                               atol=1e-5)
    # a mask pixel at the bf16 threshold may mark a voxel on the other
    # side (the device loop tests allow 1e-3 of the voxels): a top-down
    # cell then moves the pixels resized from it
    off = np.abs(got.maps - want.maps) > 1e-4
    assert off.mean() <= 1e-3, off.mean()
    assert np.abs(want.maps[..., 0]).max() > 1e-3
    for f in ("orientation", "masks", "raw_actions", "log_probs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.values[:-1], want.values[:-1])
    np.testing.assert_allclose(got.values[-1], want.values[-1], rtol=0,
                               atol=2 ** -6 * np.abs(want.values[-1]).max())
    lr = tr.cfg.ppo.lr
    steps = tr.cfg.ppo.ppo_epoch * tr.cfg.ppo.num_mini_batch
    p0 = TPPO.tree_leaves(P.from_jax(rec["params0"], "cpu"))
    p1 = TPPO.tree_leaves(P.from_jax(rec["params1"], "cpu"))
    mine = TPPO.tree_leaves(tr.ppo_state.params)
    diff = np.concatenate([(a - b).abs().numpy().ravel()
                           for a, b in zip(mine, p1)])
    move = np.concatenate([(b - a).abs().numpy().ravel()
                           for a, b in zip(p0, p1)])
    assert diff.max() <= 2 * lr * steps
    assert diff.mean() <= 0.1 * move.mean() and move.mean() > 0.5 * lr
    assert len(tr.metrics_log) == 1
    # each loss within a limit scaled by its own magnitude. Measured gaps
    # (loss, action_loss, value_loss): 3.1e-3, 3.4e-3, 7.1e-3 unfused;
    # 2.9e-2, 3.2e-2, 1.5e-3 fused. Two causes, read by handing inputs
    # across: the port's update on JAX's own rollout is already 1.0e-2 off
    # in the action loss in both forms (at 128^2 maps the trunk's bf16
    # gradients are chaotic, ROADMAP C.20, and Adam turns a near-zero
    # gradient element of either sign into a whole lr step, while the
    # action loss, about mean((ratio - 1) * advantage), is of the order of
    # those steps); in the fused form the maps' flipped top-down cell
    # moves JAX's own update on the port's maps by 2.2e-2. The bootstrap
    # value (2 bf16 ulps, unfused) moves it by 4.6e-4.
    want_m, got_m = rec["metrics"][0], tr.metrics_log[0]
    assert set(got_m) == set(want_m)
    for k, rtol in (("loss", 5e-2), ("action_loss", 5e-2),
                    ("value_loss", 2e-2)):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=rtol,
                                   err_msg=k)
    np.testing.assert_allclose(got_m["entropy"], want_m["entropy"],
                               rtol=1e-6)
    assert tr._step == 4


# ---------------------------------------------------------------------------
# the registry and the trainers of tests/test_trainers.py
# ---------------------------------------------------------------------------

def test_registry_has_every_jax_trainer_but_myppo():
    assert set(list_trainers()) == set(jlist()) - {"myppo"}
    for name in ("goalexplorationbaseline-v0", "goalexplorationbaseline-v3",
                 "informative-trajectories-v0",
                 "randomgoalsbaselinecaptioner", "curiosity-v0"):
        assert name in list_trainers()


@pytest.mark.parametrize("name", ["frontierbaseline-v2", "frontierbaseline-v3",
                                  "curiosity-v0",
                                  "observeobjectdiscreteactionsbaseline"])
def test_new_light_trainers_act_as_jax(name):
    jtr = jget(name)(jload("tiny", overrides=LIGHT), with_perception=False)
    tr = get_trainer(name)(load_config("tiny", overrides=LIGHT),
                           device="cpu", with_perception=False)
    for _ in range(8):
        a, ja = tr.actions(None), jtr.actions(None)
        assert [int(x) for x in a] == [int(x) for x in ja]
        assert all(0 <= x <= 3 for x in a)
        tr.envs.step(a), jtr.envs.step(ja)
    tr.envs.close()
    jtr.envs.close()


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3"])
def test_goalexploration_generate_without_perception(variant):
    tr = get_trainer(f"goalexplorationbaseline-{variant}")(
        load_config("tiny", overrides=LIGHT), device="cpu",
        with_perception=False)
    assert tr.generate(4) == [] and tr._step == 4
    assert all(g is not None for g in tr._pending_goal)
    tr.envs.close()


def test_goalexploration_v3_image_history():
    tr = get_trainer("goalexplorationbaseline-v3")(
        load_config("tiny", overrides=LIGHT), device="cpu",
        with_perception=False)
    assert tr.pcfg.input_channels == 8  # 4 frames x 2 channels
    assert tr.ppo_state.params["convs"][0]["w"].shape[1] == 8
    maps, _ = tr._policy_obs()
    assert maps.shape[-1] == 8
    maps2, _ = tr._policy_obs()
    # the history shifted: frame 0 of the new stack is frame 1 of the old
    np.testing.assert_allclose(maps2[..., 4:6], maps[..., 6:8])
    tr.generate(4)
    assert tr._step == 4
    tr.envs.close()


def test_goalexploration_recurrent_gru_train():
    """The GRU state threads through the decisions, and PPO evaluates
    again against the stored pre-step states."""
    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=2", "sensors.height=48", "sensors.width=48",
        "sim.scene_size=6.0", "sim.num_objects=4", "map.voxel_size=0.1",
        "ppo.num_global_steps=2", "ppo.ppo_epoch=1", "ppo.num_mini_batch=2",
        "policy.recurrent=true", "policy.map_size=32"])
    tr = get_trainer("goalexplorationbaseline-v0")(cfg, device="cpu",
                                                   with_perception=False)
    assert tr._rnn is not None and tr._rnn.shape == (2, tr.RNN_DIM)
    before = tr._rnn.copy()
    seen = []
    own = GE.ppo_update
    try:
        GE.ppo_update = lambda s, r, g, c: seen.append(r) or own(s, r, g, c)
        metrics = tr.train(num_updates=1, decisions_per_update=2)
    finally:
        GE.ppo_update = own
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])
    assert not np.allclose(tr._rnn, before)  # the GRU state advanced
    states = seen[0].rnn_states
    assert states.shape == (2, 2, tr.RNN_DIM)
    np.testing.assert_array_equal(states[0], before)  # pre-step states
    assert not np.array_equal(states[1], states[0])
    tr.envs.close()


def test_goalexploration_fused_train():
    """Fused PPO windows (`BaseTrainer.fused_window`): the host sims are
    stepped for the plan and take the device pose after; a second update
    crosses the episode boundary (step 8) at a window's edge: the envs
    reset, their masks are 0 there, and training goes on."""
    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=2", "sensors.height=48", "sensors.width=48",
        "sim.scene_size=6.0", "sim.num_objects=4", "sim.episode_steps=8",
        "map.voxel_size=0.1", "ppo.num_global_steps=2", "ppo.ppo_epoch=1",
        "ppo.num_mini_batch=2", "runtime.caption_slots_per_frame=2",
        "detector.score_threshold=0.2"])
    tr = get_trainer("goalexplorationbaseline-v0")(cfg, device="cpu")
    seen = []
    own = GE.ppo_update
    try:
        GE.ppo_update = lambda s, r, g, c: seen.append(
            r.masks.copy()) or own(s, r, g, c)
        metrics = tr.train(num_updates=1, decisions_per_update=2, fused=True)
        assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])
        assert tr._step == 4  # 1 update x 2 decisions x window 2
        for env in tr.envs.envs:
            assert np.isfinite(env.sim.agent.x) and env.get_step() == 4
        metrics = tr.train(num_updates=1, decisions_per_update=2, fused=True)
    finally:
        GE.ppo_update = own
    assert np.isfinite(metrics[-1]["loss"]) and tr._step == 8
    assert (seen[0] == 1).all() and (seen[1][-1] == 0).all()
    assert all(e.get_step() == 0 and e.get_episode_id() % 100000 == 1
               for e in tr.envs.envs)
    # a window that does not divide the episode is refused
    tr.cfg = dataclasses.replace(tr.cfg, ppo=dataclasses.replace(
        tr.cfg.ppo, num_global_steps=3))
    with pytest.raises(ValueError):
        tr.train(num_updates=1, decisions_per_update=1, fused=True)
    tr.envs.close()


# ---------------------------------------------------------------------------
# checkpoints, the logging trainer, the captioning baseline, the CLI
# ---------------------------------------------------------------------------

def _ckpt_cfg(tmp_path, sub):
    return LIGHT + ["policy.map_size=32",
                    f"runtime.checkpoint_dir={tmp_path}/{sub}"]


def test_checkpoint_interchange(tmp_path):
    """A policy.pkl of either package loads in the other: the same arrays
    (conv kernels HWIO on disk) and policy_forward outputs within 2 bf16
    ulps."""
    maps = np.random.default_rng(0).random((3, 32, 32, 2)).astype(np.float32)
    orient = np.asarray([0, 17, 71], np.int32)
    # port -> JAX
    tr = get_trainer("goalexplorationbaseline-v0")(
        load_config("tiny", overrides=_ckpt_cfg(tmp_path, "t")),
        device="cpu", with_perception=False)
    path = tr.save_checkpoint()
    assert path == f"{tmp_path}/t/policy.pkl"
    jtr = jget("goalexplorationbaseline-v0")(
        jload("tiny", overrides=_ckpt_cfg(tmp_path, "t")),
        with_perception=False)  # loads the port's checkpoint on init
    with open(path, "rb") as fh:
        host = pickle.load(fh)
    assert host["convs"][0]["w"].shape == (3, 3, 2, 32)
    for a, b in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(_np(jtr.ppo_state.params))):
        np.testing.assert_array_equal(a, b)
    want = JP.policy_forward(jtr.ppo_state.params, maps, orient)
    got = TP.policy_forward(tr.ppo_state.params, torch.from_numpy(maps),
                            torch.from_numpy(orient))
    for g, w in ((got.value, want.value), (got.mean, want.mean)):
        np.testing.assert_allclose(np32(g), np32(w), rtol=0,
                                   atol=2 ** -6 * np.abs(np32(w)).max())
    # JAX -> port
    jtr2 = jget("goalexplorationbaseline-v0")(
        jload("tiny", overrides=_ckpt_cfg(tmp_path, "j")),
        with_perception=False)
    jtr2.save_checkpoint()
    tr2 = get_trainer("goalexplorationbaseline-v0")(
        load_config("tiny", overrides=_ckpt_cfg(tmp_path, "j")),
        device="cpu", with_perception=False)  # loads on init
    for a, b in zip(TPPO.tree_leaves(tr2.ppo_state.params),
                    TPPO.tree_leaves(P.from_jax(_np(jtr2.ppo_state.params),
                                                "cpu"))):
        assert torch.equal(a, b)
    assert tr2.ppo_state.opt_state.count == 0
    tr.envs.close(), tr2.envs.close(), jtr.envs.close(), jtr2.envs.close()


def test_informative_trajectories_logs_each_update(tmp_path):
    cfg = load_config("tiny", overrides=_ckpt_cfg(tmp_path, "c") + [
        "ppo.num_global_steps=2", "ppo.ppo_epoch=1"])
    tr = get_trainer("informative-trajectories-v0")(
        cfg, device="cpu", with_perception=False)
    metrics = tr.train(num_updates=2, decisions_per_update=2)
    tr.logger.close()
    with open(tmp_path / "c" / "informative_trajectories.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [0, 1]
    for row, m in zip(rows, metrics):
        assert {k: row[k] for k in m} == m
        assert np.isfinite(row["mean_env_reward"])
        assert row["max_env_reward"] >= row["mean_env_reward"]
    assert os.path.exists(tmp_path / "c" / "policy.pkl")
    tr.envs.close()


def test_random_goals_captioner_records_ground_truth_captions(tmp_path):
    """`randomgoalsbaselinecaptioner` captions the simulator's ground-truth
    boxes: the same files as the JAX trainer's, the same boxes, classes
    and validity (the render's instances are equal), and a caption and a
    unit embedding for each valid box."""
    ov = GENERATE_OVERRIDES[:4] + ["map.voxel_size=0.2"]
    name = "randomgoalsbaselinecaptioner"
    jtr = jget(name)(jload("tiny", overrides=ov + [
        f"runtime.obs_dir={tmp_path}/j"]))
    cfg = load_config("tiny", overrides=ov + [f"runtime.obs_dir={tmp_path}/t"])
    tr = get_trainer(name)(cfg, device="cpu", perceiver=Perceiver(
        cfg, params=P.from_jax(_np(jtr.perceiver.params), "cpu"),
        device="cpu"))
    jpaths, paths = jtr.generate(2), tr.generate(2)
    rel = [sorted(os.path.relpath(p, f"{tmp_path}/{d}") for p in ps)
           for ps, d in ((jpaths, "j"), (paths, "t"))]
    assert rel[0] == rel[1] and len(rel[1]) == 2 * 2 * 4
    n_valid = 0
    for r in rel[1]:
        if "modality_bbs" not in r:
            continue
        got, want = (np.load(f"{tmp_path}/{d}/{r}", allow_pickle=True)[
            "arr_0"].item()["instances"] for d in ("t", "j"))
        for k in ("boxes", "classes", "valid"):
            np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                          np.asarray(want[k], np.float32),
                                          err_msg=k)
        valid = np.asarray(got["valid"], bool)
        n_valid += valid.sum()
        norms = np.linalg.norm(got["embeddings"][valid], axis=-1)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-2)
        assert all(isinstance(c, str) for c in got["captions"])
    assert n_valid > 0
    assert np.isfinite(tr.rewards()).all()
    tr.envs.close()
    jtr.envs.close()


def test_run_exp_train_on_cpu(tmp_path, capsys):
    argv = ["--trainer", "goalexplorationbaseline-v0", "--mode", "train",
            "--preset", "tiny", "--steps", "1", "ppo.num_global_steps=2",
            "runtime.num_envs=2", "sensors.height=64", "sensors.width=64",
            f"runtime.checkpoint_dir={tmp_path}"]
    assert run_exp.main(argv + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "train" and out["updates"] == 1
    assert len(out["metrics"]) == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    assert set(out["metrics"][0]) == {"loss", "action_loss", "value_loss",
                                      "entropy"}
    assert os.path.exists(tmp_path / "policy.pkl")
    assert run_exp.main(["--trainer", "myppo", "--mode", "train",
                         "--device", "cpu"]) == 2
    assert "ROADMAP A.15" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # the default device is the card
        assert run_exp.main(argv) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_kl_env_reward_is_zero_in_fused_windows():
    """ROADMAP C.19: the KL env's reward reads the detections of the frame
    handed to `set_last_frame`, which `fused_window` never calls, so
    `train(fused=True)` on SemanticDisagreement-kl gets zero rewards in
    both packages, though the maps fuse the frames."""
    ov = SLICE + ["runtime.env_name=SemanticDisagreement-kl"]
    rewards = {}
    for key, trainer, module in (
            ("jax", jget("goalexplorationbaseline-v0")(
                jload("tiny", overrides=ov)), JGE),
            ("port", get_trainer("goalexplorationbaseline-v0")(
                load_config("tiny", overrides=ov), device="cpu"), GE)):
        own = module.ppo_update
        try:
            module.ppo_update = lambda s, r, *a, **k: rewards.setdefault(
                key, np.asarray(r.rewards)) is None or own(s, r, *a, **k)
            trainer.train(num_updates=1, decisions_per_update=2, fused=True)
        finally:
            module.ppo_update = own
        if key == "port":
            fused = sum(float(env.map_state.count.sum())
                        for env in trainer.envs.envs)
        trainer.envs.close()
    assert not rewards["jax"].any() and not rewards["port"].any()
    assert fused > 0  # the voxels the windows fused
