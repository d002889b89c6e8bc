"""The port's exploration entry point (agents/baselines.py, run_exp.py)
against the JAX package's `BaseTrainer.generate` loop.

- Fusion on handed detections (ROADMAP C.1, the unfused protocol: the
  pre-step frame, masks upsampled to the sensor): the port's
  `perceive_and_fuse` is handed the JAX trainer's detections and frames
  at every step; its KL and disagreement rewards and top-down maps match
  the JAX trainer's in every env within rtol 1e-4 / atol 1e-5 (the JAX
  package's loop tolerance, tests/test_device_loop.py).
- The whole slice on handed frames: the port's own perception (same float
  weights, block decode route) on the JAX frames, the same tolerance, on
  env 0 of scene seed 12 (`python tests/torch_parity.py generate-scan`:
  env 1 of that seed flips a greedy token, ROADMAP C.12).
- `generate` of `randombaseline` and `bouncebaseline` in both packages:
  equal actions and equal saved file sets; the other baselines' actions.
- The port's twin of test_rollout_fused_matches_unfused_env_loop.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import embodied_captioning_tpu.agents.baselines  # noqa: F401
from embodied_captioning_tpu.agents.registry import get_trainer as jget
from embodied_captioning_tpu.config import load_config as jload
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch import run_exp
from embodied_captioning_tpu_torch.agents.registry import get_trainer
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.envs import device_loop as DL
from embodied_captioning_tpu_torch.envs.env import EmbodiedEnv
from embodied_captioning_tpu_torch.mapping import voxel_map as V
from embodied_captioning_tpu_torch.perception import Perceiver
from torch_parity import (
    GENERATE_OVERRIDES, jax_generate_records, port_generate_on,
    readouts_agree)

SEED = 12
STEPS = 4


@pytest.fixture(scope="module")
def records():
    ov = GENERATE_OVERRIDES + [f"sim.scene_seed={SEED}"]
    jtr, recs = jax_generate_records(jload("tiny", overrides=ov), STEPS)
    params = P.from_jax(jax.tree_util.tree_map(np.asarray,
                                               jtr.perceiver.params), "cpu")
    return load_config("tiny", overrides=ov), params, recs


def _check(got, recs, envs):
    for k, (g, r) in enumerate(zip(got, recs)):
        for i in envs:
            assert readouts_agree(g, r, i), (k, i, g["kl"], r["kl"],
                                             g["disagreement"],
                                             r["disagreement"])


def test_fusion_on_handed_detections_matches_jax(records):
    cfg, params, recs = records
    got = port_generate_on(cfg, params, recs, detections=True)
    _check(got, recs, envs=(0, 1))
    for g, r in zip(got, recs):
        for a, b in zip(g["maps"], r["maps"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # not vacuous: both rewards move in both envs
    for key in ("kl", "disagreement"):
        for i in (0, 1):
            assert max(r[key][i] for r in recs) > 1e-4, (key, i)


def test_generate_matches_jax_on_handed_frames(records):
    cfg, params, recs = records
    got = port_generate_on(cfg, params, recs, frames="handed")
    _check(got, recs, envs=(0,))
    assert max(r["disagreement"][0] for r in recs) > 1e-3


def test_rollout_fused_matches_unfused_env_loop():
    """The port's fused loop gives the port's unfused env loop's rewards
    (env.step_state -> observe -> perceive -> update_pointcloud ->
    get_reward), rtol 1e-4 / atol 1e-5: fusing is a scheduling change."""
    cfg = load_config("tiny", overrides=[
        "sensors.height=64", "sensors.width=64", "sim.num_objects=6",
        "sim.scene_size=8.0", "map.voxel_size=0.2",
        "runtime.caption_slots_per_frame=2", "detector.score_threshold=0.0"])
    # weights of generator seed 1: those of seed 0 detect nothing that
    # gets two captions in these scenes
    params = P.init_perception(torch.Generator().manual_seed(1), cfg, "cpu")
    actions = DL.make_action_plan(4, 1, pattern="random", seed=5)
    env = EmbodiedEnv(cfg, env_id=0, seed=11, device="cpu")
    host = []
    for k in range(4):
        env.step_state(int(actions[k, 0]))
        obs = env.observe()
        det = DL.perceive(params, obs["rgb"][None], cfg).detections.index(0)
        env.update_pointcloud(det, depth=obs["depth"], pose=env.camera_pose())
        host.append(env.get_reward())
    env2 = EmbodiedEnv(cfg, env_id=0, seed=11, device="cpu")
    scenes, state = DL.states_from_sims([env2.sim])
    maps = V.VoxelMapState(*(x[None] for x in env2.map_state))
    rewards = DL.rollout_fused(params, scenes, state, maps, actions, cfg)[2]
    np.testing.assert_allclose(rewards[:, 0].numpy(), host, rtol=1e-4,
                               atol=1e-5)
    assert max(host) > 1e-4


def _generate_both(name, tmp_path, ov, steps):
    """The trainer `name` in both packages with the JAX trainer's weights:
    (actions per step of each, saved paths of each)."""
    jcfg = jload("tiny", overrides=ov + [f"runtime.obs_dir={tmp_path}/j"])
    cfg = load_config("tiny", overrides=ov + [f"runtime.obs_dir={tmp_path}/t"])
    jtr = jget(name)(jcfg)
    params = P.from_jax(jax.tree_util.tree_map(np.asarray,
                                               jtr.perceiver.params), "cpu")
    tr = get_trainer(name)(cfg, device="cpu",
                           perceiver=Perceiver(cfg, params=params,
                                               device="cpu"))
    acts = {}
    for key, t in (("jax", jtr), ("port", tr)):
        acts[key] = []
        own = t.actions
        t.actions = lambda obs, own=own, log=acts[key]: log.append(
            [int(a) for a in own(obs)]) or log[-1]
    paths = {"jax": jtr.generate(steps), "port": tr.generate(steps)}
    tr.envs.close()
    jtr.envs.close()
    rel = {k: sorted(os.path.relpath(p, f"{tmp_path}/{d}")
                     for p in paths[k])
           for k, d in (("jax", "j"), ("port", "t"))}
    return acts, rel, tr


@pytest.mark.parametrize("name", ["randombaseline", "bouncebaseline"])
def test_generate_actions_and_files_equal_jax(name, tmp_path):
    ov = GENERATE_OVERRIDES[:-1] + ["sim.episode_steps=3"]
    acts, rel, tr = _generate_both(name, tmp_path, ov, steps=4)
    assert acts["port"] == acts["jax"] and len(acts["port"]) == 4
    assert rel["port"] == rel["jax"] and len(rel["port"]) == 4 * 2 * 4
    # the auto-reset started episode 1 of each env
    assert any("episode_000001" in p for p in rel["port"])
    assert np.isfinite(tr.rewards()).all()


@pytest.mark.parametrize("name", ["rotatebaseline", "randomgoalsbaseline",
                                  "frontierbaseline-v1",
                                  "observeobjectbaseline"])
def test_other_baselines_act_as_jax(name):
    ov = ["runtime.num_envs=2", "sensors.height=32", "sensors.width=32",
          "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2"]
    jtr = jget(name)(jload("tiny", overrides=ov), with_perception=False)
    tr = get_trainer(name)(load_config("tiny", overrides=ov), device="cpu",
                           with_perception=False)
    for _ in range(6):
        a, ja = tr.actions(None), jtr.actions(None)
        assert [int(x) for x in a] == [int(x) for x in ja]
        tr.envs.step(a), jtr.envs.step(ja)
    assert tr.perceiver is None and tr.generate(1) == []


def test_fused_window_runs_the_plan_and_resets():
    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=2", "sensors.height=64", "sensors.width=64",
        "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2",
        "sim.episode_steps=4", "runtime.caption_slots_per_frame=2",
        "detector.score_threshold=0.0"])
    tr = get_trainer("randombaseline")(cfg, device="cpu")
    done = tr.fused_window(2)
    assert not done.any() and tr._step == 2
    assert all(e.get_step() == 2 for e in tr.envs.envs)
    assert np.isfinite(tr.rewards()).all()
    done = tr.fused_window(2)
    assert done.all() and all(e.get_step() == 0 and e.get_episode_id() % 10
                              == 1 for e in tr.envs.envs)
    tr.envs.close()


def test_perceiver_takes_tensors_and_numpy():
    """`Perceiver.process` on a tensor equals it on the same numpy frames
    (the tensor is used where it lies)."""
    cfg = load_config("tiny", overrides=["detector.score_threshold=0.0"])
    per = Perceiver(cfg, seed=1, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 80, 3),
                                               dtype=np.uint8)
    a, b = per.process(frames), per.process(torch.from_numpy(frames))
    for x, y in zip(jax.tree_util.tree_leaves(a.detections.to_numpy_dict()),
                    jax.tree_util.tree_leaves(b.detections.to_numpy_dict())):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert int(a.detections.count().sum()) > 0
    one = per.process(torch.from_numpy(frames[0]))
    assert torch.equal(one.caption_tokens[0], a.caption_tokens[0])


def test_run_exp_cli_on_cpu(tmp_path, capsys):
    argv = ["--trainer", "randombaseline", "--mode", "generate", "--preset",
            "tiny", "--steps", "4", "--obs-dir", str(tmp_path), "--device",
            "cpu", "runtime.num_envs=2", "sensors.height=64",
            "sensors.width=64"]
    assert run_exp.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "generate" and out["frames"] == 8
    assert out["saved_files"] == 4 * 2 * 4
    assert all(np.isfinite(out["rewards"])) and len(out["rewards"]) == 2
    assert sum(len(f) for _, _, f in os.walk(tmp_path)) == 32
    # --mode train runs (tests/test_torch_trainers.py); the distributed
    # PPO trainer is not ported
    assert run_exp.main(["--trainer", "myppo"] + argv[2:4]) == 2
    assert "ROADMAP A.15" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # the default device is the card
        assert run_exp.main(argv[:10] + argv[12:]) == 2
        assert "no CUDA device" in capsys.readouterr().err
