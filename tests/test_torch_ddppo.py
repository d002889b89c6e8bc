"""The port's checkpoint manager and the distributed PPO trainer
("myppo", agents/ddppo.py) against the JAX package's.

- `CheckpointManager` beside the JAX package's orbax manager on one save
  sequence (a repeated and an older step included): the same latest step,
  the same steps kept under max_to_keep, the same restored trees and
  metadata. The formats differ (ROADMAP C): each reads its own.
- At world size 1 `myppo` is `goalexplorationbaseline-v0` bit for bit.
- At world size 2 on gloo (`torch_dist.ddppo`): the ranks step the envs a
  single process steps (env ids; the rollouts' maps, orientations,
  rewards and masks bit for bit, the policy's outputs within 1e-5, since
  the policy forward sees 2 rows in place of 4); the update on a handed
  rollout and handed permutations against JAX `ppo_update` at
  `tests/test_torch_policy.py`'s limits (C.20: metrics to 2e-3, parameters
  within 2 lr a step, the mean difference under a tenth of the mean
  move), and against the port's single-process `ppo_update_with`;
  SIGTERM on one rank stops both at the update boundary; num_envs not
  divisible by the world size is refused.
- The SIGTERM, resume and requeue path of JAX
  `test_myppo_sigterm_preemption_and_resume`.
"""

import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.agents import policy as JP
from embodied_captioning_tpu.agents import ppo as JPPO
from embodied_captioning_tpu.config import PolicyConfig as JPolicyConfig
from embodied_captioning_tpu.config import PPOConfig as JPPOConfig
from embodied_captioning_tpu.utils.checkpoint import (
    CheckpointManager as JManager,
)
from embodied_captioning_tpu_torch.agents import get_trainer
from embodied_captioning_tpu_torch.agents import ppo as TPPO
from embodied_captioning_tpu_torch.agents.storage import Rollout
from embodied_captioning_tpu_torch.config import PPOConfig, load_config
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.train.optim import tree_leaves
from embodied_captioning_tpu_torch.utils.checkpoint import (
    CheckpointManager, PreemptionGuard,
)
from torch_dist import run

WORLD = 2
OVERRIDES = ["runtime.num_envs=4", "sensors.height=32", "sensors.width=32",
             "sim.scene_size=6.0", "sim.num_objects=3",
             "sim.episode_steps=64", "map.voxel_size=0.2",
             "ppo.num_global_steps=1", "ppo.num_mini_batch=2",
             "ppo.ppo_epoch=2"]
PPO = dict(num_mini_batch=2, ppo_epoch=2)


def _cfg(ckpt, overrides=OVERRIDES):
    return load_config("tiny", overrides=overrides + [
        f"runtime.checkpoint_dir={ckpt}"])


def _leaves(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_manager_beside_orbax(tmp_path):
    saves = [(1, {"w": np.arange(4.0, dtype=np.float32), "n": np.int32(3)},
              {"note": "one"}),
             (2, {"w": np.full(4, 2.0, np.float32), "n": np.int32(4)}, None),
             (3, {"w": np.full(4, 3.0, np.float32), "n": np.int32(5)},
              {"note": "three"}),
             (3, {"w": np.zeros(4, np.float32), "n": np.int32(0)}, None),
             (2, {"w": np.zeros(4, np.float32), "n": np.int32(0)}, None),
             (5, {"w": np.full(4, 5.0, np.float32), "n": np.int32(7)},
              {"note": "five"})]
    jm = JManager(str(tmp_path / "orbax"), max_to_keep=2)
    tm = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    assert tm.latest_step() is None and tm.restore({"w": 0}) is None
    for step, state, meta in saves:
        jm.save(step, jax.tree_util.tree_map(jnp.asarray, state),
                metadata=meta)
        tm.save(step, state, metadata=meta)
        assert tm.latest_step() == jm.latest_step()
        assert tm.all_steps() == list(jm._mgr.all_steps())
    template = {"w": np.zeros(4, np.float32), "n": np.int32(0)}
    for step in (None, 3):
        jstate, jmeta = jm.restore(
            jax.tree_util.tree_map(jnp.asarray, template), step=step,
            with_metadata=True)
        tstate, tmeta = tm.restore(template, step=step, with_metadata=True)
        assert tmeta == jmeta
        for k in template:
            np.testing.assert_array_equal(tstate[k], np.asarray(jstate[k]))
            assert tstate[k].dtype == template[k].dtype
    jm.close()
    tm.close()
    # a tree of tensors, a NamedTuple and a Python counter come back in
    # the template's types
    state = TPPO.PPOState({"a": torch.arange(3.0)},
                          TPPO.AdamState(4, {"a": torch.ones(3)},
                                         {"a": torch.zeros(3)}))
    tm.save(9, state)
    back = tm.restore(TPPO.create_state({"a": torch.zeros(3)}, PPOConfig()))
    assert isinstance(back, TPPO.PPOState) and back.opt_state.count == 4
    assert torch.equal(back.params["a"], state.params["a"])
    assert sorted(os.listdir(tmp_path / "port")) == ["5", "9"]


def test_preemption_guard():
    calls = []
    g = PreemptionGuard(on_exit=lambda: calls.append(1))
    g.install()
    g.finalize()
    assert calls == [] and not g.should_exit
    old = signal.getsignal(signal.SIGUSR1)
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert g.should_exit
    finally:
        signal.signal(signal.SIGUSR1, old)
    g.finalize()
    assert calls == [1]
    # off the main thread it does not install
    other = PreemptionGuard()
    t = threading.Thread(target=other.install)
    t.start()
    t.join()
    assert not other._installed


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------

def test_myppo_world_one_is_v0_bit_for_bit(tmp_path):
    v0 = get_trainer("goalexplorationbaseline-v0")(
        _cfg(tmp_path / "v0"), with_perception=False, device="cpu")
    mv = v0.train(num_updates=2, decisions_per_update=2)
    tr = get_trainer("myppo")(_cfg(tmp_path / "dd"), with_perception=False,
                              device="cpu")
    assert tr.world == 1 and tr.group is None
    md = tr.train(num_updates=2, decisions_per_update=2)
    assert md == mv
    for a, b in zip(tree_leaves(v0.ppo_state), tree_leaves(tr.ppo_state)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    # the resume state (params and optimizer state), and no policy.pkl
    assert tr.ckpt_mgr.latest_step() == tr._update_idx == 2
    assert not os.path.exists(tmp_path / "dd" / "policy.pkl")
    tr2 = get_trainer("myppo")(_cfg(tmp_path / "dd"), with_perception=False,
                               device="cpu")
    assert tr2._update_idx == 2
    for a, b in zip(tree_leaves(tr2.ppo_state), tree_leaves(tr.ppo_state)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    v0.envs.close()
    tr.envs.close()
    tr2.envs.close()


def test_myppo_sigterm_preemption_and_resume(tmp_path, monkeypatch):
    """A real SIGTERM mid-train stops the loop early, writes the resume
    checkpoint, fires ECAP_REQUEUE_CMD, and a fresh trainer resumes at the
    saved update index and trains on."""
    marker = tmp_path / "requeued.marker"
    monkeypatch.setenv("ECAP_REQUEUE_CMD", f"touch {marker}")
    cfg = _cfg(tmp_path / "ckpt", OVERRIDES[1:] + ["runtime.num_envs=8"])
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr = get_trainer("myppo")(cfg, with_perception=False, device="cpu")
        pid = os.getpid()
        timer = threading.Timer(0.5, lambda: os.kill(pid, signal.SIGTERM))
        timer.start()
        try:
            metrics = tr.train(num_updates=50, decisions_per_update=2)
        finally:
            timer.cancel()
        assert tr.guard.should_exit
        assert 1 <= len(metrics) < 50
        assert tr.ckpt_mgr.latest_step() == tr._update_idx
        assert marker.exists()
        tr2 = get_trainer("myppo")(cfg, with_perception=False, device="cpu")
        assert tr2._update_idx == tr._update_idx
        more = tr2.train(num_updates=1, decisions_per_update=2)
        assert np.isfinite(more[-1]["loss"])
        assert tr2._update_idx == tr._update_idx + 1
    finally:
        signal.signal(signal.SIGTERM, old)
    tr.envs.close()
    tr2.envs.close()


# ---------------------------------------------------------------------------
# world size 2
# ---------------------------------------------------------------------------

def _rollout(map_size: int, t: int, e: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return Rollout(
        maps=rng.random((t + 1, e, map_size, map_size, 2)).astype(np.float32),
        orientation=rng.integers(0, 72, (t + 1, e)).astype(np.int32),
        raw_actions=rng.standard_normal((t, e, 2)).astype(np.float32),
        log_probs=(rng.standard_normal((t, e)) - 2).astype(np.float32),
        values=rng.random((t + 1, e)).astype(np.float32),
        rewards=rng.random((t, e)).astype(np.float32),
        masks=(rng.random((t + 1, e)) > 0.2).astype(np.float32),
        rnn_states=None)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jcfg = JPPOConfig(**PPO)
    jp = JP.init_policy(jax.random.PRNGKey(0), JPolicyConfig(map_size=32),
                        num_actions=2)
    ro = _rollout(32, 4, 4)
    key = jax.random.PRNGKey(3)
    jstate, jm = JPPO.ppo_update(JPPO.create_state(jp, jcfg), ro, key, jcfg)
    perms = [np.asarray(jax.random.permutation(k, 16))
             for k in jax.random.split(key, jcfg.ppo_epoch)]
    policy = jax.tree_util.tree_map(np.asarray, jp)
    tmp = tmp_path_factory.mktemp("ddppo")
    ranks = run("ddppo", WORLD, tmp, dict(
        rollout=tuple(ro), perms=perms, ppo=PPO, policy=policy,
        overrides=OVERRIDES, updates=1))
    # one process stepping all 4 envs
    one = get_trainer("myppo")(_cfg(tmp / "one"), with_perception=False,
                               device="cpu")
    seen = []
    update = one._ppo_update
    one._ppo_update = lambda r: (seen.append(r), update(r))[1]
    one.train(num_updates=1, decisions_per_update=2)
    one.envs.close()
    return dict(ranks=ranks, ro=ro, perms=perms, policy=policy,
                jparams=_leaves(from_jax(jax.tree_util.tree_map(
                    np.asarray, jstate.params), "cpu")),
                jmetrics={k: float(v) for k, v in jm.items()}, one=seen[0])


def _held_to(got, want, p0, cfg, steps):
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    move = np.concatenate([np.abs(w - p).ravel() for w, p in zip(want, p0)])
    assert diff.max() <= 2 * cfg.lr * steps
    assert diff.mean() <= 0.1 * move.mean()
    assert move.mean() > 0.5 * cfg.lr


def test_ddppo_update_matches_jax(world2):
    cfg = PPOConfig(**PPO)
    steps = cfg.ppo_epoch * cfg.num_mini_batch
    tp = from_jax(world2["policy"], "cpu")
    p0 = _leaves(tp)
    single, sm = TPPO.ppo_update_with(
        TPPO.create_state(tp, cfg), world2["ro"],
        [torch.from_numpy(p) for p in world2["perms"]], cfg)
    for out in world2["ranks"]:
        up = out["update"]
        assert up["count"] == steps
        for k, v in world2["jmetrics"].items():
            np.testing.assert_allclose(up["metrics"][k], v, rtol=2e-3)
            np.testing.assert_allclose(up["metrics"][k], float(sm[k]),
                                       rtol=2e-3)
        _held_to(up["params"], world2["jparams"], p0, cfg, steps)
        _held_to(up["params"], _leaves(single.params), p0, cfg, steps)
    # both ranks hold the same parameters after the update
    for a, b in zip(*(r["update"]["params"] for r in world2["ranks"])):
        np.testing.assert_array_equal(a, b)


def test_ddppo_ranks_step_one_process_envs(world2):
    one = world2["one"]
    for r, out in enumerate(world2["ranks"]):
        tr = out["trainer"]
        assert tr["env_ids"] == [2 * r, 2 * r + 1]
        got = tr["rollouts"][0]
        cols = slice(2 * r, 2 * r + 2)
        for name in ("maps", "orientation", "rewards", "masks"):
            np.testing.assert_array_equal(got[name],
                                          getattr(one, name)[:, cols])
        for name in ("raw_actions", "log_probs", "values"):
            np.testing.assert_allclose(got[name],
                                       getattr(one, name)[:, cols],
                                       rtol=1e-5, atol=1e-5)
        assert len(tr["metrics"]) == 1 and tr["update_idx"] == 1
        assert np.isfinite(tr["metrics"][0]["loss"])
    a, b = (o["trainer"]["params"] for o in world2["ranks"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert world2["ranks"][0]["trainer"]["saved"] == [1]


def test_ddppo_sigterm_on_one_rank_stops_both(world2):
    for out in world2["ranks"]:
        assert out["resumed_idx"] == 1
        pre = out["preempted"]
        assert pre["should_exit"] and pre["updates"] == 1
        assert pre["idx"] == 2 and pre["saved"] == 2


def test_ddppo_refuses_indivisible_envs(world2):
    for out in world2["ranks"]:
        msg = out["refusal"]
        assert msg is not None
        assert "runtime.num_envs=3" in msg and "world size 2" in msg
