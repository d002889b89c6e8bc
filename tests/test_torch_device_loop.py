"""The port's fused exploration loop (envs/device_loop.py) against the JAX
package's `step_agents`, `camera_poses` and `rollout_fused` (the fused
protocol: post-step frames, depth brought down to the mask raster), on
both decode routes: the port's default (whole-block kernels) against the
JAX loop with ECAP_USE_PALLAS=1 and ECAP_PALLAS_BLOCKS=1, and the route of
separate calls (`decode_blocks=False`) against ECAP_USE_PALLAS=1 alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import load_config
from embodied_captioning_tpu.envs import device_loop as JDL
from embodied_captioning_tpu.envs.sim import RaycastSim as JSim
from embodied_captioning_tpu.mapping import voxel_map as JV
from embodied_captioning_tpu.perception import init_perception
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch.config import (
    ExperimentConfig, apply_dotlist)
from embodied_captioning_tpu_torch.envs import device_loop as DL
from embodied_captioning_tpu_torch.envs.sim import RaycastSim
from embodied_captioning_tpu_torch.mapping import voxel_map as V
from torch_parity import jax_kernel_path

# the tiny settings of the JAX package's device-loop tests; the detector
# threshold is 0 so that the random-weight detector yields detections
OVERRIDES = ["sensors.height=64", "sensors.width=64", "sim.num_objects=6",
             "sim.scene_size=8.0", "map.voxel_size=0.2",
             "runtime.caption_slots_per_frame=2",
             "detector.score_threshold=0.0"]


@pytest.fixture(scope="module")
def cfgs():
    return (load_config("tiny", overrides=OVERRIDES),
            apply_dotlist(ExperimentConfig.preset_config("tiny"), OVERRIDES))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_configs_agree(cfgs):
    jcfg, cfg = cfgs
    for part in ("sensors", "sim", "map", "ppo"):
        for f in getattr(cfg, part).__dataclass_fields__:
            assert getattr(getattr(cfg, part), f) == getattr(
                getattr(jcfg, part), f), (part, f)
    large, jlarge = ExperimentConfig.preset_config("large"), load_config(
        "large")
    assert large.sensors.height == jlarge.sensors.height == 1280
    assert large.map.grid == jlarge.map.grid == (256, 64, 256)
    assert large.map.max_objects == jlarge.map.max_objects == 128


def test_step_agents_match_jax_and_host_sim(cfgs):
    """60 mixed actions with collision rejections: the port's step_agents
    against the JAX function (x, z within 1e-6: XLA fuses the multiply-add
    of the forward step; yaw and collided equal) and against the port's
    host RaycastSim.step (float64 on the host: 1e-5, yaw 1e-4)."""
    jcfg, cfg = cfgs
    sims = [RaycastSim(cfg.sim, cfg.sensors, seed=s, device="cpu")
            for s in (3, 7)]
    jsims = [JSim(jcfg.sim, jcfg.sensors, seed=s) for s in (3, 7)]
    scenes, state = DL.states_from_sims(sims)
    jscenes, jstate = JDL.states_from_sims(jsims)
    bridged = P.loop_state_from_jax(_np(jstate), "cpu")
    for f in state._fields:
        assert torch.equal(getattr(state, f), getattr(bridged, f))
        assert getattr(state, f).dtype == getattr(bridged, f).dtype
    rng = np.random.default_rng(0)
    actions = rng.integers(0, 4, size=(60, len(sims))).astype(np.int32)
    jstep = jax.jit(JDL.step_agents, static_argnames=("sim_cfg",))
    blocked = 0
    for k in range(actions.shape[0]):
        host_hit = [sim.step(int(a)) for sim, a in zip(sims, actions[k])]
        state = DL.step_agents(scenes, state, torch.from_numpy(actions[k]),
                               cfg.sim)
        jstate = jstep(jscenes, jstate, jnp.asarray(actions[k]), jcfg.sim)
        assert state.collided.tolist() == host_hit
        assert state.collided.tolist() == np.asarray(jstate.collided).tolist()
        blocked += sum(host_hit)
        for f, tol in (("x", 1e-6), ("z", 1e-6), ("yaw", 0.0)):
            np.testing.assert_allclose(getattr(state, f).numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       atol=tol, rtol=0)
        for f, tol in (("x", 1e-5), ("z", 1e-5), ("yaw", 1e-4)):
            np.testing.assert_allclose(getattr(state, f).numpy(),
                                       [getattr(s.agent, f) for s in sims],
                                       atol=tol)
    assert blocked > 0
    poses = DL.camera_poses(state).numpy()
    assert poses.dtype == np.float32
    # the sine and cosine of torch and of XLA differ in the last bit
    np.testing.assert_allclose(poses, np.asarray(JDL.camera_poses(jstate)),
                               atol=1e-6)
    for i, sim in enumerate(sims):
        np.testing.assert_allclose(poses[i], sim.agent.camera_matrix(),
                                   atol=1e-5)


@pytest.mark.parametrize("pattern", ["explore", "random"])
def test_make_action_plan_equals_jax(pattern):
    a = DL.make_action_plan(7, 3, pattern, seed=5)
    b = JDL.make_action_plan(7, 3, pattern, seed=5)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


# env seeds, and their columns of the 12-env random plan of seed 5: one env
# each with rewards from step 4, 3 and 2 on, and one whose first forward
# move is blocked
SEEDS, COLUMNS = (19, 30, 41, 10), (6, 5, 4, 9)
# the same for the whole-block decode route, on which env seed 30 flips a
# greedy token (`python tests/torch_parity.py rollout-scan-blocks`); env
# seed 24 (rewards from step 2 on) takes its place
BLOCK_SEEDS, BLOCK_COLUMNS = (19, 24, 41, 10), (6, 11, 4, 9)
K = 4


def _jax_rollout(jcfg, seeds, columns, blocks):
    """The JAX rollout_fused on four envs, plus the frames it renders
    (the same step and render functions, outside the scan)."""
    sims = [JSim(jcfg.sim, jcfg.sensors, seed=s) for s in seeds]
    scenes, state = JDL.states_from_sims(sims)
    maps = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JV.create(jcfg.map, np.asarray(s.scene.lower)) for s in sims])
    actions = np.ascontiguousarray(
        JDL.make_action_plan(K, 12, pattern="random", seed=5)[:, columns])
    params = init_perception(jax.random.PRNGKey(0), jcfg)
    start = dict(scenes=_np(scenes), state=_np(state), maps=_np(maps),
                 params=_np(params), actions=actions)
    frames, st = [], state
    for k in range(K):
        st = JDL.step_agents(scenes, st, jnp.asarray(actions[k]), jcfg.sim)
        rgb, depth, _, _ = JDL._render_scan(scenes, JDL.camera_poses(st),
                                            jcfg, True)
        frames.append({"rgb": torch.from_numpy(np.array(rgb)),
                       "depth": torch.from_numpy(np.array(depth))})
    with jax_kernel_path(blocks=blocks):
        st, maps, rewards, collided = JDL.rollout_fused(
            params, scenes, state, maps, jnp.asarray(actions),
            jax.random.PRNGKey(2), jcfg)
        out = dict(state=_np(st), maps=_np(maps), rewards=np.asarray(rewards),
                   collided=np.asarray(collided))
    return start, frames, out


@pytest.fixture(scope="module")
def jax_rollout(cfgs):
    return _jax_rollout(cfgs[0], SEEDS, COLUMNS, blocks=False)


@pytest.fixture(scope="module")
def jax_rollout_blocks(cfgs):
    return _jax_rollout(cfgs[0], BLOCK_SEEDS, BLOCK_COLUMNS, blocks=True)


def _port_inputs(start):
    return (P.from_jax(start["params"], "cpu"),
            P.scene_from_jax(start["scenes"], "cpu"),
            P.loop_state_from_jax(start["state"], "cpu"),
            P.map_state_from_jax(start["maps"], "cpu"))


def _check_rollout_on_handed_frames(cfg, jax_result, monkeypatch, n_envs,
                                    decode_blocks):
    start, frames, ref = jax_result
    params, scenes, state, maps = _port_inputs(start)
    handed = iter(frames)
    monkeypatch.setattr(DL, "_render_scan", lambda sc, poses, c: next(handed))
    monkeypatch.setattr(DL, "perceive", functools.partial(
        DL.perceive, decode_blocks=decode_blocks))
    state, maps, rewards, collided = DL.rollout_fused(
        params, scenes, state, maps, start["actions"], cfg)
    assert rewards.shape == (K, n_envs) and rewards.dtype == torch.float32
    assert (ref["rewards"][-1, :3] > 1e-4).all()      # not a vacuous check
    np.testing.assert_allclose(rewards.numpy(), ref["rewards"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(collided.numpy(), ref["collided"])
    assert ref["collided"].any()
    for f in ("x", "z", "yaw"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   getattr(ref["state"], f), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(state.collided.numpy(),
                                  ref["state"].collided)
    for f in ("obj_active", "obj_class", "obj_logit_cnt", "obj_emb_cnt"):
        np.testing.assert_array_equal(getattr(maps, f).numpy(),
                                      getattr(ref["maps"], f), err_msg=f)
    assert int(maps.obj_emb_cnt.max()) >= 2
    # the detector's mask probabilities are bf16: a pixel at the 0.5
    # threshold may fall on the other side (an object's point count within
    # 1% + 10 points, its position sum within 1% + 10 points x 8 m, the
    # voxel grids on all but 1e-3 of the voxels); logits and embeddings
    # come out of bf16 networks (1e-3 and 5e-3)
    for f, rtol, atol in (("obj_pts", 1e-2, 10.0), ("obj_pos_sum", 1e-2, 80.0),
                          ("obj_logits", 1e-3, 1e-3), ("obj_emb", 0, 5e-3)):
        a, b = getattr(maps, f).numpy(), getattr(ref["maps"], f)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f)
    for f in ("count", "vox_obj"):
        off = np.mean(getattr(maps, f).numpy() != getattr(ref["maps"], f))
        assert off < 1e-3, (f, off)


def test_rollout_fused_matches_jax_on_handed_frames(cfgs, jax_rollout,
                                                    monkeypatch):
    """The slice as a whole against the JAX `rollout_fused`: same float
    weights (PRNGKey(0) through the bridge), scenes, agents, empty maps and
    actions. The port's loop is handed the frames the JAX package renders:
    its own rgb differs by one level on ~0.5% of the pixels, which can move
    a box of the random-weight detector (see test_torch_sim.py for the
    render, and the own-frames test below). Rewards within rtol 1e-4 /
    atol 1e-5; collisions and poses equal; the object tables' flags,
    classes and counts equal and their float fields close. Both packages
    decode on the route of separate kernel calls (the port with
    `decode_blocks=False`, the JAX package with ECAP_USE_PALLAS=1), on
    which these env seeds were chosen."""
    _check_rollout_on_handed_frames(cfgs[1], jax_rollout, monkeypatch,
                                    len(SEEDS), decode_blocks=False)


def test_rollout_fused_block_route_matches_jax_on_handed_frames(
        cfgs, jax_rollout_blocks, monkeypatch):
    """The same on the port's default route, the whole-block decode
    kernels, against the JAX loop with ECAP_PALLAS_BLOCKS=1 as well; same
    tolerances, env seed 24 in place of 30."""
    _check_rollout_on_handed_frames(cfgs[1], jax_rollout_blocks, monkeypatch,
                                    len(BLOCK_SEEDS), decode_blocks=True)


def test_rollout_fused_on_own_frames(cfgs, jax_rollout):
    """The port's loop on its own render: agents, collisions and shapes as
    the JAX loop's (they do not depend on perception), finite rewards, and
    the input maps updated in place."""
    _, cfg = cfgs
    start, _, ref = jax_rollout
    params, scenes, state, maps = _port_inputs(start)
    timings = {}
    state, maps2, rewards, collided = DL.rollout_fused(
        params, scenes, state, maps, torch.from_numpy(start["actions"]), cfg,
        timings=timings)
    assert maps2.count is maps.count
    assert set(timings) == {"step_render", "perceive", "fuse_reward"}
    assert torch.isfinite(rewards).all() and (rewards >= 0).all()
    np.testing.assert_array_equal(collided.numpy(), ref["collided"])
    for f in ("x", "z", "yaw"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   getattr(ref["state"], f), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(maps2.obj_active.numpy().sum(-1) > 0,
                                  ref["maps"].obj_active.sum(-1) > 0)


def test_rollout_perception_and_depth_resize_branch(cfgs):
    """rollout_perception steps the agents as step_agents does and returns
    a finite checksum; with 80^2 sensors over the 64^2 mask raster the
    depth is resized, not strided, and rollout_fused still runs."""
    _, cfg = cfgs
    cfg = apply_dotlist(cfg, ["sensors.height=80", "sensors.width=80"])
    sims = [RaycastSim(cfg.sim, cfg.sensors, seed=s, device="cpu")
            for s in (1, 2)]
    scenes, state = DL.states_from_sims(sims)
    g = torch.Generator().manual_seed(0)
    params = P.init_perception(g, cfg, "cpu")
    actions = DL.make_action_plan(3, 2)
    want = state
    for acts in actions:
        want = DL.step_agents(scenes, want, torch.from_numpy(acts), cfg.sim)
    state2, checksum, n_valid = DL.rollout_perception(params, scenes, state,
                                                      actions, cfg)
    assert torch.isfinite(checksum) and int(n_valid) > 0
    for f in state2._fields:
        assert torch.equal(getattr(state2, f), getattr(want, f))
    assert (state2.x != state.x).any() or (state2.z != state.z).any()
    maps = V.create(cfg.map, scenes.lower, device="cpu")
    _, maps, rewards, collided = DL.rollout_fused(params, scenes, state, maps,
                                                  actions, cfg)
    assert rewards.shape == collided.shape == (3, 2)
    assert torch.isfinite(rewards).all()
    assert int(maps.num_objects.sum()) > 0
