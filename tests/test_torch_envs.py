"""The port's host env layer (envs/env.py, envs/vector_env.py,
envs/registry.py, envs/episodes.py, envs/sensors.py, sim
`render_batch_chunked`) against the JAX package's.

Tolerances: depth, instances and classes equal on every pixel; rgb within
one level on all but 2e-3 of the pixels (ROADMAP C.11: XLA's sine and the
port's differ in the last bit, which the texture hash amplifies, as in
test_torch_sim.py); host values (poses, steps, episode ids, dones, paths,
annotations) equal. Async, chunked and batched renders equal the
synchronous, unchunked and per-env ones bit for bit."""

import jax
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload
from embodied_captioning_tpu.envs import episodes as JE
from embodied_captioning_tpu.envs import registry as JR
from embodied_captioning_tpu.envs import sensors as JSn
from embodied_captioning_tpu.envs.env import EmbodiedEnv as JEnv
from embodied_captioning_tpu.envs.vector_env import VectorEnv as JVec
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.envs import episodes as E
from embodied_captioning_tpu_torch.envs import registry as R
from embodied_captioning_tpu_torch.envs import sensors as Sn
from embodied_captioning_tpu_torch.envs import sim as S
from embodied_captioning_tpu_torch.envs.env import EmbodiedEnv
from embodied_captioning_tpu_torch.envs.vector_env import VectorEnv
from embodied_captioning_tpu_torch.ops.detections import Detections
from torch_parity import np32

OV = ["runtime.num_envs=3", "sensors.height=64", "sensors.width=64",
      "sim.scene_size=8.0", "sim.num_objects=6", "map.voxel_size=0.2",
      "sim.episode_steps=3"]
RGB_SHARE = 2e-3


@pytest.fixture(scope="module")
def cfgs():
    return jload("tiny", overrides=OV), load_config("tiny", overrides=OV)


def _check_obs(got, ref, counts):
    for k in ("depth", "instances", "classes"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    d = np.abs(got["rgb"].numpy().astype(int)
               - np.asarray(ref["rgb"]).astype(int)).max(-1)
    counts[0] += int((d > 1).sum())
    counts[1] += d.size


def test_vector_env_step_matches_jax(cfgs):
    """Seven steps of 3 envs with 3-step episodes (two auto-resets each):
    obs, dones, infos, snapshots and the envs' host state equal the JAX
    VectorEnv's."""
    jcfg, cfg = cfgs
    jv, tv = JVec(jcfg), VectorEnv(cfg, device="cpu")
    counts = [0, 0]
    _check_obs(tv.observe(), jv.observe(), counts)
    rng = np.random.default_rng(0)
    resets = 0
    for _ in range(7):
        acts = rng.integers(1, 4, 3).tolist()
        ref, jr, jd, ji = jv.step(acts)
        got, r, d, info = tv.step(acts)
        _check_obs(got, ref, counts)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(r, jr)
        assert info == ji
        resets += int(d.sum())
        for a, b in zip(tv.envs, jv.envs):
            assert (a.get_episode_id(), a.get_step(), a.collided()) == (
                b.get_episode_id(), b.get_step(), b.collided())
            for k, v in b.get_agent_position().items():
                np.testing.assert_array_equal(a.get_agent_position()[k], v)
    assert resets == 6
    for i in range(3):
        s, js = tv.snapshot_at(i), jv.snapshot_at(i)
        assert (s["step"], s["episode_id"]) == (js["step"], js["episode_id"])
    assert counts[0] <= RGB_SHARE * counts[1], counts
    jv.close()
    tv.close()


def test_async_equals_sync_and_snapshots(cfgs):
    _, cfg = cfgs
    sync, asy = VectorEnv(cfg, device="cpu"), VectorEnv(cfg, device="cpu")
    for k, acts in enumerate(([1, 1, 1], [2, 1, 3], [1, 3, 2], [1, 1, 1])):
        before = [e.get_agent_position()["position"].copy()
                  for e in asy.envs]
        steps = [e.get_step() for e in asy.envs]
        want = sync.step(acts)
        asy.step_async(acts)
        snaps = [asy.snapshot_at(i) for i in range(3)]
        got = asy.step_wait()
        for key in want[0]:
            assert torch.equal(got[0][key], want[0][key]), (k, key)
        np.testing.assert_array_equal(got[2], want[2])
        # the snapshot is the dispatch-time state
        for i, s in enumerate(snaps):
            np.testing.assert_array_equal(s["position"]["position"],
                                          before[i])
            assert s["step"] == steps[i]
    with pytest.raises(AssertionError, match="no step_async pending"):
        asy.step_wait()
    asy.async_step_at(1, 2)
    one = asy.wait_step_at(1)
    ref = sync.envs[1].step(2)
    for key in ref[0]:
        assert torch.equal(one[0][key], ref[0][key]), key
    with pytest.raises(RuntimeError, match="without a matching"):
        asy.wait_step_at(1)
    sync.close()
    asy.close()


def test_batched_render_equals_per_env_and_chunked_equals_unchunked(cfgs):
    """The batched render of the VectorEnv path equals each env's own
    render; a budget that forces chunks of 2 (of 4 envs) and of 1 equals
    the single call, bit for bit."""
    _, cfg = cfgs
    sims = [S.RaycastSim(cfg.sim, cfg.sensors, seed=s, device="cpu")
            for s in range(4)]
    scenes = S.Scene(*(torch.stack(x) for x in zip(*(s.scene
                                                      for s in sims))))
    poses = torch.stack([torch.from_numpy(s.agent.camera_matrix()).float()
                         for s in sims])
    h = w = 64
    full = S.render_batch(scenes, poses, h, w, 79.0, 15.0)
    rays = h * w
    onehot = rays * scenes.box_min.shape[-2] * S.ONEHOT_BYTES_PER_RAY_BOX
    for chunk in (1, 2, 4):
        budget = onehot + chunk * rays * S.RENDER_BYTES_PER_RAY
        out = S.render_batch_chunked(scenes, poses, h, w, 79.0, 15.0,
                                     budget_bytes=budget)
        for k in full:
            assert torch.equal(out[k], full[k]), (chunk, k)
    for i, s in enumerate(sims):
        one = s.observe()
        for k in one:
            assert torch.equal(one[k], full[k][i]), k
    venv = VectorEnv(cfg, device="cpu")
    assert venv._batched_render_ok()
    got = venv.step([1, 2, 3])[0]
    for i, env in enumerate(venv.envs):
        one = env.observe()
        for k in one:
            assert torch.equal(got[k][i], one[k]), k
    venv.close()


def test_per_env_path_for_overriding_envs(cfgs):
    """Envs that override step (SemanticDisagreement-v0 adds area_ratio)
    are stepped one by one, as in the JAX package; their infos equal."""
    jcfg, cfg = cfgs
    ov = ["runtime.env_name=SemanticDisagreement-v0"]
    jv = JVec(jload("tiny", overrides=OV + ov))
    tv = VectorEnv(load_config("tiny", overrides=OV + ov), device="cpu")
    assert not tv._batched_render_ok() and not jv._batched_render_ok()
    counts = [0, 0]
    for acts in ([1, 2, 1], [1, 1, 3]):
        got, _, d, info = tv.step(acts)
        ref, _, jd, jinfo = jv.step(acts)
        _check_obs(got, ref, counts)
        np.testing.assert_array_equal(d, jd)
        for a, b in zip(info, jinfo):
            assert a["area_ratio"] == pytest.approx(b["area_ratio"], abs=0)
    assert counts[0] <= RGB_SHARE * counts[1]
    tv.close()
    jv.close()


def test_env_rpc_surface_equals_jax(cfgs):
    jcfg, cfg = cfgs
    a, b = EmbodiedEnv(cfg, env_id=1, device="cpu"), JEnv(jcfg, env_id=1)
    assert a.get_episode_id() == b.get_episode_id() == 100000
    assert a.get_scene() == b.get_scene()
    for x, y in zip(a.get_upper_and_lower_map_bounds(),
                    b.get_upper_and_lower_map_bounds()):
        np.testing.assert_array_equal(x, y)
    assert a.get_semantic_annotations() == b.get_semantic_annotations()
    for act in (1, 1, 2, 1):
        a.step(act), b.step(act)
    assert a.get_step() == b.get_step() == 4
    np.testing.assert_array_equal(a.get_path((1.0, 1.0), (6.5, 6.5)),
                                  b.get_path((1.0, 1.0), (6.5, 6.5)))
    np.testing.assert_array_equal(a.traversability(0.25),
                                  b.traversability(0.25))
    np.testing.assert_array_equal(a.camera_pose().numpy(),
                                  np.asarray(jax.numpy.asarray(
                                      b.sim.agent.camera_matrix(),
                                      jax.numpy.float32)))
    maps = a.get_and_update_disagreement_map()
    assert maps.shape == np.asarray(b.get_and_update_disagreement_map()).shape
    assert a.get_reward() == b.get_reward() == 0.0
    a.set_goals([(1, 2)])
    assert a.get_goals() == [(1, 2)]
    obs = a.reset()
    b.reset()
    assert a.get_episode_id() == b.get_episode_id() == 100001
    assert obs["depth"].shape == (64, 64)


def test_match_raster():
    from embodied_captioning_tpu.envs.env import _match_raster as jm
    from embodied_captioning_tpu_torch.envs.env import _match_raster

    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 10, (96, 96)).astype(np.float32)
    for m in (96, 48, 32, 40):
        masks = np.zeros((2, m, m), np.float32)
        got = _match_raster(torch.from_numpy(depth), torch.from_numpy(masks))
        want = np.asarray(jm(jax.numpy.asarray(depth),
                             jax.numpy.asarray(masks)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


SENSORS = ("object_detector_gt", "object_detector_gt_discard_occlusions",
           "position_sensor_origin", "position_sensor",
           "position_sensor_pixels", "noisy_position_sensor",
           "noisy_position_sensor2", "agent_collision_sensor",
           "movement_sensor", "proximity_sensor", "gt_ego_map", "map_sensor",
           "semantic_instances")


def test_sensor_registry_equals_jax(cfgs):
    """Every registered sensor against the JAX sensor on the same env
    state. The egocentric map bins back-projected points: a point on a
    bin edge may fall on the other side (at most 1% of the cells)."""
    jcfg, cfg = cfgs
    assert set(Sn.SENSOR_REGISTRY) == set(JSn.SENSOR_REGISTRY)
    a, b = EmbodiedEnv(cfg, env_id=0, device="cpu"), JEnv(jcfg, env_id=0)
    for act in (1, 2, 1):
        a.step(act), b.step(act)
    obs, jobs = a.observe(), b.observe()
    jobs = {k: np.asarray(v) for k, v in jobs.items()}
    # the same depth and instances into both
    obs = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
    for name in SENSORS:
        got = Sn.get_sensor(name)(a, obs)
        want = JSn.get_sensor(name)(b, jobs)
        if isinstance(got, Detections):
            for f in ("boxes", "classes", "valid", "masks", "object_ids"):
                np.testing.assert_array_equal(np32(getattr(got, f)),
                                              np32(getattr(want, f)),
                                              err_msg=(name, f))
        elif isinstance(got, dict):
            assert set(got) == set(want), name
            for k in got:
                if k == "mapping":
                    assert got[k] == want[k]
                else:
                    np.testing.assert_array_equal(got[k], want[k],
                                                  err_msg=(name, k))
        elif name == "gt_ego_map":
            assert got.shape == want.shape == (64, 64, 2)
            assert np.mean(got != want) <= 0.01, np.mean(got != want)
            assert got[..., 1].sum() >= got[..., 0].sum() > 0
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)
    noisy = Sn.get_sensor("noisy_position_sensor")(a, obs)
    clean = Sn.get_sensor("position_sensor_origin")(a, obs)
    assert not np.allclose(noisy["position"], clean["position"])
    assert 0 < Sn.get_sensor("proximity_sensor")(a, obs) <= 2.0
    with pytest.raises(ValueError, match="Perceiver"):
        Sn.get_sensor("object_detector_detectron")(a, obs)


def test_sensor_caches_reset_per_episode(cfgs):
    _, cfg = cfgs
    env = EmbodiedEnv(cfg, env_id=3, device="cpu")
    obs = env.observe()
    rel = Sn.get_sensor("position_sensor")(env, obs)
    np.testing.assert_allclose(rel["position"], 0.0, atol=1e-9)
    Sn.get_sensor("movement_sensor")(env, obs)
    env.step(1)
    obs = env.reset()
    rel = Sn.get_sensor("position_sensor")(env, obs)
    np.testing.assert_allclose(rel["position"], 0.0, atol=1e-9)
    np.testing.assert_allclose(Sn.get_sensor("movement_sensor")(env, obs),
                               0.0, atol=1e-9)


def test_env_registry_equals_jax(cfgs):
    jcfg, cfg = cfgs
    ported = set(JR.ENV_REGISTRY) - {"Viz-v0", "Viz-v1"}
    assert set(R.ENV_REGISTRY) == ported
    with pytest.raises(KeyError, match="unknown env"):
        R.make_env("nope", cfg)
    g, jg = (R.make_env("GymHabitatEnv-v2", cfg, device="cpu"),
             JR.make_env("GymHabitatEnv-v2", jcfg))
    assert g.get_distance(2) == jg.get_distance(2) == 10.0
    assert g.get_action_to_goal() == jg.get_action_to_goal() == (2, False)
    g.set_goals((6.0, 6.0)), jg.set_goals((6.0, 6.0))
    for _ in range(5):
        act = g.get_action_to_goal()
        assert act == jg.get_action_to_goal()
        g.step(act[0]), jg.step(act[0])
    kl = R.make_env("SemanticDisagreement-kl", cfg, device="cpu")
    assert kl.get_reward() == 0.0
    assert isinstance(kl, R.SemanticDisagreementEnv)
    sd, jsd = (R.make_env("SemanticDisagreement-v0", cfg, device="cpu"),
               JR.make_env("SemanticDisagreement-v0", jcfg))
    assert sd.area_ratio() == jsd.area_ratio() == 0.0


def test_episodes_equal_jax(cfgs, tmp_path):
    jcfg, cfg = cfgs
    ds, jds = E.EpisodeDataset(6, "val", 8.0), JE.EpisodeDataset(6, "val",
                                                                 8.0)
    assert [e.__dict__ for e in ds] == [e.__dict__ for e in jds]
    ds.save(str(tmp_path / "ep.json"))
    back = E.EpisodeDataset.load(str(tmp_path / "ep.json"))
    assert [e.__dict__ for e in back] == [e.__dict__ for e in ds]
    a, b = EmbodiedEnv(cfg, device="cpu"), JEnv(jcfg)
    E.apply_episode(a, ds[2])
    JE.apply_episode(b, jds[2])
    assert (a.get_episode_id(), a.sim.agent.x, a.sim.agent.z,
            a.sim.agent.yaw) == (b.get_episode_id(), b.sim.agent.x,
                                 b.sim.agent.z, b.sim.agent.yaw)
    assert a.map_state.lower.device.type == "cpu"
    np.testing.assert_array_equal(a.observe()["depth"].numpy(),
                                  np.asarray(b.observe()["depth"]))
