"""The port's simulator (envs/sim.py) against the JAX package's: scene
generation, the render, ground-truth detections and the host agent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import SensorConfig as JSensorCfg
from embodied_captioning_tpu.config import SimConfig as JSimCfg
from embodied_captioning_tpu.envs import sim as JS
from embodied_captioning_tpu_torch import params as P
from embodied_captioning_tpu_torch.config import SensorConfig, SimConfig
from embodied_captioning_tpu_torch.envs import sim as S
from torch_parity import np32, t

SIZE = 96
ACTIONS = (1, 2, 1, 3, 1, 1)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("distractors", [0, 4])
def test_generate_scene_equals_jax(seed, distractors):
    # host-side numpy with the same generator calls: every field is equal
    kw = dict(num_distractors=distractors, interior_walls=2 + distractors)
    ref = JS.generate_scene(JSimCfg(**kw), seed)
    out = S.generate_scene(SimConfig(**kw), seed, device="cpu")
    assert out._fields == ref._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_scene_bridge_keeps_dtypes():
    ref = JS.generate_scene(JSimCfg(), 5)
    out = P.scene_from_jax(jax.tree_util.tree_map(np.asarray, ref), "cpu")
    own = S.generate_scene(SimConfig(), 5, device="cpu")
    assert isinstance(out, S.Scene)
    for f in out._fields:
        assert getattr(out, f).dtype == getattr(own, f).dtype, f
        assert torch.equal(getattr(out, f), getattr(own, f)), f


def _pair(seed):
    sens = dict(height=SIZE, width=SIZE)
    return (JS.RaycastSim(JSimCfg(), JSensorCfg(**sens), seed=seed),
            S.RaycastSim(SimConfig(), SensorConfig(**sens), seed=seed,
                         device="cpu"))


@pytest.mark.parametrize("seed", [1, 7])
def test_render_matches_jax(seed):
    """Same scene, same poses. depth, instances and classes are equal on
    every pixel (the port spells the ray directions' K=3 product, the
    focal-length reciprocal and the hit point's fused multiply-add as XLA
    compiles them). rgb is within 1 level on all but a measured 3e-4 of
    the pixels (limit 2e-3): XLA's sine and the port's differ in the last
    bit, which `_hash_noise` amplifies, and a texture cell's floor can
    flip."""
    jsim, tsim = _pair(seed)
    assert (jsim.agent.x, jsim.agent.z, jsim.agent.yaw) == (
        tsim.agent.x, tsim.agent.z, tsim.agent.yaw)
    off = total = 0
    for a in ACTIONS:
        assert jsim.step(a) == tsim.step(a)
        ref, out = jsim.observe(), tsim.observe()
        for k in ("depth", "instances", "classes"):
            got = out[k].numpy()
            assert got.dtype == np.asarray(ref[k]).dtype
            np.testing.assert_array_equal(got, np.asarray(ref[k]), err_msg=k)
        assert out["rgb"].dtype == torch.uint8
        d = np.abs(np.asarray(ref["rgb"]).astype(int)
                   - out["rgb"].numpy().astype(int)).max(-1)
        off += int((d > 1).sum())
        total += d.size
    assert off <= 2e-3 * total, (off, total)


def test_render_modes_and_batch_agree():
    # "gather" equals "onehot" bit for bit; render_batch equals per-env
    # render
    sims = [_pair(s)[1] for s in (2, 4)]
    poses = torch.stack([torch.from_numpy(s.agent.camera_matrix()).float()
                         for s in sims])
    scenes = S.Scene(*(torch.stack(x) for x in zip(*(s.scene for s in sims))))
    onehot = S.render_batch(scenes, poses, SIZE, SIZE, 79.0, 15.0, "onehot")
    gather = S.render_batch(scenes, poses, SIZE, SIZE, 79.0, 15.0, "gather")
    for k in onehot:
        assert torch.equal(onehot[k], gather[k]), k
    for i, s in enumerate(sims):
        one = S.render(s.scene, poses[i], SIZE, SIZE, 79.0)
        for k in one:
            assert torch.equal(one[k], onehot[k][i]), k
    # every JAX mode is accepted ("+pk" names its raycast kernel, the
    # port's visibility pass in every mode); a name of none is refused
    pk = S.render_batch(scenes, poses, SIZE, SIZE, 79.0, 15.0, "onehot+pk")
    for k in onehot:
        assert torch.equal(pk[k], onehot[k]), k
    with pytest.raises(ValueError, match="attr_mode"):
        S.render_batch(scenes, poses, SIZE, SIZE, 79.0, 15.0, "onehot+xx")


def test_hash_noise_matches_jitted_jax():
    # XLA contracts the argument's sum into fused multiply-adds; the port
    # spells that order. What is left is the sine's last bit, amplified to
    # at most 4e-3 of the noise (1/256), modulo the wrap at 1
    rng = np.random.default_rng(0)
    p = np.floor(rng.uniform(0, 12, (20000, 3)).astype(np.float32) * 7.0)
    ref = np.asarray(jax.jit(JS._hash_noise)(jnp.asarray(p)))
    out = S._hash_noise(t(p)).numpy()
    d = np.abs(ref - out)
    assert np.minimum(d, 1 - d).max() <= 4e-3
    assert (out >= 0).all() and (out < 1).all()


def test_gt_detections_match_jax():
    jsim, tsim = _pair(7)
    ref = jsim.gt_detections(jsim.observe())
    obs = tsim.observe()
    out = tsim.gt_detections(obs)
    assert int(out.valid.sum()) > 0
    for f in ("boxes", "classes", "scores", "logits", "valid", "masks",
              "object_ids", "episode_ids"):
        np.testing.assert_array_equal(np32(getattr(out, f)),
                                      np32(getattr(ref, f)), err_msg=f)


def test_host_sim_steps_like_jax():
    # spawn, collision and motion are host numpy: equal
    jsim, tsim = _pair(3)
    rng = np.random.default_rng(0)
    hits = 0
    for a in rng.integers(0, 4, size=80):
        hit = tsim.step(int(a))
        assert jsim.step(int(a)) == hit
        hits += hit
        assert (jsim.agent.x, jsim.agent.z, jsim.agent.yaw) == (
            tsim.agent.x, tsim.agent.z, tsim.agent.yaw)
    assert hits > 0
    np.testing.assert_array_equal(jsim.agent.camera_matrix(),
                                  tsim.agent.camera_matrix())
    np.testing.assert_array_equal(jsim.traversability(0.5),
                                  tsim.traversability(0.5))
    for a, b in zip(jsim.bounds(), tsim.bounds()):
        np.testing.assert_array_equal(a, b)
