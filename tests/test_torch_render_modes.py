"""The render modes and the detector's space-to-depth stem against the JAX
package, on the CPU.

Every mode of the JAX package's `render` (`tests/test_agents.py`'s poses)
gives its depth, instances and classes bit for bit; its rgb is off JAX's
on no more pixels than "onehot"'s (the sine's last bit, ROADMAP C.11)
and equals the port's own "onehot" wherever JAX's mode equals JAX's
"onehot" (everywhere, where no tile overflows; where one does, the pixels
JAX's mode renders otherwise are held by depth, instances and classes,
their rgb again up to the sine's bit). The culled mode's
candidate sets and overflow counts are JAX's, an overflowing K included.
`_stem_s2d` is the strided stem bit for bit on float weights, as the JAX
package's is, and JAX's `_stem_s2d` on int8 weights too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import DetectorConfig as JDCfg
from embodied_captioning_tpu.config import SimConfig as JSimCfg
from embodied_captioning_tpu.envs import sim as JS
from embodied_captioning_tpu.models import detector as JD
from embodied_captioning_tpu.models.quantize import quantize_params as jqp
from embodied_captioning_tpu.ops.geometry import intrinsics_from_hfov
from embodied_captioning_tpu_torch.config import DetectorConfig as TDCfg
from embodied_captioning_tpu_torch.config import SensorConfig as TSensCfg
from embodied_captioning_tpu_torch.config import SimConfig as TSimCfg
from embodied_captioning_tpu_torch.envs import sim as TS
from embodied_captioning_tpu_torch.models import detector as TD
from embodied_captioning_tpu_torch.params import from_jax

MODES = ("gather", "onehot16", "onehot+vr", "onehot+pk", "gather+pk",
         "onehot16+vr", "onehot@16x48", "onehot@8x3", "onehot@16x4")


def _poses(rng, n):
    """test_agents.py's tile-culled poses: a yaw, a position in the room at
    camera height."""
    out = []
    for _ in range(n):
        yaw = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                  np.float32)
        pose[0, 3] = rng.uniform(1, 7)
        pose[2, 3] = rng.uniform(1, 7)
        pose[1, 3] = 0.88
        out.append(pose)
    return out


def _scenes():
    """(seed, JAX scene, port scene, poses): test_agents.py's scene seeds
    and poses, with the forward-looking identity pose."""
    rng = np.random.default_rng(3)
    eye = np.eye(4, dtype=np.float32)
    eye[1, 3] = 0.88
    out = []
    for seed in (5, 11):
        js = JS.generate_scene(JSimCfg(scene_size=8.0, num_objects=6),
                               seed=seed)
        ts = TS.generate_scene(TSimCfg(scene_size=8.0, num_objects=6),
                               seed=seed, device="cpu")
        out.append((seed, js, ts, [eye] + _poses(rng, 3)))
    return out


@pytest.fixture(scope="module")
def renders():
    """Per (scene, pose, mode): the JAX and the port render, and both
    packages' "onehot"."""
    res = []
    for seed, js, ts, poses in _scenes():
        for i, pose in enumerate(poses):
            def jr(mode):
                return {k: np.asarray(v) for k, v in JS.render(
                    js, jnp.asarray(pose), 64, 64, 79.0, 15.0, mode).items()}

            def tr(mode):
                return {k: v.numpy() for k, v in TS.render(
                    ts, torch.from_numpy(pose), 64, 64, 79.0, 15.0,
                    mode).items()}

            res.append(dict(key=(seed, i), pose=pose, js=js, ts=ts,
                            j_onehot=jr("onehot"), t_onehot=tr("onehot"),
                            modes={m: (jr(m), tr(m)) for m in MODES}))
    return res


@pytest.mark.parametrize("mode", MODES)
def test_every_render_mode_matches_jax(renders, mode):
    for r in renders:
        want, got = r["modes"][mode]
        for k in ("depth", "instances", "classes"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{r['key']}/{k}")
        # rgb: the port's own "onehot" wherever JAX's mode is JAX's
        # "onehot", and so no more pixels off JAX's there than "onehot" has
        same_j = (want["rgb"] == r["j_onehot"]["rgb"]).all(-1)
        same_t = (got["rgb"] == r["t_onehot"]["rgb"]).all(-1)
        assert same_t[same_j].all(), r["key"]
        off = ((got["rgb"] != want["rgb"]).any(-1) & same_j).sum()
        off_onehot = (r["t_onehot"]["rgb"] != r["j_onehot"]["rgb"]
                      ).any(-1).sum()
        assert off <= off_onehot, (r["key"], off, off_onehot)
        if "@" not in mode or mode == "onehot@16x48":
            assert same_j.all()  # no tile overflows: "onehot" itself
            for k in got:
                np.testing.assert_array_equal(got[k], r["t_onehot"][k])


@pytest.mark.parametrize("tile,k", [(16, 48), (16, 4), (8, 3), (32, 2)])
def test_tile_candidates_match_jax(renders, tile, k):
    """Candidate sets (ascending box indices), their validity and the
    overflow count, per tile; K=48 never overflows, K <= 4 does."""
    fx, fy, xc, yc = intrinsics_from_hfov(64, 64, 79.0)
    overflowed = 0
    for r in renders:
        pose = jnp.asarray(r["pose"])
        jc, jv, jo = JS._tile_candidates(r["js"], pose[:3, 3], pose[:3, :3],
                                         fx, fy, xc, yc, 64, 64, tile, k)
        ts = TS.Scene(*(x[None] for x in r["ts"]))
        p = torch.from_numpy(r["pose"])[None]
        tc, tv, to = TS._tile_candidates(ts, p[:, :3, 3], p[:, :3, :3], fx,
                                         fy, xc, yc, 64, 64, tile, k)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
        assert int(to[0]) == int(jo)
        overflowed += int(jo) > 0
    assert (overflowed > 0) == (k <= 4)


def test_culled_render_batches_envs_and_refuses_as_jax(renders):
    r0, r1 = renders[0], renders[5]
    scenes = TS.Scene(*(torch.stack(x) for x in zip(r0["ts"], r1["ts"])))
    poses = torch.from_numpy(np.stack([r0["pose"], r1["pose"]]))
    for mode in ("onehot@16x48", "onehot@8x3"):
        out = TS.render_batch(scenes, poses, 64, 64, 79.0, 15.0, mode)
        for i, r in enumerate((r0, r1)):
            for k in out:
                np.testing.assert_array_equal(out[k][i].numpy(),
                                              r["modes"][mode][1][k])
        chunked = TS.render_batch_chunked(scenes, poses, 64, 64, 79.0, 15.0,
                                          budget_bytes=1, attr_mode=mode)
        for k in out:
            assert torch.equal(chunked[k], out[k])
    with pytest.raises(ValueError, match="onehot base"):
        TS.render_batch(scenes, poses, 64, 64, 79.0, 15.0, "gather@16x8")
    with pytest.raises(ValueError, match="divisible"):
        TS.render_batch(scenes, poses, 64, 64, 79.0, 15.0, "onehot@24x8")


def test_chunk_estimate_counts_the_culled_slab_tests():
    """The culled mode budgets [envs, tiles, tile^2, K] slab tests per ray
    and candidate, so a budget that takes 16 full envs takes fewer culled
    ones, and the one-hot's [H*W, Bx] product is not counted for them."""
    per_ray = TS.RENDER_BYTES_PER_RAY
    k = 48
    cull = per_ray + k * TS.CULL_BYTES_PER_RAY_CAND
    assert cull > per_ray
    calls = []
    orig = TS.render_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "render_batch",
                   lambda s, p, *a: (calls.append(p.shape[0]), orig(
                       s, p, *a))[1])
        sims = [TS.RaycastSim(TSimCfg(scene_size=8.0, num_objects=4),
                              TSensCfg(height=32, width=32), seed=s,
                              device="cpu") for s in range(4)]
        scenes = TS.Scene(*(torch.stack(x) for x in zip(
            *(s.scene for s in sims))))
        poses = torch.stack([torch.from_numpy(s.agent.camera_matrix()
                                              ).float() for s in sims])
        rays = 32 * 32
        TS.render_batch_chunked(scenes, poses, 32, 32, 79.0, 15.0,
                                budget_bytes=2 * rays * cull,
                                attr_mode="onehot@16x48")
        assert calls == [2, 2]
        calls.clear()
        TS.render_batch_chunked(scenes, poses, 32, 32, 79.0, 15.0,
                                budget_bytes=2 * rays * cull,
                                attr_mode="gather")
        assert calls == [4]


def test_resolve_attr_mode_and_the_sim_default(monkeypatch):
    """test_agents.py's cases with the mode handed in place of
    ECAP_RENDER_MODE, which the port never reads; the sim renders with the
    mode it is handed."""
    monkeypatch.setenv("ECAP_RENDER_MODE", "onehot@128x40")
    assert TS.resolve_attr_mode(None, 1280, 1280) == "onehot"
    assert TS.resolve_attr_mode("gather", 1280, 1280) == "gather"
    assert TS.resolve_attr_mode("onehot@128x40", 1280,
                                1280) == "onehot@128x40"
    assert TS.resolve_attr_mode("onehot@128x40", 192, 192) == "onehot"
    assert TS.resolve_attr_mode("onehot", 1280, 1280) == "onehot"
    assert TS._parse_cull("onehot@160x48") == ("onehot", 160, 48)
    assert TS._parse_cull("onehot16+pk") == ("onehot16+pk", 0, 0)
    sensors = TSensCfg(height=64, width=64)
    sim_cfg = TSimCfg(scene_size=8.0, num_objects=6)
    sim = TS.RaycastSim(sim_cfg, sensors, seed=5, device="cpu",
                        render_mode="onehot@16x48")
    assert sim.render_mode == "onehot@16x48"
    plain = TS.RaycastSim(sim_cfg, sensors, seed=5, device="cpu")
    assert plain.render_mode == "onehot"
    a, b = sim.observe(), plain.observe()
    for k in a:
        assert torch.equal(a[k], b[k])


def test_vector_env_and_run_exp_thread_the_render_mode(tmp_path):
    from embodied_captioning_tpu_torch import run_exp
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.envs.vector_env import VectorEnv

    cfg = load_config("tiny", overrides=[
        "runtime.num_envs=2", "sensors.height=32", "sensors.width=32",
        "sim.num_objects=4", "sim.scene_size=8.0"])
    envs = VectorEnv(cfg, device="cpu", render_mode="onehot@16x48")
    assert envs.render_mode == "onehot@16x48"
    assert all(e.sim.render_mode == "onehot@16x48" for e in envs.envs)
    fallback = VectorEnv(cfg, device="cpu", render_mode="onehot@24x8")
    assert fallback.render_mode == "onehot"
    assert all(e.sim.render_mode == "onehot" for e in fallback.envs)
    fallback.close()
    ref = VectorEnv(cfg, device="cpu")
    a, b = envs.step([1, 2]), ref.step([1, 2])
    for k in ("depth", "instances", "classes"):
        assert torch.equal(a[0][k], b[0][k])
    envs.close()
    ref.close()
    rc = run_exp.main(["--trainer", "randombaseline", "--steps", "2",
                       "--device", "cpu", "--render-mode", "onehot@16x48",
                       "runtime.num_envs=2", "sensors.height=32",
                       "sensors.width=32", "sim.num_objects=4",
                       "sim.scene_size=8.0"])
    assert rc == 0


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stem_weights():
    """The tiny detector at score threshold 0 (the random-weight detector
    keeps detections), test_detector_large.py's key."""
    cfg = dataclasses.replace(JDCfg.tiny(), score_threshold=0.0)
    return cfg, JD.init_detector(jax.random.PRNGKey(5), cfg)


@pytest.mark.parametrize("int8", [False, True])
def test_stem_s2d_matches_jax(stem_weights, int8):
    """On float weights `_stem_s2d` is the strided stem bit for bit (as
    `tests/test_detector_large.py` holds the JAX package's) and JAX's
    `_stem_s2d`. On int8 weights the weight scatter dequantizes in float32,
    as JAX's does, so neither package's equals its strided stem there; the
    port's is JAX's but for a sum that cancels to near zero, where the
    float32 accumulation order (oneDNN's, XLA's) can move the bf16 result
    by an ulp (at most 1e-4 of the outputs)."""
    _, params = stem_weights
    p = jqp(params, min_size=64) if int8 else params
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(6), (2, 64, 64, 3)))
    want = np.asarray(JD._stem_s2d(p["stem"], jnp.asarray(x)), np.float32)
    tp = from_jax(p, "cpu")
    got = TD._stem_s2d(tp["stem"], torch.from_numpy(x))
    direct = TD.conv(tp["stem"], torch.from_numpy(x), 2)
    if not int8:
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.equal(got, direct)
        return
    g = got.float().numpy()
    assert (g != want).mean() <= 1e-4
    bits = [np.asarray(v, np.float32).view(np.int32) >> 16 for v in (g, want)]
    assert np.abs(bits[0] - bits[1]).max() <= 1  # one bf16 ulp
    assert not torch.equal(got, direct)


def test_stem_s2d_forward_matches_the_direct_forward_and_jax(stem_weights):
    """test_detector_large.py's whole-forward check: equal boxes and valid
    flags with `stem_s2d`, and the JAX forward's with it."""
    jcfg, params = stem_weights
    tcfg = dataclasses.replace(TDCfg.tiny(), score_threshold=0.0)
    tp = from_jax(params, "cpu")
    imgs = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3)
                                             ).astype(np.uint8)
    d_a = TD.forward(tp, torch.from_numpy(imgs), tcfg)
    d_b = TD.forward(tp, torch.from_numpy(imgs),
                     dataclasses.replace(tcfg, stem_s2d=True))
    assert torch.equal(d_a.boxes, d_b.boxes)
    assert torch.equal(d_a.valid, d_b.valid)
    j_b = JD.forward(params, jnp.asarray(imgs),
                     dataclasses.replace(jcfg, stem_s2d=True))
    np.testing.assert_array_equal(d_b.valid.numpy(), np.asarray(j_b.valid))
    np.testing.assert_allclose(d_b.boxes.float().numpy(),
                               np.asarray(j_b.boxes, np.float32), atol=0.25,
                               rtol=0)


def test_the_artifact_loader_serves_the_s2d_stem(tmp_path, stem_weights):
    from embodied_captioning_tpu_torch.params import (
        dump_tree, load_detector_artifact, to_numpy,
    )
    from embodied_captioning_tpu_torch.config import to_dict

    _, params = stem_weights
    cfg = dataclasses.replace(TDCfg.tiny(), stem_s2d=True)
    path = tmp_path / "art.pkl"
    dump_tree({"served": to_numpy(from_jax(params, "cpu")),
               "serving_cfg": to_dict(cfg)}, str(path))
    served, scfg = load_detector_artifact(str(path), "cpu")
    assert scfg["stem_s2d"] is True
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, (1, 64, 64, 3)).astype(np.uint8))
    det = TD.forward(served, imgs, dataclasses.replace(TDCfg.tiny(), **scfg))
    assert torch.isfinite(det.scores).all()
