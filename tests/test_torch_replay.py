"""The port's replay path: `utils/image_io`, the replay envs `Viz-v0` and
`Viz-v1` (`envs/registry.py`) and the `replay_exp` entry point, beside the
JAX package's on the same npz stores.

Limits: the replayed frames, `pcd`, the trajectory cells and the PNG
files' bytes equal; `replay_exp`'s lines equal the JAX script's; with
--perceive, the same JSON keys and frames, and the same detection count as
the JAX script on the same store with the JAX perceiver's weights handed
across (the count is of valid detection slots, which the detector's scores
decide before any captioning).
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import load_config as jload
from embodied_captioning_tpu.envs import registry as JR
from embodied_captioning_tpu.perception import Perceiver as JPerceiver
from embodied_captioning_tpu.utils import image_io as JIO
from embodied_captioning_tpu.utils.obs_store import save_obs
from embodied_captioning_tpu_torch import perception as TPER
from embodied_captioning_tpu_torch import replay_exp
from embodied_captioning_tpu_torch.config import load_config
from embodied_captioning_tpu_torch.envs import registry as R
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.utils import image_io as IO
from torch_parity import jax_kernel_path

REPO = Path(__file__).resolve().parent.parent
OV = ["sensors.height=24", "sensors.width=24", "sim.scene_size=6.0",
      "sim.num_objects=2", "map.voxel_size=0.2"]
STEPS = (4, 3)  # recorded steps of episodes 0 and 1
TPerceiver = TPER.Perceiver
# --perceive: the tiny preset on 64^2 frames, a score threshold that
# leaves some slots of the random detector valid and some not
PERCEIVE_OV = ["detector.score_threshold=0.3"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Two episodes: rgb, depth and recorded positions in episode 0; rgb
    only in episode 1 (depth then replays as zeros); 64^2 frames."""
    root = tmp_path_factory.mktemp("replay_store")
    rng = np.random.default_rng(0)
    for ep, steps in enumerate(STEPS):
        for step in range(steps):
            obs = {"rgb": (rng.random((64, 64, 3)) * 255).astype(np.uint8)}
            if ep == 0:
                obs["depth"] = rng.random((64, 64)).astype(np.float32)
                obs["position"] = {
                    "position": np.asarray([1.0 + 0.7 * step, 0.0,
                                            2.0 - 0.3 * step]),
                    "orientation": np.asarray([1.0, 0.0, 0.0, 0.0])}
            save_obs(str(root / f"env{ep}"), ep, obs, step)
    return str(root)


def _cfgs(store, out=None):
    ov = OV + [f"sim.replay_dir={store}"]
    if out is not None:
        ov.append(f"runtime.obs_dir={out}")
    return jload("tiny", overrides=ov), load_config("tiny", overrides=ov)


def _same_obs(got, want):
    for k in ("rgb", "depth", "instances", "classes"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("env_id", [0, 1, 3])
def test_viz_v0_replays_as_jax(store, env_id):
    """Every replayed observation, reward, done and info of episode
    env_id % 2 equal the JAX env's, through a reset and back."""
    jcfg, cfg = _cfgs(store)
    a = R.make_env("Viz-v0", cfg, env_id=env_id, device="cpu")
    b = JR.make_env("Viz-v0", jcfg, env_id=env_id)
    assert isinstance(a, R.VizEnv)
    _same_obs(a.observe(), b.observe())
    for _ in range(2):
        steps, done = 0, False
        while not done:
            ra, rb = a.step(1), b.step(1)
            _same_obs(ra[0], rb[0])
            assert ra[1:] == rb[1:]
            done, steps = ra[2], steps + 1
        assert steps == STEPS[env_id % 2]
        assert a.step_count == b.step_count
        _same_obs(a.reset(), b.reset())
    if env_id % 2:
        assert not a.observe()["depth"].any()


def test_viz_v1_writes_as_jax(store, tmp_path):
    """`pcd`, the trajectory cells and every trajectory PNG equal the JAX
    env's, byte for byte."""
    jcfg, _ = _cfgs(store, tmp_path / "j")
    _, cfg = _cfgs(store, tmp_path / "t")
    a = R.make_env("Viz-v1", cfg, device="cpu")
    b = JR.make_env("Viz-v1", jcfg)
    oa, ob = a.reset(), b.reset()
    for _ in range(STEPS[0]):
        _same_obs(oa, ob)
        np.testing.assert_array_equal(oa["pcd"], ob["pcd"])
        assert oa["pcd"].dtype == np.float32
        assert a._traj_cells == b._traj_cells
        (oa, *_), (ob, *_) = a.step(1), b.step(1)
    assert len(a._traj_cells) == STEPS[0] + 1
    pngs = sorted(p.name for p in (tmp_path / "t" / "viz").glob("*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "j" / "viz").glob(
        "*.png"))
    assert len(pngs) == STEPS[0] + 1
    for name in pngs:
        raw = (tmp_path / "t" / "viz" / name).read_bytes()
        assert raw == (tmp_path / "j" / "viz" / name).read_bytes(), name
        assert raw[:8] == b"\x89PNG\r\n\x1a\n" and b"IEND" in raw


def test_viz_needs_a_replay_dir():
    with pytest.raises(ValueError, match="replay_dir"):
        R.make_env("Viz-v0", load_config("tiny", overrides=OV),
                   device="cpu")


@pytest.mark.parametrize("with_path", [False, True])
def test_image_io_as_jax(tmp_path, with_path):
    """`render_topdown` of a map with every channel set, with and without
    a trajectory and agent (one off the map), and `write_png` of it and of
    a grey frame: equal arrays, equal bytes."""
    rng = np.random.default_rng(int(with_path))
    maps = np.zeros((20, 30, 4), np.float32)
    maps[..., 0] = rng.random((20, 30)) > 0.8
    maps[..., 1] = rng.random((20, 30)) > 0.4
    maps[..., 2] = rng.integers(0, 9, (20, 30)) * (rng.random((20, 30)) > 0.7)
    path = [(1, 2), (5, 5), (19, 29), (25, 3)] if with_path else None
    agent = (19, 29) if with_path else None
    img, jimg = (IO.render_topdown(maps, path, agent),
                 JIO.render_topdown(maps, path, agent))
    np.testing.assert_array_equal(img, jimg)
    assert IO.render_topdown(maps, path, (40, 40)).shape == (20, 30, 3)
    for name, frame in (("rgb", img), ("grey", maps[..., 1] * 255)):
        IO.write_png(str(tmp_path / f"t_{name}.png"), frame)
        JIO.write_png(str(tmp_path / f"j_{name}.png"), frame)
        assert (tmp_path / f"t_{name}.png").read_bytes() == \
            (tmp_path / f"j_{name}.png").read_bytes()


def _script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_replay_exp", REPO / "scripts" / "replay_exp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, jax_side: bool) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_side:
            mp.setattr(sys, "argv", ["replay_exp.py"] + argv)
            rc = main()
        else:
            rc = main(argv + ["--device", "cpu"])
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("max_frames", [500, 5])
def test_replay_exp_lines_as_jax_script(store, max_frames):
    argv = [store, "--max-frames", str(max_frames)]
    jrc, want = _run(_script().main, argv, True)
    rc, got = _run(replay_exp.main, argv, False)
    assert rc == 0 and jrc is None
    assert got == want
    assert got[1] == f"[replay] {min(max_frames, sum(STEPS))} rgb frames"


def test_replay_exp_perceive_as_jax_script(store, monkeypatch):
    """--perceive at the tiny preset, batches of 3 over the 7 frames: the
    JAX script's JSON keys and types, frames, and detection count, the
    JAX perceiver's seeded weights on both sides; the count equals the
    port's `Perceiver.process` on the frames stacked by hand."""
    argv = [store] + PERCEIVE_OV + ["--perceive", "--batch", "3"]
    with jax_kernel_path(blocks=True):
        jrc, want = _run(_script().main, argv, True)
    jparams = JPerceiver(jload("tiny", overrides=PERCEIVE_OV)).params
    params = from_jax(jparams, "cpu")
    monkeypatch.setattr(TPER, "Perceiver",
                        lambda cfg, device="cuda", **kw: TPerceiver(
                            cfg, params=params, device=device, **kw))
    rc, got = _run(replay_exp.main, argv, False)
    assert rc == 0 and jrc is None
    want, got = json.loads(want[-1]), json.loads(got[-1])
    assert set(got) == set(want) == {"frames", "detections", "seconds",
                                     "fps"}
    for k, v in want.items():
        assert type(got[k]) is type(v), k
    assert got["frames"] == want["frames"] == sum(STEPS)
    assert got["detections"] == want["detections"]
    from embodied_captioning_tpu_torch.utils.obs_store import SampleLoader

    loader = SampleLoader(store)
    per = TPerceiver(load_config("tiny", overrides=PERCEIVE_OV),
                     params=params, device="cpu")
    frames = replay_exp.rgb_frames(loader, 500)
    valid = [per.process(replay_exp.load_batch(loader, frames[i:i + 3])
                         ).detections.valid for i in range(0, 7, 3)]
    n = sum(int(v.sum()) for v in valid)
    assert n == got["detections"]
    assert 0 < n < sum(v.numel() for v in valid)


def test_replay_exp_perceive_needs_a_card(store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert replay_exp.main([store, "--perceive"]) == 2
    assert replay_exp.main([store, "--max-frames", "1"]) == 0
