"""Helpers shared by the tests that hold the PyTorch port to the JAX
package: numpy conversion and the JAX kernel-path switch."""

from __future__ import annotations

import contextlib
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache


def np32(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as numpy (bf16 widened to
    float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (bf16 kept as bf16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        out = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


# the persistent compilation cache of the programs compiled inside
# `_persist_every_compile`: under the temporary directory, so that each
# checkout (each TMPDIR) keeps its own, apart from the suite's shared one
PORT_JAX_CACHE = os.path.join(tempfile.gettempdir(), "ecap_port_jax_cache")


@contextlib.contextmanager
def _persist_every_compile():
    """The persistent compilation cache takes every program compiled
    inside, however short its compile (the package's threshold is 0.3 s),
    in PORT_JAX_CACHE. The interpret-mode kernel path compiles hundreds of
    small programs a test, and every `jax.clear_caches()` drops them from
    memory: from the disk, the next test (or another worker) loads them
    in place of compiling them again. Results are the same programs'
    either way. The directory and threshold are restored on exit."""
    keys = ("jax_persistent_cache_min_compile_time_secs",
            "jax_compilation_cache_dir")
    old = {k: getattr(jax.config, k) for k in keys}
    jax.config.update(keys[0], 0.0)
    jax.config.update(keys[1], PORT_JAX_CACHE)
    compilation_cache.reset_cache()  # the cache reads its dir once
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@contextlib.contextmanager
def jax_kernel_path(blocks: bool = False):
    """Run the JAX package with ECAP_USE_PALLAS=1 (its Pallas kernels in
    interpret mode on the CPU); with `blocks` also ECAP_PALLAS_BLOCKS=1,
    the whole-block decode kernels, which is the configuration the port's
    default decode route (`decode_blocks=True`) mirrors. The flags are
    read at trace time, so the jit caches are cleared on entry and exit.
    Inside, every program goes to the persistent compilation cache
    (`_persist_every_compile`)."""
    with pytest.MonkeyPatch.context() as mp, _persist_every_compile():
        mp.setenv("ECAP_USE_PALLAS", "1")
        if blocks:
            mp.setenv("ECAP_PALLAS_BLOCKS", "1")
        else:
            mp.delenv("ECAP_PALLAS_BLOCKS", raising=False)
        mp.delenv("ECAP_CROSS_V_HEADMAJOR", raising=False)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()
    jax.clear_caches()


@contextlib.contextmanager
def jitted_quantize_kv():
    """The JAX package's `quantize_kv` jitted, as the jitted `perceive`
    runs it: there XLA turns its `/ 127.0` into a product with the float32
    reciprocal, which the port spells (ROADMAP C.10); called eagerly it
    divides. `precompute_kv` imports it at each call, so the patch reaches
    every caller."""
    from embodied_captioning_tpu.models import quantize as jquantize

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquantize, "quantize_kv", jax.jit(jquantize.quantize_kv))
        yield


@contextlib.contextmanager
def jax_train_path():
    """Run the JAX package on its default path (ECAP_USE_PALLAS and
    ECAP_PALLAS_LN unset): the path its `train_step` differentiates, since
    its Pallas flash attention has no VJP (jax.grad through it fails to
    linearize). Attention is then XLA attention with bf16 scores and the
    max under stop_gradient, LayerNorm `_layernorm_ref`, the preprocess the
    unfused `preprocess_for_vit`. Inside, every program goes to the
    persistent compilation cache (`_persist_every_compile`)."""
    with pytest.MonkeyPatch.context() as mp, _persist_every_compile():
        for name in ("ECAP_USE_PALLAS", "ECAP_PALLAS_LN", "ECAP_PALLAS_BLOCKS",
                     "ECAP_HEADMAJOR", "ECAP_FUSE_QKV_ENC", "ECAP_W8A8"):
            mp.delenv(name, raising=False)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()
    jax.clear_caches()


# The tier-1 run puts six test workers on the machine's cores: small
# torch ops on all of them spin at each parallel region's barrier for the
# threads other workers hold (a detector training test took 86 s on 8
# threads beside a loaded CPU, 5.5 s on 2). Most port test files import
# this module, and each xdist worker imports every test file, so every
# worker keeps two intra-op threads.
TEST_TORCH_THREADS = 2
torch.set_num_threads(TEST_TORCH_THREADS)


def leaf_names(tree, path: str = "") -> list:
    """Dotted names of a parameter tree's leaves in `tree_leaves` order
    (dict keys sorted, lists in order; None is no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{path}.{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{path}[{i}]")]
    return [path]


def perturbed(tree, seed: int, rel: float = 1e-4):
    """A JAX parameter tree with every leaf moved by `rel` of itself
    (times a standard normal draw), for measuring how far the JAX
    package's own bf16 gradients move (ROADMAP C.20)."""
    leaves, tdef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tdef, [
        np.asarray(x) * (1 + rel * rng.standard_normal(np.shape(x))).astype(
            np.float32) for x in leaves])


def gradient_errors(got: list, want: list, spreads: list, rel: float,
                    spread_factor: float) -> list:
    """Per leaf (error, limit): error = ||got - want||, limit = the larger
    of rel * ||want|| and spread_factor * spread, where `spread` is how
    far the JAX package's own gradient of that leaf moved when the
    parameters moved by 1e-4 of themselves. A leaf whose gradient is
    mathematically zero or rounding noise (a key bias; the query and key
    of an attention whose keys are nearly equal) moves by more than its
    own norm there, so only the spread can bound it."""
    out = []
    for g, w, s in zip(got, want, spreads):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        out.append((float(np.linalg.norm(g - w)),
                    max(rel * float(np.linalg.norm(w)), spread_factor * s)))
    return out


# ---------------------------------------------------------------------------
# the unfused exploration loop of both packages (agents/baselines.py)
# ---------------------------------------------------------------------------

# tiny settings of the generate tests: 128^2 sensors over the tiny
# detector's 64^2 mask raster, so fusion runs on upsampled masks; the KL
# env, so each step reads the KL reward too; detector threshold 0 so that
# the random-weight detector yields detections
GENERATE_OVERRIDES = [
    "runtime.num_envs=2", "sensors.height=128", "sensors.width=128",
    "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2",
    "runtime.caption_slots_per_frame=2", "detector.score_threshold=0.0",
    "runtime.env_name=SemanticDisagreement-kl"]

# the trainers' tests (test_torch_trainers*.py): the generate tests'
# settings on the disagreement env (the KL env reads a frame's detections,
# which the fused loop does not hand it); scene seed 12 gives both loop
# forms a reward in env 0 within the 4 steps
TRAIN_SLICE = GENERATE_OVERRIDES[:-1] + [
    "sim.scene_seed=12", "sim.episode_steps=8", "ppo.num_global_steps=2",
    "ppo.ppo_epoch=2", "ppo.num_mini_batch=2"]


def _readouts(envs, base_reward) -> dict:
    """Per env: the KL reward (`get_reward` of the KL env), the
    disagreement reward and the top-down maps."""
    return dict(kl=[env.get_reward() for env in envs],
                disagreement=[base_reward(env) for env in envs],
                maps=[np.asarray(env.get_and_update_disagreement_map())
                      for env in envs])


def jax_generate_records(jcfg, steps: int, trainer: str = "randombaseline",
                         blocks: bool = True):
    """`steps` iterations of the JAX package's unfused loop (the body of
    BaseTrainer.generate, synchronous and without the store) with its
    Pallas kernels (`jax_kernel_path(blocks)`). Returns (trainer, records):
    per step the frames handed to perception, the detections at the mask
    raster (`to_numpy_dict`), the readouts after fusion and the actions."""
    import embodied_captioning_tpu.agents.baselines  # noqa: F401
    from embodied_captioning_tpu.agents.registry import get_trainer
    from embodied_captioning_tpu.envs.env import EmbodiedEnv

    tr = get_trainer(trainer)(jcfg)
    records = []
    obs = tr.envs.observe()
    with jax_kernel_path(blocks=blocks):
        for _ in range(steps):
            result = tr.perceive_and_fuse(obs)
            rec = dict(obs={k: np.array(v) for k, v in obs.items()},
                       det=result.detections.to_numpy_dict(),
                       **_readouts(tr.envs.envs, EmbodiedEnv.get_reward))
            rec["actions"] = [int(a) for a in tr.actions(obs)]
            obs = tr.envs.step(rec["actions"])[0]
            records.append(rec)
    return tr, records


def port_generate_on(cfg, params, records, trainer: str = "randombaseline",
                     frames: str = "handed", detections: bool = False):
    """The port's unfused loop over the JAX records' steps, on the CPU,
    taking the same actions (asserted equal to its own controller's).
    `frames`: "handed" perceives the JAX package's frames, "own" its own
    render; with `detections` perception is skipped and the JAX package's
    detections are fused. Returns the readouts per step."""
    from embodied_captioning_tpu_torch.agents import baselines  # noqa: F401
    from embodied_captioning_tpu_torch.agents.registry import get_trainer
    from embodied_captioning_tpu_torch.envs.env import EmbodiedEnv
    from embodied_captioning_tpu_torch.ops.detections import Detections
    from embodied_captioning_tpu_torch.perception import (
        FrameResult, Perceiver)

    tr = get_trainer(trainer)(cfg, device="cpu", perceiver=Perceiver(
        cfg, params=params, device="cpu"))
    out = []
    obs = tr.envs.observe()
    for rec in records:
        if frames == "handed":
            obs = {k: torch.from_numpy(v) for k, v in rec["obs"].items()}
        if detections:
            det = Detections.from_numpy_dict(rec["det"], "cpu")
            tr.perceiver.process = lambda _, d=det: FrameResult(
                d, None, None, None)
        tr.perceive_and_fuse(obs)
        out.append(_readouts(tr.envs.envs, EmbodiedEnv.get_reward))
        acts = [int(a) for a in tr.actions(obs)]
        assert acts == rec["actions"], (acts, rec["actions"])
        obs = tr.envs.step(acts)[0]
    return out


def readouts_agree(got: dict, want: dict, env: int) -> bool:
    """Rewards of one env within rtol 1e-4 / atol 1e-5 (the JAX package's
    loop-parity tolerance)."""
    return all(np.allclose(got[k][env], want[k][env], rtol=1e-4, atol=1e-5)
               for k in ("kl", "disagreement"))


# ---------------------------------------------------------------------------
# probes: the measurements behind the tolerances of the loop-slice tests
# (python tests/torch_parity.py render | rollout-scan | rollout-scan-blocks
# | beam | generate-scan | grad-chaos); not collected
# ---------------------------------------------------------------------------

def probe_render(size: int = 128, seeds=(1, 2, 3, 7, 11),
                 actions=(1, 2, 1, 3, 1, 1)) -> dict:
    """Pixels on which the port's render differs from the JAX render, over
    `seeds` x `actions` poses at size^2."""
    from embodied_captioning_tpu.config import SensorConfig as JSensor
    from embodied_captioning_tpu.config import SimConfig as JSim
    from embodied_captioning_tpu.envs import sim as JS
    from embodied_captioning_tpu_torch.config import SensorConfig, SimConfig
    from embodied_captioning_tpu_torch.envs import sim as S

    out = dict(pixels=0, depth=0, instances=0, classes=0, rgb_any=0,
               rgb_over_1_level=0)
    for seed in seeds:
        js = JS.RaycastSim(JSim(), JSensor(height=size, width=size), seed=seed)
        ts = S.RaycastSim(SimConfig(), SensorConfig(height=size, width=size),
                          seed=seed, device="cpu")
        for a in actions:
            js.step(a), ts.step(a)
            ref, got = js.observe(), ts.observe()
            out["pixels"] += size * size
            for k in ("depth", "instances", "classes"):
                out[k] += int((np.asarray(ref[k]) != got[k].numpy()).sum())
            d = np.abs(np.asarray(ref["rgb"]).astype(int)
                       - got["rgb"].numpy().astype(int)).max(-1)
            out["rgb_any"] += int((d > 0).sum())
            out["rgb_over_1_level"] += int((d > 1).sum())
    return out


def probe_rollout_scan(blocks: bool, bases=(1, 13, 25, 37), envs: int = 12,
                       steps: int = 4):
    """Tiny `rollout_fused` over env seeds base..base+envs-1 with the
    random plan of seed 5: for every env with a non-zero reward, the JAX
    rewards, the port's on the JAX package's frames, and whether they agree
    within rtol 1e-4 / atol 1e-5. `blocks`: both packages on their
    whole-block decode route, else both on the route of separate calls."""
    import functools

    from embodied_captioning_tpu.config import load_config
    from embodied_captioning_tpu.envs import device_loop as JDL
    from embodied_captioning_tpu.envs.sim import RaycastSim as JSim
    from embodied_captioning_tpu.mapping import voxel_map as JV
    from embodied_captioning_tpu.perception import init_perception
    from embodied_captioning_tpu_torch import params as P
    from embodied_captioning_tpu_torch.config import (
        ExperimentConfig, apply_dotlist)
    from embodied_captioning_tpu_torch.envs import device_loop as DL

    ov = ["sensors.height=64", "sensors.width=64", "sim.num_objects=6",
          "sim.scene_size=8.0", "map.voxel_size=0.2",
          "runtime.caption_slots_per_frame=2", "detector.score_threshold=0.0"]
    jcfg = load_config("tiny", overrides=ov)
    cfg = apply_dotlist(ExperimentConfig.preset_config("tiny"), ov)
    jparams = init_perception(jax.random.PRNGKey(0), jcfg)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tparams = P.from_jax(as_np(jparams), "cpu")
    actions = JDL.make_action_plan(steps, envs, pattern="random", seed=5)
    render, perceive, rows = DL._render_scan, DL.perceive, []
    for base in bases:
        sims = [JSim(jcfg.sim, jcfg.sensors, seed=base + i)
                for i in range(envs)]
        scenes, state = JDL.states_from_sims(sims)
        maps = jax.tree_util.tree_map(
            lambda *xs: jax.numpy.stack(xs),
            *[JV.create(jcfg.map, np.asarray(s.scene.lower)) for s in sims])
        port = (P.scene_from_jax(as_np(scenes), "cpu"),
                P.loop_state_from_jax(as_np(state), "cpu"),
                P.map_state_from_jax(as_np(maps), "cpu"))
        frames, st = [], state
        for k in range(steps):
            st = JDL.step_agents(scenes, st, jax.numpy.asarray(actions[k]),
                                 jcfg.sim)
            rgb, depth, _, _ = JDL._render_scan(
                scenes, JDL.camera_poses(st), jcfg, True)
            frames.append({"rgb": t(rgb), "depth": t(depth)})
        with jax_kernel_path(blocks=blocks):
            ref = np.asarray(JDL.rollout_fused(
                jparams, scenes, state, maps, jax.numpy.asarray(actions),
                jax.random.PRNGKey(2), jcfg)[2])
        handed = iter(frames)
        DL._render_scan = lambda sc, poses, c: next(handed)
        DL.perceive = functools.partial(perceive, decode_blocks=blocks)
        try:
            got = DL.rollout_fused(tparams, *port, actions, cfg)[2].numpy()
        finally:
            DL._render_scan, DL.perceive = render, perceive
        for i in range(envs):
            if ref[:, i].any() or got[:, i].any():
                rows.append(dict(
                    seed=base + i, column=i, jax=ref[:, i].tolist(),
                    port=got[:, i].tolist(),
                    agree=bool(np.allclose(got[:, i], ref[:, i], rtol=1e-4,
                                           atol=1e-5))))
    return rows


def probe_generate_scan(seeds=range(0, 20, 2), steps: int = 4):
    """The unfused loop (randombaseline, 2 envs a scene seed) of both
    packages on their block decode routes with the same float weights:
    per env with a reward above 1e-5, whether the port's KL and
    disagreement rewards agree with the JAX package's at every step (rtol
    1e-4 / atol 1e-5) when it fuses the JAX package's detections
    ("detections"), perceives the JAX package's frames ("handed") or its
    own render ("own")."""
    from embodied_captioning_tpu.config import load_config
    from embodied_captioning_tpu_torch import params as P
    from embodied_captioning_tpu_torch.config import load_config as tload

    rows = []
    for seed in seeds:
        ov = GENERATE_OVERRIDES + [f"sim.scene_seed={seed}"]
        jtr, recs = jax_generate_records(load_config("tiny", overrides=ov),
                                         steps)
        params = P.from_jax(jax.tree_util.tree_map(
            np.asarray, jtr.perceiver.params), "cpu")
        cfg = tload("tiny", overrides=ov)
        got = {f: port_generate_on(cfg, params, recs, frames=f)
               for f in ("handed", "own")}
        got["detections"] = port_generate_on(cfg, params, recs,
                                             detections=True)
        for i in range(2):
            if not any(max(r["disagreement"][i], r["kl"][i]) > 1e-5
                       for r in recs):
                continue
            rows.append(dict(
                scene_seed=seed, env=i,
                jax=[r["disagreement"][i] for r in recs],
                **{f: all(readouts_agree(g, r, i) for g, r in
                          zip(got[f], recs)) for f in got}))
    return rows


def probe_beam(seeds=(0, 1, 2, 3), widths=(2, 3, 4), crops: int = 4):
    """Tiny `generate_beam` on `crops` random 64^2 crops per seed: per
    seed and beam width, on how many rows the best beam's tokens of the
    port (block route) equal the JAX package's (block route), and on how
    many the JAX package's XLA route equals its own block route."""
    from embodied_captioning_tpu.config import CaptionerConfig as JCfg
    from embodied_captioning_tpu.models import captioner as JCAP
    from embodied_captioning_tpu_torch.config import CaptionerConfig as TCfg
    from embodied_captioning_tpu_torch.models import captioner as TCAP
    from embodied_captioning_tpu_torch.params import from_jax

    jc, tc = JCfg.tiny(), TCfg.tiny()
    params = JCAP.init_captioner(jax.random.PRNGKey(0), jc)
    tparams = from_jax(params, "cpu")
    rows = []
    for seed in seeds:
        imgs = (np.random.default_rng(seed).random((crops, 64, 64, 3)) * 255
                ).astype(np.uint8)
        for w in widths:
            jax.clear_caches()
            xla = np.asarray(JCAP.generate_beam(params, jax.numpy.asarray(imgs),
                                                jc, num_beams=w)[0])
            with jax_kernel_path(blocks=True):
                ref = np.asarray(JCAP.generate_beam(
                    params, jax.numpy.asarray(imgs), jc, num_beams=w)[0])
            got = TCAP.generate_beam(tparams, t(imgs), tc, num_beams=w)[0]
            rows.append(dict(
                seed=seed, beams=w, rows=crops,
                port_equals_jax=int((got.numpy() == ref).all(1).sum()),
                jax_xla_equals_jax_blocks=int((xla == ref).all(1).sum())))
    return rows


def jax_first_gradients(params, rollout, key, jcfg):
    """The JAX package's own gradients of the first minibatch of
    `ppo_update`: its optimizer is swapped, for this call, for one that
    keeps the first gradients it sees in its state and updates nothing.
    Returns the gradient tree (numpy)."""
    import jax.numpy as jnp
    import optax

    from embodied_captioning_tpu.agents import ppo as JPPO

    def init(p):
        return (jnp.zeros([], jnp.int32),
                jax.tree_util.tree_map(jnp.zeros_like, p))

    def update(g, state, p=None):
        count, first = state
        first = jax.tree_util.tree_map(
            lambda f, x: jnp.where(count == 0, x, f), first, g)
        return jax.tree_util.tree_map(jnp.zeros_like, g), (count + 1, first)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPPO, "make_optimizer",
                   lambda c: optax.GradientTransformation(init, update))
        state, _ = JPPO.ppo_update(JPPO.create_state(params, jcfg), rollout,
                                   key, jcfg)
    return jax.tree_util.tree_map(np.asarray, state.opt_state[1])


def probe_gradient_chaos(map_sizes=(32, 128), moves=(1e-4, 2e-3)) -> list:
    """How far bf16 rounding moves the policy's first-minibatch gradients
    (ROADMAP C.20): per map size and policy form, the largest relative L2
    change of a trunk leaf (convs, fc1, fc2, the orientation embedding)
    of the JAX package's own gradients when the rollout's maps move by
    `moves` of themselves, beside the port's distance from the JAX
    package on the unmoved maps (the rollout of tests/test_torch_policy.py,
    4 decisions x 4 envs)."""
    from embodied_captioning_tpu.agents import policy as JP
    from embodied_captioning_tpu.config import PolicyConfig as JPolicy
    from embodied_captioning_tpu.config import PPOConfig as JPPOConfig
    from embodied_captioning_tpu_torch.agents import ppo as TPPO
    from embodied_captioning_tpu_torch.agents import storage as TS
    from embodied_captioning_tpu_torch.config import PPOConfig
    from embodied_captioning_tpu_torch.params import from_jax, to_numpy
    from test_torch_policy import _rollout

    jcfg = JPPOConfig(num_mini_batch=2, ppo_epoch=2)
    key = jax.random.PRNGKey(3)
    trunk = ("convs", "fc1", "fc2", "orient_emb")

    def trunk_errors(got, want):
        out = []
        for name in trunk:
            for a, b in zip(TPPO.tree_leaves(from_jax(got[name], "cpu")),
                            TPPO.tree_leaves(from_jax(want[name], "cpu"))):
                out.append(float((a - b).norm() / b.norm().clamp(min=1e-30)))
        return max(out)

    rows = []
    for size in map_sizes:
        for recurrent in (False, True):
            jp = JP.init_policy(jax.random.PRNGKey(0),
                                JPolicy(map_size=size, recurrent=recurrent))
            ro = _rollout(size, 4, 4, recurrent)
            want = jax_first_gradients(jp, ro, key, jcfg)
            perm = np.asarray(jax.random.permutation(
                jax.random.split(key, 2)[0], 16))
            batch = TPPO.prepare_batch(TS.Rollout(*ro), PPOConfig(
                num_mini_batch=2, ppo_epoch=2), "cpu")
            tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
            got = to_numpy(TPPO.ppo_grads(
                tp, batch, torch.from_numpy(perm[:8]),
                PPOConfig(num_mini_batch=2, ppo_epoch=2))[0])
            row = dict(map_size=size, recurrent=recurrent,
                       port_vs_jax=round(trunk_errors(got, want), 4))
            for m in moves:
                rng = np.random.default_rng(9)
                moved = ro._replace(maps=(ro.maps * (1 + m * rng.standard_normal(
                    ro.maps.shape))).astype(np.float32))
                row[f"jax_maps_moved_{m:g}"] = round(trunk_errors(
                    jax_first_gradients(jp, moved, key, jcfg), want), 4)
            rows.append(row)
    return rows


def probe_preprocess_diff(cases=((64, 64, 8), (224, 224, 14), (64, 90, 8),
                                  (224, 333, 14)), seed: int = 0) -> list:
    """The port's preprocess twin (`fused_preprocess_plain`) against the JAX
    package's unfused `preprocess_for_vit` (its default path) on 4 random
    uint8 images per (out size, source size, patch): the largest absolute
    difference of the float32 tokens, the share of tokens that differ, and
    the share whose bf16 rounding (the patch product's input) differs."""
    import jax.numpy as jnp

    from embodied_captioning_tpu.ops.image import preprocess_for_vit as jpre
    from embodied_captioning_tpu_torch.ops.image import preprocess_for_vit

    rng = np.random.default_rng(seed)
    rows = []
    for size, src, patch in cases:
        imgs = rng.integers(0, 256, (4, src, src, 3), dtype=np.uint8)
        want = np.asarray(jpre(jnp.asarray(imgs), size, patch))
        got = preprocess_for_vit(torch.from_numpy(imgs), size, patch).numpy()
        bf = [torch.from_numpy(np.array(x)).to(torch.bfloat16)
              for x in (want, got)]
        rows.append(dict(size=size, source=src, patch=patch,
                         max_abs=float(np.abs(got - want).max()),
                         share_differ=float((got != want).mean()),
                         share_bf16_differ=float(
                             (bf[0] != bf[1]).float().mean())))
    return rows


def probe_preprocess_rounding(outs=tuple(range(40, 300, 3)) + (64, 128, 224),
                              src: int = 997, seed: int = 0) -> list:
    """How XLA on the CPU rounds the JAX package's resize (a dense weight
    product [out, src] @ [src, ...]) at each output size: every two-tap sum
    as one FMA ("fma"), as two rounded products and their sum ("separate",
    the port's one spelling), or neither throughout ("mixed"). One random
    image of `src` x 7 pixels, vertical pass."""
    import jax.numpy as jnp

    from embodied_captioning_tpu.ops import image as JI
    from embodied_captioning_tpu_torch.kernels.preprocess import source_taps

    x = (np.random.default_rng(seed).integers(0, 256, (1, src, 7, 3))
         .astype(np.float32) / np.float32(255))
    rows = []
    for out in outs:
        w = JI._interp_weights(JI._src_coords(out, src, False), src)
        got = np.asarray(jnp.einsum("oh,...hwc->...owc", w, x,
                                    preferred_element_type=jnp.float32))
        i0, i1, f = (np.asarray(v) for v in source_taps(out, src, "cpu"))
        lo = x[:, i0] * (1 - f)[None, :, None, None]
        hi = x[:, i1].astype(np.float64) * f[None, :, None, None]
        fma = (hi + lo.astype(np.float64)).astype(np.float32)
        sep = lo + hi.astype(np.float32)
        rows.append(dict(out=out, xla=(
            "fma" if np.array_equal(got, fma) else
            "separate" if np.array_equal(got, sep) else "mixed")))
    return rows


def probe_template_cosines(port_seeds=(0, 1, 2, 3)) -> list:
    """The captioner self-check's bar reads the mean cosine of a
    sentence encoder's embeddings of the predicted and the reference
    captions, "a {colour} {class}", with random seeded weights. Per
    encoder (the JAX package's SentenceEncoder.create(0), jax.random, and
    the port's create(seed), a torch.Generator), the mean cosine of two
    different template captions, of two of one class, and of two of
    different classes: what a wrong caption scores."""
    from embodied_captioning_tpu.config import SentenceEncoderConfig as JC
    from embodied_captioning_tpu.models.sbert import SentenceEncoder as JSE
    from embodied_captioning_tpu_torch.config import SentenceEncoderConfig
    from embodied_captioning_tpu_torch.models.sbert import SentenceEncoder

    caps = [f"a {c} {k}" for c in ("brown", "green", "blue", "white",
                                   "black")
            for k in ("couch", "plant", "bed", "table", "toilet", "tv")]
    cls = [c.split()[2] for c in caps]

    def row(name, e):
        s = np.asarray(e, np.float64) @ np.asarray(e, np.float64).T
        n = len(caps)
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        return dict(encoder=name,
                    different=round(float(np.mean([s[i, j]
                                                   for i, j in pairs])), 4),
                    same_class=round(float(np.mean([
                        s[i, j] for i, j in pairs if cls[i] == cls[j]])), 4),
                    other_class=round(float(np.mean([
                        s[i, j] for i, j in pairs if cls[i] != cls[j]])), 4))

    rows = [row("jax create(0)", JSE.create(0, JC.tiny()).encode(caps))]
    for seed in port_seeds:
        rows.append(row(f"port create({seed})", SentenceEncoder.create(
            seed, SentenceEncoderConfig.tiny(), "cpu").encode(caps)))
    return rows


def probe_update_gaps(store: str = "") -> list:
    """What the teacher-student steps did against the JAX package's
    (`train/optim.update_gaps`, `relative_gap`; test_torch_pipelines.py's
    limits come from these rows): two steps of each class and head, on the
    port as it is and on ports made wrong on purpose (a decay of 0.01, the
    optimizer's state reset every step, the gradient negated); with a
    `store` directory (written here when missing) also one `run_round` of
    each pipeline."""
    import glob
    import os

    import test_torch_pipelines as P
    from embodied_captioning_tpu.config import load_config as jload_config
    from embodied_captioning_tpu.models import detector as JD
    from embodied_captioning_tpu.perception import Perceiver as JPer
    from embodied_captioning_tpu.train import pipelines as JP
    from embodied_captioning_tpu_torch.config import load_config
    from embodied_captioning_tpu_torch.models import detector as TD
    from embodied_captioning_tpu_torch.params import from_jax
    from embodied_captioning_tpu_torch.train import optim as TO
    from embodied_captioning_tpu_torch.train import pipelines as TP

    def gaps(before, jts, tts):
        g = TO.update_gaps(before, P._leaves(tts.student),
                           P._leaves(jts.student), P.LR)
        (jc, jmu, jnu), (tc, tmu, tnu) = P._adam_state(jts), P._adam_state(
            tts)
        mom = max(TO.relative_gap(tmu, jmu), TO.relative_gap(tnu, jnu))
        return dict(agree=round(g["agree"], 5),
                    decay=float(f"{g['decay']:.3e}"),
                    moments=float(f"{mom:.3e}"), count=(tc, jc))

    faults = {"none": None, "decay_0.01": ("WEIGHT_DECAY", 0.01),
              "reset_state": ("adam_update", P._reset(TP.adam_update)),
              "negated_gradient": ("adam_update",
                                   P._negated(TP.adam_update))}
    jper = JPer(jload_config("tiny"))
    rows = []
    for cls, head in (("TeacherStudent", "ce"),
                      ("TeacherStudent", "focal"),
                      ("OnlineTeacherStudent", "ce"),
                      ("OnlineTeacherStudent", "focal")):
        for name, fault in faults.items():
            saved = fault and getattr(TP, fault[0])
            if fault:
                setattr(TP, fault[0], fault[1])
            try:
                jts, tts = P._pair(cls, head, jper)
                before = P._leaves(tts.student)
                row = dict(cls=cls, head=head, fault=name)
                for i, batch in enumerate((P._batch(), P._batch(
                        rng=np.random.default_rng(1)))):
                    jts.training_step(batch)
                    tts.training_step(batch)
                    row[f"step{i + 1}"] = gaps(before, jts, tts)
            finally:
                if fault:
                    setattr(TP, fault[0], saved)
            rows.append(row)
    if not store:
        return rows
    if not os.path.exists(store):
        jax_store(store)
        for f in glob.glob(os.path.join(store, "*",
                                        "*modality_bbs_id_*.npz")):
            d = np.load(f, allow_pickle=True)["arr_0"].item()
            inst = dict(d["instances"])
            inst["boxes"] = np.asarray(inst["boxes"], np.float32) + 0.25
            np.savez_compressed(
                f.replace("modality_bbs_id_3", "modality_bbsgt_id_4"),
                np.array({"instances": inst}, dtype=object))
    for name in ("Pipeline", "OnlinePipeline", "GTPipeline",
                 "SWAPipeline"):
        kw = dict(consensus="soft", head="focal")
        if name == "SWAPipeline":
            kw["snapshot_every"] = 1
        jpipe = getattr(JP, name)(jload_config(
            "tiny", overrides=STORE_OVERRIDES), **kw)
        jlogs = jpipe.run_round(store)
        params = jax.tree_util.tree_map(np.asarray, JD.init_detector(
            jax.random.split(jax.random.PRNGKey(0))[0],
            jpipe.cfg.detector))
        real = TD.init_detector
        TD.init_detector = lambda g, cfg, dev: from_jax(params, dev)
        try:
            tpipe = getattr(TP, name)(
                load_config("tiny", overrides=STORE_OVERRIDES),
                device="cpu", perceiver=P._port_perceiver(
                    jper, STORE_OVERRIDES), **kw)
        finally:
            TD.init_detector = real
        tlogs = tpipe.run_round(store)
        rows.append(dict(pipeline=name, steps=len(jlogs), **gaps(
            P._leaves(params), jpipe.ts, tpipe.ts), loss=[
                {k: float(f"{abs(t[k] - j[k]) / max(abs(j[k]), 1e-4):.2e}")
                 for k in j} for t, j in zip(tlogs, jlogs)]))
    return rows


# ---------------------------------------------------------------------------
# the query detector's decoder and set loss (ROADMAP C.29)
# ---------------------------------------------------------------------------

QUERY_QCFG = dict(image_size=64, backbone_width=16, fpn_dim=64,
                  family="query", num_queries=16, query_layers=3,
                  max_detections=8, score_threshold=0.1)


def probe_query_chaos(aux_topks=(0, 3), moves=(1, 2, 3, 4)) -> list:
    """At tests/test_query_detector.py's QCFG on the JAX package's seeded
    weights: per supervision point, the port's distance from the JAX
    decoder (kernel path) beside the JAX decoder's own spread under 1e-4
    moves of the weights; per `query_aux_topk`, the loss gap and the
    largest ratio of a leaf's gradient gap to its spread (the training
    path)."""
    import functools

    import jax.numpy as jnp

    from embodied_captioning_tpu.config import DetectorConfig as JCfg
    from embodied_captioning_tpu.models import detector as JD
    from embodied_captioning_tpu.models import query_detector as JQ
    from embodied_captioning_tpu.ops.detections import Detections as JDet
    from embodied_captioning_tpu_torch.config import DetectorConfig as TCfg
    from embodied_captioning_tpu_torch.models import detector as TD
    from embodied_captioning_tpu_torch.models import query_detector as TQ
    from embodied_captioning_tpu_torch.ops.detections import (
        Detections as TDet,
    )
    from embodied_captioning_tpu_torch.params import from_jax, to_numpy
    from embodied_captioning_tpu_torch.train.optim import value_and_grad
    from test_torch_query_detector import _gt_batch

    rows = []
    jc, tc = JCfg(**QUERY_QCFG), TCfg(**QUERY_QCFG)
    p = JD.init_detector(jax.random.PRNGKey(0), jc)
    imgs, gt = _gt_batch(np.random.default_rng(0), 2, 8, 64)
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    with jax_kernel_path():
        fn = jax.jit(functools.partial(JQ._decode, cfg=jc))
        want = fn(p, x)
        moved = [fn(perturbed(p, s), x) for s in moves]
    with torch.no_grad():
        got = TQ._decode(from_jax(p, "cpu"),
                         torch.from_numpy(imgs).float() / 255.0, tc)
    for li, (g, w) in enumerate(zip(got, want)):
        err = float(np.linalg.norm(np32(g[1]) - np32(w[1])))
        spread = max(float(np.linalg.norm(np32(m[li][1]) - np32(w[1])))
                     for m in moved)
        rows.append({"decoder point": li, "mask logits gap": err,
                     "jax spread": spread})
    for k in aux_topks:
        jc, tc = (JCfg(**QUERY_QCFG, query_aux_topk=k),
                  TCfg(**QUERY_QCFG, query_aux_topk=k))
        p = JD.init_detector(jax.random.PRNGKey(1), jc)
        imgs, gt = _gt_batch(np.random.default_rng(1), 4, 8, 64)
        jgt = JDet(**{n: jnp.asarray(v) for n, v in gt.items()})
        with jax_train_path():
            vg = jax.jit(jax.value_and_grad(lambda q: JD.detector_loss(
                q, jnp.asarray(imgs), jgt, jc)[0]))
            loss, grads = vg(p)
            mv = [vg(perturbed(p, s)) for s in moves]
        tl, _, tg = value_and_grad(lambda q: TD.detector_loss(
            q, torch.from_numpy(imgs),
            TDet(**{n: torch.from_numpy(np.asarray(v))
                    for n, v in gt.items()}), tc), from_jax(p, "cpu"))
        want = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
        got = [np32(g) for g in jax.tree_util.tree_leaves(to_numpy(tg))]
        ratios = []
        for i, (g, w) in enumerate(zip(got, want)):
            spread = max(float(np.linalg.norm(
                np32(jax.tree_util.tree_leaves(m[1])[i]) - w)) for m in mv)
            ratios.append(float(np.linalg.norm(g - w)) / max(spread, 1e-30))
        rows.append({"aux_topk": k, "loss": float(loss),
                     "loss gap": abs(float(tl) - float(loss)),
                     "jax loss spread": max(abs(float(m[0]) - float(loss))
                                            for m in mv),
                     "largest gradient gap / spread": max(ratios)})
    return rows


# ---------------------------------------------------------------------------
# a small store of the JAX package's exploration loop
# ---------------------------------------------------------------------------

# tiny settings of the labeling tests' stores: 64^2 frames, detector
# threshold 0 so that the random-weight detector yields detections
STORE_OVERRIDES = [
    "runtime.num_envs=2", "sensors.height=64", "sensors.width=64",
    "sim.num_objects=6", "sim.scene_size=8.0", "map.voxel_size=0.2",
    "detector.score_threshold=0.0"]


def jax_store(root: str, steps: int = 4, overrides=STORE_OVERRIDES):
    """`steps` steps of the JAX package's `randombaseline` generate (2 envs)
    written to the npz store at `root`; returns the JAX config."""
    import embodied_captioning_tpu.agents.baselines  # noqa: F401
    from embodied_captioning_tpu.agents.registry import get_trainer
    from embodied_captioning_tpu.config import load_config

    jcfg = load_config("tiny", overrides=list(overrides) + [
        f"runtime.obs_dir={root}"])
    tr = get_trainer("randombaseline")(jcfg)
    tr.generate(steps)
    tr.envs.close()
    return jcfg


# ---------------------------------------------------------------------------
# the teacher-student loop's student loss (ROADMAP C.49)
# ---------------------------------------------------------------------------

def probe_student_loss(teacher: str, keys=(1, 2, 3)) -> list:
    """The detector loss of a student at initialisation on one batch of
    the teacher-student loop's pseudo-labels (the port's pool of 2 scenes
    from seed 2000, labelled by `teacher`, a `selfcheck_detector --save`
    pickle, at threshold 0.5), per consensus mode and key: the JAX
    package's at `init_detector(PRNGKey(key))`, the port's on those
    weights, and the port's at its own init from a generator seeded
    `key` (the entry points' students start at seed + 1)."""
    import dataclasses

    import jax.numpy as jnp

    from embodied_captioning_tpu.config import load_config as jload
    from embodied_captioning_tpu.config import merge as jmerge
    from embodied_captioning_tpu.models import detector as JD
    from embodied_captioning_tpu.ops.detections import Detections as JDet
    from embodied_captioning_tpu_torch import selfcheck_teacher_student as TS
    from embodied_captioning_tpu_torch.config import load_config, merge
    from embodied_captioning_tpu_torch.models import detector as TD
    from embodied_captioning_tpu_torch.params import from_jax
    from embodied_captioning_tpu_torch.selfcheck_detector import (
        FIELDS, stack_detections)

    params, train_cfg = TS.load_teacher(teacher, "cpu")
    over = {"detector": train_cfg,
            "map": {"grid": (256, 64, 256), "max_objects": 128}}
    cfg = merge(load_config("tiny"), over)
    jdcfg = jmerge(jload("tiny"), over).detector
    pool = TS.collect_with_pose(cfg, 2, 16, 2000, np.random.default_rng(0),
                                "cpu")
    samples = TS.label_pool(params, pool, dataclasses.replace(
        cfg.detector, score_threshold=0.5), 8, "cpu")
    rows = []
    for mode in ("vanilla", "soft"):
        pseudo, head = TS.consensus(mode, samples, cfg, "cpu")
        frames = TS.to_frames([p for p in pseudo if p.valid.any()])[:8]
        imgs = np.stack([f[0] for f in frames])
        gt = stack_detections([f[1] for f in frames], "cpu")
        jgt = JDet(**{k: jnp.asarray(np.stack([f[1][k] for f in frames]))
                      for k in FIELDS})
        for key in keys:
            p0 = JD.init_detector(jax.random.PRNGKey(key), jdcfg)
            want = float(JD.detector_loss(p0, jnp.asarray(imgs), jgt, jdcfg,
                                          head=head)[0])
            with torch.no_grad():
                handed = float(TD.detector_loss(
                    from_jax(p0, "cpu"), torch.from_numpy(imgs), gt,
                    cfg.detector, head=head)[0])
                own = float(TD.detector_loss(
                    TD.init_detector(torch.Generator().manual_seed(key),
                                     cfg.detector, "cpu"),
                    torch.from_numpy(imgs), gt, cfg.detector, head=head)[0])
            rows.append({"mode": mode, "frames": len(frames), "key": key,
                         "jax": want, "port on the JAX weights": handed,
                         "port at its own init": own})
    return rows


if __name__ == "__main__":
    import sys
    from pathlib import Path

    # run as a script, sys.path starts at tests/: add the repository root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    jax.config.update("jax_platforms", "cpu")
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "render":
        print(probe_render())
    elif what in ("rollout-scan", "rollout-scan-blocks"):
        for row in probe_rollout_scan(blocks=what.endswith("blocks")):
            print(row)
    elif what == "beam":
        for row in probe_beam():
            print(row)
    elif what == "grad-chaos":
        for row in probe_gradient_chaos():
            print(row)
    elif what == "preprocess-diff":
        for row in probe_preprocess_diff():
            print(row)
    elif what == "preprocess-rounding":
        rows = probe_preprocess_rounding()
        for row in rows:
            print(row)
        print({k: sum(r["xla"] == k for r in rows)
               for k in ("separate", "fma", "mixed")})
    elif what == "template-cosines":
        for row in probe_template_cosines():
            print(row)
    elif what == "update-gaps":
        for row in probe_update_gaps(sys.argv[2] if len(sys.argv) > 2
                                     else ""):
            print(row)
    elif what == "query-chaos":
        for row in probe_query_chaos():
            print(row)
    elif what == "student-loss" and len(sys.argv) == 3:
        for row in probe_student_loss(sys.argv[2]):
            print(row)
    elif what == "generate-scan":
        rows = probe_generate_scan()
        for row in rows:
            print(row)
        print({f: f"{sum(r[f] for r in rows)} of {len(rows)} envs agree"
               for f in ("detections", "handed", "own")})
    else:
        sys.exit("usage: python tests/torch_parity.py render | rollout-scan "
                 "| rollout-scan-blocks | beam | generate-scan | grad-chaos "
                 "| preprocess-diff | preprocess-rounding | template-cosines "
                 "| update-gaps [STORE_DIR] | query-chaos "
                 "| student-loss TEACHER_PKL")
