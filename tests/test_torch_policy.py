"""The port's global policy, rollout storage and PPO update
(agents/policy.py, storage.py, ppo.py) against the JAX package's, on the
JAX `init_policy` weights through `params.from_jax`.

Tolerances and their reasons:
- Policy outputs: 2 bf16 ulps of the largest element (2**-6 of it). The
  convs and dense layers round to bf16 at each layer; XLA keeps excess
  precision inside its fusions where torch rounds after each op, so a
  value can sit one or two ulps apart.
- Gradients of the first minibatch (the JAX package's own, read out by
  `torch_parity.jax_first_gradients`): relative L2 error per leaf 1e-2
  (feed-forward) and 5e-2 (GRU). Each backward product rounds its
  gradient to bf16; the GRU's gates add more bf16 roundings on the way
  to the trunk. For scale (ROADMAP C.20, `python tests/torch_parity.py
  grad-chaos`): moving the rollout's maps by a small share of themselves
  moves the JAX package's own trunk gradients by far more.
- Parameters after a whole update: Adam divides each moment by its own
  root, so an element whose gradient is near zero (or whose sign the
  bf16 noise flips) can step anywhere in [-lr, lr] in either package:
  up to 2 * lr apart per step, 2 * lr * steps in all. Over all elements
  the mean difference stays under a tenth of the mean move.
- The optimizer alone (clip, Adam, scale) on the same gradients: within
  2 float32 ulps of optax, or a millionth of a step (1e-6 * lr) where the
  parameter is near zero: the global norm sums its squares in another
  order, and XLA contracts the moment updates into fused multiply-adds.
- GAE and the storage: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from embodied_captioning_tpu.agents import policy as JP
from embodied_captioning_tpu.agents import ppo as JPPO
from embodied_captioning_tpu.agents import storage as JS
from embodied_captioning_tpu.config import PolicyConfig as JPolicyConfig
from embodied_captioning_tpu.config import PPOConfig as JPPOConfig
from embodied_captioning_tpu_torch.agents import policy as TP
from embodied_captioning_tpu_torch.agents import ppo as TPPO
from embodied_captioning_tpu_torch.agents import storage as TS
from embodied_captioning_tpu_torch.config import PolicyConfig, PPOConfig
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_first_gradients, np32

B = 8


def _policies(map_size: int, recurrent: bool, num_actions: int = 2):
    jp = JP.init_policy(jax.random.PRNGKey(0),
                        JPolicyConfig(map_size=map_size, recurrent=recurrent),
                        num_actions=num_actions)
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _inputs(map_size: int, recurrent: bool, seed: int = 1, b: int = B):
    rng = np.random.default_rng(seed)
    maps = rng.random((b, map_size, map_size, 2)).astype(np.float32)
    orient = rng.integers(0, 72, b).astype(np.int32)
    h = ((rng.standard_normal((b, 256)) * 0.5).astype(np.float32)
         if recurrent else None)
    return maps, orient, h


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _same_dtype(got: torch.Tensor, want) -> bool:
    return str(got.dtype) == "torch." + str(want.dtype)


def _close_bf16(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=2 ** -6 * np.abs(want).max())


CASES = [(32, False), (128, False), (32, True), (128, True)]


@pytest.mark.parametrize("map_size,recurrent", CASES)
def test_policy_forward_matches_jax(map_size, recurrent):
    jp, tp = _policies(map_size, recurrent)
    maps, orient, h = _inputs(map_size, recurrent)
    want = JP.policy_forward(jp, _j(maps), _j(orient), _j(h))
    got = TP.policy_forward(tp, _t(maps), _t(orient), _t(h))
    assert got.value.dtype == got.mean.dtype == torch.bfloat16
    assert got.value.shape == (B,) and got.mean.shape == (B, 2)
    _close_bf16(got.value, want.value)
    _close_bf16(got.mean, want.mean)
    assert torch.equal(got.log_std, _t(want.log_std))
    if recurrent:
        assert got.rnn_state.dtype == torch.float32
        _close_bf16(got.rnn_state, want.rnn_state)
    else:
        assert got.rnn_state is None and want.rnn_state is None


@pytest.mark.parametrize("categorical", [False, True])
@pytest.mark.parametrize("map_size,recurrent", [(32, False), (128, True)])
def test_deterministic_act_matches_jax(map_size, recurrent, categorical):
    jp, tp = _policies(map_size, recurrent, 4 if categorical else 2)
    maps, orient, h = _inputs(map_size, recurrent, seed=2)
    want = JP.act(jp, jax.random.PRNGKey(0), _j(maps), _j(orient),
                  deterministic=True, categorical=categorical, rnn_state=_j(h))
    got = TP.act(tp, None, _t(maps), _t(orient), deterministic=True,
                 categorical=categorical, rnn_state=_t(h))
    assert len(got) == len(want) == (5 if recurrent else 4)
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 2 and not categorical:
            # JAX's init_policy makes log_std weakly typed (`jnp.full` of a
            # Python float), so its log-prob of a bf16 mean stays bf16; a
            # log_std from a checkpoint is float32 there as here
            assert g.dtype == torch.float32 and w.dtype == jnp.bfloat16
            continue
        assert _same_dtype(g, w), (k, g.dtype, w.dtype)
    if categorical:
        # near-tied logits may pick another action: compare where the
        # JAX logits' margin exceeds the bf16 tolerance
        logits = np32(JP.policy_forward(jp, _j(maps), _j(orient),
                                        _j(h)).mean)
        top2 = np.sort(logits, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 ** -5 * np.abs(logits).max()
        assert clear.sum() >= B // 2
        np.testing.assert_array_equal(np32(got[0])[clear],
                                      np32(want[0])[clear])
        _close_bf16(got[2][clear], np.asarray(want[2])[clear])
    else:
        for g, w in zip(got[:4], want[:4]):
            _close_bf16(g, w)
    _close_bf16(got[3], want[3])
    if recurrent:
        _close_bf16(got[4], want[4])


@pytest.mark.parametrize("categorical", [False, True])
@pytest.mark.parametrize("recurrent", [False, True])
def test_evaluate_actions_on_handed_actions(recurrent, categorical):
    jp, tp = _policies(32, recurrent, 4 if categorical else 2)
    maps, orient, h = _inputs(32, recurrent, seed=3)
    rng = np.random.default_rng(4)
    actions = (rng.integers(0, 4, B).astype(np.int32) if categorical
               else rng.standard_normal((B, 2)).astype(np.float32))
    want = JP.evaluate_actions(jp, _j(maps), _j(orient), _j(actions),
                               categorical, _j(h))
    got = TP.evaluate_actions(tp, _t(maps), _t(orient), _t(actions),
                              categorical, _t(h))
    for g, w in zip(got, want):
        assert _same_dtype(g, w) and g.shape == w.shape
    if categorical:
        # bf16 log-softmax of bf16 logits
        _close_bf16(got[0], want[0])
        _close_bf16(got[1], want[1])
    else:
        # float32 log-probs of bf16 means: the means' ulps, scaled by the
        # Gaussian's 1/var = e^2 and the action's distance to the mean
        np.testing.assert_allclose(np32(got[0]), np32(want[0]), rtol=2e-2,
                                   atol=2e-2)
        assert float(got[1]) == float(want[1])  # log_std only
    _close_bf16(got[2], want[2])


def test_sampled_gaussian_actions_statistics():
    """N samples of one input: the sample mean of the raw actions within
    5 standard errors of the JAX policy's mean, the sample std within 5%
    of exp(log_std), the actions in [0, 1], and each log-prob equal to
    the JAX package's `gaussian_log_prob` of the same raw action."""
    n = 4096
    jp, tp = _policies(32, False)
    maps, orient, _ = _inputs(32, False, seed=5, b=1)
    mean = np32(JP.policy_forward(jp, _j(maps), _j(orient)).mean)[0]
    std = float(np.exp(-1.0))
    g = torch.Generator().manual_seed(0)
    a, raw, lp, v = TP.act(tp, g, _t(np.repeat(maps, n, 0)),
                           _t(np.repeat(orient, n, 0)))
    raw = raw.numpy()
    assert raw.dtype == np.float32 and raw.shape == (n, 2)
    assert np.all(np.abs(raw.mean(0) - mean) < 5 * std / np.sqrt(n))
    np.testing.assert_allclose(raw.std(0), std, rtol=5e-2)
    assert ((a.numpy() >= 0) & (a.numpy() <= 1)).all()
    out = JP.policy_forward(jp, _j(np.repeat(maps, n, 0)),
                            _j(np.repeat(orient, n, 0)))
    want_lp = JP.gaussian_log_prob(_j(raw), out.mean, out.log_std)
    np.testing.assert_allclose(lp.numpy(), np32(want_lp), rtol=2e-2,
                               atol=2e-2)
    # another draw from the same generator differs
    assert not torch.equal(TP.act(tp, g, _t(maps), _t(orient))[1],
                           torch.from_numpy(raw[:1]))


def test_sampled_categorical_action_frequencies():
    """Frequencies of N draws within 5 standard errors of the JAX
    policy's softmax probabilities (logits made large enough to spread
    the draws by scaling the head)."""
    n = 20000
    jp, _ = _policies(32, False, num_actions=4)
    jp["act"]["w"] = jp["act"]["w"] * 50.0
    tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    maps, orient, _ = _inputs(32, False, seed=6, b=1)
    logits = JP.policy_forward(jp, _j(maps), _j(orient)).mean
    p = np.asarray(jax.nn.softmax(logits.astype(jnp.float32)))[0]
    assert p.max() < 0.9
    a = TP.act(tp, torch.Generator().manual_seed(1),
               _t(np.repeat(maps, n, 0)), _t(np.repeat(orient, n, 0)),
               categorical=True)[0].numpy()
    freq = np.bincount(a, minlength=4) / n
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / n) + 2e-2)


def _rollout(map_size: int, t: int, e: int, recurrent: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    return JS.Rollout(
        maps=rng.random((t + 1, e, map_size, map_size, 2)).astype(np.float32),
        orientation=rng.integers(0, 72, (t + 1, e)).astype(np.int32),
        raw_actions=rng.standard_normal((t, e, 2)).astype(np.float32),
        log_probs=(rng.standard_normal((t, e)) - 2).astype(np.float32),
        values=rng.random((t + 1, e)).astype(np.float32),
        rewards=rng.random((t, e)).astype(np.float32),
        masks=(rng.random((t + 1, e)) > 0.2).astype(np.float32),
        rnn_states=((rng.standard_normal((t, e, 256)) * 0.5).astype(
            np.float32) if recurrent else None))


def test_compute_gae_bit_for_bit():
    ro = _rollout(8, 16, 5, False, seed=7)
    want = JS.compute_gae(jnp.asarray(ro.rewards), jnp.asarray(ro.values),
                          jnp.asarray(ro.masks), 0.99, 0.95)
    got = TS.compute_gae(_t(ro.rewards), _t(ro.values), _t(ro.masks),
                         0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (ro.masks == 0).any()


def test_rollout_storage_matches_jax():
    rng = np.random.default_rng(8)
    stores = [JS.RolloutStorage(3, 2, 8, 2, rnn_dim=4),
              TS.RolloutStorage(3, 2, 8, 2, rnn_dim=4)]
    for s in stores:
        s.insert_obs(np.full((2, 8, 8, 2), 0.5, np.float32), [1, 2])
    for update in range(2):
        for _ in range(3):
            step = [rng.standard_normal((2, 2)), rng.standard_normal(2),
                    rng.standard_normal(2), rng.random(2),
                    (rng.random(2) > 0.5).astype(np.float32),
                    rng.random((2, 8, 8, 2)), rng.integers(0, 72, 2)]
            rnn = rng.standard_normal((2, 4))
            for s in stores:
                s.insert_step(*step, rnn_state=rnn)
        last = rng.standard_normal(2)
        got, want = stores[1].as_rollout(last), stores[0].as_rollout(last)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for s in stores:
            s.after_update()
        assert stores[1].t == stores[0].t == 0
        np.testing.assert_array_equal(stores[1].maps, stores[0].maps)
        np.testing.assert_array_equal(stores[1].masks, stores[0].masks)


def test_fifo_memory():
    m = TS.FIFOMemory(3)
    for i in range(5):
        m.push(i)
    assert len(m) == 3 and list(m.buffer) == [2, 3, 4]
    got = m.sample(np.random.default_rng(0), 5)
    assert sorted(got) == [2, 3, 4]


def _jax_perms(key, n: int, epochs: int):
    return [torch.from_numpy(np.asarray(jax.random.permutation(k, n)))
            for k in jax.random.split(key, epochs)]


def _leaves(tree):
    return [x.numpy() for x in TPPO.tree_leaves(tree)]


def _jax_leaves(jtree):
    return _leaves(from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                            "cpu"))


@pytest.mark.parametrize("recurrent", [False, True])
def test_first_minibatch_gradients_match_jax(recurrent):
    jcfg = JPPOConfig(num_mini_batch=2, ppo_epoch=2)
    cfg = PPOConfig(num_mini_batch=2, ppo_epoch=2)
    jp, tp = _policies(32, recurrent)
    ro = _rollout(32, 4, 4, recurrent)
    key = jax.random.PRNGKey(3)
    perms = _jax_perms(key, 16, jcfg.ppo_epoch)
    want = _jax_leaves(jax_first_gradients(jp, ro, key, jcfg))
    batch = TPPO.prepare_batch(TS.Rollout(*ro), cfg, "cpu")
    grads, loss, _ = TPPO.ppo_grads(tp, batch, perms[0][:8], cfg)
    got = _leaves(grads)
    assert len(got) == len(want) == len(TPPO.tree_leaves(tp))
    tol = 5e-2 if recurrent else 1e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (w.shape, err)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("recurrent", [False, True])
def test_ppo_update_matches_jax(recurrent):
    jcfg = JPPOConfig(num_mini_batch=2, ppo_epoch=2)
    cfg = PPOConfig(num_mini_batch=2, ppo_epoch=2)
    jp, tp = _policies(32, recurrent)
    ro = _rollout(32, 4, 4, recurrent)
    key = jax.random.PRNGKey(3)
    jstate, jm = JPPO.ppo_update(JPPO.create_state(jp, jcfg), ro, key, jcfg)
    state, m = TPPO.ppo_update_with(TPPO.create_state(tp, cfg),
                                    TS.Rollout(*ro),
                                    _jax_perms(key, 16, jcfg.ppo_epoch), cfg)
    assert set(m) == set(jm) == {"loss", "action_loss", "value_loss",
                                 "entropy"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3)
    assert state.opt_state.count == 4
    steps = jcfg.ppo_epoch * jcfg.num_mini_batch
    p0, got, want = _leaves(tp), _leaves(state.params), _jax_leaves(
        jstate.params)
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    move = np.concatenate([np.abs(w - p).ravel() for w, p in zip(want, p0)])
    assert diff.max() <= 2 * cfg.lr * steps
    assert diff.mean() <= 0.1 * move.mean()
    assert move.mean() > 0.5 * cfg.lr  # the update moved the parameters


@pytest.mark.parametrize("clipped", [False, True])
def test_optimizer_matches_optax(clipped):
    """`adam_step` (clip by global norm, Adam, -lr) against the JAX
    package's optax chain on the same gradients for three steps, with the
    norm below and above `max_grad_norm`."""
    cfg = PPOConfig()
    jcfg = JPPOConfig()
    jp, tp = _policies(32, False)
    opt = JPPO.make_optimizer(jcfg)
    jstate = JPPO.create_state(jp, jcfg)
    state = TPPO.create_state(tp, cfg)
    rng = np.random.default_rng(9)
    scale = 1.0 if clipped else 1e-4
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * scale,
                                  jnp.float32), jp)
        norm = float(optax.global_norm(g))
        assert (norm >= cfg.max_grad_norm) == clipped
        updates, opt_state = opt.update(g, jstate.opt_state, jstate.params)
        jstate = JPPO.PPOState(optax.apply_updates(jstate.params, updates),
                               opt_state)
        state = TPPO.adam_step(
            state, from_jax(jax.tree_util.tree_map(np.asarray, g), "cpu"),
            cfg)
    for g, w in zip(_leaves(state.params), _jax_leaves(jstate.params)):
        np.testing.assert_allclose(g, w, rtol=2 ** -21, atol=1e-6 * cfg.lr)


def test_matmul_f32_backward_matches_jax():
    """`dense`'s gradients against JAX's transpose of the bf16 dot with a
    float32 result: each operand's gradient rounded to bf16 then widened
    (one bf16 ulp: the float32 products sum in another order)."""
    rng = np.random.default_rng(10)
    p = {"w": rng.standard_normal((64, 32)).astype(np.float32) * 0.1,
         "b": rng.standard_normal(32).astype(np.float32)}
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    cot = rng.standard_normal((3, 5, 32)).astype(np.float32)
    from embodied_captioning_tpu.models import common as JC

    def jf(p, x):
        return jnp.sum(JC.dense(p, x).astype(jnp.float32) * cot)

    jg = jax.grad(jf, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                      jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    (TC.dense(tp, tx).float() * _t(cot)).sum().backward()
    for got, want in ((tp["w"].grad, jg[0]["w"]), (tp["b"].grad, jg[0]["b"]),
                      (tx.grad, jg[1])):
        assert got.dtype == torch.float32
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)
    # off autograd the product takes its plain route
    assert TC.matmul_f32(_t(x).to(torch.bfloat16),
                         _t(p["w"]).to(torch.bfloat16)).grad_fn is None
