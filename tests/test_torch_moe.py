"""The port's mixture-of-experts MLP (parallel/moe.py) and the MoE
captioner (`text.moe_experts > 0`) against the JAX package's, on the CPU.

Tolerances and their reasons:
- `_route_group` on handed probabilities: bit for bit (maxima, one-hots,
  float32 cumsums of 0/1 and copies of the chosen probabilities are
  exact), ties, pad rows and capacity overflow included;
- `moe_mlp`: 1e-5 (float32 products summed in another order; the gate's
  softmax may differ in the last bit, so the inputs are drawn on seeds
  whose top-2 gaps exceed 1e-6 and routing is the same); with bf16
  compute, 1e-2 (the combine rounds its operands to bf16, a flipped
  rounding moves a term by one bf16 ulp);
- the tiny MoE captioner: 98% of the logits within 5e-2 (the CoCa tests'
  bf16 limit) and all within 3x the JAX package's own spread under a 1e-4
  move of its parameters (a routing flip near a tie moves a token's
  logits by as much in the JAX package itself); `caption_loss` within
  the larger of 1e-3 of its value and 3x that spread, every leaf's
  gradient within the larger of 5% of its norm and 3x that spread (the
  C.20 / C.29 rule: a routing flip near a tie is one of the moves);
  greedy tokens equal on a seed where no row parts (C.8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.config import CaptionerConfig as JCfg
from embodied_captioning_tpu.models import captioner as JCap
from embodied_captioning_tpu.parallel import moe as JMOE
from embodied_captioning_tpu_torch.config import CaptionerConfig as TCfg
from embodied_captioning_tpu_torch.models import captioner as TCap
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models.quantize import (
    QuantizedArray, quantize_params,
)
from embodied_captioning_tpu_torch.parallel import moe as TMOE
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.train import captioner_train as TT
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, value_and_grad,
)
from torch_parity import (
    gradient_errors, jax_kernel_path, jax_train_path, leaf_names, np32,
    perturbed,
)

DIM, HID, E = 16, 32, 4
EXPERTS = 4  # the tiny captioner's
LOGIT_ATOL = 5e-2


def _tree(tree):
    return from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def moe_setup():
    params = JMOE.moe_init(jax.random.PRNGKey(0), DIM, HID, E)
    x = np.random.default_rng(0).standard_normal((2, 8, DIM)).astype(
        np.float32)
    return params, _tree(params), x


def _top2_gap(p, x) -> float:
    logits = x.reshape(-1, DIM) @ np.asarray(p["gate"]["w"]) + np.asarray(
        p["gate"]["b"])
    pr = np.asarray(jax.nn.softmax(logits, -1))
    s = np.sort(pr, -1)
    return float(np.min(np.diff(s[:, -3:], axis=-1)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _handed_probs():
    """[2 groups, 8 tokens, 4 experts]: ties (a token with two equal top
    probabilities, one with all four equal), a pad row, every token's top
    choice on expert 0 in group 1 (overflow)."""
    rng = np.random.default_rng(3)
    p = rng.random((2, 8, 4)).astype(np.float32)
    p[0, 1] = [0.3, 0.3, 0.2, 0.2]
    p[0, 2] = [0.25, 0.25, 0.25, 0.25]
    p[0, 7] = 0.0
    p[1, :, 0] = 0.9
    p[1, 5] = 0.0
    return p


@pytest.mark.parametrize("top_k,cap", [(1, 2), (2, 3), (2, 8), (4, 2)])
def test_route_group_equals_jax_bit_for_bit(top_k, cap):
    probs = _handed_probs()
    jd, jc = jax.vmap(lambda q: JMOE._route_group(q, top_k, cap))(
        jnp.asarray(probs))
    td, tc = TMOE._route_group(torch.from_numpy(probs), top_k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # pad rows route nowhere; ties go to the first maximum
    assert not td[0, 7].any() and not td[1, 5].any()
    assert td[0, 2, 0].any()
    if top_k == 1:
        assert not td[0, 2, 1:].any()


def test_moe_mlp_matches_jax(moe_setup):
    jp, tp, x = moe_setup
    assert _top2_gap(jp, x) > 1e-6
    for kw, jkw, tol in (
            (dict(compute_dtype=torch.float32),
             dict(compute_dtype=jnp.float32), 1e-5),
            ({}, {}, 1e-2),
            (dict(top_k=1, capacity_factor=1.0, compute_dtype=torch.float32),
             dict(top_k=1, capacity_factor=1.0, compute_dtype=jnp.float32),
             1e-5)):
        want, jprobs = JMOE.moe_mlp(jp, jnp.asarray(x), return_gate_probs=True,
                                    **jkw)
        got, probs = TMOE.moe_mlp(tp, torch.from_numpy(x),
                                  return_gate_probs=True, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   rtol=1e-6, atol=1e-7)


def test_moe_topk_all_equals_dense_mixture(moe_setup):
    _, p, x = moe_setup
    x = torch.from_numpy(x)
    out = TMOE.moe_mlp(p, x, capacity_factor=float(E), top_k=E,
                       compute_dtype=torch.float32)
    xf = x.reshape(-1, DIM)
    probs = torch.softmax(xf @ p["gate"]["w"] + p["gate"]["b"], -1)
    ref = sum(probs[:, e:e + 1] * (TC.gelu_tanh(xf @ p["fc_w"][e]
                                                + p["fc_b"][e])
                                   @ p["proj_w"][e] + p["proj_b"][e])
              for e in range(E))
    np.testing.assert_allclose(out.numpy(), ref.reshape(x.shape).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_moe_capacity_overflow_drops_latest(moe_setup):
    _, p, _ = moe_setup
    tok = np.random.default_rng(1).standard_normal((1, DIM)).astype(
        np.float32)
    x = torch.from_numpy(np.repeat(tok, 8, 0)[None])
    out = TMOE.moe_mlp(p, x, capacity_factor=1.0, top_k=1,
                       compute_dtype=torch.float32)[0].numpy()
    nz = np.abs(out).sum(-1) > 1e-6
    assert nz[:2].all() and not nz[2:].any(), nz


def test_moe_grouped_matches_single_group(moe_setup):
    """Groups of 4, and groups of 5 with 4 pad tokens, equal the flat
    group where every group has headroom; top_k > E is refused."""
    _, p, x = moe_setup
    x = torch.from_numpy(x)
    ref = TMOE.moe_mlp(p, x, capacity_factor=float(E), top_k=2,
                       compute_dtype=torch.float32)
    for gs in (4, 5):
        out = TMOE.moe_mlp(p, x, capacity_factor=float(E), top_k=2,
                           group_size=gs, compute_dtype=torch.float32)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="exceeds expert count"):
        TMOE.moe_mlp(p, x, top_k=E + 1)
    assert TMOE.capacity(2, 616, 8, 1.25) == 193


def test_load_balance_loss_matches_jax(moe_setup):
    jp, tp, x = moe_setup
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(float(TMOE.load_balance_loss(tp, tx)),
                               float(JMOE.load_balance_loss(jp, jx)),
                               rtol=1e-6)
    zero = {"w": torch.zeros(DIM, E), "b": torch.zeros(E)}
    assert abs(float(TMOE.load_balance_loss(dict(tp, gate=zero), tx))
               - 1.0) < 1e-5
    collapsed = {"w": torch.zeros(DIM, E),
                 "b": torch.tensor([100.0, 0, 0, 0])}
    assert float(TMOE.load_balance_loss(dict(tp, gate=collapsed), tx)) > 3.5
    out, probs = TMOE.moe_mlp(dict(tp, gate=zero), tx,
                              compute_dtype=torch.float32,
                              return_gate_probs=True)
    assert out.shape == tx.shape
    assert abs(float(TMOE.load_balance_loss(dict(tp, gate=zero), tx,
                                            gate_probs=probs)) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# the MoE captioner
# ---------------------------------------------------------------------------

def _cfgs():
    j, t = JCfg.tiny(), TCfg.tiny()
    return (dataclasses.replace(j, text=dataclasses.replace(
                j.text, moe_experts=EXPERTS)),
            dataclasses.replace(t, text=dataclasses.replace(
                t.text, moe_experts=EXPERTS)))


def _batch(seed: int, cfg, b: int = 4):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    imgs = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    toks = np.zeros((b, cfg.text.context_length), np.int32)
    for i in range(b):
        n = 5 + 3 * i
        toks[i, 0] = cfg.text.bos_id
        toks[i, 1:n] = rng.integers(3, cfg.text.vocab_size, n - 1)
        toks[i, n] = cfg.text.eos_id
    return imgs, toks


@pytest.fixture(scope="module")
def cap_ref():
    """The JAX MoE captioner's logits, loss and gradients on its default
    path (the path its train_step differentiates), and the loss and
    gradients at two points moved by 1e-4 of themselves."""
    jcfg, tcfg = _cfgs()
    params = JCap.init_captioner(jax.random.PRNGKey(0), jcfg)
    imgs, toks = _batch(0, jcfg)
    ji, jt = jnp.asarray(imgs), jnp.asarray(toks)
    with jax_train_path():
        logits = JCap.forward(params, ji, jt, jcfg)[0]
        logits_moved = [JCap.forward(perturbed(params, s), ji, jt, jcfg)[0]
                        for s in (1, 2)]
        vg = jax.jit(jax.value_and_grad(
            lambda p: JCap.caption_loss(p, ji, jt, jcfg)[0]))
        loss, grads = vg(params)
        moved = [vg(perturbed(params, s)) for s in (1, 2)]
    flat = [np32(g) for g in jax.tree_util.tree_leaves(grads)]
    spreads = [max(float(np.linalg.norm(np.asarray(m, np.float64) - w))
                   for m in ms) for w, ms in zip(flat, zip(*(
                       [np32(g) for g in jax.tree_util.tree_leaves(mv[1])]
                       for mv in moved)))]
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, imgs=imgs, toks=toks,
                logits=np32(logits), loss=float(loss),
                logits_spread=max(float(np.abs(np32(m) - np32(logits)).max())
                                  for m in logits_moved),
                loss_spread=max(abs(float(mv[0]) - float(loss))
                                for mv in moved),
                grads=flat, spreads=spreads)


def test_moe_captioner_forward_loss_and_gradients_match_jax(cap_ref):
    tp = _tree(cap_ref["params"])
    cfg = cap_ref["tcfg"]
    imgs, toks = (torch.from_numpy(cap_ref[k]) for k in ("imgs", "toks"))
    with torch.no_grad():
        logits = TCap.forward(tp, imgs, toks, cfg)[0]
    # a token whose top-2 experts are near a tie takes another expert
    # under any rounding: JAX's own logits move by as much when its
    # parameters move by 1e-4 of themselves (C.29); the other logits hold
    # the bf16 limit
    err = np.abs(np32(logits) - cap_ref["logits"])
    assert err.max() <= max(LOGIT_ATOL, 3 * cap_ref["logits_spread"]), (
        err.max(), cap_ref["logits_spread"])
    assert (err <= LOGIT_ATOL).mean() >= 0.98, (err <= LOGIT_ATOL).mean()
    loss, _, grads = value_and_grad(
        lambda p: TCap.caption_loss(p, imgs, toks, cfg), tp)
    want = cap_ref["loss"]
    assert abs(float(loss) - want) <= max(1e-3 * abs(want),
                                          3 * cap_ref["loss_spread"])
    names = leaf_names(tp)
    got = [np32(g) for g in tree_leaves(grads)]
    assert len(got) == len(cap_ref["grads"]) == len(names)
    errs = gradient_errors(got, cap_ref["grads"], cap_ref["spreads"], 5e-2,
                           3.0)
    bad = [(n, e, lim) for n, (e, lim) in zip(names, errs) if e > lim]
    assert not bad, bad
    # the routed experts and the gate get gradients (through the combine
    # weights)
    for n, g in zip(names, got):
        if ".moe." in n:
            assert np.any(g) and np.all(np.isfinite(g)), n


# crops seeds 0-11 of 6 rows: rows parted on seeds 1, 3, 5, 7, 8, 9 (1-6
# rows), none on 0, 2, 4, 6, 10, 11
GENERATE_SEED = 0


def test_moe_captioner_greedy_generate_matches_jax(cap_ref):
    """Greedy decoding on the kernel route (decode blocks) against the
    JAX package's on its block-kernel path, on crops where no row parts
    (C.8)."""
    jcfg, tcfg = cap_ref["jcfg"], cap_ref["tcfg"]
    imgs, _ = _batch(GENERATE_SEED, jcfg, b=6)
    with jax_kernel_path(blocks=True):
        jt, jlp, jlen = JCap.generate(cap_ref["params"], jnp.asarray(imgs),
                                      jax.random.PRNGKey(0), jcfg)
    tt, tlp, tlen = TCap.generate(_tree(cap_ref["params"]),
                                  torch.from_numpy(imgs), tcfg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert (np.asarray(jlen) > 2).sum() >= 3
    np.testing.assert_allclose(tlp.numpy(), np32(jlp), atol=5e-2, rtol=0)


def test_moe_text_block_decode_route(monkeypatch):
    """A MoE text block in a one-token decode step takes the fused self
    block (its attention sublayer) and never the decode-MLP kernel, and
    equals the route of separate calls within bf16 logit noise."""
    _, tcfg = _cfgs()
    p = TCap.init_captioner(torch.Generator().manual_seed(0), tcfg, "cpu")
    blk = p["text_blocks"][0]
    calls = []
    for name in ("decode_self_block", "decode_mlp"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    t = tcfg.text
    cache = TC.KVCache.create(3, 8, t.heads, t.width // t.heads, "cpu")
    x = torch.randn(3, 1, t.width, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    out, _ = TC.block(blk, x, t.heads, cache=cache)
    assert calls == ["decode_self_block"]
    cache = TC.KVCache.create(3, 8, t.heads, t.width // t.heads, "cpu")
    ref, _ = TC.block(blk, x, t.heads, cache=cache, decode_blocks=False)
    assert calls == ["decode_self_block"]
    np.testing.assert_allclose(np32(out), np32(ref), atol=LOGIT_ATOL, rtol=0)
    # a dense block on the same path takes the decode-MLP kernel
    dense = TCap.init_captioner(torch.Generator().manual_seed(0),
                                TCfg.tiny(), "cpu")["text_blocks"][0]
    cache = TC.KVCache.create(3, 8, t.heads, t.width // t.heads, "cpu")
    TC.block(dense, x, t.heads, cache=cache)
    assert calls[-2:] == ["decode_self_block", "decode_mlp"]


def test_moe_params_from_jax_and_quantized():
    """`from_jax` carries the stacked expert leaves; `quantize_params`
    leaves fc_w / proj_w float and the gate float below MIN_QUANT_SIZE, as
    the JAX package's name == "w" rule does."""
    jcfg, _ = _cfgs()
    jp = JCap.init_captioner(jax.random.PRNGKey(0), jcfg)
    tp = _tree(jp)
    moe = tp["text_blocks"][0]["moe"]
    assert moe["fc_w"].shape == (EXPERTS, 64, 256)
    np.testing.assert_array_equal(
        moe["proj_b"].numpy(), np.asarray(jp["text_blocks"][0]["moe"][
            "proj_b"]))
    q = quantize_params(tp)["text_blocks"][0]["moe"]
    assert all(isinstance(q[k], torch.Tensor)
               for k in ("fc_w", "fc_b", "proj_w", "proj_b"))
    assert isinstance(q["gate"]["w"], torch.Tensor)  # 64 x 4 < 16384
    wide = quantize_params({"gate": {"w": torch.randn(768, 22),
                                     "b": torch.zeros(22)}})
    assert isinstance(wide["gate"]["w"], QuantizedArray)


def test_moe_captioner_trains_and_generates():
    """The mirror of JAX `test_moe_captioner_trains_and_generates`: a tiny
    captioner with MoE text blocks (2 experts) forwards, lowers its caption
    loss over a few steps, and generates with the KV-cached decode loop."""
    tiny = TCfg.tiny()
    cfg = dataclasses.replace(
        tiny, text=dataclasses.replace(tiny.text, moe_experts=2))
    params = TCap.init_captioner(torch.Generator().manual_seed(0), cfg, "cpu")
    for blk in params["text_blocks"]:
        assert "moe" in blk and "mlp" not in blk
        assert blk["moe"]["fc_w"].shape[0] == 2
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy((rng.random((4, 64, 64, 3)) * 255).astype(
        np.uint8))
    toks = torch.from_numpy(rng.integers(3, 1000, (4, 12)).astype(np.int32))
    state = TT.create_train_state(params)
    l0 = float(TCap.caption_loss(state.params, imgs, toks, cfg)[0])
    for _ in range(8):
        state, aux = TT.train_step(state, imgs, toks,
                                   torch.zeros(4, dtype=torch.int32),
                                   torch.ones(4, dtype=torch.bool), cfg,
                                   lr=3e-3)
    l1 = float(TCap.caption_loss(state.params, imgs, toks, cfg)[0])
    assert l1 < l0, (l0, l1)
    out, _, lengths = TCap.generate(state.params, imgs[:2], cfg)
    assert out.shape == (2, cfg.max_caption_len)
    assert int(lengths.max()) >= 1
