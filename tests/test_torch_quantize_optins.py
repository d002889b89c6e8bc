"""The quantized serving opt-ins against the JAX package, tiny preset, on
the CPU: `dense_w8a8` bit for bit, `quantization_ratio`, the decode route
under `w8a8` (the JAX package's `_decode_fusion_ok`) on float leaves, the
refusal under tensor parallelism, and `perceive` on an int8 serving tree
with `w8a8` on and off and `int8_kv` on and off, against the JAX package
run under `quantize._W8A8` / ECAP_INT8_KV with its kernels (interpret
mode) on the same handed frames.

The JAX package reads `_W8A8` when it traces and `jax.jit` keeps traces,
so every JAX call under a mode here clears the jit caches first
(`_jax_modes`)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu import perception as JP
from embodied_captioning_tpu.config import ExperimentConfig as JCfg
from embodied_captioning_tpu.config import merge as jmerge
from embodied_captioning_tpu.models import common as JC
from embodied_captioning_tpu.models import quantize as JQ
from embodied_captioning_tpu_torch import perception as TP
from embodied_captioning_tpu_torch.config import ExperimentConfig as TCfg
from embodied_captioning_tpu_torch.config import merge as tmerge
from embodied_captioning_tpu_torch.models import common as TC
from embodied_captioning_tpu_torch.models import quantize as TQ
from embodied_captioning_tpu_torch.params import from_jax
from torch_parity import jax_kernel_path, np32, t


@contextlib.contextmanager
def _jax_modes(w8a8: bool, int8_kv: bool):
    """The JAX package's kernel path (whole-block decode kernels) under
    `_W8A8 = w8a8` and ECAP_INT8_KV, traced afresh."""
    with jax_kernel_path(blocks=True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQ, "_W8A8", w8a8)
        mp.setenv("ECAP_INT8_KV", "1" if int8_kv else "0")
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


# ---------------------------------------------------------------------------
# dense_w8a8 and quantization_ratio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [((4, 17, 256), 128), ((5, 90), 37),
                                   ((1, 64), 1024), ((64, 768), 3072)])
def test_dense_w8a8_matches_jax_bit_for_bit(shape, dtype):
    """The jitted JAX function (XLA's reciprocal product for `/ 127.0`);
    K and N that are not multiples of 8 take the zero-padded product."""
    (xs, n) = shape
    rng = np.random.default_rng(len(xs) + n)
    x = (rng.standard_normal(xs) * rng.uniform(0.1, 3, xs[:-1] + (1,))
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jw = JQ.quantize_array(jnp.asarray(
        rng.standard_normal((xs[-1], n)).astype(np.float32) * 0.05))
    want = np.asarray(jax.jit(JQ.dense_w8a8)(jx, jw))
    got = TQ.dense_w8a8(t(jx), from_jax({"w": jw}, "cpu")["w"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_under_w8a8_adds_the_bias_and_casts_as_jax():
    rng = np.random.default_rng(7)
    p = {"w": JQ.quantize_array(jnp.asarray(
            rng.standard_normal((96, 64)).astype(np.float32))),
         "b": jnp.asarray(rng.standard_normal(64).astype(np.float32))}
    x = jnp.asarray(rng.standard_normal((3, 5, 96)), jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JQ, "_W8A8", True)
        jax.clear_caches()
        want = np.asarray(jax.jit(JC.dense)(p, x).astype(jnp.float32))
    jax.clear_caches()
    tp = from_jax(p, "cpu")
    got = TC.dense(tp, t(x), w8a8=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(got), want)
    # float weights multiply as they do without it
    fp = {"w": torch.randn(96, 64), "b": torch.randn(64)}
    assert torch.equal(TC.dense(fp, t(x), w8a8=True), TC.dense(fp, t(x)))


def _trees():
    jc = JCfg.preset_config("tiny")
    params = JP.init_perception(jax.random.PRNGKey(0), jc)
    return {
        "float": params,
        "int8": JQ.quantize_params(params, min_size=64),
        "default": JQ.quantize_params(params),
        "mixed": params._replace(captioner=JQ.quantize_params(
            params.captioner, min_size=64)),
    }


@pytest.mark.parametrize("kind", ["float", "int8", "default", "mixed"])
def test_quantization_ratio_matches_jax(kind):
    tree = _trees()[kind]
    want = JQ.quantization_ratio(tree)
    got = TQ.quantization_ratio(from_jax(tree, "cpu"))
    assert got == want
    assert (got == 0.0) == (kind == "float")


# ---------------------------------------------------------------------------
# the decode route under w8a8, and the refusal under tensor parallelism
# ---------------------------------------------------------------------------

def test_w8a8_turns_the_fused_decode_kernels_off():
    for rows, d, heads, f in ((1, 64, 2, 256), (64, 768, 12, 3072)):
        assert TC.decode_route(rows, d, heads, f, 77, True, w8a8=True) == (
            TC.DecodeRoute(False, False, False))
        assert TC.decode_route(rows, d, heads, f, 77, True) == (
            TC.DecodeRoute(True, True, True))


@pytest.mark.parametrize("int8", [False, True])
def test_block_under_w8a8_matches_jax(int8, monkeypatch):
    """One cached decode step of a multimodal block under W8A8, on float
    and on int8 leaves: the standalone decode attention kernels and no
    fused sublayer (the JAX package's `_decode_fusion_ok` with its kernel
    path on); the step's output within bf16 rounding of the JAX block's,
    and the cache written alike."""
    d, heads, tk = 64, 2, 12
    key = jax.random.split(jax.random.PRNGKey(int8), 4)
    jp = JC.block_init(key[0], d, heads, cross_dim=d)
    if int8:
        jp = JQ.quantize_params(jp, min_size=0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((3, 1, d)), jnp.bfloat16)
    img = jnp.asarray(rng.standard_normal((3, tk, d)), jnp.bfloat16)
    cache = JC.KVCache(
        jnp.asarray(rng.standard_normal((3, heads, d // heads, 8)),
                    jnp.bfloat16),
        jnp.asarray(rng.standard_normal((3, 8, heads, d // heads)),
                    jnp.bfloat16), jnp.int32(2))
    with _jax_modes(True, True):
        ckv = JC.precompute_kv(jp["xattn"], img, heads)
        want, wc = jax.jit(lambda p, x, c, k: JC.block(
            p, x, heads, cache=c, cross_kv=k))(jp, x, cache, ckv)
        want, wc = np32(want), jax.tree_util.tree_map(np32, wc)
    tp = from_jax(jp, "cpu")
    called = []
    for name in ("decode_self_block", "decode_cross_block", "decode_mlp",
                 "decode_self_attention", "decode_cross_attention"):
        fn = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    tckv = TC.precompute_kv(tp["xattn"], t(img), heads, w8a8=True)
    assert isinstance(tckv, TQ.QuantizedKV) == bool(int8)
    tcache = TC.KVCache(t(cache.k).clone(), t(cache.v).clone(), 2)
    got, gc = TC.block(tp, t(x), heads, cache=tcache, cross_kv=tckv,
                       w8a8=True)
    assert called == ["decode_self_attention", "decode_cross_attention"]
    np.testing.assert_allclose(np32(got), want, atol=6e-2, rtol=2e-2)
    np.testing.assert_allclose(np32(gc.k), wc.k, atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(np32(gc.v), wc.v, atol=3e-2, rtol=1e-2)


def test_w8a8_is_refused_under_tensor_parallelism():
    g = torch.Generator().manual_seed(0)
    p = TQ.quantize_params(TC.block_init(g, 64, 4.0, "cpu"), min_size=0)
    x = torch.randn(2, 3, 64).bfloat16()
    group = object()  # never reached: the refusal comes first
    for call in (lambda: TC.dense(p["mlp"]["proj"], x.repeat(1, 1, 4),
                                  group=group, w8a8=True),
                 lambda: TC.mlp(p["mlp"], x, group=group, w8a8=True),
                 lambda: TC.mha(p["attn"], x, 2, group=group, w8a8=True),
                 lambda: TC.block(p, x, 2, tp=TC.TP(group, 256),
                                  w8a8=True)):
        with pytest.raises(ValueError, match="w8a8 under tensor parallel"):
            call()


# ---------------------------------------------------------------------------
# perceive on an int8 serving tree
# ---------------------------------------------------------------------------

# (w8a8, int8_kv, frames seed). The random-weight tiny captioner's greedy
# decode flips at near-ties (ROADMAP C.12): with w8a8 and int8 K/V on
# frames seed 0, slot 0's tenth token is a tie of two tokens 2.2e-3 apart
# in log-prob, taken one way by each package. Seeds 1-3 flip one mode or
# another as well; seed 1 also swaps two near-equal-score detections. The
# seeds are those of a scan where every token of the mode agrees.
MODES = [(True, True, 2), (False, False, 0), (True, False, 0)]


@pytest.fixture(scope="module", params=MODES,
                ids=lambda m: f"w8a8{int(m[0])}-int8kv{int(m[1])}")
def perceive_pair(request):
    w8a8, int8_kv, seed = request.param
    over = {"detector": {"score_threshold": 0.0}}
    jc = jmerge(JCfg.preset_config("tiny"), over)
    tc = tmerge(TCfg.preset_config("tiny"), over)
    params = JQ.quantize_params(JP.init_perception(jax.random.PRNGKey(0), jc),
                                min_size=64)
    frames = (np.random.default_rng(seed).random((3, 96, 96, 3)) * 255
              ).astype(np.uint8)
    with _jax_modes(w8a8, int8_kv):
        ref = JP.perceive(params, jnp.asarray(frames), jax.random.PRNGKey(1),
                          jc)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    tparams = from_jax(params, "cpu")
    out = TP.perceive(tparams, torch.from_numpy(frames), tc, w8a8=w8a8,
                      int8_kv=int8_kv)
    return ref, out, tparams, tc, frames, w8a8, int8_kv


def test_perceive_optins_match_jax(perceive_pair):
    """Detections (valid, classes exactly; bf16 boxes to 1 px, scores to
    2e-2), caption tokens and lengths exactly, the sentence embeddings to
    a cosine of 0.999 a live slot. The boxes' limit is four bf16 ulps at
    32-64 px: on this int8 tree the backbone's convolutions dequantize
    their int8 weights in bf16 and sum in another order than XLA's, and
    the refinement pass scales a delta's last bit by the box size (1.0 px
    on one box of seed 0 with w8a8 off, as on)."""
    ref, out, *_ = perceive_pair
    jd, td = ref.detections, out.detections
    np.testing.assert_array_equal(np32(td.valid), np32(jd.valid))
    assert np32(jd.valid).sum() >= 3
    np.testing.assert_array_equal(np32(td.classes), np32(jd.classes))
    np.testing.assert_allclose(np32(td.boxes), np32(jd.boxes), atol=1.0,
                               rtol=0)
    np.testing.assert_allclose(np32(td.scores), np32(jd.scores), atol=2e-2,
                               rtol=0)
    np.testing.assert_array_equal(np32(out.caption_tokens),
                                  np32(ref.caption_tokens))
    np.testing.assert_array_equal(np32(out.caption_lengths),
                                  np32(ref.caption_lengths))
    assert (np32(ref.caption_lengths) > 1).sum() >= 3
    je = np32(jd.embeddings).reshape(-1, 384)
    te = np32(td.embeddings).reshape(-1, 384)
    live = np.linalg.norm(je, axis=1) > 0
    np.testing.assert_array_equal(np.linalg.norm(te, axis=1) > 0, live)
    cos = np.sum(je[live] * te[live], 1) / (
        np.linalg.norm(je[live], axis=1) * np.linalg.norm(te[live], axis=1))
    assert cos.min() > 0.999, cos


def test_perceiver_and_sharded_forward_the_optins(perceive_pair):
    _, out, tparams, tc, frames, w8a8, int8_kv = perceive_pair
    res = TP.Perceiver(tc, params=tparams, device="cpu", w8a8=w8a8,
                       int8_kv=int8_kv).process(frames)
    assert torch.equal(res.caption_tokens, out.caption_tokens)
    sharded = TP.perceive_sharded(tparams, torch.from_numpy(frames), tc,
                                  None, w8a8=w8a8, int8_kv=int8_kv)
    assert torch.equal(sharded.caption_tokens, out.caption_tokens)


def test_entry_points_take_the_optin_flags(monkeypatch, tmp_path):
    """`run_exp`, `replay_exp` and `run_pseudolabeler` take `--w8a8` and
    `--no-int8-kv` (for ECAP_W8A8 / ECAP_INT8_KV) to the perceiver they
    make, and `run_exp --render-mode` to the envs."""
    from embodied_captioning_tpu_torch import perception as P
    from embodied_captioning_tpu_torch import replay_exp, run_exp
    from embodied_captioning_tpu_torch import run_pseudolabeler

    made = []
    real = P.Perceiver

    def spy(*a, **kw):
        made.append((kw.get("w8a8", False), kw.get("int8_kv", True)))
        return real(*a, **kw)

    monkeypatch.setattr(P, "Perceiver", spy)
    import embodied_captioning_tpu_torch.agents.baselines as B

    monkeypatch.setattr(B, "Perceiver", spy)
    small = ["runtime.num_envs=2", "sensors.height=32", "sensors.width=32",
             "sim.num_objects=4", "sim.scene_size=8.0"]
    store = str(tmp_path / "obs")
    assert run_exp.main(["--trainer", "randombaseline", "--steps", "1",
                         "--device", "cpu", "--obs-dir", store, "--w8a8",
                         "--no-int8-kv", "--render-mode", "onehot16"]
                        + small) == 0
    assert made[-1] == (True, False)
    assert replay_exp.main([store, "--perceive", "--batch", "2",
                            "--device", "cpu", "--w8a8"] + small) == 0
    assert made[-1] == (True, True)
    assert run_pseudolabeler.main([store, "--out", str(tmp_path / "pl"),
                                   "--consensus", "vanilla", "--device",
                                   "cpu", "--no-int8-kv"] + small) == 0
    assert made[-1] == (False, False)
