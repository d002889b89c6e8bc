"""The port's tensor-parallel captioner (`forward` and `train_step` with a
("data", "model") mesh over `shard_params`'s blocks) on gloo process groups,
against the JAX package's single-device calls at `tests/test_tp.py`'s
base-class widths (768-wide vision, 512-wide text, the full 49,408-token
vocabulary), and against the port's own one-rank calls.

One spawn per world size (`torch_dist.tp`) runs that size's cases; the
JAX references and the port's one-rank train step are computed here.
Limits and their reasons:
- TP=2 forward against JAX `forward`: `test_tp.py`'s own (embeddings
  within rtol = atol = 2e-2, logits correlation > 0.999, argmax agreement
  > 0.99 on the confident half of the rows);
- TP=2 forward against the port's one-rank forward: the same products
  split in two float32 partial sums before each bf16 rounding; measured on
  this file's inputs: logits within 0.03125 (one bf16 ulp at |x| < 8),
  the image embedding within 7.1e-4, the text embedding equal, logits
  correlation 0.999993; held to two ulps, 2e-3 and 0.9999 (TP_LOGITS_ATOL,
  TP_EMB_ATOL, TP_CORR);
- DP4 x TP2 train step: the loss within 2e-2 relative of JAX
  `train_step`'s (its test's limit) and within 1e-4 relative of the port's
  one-rank step (the one-rank step's own loss moves by 4.7e-5 of itself
  between 1 and 8 torch threads: bf16 roundings after float32 sums in
  another order); the updated blocks, reassembled, against the port's
  one-rank step by `update_gaps`: of the elements either run moved, the
  share moved alike at least 0.98 (measured 0.9900-0.9913 on 1-8 threads:
  the leaves whose gradient is rounding noise move either way, the
  attention k biases, whose gradient is 0 in exact arithmetic, and the
  cross-attention q / k over the near-equal pooled tokens of random
  weights; a step that skips the sum over "data" reads 0.783, one that
  counts the contrastive and triplet terms on every data rank 0.942, in a
  mutated copy), the decay estimate within 2e-3 of 0
  (`test_torch_pipelines.py`'s limit; the step without the data sum reads
  -0.011); a global norm without the sum over "model" leaves the ranks'
  whole leaves unequal, which `_reassemble` refuses;
- the world-size-1 mesh: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from embodied_captioning_tpu.config import CaptionerConfig as JCapCfg
from embodied_captioning_tpu.config import TextDecoderConfig as JTextCfg
from embodied_captioning_tpu.config import VitConfig as JVitCfg
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models.quantize import (
    quantize_params as jquantize,
)
from embodied_captioning_tpu.train import captioner_train as JTT
from embodied_captioning_tpu_torch.config import TextDecoderConfig, VitConfig
from embodied_captioning_tpu_torch.models import captioner as CAP
from embodied_captioning_tpu_torch.parallel.mesh import (
    partition_spec_for, shard_params,
)
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.train import captioner_train as TT
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, update_gaps,
)
from test_tp import BASE_TP_CFG
from torch_dist import _cap_cfg, run
from torch_parity import jax_train_path, leaf_names, np32

LR = 1e-4
TRIPLET = 0.1
TP_LOGITS_ATOL = 0.0625
TP_EMB_ATOL = 2e-3
TP_CORR = 0.9999
LOSS_RTOL_JAX = 2e-2
LOSS_RTOL_PORT = 1e-4
AGREE, DECAY_ATOL = 0.98, 2e-3
# tiny configurations for the unit cases (JAX `init_captioner` weights)
TINY = dict(
    vision=dict(image_size=32, patch_size=8, width=64, layers=1, heads=2,
                pool_queries=4, pool_heads=2, embed_dim=32),
    text=dict(context_length=16, vocab_size=1023, width=64, heads=2,
              layers=1, cross_layers=1),
    max_caption_len=8)


def _cfg_dict(jcfg) -> dict:
    """The port's configuration fields of a JAX `CaptionerConfig`."""
    return dict(
        vision={f.name: getattr(jcfg.vision, f.name)
                for f in dataclasses.fields(VitConfig)},
        text={f.name: getattr(jcfg.text, f.name)
              for f in dataclasses.fields(TextDecoderConfig)},
        max_caption_len=jcfg.max_caption_len)


def _jcfg(d: dict):
    return JCapCfg(vision=JVitCfg(**d["vision"]),
                   text=JTextCfg(**d["text"]),
                   max_caption_len=d["max_caption_len"])


def _np_params(jcfg, seed: int = 0):
    return jax.tree_util.tree_map(
        np.asarray, JCAP.init_captioner(jax.random.PRNGKey(seed), jcfg))


def _batch(n: int, size: int, seed: int = 0, pads: bool = False):
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, size, size, 3)) * 255).astype(np.uint8)
    toks = rng.integers(3, 1000, (n, 12)).astype(np.int32)
    if pads:
        toks[1, 7:] = 0
    return imgs, toks


@pytest.fixture(scope="module")
def ref():
    """`test_tp.py`'s inputs and the JAX package's single-device forward
    and train step on them."""
    cfg = BASE_TP_CFG
    params = _np_params(cfg)
    imgs, toks = _batch(4, 56)
    obj = np.asarray([0, 0, 1, 1], np.int32)
    valid = np.ones(4, bool)
    with jax_train_path():
        logits, img, txt = JCAP.forward(params, jnp.asarray(imgs),
                                        jnp.asarray(toks), cfg)
        state = JTT.create_train_state(
            jax.tree_util.tree_map(jnp.array, params))
        _, aux = JTT.train_step(state, jnp.asarray(imgs), jnp.asarray(toks),
                                jnp.asarray(obj), jnp.asarray(valid), cfg,
                                lr=LR, triplet_weight=TRIPLET)
    return dict(cfg=_cfg_dict(cfg), params=params, imgs=imgs, toks=toks,
                obj=obj, valid=valid, logits=np32(logits), img=np32(img),
                txt=np32(txt), loss=float(aux["loss"]))


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    tiny = _np_params(_jcfg(TINY), 1)
    moe = dict(TINY, text=dict(TINY["text"], vocab_size=1024,
                               moe_experts=4))
    rng = np.random.default_rng(2)
    ce_toks = rng.integers(0, 10, (3, 7)).astype(np.int32)
    ce_toks[:, 1:4] = [[1, 8, 4], [6, 0, 9], [5, 2, 0]]  # both halves, pads
    timgs, ttoks = _batch(2, 32, 3, pads=True)
    cases = {
        "base": dict(kind="forward", cfg=ref["cfg"], params=ref["params"],
                     imgs=ref["imgs"], toks=ref["toks"], mesh=(1, 2)),
        "odd": dict(kind="forward", cfg=TINY, params=tiny, imgs=timgs,
                    toks=ttoks, mesh=(1, 2)),
        "moe": dict(kind="forward", cfg=moe, params=_np_params(_jcfg(moe), 2),
                    imgs=timgs, toks=ttoks, mesh=(1, 2)),
        "units": dict(
            kind="units",
            logits=rng.standard_normal((3, 7, 10)).astype(np.float32) * 3,
            ce_toks=ce_toks, block=tiny["text_blocks"][0],
            norm_tree={"head": rng.standard_normal((4, 6)).astype("f"),
                       "ln": rng.standard_normal((5,)).astype("f"),
                       "fc": rng.standard_normal((3, 8)).astype("f")}),
    }
    return run("tp", 2, tmp_path_factory.mktemp("tp2"), cases)


@pytest.fixture(scope="module")
def world8(ref, tmp_path_factory):
    case = dict(kind="train", cfg=ref["cfg"], params=ref["params"],
                mesh=(4, 2), lr=LR, triplet=TRIPLET,
                **{k: ref[k] for k in ("imgs", "toks", "obj", "valid")})
    return run("tp", 8, tmp_path_factory.mktemp("tp8"), {"train": case})


@pytest.fixture(scope="module")
def one_rank_step(ref):
    """The port's mesh-less train step on the whole batch."""
    params = from_jax(ref["params"], "cpu")
    state, aux = TT.train_step(
        TT.create_train_state(params),
        *(from_jax(ref[k], "cpu") for k in ("imgs", "toks", "obj", "valid")),
        _cap_cfg(ref["cfg"]), lr=LR, triplet_weight=TRIPLET)
    return dict(before=[np32(t) for t in tree_leaves(params)],
                after=[np32(t) for t in tree_leaves(state.params)],
                aux={k: float(v) for k, v in aux.items()})


def _corr(a, b) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def test_tp2_forward_matches_jax(ref, world2):
    """`test_tp.py`'s TP=2 forward, its limits."""
    logits, img, txt = world2[0]["base"]["got"]
    np.testing.assert_allclose(txt, ref["txt"], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(img, ref["img"], rtol=2e-2, atol=2e-2)
    b = ref["logits"]
    assert logits.shape == b.shape == (4, 12, 49408)
    assert _corr(logits, b) > 0.999
    top2 = np.sort(b, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    confident = margin > np.median(margin)
    agree = (logits.argmax(-1) == b.argmax(-1))[confident].mean()
    assert agree > 0.99, agree


def test_tp2_forward_matches_one_rank(world2):
    got, want = world2[0]["base"]["got"], world2[0]["base"]["want"]
    assert np.abs(got[0] - want[0]).max() <= TP_LOGITS_ATOL
    assert _corr(got[0], want[0]) > TP_CORR
    for a, b in zip(got[1:], want[1:]):
        assert np.abs(a - b).max() <= TP_EMB_ATOL
    # every rank gathered the same whole vocabulary, without a host copy
    # (CPU tensors)
    for a, b in zip(world2[1]["base"]["got"], got):
        np.testing.assert_array_equal(a, b)
    assert all(r["base"]["host_copies"] == {} for r in world2)


def test_tp2_leaves_cut(ref, world2):
    """At least 30 leaves cut (`test_tp.py`'s `_count_model_sharded`),
    each rank's leaves the blocks `shard_params` gives, and each cut
    leaf half its whole width on its TP dim."""
    names = leaf_names(ref["params"])
    whole = [np.shape(a) for a in tree_leaves(from_jax(ref["params"],
                                                       "cpu"))]
    for r in world2:
        cut, shapes = r["base"]["cut"], r["base"]["shapes"]
        assert sum(cut) >= 30, sum(cut)
        assert len(shapes) == len(whole) == len(names)
        for name, c, s, w in zip(names, cut, shapes, whole):
            halved = [i for i in range(len(w)) if s[i] != w[i]]
            assert halved == ([] if not c else halved[:1]), name
            if c:
                assert s[halved[0]] * 2 == w[halved[0]], name
    assert sum(world2[0]["base"]["cut"]) == 83


def test_dp4_tp2_loss_matches_jax(ref, world8, one_rank_step):
    """The DP4 x TP2 loss against JAX `train_step`'s single-device loss
    (triplet weight 0.1, `test_tp.py`'s limit) and the port's one-rank
    step's; every rank reports the global batch's loss and parts."""
    losses = [r["train"]["aux"]["loss"] for r in world8]
    assert len(set(losses)) == 1
    assert np.isfinite(losses[0])
    assert abs(losses[0] - ref["loss"]) / abs(ref["loss"]) < LOSS_RTOL_JAX
    for k, v in one_rank_step["aux"].items():
        got = world8[0]["train"]["aux"][k]
        assert abs(got - v) <= LOSS_RTOL_PORT * abs(v), (k, got, v)


def _reassemble(ref, ranks) -> list:
    """The first data rank's updated blocks of the two model ranks as
    whole leaves."""
    names = leaf_names(ref["params"])
    out = []
    for i, name in enumerate(names):
        a, b = ranks[0]["leaves"][i], ranks[1]["leaves"][i]
        if not ranks[0]["cut"][i]:
            np.testing.assert_array_equal(a, b)
            out.append(a)
            continue
        spec = partition_spec_for(name.replace(".", "/"), a, True)
        out.append(np.concatenate([a, b], axis=spec.index("model")))
    return out


def test_dp4_tp2_update_matches_one_rank(ref, world8, one_rank_step):
    """The updated blocks, reassembled, against the port's one-rank step
    (`update_gaps`); the data ranks hold equal blocks."""
    ranks = [r["train"] for r in world8]
    for d in range(4):
        for m in range(2):
            assert ranks[2 * d + m]["sums"] == ranks[m]["sums"]
    got = _reassemble(ref, ranks[:2])
    gaps = update_gaps(one_rank_step["before"], got, one_rank_step["after"],
                       LR)
    assert gaps["agree"] >= AGREE, gaps
    assert abs(gaps["decay"]) <= DECAY_ATOL, gaps


def test_dp4_tp2_leaves_local_and_finite(ref, world8):
    """The state's leaves stay the local blocks `shard_params` gives, and
    finite; `head/w` finite (`test_tp.py`)."""
    params = from_jax(ref["params"], "cpu")
    names = leaf_names(ref["params"])
    head = names.index("head.w")

    class Mesh:  # the (data, model) coordinates of a rank
        mesh_dim_names = ("data", "model")

        def __init__(self, rank):
            self.rank = rank

        def size(self, i):
            return (4, 2)[i]

        def get_local_rank(self, axis):
            return self.rank // 2 if axis == "data" else self.rank % 2

    for rank, r in enumerate(world8):
        t = r["train"]
        want = [tuple(x.shape) for x in tree_leaves(
            shard_params(params, Mesh(rank)))]
        assert t["shapes"] == want
        assert t["finite"] and t["step"] == 1 and t["count"] == 1
        if "leaves" in t:
            assert np.isfinite(t["leaves"][head]).all()
            assert t["leaves"][head].shape == (512, 24704)


@pytest.mark.parametrize("case", ["odd", "moe"])
def test_tp2_tiny_forward_matches_one_rank(world2, case):
    """An odd vocabulary keeps `head` whole on both ranks (replicated, the
    rest tensor-parallel); the MoE captioner runs its experts replicated
    after tensor-parallel attention. Both against the one-rank forward
    within the base case's limits."""
    for r in world2:
        got, want = r[case]["got"], r[case]["want"]
        assert np.abs(got[0] - want[0]).max() <= TP_LOGITS_ATOL
        assert _corr(got[0], want[0]) > TP_CORR
        for a, b in zip(got[1:], want[1:]):
            assert np.abs(a - b).max() <= TP_EMB_ATOL
        if case == "odd":
            names = leaf_names(_np_params(_jcfg(TINY), 1))
            cut = dict(zip(names, r[case]["cut"]))
            assert not cut["head.w"] and not cut["head.b"]
            assert cut["text_blocks[0].mlp.fc.w"]
            assert r[case]["shapes"][names.index("head.w")] == (64, 1023)
        else:
            assert sum(r[case]["cut"]) > 0


def test_vocab_parallel_cross_entropy(world2):
    """Targets in each rank's half and pads: the vocabulary-parallel NLL
    and its gradient against the full softmax's."""
    for r in world2:
        ce = r["units"]["ce"]
        np.testing.assert_array_equal(ce["mask"][:, 0:3] == 0,
                                      [[False] * 3, [False, True, False],
                                       [False, False, True]])
        np.testing.assert_allclose(ce["nll"], ce["full"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ce["grad"], ce["full_grad"], rtol=1e-5,
                                   atol=1e-7)


def test_sharded_global_norm(world2):
    """The clip of a tree with two cut leaves and a whole one: each rank's
    clipped blocks equal the whole tree's clipped blocks."""
    for r in world2:
        got, want = r["units"]["norm"]["got"], r["units"]["norm"]["want"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_gather_batch_and_max(world2):
    """The data axis's differentiable gather: every block in rank order;
    each rank's gradient is its rows of the cotangent summed over the
    ranks (here weights 1-4 on each rank); the max all-reduce."""
    for rank, r in enumerate(world2):
        g = r["units"]["gather"]
        np.testing.assert_array_equal(g["y"], [[1] * 3] * 2 + [[2] * 3] * 2)
        np.testing.assert_array_equal(
            g["grad"], 2 * np.arange(1.0 + 2 * rank, 3.0 + 2 * rank
                                     )[:, None].repeat(3, 1))
        np.testing.assert_array_equal(r["units"]["max"], [1, 0, 3])


def test_decode_refused_under_tp(world2):
    """Cached decoding (the decode kernels' route) under a TP context
    raises rather than run on partial widths."""
    for r in world2:
        msgs = r["units"]["refusals"]
        assert len(msgs) == 2
        assert all(m and "tensor parallelism" in m for m in msgs), msgs


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    imgs, toks = _batch(4, 32, 4, pads=True)
    case = dict(kind="world_one", cfg=TINY, params=_np_params(_jcfg(TINY), 3),
                imgs=imgs, toks=toks, obj=np.asarray([0, 0, 1, 1], np.int32),
                valid=np.asarray([True, True, True, False]), lr=LR,
                triplet=TRIPLET)
    return run("tp", 1, tmp_path_factory.mktemp("tp1"), {"one": case})[0]


@pytest.mark.parametrize("what", ["forward", "aux", "params", "moments"])
def test_world_one_mesh_bit_for_bit(world1, what):
    """A (1, 1) mesh: `forward` and `train_step` equal the mesh-less
    calls bit for bit."""
    assert world1["one"][what] is True


def test_meshless_forward_on_int8_leaves_matches_jax():
    """Without a mesh `forward` reads no leaf's shape for tensor
    parallelism: on the int8 serving tree (`QuantizedArray` leaves, as
    `pseudocaptioner._clip_consensus` hands it) it runs, and agrees with
    the JAX package's `forward` on its own int8 tree at `test_tp.py`'s
    limits."""
    jcfg = _jcfg(TINY)
    q = jquantize(JCAP.init_captioner(jax.random.PRNGKey(4), jcfg))
    imgs, toks = _batch(2, 32, 5, pads=True)
    with jax_train_path():
        want = [np32(x) for x in JCAP.forward(q, jnp.asarray(imgs),
                                              jnp.asarray(toks), jcfg)]
    got = [np32(x) for x in CAP.forward(from_jax(q, "cpu"),
                                        from_jax(imgs, "cpu"),
                                        from_jax(toks, "cpu"),
                                        _cap_cfg(TINY))]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)
    assert _corr(got[0], want[0]) > 0.999
