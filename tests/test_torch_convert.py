"""The port's checkpoint converters (`tools/convert_weights.py`), CoCa
replica (`tools/torch_replica.py`) and `tools/port.py` against the JAX
package's, on the same torch state dicts: the tiny CoCa of
`tests/test_convert.py`, a mixed-width CoCa (vision 48 wide, text 32, the
real checkpoint's shape family) and one at ViT-L/14 widths (vision 1024 x
4 layers at 224^2 and patch 14, text 768), and tiny HF BertModels.

Limits:
- every converter's tree equals the JAX converter's leaf for leaf, bit
  for bit (the same numpy arrays out of the same tensors);
- the port's `captioner.forward` on the converted tree against the JAX
  package's `forward` on the same tree (its default path, as
  `tests/test_convert.py` runs it): `tests/test_tp.py`'s forward limits,
  logits correlation > 0.999 and the embeddings within rtol = atol =
  2e-2, and the log-softmax within 5e-2 (`test_torch_generate.py`'s
  chosen log-prob limit);
- the port's forward against the replica's float32 logits teacher-forced
  (`coca_parity_report`): correlation > 0.999, the bar
  `port_checkpoint` sets;
- greedy `generate` on the converted CoCa equals the JAX package's on the
  block route (Pallas in interpret mode) token for token on images where
  no row parts (ROADMAP C.8: greedy decoding of random weights is
  chaotic, a near-tie may flip), log-probs within 5e-2."""

import collections
import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.tools import convert_weights as JW
from embodied_captioning_tpu.tools import port as JP
from embodied_captioning_tpu_torch.models import captioner as TCAP
from embodied_captioning_tpu_torch.params import from_jax
from embodied_captioning_tpu_torch.tools import convert_weights as TW
from embodied_captioning_tpu_torch.tools import port as TP
from embodied_captioning_tpu_torch.tools.torch_replica import (
    build_torch_coca, coca_parity_report, zero_state,
)
from tests.test_convert import _tiny_torch_coca, _tiny_torch_vit
from torch_parity import jax_kernel_path, jax_train_path, np32

MERGES = [("l", "o"), ("lo", "w"), ("e", "r</w>")]


def same_tree(got, want, path="") -> int:
    """Asserts equal structure and leaves equal bit for bit (dtype, shape,
    bytes); returns the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        return sum(same_tree(got[k], want[k], f"{path}.{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        return sum(same_tree(g, w, f"{path}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    assert g.tobytes() == w.tobytes(), path
    return 1


def replica_state(seed, std, **shape):
    """A CoCa state dict in open_clip's layout: the replica built at
    `shape`, every tensor drawn from N(0, std) with a seeded generator,
    and `logit_scale`."""
    replica, _ = build_torch_coca(zero_state(**shape))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in replica.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return {**replica.state_dict(), "logit_scale": torch.tensor(2.0)}


def _write_bpe(path, merges):
    with gzip.open(path, "wb") as fh:
        fh.write("\n".join(["#version: tiny"] + [f"{a} {b}" for a, b in
                                                 merges]).encode("utf-8"))
    return str(path)


@pytest.fixture(scope="module")
def cocas(tmp_path_factory):
    """Checkpoints (saved with torch.save) and merges tables of the tiny
    CoCa, two mixed-width CoCas (48 / 32 and 128 / 64 wide) and the
    ViT-L-width CoCa, each ported by both packages' `port_coca`."""
    d = tmp_path_factory.mktemp("cocas")
    torch.manual_seed(3)
    tiny = dict(_tiny_torch_coca(width=32, layers=2, heads=2, patch=8,
                                 image=32, vocab=512 + len(MERGES) + 2,
                                 ctx=16, queries=5).eval().state_dict())
    n_mixed = 600 - 514
    mixed = replica_state(9, 0.05, v_width=48, t_width=32, v_layers=2,
                          t_layers=1, mm_pairs=2, patch=8, image=32,
                          queries=5, vocab=600, ctx=16, mlp=2)
    # text 64 wide: every decode sublayer takes its block kernel
    mm64 = replica_state(10, 0.05, v_width=128, t_width=64, v_layers=2,
                         t_layers=2, mm_pairs=2, patch=8, image=32,
                         queries=5, vocab=600, ctx=16)
    n_vitl = 1000 - 514
    vitl = replica_state(14, 0.02, v_width=1024, t_width=768, v_layers=4,
                         t_layers=1, mm_pairs=1, patch=14, image=224,
                         queries=256, vocab=1000, ctx=77)
    b2u = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pairs = [(a, b) for a in b2u for b in b2u]
    out = {}
    for name, state, merges in (("tiny", tiny, MERGES),
                                ("mixed", mixed, pairs[:n_mixed]),
                                ("mm64", mm64, pairs[:n_mixed]),
                                ("vitl", vitl, pairs[:n_vitl])):
        ckpt = d / f"{name}.pt"
        torch.save(state, ckpt)
        bpe = _write_bpe(d / f"{name}.txt.gz", merges)
        jp = JP.port_coca(str(ckpt), bpe, max_caption_len=8)
        tp = TP.port_coca(str(ckpt), bpe, max_caption_len=8)
        out[name] = dict(state=state, ckpt=str(ckpt), bpe=bpe, jax=jp,
                         port=tp)
    return out


@pytest.mark.parametrize("name", ["tiny", "mixed", "mm64", "vitl"])
def test_port_coca_tree_and_config_equal(cocas, name):
    c = cocas[name]
    (jparams, jcfg, jtok), (tparams, tcfg, ttok) = c["jax"], c["port"]
    n = same_tree(tparams, jparams)
    assert n > 50
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (ttok.vocab_size, ttok.bos_id, ttok.eos_id) == (
        jtok.vocab_size, jtok.bos_id, jtok.eos_id)
    # self-only and cross-only multimodal blocks alternate
    mm = tparams["mm_blocks"]
    assert len(mm) == tcfg.text.cross_layers
    assert all(("attn" in b) != ("xattn" in b) for b in mm)
    assert all("ln_kv" in b for b in mm[1::2])


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_each_coca_converter_tree_equal(cocas, name):
    state, width = cocas[name]["state"], cocas[name]["port"][1].text.width
    same_tree(TW.convert_clip_vit(state), JW.convert_clip_vit(state))
    same_tree(TW.convert_attn_pool(state, "visual.attn_pool.", dim=width),
              JW.convert_attn_pool(state, "visual.attn_pool.", dim=width))
    same_tree(TW.convert_gpt_decoder(state, width, prefix="text."),
              JW.convert_gpt_decoder(state, width, prefix="text."))
    same_tree(TW.convert_coca_multimodal(state, "text_decoder.", width),
              JW.convert_coca_multimodal(state, "text_decoder.", width))
    same_tree(TW.convert_coca(state), JW.convert_coca(state))


def test_clip_vit_converter_without_pooler_tree_equal():
    torch.manual_seed(0)
    tv = _tiny_torch_vit(width=32, layers=2, heads=2, patch=8, image=32)
    state = {"visual." + k: v for k, v in tv.state_dict().items()}
    state["visual.proj"] = torch.randn(32, 16)
    got, want = TW.convert_clip_vit(state), JW.convert_clip_vit(state)
    same_tree(got, want)
    assert got["proj"]["w"].shape == (32, 16)


@pytest.mark.parametrize("layout", ["bare", "bert.", "0.auto_model."])
def test_bert_converter_tree_equal(layout):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=90, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=24)
    torch.manual_seed(1)
    sd = transformers.BertModel(cfg).state_dict()
    prefix = "" if layout == "bare" else layout
    state = {prefix + k: v for k, v in sd.items()}
    got = TW.convert_bert_encoder(TP._strip_bert_prefix(state))
    want = JW.convert_bert_encoder(JP._strip_bert_prefix(state))
    assert same_tree(got, want) > 30
    assert TP._strip_bert_prefix(state).keys() == sd.keys()


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "module"])
def test_load_torch_checkpoint_equal(tmp_path, wrap):
    torch.manual_seed(2)
    sd = {"a.weight": torch.randn(3, 4), "b": torch.randn(2)}
    obj = {"state_dict": sd} if wrap == "state_dict" else (
        {"module." + k: v for k, v in sd.items()} if wrap == "module"
        else sd)
    path = tmp_path / "ckpt.pt"
    torch.save(obj, path)
    got = TW.load_torch_checkpoint(str(path))
    want = JW.load_torch_checkpoint(str(path))
    assert got.keys() == want.keys() == sd.keys()
    assert all(torch.equal(got[k], want[k]) for k in sd)


class _Opaque:
    """Not loadable with weights_only=True."""

    def __init__(self):
        self.w = torch.ones(2)


def test_load_torch_checkpoint_refuses_pickle_unless_allowed(tmp_path):
    path = tmp_path / "opaque.pt"
    torch.save({"x": _Opaque()}, path)
    msgs = []
    for mod in (JW, TW):
        with pytest.raises(RuntimeError) as exc:
            mod.load_torch_checkpoint(str(path))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "allow_pickle=True" in msgs[0]
    assert isinstance(TW.load_torch_checkpoint(str(path),
                                               allow_pickle=True)["x"],
                      _Opaque)


def _images(seed, n, size):
    return (np.random.default_rng(seed).random((n, size, size, 3))
            * 255).astype(np.uint8)


def _corr(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("name", ["tiny", "mixed", "vitl"])
def test_forward_on_converted_weights_matches_jax(cocas, name):
    params, cfg, _ = cocas[name]["jax"]
    size = cfg.vision.image_size
    imgs = _images(5, 2, size)
    toks = np.random.default_rng(6).integers(
        4, cfg.text.vocab_size - 2, (2, 7)).astype(np.int32)
    toks[:, 0] = cfg.text.bos_id
    toks[1, 5:] = cfg.text.pad_id
    with jax_train_path():
        want = [np32(x) for x in JCAP.forward(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs),
            jnp.asarray(toks), cfg)]
    got = [np32(x) for x in TCAP.forward(
        from_jax(cocas[name]["port"][0], "cpu"), torch.from_numpy(imgs),
        torch.from_numpy(toks), cocas[name]["port"][1])]
    assert _corr(got[0], want[0]) > 0.999
    np.testing.assert_allclose(_log_softmax(got[0]), _log_softmax(want[0]),
                               atol=5e-2, rtol=0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["tiny", "mixed", "vitl"])
def test_forward_matches_the_replica_teacher_forced(cocas, name):
    c = cocas[name]
    params, cfg, _ = c["port"]
    imgs = _images(8, 2, cfg.vision.image_size)
    toks = np.random.default_rng(9).integers(
        4, cfg.text.vocab_size - 2, (2, 6)).astype(np.int64)
    rep = coca_parity_report(c["state"], from_jax(params, "cpu"), cfg,
                             imgs, toks, "cpu")
    assert rep["replica_missing"] == []
    assert rep["checkpoint_unconsumed"] == []
    assert rep["text"]["mm_pairs"] * 2 == cfg.text.cross_layers
    assert rep["teacher_forced_corr"] > 0.999, rep
    assert rep["argmax_agreement"] > 0.9, rep


def test_replica_pooler_heads_follow_the_inferred_config(cocas):
    """The replica's pooler takes text width / 96 heads (open_clip's 8 at
    768), as `infer_coca_config` does; the JAX package's replica takes
    width / 64 (12), which its config does not (ROADMAP C.41)."""
    cfg = cocas["vitl"]["port"][1]
    replica, _ = build_torch_coca(cocas["vitl"]["state"])
    assert replica.visual.attn_pool.attn.num_heads == cfg.vision.pool_heads
    assert cfg.vision.pool_heads == 8


# images where no row of the greedy decode parts from the JAX package's
GENERATE_IMAGES = {"tiny": 0, "mm64": 0}


@pytest.mark.parametrize("name", ["tiny", "mm64"])
def test_greedy_generate_on_converted_coca_matches_jax(cocas, name,
                                                       monkeypatch):
    """The converted CoCa's alternating self-only and cross-only
    multimodal blocks through the decode loop: every self-attention
    sublayer (the text tower's and the self-only blocks') on the self
    block, every cross-only block on the cross block, every block on the
    decode MLP, where `decode_route` takes them (at 64 wide all; at 32
    wide the self block refuses and the sublayer runs as separate
    calls)."""
    from embodied_captioning_tpu_torch.models import common as TCM

    jparams, cfg, _ = cocas[name]["jax"]
    imgs = _images(GENERATE_IMAGES[name], 4, cfg.vision.image_size)
    with jax_kernel_path(blocks=True):
        want = [np.asarray(x) for x in JCAP.generate(
            jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(imgs),
            jax.random.PRNGKey(0), cfg)]
    calls = collections.Counter()
    for mod, fn in ((TCM, "_decode_self_block"), (TCM, "_decode_cross_block"),
                    (TCM, "_decode_mlp_block"), (TCM, "decode_self_attention"),
                    (TCAP, "_decode_step")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.update([_n]), _f(*a, **k))[1])
    tparams, tcfg, _ = cocas[name]["port"]
    toks, logp, lengths = TCAP.generate(from_jax(tparams, "cpu"),
                                        torch.from_numpy(imgs), tcfg)
    t = tcfg.text
    route = TCM.decode_route(4, t.width, t.heads, int(t.width * t.mlp_ratio),
                             tcfg.max_caption_len, True)
    selfs = calls["_decode_step"] * (t.layers + t.cross_layers // 2)
    assert route.cross_block and route.mlp
    assert route.self_block == (name == "mm64")
    assert calls["_decode_self_block"] == (selfs if route.self_block else 0)
    assert calls["decode_self_attention"] == (0 if route.self_block
                                              else selfs)
    assert calls["_decode_cross_block"] == (calls["_decode_step"]
                                            * t.cross_layers // 2)
    assert calls["_decode_mlp_block"] == calls["_decode_step"] * (
        t.layers + t.cross_layers)
    np.testing.assert_array_equal(np32(toks), want[0])
    np.testing.assert_array_equal(np32(lengths), want[2])
    assert (want[0][:, 0] == t.bos_id).all() and (want[2] > 2).all()
    np.testing.assert_allclose(np32(logp), want[1], atol=5e-2, rtol=0)
