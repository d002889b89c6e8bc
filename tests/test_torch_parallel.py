"""The port's parallel layer (parallel/mesh, moe, pipeline, sequence and
`perceive_sharded`) at world size 2 on gloo process groups, against the
JAX package's on its 8-device CPU mesh.

One spawn of two ranks (`torch_dist.parallel`) runs every multi-rank case;
the JAX references are computed here. Tolerances and their reasons:
- mesh shapes, partition specs, local shards, gathers: exact;
- `pipeline_apply`, at `tests/test_pipeline.py`'s limits (2e-4 forward,
  5e-3 gradients): on a float32 tanh block both packages compute alike,
  against JAX `pipeline_apply` (float32 products summed in another order;
  activations reach 50); on the real `block`, against the port's
  sequential stack;
- `ring_attention`: 1e-5 against JAX `ring_attention` and dense attention
  (`tests/test_seq_parallel.py`'s limit: float32 reassociation);
- `vit_features_seqparallel`: 3e-2 against JAX's (its test's limit: the
  bf16 residual stream) and against the port's `vit_features`;
- expert-parallel `moe_mlp`: 1e-5 against the single-rank call (the limit
  of JAX `test_moe_expert_sharded_matches_single_device`) and against JAX;
- `perceive_sharded` against the port's `perceive` at
  `tests/test_sharded_perceive.py`'s limits (tokens and validity exact),
  and against JAX `perceive_sharded` at `tests/test_torch_perception.py`'s
  (tokens and validity exact; bf16 boxes to a quarter pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from embodied_captioning_tpu import perception as JPER
from embodied_captioning_tpu.config import CaptionerConfig as JCapCfg
from embodied_captioning_tpu.config import ExperimentConfig as JCfg
from embodied_captioning_tpu.config import VitConfig as JVitCfg
from embodied_captioning_tpu.config import merge as jmerge
from embodied_captioning_tpu.models import captioner as JCAP
from embodied_captioning_tpu.models import vit as JVIT
from embodied_captioning_tpu.models.common import block_init as jblock_init
from embodied_captioning_tpu.parallel import mesh as JM
from embodied_captioning_tpu.parallel import moe as JMOE
from embodied_captioning_tpu.parallel import pipeline as JPP
from embodied_captioning_tpu.parallel import sequence as JSQ
from embodied_captioning_tpu_torch import perception as TPER
from embodied_captioning_tpu_torch.config import ExperimentConfig as TCfg
from embodied_captioning_tpu_torch.config import VitConfig
from embodied_captioning_tpu_torch.config import merge as tmerge
from embodied_captioning_tpu_torch.models import vit as TVIT
from embodied_captioning_tpu_torch.models.captioner import init_captioner
from embodied_captioning_tpu_torch.models.common import block
from embodied_captioning_tpu_torch.parallel import mesh as M
from embodied_captioning_tpu_torch.parallel import pipeline as PP
from embodied_captioning_tpu_torch.params import from_jax, to_numpy
from embodied_captioning_tpu_torch.train.optim import (
    tree_leaves, tree_map, tree_map_with_path,
)
from torch_dist import run
from torch_parity import jax_kernel_path

WORLD = 2
HEADS, DIM = 4, 64
VIT = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4,
           pool_queries=4, pool_heads=2, embed_dim=32)
PERCEIVE_OVER = {"runtime": {"caption_slots_per_frame": 2},
                 "detector": {"score_threshold": 0.0}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jtanh_block(p, h):
    return h + jnp.tanh(h @ p["w1"]) @ p["w2"]


@pytest.fixture(scope="module")
def ref():
    """The inputs and the JAX package's results."""
    ks = jax.random.split(jax.random.PRNGKey(0), 9)
    layers = [jblock_init(ks[i], DIM, HEADS) for i in range(8)]
    x = jax.random.normal(ks[8], (8, 6, DIM), jnp.float32)
    rng = np.random.default_rng(0)
    tanh_layers = [{"w1": (rng.standard_normal((DIM, DIM)) * 0.1
                           ).astype(np.float32),
                    "w2": (rng.standard_normal((DIM, DIM)) * 0.1
                           ).astype(np.float32)} for _ in range(8)]
    pipe_mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("pipe",))

    def loss(sp, x):
        return jnp.sum(jnp.square(JPP.pipeline_apply(
            sp, x, _jtanh_block, pipe_mesh, microbatches=8)))

    stacked = JPP.shard_stacked(JPP.stack_stages(
        jax.tree_util.tree_map(jnp.asarray, tanh_layers), WORLD), pipe_mesh)
    tanh_out = JPP.pipeline_apply(stacked, x, _jtanh_block, pipe_mesh,
                                  microbatches=8)
    tanh_grads, tanh_xg = jax.grad(loss, argnums=(0, 1))(stacked, x)

    b, h, t, d = 2, 4, 32, 16
    qkv = [rng.standard_normal((b, h, t, d)).astype(np.float32)
           for _ in range(3)]
    valid = np.ones((b, t), bool)
    valid[0, 16:] = False  # rank 1's whole block of row 0 is padding
    valid[1, 5:9] = False
    seq_mesh = Mesh(np.asarray(jax.devices()), ("seq",))
    ring = JSQ.ring_attention(*map(jnp.asarray, qkv), seq_mesh,
                              key_valid=jnp.asarray(valid))

    vcfg = JVitCfg(**VIT)
    vit = JVIT.init_vit(jax.random.PRNGKey(0), vcfg)
    vit_tokens = rng.standard_normal(
        (2, 16, 14 * 14 * 3)).astype(np.float32)
    vit_sp = JSQ.vit_features_seqparallel(vit, jnp.asarray(vit_tokens), vcfg,
                                          seq_mesh)

    moe = JMOE.moe_init(jax.random.PRNGKey(0), 16, 32, 4)
    moe_x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    moe_out = JMOE.moe_mlp(moe, jnp.asarray(moe_x),
                           compute_dtype=jnp.float32)

    cap = JCAP.init_captioner(jax.random.PRNGKey(0), JCapCfg.tiny())

    jc = jmerge(JCfg.preset_config("tiny"), PERCEIVE_OVER)
    per = JPER.init_perception(jax.random.PRNGKey(0), jc)
    frames = (rng.random((4, 96, 96, 3)) * 255).astype(np.uint8)
    with jax_kernel_path(blocks=True):
        jsharded = JPER.perceive_sharded(
            per, jnp.asarray(frames), jax.random.PRNGKey(1), jc,
            JM.make_mesh(shape=(4, 1), devices=jax.devices()[:4]))
        jsharded = _np_tree(jsharded)
    tper = from_jax(_np_tree(per), "cpu")
    payload = dict(
        cap=_np_tree(cap), batch=np.arange(8 * 3).reshape(8, 3),
        heads=HEADS, layers=_np_tree(layers), tanh_layers=tanh_layers,
        x=np.asarray(x), q=qkv[0], k=qkv[1], v=qkv[2], valid=valid,
        vit=_np_tree(vit), vit_cfg=VitConfig(**VIT), vit_tokens=vit_tokens,
        moe=_np_tree(moe), moe_x=moe_x, perceive_over=PERCEIVE_OVER,
        perception={f: to_numpy(getattr(tper, f)) for f in tper._fields},
        frames=frames)
    return dict(
        payload=payload, layers=layers, tanh_out=np.asarray(tanh_out),
        tanh_grads=_np_tree(tanh_grads), tanh_xg=np.asarray(tanh_xg),
        qkv=qkv, valid=valid, ring=np.asarray(ring), vit=vit,
        vit_sp=np.asarray(vit_sp, np.float32), moe=moe,
        moe_out=np.asarray(moe_out), jsharded=jsharded, tper=tper,
        frames=frames)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return run("parallel", WORLD, tmp_path_factory.mktemp("parallel"),
               ref["payload"])


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_match_jax(ranks):
    for n in range(1, 9):
        want = JM.make_mesh(devices=jax.devices()[:n]).devices.shape
        assert M.mesh_shape(n) == want, n
    assert M.mesh_shape(8, (4, 2)) == (4, 2)
    for r in ranks:
        assert r["mesh"] == ((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="process group"):
        M.make_mesh()


def _spec(p):
    return tuple(p)


def test_partition_specs_match_jax():
    """Every leaf of the JAX large-preset captioner (ViT-L, 49,408 vocab)
    gets the JAX package's spec from the port's rules, and the rules
    engage and divide by 2 and 4 there (`test_tp_rules_cover_large_dims`);
    the port's tiny captioner has the JAX package's paths."""
    shapes = jax.eval_shape(lambda k: JCAP.init_captioner(
        k, JCapCfg.large()), jax.random.PRNGKey(0))
    matched = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        ps = JM._path_str(path)
        want = _spec(JM.partition_spec_for(ps, leaf, tp=True))
        got = M.partition_spec_for(ps, leaf, tp=True)
        assert got == want, (ps, got, want)
        assert M.partition_spec_for(ps, leaf, tp=False) == ()
        for i, axis in enumerate(got):
            if axis == "model":
                matched += 1
                assert leaf.shape[i] % 2 == 0 and leaf.shape[i] % 4 == 0
    assert matched > 200, matched
    jtiny = jax.tree_util.tree_flatten_with_path(
        JCAP.init_captioner(jax.random.PRNGKey(0), JCapCfg.tiny()))[0]
    tiny = init_captioner(torch.Generator().manual_seed(0),
                          TCfg.preset_config("tiny").captioner, "cpu")
    paths = set()
    tree_map_with_path(lambda p, leaf: paths.add(M._path_str(p)), tiny)
    assert paths == {JM._path_str(p) for p, _ in jtiny}


def test_shard_params_and_batch(ref, ranks):
    cap = ref["payload"]["cap"]
    for r, out in enumerate(ranks):
        n = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(cap)[0]:
            ps = JM._path_str(path)
            spec = M.partition_spec_for(ps, leaf, tp=True)
            want = np.asarray(leaf)
            if "model" in spec and want.shape[spec.index("model")] % 2 == 0:
                want = np.split(want, 2, axis=spec.index("model"))[r]
                n += 1
            got = out["shard_params"]
            for p in path:
                got = got[p.key if hasattr(p, "key") else p.idx]
            np.testing.assert_array_equal(got, want, err_msg=ps)
        assert n > 20
        # no model axis: every leaf whole
        np.testing.assert_array_equal(
            out["shard_params_dp"]["head"]["w"], cap["head"]["w"])
        np.testing.assert_array_equal(
            out["shard_batch"]["x"],
            np.split(ref["payload"]["batch"], 2)[r])


def test_process_allgather(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["allgather"], [[0, 0], [1, 10]])
    np.testing.assert_array_equal(M.process_allgather([3, 4]), [3, 4])


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def test_pipeline_matches_jax_pipeline(ref, ranks):
    for r, out in enumerate(ranks):
        got = out["pipe_tanh"]
        np.testing.assert_allclose(got["out"], ref["tanh_out"], rtol=2e-4,
                                   atol=2e-4)
        want = [np.asarray(g)[r:r + 1]
                for g in jax.tree_util.tree_leaves(ref["tanh_grads"])]
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got["x_grad"], ref["tanh_xg"], rtol=5e-3,
                                   atol=5e-3)


def _sequential(ref, micro: int):
    """The port's block stack run in order on each of `micro` microbatches
    (the pipeline's split: the plain attention rounds its scores to bf16,
    and a backward product over another batch size sums in another order,
    which the key bias's gradient, zero in exact arithmetic, shows in
    full)."""
    layers = [tree_map(lambda t: t.requires_grad_(True),
                       from_jax(_np_tree(p), "cpu")) for p in ref["layers"]]
    x = torch.from_numpy(ref["payload"]["x"].copy()).requires_grad_(True)
    outs = []
    for h in x.chunk(micro):
        for p in layers:
            h = block(p, h, HEADS, compute_dtype=torch.float32)[0]
        outs.append(h)
    h = torch.cat(outs)
    torch.sum(torch.square(h)).backward()
    stacked = PP.stack_stages(tree_map(lambda t: t.grad, layers), WORLD)
    return h.detach().numpy(), tree_leaves(stacked), x.grad.numpy()


@pytest.mark.parametrize("key,micro", [("pipe_block", 8),
                                       ("pipe_block_1", 2)])
def test_pipeline_block_matches_sequential(ref, ranks, key, micro):
    """Stages 2 with 8 microbatches, and a pipe axis of 1 with 2
    (`test_pipeline_matches_sequential`'s cases a world of 2 allows)."""
    out_seq, grads_seq, xg_seq = _sequential(ref, micro)
    out_whole = _sequential(ref, 1)[0]
    for r, out in enumerate(ranks):
        got = out[key]
        np.testing.assert_allclose(got["out"], out_seq, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got["out"], out_whole, rtol=2e-4,
                                   atol=2e-4)
        stage = slice(r, r + 1) if key == "pipe_block" else slice(None)
        for g, w in zip(got["grads"], grads_seq):
            w = w.numpy()[stage].reshape(g.shape)
            np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got["x_grad"], xg_seq, rtol=5e-3,
                                   atol=5e-3)


def test_stack_stages_validates():
    layers = [{"w": torch.zeros(2)} for _ in range(6)]
    with pytest.raises(ValueError, match="6 layers not divisible into 4"):
        PP.stack_stages(layers, 4)
    assert PP.stack_stages(layers, 3)["w"].shape == (3, 2, 2)


# ---------------------------------------------------------------------------
# sequence
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, valid):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def test_ring_attention_matches_jax_and_dense(ref, ranks):
    got = np.concatenate([r["ring"] for r in ranks], axis=2)
    np.testing.assert_allclose(got, ref["ring"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _dense_attention(*ref["qkv"],
                                                     ref["valid"]),
                               rtol=1e-5, atol=1e-5)
    got = np.concatenate([r["ring_all_valid"] for r in ranks], axis=2)
    np.testing.assert_allclose(
        got, _dense_attention(*ref["qkv"], np.ones_like(ref["valid"])),
        rtol=1e-5, atol=1e-5)


def test_vit_features_seqparallel_matches_jax(ref, ranks):
    """17 tokens over a ring of 2 (padded to 18; the JAX package's ring of
    8 pads to 24)."""
    tvit = from_jax(_np_tree(ref["vit"]), "cpu")
    toks = torch.from_numpy(ref["payload"]["vit_tokens"])
    dense = TVIT.vit_features(tvit, toks, VitConfig(**VIT)).float().numpy()
    for out in ranks:
        got = out["vit_sp"]
        assert got.shape == ref["vit_sp"].shape == (2, 17, 64)
        np.testing.assert_allclose(got, ref["vit_sp"], rtol=3e-2, atol=3e-2)
        np.testing.assert_allclose(got, dense, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def test_expert_parallel_moe_matches_single_rank(ref, ranks):
    moe = ref["payload"]["moe"]
    for r, out in enumerate(ranks):
        for name in ("fc_w", "fc_b", "proj_w", "proj_b"):
            np.testing.assert_array_equal(out["moe_local"][name],
                                          moe[name][2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["moe_local"]["gate"]["w"],
                                      moe["gate"]["w"])
        np.testing.assert_allclose(out["moe_ep"], out["moe_single"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["moe_ep"], ref["moe_out"], rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(out["moe_ep"]).sum() > 0


# ---------------------------------------------------------------------------
# perceive_sharded
# ---------------------------------------------------------------------------

def test_perceive_sharded_matches_perceive_and_jax(ref, ranks):
    tc = tmerge(TCfg.preset_config("tiny"), PERCEIVE_OVER)
    single = TPER.perceive(ref["tper"], torch.from_numpy(ref["frames"]), tc)
    js = ref["jsharded"]
    for out in ranks:
        got = out["perceive"]
        np.testing.assert_array_equal(got["valid"], single.detections.valid)
        np.testing.assert_array_equal(got["tokens"], single.caption_tokens)
        np.testing.assert_array_equal(got["lengths"],
                                      single.caption_lengths)
        np.testing.assert_allclose(got["boxes"],
                                   single.detections.boxes.float(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["embeddings"],
                                   single.detections.embeddings,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["valid"], js.detections.valid)
        assert js.detections.valid.sum() >= 3
        np.testing.assert_array_equal(got["classes"], js.detections.classes)
        np.testing.assert_array_equal(got["tokens"], js.caption_tokens)
        assert (js.caption_lengths > 1).sum() >= 3  # real decode work
        np.testing.assert_allclose(
            got["boxes"], np.asarray(js.detections.boxes, np.float32),
            atol=0.25, rtol=0)
    with pytest.raises(AssertionError, match="not divisible by data axis"):
        TPER.perceive_sharded(ref["tper"], torch.zeros(3, 96, 96, 3,
                                                       dtype=torch.uint8),
                              tc, _FakeMesh())


class _FakeMesh:
    """A mesh object with a "data" axis of 2 (the divisibility check runs
    before any collective)."""

    mesh_dim_names = ("data",)

    def size(self, dim):
        return 2
